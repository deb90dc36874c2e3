"""Train the CGF embedding MLP on synthetic correspondences (port of
point_cloud_donkey_tpu/cli/train_cgf_embedding.py; the same flags and the
same .npz layout, ``w0, b0, w1, b1, ...``).

Anchor / positive pairs are raw CGF histograms (ops/cgf.py) of the same
surface location of a synthetic shape (utils/shapes.py) under two
independent samplings, noises and rotations; the other rows of a batch are
the negatives.  NT-Xent (InfoNCE, temperature 0.1) pulls the pairs
together in the embedding space, trained with torch autograd and Adam
(optax's defaults: betas 0.9 / 0.999, eps 1e-8).  The initial weights are
the JAX tool's for the same seed (He-scaled ``jax.random.normal`` draws,
ops/global_descriptors.normal), and the batches its numpy draws, so the
two tools start from the same point.

    python -m point_cloud_donkey_tpu_torch.train_cgf_embedding \\
        --out my_embedding.npz --pairs 3000 --steps 600 [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.cgf import cgf_raw_histogram
from .ops.global_descriptors import normal, prng_key, prng_split
from .ops.lrf import shot_lrf
from .ops.neighbors import full_fp32, gather_radius_neighbors, gather_rows
from .ops.normals import compute_normals_fast
from .utils import shapes

Layers = List[Tuple[np.ndarray, np.ndarray]]


def cgf_pair_rows(kp: np.ndarray, pts: np.ndarray, radius: float,
                  device) -> Tuple[np.ndarray, np.ndarray]:
    """(raw CGF rows [K, 2244], frame valid [K]) of the keypoints `kp` on
    one cloud `pts`: method-2 normals at radius / 2 (K1 / K2), the SHOT
    LRF at 0.75 x radius (K1 / K2), 512 neighbours a keypoint."""
    p = torch.from_numpy(np.ascontiguousarray(pts)).to(device)[None]
    k = torch.from_numpy(np.ascontiguousarray(kp)).to(device)[None]
    mask = torch.ones(p.shape[:2], dtype=torch.bool, device=device)
    kmask = torch.ones(k.shape[:2], dtype=torch.bool, device=device)
    with full_fp32():
        nrm = compute_normals_fast(p, mask, 0.5 * radius)
        lrf = shot_lrf(k, kmask, p, mask, 0.75 * radius)
        nbr = gather_radius_neighbors(k, p, mask, radius, capacity=512)
        kp_nrm = gather_rows(nrm, nbr.idx[..., 0])
        raw = cgf_raw_histogram(k, kp_nrm, lrf.frames, lrf.valid, p, nbr,
                                radius)
    return raw[0].cpu().numpy(), lrf.valid[0].cpu().numpy()


def generate_pairs(n_pairs: int, n_points: int, radius: float, seed: int,
                   kp_per_instance: int = 16, device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """[P, 2244] x 2 raw-histogram correspondence pairs (the JAX tool's
    draws: a shape, two rotations, two samplings of it, the keypoints,
    the noise)."""
    rng = np.random.default_rng(seed)
    anchors, positives = [], []
    for i in range(-(-n_pairs // kp_per_instance)):
        cid = int(rng.integers(len(shapes.SHAPES)))
        rot_a = shapes.random_rotation(rng)
        rot_b = shapes.random_rotation(rng)
        base_a = shapes.SHAPES[cid](np.random.default_rng(1000 + i),
                                    n_points)
        base_b = shapes.SHAPES[cid](np.random.default_rng(2000 + i),
                                    n_points)
        kp_base = base_a[rng.choice(len(base_a), kp_per_instance,
                                    replace=False)]

        def noisy(base, rot):
            p = base @ rot.T
            return (p + rng.normal(scale=0.008, size=p.shape)
                    ).astype(np.float32)

        pa = noisy(base_a, rot_a)
        pb = noisy(base_b, rot_b)
        ka = (kp_base @ rot_a.T).astype(np.float32)
        kb = (kp_base @ rot_b.T).astype(np.float32)
        ha, va = cgf_pair_rows(ka, pa, radius, device)
        hb, vb = cgf_pair_rows(kb, pb, radius, device)
        anchors.append(ha[va & vb])
        positives.append(hb[va & vb])
    return (np.concatenate(anchors)[:n_pairs].astype(np.float32),
            np.concatenate(positives)[:n_pairs].astype(np.float32))


def initial_layers(d_in: int, dims: Sequence[int], seed: int) -> Layers:
    """The JAX tool's initial weights for `seed`: a key split off
    PRNGKey(seed) a layer, w = normal(key, (d_in, d_out)) * sqrt(2 /
    d_in), b = 0."""
    key = prng_key(seed)
    layers = []
    for d_out in dims:
        key, k1 = prng_split(key, 2)
        w = normal(k1, (d_in, d_out)) * np.float32(np.sqrt(2.0 / d_in))
        layers.append((w.astype(np.float32), np.zeros(d_out, np.float32)))
        d_in = d_out
    return layers


def _forward(params, x):
    for i in range(0, len(params), 2):
        x = x @ params[i] + params[i + 1]
        if i < len(params) - 2:
            x = torch.relu(x)
    return x


def _optax_step_scale(t: int) -> float:
    """The factor that turns torch Adam's step t into optax's: both scale
    the step by sqrt(1 - b2^t) / (1 - b1^t), torch in float64, optax in
    float32 (0.9 and 0.999 rounded to float32 first)."""
    b1, b2 = np.float32(0.9), np.float32(0.999)
    one = np.float32(1.0)
    optax = math.sqrt(float(one - b2 ** np.float32(t))) \
        / float(one - b1 ** np.float32(t))
    return optax / (math.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t))


def nt_xent(za: torch.Tensor, zp: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """The symmetric NT-Xent loss of the row pairs (za_i, zp_i)."""
    za = za / torch.clamp(torch.linalg.norm(za, dim=1, keepdim=True),
                          min=1e-9)
    zp = zp / torch.clamp(torch.linalg.norm(zp, dim=1, keepdim=True),
                          min=1e-9)
    logits = za @ zp.T / temperature
    labels = torch.arange(za.shape[0], device=za.device)
    ce = torch.nn.functional.cross_entropy
    return (ce(logits, labels) + ce(logits.T, labels)) / 2.0


def train(anchors: np.ndarray, positives: np.ndarray, dims: Sequence[int],
          steps: int, batch: int, lr: float, seed: int,
          temperature: float = 0.1, device="cuda",
          init: Optional[Layers] = None,
          losses: Optional[list] = None) -> Layers:
    """The embedding's layers [(w, b)] after `steps` Adam steps on batches
    of `batch` pairs (numpy draws from `seed`), from `init` or the JAX
    tool's initial weights for `seed`; each step's loss is appended to
    `losses` when given."""
    layers = init if init is not None else \
        initial_layers(anchors.shape[1], dims, seed)
    params = [torch.tensor(np.asarray(a, np.float32), device=device,
                           requires_grad=True)
              for w, b in layers for a in (w, b)]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    xa_all = torch.from_numpy(np.ascontiguousarray(anchors)).to(device)
    xp_all = torch.from_numpy(np.ascontiguousarray(positives)).to(device)
    rng = np.random.default_rng(seed)
    n = len(anchors)
    with full_fp32():
        for s in range(steps):
            sel = torch.from_numpy(rng.choice(n, min(batch, n),
                                              replace=False)).to(device)
            opt.param_groups[0]["lr"] = lr * _optax_step_scale(s + 1)
            opt.zero_grad()
            loss = nt_xent(_forward(params, xa_all[sel]),
                           _forward(params, xp_all[sel]), temperature)
            loss.backward()
            opt.step()
            if losses is not None:
                losses.append(float(loss.detach()))
            if s % 50 == 0 or s == steps - 1:
                print(f"step {s}: loss {float(loss.detach()):.4f}", flush=True)
    return [(params[i].detach().cpu().numpy(),
             params[i + 1].detach().cpu().numpy())
            for i in range(0, len(params), 2)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="train_cgf_embedding",
        description="Train the CGF 32-D embedding on synthetic "
                    "correspondences")
    ap.add_argument("--out", default="cgf_embedding.npz")
    ap.add_argument("--pairs", type=int, default=2000)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--radius", type=float, default=0.6)
    ap.add_argument("--dims", type=int, nargs="*", default=[512, 64, 32])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    t0 = time.time()
    a, p = generate_pairs(args.pairs, args.points, args.radius, args.seed,
                          device=device)
    print(f"generated {len(a)} correspondence pairs in "
          f"{time.time() - t0:.0f}s", flush=True)
    weights = train(a, p, args.dims, args.steps, args.batch, args.lr,
                    args.seed, device=device)
    out = {}
    for i, (w, b) in enumerate(weights):
        out[f"w{i}"] = w
        out[f"b{i}"] = b
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
