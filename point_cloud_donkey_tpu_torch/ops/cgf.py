"""CGF: Compact Geometric Features (Khoury, Zhou, Funkhouser ICCV'17; port
of point_cloud_donkey_tpu/ops/cgf.py), batched over clouds: [B, K]
keypoints over [B, K, M] neighbour gathers
(ops/neighbors.gather_radius_neighbors).

The raw row is a spherical histogram of 2244 bins (17 log-radial from
0.05 x the radius, 11 polar, 12 azimuth) in the keypoint's SHOT LRF --
the whole frame turned where its z disagrees with the keypoint's normal,
the identity where the frame is invalid -- normalised by the neighbour
count (features_cgf.cpp:31-113, third_party/cgf/cgf.cpp:100-165); one
``scatter_add_`` over the pairs' bins (ops/descriptors_misc.
slot_histogram).  A bin comes from truncating a float, so a pair on a
log-radius, arccos or atan2 edge can land in the neighbouring bin where a
function differs by an ulp.

:class:`CgfEmbedding` maps raw rows to CgfOutputDims through an MLP
(``w0, b0, w1, b1, ...`` of an .npz, ReLU between layers) in full fp32;
without a checkpoint, a Gaussian random projection drawn as
``jax.random.normal(PRNGKey(seed))`` draws it
(ops/global_descriptors.normal).  The shipped embedding is the port's copy
of the JAX package's (data/cgf_embedding.npz, trained by
train_cgf_embedding.py).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .descriptors_misc import slot_histogram
from .global_descriptors import normal, prng_key
from .neighbors import NeighborBlock, full_fp32, gather_rows
from .shot import ShotResult

CGF_R_BINS = 17
CGF_P_BINS = 11
CGF_A_BINS = 12
CGF_RAW_LEN = CGF_R_BINS * CGF_P_BINS * CGF_A_BINS  # 2244


def default_checkpoint_path() -> str:
    """The shipped embedding (data/cgf_embedding.npz)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "cgf_embedding.npz")


def cgf_raw_histogram(keypoints: torch.Tensor,    # [B, K, 3]
                      kp_normals: torch.Tensor,   # [B, K, 3]
                      frames: torch.Tensor,       # [B, K, 3, 3]
                      frame_valid: torch.Tensor,  # [B, K]
                      points: torch.Tensor,       # [B, N, 3]
                      nbr: NeighborBlock,         # [B, K, M]
                      radius: float,
                      min_radius_rel: float = 0.05) -> torch.Tensor:
    """[B, K, 2244] density-normalised raw CGF histograms (the JAX
    ``cgf_raw_histogram``; its radius arithmetic in float32)."""
    dt = points.dtype
    use = nbr.valid & (nbr.dist > 1e-15) & torch.isfinite(nbr.dist)
    eye = torch.eye(3, dtype=dt, device=points.device).expand_as(frames)
    fr = torch.where(frame_valid[..., None, None], frames, eye)
    flip = ((fr[..., 2, :] * kp_normals).sum(-1) < 0) & frame_valid
    fr = torch.where(flip[..., None, None], -fr, fr)

    delta = gather_rows(points, nbr.idx) - keypoints[..., None, :]
    x_l = (delta * fr[..., None, 0, :]).sum(-1)
    y_l = (delta * fr[..., None, 1, :]).sum(-1)
    z_l = (delta * fr[..., None, 2, :]).sum(-1)
    rad = torch.tensor(radius, dtype=dt, device=points.device)
    r = torch.sqrt(x_l * x_l + y_l * y_l + z_l * z_l)
    r = torch.where(use, r, rad * 0.5)
    deg = torch.tensor(180.0 / np.pi, dtype=dt)
    theta = torch.arccos(torch.clamp(z_l / torch.clamp(r, min=1e-30),
                                     -1.0, 1.0)) * deg
    phi = torch.atan2(y_l, x_l) * deg

    rmin = min_radius_rel * rad
    ln_rmin = torch.log(rmin)
    ln_span = torch.log(rad / rmin)
    i32 = torch.int32
    bin_r = ((CGF_R_BINS - 1) * (torch.log(torch.clamp(r, min=1e-30))
                                 - ln_rmin) / ln_span + 1.0).to(i32)
    bin_r = torch.clamp(bin_r, 0, CGF_R_BINS - 1)
    bin_t = torch.clamp((CGF_P_BINS * theta / 180.0).to(i32),
                        max=CGF_P_BINS - 1)
    bin_p = torch.clamp((CGF_A_BINS * (phi + 180.0) / 360.0).to(i32),
                        max=CGF_A_BINS - 1)
    idx = bin_r + bin_t * CGF_R_BINS + bin_p * CGF_R_BINS * CGF_P_BINS
    w = use.to(dt)
    hist = slot_histogram(idx, w, CGF_RAW_LEN, 2)
    count = torch.clamp(w.sum(-1), min=1.0)
    return hist / count[..., None]


class CgfEmbedding:
    """The embedding MLP (the reference's embedding.py TF model
    equivalent): x @ w + b a layer, ReLU between layers, in full fp32."""

    def __init__(self, weights: List[Tuple[np.ndarray, np.ndarray]],
                 device="cpu"):
        self.weights = [(torch.as_tensor(np.asarray(w, np.float32),
                                         device=device),
                         torch.as_tensor(np.asarray(b, np.float32),
                                         device=device))
                        for w, b in weights]

    @classmethod
    def from_npz(cls, path: str, device="cpu") -> "CgfEmbedding":
        with np.load(path) as z:
            layers = []
            while f"w{len(layers)}" in z.files:
                i = len(layers)
                layers.append((z[f"w{i}"], z[f"b{i}"]))
        if not layers:
            raise ValueError(f"{path}: no w0/b0... layers found")
        return cls(layers, device)

    @classmethod
    def random_projection(cls, out_dims: int, seed: int = 0,
                          device="cpu") -> "CgfEmbedding":
        """The seeded Gaussian projection (JL lemma) used where no trained
        checkpoint is: JAX's normal(PRNGKey(seed), (2244, out_dims)) /
        sqrt(2244)."""
        w = normal(prng_key(seed), (CGF_RAW_LEN, out_dims)) \
            / np.float32(np.sqrt(CGF_RAW_LEN))
        return cls([(w, np.zeros(out_dims, np.float32))], device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            for i, (w, b) in enumerate(self.weights):
                x = x @ w + b
                if i < len(self.weights) - 1:
                    x = torch.relu(x)
        return x


def cgf_descriptor(keypoints: torch.Tensor,    # [B, K, 3]
                   kp_normals: torch.Tensor,   # [B, K, 3]
                   frames: torch.Tensor,       # [B, K, 3, 3]
                   frame_valid: torch.Tensor,  # [B, K]
                   points: torch.Tensor,       # [B, N, 3]
                   nbr: NeighborBlock,
                   radius: float,
                   embedding: Optional[CgfEmbedding] = None,
                   min_neighbors: int = 5) -> ShotResult:
    """CGF rows [B, K, D]: the raw histogram, embedded where `embedding` is
    given; valid with `min_neighbors` neighbours and a finite row."""
    raw = cgf_raw_histogram(keypoints, kp_normals, frames, frame_valid,
                            points, nbr, radius)
    out = embedding(raw) if embedding is not None else raw
    n_nbr = (nbr.valid & (nbr.dist > 1e-15)).sum(-1)
    valid = (n_nbr >= min_neighbors) & torch.isfinite(out).all(-1)
    return ShotResult(out, valid)
