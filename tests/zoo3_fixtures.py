"""Writes point_cloud_donkey_tpu_torch/data/zoo3_reference.npz: what the JAX
package computes on the CPU for the configurations of tests/zoo3_data.py,
which chip_smoke.py's phase 14 holds the card to.

    JAX_PLATFORMS=cpu python tests/zoo3_fixtures.py [NAME ...]

For each configuration `<name>_`: the JAX ImplicitShapeModel trained on
zoo3_data's training set (dense SHOT-family descriptors, as
torch_fixtures.dense_descriptors sets them): its codebook (`cb_<field>`)
and global descriptors (`glob`); the maxima of detect_batch on zoo3_data's
detection set (`max_<field>`, bench_data.pack_maxima).  For CGF also, on
the first zoo3_data.CGF_RAW_CLOUDS training clouds, its keypoints
(`raw_pos<i>`), CGF's SHOT LRFs there (`raw_frames<i>`, `raw_fvalid<i>`),
the keypoints' normals (`raw_kpn<i>`) and the raw rows (`raw_rows<i>`).
`train_`: the embedding trainer's 14e (zoo3_data.TRAIN_*): the JAX tool's
pairs (`train_a`, `train_p`), its loss at each step (`train_losses`), the
entries of its initial weights where the port's draw of the same seed
differs (`train_fix_idx<l>`, `train_fix_val<l>`: flat index, JAX's value),
its final layers (`train_b<l>`, `train_w<l>`; of w0 only the rows
`train_w0_rows`).  Each configuration runs in a subprocess of its own,
four at a time (tests/jax_jobs.py); about 5 minutes on 4 CPU threads.
With names (`train` for 14e), only those are recomputed.
"""

import os
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import zoo3_data as zd  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(_TESTS), "point_cloud_donkey_tpu_torch",
                        "data")
ZOO3_REFERENCE = os.path.join(DATA_DIR, "zoo3_reference.npz")
# the rows of w0 kept: every W0_STRIDE-th bin
W0_STRIDE = 17


def cgf_raw(xyz: np.ndarray, cfg: dict) -> dict:
    """The JAX package's CGF intermediates at the keypoints its extraction
    keeps on one cloud (`_descriptor_fn`'s CGF branch on the padded
    cloud): positions, frames, frame valid, keypoint normals, raw rows."""
    import jax.numpy as jnp
    from zoo_jobs import _setup, jax_features
    from point_cloud_donkey_tpu.models.features import (compute_cloud_normals,
                                                        pad_cloud)
    from point_cloud_donkey_tpu.ops.cgf import cgf_raw_histogram
    from point_cloud_donkey_tpu.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu.ops.neighbors import gather_radius_neighbors
    _, fcfg, _, nr, cm = _setup(cfg)
    pos, _ = jax_features(xyz, None, cfg, True)
    pts, mask = pad_cloud(xyz)
    nrm = np.zeros_like(pts)
    nrm[:len(xyz)] = compute_cloud_normals(xyz, None, nr, cm)
    radius = jnp.asarray(fcfg.radius, jnp.float32)
    kp, kpm = jnp.asarray(pos), jnp.ones(len(pos), bool)
    lrf = shot_lrf(kp, kpm, jnp.asarray(pts), jnp.asarray(mask),
                   0.75 * radius)
    nbr = gather_radius_neighbors(kp, jnp.asarray(pts), jnp.asarray(mask),
                                  radius, min(fcfg.neighbor_capacity,
                                              len(pts)))
    kpn = nrm[np.asarray(nbr.idx[:, 0])]
    raw = cgf_raw_histogram(kp, jnp.asarray(kpn), lrf.frames, lrf.valid,
                            jnp.asarray(pts), nbr, radius)
    return {"pos": pos, "frames": np.asarray(lrf.frames),
            "fvalid": np.asarray(lrf.valid), "kpn": kpn,
            "rows": np.asarray(raw)}


def reference(name: str, tmp: str) -> dict:
    """The arrays of configuration `name` (module docstring), unprefixed;
    run by tests/jax_jobs.JaxPool.call."""
    from bench_data import pack_maxima
    from torch_fixtures import dense_descriptors
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
    cfg = zd.zoo3_config(name)
    clouds, labels, rgbs = zd.training_set(name)
    out = {}
    with dense_descriptors():
        ism = ImplicitShapeModel(IsmConfig.from_json(cfg))
        for i, (pts, cid) in enumerate(zip(clouds, labels)):
            f = os.path.join(tmp, f"{name}{i}.pcd")
            save_pcd(f, PointCloud(xyz=pts, rgb=None if rgbs is None
                                   else rgbs[i]))
            ism.add_training_model(f, int(cid), int(cid))
        ism.train()
        for k, v in ism.state.codebook._asdict().items():
            out["cb_" + k] = np.asarray(v)
        if ism.state.global_descriptors is not None:
            out["glob"] = np.asarray(ism.state.global_descriptors)
        if name == zd.CGF:
            for i in range(zd.CGF_RAW_CLOUDS):
                for k, v in cgf_raw(clouds[i], cfg).items():
                    out[f"raw_{k}{i}"] = v
        dclouds, drgbs = zd.detection_set(name)
        res = ism.detect_batch(list(dclouds), None, drgbs)
    for k, v in pack_maxima([m for m, _ in res]).items():
        out["max_" + k] = v
    return out


def jax_embedding_run(anchors, positives, dims, steps, batch, seed) -> dict:
    """The JAX tool's train() on the pairs: its initial layers
    (`init_w<l>`, `init_b<l>`), each step's loss (`losses`) and its final
    layers (`w<l>`, `b<l>`), read by wrapping the jit of its step."""
    import jax
    from point_cloud_donkey_tpu.cli import train_cgf_embedding as jt
    losses, init = [], []
    real = jax.jit

    def jit(fn, *args, **kwargs):
        f = real(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "step":
            return f

        def run(*a):
            if not init:
                init.append([(np.asarray(l["w"]), np.asarray(l["b"]))
                             for l in a[0]])
            res = f(*a)
            losses.append(float(res[2]))
            return res
        return run

    jax.jit = jit
    try:
        final = jt.train(np.asarray(anchors, np.float32),
                         np.asarray(positives, np.float32), list(dims),
                         steps, batch, 1e-3, seed)
    finally:
        jax.jit = real
    out = {"losses": np.array(losses)}
    for i, ((w0, b0), (w, b)) in enumerate(zip(init[0], final)):
        out[f"init_w{i}"], out[f"init_b{i}"] = w0, b0
        out[f"w{i}"], out[f"b{i}"] = w, b
    return out


def embedding_run(n_pairs: int, n_points: int, steps: int, batch: int,
                  seed: int = 0, dims=(512, 64, 32)) -> dict:
    """The JAX tool's generate_pairs(n_pairs, n_points, 0.6, seed)
    (`a`, `p`) and jax_embedding_run on them; run by
    tests/jax_jobs.JaxPool.call."""
    from point_cloud_donkey_tpu.cli.train_cgf_embedding import generate_pairs
    a, p = generate_pairs(n_pairs, n_points, 0.6, seed)
    return {"a": a, "p": p,
            **jax_embedding_run(a, p, dims, steps, batch, seed)}


def train_reference() -> dict:
    """14e's arrays (module docstring), unprefixed."""
    from point_cloud_donkey_tpu_torch.train_cgf_embedding import \
        initial_layers
    run = embedding_run(zd.TRAIN_PAIRS, 1024, zd.TRAIN_STEPS,
                        zd.TRAIN_BATCH, zd.TRAIN_SEED, zd.TRAIN_DIMS)
    a, p = run["a"], run["p"]
    out = {"a": a, "p": p, "losses": run["losses"],
           "w0_rows": np.arange(0, a.shape[1], W0_STRIDE)}
    mine = initial_layers(a.shape[1], zd.TRAIN_DIMS, zd.TRAIN_SEED)
    for i, (w, _) in enumerate(mine):
        want = run[f"init_w{i}"].ravel()
        fix = np.flatnonzero(w.ravel() != want)
        out[f"fix_idx{i}"] = fix.astype(np.int32)
        out[f"fix_val{i}"] = want[fix]
        out[f"b{i}"] = run[f"b{i}"]
        out[f"w{i}"] = run[f"w{i}"][out["w0_rows"]] if i == 0 \
            else run[f"w{i}"]
    return out


def owner(key: str) -> str:
    """The configuration a reference key belongs to (the longest name that
    prefixes it)."""
    return max((n for n in zd.CONFIGS + ("train",)
                if key.startswith(n + "_")), key=len)


def main() -> None:
    from jax_jobs import JaxPool
    names = sys.argv[1:] or list(zd.CONFIGS) + ["train"]
    out = {}
    if os.path.exists(ZOO3_REFERENCE) and sys.argv[1:]:
        with np.load(ZOO3_REFERENCE) as z:
            out = {k: z[k] for k in z.files if owner(k) not in names}
    pool = JaxPool(4)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {n: pool.call("zoo3_fixtures:reference", name=n, tmp=tmp)
                for n in names if n != "train"}
        if "train" in names:
            jobs["train"] = pool.call("zoo3_fixtures:train_reference")
        for n, job in jobs.items():
            arrays = job.result()
            out.update({f"{n}_{k}": v for k, v in arrays.items()})
            if n == "train":
                print(f"train: losses {arrays['losses']}", flush=True)
                continue
            maxima = int((arrays["max_class_id"] >= 0).sum())
            print(f"{n}: {len(arrays['cb_codewords'])} codewords, "
                  f"{'glob' in arrays and len(arrays['glob'])} global rows, "
                  f"{maxima} maxima", flush=True)
    pool.close()
    np.savez_compressed(ZOO3_REFERENCE, **out)
    print(f"wrote {ZOO3_REFERENCE}: {os.path.getsize(ZOO3_REFERENCE)} bytes")


if __name__ == "__main__":
    main()
