"""Writes point_cloud_donkey_tpu_torch/data/zoo2_reference.npz: what the JAX
package computes on the CPU for the configurations of tests/zoo2_data.py,
which chip_smoke.py's phase 13 holds the card to.

    JAX_PLATFORMS=cpu python tests/zoo2_fixtures.py [NAME ...]

For each configuration `<name>_`: the JAX ImplicitShapeModel trained on
zoo2_data's training set (dense SHOT-family descriptors, as
torch_fixtures.dense_descriptors sets them): its codebook (`cb_<field>`)
and global descriptors (`glob`); the maxima of detect_batch on zoo2_data's
detection set (`max_<field>`, bench_data.pack_maxima).  For BSHOT and
PFH also each training cloud's features (`feat_pos<i>`, `feat_desc<i>`)
and, for BSHOT, the SHOT features at the same keypoints (`shot_desc<i>`:
phase 13's decision contract of BSHOT's bits, tests/zoo2_check.py), for
PFH the cloud's normals (`normals<i>`: phase 13 explains a PFH feature
off JAX's by a normal in its support off JAX's).  Each
configuration runs in a subprocess of its own, four at a time
(tests/jax_jobs.py); about 10 minutes on 4 CPU threads.  With names, only
those configurations are recomputed.
"""

import os
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import zoo2_data as zd  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(_TESTS), "point_cloud_donkey_tpu_torch",
                        "data")
ZOO2_REFERENCE = os.path.join(DATA_DIR, "zoo2_reference.npz")


def reference(name: str, tmp: str) -> dict:
    """The arrays of configuration `name` (module docstring), unprefixed;
    run by tests/jax_jobs.JaxPool.call."""
    import zoo_jobs
    from bench_data import pack_maxima
    from torch_fixtures import dense_descriptors
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
    cfg = zd.zoo2_config(name)
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
        if name in ("bshot", "pfh"):
            from point_cloud_donkey_tpu.models.features import \
                compute_cloud_normals
            shot = zd.zoo2_config(name)
            shot["ObjectConfig"]["Children"]["Features"]["Type"] = "SHOT"
            root = IsmConfig.from_json(cfg).root
            for i, pts in enumerate(clouds):
                pos, desc = zoo_jobs.jax_features(pts, None, cfg, True)
                out[f"feat_pos{i}"], out[f"feat_desc{i}"] = pos, desc
                if name == "bshot":
                    spos, sdesc = zoo_jobs.jax_features(pts, None, shot,
                                                        True)
                    assert np.array_equal(pos, spos)
                    out[f"shot_desc{i}"] = sdesc
                else:
                    out[f"normals{i}"] = compute_cloud_normals(
                        pts, None, root.get("NormalRadius", 0.05),
                        root.get("ConsistentNormalsMethod", 2))
        dclouds, drgbs = zd.detection_set(name)
        res = ism.detect_batch(list(dclouds), None, drgbs)
    for k, v in pack_maxima([m for m, _ in res]).items():
        out["max_" + k] = v
    return out


def owner(key: str) -> str:
    """The configuration a reference key belongs to (the longest name that
    prefixes it: rsd_min_max's keys also start with "rsd_")."""
    return max((n for n in zd.CONFIGS if key.startswith(n + "_")), key=len)


def main() -> None:
    from jax_jobs import JaxPool
    names = sys.argv[1:] or list(zd.CONFIGS)
    out = {}
    if os.path.exists(ZOO2_REFERENCE) and sys.argv[1:]:
        with np.load(ZOO2_REFERENCE) as z:
            out = {k: z[k] for k in z.files if owner(k) not in names}
    pool = JaxPool(4)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {n: pool.call("zoo2_fixtures:reference", name=n, tmp=tmp)
                for n in names}
        for n, job in jobs.items():
            arrays = job.result()
            out.update({f"{n}_{k}": v for k, v in arrays.items()})
            maxima = int((arrays["max_class_id"] >= 0).sum()) \
                if "max_class_id" in arrays else -1
            print(f"{n}: {len(arrays['cb_codewords'])} codewords, "
                  f"{'glob' in arrays and len(arrays['glob'])} global rows, "
                  f"{maxima} maxima", flush=True)
    pool.close()
    np.savez_compressed(ZOO2_REFERENCE, **out)


if __name__ == "__main__":
    main()
