"""Writes point_cloud_donkey_tpu_torch/data/zoo_reference.npz: what the JAX
package computes on the CPU for the configurations of tests/zoo_data.py,
which chip_smoke.py's phase 12 holds the card to.

    JAX_PLATFORMS=cpu python tests/zoo_fixtures.py

For each detection configuration (harris_fpfh, iss_short_cshot,
sift_short_shot), `<name>_`:
  * the training: the JAX ImplicitShapeModel trained on zoo_data's
    training set (dense SHOT-family descriptors, as
    torch_fixtures.dense_descriptors sets them), its codebook
    (`cb_<field>`) and its per-class dimensions (`dims`);
  * each training cloud's keypoint flags (`kp_keep<i>`, the detector on
    the normals the JAX extraction hands it) and positions
    (`kp_pos<i>`), its features (`feat_pos<i>`, `feat_desc<i>`) and, for
    SIFT3D, the intensity it detects on (`intensity<i>`);
  * the maxima of detect_batch on zoo_data's detection set
    (`max_<field>`, bench_data.pack_maxima).
For each scene configuration, `<name>_`: the scene's keypoint flags and
positions and its features (the JAX tiled routes).  `eval_labels`: the
(ground truth, classified class) of each file of zoo_data.eval_lists as
the JAX eval_classification CLI writes them (harris_fpfh's config).

The JAX package raises on SHORT_SHOT's log radius inside its jitted
descriptor stage, so for sift_short_shot the reference substitutes the
configuration's radius there (tests/zoo_jobs.log_radius_shim).  About 15
minutes on 4 CPU threads.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import zoo_data as zd  # noqa: E402
import zoo_jobs  # noqa: E402
from bench_data import pack_maxima  # noqa: E402
from torch_fixtures import dense_descriptors  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(_TESTS), "point_cloud_donkey_tpu_torch",
                        "data")
ZOO_REFERENCE = os.path.join(DATA_DIR, "zoo_reference.npz")


def detection_reference(name, out, tmp):
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
    cfg = zd.zoo_config(name)
    clouds, labels, rgbs = zd.training_set(name)
    with dense_descriptors(), zoo_jobs.log_radius_shim(cfg):
        ism = ImplicitShapeModel(IsmConfig.from_json(cfg))
        for i, (pts, cid) in enumerate(zip(clouds, labels)):
            f = os.path.join(tmp, f"{name}{i}.pcd")
            save_pcd(f, PointCloud(xyz=pts, rgb=None if rgbs is None
                                   else rgbs[i]))
            ism.add_training_model(f, int(cid), int(cid))
        ism.train()
        for k, v in ism.state.codebook._asdict().items():
            out[f"{name}_cb_{k}"] = np.asarray(v)
        keys = sorted(ism.state.dims_map)
        out[f"{name}_dims"] = np.array([[k, *ism.state.dims_map[k]]
                                        for k in keys], np.float64)
        for i, pts in enumerate(clouds):
            arrays = zoo_jobs.cloud_arrays(
                pts, None if rgbs is None else rgbs[i], cfg, True, str(i))
            out.update({f"{name}_{k}": v for k, v in arrays.items()})
        dclouds, drgbs = zd.detection_set(name)
        res = ism.detect_batch(list(dclouds), None,
                               None if drgbs is None else list(drgbs))
    for k, v in pack_maxima([m for m, _ in res]).items():
        out[f"{name}_max_{k}"] = v
    counts = [int(out[f"{name}_kp_keep{i}"].sum())
              for i in range(len(clouds))]
    print(f"{name}: {len(out[name + '_cb_codewords'])} codewords, "
          f"training keypoints {counts}, "
          f"{sum(len(m) for m, _ in res)} maxima", flush=True)
    assert min(counts) >= zd.MIN_KEYPOINTS, counts


def scene_reference(name, out):
    arrays = zoo_jobs.cloud_arrays(zd.scene(), None, zd.zoo_config(name),
                                   False)
    out.update({f"{name}_{k}": v for k, v in arrays.items()})
    print(f"{name}: {int(arrays['kp_keep'].sum())} keypoints, "
          f"{len(arrays['feat_pos'])} features", flush=True)


def eval_reference(out, tmp):
    """The JAX eval_classification CLI on zoo_data.eval_lists, harris_fpfh's
    config (dense descriptors)."""
    import json
    cfg = os.path.join(tmp, "eval.ism")
    with open(cfg, "w") as f:
        json.dump(zd.zoo_config("harris_fpfh"), f)
    train, test = zd.eval_lists(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PCD_TRAIN_FUSED="1",
               PCD_DENSE_DESC="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(_TESTS),
                                           os.environ.get("PYTHONPATH", "")]))
    cli = [sys.executable, "-m", "point_cloud_donkey_tpu.cli.eval_classification"]
    model = os.path.join(tmp, "eval_model")
    subprocess.run(cli + ["-t", cfg, "-f", train, "-o", model], env=env,
                   check=True, cwd=tmp, capture_output=True)
    outdir = os.path.join(tmp, "eval_out")
    subprocess.run(cli + ["-d", model + ".ism", "-f", test, "-o", outdir],
                   env=env, check=True, cwd=tmp, capture_output=True)
    out["eval_labels"] = zd.summary_labels(os.path.join(outdir,
                                                        "summary.txt"))
    print(f"eval_classification: {out['eval_labels'].tolist()}", flush=True)


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = {}
    parts = sys.argv[1:] or list(zd.DETECTIONS) + list(zd.SCENE_CONFIGS) \
        + ["eval"]
    if os.path.exists(ZOO_REFERENCE) and sys.argv[1:]:
        with np.load(ZOO_REFERENCE) as z:
            out = {k: z[k] for k in z.files
                   if not any(k.startswith(p + "_") or k == p + "_labels"
                              for p in parts)}
    with tempfile.TemporaryDirectory() as tmp:
        for name in parts:
            if name in zd.DETECTIONS:
                detection_reference(name, out, tmp)
            elif name in zd.SCENE_CONFIGS:
                scene_reference(name, out)
            elif name == "eval":
                eval_reference(out, tmp)
            else:
                raise SystemExit(f"unknown part {name!r}")
    np.savez_compressed(ZOO_REFERENCE, **out)


if __name__ == "__main__":
    main()
