"""The JAX package's side of the zoo's references: what it computes on the
CPU for a configuration (an .ism JSON) -- keypoint flags, features,
trainings and detections -- as dicts of numpy arrays, for
tests/zoo_fixtures.py and, through tests/jax_jobs.JaxPool.call, the CPU
tests (test_torch_zoo.py, test_torch_detectors.py).

The JAX package raises on SHORT_SHOT's log radius inside its jitted
descriptor stage: models/features.py passes the radius as a traced array
and ops/short_shot.py takes math.log of it.  `log_radius_shim` substitutes
the configuration's radius there, so its references exist.
"""

import contextlib
import dataclasses

import numpy as np

from bench_data import pack_maxima


@contextlib.contextmanager
def log_radius_shim(cfg: dict):
    """While open, the JAX `_short_shot_core` takes the configuration's
    Features.Radius (a Python float) where its log radius meets a traced
    radius."""
    from point_cloud_donkey_tpu.models.features import FeatureConfig
    from point_cloud_donkey_tpu.ops import short_shot as jss
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    fcfg = FeatureConfig.from_config(
        IsmConfig.from_json(cfg).child("Features"))
    if not fcfg.short_shot_log_radius:
        yield
        return
    real = jss._short_shot_core
    radius = float(fcfg.radius)

    def core(keypoints, frames, frame_valid, delta, use, r, r_bins, e_bins,
             a_bins, min_radius, log_radius):
        return real(keypoints, frames, frame_valid, delta, use,
                    radius if log_radius else r, r_bins, e_bins, a_bins,
                    min_radius, log_radius)

    jss._short_shot_core = core
    try:
        yield
    finally:
        jss._short_shot_core = real


@contextlib.contextmanager
def scene_tiles(tiles):
    """While open, the JAX package's scene threshold and chunks are
    `tiles` (SCENE_TILE_THRESHOLD, NORMALS_CHUNK, KEYPOINT_CHUNK), when
    given."""
    from point_cloud_donkey_tpu.ops import tiled
    names = ("SCENE_TILE_THRESHOLD", "NORMALS_CHUNK", "KEYPOINT_CHUNK")
    old = [getattr(tiled, k) for k in names]
    if tiles:
        for k, v in zip(names, tiles):
            setattr(tiled, k, int(v))
    try:
        yield
    finally:
        for k, v in zip(names, old):
            setattr(tiled, k, v)


def _setup(cfg: dict):
    from point_cloud_donkey_tpu.models.features import FeatureConfig
    from point_cloud_donkey_tpu.models.keypoints import KeypointParams
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    ism_cfg = IsmConfig.from_json(cfg)
    return (ism_cfg, FeatureConfig.from_config(ism_cfg.child("Features")),
            KeypointParams.from_config(ism_cfg.child("Keypoints")),
            ism_cfg.root.get("NormalRadius", 0.05),
            ism_cfg.root.get("ConsistentNormalsMethod", 2))


def jax_keypoints(xyz: np.ndarray, cfg: dict):
    """(keep flags [N], kept positions [K, 3], intensity [N] or None,
    normals [N, 3] or None) of the JAX detector on one cloud, on the
    normals its extraction hands it (those normals); the flags from a run
    without refinement (they do not depend on it)."""
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models import keypoints as jkp
    from point_cloud_donkey_tpu.models.features import (compute_cloud_normals,
                                                        pad_cloud)
    from point_cloud_donkey_tpu.ops.normals import pca_normals
    _, fcfg, params, nr, cm = _setup(cfg)
    normals = compute_cloud_normals(xyz, None, nr, cm) \
        if fcfg.needs_normals() else None
    pos = jkp._detector_keypoints(xyz, normals, params)
    kept = jkp._detector_keypoints(
        xyz, normals, dataclasses.replace(params, harris_refine=False))
    index = {tuple(p): i for i, p in enumerate(np.asarray(xyz, np.float32))}
    keep = np.zeros(len(xyz), bool)
    for p in np.asarray(kept, np.float32):
        keep[index[tuple(p)]] = True
    intensity = None
    if params.type == "SIFT3D":
        pts, mask = pad_cloud(xyz)
        nres = pca_normals(jnp.asarray(pts), jnp.asarray(mask),
                           float(params.radius))
        intensity = np.asarray(jnp.where(nres.valid, nres.curvature,
                                         0.0))[:len(xyz)].astype(np.float32)
    return keep, np.asarray(pos, np.float32), intensity, normals


def jax_features(xyz: np.ndarray, rgb, cfg: dict, is_training: bool):
    """(positions [F, 3], descriptors [F, D]) of the JAX extraction of one
    cloud (the per-cloud route; the tiled one above the scene
    threshold)."""
    from point_cloud_donkey_tpu.models.features import extract_local_features
    ism_cfg, fcfg, _, nr, cm = _setup(cfg)
    with log_radius_shim(cfg):
        fs = extract_local_features(xyz, None, fcfg,
                                    ism_cfg.child("Keypoints"), nr, cm,
                                    rgb=rgb, is_training=is_training)
    return np.asarray(fs.positions, np.float32), \
        np.asarray(fs.descriptors, np.float32)


def cloud_arrays(xyz, rgb, cfg: dict, is_training: bool, key: str = ""):
    """One cloud's keypoint flags and positions (a detector's), intensity
    (SIFT3D) or normals (Harris3D, where the descriptor reads them) and
    features, under `key`-suffixed names."""
    _, _, params, _, _ = _setup(cfg)
    out = {}
    if params.type in ("Harris3D", "ISS3D", "SIFT3D"):
        keep, pos, inten, normals = jax_keypoints(xyz, cfg)
        out[f"kp_keep{key}"], out[f"kp_pos{key}"] = keep, pos
        if inten is not None:
            out[f"intensity{key}"] = inten
        if normals is not None and params.type == "Harris3D":
            out[f"normals{key}"] = np.asarray(normals, np.float32)
    out[f"feat_pos{key}"], out[f"feat_desc{key}"] = jax_features(
        xyz, rgb, cfg, is_training)
    return out


def features(cfg: dict, files: list, is_training: bool = True,
             tiles=None) -> dict:
    """cloud_arrays of each file, suffixed by its index (under
    scene_tiles(tiles))."""
    from point_cloud_donkey_tpu.utils.io import load_cloud
    out = {}
    with scene_tiles(tiles):
        for i, path in enumerate(files):
            pc = load_cloud(path)
            out.update(cloud_arrays(pc.xyz, pc.rgb, cfg, is_training,
                                    str(i)))
    return out


def train_detect(cfg: dict, files: list, detect_files: list,
                 tiles=None) -> dict:
    """The JAX ImplicitShapeModel trained on `files` [(path, class)]: its
    codebook (`cb_<field>`), global descriptors (`glob_desc`) and the
    maxima of detect_batch on `detect_files` (`max_<field>`), under
    scene_tiles(tiles)."""
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import load_cloud
    out = {}
    with log_radius_shim(cfg), scene_tiles(tiles):
        ism = ImplicitShapeModel(IsmConfig.from_json(cfg))
        for path, cid in files:
            ism.add_training_model(path, int(cid), int(cid))
        ism.train()
        for k, v in ism.state.codebook._asdict().items():
            out["cb_" + k] = np.asarray(v)
        if ism.state.global_descriptors is not None:
            out["glob_desc"] = np.asarray(ism.state.global_descriptors)
        if not detect_files:
            return out
        clouds = [load_cloud(p) for p in detect_files]
        res = ism.detect_batch([c.xyz for c in clouds], None,
                               [c.rgb for c in clouds])
    for k, v in pack_maxima([m for m, _ in res]).items():
        out["max_" + k] = v
    return out



def eval_cli(cfg: dict, train_list: str, test_list: str, workdir: str,
             extra: list = ()) -> dict:
    """The JAX eval_classification CLI: -t on `train_list` with the config
    `cfg`, then -d on `test_list`; its summary.txt's lines (`summary`)."""
    import json
    import os
    from point_cloud_donkey_tpu.cli import eval_classification
    path = os.path.join(workdir, "jax_cfg.ism")
    with open(path, "w") as f:
        json.dump(cfg, f)
    model = os.path.join(workdir, "jax_model")
    out = os.path.join(workdir, "jax_out")
    assert eval_classification.main(["-t", path, "-f", train_list, "-o",
                                     model]) == 0
    assert eval_classification.main(["-d", model + ".ism", "-f", test_list,
                                     "-o", out, *extra]) == 0
    with open(os.path.join(out, "summary.txt")) as f:
        return {"summary": np.array(f.read())}
