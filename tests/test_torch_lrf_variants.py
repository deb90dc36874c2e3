"""The ReferenceFrameType variants SHOTNA, FLARE and BOARD (ops/lrf.py)
against the JAX package's on the CPU:

  * the frames on three clouds (one padded, masked keypoints, a keypoint
    on a point -- BOARD's d^2 <= 1e-12 trap): validity equal, >= 97% of
    the valid frames within 2e-3, and each frame off by more than that
    explained by a decision in its rounding band
    (tests/zoo2_check.lrf_variant_near);
  * training and detect_batch through ImplicitShapeModel on the bench
    config: SHOT under SHOTNA, SHORT_SHOT under FLARE, CSHOT under BOARD
    verified by CSHOT_GLOBAL under BOARD (test_torch_train.py trains SHOT
    under FLARE and BOARD): the training contract of test_torch_train.py
    and the firm detections of the JAX package's detect_batch;
  * the scene route (ops.tiled's threshold and chunks patched to 512 / 64
    in both packages) with SHOT under BOARD: the same keypoints, >= 97% of
    the descriptor rows at cosine > 0.999.
The JAX references of the trainings run in subprocesses
(tests/jax_jobs.py), queued when the module starts."""

import copy

import numpy as np
import pytest
import torch

import shapes
import zoo2_check as zc
from bench_data import BENCH_CONFIG, bench_colors
from jax_jobs import JaxPool
from test_torch_train import assert_codebooks_match
from test_torch_zoo2 import assert_detections_match, port_train
from test_torch_zoo2_global import scene_scale  # noqa: F401 (fixture)
from torch_fixtures import dense_descriptors
from torch_parity import n, t
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from point_cloud_donkey_tpu.models import features as jfeat
from point_cloud_donkey_tpu.ops import lrf as jlrf
from point_cloud_donkey_tpu.ops.normals import compute_normals as jnormals
from point_cloud_donkey_tpu.utils.config import ComponentConfig as JaxComp
from point_cloud_donkey_tpu_torch.models import features as tfeat
from point_cloud_donkey_tpu_torch.models.detect_batch import \
    extract_local_features_batch
from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
from point_cloud_donkey_tpu_torch.ops import lrf as tlrf
from point_cloud_donkey_tpu_torch.utils.config import ComponentConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

N_POINTS = 1024
FRAME_RADIUS = 0.5


def variant_config(descriptor: str, frame: str, glob: bool = False) -> dict:
    """The bench config with Features `descriptor` under the
    ReferenceFrameType `frame` (with `glob`, verified by CSHOT_GLOBAL
    under the same frames)."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["Features"]["Type"] = descriptor
    ch["Features"]["Parameters"]["ReferenceFrameType"] = frame
    if glob:
        ch["GlobalFeatures"] = {"Type": "CSHOT_GLOBAL", "Parameters": {
            "Radius": 0.3, "ReferenceFrameRadius": 2.0,
            "ReferenceFrameType": frame}}
        ch["Voting"]["Parameters"]["UseGlobalFeatures"] = True
    return cfg


TRAININGS = {
    "shot_shotna": variant_config("SHOT", "SHOTNA"),
    "short_shot_flare": variant_config("SHORT_SHOT", "FLARE"),
    "cshot_board_global": variant_config("CSHOT", "BOARD", glob=True),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """4 coloured training models of 2 classes and 3 fresh views, as PCD
    files: ([(path, class)], [path])."""
    tmp = tmp_path_factory.mktemp("lrf_variants")
    rng = np.random.default_rng(31)
    models, views = [], []
    for i in range(7):
        pts = shapes.make_instance(rng, i % 2, n=N_POINTS, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"c{i}.pcd")
        save_pcd(path, pts, rgb=bench_colors(pts))
        if i < 4:
            models.append((path, i % 2))
        else:
            views.append(path)
    return models, views


@pytest.fixture(scope="module", autouse=True)
def jax_refs(files):
    """The JAX trainings and detections of TRAININGS, queued at once."""
    models, views = files
    pool = JaxPool(3)
    jobs = {name: pool.call("zoo_jobs:train_detect", cfg=cfg,
                            files=[list(f) for f in models],
                            detect_files=views)
            for name, cfg in TRAININGS.items()}
    yield jobs
    pool.close()


@pytest.fixture(scope="module")
def clouds():
    """Three shapes of 1024 points (the second padded past 900), their
    JAX method-2 normals (zero on padding) and keypoints: every 8th point
    (the first exactly on a point), the second cloud's last 10 masked."""
    rng = np.random.default_rng(5)
    pts = np.stack([shapes.make_instance(rng, c, n=N_POINTS, noise=0.005)
                    for c in (0, 1, 3)]).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 900:] = False
    pts[1, 900:] = 1e9
    normals = jax.jit(lambda p, m: jnormals(p, m, 0.25, 2).normals)
    nrm = np.stack([np.asarray(normals(jnp.asarray(p), jnp.asarray(m)))
                    for p, m in zip(pts, mask)])
    nrm = np.where(mask[..., None], nrm, 0.0).astype(np.float32)
    kp = pts[:, ::8][:, :100].copy()
    kpm = np.ones(kp.shape[:2], bool)
    kpm[1, 90:] = False
    return pts, mask, nrm, kp, kpm


def _jax_frames(kind, kp, kpm, pts, nrm, mask):
    fr = jnp.float32(FRAME_RADIUS)
    args = (jnp.asarray(kp), jnp.asarray(kpm), jnp.asarray(pts),
            jnp.asarray(nrm), jnp.asarray(mask))
    if kind == "SHOTNA":
        res = jlrf.shot_na_lrf(*args, fr)
    elif kind == "FLARE":
        res = jlrf.flare_lrf(*args, fr, fr / 5.0)
    else:
        res = jlrf.board_lrf(*args, fr)
    return np.asarray(res.frames), np.asarray(res.valid)


@pytest.mark.parametrize("kind", ["SHOTNA", "FLARE", "BOARD"])
def test_frames_match_jax(clouds, kind):
    """Validity equal; >= 97% of the valid frames within 2e-3 (max abs
    over the 3 x 3); each frame beyond that in its rounding band."""
    pts, mask, nrm, kp, kpm = clouds
    tangent = float(np.float32(FRAME_RADIUS) / np.float32(5.0))
    args = (t(kp), t(kpm), t(pts), t(nrm), t(mask))
    if kind == "SHOTNA":
        got = tlrf.shot_na_lrf(*args, FRAME_RADIUS)
    elif kind == "FLARE":
        got = tlrf.flare_lrf(*args, FRAME_RADIUS, tangent)
    else:
        got = tlrf.board_lrf(*args, FRAME_RADIUS)
    errs, near = [], []
    for b in range(len(pts)):
        wf, wv = _jax_frames(kind, kp[b], kpm[b], pts[b], nrm[b], mask[b])
        gf, gv = n(got.frames[b]), n(got.valid[b])
        np.testing.assert_array_equal(gv, wv)
        assert not gv[~kpm[b]].any()
        errs.append(np.abs(gf - wf).max(axis=(-2, -1))[gv])
        near.append(zc.lrf_variant_near(kind, kp[b][gv], pts[b][mask[b]],
                                        nrm[b][mask[b]], wf[gv],
                                        FRAME_RADIUS, tangent))
    err = np.concatenate(errs)
    assert (err < 2e-3).mean() >= 0.97, (err >= 2e-3).sum()
    zc.report(f"{kind} frames", err >= 2e-3, np.concatenate(near))


@pytest.mark.parametrize("name", sorted(TRAININGS))
def test_variant_trains_and_detects_as_jax(files, jax_refs, name):
    """Training: the codebook contract (and the CSHOT_GLOBAL rows at
    cosine > 0.999); detect_batch of the 3 views: the firm detections of
    JAX's."""
    models, views = files
    ism = port_train(models, TRAININGS[name])
    want = jax_refs[name].result()
    assert_codebooks_match(ism.state.codebook, SimpleNamespace(**{
        k[3:]: v for k, v in want.items() if k.startswith("cb_")}))
    if "glob_desc" in want:
        got, ref = ism.state.global_descriptors, want["glob_desc"]
        assert got.shape == ref.shape
        cos = (got * ref).sum(1) / np.maximum(
            np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1), 1e-30)
        assert cos.min() > 0.999, cos.min()
    got = assert_detections_match(ism, views, want)
    print(f"{name}: {len(ism.state.codebook.codewords)} codewords, "
          f"maxima {[len(g) for g in got]}")


def test_board_scene_route_matches_jax(scene_scale):  # noqa: F811
    """SHOT under BOARD on the scene route: the same keypoints, >= 97% of
    the descriptor rows at cosine > 0.999."""
    rng = np.random.default_rng(8)
    xyz = shapes.make_instance(rng, 1, n=2000, noise=0.005).astype(
        np.float32)
    kp_cfg = {"Type": "VoxelGrid", "Parameters": {"LeafSize": 0.3}}
    params = dict(type="SHOT", radius=0.6, ref_frame_radius=0.5,
                  ref_frame_type="BOARD")
    with dense_descriptors():
        want = jfeat.extract_local_features(
            xyz, None, jfeat.FeatureConfig(**params),
            JaxComp.from_json(kp_cfg), 0.25, 2)
    got = extract_local_features_batch(
        [xyz], [None], [None], tfeat.FeatureConfig(**params),
        KeypointParams.from_config(ComponentConfig.from_json(kp_cfg)), 0.25,
        2, torch.device("cpu"), is_training=False)[0]
    np.testing.assert_array_equal(got.positions, want.positions)
    cos = (got.descriptors * want.descriptors).sum(1)
    print(f"BOARD scene route: {len(cos)} rows, "
          f"{(cos > 0.999).mean():.4f} at cosine > 0.999")
    assert len(cos) >= 20 and (cos > 0.999).mean() >= 0.97
