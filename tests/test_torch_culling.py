"""VoxelGridCulling in the port (models/keypoints.py, the culling branch of
models/detect_batch.py) against the JAX package's models/keypoints.py on
the CPU.

  * apply_culling_host and the Auto threshold: the same host arithmetic,
    so equal outputs on the same scores, for every threshold type,
    combiner and refinement (ties and an all-zero combined score
    included);
  * culling_scores of one cloud (curvature, gaussian, KPQ, colour): the
    geometry scores within rtol 5e-3 / atol 5e-5 of the jitted JAX program
    (tests/test_tiled.py's contract for the curvature of the moment
    identity, whose float sums run in another order), the colour score
    within 1e-6;
  * detect_keypoints per cloud, below and above the scene threshold
    (monkeypatched to 512 in both packages, chunks 64), for CutOff /
    Threshold / Auto x RequireOne / RequireBoth / RequireCombinedList x
    refinement on and off, keypoint by keypoint (tests/culling_check.py,
    on both packages' scores of the same voxel keypoints): each output is
    its own scores' decisions, a keypoint is kept by one side only when
    its score lies within rtol 1e-4 of a threshold, a refined one takes
    another partner only at such a threshold or at a near tie (rtol
    1e-4), and refined positions are within 1e-5 x the leaf;
  * the batched extraction's culling rows keep the keypoints of the
    per-cloud culling of each cloud (their features within 1e-6: the CPU
    twins' scatter sums may round the last bit with the batch).

The cloud is tests/test_tiled.py's noisy ellipsoid shell (2500 points),
coloured by tests/bench_data.bench_colors, with the JAX tiled method-1
normals.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import culling_check as cc
from bench_data import bench_colors
from torch_parity import n, t

from point_cloud_donkey_tpu.models import features as jfeat
from point_cloud_donkey_tpu.models import keypoints as jk
from point_cloud_donkey_tpu.ops import tiled as jt
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models import keypoints as tk
from point_cloud_donkey_tpu_torch.models.detect_batch import \
    extract_local_features_batch
from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
from point_cloud_donkey_tpu_torch.ops import tiled as tt

CPU = torch.device("cpu")
LEAF = 0.25
COMBINERS = ("RequireOne", "RequireBoth", "RequireCombinedList")
# the geometry score each threshold type is tried with (Auto is refused
# with KPQ, culling.cpp:102-106)
GEOMETRY = {"CutOff": "KPQ", "Threshold": "Gaussian", "Auto": "Curvature"}
THRESHOLDS = {"KPQ": 0.05, "Gaussian": 1e-4, "Curvature": 0.01}


def _cloud(n_pts=2500, seed=7):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= np.array([1.5, 1.0, 0.6], np.float32)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return pts[rng.permutation(n_pts)]


@pytest.fixture(scope="module")
def cloud():
    xyz = _cloud()
    return xyz, jfeat._compute_normals_scene(xyz, 0.2, 1), bench_colors(xyz)


def _params(mod, gtype, comb, refine, **kw):
    geo = GEOMETRY[gtype]
    return mod.KeypointParams(
        type="VoxelGridCulling", leaf_size=LEAF, filter_method_geometry=geo,
        filter_type_geometry=gtype,
        filter_threshold_geometry=THRESHOLDS[geo],
        filter_method_color="ColorDistance", filter_type_color="CutOff",
        max_similar_color_distance=0.05, combine_filters=comb,
        refine_position=refine, **kw)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("comb", COMBINERS)
@pytest.mark.parametrize("gtype", sorted(GEOMETRY))
def test_apply_culling_host_matches_jax(gtype, comb, refine):
    rng = np.random.default_rng(3)
    k = 300
    kp = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (k, 3)).astype(np.float32)
    geo = rng.gamma(2.0, 0.01, k).astype(np.float32)
    geo[::17] = geo[3]                       # ties
    col = np.round(rng.uniform(0, 1, k), 2).astype(np.float32)
    for g, c in ((geo, col), (np.zeros(k, np.float32), col)):
        want = jk.apply_culling_host(kp, rgb, g, c,
                                     _params(jk, gtype, comb, refine),
                                     return_colors=True)
        got = tk.apply_culling_host(kp, rgb, g, c,
                                    _params(tk, gtype, comb, refine),
                                    return_colors=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_auto_threshold_matches_jax():
    rng = np.random.default_rng(5)
    for scores in (rng.gamma(2.0, 1.0, 500), rng.uniform(0, 1, 37),
                   np.full(10, 0.5), np.r_[np.zeros(50), np.ones(3)]):
        s = np.sort(scores.astype(np.float32))
        assert tk._auto_threshold(s) == jk._auto_threshold(s)


@pytest.mark.parametrize("geo,col", [("curvature", "none"),
                                     ("gaussian", "none"), ("kpq", "none"),
                                     ("none", "colordistance")])
def test_culling_scores_match_jax(cloud, geo, col):
    xyz, nrm, rgb = cloud
    params = tk.KeypointParams(leaf_size=LEAF)
    kp, kp_rgb = tk.detect_keypoints(xyz, nrm, rgb, params, CPU)
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    full = voxel_grid(t(xyz), torch.ones(len(xyz), dtype=torch.bool), LEAF,
                      features=t(np.concatenate([nrm, rgb], 1)),
                      exact_division=True)
    kn = n(full.centroids[full.mask])[:, 3:6]
    args = (kp, np.ones(len(kp), bool), kn, kp_rgb, xyz,
            np.ones(len(xyz), bool), nrm, rgb)
    want = jax.jit(lambda *a: jk.culling_scores(*a, geo, col, LEAF, 0.05))(
        *(jnp.asarray(a) for a in args))
    build.reset_launch_counts()
    got = tk.culling_scores(*(t(a)[None] for a in args), geo, col, LEAF,
                            0.05)
    assert set(build.launch_counts().values()) == {0}
    np.testing.assert_allclose(n(got[0])[0], np.asarray(want[0]), rtol=5e-3,
                               atol=5e-5)
    np.testing.assert_allclose(n(got[1])[0], np.asarray(want[1]), rtol=0,
                               atol=1e-6)


def _jax_scores(xyz, nrm, rgb, params):
    """The voxel keypoints and culling scores of the JAX detect_keypoints,
    as it computes them (its scene route above SCENE_TILE_THRESHOLD, its
    dense program below)."""
    kp, kp_rgb = jk.detect_keypoints(xyz, nrm, rgb, jk.KeypointParams(
        leaf_size=LEAF), return_colors=True)
    pts_pad, mask_pad = jfeat.pad_cloud(xyz)
    extra = np.zeros((len(pts_pad), 6), np.float32)
    extra[:len(xyz)] = np.concatenate([nrm, rgb], 1)
    res = jk._voxel_program(len(pts_pad), 6)(
        jnp.asarray(pts_pad), jnp.asarray(mask_pad),
        jnp.asarray(LEAF, jnp.float32), jnp.asarray(extra))
    kn = np.asarray(res.centroids)[np.asarray(res.mask)][:, 3:6]
    geo, col = params.filter_method_geometry.lower(), "colordistance"
    if len(xyz) > jt.SCENE_TILE_THRESHOLD:
        return kp, jk._tiled_culling_scores(kp, kn, kp_rgb, xyz, nrm, rgb,
                                            geo, col, LEAF, 0.05)
    k_pad = jfeat.bucket_size(max(len(kp), 1), minimum=64)
    pad = np.full((k_pad, 3), 1e9, np.float32)
    pad[:len(kp)] = kp
    rows = [np.zeros((k_pad, 3), np.float32) for _ in range(2)]
    rows[0][:len(kp)] = kn
    rows[1][:len(kp)] = kp_rgb
    nrm_pad = np.zeros_like(pts_pad)
    nrm_pad[:len(xyz)] = nrm
    rgb_pad = np.zeros_like(pts_pad)
    rgb_pad[:len(xyz)] = rgb
    g, c = jk._culling_program(len(pts_pad), k_pad, geo, col, LEAF, 0.05)(
        jnp.asarray(pad), jnp.asarray(np.arange(k_pad) < len(kp)),
        jnp.asarray(rows[0]), jnp.asarray(rows[1]), jnp.asarray(pts_pad),
        jnp.asarray(mask_pad), jnp.asarray(nrm_pad), jnp.asarray(rgb_pad))
    return kp, (np.asarray(g)[:len(kp)], np.asarray(c)[:len(kp)])


@pytest.mark.parametrize("scene", [False, True], ids=["dense", "scene"])
@pytest.mark.parametrize("gtype", sorted(GEOMETRY))
def test_detect_keypoints_culls_as_jax(cloud, monkeypatch, gtype, scene):
    """Per-cloud culling of every combiner and refinement under one
    threshold type, on the dense program or the scene tiles: the
    keypoint-by-keypoint contract of tests/culling_check.py, each side's
    output the decisions of its own scores."""
    xyz, nrm, rgb = cloud
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "SCENE_TILE_THRESHOLD",
                            512 if scene else 1 << 20)
        monkeypatch.setattr(mod, "KEYPOINT_CHUNK", 64)
        monkeypatch.setattr(mod, "NORMALS_CHUNK", 64)
    kp, want_scores = _jax_scores(xyz, nrm, rgb, _params(jk, gtype,
                                                         "RequireOne", True))
    vk, vn, vr = tk.voxel_keypoints(xyz, nrm, rgb, LEAF, CPU)
    np.testing.assert_allclose(vk, kp, rtol=0, atol=cc.coord_tol(kp))
    got_scores = tk.cloud_culling_scores(
        vk, vn, vr, xyz, nrm, rgb, _params(tk, gtype, "RequireOne", True),
        CPU)
    for comb in COMBINERS:
        for refine in (False, True):
            want = jk.detect_keypoints(xyz, nrm, rgb,
                                       _params(jk, gtype, comb, refine),
                                       return_colors=True)
            got = tk.detect_keypoints(xyz, nrm, rgb,
                                      _params(tk, gtype, comb, refine), CPU)
            assert len(got[0]) > 3
            cc.check_culled(kp, want_scores, got_scores, want[0], got[0],
                            _params(tk, gtype, comb, refine),
                            f"{gtype} {comb} refine={refine}")
            if len(got[0]) == len(want[0]):
                np.testing.assert_allclose(got[1], want[1], rtol=0,
                                           atol=1e-5)


def _kp_normals(xyz, nrm, rgb):
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    full = voxel_grid(t(xyz), torch.ones(len(xyz), dtype=torch.bool), LEAF,
                      features=t(np.concatenate([nrm, rgb], 1)),
                      exact_division=True)
    return n(full.centroids[full.mask])[:, 3:6]


def test_batched_culling_equals_per_cloud(cloud):
    """Three clouds in one chunk: each row's keypoints are those of the
    cloud extracted alone (the culling scores of the chunk in one call,
    the thresholds row by row)."""
    xyz, nrm, rgb = cloud
    clouds = [xyz, xyz[:1800] * 1.1, xyz[::2]]
    rgbs = [rgb, rgb[:1800], rgb[::2]]
    params = _params(tk, "CutOff", "RequireCombinedList", True,
                     disable_filter_in_training=False)
    fcfg = FeatureConfig(type="SHOT", radius=0.4, ref_frame_radius=0.3)
    both = extract_local_features_batch(clouds, [None] * 3, rgbs, fcfg,
                                        params, 0.2, 1, CPU)
    for i in range(3):
        alone = extract_local_features_batch([clouds[i]], [None],
                                             [rgbs[i]], fcfg, params, 0.2,
                                             1, CPU)[0]
        assert len(alone.positions) > 3
        np.testing.assert_array_equal(both[i].positions, alone.positions)
        # the CPU twins' scatter sums may round the last bit by the batch
        for a, b in zip(both[i], alone):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_culling_training_matches_jax(tmp_path):
    """DisableFilterInTraining false: training culls (KPQ, CutOff) on the
    batched route of both packages, and the codebook meets the training
    contract of tests/test_torch_train.py against JAX's."""
    import shapes
    from test_torch_train import CLASSES, assert_codebooks_match, config
    from torch_fixtures import dense_descriptors
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel as JIsm
    from point_cloud_donkey_tpu.utils.config import IsmConfig as JConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud as JCloud
    from point_cloud_donkey_tpu.utils.io import save_pcd as jsave
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    rng = np.random.default_rng(11)
    files = []
    for i in range(6):
        pts = shapes.make_instance(rng, i % CLASSES, n=1024, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp_path / f"m{i}.pcd")
        jsave(path, JCloud(xyz=pts))
        files.append((path, i % CLASSES))
    cfg = config()
    cfg["ObjectConfig"]["Children"]["Keypoints"] = {
        "Type": "VoxelGridCulling",
        "Parameters": {"LeafSize": 0.35, "FilterMethodGeometry": "KPQ",
                       "FilterTypeGeometry": "CutOff",
                       "FilterCutoffRatio": 0.3,
                       "DisableFilterInTraining": False}}
    with dense_descriptors():
        want = JIsm(JConfig.from_json(cfg))
        for path, cid in files:
            want.add_training_model(path, cid, cid)
        want.train()
    got = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    for path, cid in files:
        got.add_training_model(path, cid, cid)
    got.train()
    assert_codebooks_match(got.state.codebook, want.state.codebook)
