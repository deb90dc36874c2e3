"""The port's scene routes (above ops.tiled.SCENE_TILE_THRESHOLD points)
against the JAX package's on the CPU, with the threshold and the chunks
monkeypatched to 512 / 64 in both packages (tests/test_tiled.py:220-222
does the same to the JAX package alone):

  * a scene's normals (ConsistentNormalsMethod 0-3): >= 99.5% of the
    directions within 1 - |cos| < 1e-3 (tests/test_tiled.py);
  * a scene's local features (models/features.extract_local_features_scene
    against the JAX ``_extract_local_features_scene`` with dense
    descriptors, and against the port's own dense route): the same
    keypoints, >= 98% of the descriptors within rtol 5e-3 / atol 1e-4
    (tests/test_tiled.py:235), for SHOT, CSHOT and SHORT_SHOT;
  * a scene's CSHOT_GLOBAL descriptor (tiled normals, one dense centroid
    keypoint): cosine > 0.999 and the radius within rtol 1e-6
    (tests/test_torch_train_global.py's global contract);
  * the scene preprocessing (SOR, ROR, MLS, voxel filter) with the
    normals and colours re-ordered alongside: the same points kept, the
    positions within rtol 1e-3 / atol 1e-4 (tests/test_tiled.py:135-137);
  * detect_batch of [scene, small, scene, small]: the order kept, each row
    equal bit for bit to detect() of its cloud (a scene's firm detections
    against JAX's: tests/test_torch_detect_ism.py);
  * a training with a scene-scale model among four: the codebook
    contract of tests/test_torch_train.py;
  * eval_detection.py -t / -d on clouds above the threshold: the JAX
    CLI's summary.txt line for line;
  * one scene at the real threshold (34000 points, nothing patched): the
    same keypoints as the JAX package's, every SHORT_SHOT descriptor at
    cosine > 0.999 and >= 95% of them within rtol 5e-3 / atol 1e-4 (the
    JAX dense descriptor gates the radius by the matmul identity, the
    port by exact differences, so the boundary pairs of these larger
    neighbourhoods move a bin; tests/test_torch_short_shot.py).

The clouds are tests/test_tiled.py's noisy ellipsoid shells coloured by
tests/bench_data.bench_colors, and bench scenes of 512-point objects.
"""

import json

import numpy as np
import pytest
import torch

from bench_data import bench_colors, bench_scenes, with_voting
from test_torch_train import CLASSES, assert_codebooks_match, config
from torch_fixtures import CODEBOOK, dense_descriptors

import shapes
from point_cloud_donkey_tpu.models import features as jfeat
from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel as JaxIsm
from point_cloud_donkey_tpu.models.ism import \
    preprocess_cloud as jax_preprocess
from point_cloud_donkey_tpu.ops import tiled as jt
from point_cloud_donkey_tpu.utils.config import ComponentConfig as JaxComp
from point_cloud_donkey_tpu.utils.config import IsmConfig as JaxConfig
from point_cloud_donkey_tpu.utils.io import PointCloud as JaxCloud
from point_cloud_donkey_tpu.utils.io import save_pcd as jax_save_pcd
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models import features as tfeat
from point_cloud_donkey_tpu_torch.models.detect_batch import \
    extract_local_features_batch
from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                     preprocess_cloud)
from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
from point_cloud_donkey_tpu_torch.ops import tiled as tt
from point_cloud_donkey_tpu_torch.utils.config import (ComponentConfig,
                                                       IsmConfig)
from point_cloud_donkey_tpu_torch.utils.io import PointCloud

CPU = torch.device("cpu")


def _cloud(n_pts=2500, seed=7):
    """tests/test_tiled.py's noisy ellipsoid shell, in a random order."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= np.array([1.5, 1.0, 0.6], np.float32)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return pts[rng.permutation(n_pts)]


@pytest.fixture
def scene_scale(monkeypatch):
    """Clouds above 512 points take the scene routes of both packages."""
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "SCENE_TILE_THRESHOLD", 512)
        monkeypatch.setattr(mod, "NORMALS_CHUNK", 64)
        monkeypatch.setattr(mod, "KEYPOINT_CHUNK", 64)


def _directions_agree(a, b):
    dots = np.abs(np.sum(a * b, axis=1))
    assert np.mean(dots > 0.999) > 0.995, np.mean(dots > 0.999)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_scene_normals_match_jax(scene_scale, method):
    xyz = _cloud()
    want = jfeat.compute_cloud_normals(xyz, None, 0.2, method)
    build.reset_launch_counts()
    got = tfeat.scene_normals(xyz, None, 0.2, method, CPU)
    assert set(build.launch_counts().values()) == {0}
    _directions_agree(got, want)
    if method != 2:
        # the orientations too (methods 0, 1, 3 orient the PCA normal)
        assert np.mean(np.sum(got * want, axis=1) > 0.999) > 0.995


def _rows_close(a, b):
    """The share of descriptor rows within rtol 5e-3 / atol 1e-4."""
    return np.mean(np.all(np.abs(a - b) <= 1e-4 + 5e-3 * np.abs(b), axis=1))


@pytest.mark.parametrize("descriptor,method", [("SHOT", 2), ("CSHOT", 0),
                                               ("SHORT_SHOT", 1)])
def test_scene_features_match_jax_and_dense(scene_scale, monkeypatch,
                                            descriptor, method):
    xyz = _cloud()
    rgb = bench_colors(xyz)
    kp_cfg = {"Type": "VoxelGrid", "Parameters": {"LeafSize": 0.25}}
    jfc = jfeat.FeatureConfig(type=descriptor, radius=0.4,
                              ref_frame_radius=0.3)
    with dense_descriptors():
        want = jfeat.extract_local_features(
            xyz, None, jfc, JaxComp.from_json(kp_cfg), 0.2, method, rgb)
    fcfg = tfeat.FeatureConfig(type=descriptor, radius=0.4,
                               ref_frame_radius=0.3)
    kpp = KeypointParams.from_config(ComponentConfig.from_json(kp_cfg))
    build.reset_launch_counts()
    got = extract_local_features_batch([xyz], [None], [rgb], fcfg, kpp, 0.2,
                                       method, CPU, is_training=False)[0]
    assert set(build.launch_counts().values()) == {0}
    # the same keypoints in the same (sorted) order
    np.testing.assert_array_equal(got.positions, want.positions)
    assert _rows_close(got.descriptors, want.descriptors) >= 0.98
    # the port's dense route of the same cloud
    monkeypatch.setattr(tt, "SCENE_TILE_THRESHOLD", 1 << 20)
    dense = extract_local_features_batch([xyz], [None], [rgb], fcfg, kpp,
                                         0.2, method, CPU)[0]
    # the voxel sums run in another point order: match within 1e-5
    d2 = ((got.positions[:, None] - dense.positions[None]) ** 2).sum(-1)
    idx = d2.argmin(1)
    hit = d2[np.arange(len(idx)), idx] <= 1e-10
    assert hit.mean() >= 0.98
    assert _rows_close(got.descriptors[hit], dense.descriptors[idx[hit]]) \
        >= 0.98


def test_scene_global_feature_matches_jax(scene_scale):
    xyz = _cloud(1500, seed=3)
    rgb = bench_colors(xyz)
    gcfg = tfeat.FeatureConfig(type="CSHOT_GLOBAL", radius=0.1,
                               ref_frame_radius=1.0)
    with dense_descriptors():
        want = jfeat.extract_global_features(
            xyz, None, jfeat.FeatureConfig(type="CSHOT_GLOBAL", radius=0.1,
                                           ref_frame_radius=1.0), 0.2, 2,
            rgb)
    got = tfeat.extract_global_features([xyz], [None], [rgb], gcfg, 0.2, 2,
                                        CPU)[0]
    assert got.descriptors.shape == want.descriptors.shape == (1, 1344)
    np.testing.assert_allclose(got.global_radius, want.global_radius,
                               rtol=1e-6)
    a, b = got.descriptors[0], want.descriptors[0]
    assert (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


def test_scene_preprocessing_matches_jax(scene_scale):
    xyz = _cloud(3000, seed=5)
    xyz[::97] += 3.0    # outliers
    rng = np.random.default_rng(2)
    nrm = rng.normal(size=xyz.shape).astype(np.float32)
    rgb = bench_colors(xyz)
    params = {"UseStatisticalOutlierRemoval": True,
              "OutlierRemovalMeanK": 10, "OutlierRemovalStddevMul": 1.0,
              "UseRadiusOutlierRemoval": True, "OutlierRemovalRadius": 0.2,
              "OutlierRemovalMinNeighbors": 5, "UseSmoothing": True,
              "SmoothingRadius": 0.2, "UseVoxelFiltering": True,
              "VoxelLeafSize": 0.05}
    want = jax_preprocess(JaxCloud(xyz=xyz, normals=nrm, rgb=rgb),
                          JaxComp(params=params))
    got = preprocess_cloud(PointCloud(xyz=xyz, normals=nrm, rgb=rgb),
                           ComponentConfig(params=params), CPU)
    assert got.xyz.shape == want.xyz.shape
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.normals, want.normals, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.rgb, want.rgb, rtol=1e-5, atol=1e-6)


SCENE_VOTING = {"Parameters": {"SingleObjectMode": False,
                               "MaxFilterType": "Merge",
                               "AverageRotation": True,
                               "MinVotesThreshold": 2}}


def test_mixed_detect_batch_keeps_order_and_rows(scene_scale):
    """detect_batch of [scene, small, scene, small] with the bench SHOT
    model: the scenes take the scene route, the small clouds the batched
    one; the order is kept, each row equals detect() of its cloud bit for
    bit, and the small rows the batch of the small clouds alone (a scene
    against the JAX package: tests/test_torch_detect_ism.py)."""
    scenes, _, _ = bench_scenes(2, n=512, seed=12)
    small = bench_scenes(2, n=100, seed=3)[0]
    clouds = [scenes[0], small[0], scenes[1], small[1]]
    with open(CODEBOOK) as f:
        cfg = with_voting(json.load(f), SCENE_VOTING)
    ism = ImplicitShapeModel.load(CODEBOOK, device="cpu")
    ism.config = IsmConfig.from_json(cfg)
    build.reset_launch_counts()
    got = [m for m, _ in ism.detect_batch(clouds)]
    assert set(build.launch_counts().values()) == {0}
    assert got[0] and got[2]
    alone = [m for m, _ in ism.detect_batch([small[0], small[1]])]
    for i, cloud in enumerate(clouds):
        _assert_bit_equal(ism.detect(cloud)[0], got[i])
    _assert_bit_equal(alone[0], got[1])
    _assert_bit_equal(alone[1], got[3])


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("class_id", "instance_id", "weight", "instance_weight",
                  "num_votes"):
            assert getattr(x, f) == getattr(y, f), f
        for f in ("position", "bb_size", "bb_quat"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_training_with_scene_models_matches_jax(scene_scale, tmp_path):
    """Four models of three classes, one of them (2048 points) above the
    patched threshold: it takes the scene route, decided per cloud, and
    the codebook meets the training contract against JAX's training."""
    rng = np.random.default_rng(11)
    files = []
    for i in range(4):
        n_pts = 2048 if i == 1 else 512
        pts = shapes.make_instance(rng, i % CLASSES, n=n_pts, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp_path / f"m{i}.pcd")
        jax_save_pcd(path, JaxCloud(xyz=pts))
        files.append((path, i % CLASSES))
    cfg = config()
    cfg["ObjectConfig"]["Parameters"]["NormalRadius"] = 0.35
    with dense_descriptors():
        jax_ism = JaxIsm(JaxConfig.from_json(cfg))
        for path, cid in files:
            jax_ism.add_training_model(path, cid, cid)
        jax_ism.train()
    calls = []
    real = tfeat.extract_local_features_scene
    import point_cloud_donkey_tpu_torch.models.detect_batch as tdb
    old = tdb.extract_local_features_scene
    tdb.extract_local_features_scene = \
        lambda *a, **k: calls.append(len(a[0])) or real(*a, **k)
    try:
        ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
        for path, cid in files:
            ism.add_training_model(path, cid, cid)
        ism.train()
    finally:
        tdb.extract_local_features_scene = old
    assert calls == [2048]
    assert_codebooks_match(ism.state.codebook, jax_ism.state.codebook)


def test_scene_features_at_the_real_threshold():
    """Nothing patched: a 34000-point shell takes the scene route of both
    packages, with the shipped chunks."""
    xyz = _cloud(34000, seed=9)
    assert len(xyz) > tt.SCENE_TILE_THRESHOLD == jt.SCENE_TILE_THRESHOLD
    kp_cfg = {"Type": "VoxelGrid", "Parameters": {"LeafSize": 0.2}}
    with dense_descriptors():
        want = jfeat.extract_local_features(
            xyz, None, jfeat.FeatureConfig(type="SHORT_SHOT", radius=0.1,
                                           ref_frame_radius=0.1),
            JaxComp.from_json(kp_cfg), 0.05, 1)
    got = extract_local_features_batch(
        [xyz], [None], [None],
        tfeat.FeatureConfig(type="SHORT_SHOT", radius=0.1,
                            ref_frame_radius=0.1),
        KeypointParams(leaf_size=0.2), 0.05, 1, CPU)[0]
    np.testing.assert_array_equal(got.positions, want.positions)
    a, b = got.descriptors, want.descriptors
    assert ((a * b).sum(1) > 0.999).all()
    assert _rows_close(a, b) >= 0.95


def test_scene_scale_filters_train_as_jax(scene_scale, tmp_path):
    """Models above the (patched) scene threshold with SOR, ROR and MLS on:
    the filters and the features take the scene routes of both packages,
    and the codebook meets the training contract against JAX's."""
    rng = np.random.default_rng(5)
    files = []
    for i in range(3):
        pts = shapes.make_instance(rng, i % CLASSES, n=1024, rotate=True,
                                   noise=0.005).astype(np.float32)
        pts[::101] += 2.0    # outliers for SOR / ROR
        path = str(tmp_path / f"s{i}.pcd")
        jax_save_pcd(path, JaxCloud(xyz=pts))
        files.append((path, i % CLASSES))
    cfg = config()
    cfg["ObjectConfig"]["Parameters"].update(
        UseStatisticalOutlierRemoval=True, OutlierRemovalMeanK=10,
        OutlierRemovalStddevMul=2.0, UseRadiusOutlierRemoval=True,
        OutlierRemovalRadius=0.3, OutlierRemovalMinNeighbors=3,
        UseSmoothing=True, SmoothingRadius=0.2, NormalRadius=0.35)
    with dense_descriptors():
        jax_ism = JaxIsm(JaxConfig.from_json(cfg))
        for path, cid in files:
            jax_ism.add_training_model(path, cid, cid)
        jax_ism.train()
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    for path, cid in files:
        ism.add_training_model(path, cid, cid)
    ism.train()
    assert_codebooks_match(ism.state.codebook, jax_ism.state.codebook)


def test_eval_detection_on_scenes_matches_jax(scene_scale, tmp_path):
    """eval_detection.py -t / -d with every cloud above the (patched)
    scene threshold -- the models and the scene of
    tests/test_torch_detect_ism.py's CLI test -- beside the JAX CLI on the
    same files: summary.txt equal line for line but for its timing
    lines."""
    import re
    from test_torch_detect_ism import _detection_files
    from point_cloud_donkey_tpu.cli.eval_detection import main as jax_eval
    from point_cloud_donkey_tpu_torch import eval_detection
    cfg = _detection_files(tmp_path, np.random.default_rng(0))
    flist, tlist = str(tmp_path / "train.txt"), str(tmp_path / "test.txt")
    with dense_descriptors():
        assert jax_eval(["-t", cfg, "-f", flist,
                         "-o", str(tmp_path / "jax")]) == 0
        assert jax_eval(["-d", str(tmp_path / "jax.ism"), "-f", tlist,
                         "-o", str(tmp_path / "jax_out")]) == 0
    assert eval_detection.main(["-t", cfg, "-f", flist, "-o",
                                str(tmp_path / "port"),
                                "--device", "cpu"]) == 0
    assert eval_detection.main(["-d", str(tmp_path / "port.ism"), "-f",
                                tlist, "-o", str(tmp_path / "port_out"),
                                "--device", "cpu"]) == 0
    got = (tmp_path / "port_out" / "summary.txt").read_text().splitlines()
    want = (tmp_path / "jax_out" / "summary.txt").read_text().splitlines()
    assert got[:-2] == want[:-2]
    m = re.search(r"mean recall:\s+([0-9.]+)", "\n".join(got))
    assert m and float(m.group(1)) >= 0.5


def test_scene_path_refuses_lrf_version_2(scene_scale):
    """lrf_version 2 (K10 / K11's moment identity) is refused by name above
    the scene threshold; the scene path runs K1 / K2 (PERF.md: the frame
    readings behind it)."""
    xyz = _cloud()
    fcfg = tfeat.FeatureConfig(type="SHOT", radius=0.4, ref_frame_radius=0.3)
    with pytest.raises(NotImplementedError, match="lrf_version 2"):
        extract_local_features_batch([xyz], [None], [None], fcfg,
                                     KeypointParams(leaf_size=0.25), 0.2, 2,
                                     CPU, lrf_version=2)
