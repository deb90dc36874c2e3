"""The whole-cloud global descriptors, USC_GLOBAL and NARF through the
port's ImplicitShapeModel against the JAX package's on the CPU, and RIFT
on the scene route:

  * ESF, VFH, GRSD, GASD with and without colour, CVFH, OURCVFH and
    USC_GLOBAL as the verification features of the bench config (SHOT
    local features; single-object verification, CVFH also per maximum, on
    its several rows a ROI): the training contract of
    tests/test_torch_train.py, the same global rows each at cosine > 0.999
    (ESF within 1e-3: the same sample indices), the firm detections;
  * NARF on rendered camera views (tests/kinect_data.object_view; the
    bench shapes are centred on the camera, half behind it) at a 160 x
    120 range image: the training contract and the firm detections;
  * RIFT on the scene route (ops.tiled's threshold and chunks patched to
    512 / 64 in both packages, as tests/test_torch_scene.py does; RIFT's
    window margin doubles): the same keypoints, >= 98% of the descriptor
    rows within rtol 5e-3 / atol 1e-4.
The JAX references of the trainings run in subprocesses
(tests/jax_jobs.py), queued when the module starts."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest

import kinect_data
import shapes
from bench_data import BENCH_CONFIG, bench_colors
from jax_jobs import JaxPool
from test_torch_train import assert_codebooks_match
from test_torch_zoo2 import assert_detections_match, port_train
from point_cloud_donkey_tpu.models import features as jfeat
from point_cloud_donkey_tpu.ops import tiled as jt
from point_cloud_donkey_tpu.utils.config import ComponentConfig as JaxComp
from point_cloud_donkey_tpu_torch.models import features as tfeat
from point_cloud_donkey_tpu_torch.models.detect_batch import \
    extract_local_features_batch
from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
from point_cloud_donkey_tpu_torch.ops import tiled as tt
from point_cloud_donkey_tpu_torch.utils.config import ComponentConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

N_POINTS = 1024


def global_config(gtype: str, params: dict = None,
                  single_object: bool = True) -> dict:
    """The bench config verifying with the global features `gtype`."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["GlobalFeatures"] = {"Type": gtype, "Parameters": {
        "Radius": 0.3, "ReferenceFrameRadius": 2.0, **(params or {})}}
    ch["Voting"]["Parameters"].update({"UseGlobalFeatures": True,
                                       "SingleObjectMode": single_object})
    cfg["ObjectConfig"]["Parameters"]["UseSvmTraining"] = False
    return cfg


GLOBALS = {
    "esf": global_config("ESF"),
    "vfh": global_config("VFH"),
    "grsd": global_config("GRSD"),
    "gasd": global_config("GASD"),
    "gasd_shape": global_config("GASD", {"GasdWithColor": False}),
    "cvfh": global_config("CVFH", {"CvfhClusterTolerance": 0.1,
                                   "CvfhMinPoints": 40}),
    "cvfh_rois": global_config("CVFH", {"CvfhClusterTolerance": 0.1,
                                        "CvfhMinPoints": 40}, False),
    "ourcvfh": global_config("OURCVFH", {"CvfhClusterTolerance": 0.1,
                                         "CvfhMinPoints": 40}),
    "usc_global": global_config("USC_GLOBAL"),
}


def narf_config() -> dict:
    """The bench config with NARF at a 160 x 120 range image of a Kinect's
    field of view (focal 525 / 4), at the object views' scale."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["Features"] = {"Type": "NARF", "Parameters": {
        "Radius": 0.06, "ReferenceFrameRadius": 0.05,
        "NarfImageWidth": 160, "NarfImageHeight": 120,
        "NarfFocalLength": 131.25}}
    ch["Voting"]["Parameters"]["Bandwidth"] = 0.1
    return cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(models [(path, class)], views [path]) of the bench shapes (4 + 3,
    coloured) and of the camera views (4 + 2)."""
    tmp = tmp_path_factory.mktemp("zoo2_global")
    rng = np.random.default_rng(29)
    paths = []
    for i in range(7):
        pts = shapes.make_instance(rng, i % 2, n=N_POINTS, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"s{i}.pcd")
        save_pcd(path, pts, rgb=bench_colors(pts))
        paths.append(path)
    cams = []
    for i, (cid, yaw) in enumerate([(0, 0.2), (3, 0.9), (0, 2.0), (3, 2.6),
                                    (0, 1.1), (3, 1.7)]):
        v = kinect_data.object_view(cid, 0.8, yaw, seed=40 + i)
        path = str(tmp / f"v{i}.pcd")
        save_pcd(path, v.xyz, rgb=v.rgb)
        cams.append((path, 0 if cid == 0 else 1))
    return ([(p, i % 2) for i, p in enumerate(paths[:4])], paths[4:],
            cams[:4], [p for p, _ in cams[4:]])


@pytest.fixture(scope="module")
def jax_refs(files):
    models, views, cam_models, cam_views = files
    pool = JaxPool(4)
    jobs = {name: pool.call("zoo_jobs:train_detect", cfg=cfg,
                            files=[list(f) for f in models],
                            detect_files=views)
            for name, cfg in GLOBALS.items()}
    jobs["narf"] = pool.call("zoo_jobs:train_detect", cfg=narf_config(),
                             files=[list(f) for f in cam_models],
                             detect_files=cam_views)
    yield jobs
    pool.close()


def _codebook(ref):
    return SimpleNamespace(**{k[3:]: v for k, v in ref.items()
                              if k.startswith("cb_")})


@pytest.mark.parametrize("name", sorted(GLOBALS))
def test_global_type_trains_and_verifies_as_jax(files, jax_refs, name):
    models, views, _, _ = files
    ism = port_train(models, GLOBALS[name])
    want = jax_refs[name].result()
    assert_codebooks_match(ism.state.codebook, _codebook(want))
    got, ref = ism.state.global_descriptors, want["glob_desc"]
    assert got.shape == ref.shape
    if name == "esf":
        np.testing.assert_allclose(got, ref, atol=1e-3)
    cos = (got * ref).sum(1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1), 1e-30)
    print(f"{name}: {len(got)} global rows, min cosine {cos.min():.6f}, "
          f"max |delta| {np.abs(got - ref).max():.3g}")
    assert cos.min() > 0.999
    maxima = assert_detections_match(ism, views, want)
    assert sum(map(len, maxima)) > 0


def test_narf_trains_and_detects_as_jax(files, jax_refs):
    _, _, cam_models, cam_views = files
    ism = port_train(cam_models, narf_config())
    want = jax_refs["narf"].result()
    assert len(ism.state.codebook.codewords) >= 8
    assert_codebooks_match(ism.state.codebook, _codebook(want))
    assert_detections_match(ism, cam_views, want)


@pytest.fixture
def scene_scale(monkeypatch):
    """Clouds above 512 points take the scene routes of both packages."""
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "SCENE_TILE_THRESHOLD", 512)
        monkeypatch.setattr(mod, "NORMALS_CHUNK", 64)
        monkeypatch.setattr(mod, "KEYPOINT_CHUNK", 64)


def test_rift_scene_route_matches_jax(scene_scale):
    rng = np.random.default_rng(7)
    xyz = rng.normal(size=(2500, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    xyz *= np.array([1.5, 1.0, 0.6], np.float32)
    xyz += rng.normal(scale=0.01, size=xyz.shape).astype(np.float32)
    rgb = bench_colors(xyz)
    kp_cfg = {"Type": "VoxelGrid", "Parameters": {"LeafSize": 0.25}}
    want = jfeat.extract_local_features(
        xyz, None, jfeat.FeatureConfig(type="RIFT", radius=0.3,
                                       ref_frame_radius=0.3),
        JaxComp.from_json(kp_cfg), 0.2, 2, rgb)
    got = extract_local_features_batch(
        [xyz], [None], [rgb], tfeat.FeatureConfig(type="RIFT", radius=0.3,
                                                  ref_frame_radius=0.3),
        KeypointParams.from_config(ComponentConfig.from_json(kp_cfg)), 0.2,
        2, "cpu", is_training=False)[0]
    np.testing.assert_array_equal(got.positions, want.positions)
    close = np.all(np.abs(got.descriptors - want.descriptors)
                   <= 1e-4 + 5e-3 * np.abs(want.descriptors), axis=1)
    print(f"RIFT scene route: {len(close)} rows, {close.mean():.4f} within "
          "rtol 5e-3 / atol 1e-4")
    assert close.mean() >= 0.98
