"""The gathered-neighbour descriptors of the port against the JAX package on
the CPU: ops/neighbors.gather_radius_neighbors (and its tiled form), FPFH
(ops/fpfh.py), SHORT_CSHOT and SHORT_SHOT's minimum and log radius
(ops/short_shot.py; the latter through K9's plain twin), and the training
and detection of configurations with them through ImplicitShapeModel.

Contracts:
  * the gather: indices equal but among equal distances, distances within
    rtol 1e-6, validity equal but where a pair lies at the rounding of the
    radius;
  * FPFH: atol 0.15 against JAX and the golden rows (the JAX golden test's
    own tolerance: the blocks sum to 100, and a pair on a bin edge moves
    100 / #neighbours);
  * SHORT_CSHOT: atol 2e-3 (the golden test's); SHORT_SHOT's radius modes:
    tests/test_torch_short_shot.py's descriptor contract;
  * training: tests/test_torch_train.py's codebook contract; detection:
    the firm detections of tests/bench_data.firm_mismatches.
The JAX references of the trainings and detections run in subprocesses
(tests/jax_jobs.py), queued when the module starts."""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import shapes
from bench_data import BENCH_CONFIG, bench_colors, firm_mismatches
from jax_jobs import JaxPool
from test_torch_train import assert_codebooks_match
from torch_parity import assert_descriptors_close, n, t

import jax.numpy as jnp
from point_cloud_donkey_tpu.ops import fpfh as jfpfh
from point_cloud_donkey_tpu.ops import neighbors as jnb
from point_cloud_donkey_tpu.ops import short_shot as jss
from point_cloud_donkey_tpu.ops import tiled as jtiled
from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
from point_cloud_donkey_tpu_torch.ops import fpfh as tfpfh
from point_cloud_donkey_tpu_torch.ops import neighbors as tnb
from point_cloud_donkey_tpu_torch.ops import short_shot as tss
from point_cloud_donkey_tpu_torch.ops import tiled as ttiled
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "descriptors.npz")
RADIUS = 0.6   # the golden fixture's
N_POINTS = 1024


def _cloud(seed=0, n=500):
    """A noisy ellipsoid with duplicated points (equal distances) and a
    masked tail parked at 1e9."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p *= np.array([1.3, 0.8, 0.5], np.float32)
    p += rng.normal(scale=0.01, size=p.shape).astype(np.float32)
    p[10] = p[11]
    p[30:36] = p[30]
    mask = np.ones(n, bool)
    mask[-40:] = False
    p[-40:] = 1e9
    nrm = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-6)
    return p, mask, nrm.astype(np.float32)


def assert_gather_close(got, want, queries, points, radius):
    """The gather contract (module docstring)."""
    gi, gd, gv = n(got.idx), n(got.dist), n(got.valid)
    wi, wd, wv = (np.asarray(x) for x in (want.idx, want.dist, want.valid))
    d2 = ((points[None, :, :] - queries[:, None, :]) ** 2).sum(-1)
    r2 = np.float32(radius * radius)
    band = (np.abs(d2 - r2) <= 1e-5 * r2).any(1)
    rows = ~band
    np.testing.assert_array_equal(gv[rows], wv[rows])
    # slot by slot: an index may differ only where its distance ties
    # within the rtol (two near-equal keys ordered by another rounding)
    both = gv & wv
    np.testing.assert_allclose(gd[both], wd[both], rtol=1e-6)
    assert (gi[both] == wi[both]).mean() > 0.99


@pytest.mark.parametrize("capacity,exclude_zero",
                         [(8, False), (64, True), (4096, True), (200, False)])
def test_gather_matches_jax(capacity, exclude_zero):
    p, m, _ = _cloud()
    q = np.concatenate([p[:60], np.random.default_rng(1).normal(
        size=(20, 3)).astype(np.float32)])
    got = tnb.gather_radius_neighbors(t(q), t(p), t(m), 0.3, capacity,
                                      exclude_zero)
    want = jnb.gather_radius_neighbors(jnp.asarray(q), jnp.asarray(p),
                                       jnp.asarray(m), 0.3, capacity,
                                       exclude_zero)
    assert got.idx.shape == (len(q), min(capacity, len(p)))
    assert_gather_close(got, want, q, p, 0.3)


def test_batched_gather_is_per_cloud():
    """A batch's rows equal each cloud's gather alone."""
    clouds = [_cloud(s) for s in range(3)]
    p = np.stack([c[0] for c in clouds])
    m = np.stack([c[1] for c in clouds])
    got = tnb.gather_radius_neighbors(t(p[:, :50]), t(p), t(m), 0.25, 32)
    for i in range(3):
        one = tnb.gather_radius_neighbors(t(p[i, :50]), t(p[i]), t(m[i]),
                                          0.25, 32)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)


def test_tiled_gather_matches_dense_and_jax():
    """The windowed gather over a sorted cloud (chunks of 64 queries)
    equals the dense gather, and the JAX tiled gather under the gather
    contract."""
    p, m, _ = _cloud(3, 1500)
    p, m = p[m], m[m]
    order = np.argsort(p[:, 0], kind="stable")
    p = np.ascontiguousarray(p[order])
    plan = ttiled.plan_tiles(p[:, 0], np.ones(len(p), bool), p[:, 0], 0.2,
                             64, min_window=256)
    got = ttiled.tiled_gather_radius_neighbors(t(p), t(p), t(m), plan, 0.2,
                                               48, True)
    dense = tnb.gather_radius_neighbors(t(p), t(p), t(m), 0.2, 48, True)
    assert torch.equal(got.valid, dense.valid)
    assert torch.equal(torch.where(got.valid, got.idx, 0),
                       torch.where(dense.valid, dense.idx, 0))
    torch.testing.assert_close(got.dist, dense.dist, rtol=1e-6, atol=0)
    # the JAX stage slices whole chunks: its callers pad the queries
    q = np.full((plan.n_chunks * 64, 3), 1e9, np.float32)
    q[:len(p)] = p
    qv = np.arange(len(q)) < len(p)
    jplan = jtiled.plan_tiles(q[:, 0], qv, p[:, 0], 0.2, 64,
                              min_window=256)
    want = jtiled.tiled_gather_radius_neighbors(q, p, m, jplan, 0.2, 48,
                                                True)
    want = type(want)(*(np.asarray(x)[:len(p)] for x in want))
    want = want._replace(idx=np.where(want.valid, want.idx, 0))
    assert_gather_close(got, want, p, p, 0.2)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_fpfh_matches_golden(golden):
    pts, nrm, kp = golden["points"], golden["normals"], golden["keypoints"]
    res = tfpfh.fpfh_descriptor(
        t(kp), torch.ones(len(kp), dtype=torch.bool), t(pts), t(nrm),
        torch.ones(len(pts), dtype=torch.bool), RADIUS, capacity=len(pts))
    assert bool(res.valid.all())
    np.testing.assert_allclose(n(res.descriptors), golden["fpfh"], atol=0.15)


@pytest.mark.parametrize("capacity", [128, 24])
def test_fpfh_matches_jax(capacity):
    """Three clouds in one batch (masked tails, duplicated points, some
    keypoints on points, some off) against the JAX fpfh_descriptor of each
    cloud; FPFH's block sums stay 100 (K4's input range)."""
    clouds = [_cloud(s) for s in range(3)]
    p = np.stack([c[0] for c in clouds])
    m = np.stack([c[1] for c in clouds])
    nrm = np.stack([c[2] for c in clouds])
    kp = np.concatenate([p[:, :30], p[:, 100:110] + 0.01], 1)
    kpm = np.ones(kp.shape[:2], bool)
    kpm[:, -3:] = False
    got = tfpfh.fpfh_descriptor(t(kp), t(kpm), t(p), t(nrm), t(m), 0.25,
                                capacity)
    for i in range(3):
        want = jfpfh.fpfh_descriptor(jnp.asarray(kp[i]), jnp.asarray(kpm[i]),
                                     jnp.asarray(p[i]), jnp.asarray(nrm[i]),
                                     jnp.asarray(m[i]), 0.25, capacity)
        np.testing.assert_array_equal(n(got.valid[i]), np.asarray(want.valid))
        np.testing.assert_allclose(n(got.descriptors[i]),
                                   np.asarray(want.descriptors), atol=0.15)
    v = n(got.valid)
    sums = n(got.descriptors)[v].reshape(-1, 3, 11).sum(-1)
    np.testing.assert_allclose(sums, 100.0, rtol=1e-5)


def _golden_short(golden):
    pts, rgb = golden["points"], golden["rgb"]
    kp, kp_rgb = golden["keypoints"], golden["kp_rgb"]
    frames = golden["frames"].astype(np.float32)
    return pts, rgb, kp, kp_rgb, frames


def test_short_cshot_matches_golden(golden):
    pts, rgb, kp, kp_rgb, frames = _golden_short(golden)
    nbr = tnb.gather_radius_neighbors(t(kp)[None], t(pts)[None],
                                      torch.ones((1, len(pts)), dtype=bool),
                                      RADIUS, len(pts))
    res = tss.short_cshot_descriptor(
        t(kp)[None], t(kp_rgb)[None], t(frames)[None],
        torch.ones((1, len(kp)), dtype=bool), t(pts)[None], t(rgb)[None],
        nbr, RADIUS)
    assert bool(res.valid.all())
    np.testing.assert_allclose(n(res.descriptors[0]), golden["short_cshot"],
                               atol=2e-3)


MODES = {"min": (0.12, False), "log": (0.0, True), "min_log": (0.06, True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_short_cshot_radius_modes_match_jax(golden, mode):
    pts, rgb, kp, kp_rgb, frames = _golden_short(golden)
    mr, lr = MODES[mode]
    ones = np.ones(len(pts), bool)
    jn = jnb.gather_radius_neighbors(jnp.asarray(kp), jnp.asarray(pts),
                                     jnp.asarray(ones), RADIUS, len(pts))
    want = jss.short_cshot_descriptor(
        jnp.asarray(kp), jnp.asarray(kp_rgb), jnp.asarray(frames),
        jnp.ones(len(kp), bool), jnp.asarray(pts), jnp.asarray(rgb), jn,
        RADIUS, min_radius=mr, log_radius=lr)
    nbr = tnb.gather_radius_neighbors(t(kp)[None], t(pts)[None],
                                      t(ones)[None], RADIUS, len(pts))
    got = tss.short_cshot_descriptor(
        t(kp)[None], t(kp_rgb)[None], t(frames)[None],
        torch.ones((1, len(kp)), dtype=bool), t(pts)[None], t(rgb)[None],
        nbr, RADIUS, min_radius=mr, log_radius=lr)
    np.testing.assert_array_equal(n(got.valid[0]), np.asarray(want.valid))
    np.testing.assert_allclose(n(got.descriptors[0]),
                               np.asarray(want.descriptors), atol=2e-3)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_short_shot_radius_modes_match_jax(mode):
    """K9's plain twin (a batch of two clouds) with a minimum radius, the
    log radius and both against the JAX SHORT_SHOT of each cloud over a
    gather of all its points: the descriptor contract.  The keypoints lie
    on points: the JAX dense form gates the zero-distance self pair on the
    matmul identity, which rounds it above 1e-15 for some, so it is held
    to the gathered form, which excludes the pair on exact distances, as
    the port does."""
    from point_cloud_donkey_tpu.ops.lrf import shot_lrf as jlrf
    mr, lr = MODES[mode]
    clouds = [_cloud(s, 700) for s in (4, 5)]
    p = np.stack([c[0] for c in clouds])
    m = np.stack([c[1] for c in clouds])
    kp = p[:, ::12][:, :48]
    res = [jlrf(jnp.asarray(kp[i]), jnp.ones(len(kp[i]), bool),
                jnp.asarray(p[i]), jnp.asarray(m[i]), 0.5) for i in range(2)]
    fr = np.stack([np.asarray(r.frames) for r in res])
    fv = np.stack([np.asarray(r.valid) for r in res])
    got = tss.short_shot_descriptor_dense(t(kp), t(fr), t(fv), t(p), t(m),
                                          0.6, 2, 2, 8, mr, lr)
    for i in range(2):
        nbr = jnb.gather_radius_neighbors(jnp.asarray(kp[i]),
                                          jnp.asarray(p[i]),
                                          jnp.asarray(m[i]), 0.6, p.shape[1])
        want = jss.short_shot_descriptor(
            jnp.asarray(kp[i]), jnp.asarray(fr[i]), jnp.asarray(fv[i]),
            jnp.asarray(p[i]), nbr, 0.6, 2, 2, 8, mr, lr)
        assert n(got.valid[i]).sum() > 30
        assert_descriptors_close(got.descriptors[i], got.valid[i],
                                 want.descriptors, want.valid)


# -- training and detection through ImplicitShapeModel -----------------------

def zoo_config(features: dict, globals_: dict = None) -> dict:
    """The bench config (tests/bench_data.BENCH_CONFIG) with Features
    `features`, the global features `globals_`."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["Features"]["Type"] = features["Type"]
    ch["Features"]["Parameters"].update(features.get("Parameters", {}))
    if globals_:
        ch["GlobalFeatures"] = globals_
        cfg["ObjectConfig"]["Parameters"]["UseSvmTraining"] = False
    return cfg


TRAININGS = {
    "fpfh": zoo_config({"Type": "FPFH"}),
    "short_cshot": zoo_config(
        {"Type": "SHORT_CSHOT"},
        {"Type": "SHORT_CSHOT_GLOBAL", "Parameters": {
            "ReferenceFrameRadius": 0.5}}),
    "short_shot_min_log": zoo_config({"Type": "SHORT_SHOT", "Parameters": {
        "UseMinRadius": True, "ShortShotMinRadius": 0.1,
        "ShortShotLogRadius": True}}),
}


@pytest.fixture(scope="module")
def zoo_files(tmp_path_factory):
    """4 coloured training models of 2 classes and 3 fresh views, as PCD
    files: ([(path, class)], [path])."""
    tmp = tmp_path_factory.mktemp("zoo_models")
    rng = np.random.default_rng(21)
    files, views = [], []
    for i in range(4):
        pts = shapes.make_instance(rng, i % 2, n=N_POINTS, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"m{i}.pcd")
        save_pcd(path, pts, rgb=bench_colors(pts))
        files.append((path, i % 2))
    for i in range(3):
        pts = shapes.make_instance(rng, i % 2, n=N_POINTS, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"v{i}.pcd")
        save_pcd(path, pts, rgb=bench_colors(pts))
        views.append(path)
    return files, views


@pytest.fixture(scope="module")
def jax_refs(zoo_files):
    """The JAX trainings of TRAININGS and the FPFH detection, queued at
    once."""
    files, views = zoo_files
    pool = JaxPool(3)
    jobs = {name: pool.call("zoo_jobs:train_detect", cfg=cfg,
                            files=[list(f) for f in files],
                            detect_files=views if name == "fpfh" else [])
            for name, cfg in TRAININGS.items()}
    yield jobs
    pool.close()


def port_train(files, cfg):
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    for path, cid in files:
        ism.add_training_model(path, cid, cid)
    ism.train()
    return ism


@pytest.mark.parametrize("name", sorted(TRAININGS))
def test_training_matches_jax(zoo_files, jax_refs, name):
    """The port's training of FPFH, SHORT_CSHOT with SHORT_CSHOT_GLOBAL
    and SHORT_SHOT with a minimum and log radius (VoxelGrid keypoints)
    against the JAX package's: the codebook contract; the global
    descriptors within 2e-3."""
    files, _ = zoo_files
    got = port_train(files, TRAININGS[name])
    want = jax_refs[name].result()
    assert_codebooks_match(got.state.codebook, SimpleNamespace(**{
        k[3:]: v for k, v in want.items() if k.startswith("cb_")}))
    if "glob_desc" in want:
        np.testing.assert_allclose(got.state.global_descriptors,
                                   want["glob_desc"], atol=2e-3)


def test_fpfh_detection_matches_jax(zoo_files, jax_refs):
    """detect_batch of an FPFH model on three fresh views: the firm
    detections of the JAX package's detect_batch (its own model)."""
    from bench_data import FIRM_RTOL, unpack_maxima
    from point_cloud_donkey_tpu_torch.utils.io import read_cloud
    files, views = zoo_files
    ism = port_train(files, TRAININGS["fpfh"])
    clouds = [read_cloud(v).xyz for v in views]
    got = [m for m, _ in ism.detect_batch(clouds)]
    ref = jax_refs["fpfh"].result()
    want = unpack_maxima({k[4:]: v for k, v in ref.items()
                          if k.startswith("max_")})
    bw = ism.config.child("Voting").get("Bandwidth", 0.1)
    assert sum(map(len, got)) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert not firm_mismatches(g, w, bw, FIRM_RTOL), i
