"""The Harris3D / ISS3D / SIFT3D keypoint detectors of the port
(ops/keypoint_detectors.py, models/keypoints.py, the tiled stages of
ops/tiled.py) against the JAX package on the CPU, dense and tiled, and
through ImplicitShapeModel's training and detection.

The contract (tests/detector_check.py): a point is a keypoint on both
sides or on neither but where the value that decides it lies at the
rounding of what it is compared with (rtol 1e-4, or for SIFT3D within the
bound its intensity's difference puts on a DoG comparison); a refined
Harris3D position kept by both within 1e-4 of the radius.  Features at the
keypoints both found: >= 97% at cosine > 0.999 (the training contract);
detections: the firm maxima (tests/bench_data.firm_mismatches).  The
features are paired through their keypoints
(tests/detector_check.feature_pairs).  The JAX
references of the ImplicitShapeModel tests run in subprocesses
(tests/jax_jobs.py), queued when the module starts."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import detector_check as dc
import shapes
from bench_data import BENCH_CONFIG, FIRM_RTOL, firm_mismatches, unpack_maxima
from jax_jobs import JaxPool
from test_torch_train import assert_codebooks_match
from torch_parity import n, t

import jax.numpy as jnp
from point_cloud_donkey_tpu.models import keypoints as jkp
from point_cloud_donkey_tpu.ops import keypoint_detectors as jkd
from point_cloud_donkey_tpu.ops import tiled as jtiled
from point_cloud_donkey_tpu.ops.normals import pca_normals
from point_cloud_donkey_tpu_torch.models import keypoints as tkp
from point_cloud_donkey_tpu_torch.models.detect_batch import \
    extract_local_features_batch
from point_cloud_donkey_tpu_torch.models.features import (FeatureConfig,
                                                          pad_cloud,
                                                          scene_normals)
from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
from point_cloud_donkey_tpu_torch.ops import keypoint_detectors as tkd
from point_cloud_donkey_tpu_torch.ops import tiled as ttiled
from point_cloud_donkey_tpu_torch.ops.normals import (compute_normals,
                                                      pca_normals_at)
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import read_cloud, save_pcd

CPU = torch.device("cpu")
# the JAX package's own tests' parameters (tests/test_keypoint_detectors.py)
PARAMS = {
    "harris": dict(type="Harris3D", radius=0.3, harris_threshold=1e-4),
    "iss": dict(type="ISS3D", iss_salient_radius=0.4, iss_nonmax_radius=0.1),
    "sift": dict(type="SIFT3D", radius=0.15),
}


def _box(n=1000, seed=0):
    return np.asarray(shapes.box(np.random.default_rng(seed), n), np.float32)


def jax_mask(xyz, params, normals=None):
    """(flags [N], kept positions) of the JAX _detector_keypoints: the
    flags from a run without refinement."""
    pos = jkp._detector_keypoints(xyz, normals, params)
    kept = jkp._detector_keypoints(
        xyz, normals, dataclasses.replace(params, harris_refine=False))
    index = {tuple(p): i for i, p in enumerate(xyz)}
    keep = np.zeros(len(xyz), bool)
    for p in np.asarray(kept):
        keep[index[tuple(p)]] = True
    return keep, np.asarray(pos)


def jax_intensity(xyz, radius):
    """The JAX dense route's SIFT3D intensity of a cloud."""
    from point_cloud_donkey_tpu.models.features import pad_cloud
    pts, mask = pad_cloud(xyz)
    nres = pca_normals(jnp.asarray(pts), jnp.asarray(mask), radius)
    return np.asarray(jnp.where(nres.valid, nres.curvature, 0.0))[:len(xyz)]


def assert_detector_contract(xyz, normals, tparams, keep, pos, want_keep,
                             want_pos, want_intensity=None,
                             want_normals=None):
    """tests/detector_check.py's contract of the port's flags and positions
    (computed on `normals`; JAX's on `want_normals`) against JAX's;
    returns the differing count."""
    bad = []
    if tparams.type == "ISS3D":
        if (keep != want_keep).any():
            bad = dc.unexplained(keep, want_keep, dc.iss_near(
                dc.iss_terms(xyz, tparams), tparams))
    else:
        radius = float(tparams.radius)
        p = t(xyz)
        m = torch.ones(len(xyz), dtype=torch.bool)
        nres = pca_normals_at(p[None], m[None], p[None], m[None], radius)
        if tparams.type == "Harris3D":
            nrm = normals if normals is not None else n(nres.normals[0])
            terms = dc.harris_terms(xyz, nrm, radius,
                                    float(tparams.harris_threshold))
            spread = None if want_normals is None else dc.harris_spread(
                xyz, nrm, want_normals, radius)
            bad = list(dc.unexplained(keep, want_keep, dc.harris_near(
                terms, radius, float(tparams.harris_threshold), spread)))
            jpos = np.zeros_like(pos)
            jpos[want_keep] = want_pos
            bad += list(dc.harris_positions_unexplained(
                pos, jpos, keep & want_keep, terms, radius, spread))
        elif (keep != want_keep).any():
            inten = n(torch.where(nres.valid[0], nres.curvature[0],
                                  torch.zeros(len(xyz))))
            spread = dc.sift_spread(inten, want_intensity)
            bad = dc.unexplained(keep, want_keep, dc.sift_near(
                dc.sift_terms(xyz, inten, radius), spread))
    assert len(bad) == 0, f"{len(bad)} decisions off JAX's away from a tie"
    return int((keep != want_keep).sum())


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_detectors_match_jax_on_same_inputs(kind):
    """The detector functions on one padded cloud (216 points masked at
    1e9) fed the same normals (Harris3D) or intensity (SIFT3D) on both
    sides: the flags under the contract with no spread, Harris3D's
    responses within rtol 1e-5 of the largest."""
    xyz = _box(800)
    pts = np.full((1024, 3), 1e9, np.float32)
    pts[:800] = xyz
    mask = np.arange(1024) < 800
    p = PARAMS[kind]
    radius = p.get("radius", 0.3)
    nres = pca_normals(jnp.asarray(pts), jnp.asarray(mask), radius)
    nrm = np.asarray(nres.normals)
    inten = np.asarray(jnp.where(nres.valid, nres.curvature, 0.0))
    if kind == "harris":
        want = jkd.harris3d(jnp.asarray(pts), jnp.asarray(nrm),
                            jnp.asarray(mask), radius, 1e-4)
        got = tkd.harris3d(t(pts), t(nrm), t(mask), radius, 1e-4)
        r_w, r_g = np.asarray(want.response)[mask], n(got.response)[mask]
        np.testing.assert_allclose(r_g, r_w, atol=1e-5 * np.abs(r_w).max())
    elif kind == "iss":
        want = jkd.iss3d(jnp.asarray(pts), jnp.asarray(mask), 0.4, 0.1)
        got = tkd.iss3d(t(pts), t(mask), 0.4, 0.1)
    else:
        want = jkd.sift3d(jnp.asarray(pts), jnp.asarray(inten),
                          jnp.asarray(mask), radius)
        got = tkd.sift3d(t(pts), t(inten), t(mask), radius)
    wk, gk = np.asarray(want.is_keypoint), n(got.is_keypoint)
    assert not (gk & ~mask).any()
    tparams = tkp.KeypointParams(**p)
    assert gk.sum() >= 1
    assert_detector_contract(
        xyz, nrm[:800] if kind == "harris" else None, tparams, gk[:800],
        n(got.positions)[:800], wk[:800], np.asarray(want.positions)[:800][
            wk[:800]], inten[:800])


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_detect_keypoints_match_jax(kind):
    """detect_keypoints (the per-cloud dispatch: each side's PCA normals
    and curvature) against the JAX package's."""
    xyz = _box()
    tparams = tkp.KeypointParams(**PARAMS[kind])
    keep, pos = tkp.detector_mask(xyz, None, tparams, CPU)
    want_keep, want_pos = jax_mask(xyz, jkp.KeypointParams(**PARAMS[kind]))
    assert keep.sum() >= 1
    got_kp, _ = tkp.detect_keypoints(xyz, None, None, tparams, CPU)
    np.testing.assert_array_equal(got_kp, pos[keep])
    assert_detector_contract(
        xyz, None, tparams, keep, pos, want_keep, want_pos,
        jax_intensity(xyz, tparams.radius) if kind == "sift" else None)


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_tiled_detectors_match_jax(monkeypatch, kind):
    """Above SCENE_TILE_THRESHOLD (moved to 512 in both packages, chunks
    of 512) the tiled route against the JAX tiled route, and against the
    port's dense route on the same cloud (its own intensity: no
    spread)."""
    xyz = _box(1500, seed=3)
    tparams = tkp.KeypointParams(**PARAMS[kind])
    dense_keep, dense_pos = tkp.detector_mask(xyz, None, tparams, CPU)
    for mod in (jtiled, ttiled):
        monkeypatch.setattr(mod, "SCENE_TILE_THRESHOLD", 512)
        monkeypatch.setattr(mod, "NORMALS_CHUNK", 512)
    keep, pos = tkp.detector_mask(xyz, None, tparams, CPU)
    want_keep, want_pos = jax_mask(xyz, jkp.KeypointParams(**PARAMS[kind]))
    assert keep.sum() >= 1
    inten = jax_intensity(xyz, tparams.radius) if kind == "sift" else None
    assert_detector_contract(xyz, None, tparams, keep, pos, want_keep,
                             want_pos, inten)
    own = None
    if kind == "sift":
        p = t(xyz)
        m = torch.ones(len(xyz), dtype=torch.bool)
        nres = pca_normals_at(p[None], m[None], p[None], m[None],
                              tparams.radius)
        own = n(torch.where(nres.valid[0], nres.curvature[0],
                            torch.zeros(len(xyz))))
    assert_detector_contract(xyz, None, tparams, keep, pos, dense_keep,
                             dense_pos[dense_keep], own)


def test_tiled_stages_match_jax():
    """The tiled detector stages (payload moments, neighbour max, Gaussian
    smoothing, SIFT extrema) against the JAX stages on the same plan:
    counts and maxima equal, sums within rtol 1e-5 of the largest, the
    extrema equal but where a point lies at the rounding of the radius."""
    xyz = _box(1500, seed=5)
    order = np.argsort(xyz[:, 0], kind="stable")
    pts = np.ascontiguousarray(xyz[order])
    nq = 3 * 512
    q = np.full((nq, 3), 1e9, np.float32)
    q[:len(pts)] = pts
    qv = np.arange(nq) < len(pts)
    plan = ttiled.plan_tiles(q[:, 0], qv, pts[:, 0], 0.2, 512)
    jplan = jtiled.plan_tiles(q[:, 0], qv, pts[:, 0], 0.2, 512)
    pm = np.ones(len(pts), bool)
    rng = np.random.default_rng(0)
    payload = rng.normal(size=(len(pts), 5)).astype(np.float32)
    values = rng.normal(size=len(pts)).astype(np.float32)
    layers = rng.normal(size=(len(pts), 3)).astype(np.float32)
    k = len(pts)
    c, s = ttiled.tiled_payload_moments(t(q), t(pts), t(payload), t(pm),
                                        plan, 0.2)
    jc, js = jtiled.tiled_payload_moments(q, pts, payload, pm, jplan, 0.2)
    np.testing.assert_array_equal(n(c)[:k], np.asarray(jc)[:k])
    js = np.asarray(js)[:k]
    np.testing.assert_allclose(n(s)[:k], js, atol=1e-5 * np.abs(js).max())
    c, v = ttiled.tiled_neighbor_max(t(q), t(pts), t(values), t(pm), plan,
                                     0.2)
    jc, jv = jtiled.tiled_neighbor_max(q, pts, values, pm, jplan, 0.2)
    np.testing.assert_array_equal(n(c)[:k], np.asarray(jc)[:k])
    np.testing.assert_array_equal(n(v)[:k], np.asarray(jv)[:k])
    # a point at the rounding of the radius may sit in one neighbourhood
    # only (the identity's cross term summed in another order)
    off = dc.band_pairs(pts, 0.1)
    g = ttiled.tiled_gaussian_smooth(t(q), t(pts), t(values), t(pm), plan,
                                     0.05)
    jg = np.asarray(jtiled.tiled_gaussian_smooth(q, pts, values, pm, jplan,
                                                 0.05))[:k]
    np.testing.assert_allclose(n(g)[:k], jg, atol=1e-5 * np.abs(jg).max())
    a, lo, hi = ttiled.tiled_sift_extrema(t(q), t(pts), t(layers), t(pm),
                                          plan, 0.1)
    ja, jlo, jhi = (np.asarray(x)[:k] for x in jtiled.tiled_sift_extrema(
        q, pts, layers, pm, jplan, 0.1))
    np.testing.assert_array_equal(n(a)[:k][~off], ja[~off])
    np.testing.assert_array_equal(n(lo)[:k][~off], jlo[~off])
    np.testing.assert_array_equal(n(hi)[:k][~off], jhi[~off])
    assert off.sum() < 0.02 * k


# -- through ImplicitShapeModel ----------------------------------------------

def detector_config(keypoints: dict, features: dict) -> dict:
    """The bench config with `keypoints` and `features` swapped in."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["Keypoints"] = keypoints
    ch["Features"]["Type"] = features["Type"]
    ch["Features"]["Parameters"].update(features.get("Parameters", {}))
    return cfg


ISM_CONFIGS = {
    "harris_fpfh": detector_config(
        {"Type": "Harris3D", "Parameters": {"Radius": 0.2,
                                            "Threshold": -1e9}},
        {"Type": "FPFH"}),
    "iss_short_cshot": detector_config(
        {"Type": "ISS3D", "Parameters": {"SalientRadius": 0.2,
                                         "NonMaxRadius": 0.1}},
        {"Type": "SHORT_CSHOT"}),
    "sift_short_shot": detector_config(
        {"Type": "SIFT3D", "Parameters": {"Radius": 0.08}},
        {"Type": "SHORT_SHOT", "Parameters": {
            "UseMinRadius": True, "ShortShotMinRadius": 0.1,
            "ShortShotLogRadius": True}}),
}


@pytest.fixture(scope="module")
def ism_files(tmp_path_factory):
    """4 coloured 1024-point training models of 2 classes and 3 fresh
    views as PCD files: ([(path, class)], [path])."""
    from bench_data import bench_colors
    tmp = tmp_path_factory.mktemp("detector_models")
    rng = np.random.default_rng(31)
    files, views = [], []
    for i in range(7):
        pts = shapes.make_instance(rng, i % 2, n=1024, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"c{i}.pcd")
        save_pcd(path, pts, rgb=bench_colors(pts))
        if i < 4:
            files.append((path, i % 2))
        else:
            views.append(path)
    return files, views


# the tiled variant: the scene threshold and chunks moved to these in both
# packages, so the 1024-point clouds take the scene routes
TILES = (512, 512, 64)


@pytest.fixture(scope="module")
def ism_refs(ism_files):
    files, views = ism_files
    pool = JaxPool(3)
    jobs = {}
    for name, cfg in ISM_CONFIGS.items():
        for tiled in (False, True):
            tiles = list(TILES) if tiled else None
            jobs[name, tiled] = (
                pool.call("zoo_jobs:train_detect", cfg=cfg,
                          files=[list(f) for f in files],
                          detect_files=views, tiles=tiles),
                pool.call("zoo_jobs:features", cfg=cfg,
                          files=[f for f, _ in files], tiles=tiles))
    yield jobs
    pool.close()


@pytest.mark.parametrize("tiled", [False, True], ids=["dense", "tiled"])
@pytest.mark.parametrize("name", sorted(ISM_CONFIGS))
def test_detector_training_and_detection_match_jax(monkeypatch, ism_files,
                                                   ism_refs, name, tiled):
    """Each training cloud's keypoints and features against JAX's (the
    contract, the training contract at the keypoints both found); the
    trained codebook under the codebook contract where every keypoint is
    JAX's; detect_batch on three views: the firm maxima of JAX's.  Tiled:
    the same above a scene threshold moved to 512 in both packages (the
    tiled detectors, normals and descriptors)."""
    from types import SimpleNamespace
    if tiled:
        for k, v in zip(("SCENE_TILE_THRESHOLD", "NORMALS_CHUNK",
                         "KEYPOINT_CHUNK"), TILES):
            monkeypatch.setattr(ttiled, k, v)
    files, views = ism_files
    cfg = ISM_CONFIGS[name]
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    for path, cid in files:
        ism.add_training_model(path, cid, cid)
    ism.train()
    job_td, job_f = ism_refs[name, tiled]
    want_f = job_f.result()
    fcfg = FeatureConfig.from_config(ism.config.child("Features"))
    kpp = tkp.KeypointParams.from_config(ism.config.child("Keypoints"))
    nr = ism.root.get("NormalRadius", 0.05)
    cm = ism.root.get("ConsistentNormalsMethod", 2)
    clouds = [read_cloud(f) for f, _ in files]
    fss = extract_local_features_batch(
        [c.xyz for c in clouds], [None] * 4, [c.rgb for c in clouds], fcfg,
        kpp, nr, cm, CPU)
    same = True
    for i, c in enumerate(clouds):
        nrm = None
        if fcfg.needs_normals() and tiled:
            nrm = scene_normals(c.xyz, None, nr, cm, CPU)
        elif fcfg.needs_normals():
            pts, mask = pad_cloud(c.xyz)
            nrm = n(compute_normals(t(pts)[None], t(mask)[None], nr,
                                    cm).normals[0])[:len(c.xyz)]
        keep, pos = tkp.detector_mask(c.xyz, nrm, kpp, CPU)
        diff = assert_detector_contract(
            c.xyz, nrm, kpp, keep, pos, want_f[f"kp_keep{i}"],
            want_f[f"kp_pos{i}"], want_f.get(f"intensity{i}"),
            want_f.get(f"normals{i}"))
        same &= diff == 0
        assert keep.sum() >= 8
        cos, unexplained = dc.feature_pairs(
            pos, keep, fss[i].positions, fss[i].descriptors,
            want_f[f"kp_keep{i}"], want_f[f"kp_pos{i}"],
            want_f[f"feat_pos{i}"], want_f[f"feat_desc{i}"])
        assert unexplained == 0 and len(cos) >= 8
        assert (cos > 0.999).mean() >= 0.97
    want = job_td.result()
    if same:
        assert_codebooks_match(ism.state.codebook, SimpleNamespace(**{
            k[3:]: v for k, v in want.items() if k.startswith("cb_")}))
    got = [m for m, _ in ism.detect_batch(
        [read_cloud(v).xyz for v in views], None,
        [read_cloud(v).rgb for v in views])]
    wmax = unpack_maxima({k[4:]: v for k, v in want.items()
                          if k.startswith("max_")})
    bw = ism.config.child("Voting").get("Bandwidth", 0.1)
    assert sum(map(len, got)) > 0
    for i, (g, w) in enumerate(zip(got, wmax)):
        assert not firm_mismatches(g, w, bw, FIRM_RTOL), (name, i)
