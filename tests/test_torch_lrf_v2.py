"""The v2 LRF kernels' twins (K10 moments on the matmul identity with
bf16x3 products, K11 sign votes with the identity gate) against the JAX
package's `_moments_call_v2` / `_sign_votes_call_v2` in interpret mode
(in a process of their own, torch_parity.pallas_interpret), the LRF and
the classify step with lrf_version 2, and the training normals
(radius_covariance, compute_normals method 2) against their JAX
counterparts.  tests/test_torch_cuda.py holds K10 / K11 against these
twins on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapes
from torch_fixtures import CODEBOOK, REFERENCE
from torch_parity import assert_decisions_match, assert_frames_close, n, \
    pallas_interpret, t

from point_cloud_donkey_tpu.ops.neighbors import \
    radius_covariance as j_radius_covariance
from point_cloud_donkey_tpu.ops.normals import \
    compute_normals as j_compute_normals
from point_cloud_donkey_tpu_torch import serve
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import lrf as tlrf
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm
from point_cloud_donkey_tpu_torch.ops.neighbors import radius_covariance
from point_cloud_donkey_tpu_torch.ops.normals import compute_normals
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

RADIUS = 0.4


@pytest.fixture(scope="module")
def cloud():
    """A 700-point shape with every 50th point masked, queries at every
    9th point, and sign-vote axes (the port's v1 EVD at those queries)."""
    p = shapes.make_instance(np.random.default_rng(7), 1, n=700,
                             rotate=False).astype(np.float32)
    m = np.ones(len(p), bool)
    m[::50] = False
    kp = p[::9].copy()
    km = np.ones(len(kp), bool)
    q_s, p_s = tlrfm.prep_shift(t(kp)[None], t(p)[None], t(m)[None])
    mom, _ = tlrfm.moments(q_s, p_s, t(m)[None], RADIUS)
    _, _, axes, _ = tlrfm._evd_axes(mom, q_s, t(km)[None], False)
    return p, m, kp, km, n(axes)[0]


@pytest.fixture(scope="module")
def pallas_v2(cloud, tmp_path_factory):
    """The JAX v2 kernels in interpret mode: moments (both weightings, via
    lrf_moments), the raw K11 votes, and shot_lrf_pallas (z_only off and
    on) under PCD_PALLAS_LRF_V=2."""
    p, m, kp, km, axes = cloud
    code = (
        "import os\n"
        "os.environ['PCD_PALLAS_LRF_V'] = '2'\n"
        "import jax.numpy as jnp\n"
        "from point_cloud_donkey_tpu.ops.pallas import lrf_moments as L\n"
        "assert L._kernel_version() == 2\n"
        "p, m, kp, km, axes = (jnp.asarray(a[k]) for k in "
        "('p', 'm', 'kp', 'km', 'axes'))\n"
        "out = {}\n"
        "for w in ('shot', 'uniform'):\n"
        "    cov, s0, cnt = L.lrf_moments(kp, km, p, m, %r, weighting=w,\n"
        "                                 center='query')\n"
        "    out['cov_' + w], out['s0_' + w], out['cnt_' + w] = cov, s0, cnt\n"
        "_, ql, pl_, qpad, _ = L._prep_lanes(kp, km, p, m)\n"
        "ax = jnp.zeros((8, qpad), jnp.float32).at[:6, :kp.shape[0]]"
        ".set(axes.T)\n"
        "out['votes'] = L._sign_votes_call_v2(ql, pl_, ax, jnp.asarray(%r))"
        "[:2, :kp.shape[0]].T\n"
        "for z in (False, True):\n"
        "    f, v = L.shot_lrf_pallas(p, m, p, m, 0.3, z_only=z)\n"
        "    out[f'frames_{z}'], out[f'valid_{z}'] = f, v\n"
        % (RADIUS, RADIUS))
    return pallas_interpret(code, str(tmp_path_factory.mktemp("lrf_v2")),
                            p=p, m=m, kp=kp, km=km, axes=axes)


# --- K10 / K11 twins against the Pallas v2 kernels --------------------------

@pytest.mark.parametrize("weighting", ["shot", "uniform"])
def test_moments_v2_twin_matches_pallas_interpret(cloud, pallas_v2,
                                                  weighting):
    """K10's twin vs `_moments_call_v2`: weight sums rtol 2e-4, counts
    +-1, covariance atol 5e-4 (the JAX package's moment contract).  The
    interpret mode keeps the lo parts in f32; the twin rounds them to bf16
    as the matrix unit and the tensor cores do."""
    p, m, kp, km, _ = cloud
    q_s, p_s = tlrfm.prep_shift(t(kp)[None], t(p)[None], t(m)[None])
    mom, cnt = tlrfm.moments_v2(q_s, p_s, t(m)[None], RADIUS, weighting)
    cov, s0 = tlrfm.cov_from_moments(mom, q_s, t(km)[None])
    np.testing.assert_allclose(n(s0)[0], pallas_v2["s0_" + weighting],
                               rtol=2e-4)
    assert (np.abs(n(cnt)[0] - pallas_v2["cnt_" + weighting]) <= 1).all()
    np.testing.assert_allclose(n(cov)[0], pallas_v2["cov_" + weighting],
                               atol=5e-4)
    if weighting == "uniform":
        np.testing.assert_array_equal(n(mom)[0, :, 0], n(cnt)[0])


def test_sign_votes_v2_twin_matches_pallas_interpret(cloud, pallas_v2):
    """K11's twin vs `_sign_votes_call_v2` on the same axes: counts +-1
    (the centroid shifts round alike only up to an ulp)."""
    p, m, kp, _, axes = cloud
    q_s, p_s = tlrfm.prep_shift(t(kp)[None], t(p)[None], t(m)[None])
    votes = tlrfm.sign_votes_v2(q_s, p_s, t(m)[None], t(axes)[None], RADIUS)
    assert np.abs(n(votes)[0] - pallas_v2["votes"]).max() <= 1


@pytest.mark.parametrize("z_only", [False, True])
def test_shot_lrf_v2_matches_pallas_interpret(cloud, pallas_v2, z_only):
    """shot_lrf(lrf_version=2) vs shot_lrf_pallas under
    PCD_PALLAS_LRF_V=2: valid flags equal, >= 97% of frames within 2e-3."""
    p, m, *_ = cloud
    res = tlrf.shot_lrf(t(p), t(m), t(p), t(m), 0.3, z_only=z_only,
                        lrf_version=2)
    assert_frames_close(res.frames, res.valid, pallas_v2[f"frames_{z_only}"],
                        pallas_v2[f"valid_{z_only}"])


def test_v2_twins_hold_the_v1_contract(cloud):
    """K10 / K11 against K1 / K2 on the same inputs, the contract of the
    JAX package's v1-vs-v2 test (tests/test_pallas_kernels.py:101-125):
    weight sums rtol 2e-4, counts +-1, covariance atol 5e-4, votes +-1."""
    p, m, kp, km, axes = cloud
    q_s, p_s = tlrfm.prep_shift(t(kp)[None], t(p)[None], t(m)[None])
    m1, c1 = tlrfm.moments(q_s, p_s, t(m)[None], RADIUS)
    m2, c2 = tlrfm.moments_v2(q_s, p_s, t(m)[None], RADIUS)
    np.testing.assert_allclose(n(m2)[..., 0], n(m1)[..., 0], rtol=2e-4)
    assert (n(c2 - c1).__abs__() <= 1).all()
    cov1, _ = tlrfm.cov_from_moments(m1, q_s, t(km)[None])
    cov2, _ = tlrfm.cov_from_moments(m2, q_s, t(km)[None])
    np.testing.assert_allclose(n(cov2), n(cov1), atol=5e-4)
    v1 = tlrfm.sign_votes(q_s, p_s, t(m)[None], t(axes)[None], RADIUS)
    v2 = tlrfm.sign_votes_v2(q_s, p_s, t(m)[None], t(axes)[None], RADIUS)
    assert np.abs(n(v2) - n(v1)).max() <= 1


def test_lrf_version_selects_the_kernels(cloud, monkeypatch):
    """lrf_version 2 runs K10 for the moments and K11 for the votes, and
    K2 for z-only votes, as `_moments_dispatch` / `_sign_votes_dispatch`
    do; version 1 runs K1 / K2.  On CPU tensors no kernel launches."""
    p, m, *_ = cloud
    called = []
    for name in ("moments", "moments_v2", "sign_votes", "sign_votes_v2"):
        fn = getattr(tlrfm, name)
        monkeypatch.setattr(tlrfm, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    build.reset_launch_counts()
    for version, z_only, want in ((1, False, ["moments", "sign_votes"]),
                                  (2, False, ["moments_v2", "sign_votes_v2"]),
                                  (2, True, ["moments_v2", "sign_votes"])):
        called.clear()
        tlrf.shot_lrf(t(p), t(m), t(p), t(m), 0.3, z_only=z_only,
                      lrf_version=version)
        assert called == want, (version, z_only, called)
    assert set(build.launch_counts().values()) == {0}


def test_moments_v2_rejects_an_unknown_weighting(cloud):
    p, m, kp, _, _ = cloud
    with pytest.raises(ValueError, match="weighting"):
        tlrfm.moments_v2(t(kp)[None], t(p)[None], t(m)[None], RADIUS, "gauss")


def test_lrf_version_read_from_the_environment(monkeypatch, tmp_path,
                                              capsys):
    """PCD_PALLAS_LRF_V selects the version, as in the JAX package; serve
    reads it once and passes it to the step."""
    monkeypatch.delenv("PCD_PALLAS_LRF_V", raising=False)
    assert tlrf.lrf_version_from_env() == 1
    monkeypatch.setenv("PCD_PALLAS_LRF_V", "2")
    assert tlrf.lrf_version_from_env() == 2
    seen = []
    monkeypatch.setattr(serve, "IsmClassifier",
                        lambda cb, cfg, params: seen.append(cfg)
                        or IsmClassifier(cb, cfg, params))
    flist = tmp_path / "list.txt"
    flist.write_text("# test\n")
    with pytest.raises(Exception):
        serve.main(["-d", CODEBOOK, "-f", str(flist), "--device", "cpu"])
    assert seen and seen[0].lrf_version == 2


def test_classify_step_v2_matches_jax():
    """The dense classify step with lrf_version 2 at B=4 against the JAX
    step's scores (the committed JAX-CPU reference, which
    tests/test_torch_fixtures.py pins to a live run): the same argmax on
    every firm cloud and an rms delta <= 5% of the scale."""
    ref = np.load(REFERENCE)
    config = IsmConfig.load(CODEBOOK)
    cb = load_codebook(CODEBOOK)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192, lrf_version=2)
    model = IsmClassifier(cb, cfg,
                          CodebookParams.from_config(config.child("Codebook")))
    pts = ref["points"][:4]
    with torch.no_grad():
        scores = model(t(pts), torch.ones(pts.shape[:2], dtype=torch.bool))
    assert_decisions_match(scores, ref["scores"][:4])
    assert (n(scores).argmax(1) == ref["labels"][:4]).all()


# --- the training normals -----------------------------------------------------

@pytest.fixture(scope="module")
def two_clouds():
    """Two 512-point shapes, the second with a masked tail parked at 1e9;
    the first has four of its points moved to a small square far away,
    whose LRFs have too few neighbours (the PCA fallback's case)."""
    rng = np.random.default_rng(3)
    pts = np.stack([shapes.make_instance(rng, c, n=512, rotate=True,
                                         noise=0.005) for c in (0, 2)]
                   ).astype(np.float32)
    pts[0, :4] = np.array([[2.5, 0.0, 0.0], [2.6, 0.0, 0.01],
                           [2.5, 0.1, 0.0], [2.6, 0.1, 0.01]], np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 480:] = False
    pts[1, 480:] = 1e9
    return pts, mask


@pytest.mark.parametrize("weighting,center", [("uniform", "mean"),
                                              ("shot", "query")])
def test_radius_covariance_matches_jax(two_clouds, weighting, center):
    """The XLA radius_covariance (matmul identity, HIGHEST) vs the port's
    (the same identity in full fp32): counts +-1, weight sums rtol 2e-4
    (uniform) or atol 1e-3 (shot: the identity leaves d2 ~ eps |p|^2 off
    at the query's own point, and r - sqrt(d2) turns that into ~3e-4 in
    either implementation), covariance atol 5e-4, means atol 1e-5."""
    pts, mask = two_clouds
    want = jax.vmap(lambda p, m: j_radius_covariance(
        p, p, m, 0.25, weighting=weighting, center=center))(
            jnp.asarray(pts), jnp.asarray(mask))
    got = radius_covariance(t(pts), t(pts), t(mask), 0.25, weighting, center)
    ok = mask
    assert (np.abs(n(got.count) - np.asarray(want.count))[ok] <= 1).all()
    np.testing.assert_allclose(n(got.wsum)[ok], np.asarray(want.wsum)[ok],
                               rtol=2e-4 if weighting == "uniform" else 0,
                               atol=0 if weighting == "uniform" else 1e-3)
    np.testing.assert_allclose(n(got.cov)[ok], np.asarray(want.cov)[ok],
                               atol=5e-4)
    np.testing.assert_allclose(n(got.mean)[ok], np.asarray(want.mean)[ok],
                               atol=1e-5 if weighting == "uniform" else 1e-4)


@pytest.mark.parametrize("lrf_version", [1, 2])
def test_compute_normals_matches_jax(two_clouds, lrf_version):
    """compute_normals method 2 (the full LRF's inverted z, the PCA normal
    where the LRF is invalid) vs the JAX function: the PCA validity equal,
    >= 97% of the normals within 2e-3, eigenvalues atol 1e-4; the far
    square takes the PCA fallback, within 2e-3 of JAX's."""
    pts, mask = two_clouds
    want = jax.vmap(lambda p, m: j_compute_normals(p, m, 0.25, 2))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = compute_normals(t(pts), t(mask), 0.25, 2, lrf_version)
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))
    err = np.abs(n(got.normals) - np.asarray(want.normals)).max(-1)[mask]
    assert (err < 2e-3).mean() >= 0.97, (err >= 2e-3).sum()
    np.testing.assert_allclose(n(got.eigenvalues)[mask],
                               np.asarray(want.eigenvalues)[mask], atol=1e-4)
    lrf = tlrf.shot_lrf(t(pts), t(mask), t(pts), t(mask), 0.25,
                        lrf_version=lrf_version)
    fallback = n(t(mask) & ~lrf.valid)
    assert fallback[0, :4].all()
    assert (err[:4] < 2e-3).all(), err[:4]


def test_compute_normals_refuses_other_methods(two_clouds):
    """compute_normals method 1 (the PCA normal oriented away from each
    cloud's masked centroid) vs the JAX function on the same clouds: the
    PCA validity equal, >= 97% of the valid normals within 2e-3, every
    valid normal pointing away from its cloud's centroid."""
    pts, mask = two_clouds
    want = jax.vmap(lambda p, m: j_compute_normals(p, m, 0.25, 1))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = compute_normals(t(pts), t(mask), 0.25, 1)
    valid = n(got.valid)
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    err = np.abs(n(got.normals) - np.asarray(want.normals)).max(-1)[valid]
    assert (err < 2e-3).mean() >= 0.97, (err >= 2e-3).sum()
    w = mask[..., None].astype(np.float32)
    centroid = (np.where(mask[..., None], pts, 0) * w).sum(1) / w.sum(1)
    away = ((pts - centroid[:, None]) * n(got.normals)).sum(-1)
    assert (away[valid] >= 0).all()
