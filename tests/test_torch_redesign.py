"""The plain twins of K1 (radius moments), K2 (LRF sign votes), K3
(tile-compacted SHOT-352), K4 (chi-square top-k), K5 (windowed moments),
K6 (windowed sign votes), K7 (dense-grid SHOT-352), K10 (v2 moments) and
K11 (v2 sign votes) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, at the edge cases of tests/redesign_cases.py:
padded and invalid queries, masked points holding NaN and huge
coordinates, a cloud far wider than the radius, ragged N, points at
exactly r and offsets orthogonal to an axis, N beyond one binning chunk;
keypoints coincident with points, NaN normals, exact on-axis, in-plane
and shell-edge local geometry, cos_desc = +-1, dead rows and an empty
cloud; ragged D, C off the tiles, k in {1, 2, 3}, masked, all-zero and
duplicated codewords; windows clamped at the cloud's end, an inexact
plan, a query tail, W = N, W = 128 and overlapping windows; on the dense
keypoint grid, rows that are not live (a tile of them between live ones),
K not a multiple of 8 and a cloud past one staging chunk.  K2's (with
K11's), K3's, K5's, K6's, K7's and K10's Pallas references run in a
process of their own (torch_parity.pallas_interpret).
K8's and K9's twins (the slot arrays, then their histograms) are held
against the JAX dense CSHOT and SHORT_SHOT on the dense [B, K] grid, each
in a process of its own too: dead rows at 1e9, all-dead tiles, masked
garbage, exact-zero self pairs, pairs at exactly r and on the shell, theta
and phi and r bin edges, invalid frames, an empty cloud, ragged N, NaN and
+-inf normals and colour distances on a bin edge and past 1.
tests/test_torch_cuda.py holds the CUDA kernels against these twins on the
same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from redesign_cases import (K1_CASES, K1_RADIUS, K2_CASES, K3_CASES,
                            K3_KEYS, K3_RADIUS, K4_DIMS, K5_CASES, K5_TILE,
                            K7_CASES, K7_KEYS, K7_RADIUS, K8_CASES, K8_KEYS,
                            K8_LAB_CASES, K8_RADIUS, K9_CASES, K9_KEYS,
                            K9_RADIUS, k1_case, k2_case, k3_case, k4_case,
                            k5_case, k5_windows_exact, k6_case, k7_case,
                            k8_case, k9_bins, k9_case)
from torch_parity import (assert_descriptors_close, assert_topk_close, n,
                          pallas_interpret, t)

from point_cloud_donkey_tpu.ops.pallas import lrf_moments as jlrf
from point_cloud_donkey_tpu.ops.pallas.chisq import \
    chi_square_distance_matrix_pallas
from point_cloud_donkey_tpu_torch.ops import color as tcolor
from point_cloud_donkey_tpu_torch.ops import shot as tshot_ops
from point_cloud_donkey_tpu_torch.ops import short_shot as tss
from point_cloud_donkey_tpu_torch.ops.kernels import chisq as tchisq
from point_cloud_donkey_tpu_torch.ops.kernels import histogram as tk9
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm
from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as tshot
from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as tk8


def _jax_moments(q, q_mask, p, mask, radius):
    """`_moments_call` per cloud on the lanes the JAX package builds:
    masked points and invalid queries parked at 1e9 -> (mom [B, Q, 10],
    count [B, Q])."""
    moms, cnts = [], []
    for qb, qm, pb, pm in zip(q, q_mask, p, mask):
        qs = np.where(qm[:, None], qb, 1e9).astype(np.float32)
        ps = np.where(pm[:, None], pb, 1e9).astype(np.float32)
        q_l = jlrf.to_lanes(jnp.asarray(qs), jlrf._pad_lanes(len(qs), jlrf.TQ))
        p_l = jlrf.to_lanes(jnp.asarray(ps), jlrf._pad_lanes(len(ps), jlrf.TN))
        with pltpu.force_tpu_interpret_mode():
            mom = np.asarray(jlrf._moments_call(q_l, p_l,
                                                jnp.float32(radius), "shot"))
        moms.append(mom[:10, :len(qs)].T)
        cnts.append(mom[jlrf.R_CNT, :len(qs)].astype(np.int32))
    return np.stack(moms), np.stack(cnts)


@pytest.mark.parametrize("case", K1_CASES)
def test_moments_twin_matches_pallas_at_edge_cases(case):
    """K1's twin vs `_moments_call` on the valid queries: weight sums rtol
    2e-4, counts +-1, covariance atol 5e-4 (the moments contract).  Masked
    points reach the twin with their own coordinates (NaN, +-1e30, +-inf)
    and the JAX kernel parked at 1e9: both leave them out.  Invalid
    queries (at 1e9) get 0 from the twin; the JAX kernel's are garbage
    (they meet the parked points) and its callers drop them."""
    q, q_mask, p, mask = k1_case(case)
    jmom, jcnt = _jax_moments(q, q_mask, p, mask, K1_RADIUS)
    mom, cnt = tlrfm.moments(t(q), t(p), t(mask), K1_RADIUS)
    mom, cnt = n(mom), n(cnt)
    assert np.isfinite(mom).all()
    assert not cnt[~q_mask].any() and not mom[~q_mask].any()
    if case == "no_valid_queries":
        return
    assert cnt[q_mask].max() > 1
    _assert_moment_contract(mom, cnt, jmom, jcnt, q, q_mask)


def _assert_moment_contract(mom, cnt, jmom, jcnt, q, q_mask, s0_atol=1e-6,
                            cov_atol=5e-4):
    """The moments contract on the valid queries: weight sums rtol 2e-4
    (plus s0_atol), counts +-1, covariance atol 5e-4 (or cov_atol)."""
    np.testing.assert_allclose(mom[q_mask][:, 0], jmom[q_mask][:, 0],
                               rtol=2e-4, atol=s0_atol)
    assert (np.abs(cnt - jcnt)[q_mask] <= 1).all()
    tcov, _ = tlrfm.cov_from_moments(t(mom), t(q), t(q_mask))
    jcov, _ = tlrfm.cov_from_moments(t(jmom), t(q), t(q_mask))
    np.testing.assert_allclose(n(tcov)[q_mask], n(jcov)[q_mask],
                               atol=cov_atol)


# --- K10: v2 moments ---------------------------------------------------------

_K10_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import lrf_moments as L
out = {}
for case in %r:
    for w in ("shot", "uniform"):
        out[case + "__" + w] = np.stack([np.asarray(L._moments_call_v2(
            jnp.asarray(ql), jnp.asarray(pl_), jnp.float32(%r), w))
            for ql, pl_ in zip(a[case + "__ql"], a[case + "__pl"])])
""" % (K1_CASES, K1_RADIUS)


def _lanes(x, valid, tile):
    """[B, L, 3] -> [B, 8, L padded to tile] rows x, y, z, with invalid and
    padded entries parked at 1e9 (jlrf.to_lanes per cloud)."""
    b, length, _ = x.shape
    out = np.full((b, 8, -(-length // tile) * tile), 1e9, np.float32)
    out[:, :3, :length] = np.where(valid[..., None], x, np.float32(1e9)
                                   ).transpose(0, 2, 1)
    return out


@pytest.fixture(scope="module")
def pallas_k10(tmp_path_factory):
    """`_moments_call_v2` per cloud at every K1 case and both weightings,
    on the lanes the JAX package builds."""
    arrays = {}
    for case in K1_CASES:
        q, q_mask, p, mask = k1_case(case)
        arrays[case + "__ql"] = _lanes(q, q_mask, jlrf.TQ)
        arrays[case + "__pl"] = _lanes(p, mask, jlrf.TN)
    return pallas_interpret(_K10_CODE, str(tmp_path_factory.mktemp("k10")),
                            **arrays)


def _v2_tolerances(p, mask, weighting):
    """(weight-sum atol, covariance atol) of the v2 moments contract on a
    cloud whose unmasked points reach |p|^2 <= P^2.  At unit scale (P^2 <=
    32) they are the contract's: 1e-3 under "shot" (the identity leaves d2
    ~ eps |p|^2 off at a query's own point, and r - sqrt(d2) turns that
    into ~3e-4, tests/test_torch_lrf_v2.py) and 5e-4.  Past it they scale
    with the extent, as the v2 function's error does: d2 is up to ~8 ulp
    of 2 P^2 (2^-19 P^2) off at a query's own point, sqrt(2^-19 P^2) of
    weight; the bf16x3 split carries the moments to 2^-16 of their size
    (~P^2 s0), and the interpret mode keeps the lo parts in f32 where the
    twin (like the TPU's and the tensor cores' bf16 passes) rounds them, so
    the covariance holds to 2^-16 P^2.  `wide_extent` (|p| up to 26) is
    past it.  Under "uniform" a weight sum is a count: +-1, as the
    counts."""
    p2 = float(np.nanmax(np.where(mask, (p.astype(np.float64) ** 2).sum(-1),
                                  0.0)))
    unit = p2 <= 32.0
    s0_atol = (1e-3 if unit else np.sqrt(2.0 ** -19 * p2)) \
        if weighting == "shot" else 1.0
    return s0_atol, 5e-4 if unit else 2.0 ** -16 * p2


@pytest.mark.parametrize("weighting", ["shot", "uniform"])
@pytest.mark.parametrize("case", K1_CASES)
def test_moments_v2_twin_matches_pallas_at_edge_cases(pallas_k10, case,
                                                      weighting):
    """K10's twin vs `_moments_call_v2` at K1's edge cases, with either
    weighting: the moments contract on the valid queries -- weight sums
    rtol 2e-4 plus the identity's atol, counts +-1, covariance atol 5e-4,
    both atols scaled with the cloud's extent past unit scale
    (_v2_tolerances).  Invalid queries get 0 from the twin; uniform weight
    sums equal the counts."""
    q, q_mask, p, mask = k1_case(case)
    want = pallas_k10[f"{case}__{weighting}"]
    nq = q.shape[1]
    jmom = want[:, :10, :nq].transpose(0, 2, 1)
    jcnt = want[:, jlrf.R_CNT, :nq].astype(np.int32)
    mom, cnt = tlrfm.moments_v2(t(q), t(p), t(mask), K1_RADIUS, weighting)
    mom, cnt = n(mom), n(cnt)
    assert np.isfinite(mom).all()
    assert not cnt[~q_mask].any() and not mom[~q_mask].any()
    if weighting == "uniform":
        np.testing.assert_array_equal(mom[..., 0], cnt)
    if case == "no_valid_queries":
        return
    assert cnt[q_mask].max() > 1
    _assert_moment_contract(mom, cnt, jmom, jcnt, q, q_mask,
                            *_v2_tolerances(p, mask, weighting))


# --- K5: windowed moments ----------------------------------------------------

_K5_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import lrf_moments as L
out = {}
for case in %r:
    w = int(a[case + "__w"])
    out[case] = np.stack([np.asarray(L._moments_call_gathered(
        jnp.asarray(qt), jnp.asarray(pw), jnp.float32(%r), "shot", w))
        for qt, pw in zip(a[case + "__qt"], a[case + "__pw"])])
""" % (K5_CASES, K1_RADIUS)


def _k5_lanes(pts, mask, starts, window):
    """The lanes `_moments_call_gathered` takes for one K5 case, as
    shot_lrf_pallas_windowed builds them per cloud: the queries (the
    points) qt [B, 8, T * 256] and every plan tile's window pw [B, 8,
    T * W], masked points, pad queries and window slots past N parked at
    1e9."""
    b, n_pts, _ = pts.shape
    qt = _lanes(pts, mask, K5_TILE)
    idx = np.clip(starts, 0, n_pts)[..., None] + np.arange(window)
    idx = idx.reshape(b, -1)
    inside = idx < n_pts
    idx = np.minimum(idx, n_pts - 1)
    win = np.take_along_axis(pts, idx[..., None], 1)
    return qt, _lanes(win, np.take_along_axis(mask, idx, 1) & inside, 1)


@pytest.fixture(scope="module")
def pallas_k5(tmp_path_factory):
    """`_moments_call_gathered` per cloud at every K5 case."""
    arrays = {}
    for case in K5_CASES:
        pts, mask, starts, window = k5_case(case)
        arrays[case + "__qt"], arrays[case + "__pw"] = _k5_lanes(
            pts, mask, starts, window)
        arrays[case + "__w"] = np.array(window)
    return pallas_interpret(_K5_CODE, str(tmp_path_factory.mktemp("k5")),
                            **arrays)


@pytest.mark.parametrize("case", K5_CASES)
def test_windowed_moments_twin_matches_pallas_at_edge_cases(pallas_k5,
                                                            case):
    """K5's twin vs `_moments_call_gathered` on the self-LRF's valid
    queries: the moments contract (weight sums rtol 2e-4, counts +-1,
    covariance atol 5e-4).  Masked queries (holding NaN and +-1e30 /
    +-inf) get 0, as do the queries of a window past the cloud's end.  On
    the inexact plan some point within r of a query lies outside its
    tile's window and stays out of its sums, in the twin as in the JAX
    kernel; on an exact plan the twin equals K1's over the whole cloud
    within the contract."""
    pts, mask, starts, window = k5_case(case)
    want = pallas_k5[case]
    nq = pts.shape[1]
    jmom = want[:, :10, :nq].transpose(0, 2, 1)
    jcnt = want[:, jlrf.R_CNT, :nq].astype(np.int32)
    mom, cnt = tlrfm.moments_windowed(t(pts), t(pts), t(mask), t(starts),
                                      window, K1_RADIUS)
    mom, cnt = n(mom), n(cnt)
    assert np.isfinite(mom).all()
    assert not cnt[~mask].any() and not mom[~mask].any()
    assert cnt[mask].max() > 1
    _assert_moment_contract(mom, cnt, jmom, jcnt, pts, mask)
    full, full_cnt = (n(x) for x in tlrfm.moments(t(pts), t(pts), t(mask),
                                                  K1_RADIUS))
    exact = k5_windows_exact(pts, mask, starts, window)
    assert exact == (case in ("query_tail", "masked_nan_huge",
                              "full_window", "overlapping"))
    if exact:
        _assert_moment_contract(mom, cnt, full, full_cnt, pts, mask)
    else:
        assert (cnt < full_cnt)[mask].any()
    if case == "clamped_end":
        assert not cnt[1, 2 * K5_TILE:].any()


# --- K6: windowed sign votes ------------------------------------------------

_K6_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import lrf_moments as L
out = {}
for case in %r:
    w = int(a[case + "__w"])
    g = lambda key: a[case + "__" + key]
    for z_only in (False, True):
        out[case + "__z%%d" %% z_only] = np.stack([np.asarray(
            L._sign_votes_call_gathered(
                jnp.asarray(qt), jnp.asarray(pw), jnp.asarray(ax),
                jnp.float32(%r), z_only, w))
            for qt, pw, ax in zip(g("qt"), g("pw"), g("ax"))])
""" % (K5_CASES, K1_RADIUS)


@pytest.fixture(scope="module")
def pallas_k6(tmp_path_factory):
    """`_sign_votes_call_gathered` per cloud at every K5 case with K6's
    axis candidates, with and without z_only, on the lanes
    shot_lrf_pallas_windowed builds (_k5_lanes; the axes in rows 0-5 of
    the query lanes)."""
    arrays = {}
    for case in K5_CASES:
        pts, mask, starts, window, axes = k6_case(case)
        qt, pw = _k5_lanes(pts, mask, starts, window)
        ax = np.zeros_like(qt)
        ax[:, :6, :pts.shape[1]] = axes.transpose(0, 2, 1)
        arrays.update({case + "__qt": qt, case + "__pw": pw,
                       case + "__ax": ax, case + "__w": np.array(window)})
    return pallas_interpret(_K6_CODE, str(tmp_path_factory.mktemp("k6")),
                            **arrays)


@pytest.mark.parametrize("z_only", [False, True])
@pytest.mark.parametrize("case", K5_CASES)
def test_windowed_sign_votes_twin_matches_pallas_at_edge_cases(
        pallas_k6, case, z_only):
    """K6's twin vs `_sign_votes_call_gathered` at the K5 cases: votes
    equal on the self-LRF's valid queries (both take p - q exactly, square
    and dot it in one order, and count integers), 0 on the masked ones,
    on the queries of a window past the cloud's end and in x when z_only.
    On an exact plan the twin equals K2's over the whole cloud."""
    pts, mask, starts, window, axes = k6_case(case)
    nq = pts.shape[1]
    want = pallas_k6[f"{case}__z{int(z_only)}"][:, :2, :nq].transpose(
        0, 2, 1).astype(np.int32)
    got = n(tlrfm.sign_votes_windowed(t(pts), t(pts), t(mask), t(axes),
                                      t(starts), window, K1_RADIUS, z_only))
    assert not got[~mask].any()
    if z_only:
        assert not got[..., 0].any()
    assert got[mask].max() > 1
    np.testing.assert_array_equal(got[mask], want[mask])
    if k5_windows_exact(pts, mask, starts, window):
        full = n(tlrfm.sign_votes(t(pts), t(pts), t(mask), t(axes),
                                  K1_RADIUS, z_only))
        np.testing.assert_array_equal(got[mask], full[mask])
    if case == "clamped_end":
        assert not got[1, 2 * K5_TILE:].any()


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dim", K4_DIMS)
def test_chisq_twin_matches_pallas_at_edge_cases(dim, k, signed):
    """K4's twin vs the Pallas chi-square matrix + the k smallest in
    (distance, index) order: distances rtol 1e-5, indices equal except at
    ties; the duplicated codeword's tie goes to the lower index, the
    all-zero pair is at distance 0, masked codewords never win; with
    signed values too (terms with a + b <= 0 count 0)."""
    a, b, b_mask = k4_case(dim, signed=signed)
    with pltpu.force_tpu_interpret_mode():
        d = np.asarray(chi_square_distance_matrix_pallas(jnp.asarray(a),
                                                         jnp.asarray(b)))
    d = np.where(b_mask[None, :], d, np.inf)
    ji = np.argsort(d, axis=1, kind="stable")[:, :k]
    jd = np.take_along_axis(d, ji, 1)
    td, ti = tchisq.chisq_topk(t(a), t(b), t(b_mask), k)
    assert_topk_close(td, ti, jd, ji)
    ti = n(ti)
    assert b_mask[ti].all()
    assert ti[9, 0] == 3 and n(td)[9, 0] == 0.0
    if k >= 2:
        assert ti[9, 1] == 7
    assert n(td)[5].min() == 0.0 and ti[5, 0] == 11


# --- K2: sign votes -----------------------------------------------------------

_K2_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import lrf_moments as L
out = {}
for case in %r:
    g = lambda key: a[case + "__" + key]
    for z_only in (False, True):
        votes = []
        for qb, qm, pb, pm, ax in zip(g("q"), g("q_mask"), g("p"), g("mask"),
                                      g("axes")):
            qs = np.where(qm[:, None], qb, 1e9).astype(np.float32)
            ps = np.where(pm[:, None], pb, 1e9).astype(np.float32)
            qpad = L._pad_lanes(len(qs), L.TQ)
            ql = L.to_lanes(jnp.asarray(qs), qpad)
            pl_ = L.to_lanes(jnp.asarray(ps), L._pad_lanes(len(ps), L.TN))
            axl = np.zeros((8, qpad), np.float32)
            axl[:6, :len(qs)] = ax.T
            v = L._sign_votes_call(ql, pl_, jnp.asarray(axl),
                                   jnp.float32(%r), z_only=z_only)
            votes.append(np.asarray(v)[:2, :len(qs)].T.astype(np.int32))
        out[case + "__z%%d" %% z_only] = np.stack(votes)
    votes = []
    for qb, qm, pb, pm, ax in zip(g("q"), g("q_mask"), g("p"), g("mask"),
                                  g("axes")):
        qs = np.where(qm[:, None], qb, 1e9).astype(np.float32)
        ps = np.where(pm[:, None], pb, 1e9).astype(np.float32)
        qpad = L._pad_lanes(len(qs), L.TQ)
        ql = L.to_lanes(jnp.asarray(qs), qpad)
        pl_ = L.to_lanes(jnp.asarray(ps), L._pad_lanes(len(ps), L.TN))
        axl = np.zeros((8, qpad), np.float32)
        axl[:6, :len(qs)] = ax.T
        v = L._sign_votes_call_v2(ql, pl_, jnp.asarray(axl), jnp.float32(%r))
        votes.append(np.asarray(v)[:2, :len(qs)].T.astype(np.int32))
    out[case + "__v2"] = np.stack(votes)
""" % (K2_CASES, K1_RADIUS, K1_RADIUS)


@pytest.fixture(scope="module")
def pallas_k2(tmp_path_factory):
    """`_sign_votes_call` per cloud at every K2 case, with and without
    z_only, and `_sign_votes_call_v2` (K11's reference) on the same inputs,
    on the lanes the JAX package builds (masked points and invalid queries
    parked at 1e9)."""
    arrays = {}
    for case in K2_CASES:
        for key, x in zip(("q", "q_mask", "p", "mask", "axes"),
                          k2_case(case)):
            arrays[f"{case}__{key}"] = x
    return pallas_interpret(_K2_CODE, str(tmp_path_factory.mktemp("k2")),
                            **arrays)


@pytest.mark.parametrize("z_only", [False, True])
@pytest.mark.parametrize("case", K2_CASES)
def test_sign_votes_twin_matches_pallas_at_edge_cases(pallas_k2, case,
                                                      z_only):
    """K2's twin vs `_sign_votes_call` on the valid queries: votes +-1 (a
    point on the radius boundary can fall either side of the gate when the
    float operations differ).  Invalid queries (at 1e9) get 0 from the
    twin; the x vote is 0 when z_only.  Points at exactly r count, and an
    offset orthogonal to an axis votes +: there the twin equals the JAX
    kernel exactly."""
    q, q_mask, p, mask, axes = k2_case(case)
    want = pallas_k2[f"{case}__z{int(z_only)}"]
    got = n(tlrfm.sign_votes(t(q), t(p), t(mask), t(axes), K1_RADIUS,
                             z_only))
    assert not got[~q_mask].any()
    if z_only:
        assert not got[..., 0].any()
    if case == "no_valid_queries":
        return
    assert got[q_mask].max() > 1
    assert (np.abs(got - want)[q_mask] <= 1).all()
    if case == "on_radius_and_orthogonal":
        special = 12      # the queries with exact offsets come first
        np.testing.assert_array_equal(got[:, :special], want[:, :special])


@pytest.mark.parametrize("case", K2_CASES)
def test_sign_votes_v2_twin_matches_pallas_at_edge_cases(pallas_k2, case):
    """K11's twin vs `_sign_votes_call_v2` at K2's edge cases, with K2's
    seeded axis candidates, on the valid queries: votes +-1 (the identity's
    d2 and the dots a.p, a.q come from the twin's elementwise float
    operations and from the interpret mode's k = 3 HIGHEST products, which
    may round a point on the gate's or a vote's boundary to the other
    side).  Invalid queries (at 1e9) get 0 from the twin; the JAX kernel's
    are garbage (they meet the parked points) and its callers drop them.
    Masked points holding NaN, +-1e30 and +-inf fail the twin's gate."""
    q, q_mask, p, mask, axes = k2_case(case)
    want = pallas_k2[f"{case}__v2"]
    got = n(tlrfm.sign_votes_v2(t(q), t(p), t(mask), t(axes), K1_RADIUS))
    assert not got[~q_mask].any()
    if case == "no_valid_queries":
        return
    assert got[q_mask].max() > 1
    assert (np.abs(got - want)[q_mask] <= 1).all()


# --- K3: tile-compacted SHOT-352 ----------------------------------------------

_K3_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import shot_fused as SF
counts = []
_call = SF._shot_fused_call_windowed


def _spy(*args, **kw):          # keep the in-radius counts the call returns
    hist, cnt = _call(*args, **kw)
    counts.append(np.asarray(cnt)[:, 0])
    return hist, cnt


SF._shot_fused_call_windowed = _spy
out = {}
for case in %r:
    g = lambda key: jnp.asarray(a[case + "__" + key])
    tiles = int(np.ceil(a[case + "__kp_mask"].sum(1) / SF.TK).sum())
    res = SF.shot_descriptor_fused_compact(
        g("keypoints"), g("frames"), g("frame_valid"), g("kp_mask"),
        g("points"), g("normals"), g("mask"), %r, tiles + 2, interpret=True)
    for key, x in zip(("desc", "valid", "kp", "frames", "cloud", "exact"),
                      res):
        out[case + "__" + key] = np.asarray(x)
    out[case + "__count"] = counts[-1]
""" % (K3_CASES, K3_RADIUS)


@pytest.fixture(scope="module")
def pallas_k3(tmp_path_factory):
    """`shot_descriptor_fused_compact(..., interpret=True)` at every K3
    case with two dead tiles of headroom, and the in-radius counts of its
    `_shot_fused_call_windowed`."""
    arrays = {f"{case}__{key}": x for case in K3_CASES
              for key, x in zip(K3_KEYS, k3_case(case))}
    return pallas_interpret(_K3_CODE, str(tmp_path_factory.mktemp("k3")),
                            **arrays)


@pytest.mark.parametrize("case", K3_CASES)
def test_shot_twin_matches_pallas_at_edge_cases(pallas_k3, case):
    """K3's twin (through `shot_descriptor_fused_compact`) vs the Pallas
    compact kernel: in-radius counts equal, the same flat layout row for
    row, validity equal, descriptor cosine > 0.999 with fewer than 1e-4 of
    the entries off by more than 1e-3; the JAX side's dead tiles are
    invalid.  Counts leave out a keypoint's coincident point (d^2 = 0),
    NaN and +-inf normals and masked points."""
    arrays = k3_case(case)
    kp, frames, fv, kp_mask, pts, nrm, mask = (t(x) for x in arrays)
    j = lambda key: pallas_k3[f"{case}__{key}"]          # noqa: E731
    assert j("exact")
    td, tv, tk, tf, tc = tshot.shot_descriptor_fused_compact(
        kp, frames, fv, kp_mask, pts, nrm, mask, K3_RADIUS)
    rows = td.shape[0]
    assert rows == -(-arrays[3].sum(1) // tshot.TK).sum() * tshot.TK
    # the twin's counts, on the rows the wrapper hands to K3
    gidx, alive, tile_cloud = tshot.compact_layout(kp_mask)
    kp_rows = kp.reshape(-1, 3)[gidx]
    kp_rows = np.where(n(alive)[:, None], n(kp_rows), np.float32(1e9))
    _, count = tshot.shot_tiles(t(kp_rows), frames.reshape(-1, 3, 3)[gidx]
                                .contiguous(), tile_cloud, pts, nrm, mask,
                                K3_RADIUS)
    np.testing.assert_array_equal(n(count), j("count")[:rows])
    assert not j("count")[rows:].any() and not j("valid")[rows:].any()
    np.testing.assert_array_equal(n(tc), j("cloud")[:rows])
    assert_descriptors_close(td, tv, j("desc")[:rows], j("valid")[:rows])
    np.testing.assert_allclose(n(tk), j("kp")[:rows], atol=1e-6)
    np.testing.assert_allclose(n(tf), j("frames")[:rows], atol=1e-6)
    assert n(count)[n(alive)].min() >= 0 and n(count).max() > 5
    assert not n(count)[~n(alive)].any()


# --- K7: SHOT-352 on the dense keypoint grid --------------------------------

_K7_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import shot_fused as SF
counts = []
_call = SF._shot_fused_call


def _spy(*args, **kw):          # keep the in-radius counts the call returns
    hist, cnt = _call(*args, **kw)
    counts.append(np.asarray(cnt)[:, 0])
    return hist, cnt


SF._shot_fused_call = _spy
out = {}
for case in %r:
    g = lambda key: jnp.asarray(a[case + "__" + key])
    desc, valid = SF.shot_descriptor_fused(
        *(g(key) for key in %r), %r, interpret=True)
    out[case + "__desc"] = np.asarray(desc)
    out[case + "__valid"] = np.asarray(valid)
    out[case + "__count"] = counts[-1]
""" % (K7_CASES, K7_KEYS, K7_RADIUS)


@pytest.fixture(scope="module")
def pallas_k7(tmp_path_factory):
    """`shot_descriptor_fused(..., interpret=True)` at every K7 case, and
    the in-radius counts of its `_shot_fused_call` (rows of K padded to a
    multiple of 8)."""
    arrays = {f"{case}__{key}": x for case in K7_CASES
              for key, x in zip(K7_KEYS, k7_case(case))}
    return pallas_interpret(_K7_CODE, str(tmp_path_factory.mktemp("k7")),
                            **arrays)


@pytest.mark.parametrize("case", K7_CASES)
def test_shot_dense_twin_matches_pallas_at_edge_cases(pallas_k7, case):
    """K7's twin (`shot_dense`, and `shot_descriptor_fused` over it) vs
    the Pallas dense-grid kernel: in-radius counts equal on the live rows
    (the rows with a valid frame), validity equal, descriptor cosine >
    0.999 with fewer than 1e-4 of the entries off by more than 1e-3; rows
    that are not live keep a zero histogram and count, whatever their
    keypoint.  Masked garbage, NaN and +-inf normals, a keypoint's
    coincident point (d^2 = 0) and the empty cloud add nothing; points at
    exactly r count."""
    arrays = k7_case(case)
    kp, fr, fv, pts, nrm, mask = (t(x) for x in arrays)
    live = arrays[2]
    b, k = live.shape
    j = lambda key: pallas_k7[f"{case}__{key}"]          # noqa: E731
    hist, count = tshot.shot_dense(kp, fr, fv, pts, nrm, mask, K7_RADIUS)
    hist, count = n(hist), n(count)
    jcount = j("count").reshape(b, -1)[:, :k]
    np.testing.assert_array_equal(count[live], jcount[live])
    assert not count[~live].any() and not hist[~live].any()
    assert count.max() > 5
    td, tv = tshot.shot_descriptor_fused(kp, fr, fv, pts, nrm, mask,
                                         K7_RADIUS)
    assert td.shape == (b, k, 352)
    assert_descriptors_close(td.reshape(-1, 352), tv.reshape(-1),
                             j("desc").reshape(-1, 352),
                             j("valid").reshape(-1))
    if case == "empty_cloud":
        assert not count[1].any() and not n(tv)[1].any()
    if case == "dead_tile_beside_live":
        # real keypoints that are not live, between two live tiles
        assert jcount[0, 8:16].all() and live[0, :8].all() \
            and live[0, 16:21].all()
    if case == "k_not_multiple_of_8":
        assert k % 8 and count[0, 16:21].all()


# --- K8 / K9: CSHOT and SHORT_SHOT on the dense keypoint grid ----------------

def _jax_input(points, mask, normals=None):
    """The same cloud as the JAX dense descriptors need it: they multiply
    unused pairs by zero, so a NaN in a masked point -- or, for CSHOT, a
    non-finite normal anywhere -- makes every descriptor of its cloud NaN.
    The port leaves such points out (a point with a non-finite normal is
    not used, as the JAX gate intends), so the reference gets them masked,
    at 1e9 (the pipelines' pad), with a zero normal."""
    drop = ~mask | ~np.isfinite(points).all(-1)
    if normals is not None:
        drop |= ~np.isfinite(normals).all(-1)
        normals = np.where(drop[..., None], 0, normals).astype(np.float32)
    pts = np.where(drop[..., None] & ~np.isfinite(points), 1e9, points)
    return pts.astype(np.float32), mask & ~drop, normals


_K8_CODE = """
import jax
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops import color
from point_cloud_donkey_tpu.ops.neighbors import pairwise_sqdist
from point_cloud_donkey_tpu.ops.shot import cshot_descriptor_dense
r = %r
to_lab = color.rgb_to_cielab_normalized
out = {}
for case in %r:
    g = lambda key: jnp.asarray(a[case + "__" + key])
    # Lab cases feed their colours past the conversion
    color.rgb_to_cielab_normalized = to_lab if case not in %r else (
        lambda c: c)
    f = jax.jit(jax.vmap(lambda *x: cshot_descriptor_dense(*x, r)))
    res = f(*(g(key) for key in %r))
    out[case + "__desc"] = np.asarray(res.descriptors)
    out[case + "__valid"] = np.asarray(res.valid)
    d2 = jax.vmap(pairwise_sqdist)(g("keypoints"), g("points"))
    use = (d2 <= r * r) & (d2 > 1e-15) & g("mask")[:, None, :]
    out[case + "__count"] = np.asarray(use.sum(-1))
""" % (K8_RADIUS, K8_CASES, K8_LAB_CASES, K8_KEYS)


@pytest.fixture(scope="module")
def jax_k8(tmp_path_factory):
    """The JAX dense CSHOT (vmapped over the clouds) and its gate's
    in-radius counts at every K8 case, on _jax_input's clouds."""
    arrays = {}
    for case in K8_CASES:
        x = dict(zip(K8_KEYS, k8_case(case)))
        x["points"], x["mask"], x["normals"] = _jax_input(
            x["points"], x["mask"], x["normals"])
        arrays.update({f"{case}__{key}": v for key, v in x.items()})
    return pallas_interpret(_K8_CODE, str(tmp_path_factory.mktemp("k8")),
                            **arrays)


@pytest.mark.parametrize("case", K8_CASES)
def test_cshot_twin_matches_jax_at_edge_cases(jax_k8, case):
    """K8's twin (the slot arrays of each chunk of clouds, then their
    histograms) through `cshot_descriptor_dense` vs the JAX dense CSHOT:
    validity equal, descriptor cosine > 0.999 with fewer than 1e-4 of the
    entries off by more than 1e-3, in-radius counts +-1 on the live rows
    (equal where the geometry is exact) and 0 elsewhere.  Masked garbage,
    NaN and +-inf normals, a keypoint's coincident point (d^2 = 0) and the
    empty cloud add nothing; points at exactly r count; colour distances
    with d * 30 an integer and past 1 (clamped) bin as the reference
    bins them."""
    kp, kp_col, fr, fv, pts, nrm, col, mask = arrays = k8_case(case)
    j = lambda key: jax_k8[f"{case}__{key}"]          # noqa: E731
    lab = case in K8_LAB_CASES
    kp_lab = t(kp_col) if lab else tcolor.rgb_to_cielab_normalized(t(kp_col))
    pt_lab = t(col) if lab else tcolor.rgb_to_cielab_normalized(t(col))
    hist, count = tk8.cshot_hist(t(kp), kp_lab, t(fr), t(fv), t(pts), t(nrm),
                                 pt_lab, t(mask), K8_RADIUS)
    got = tshot_ops.normalize_descriptors(hist, count, t(fv))
    if not lab:
        res = tshot_ops.cshot_descriptor_dense(*map(t, arrays), K8_RADIUS)
        assert torch.equal(res.descriptors, got.descriptors)
    assert_descriptors_close(got.descriptors, got.valid, j("desc"),
                             j("valid"))
    count = n(count)
    assert not count[~fv].any() and not n(hist)[~fv].any()
    diff = np.abs(count - j("count"))[fv]
    assert diff.max() <= 1 and count.max() > 5
    if case == "on_radius":
        assert not (count - j("count"))[:, :4].any()
    if case == "empty_cloud":
        assert not count[1].any() and not n(got.valid)[1].any()
    if case in ("colour_edges", "colour_past_one"):
        # the edge is reached: in-radius pairs of the first 8 keypoints at
        # d * 30 an integer, or at a distance past 1
        near = (((pts[:, None] - kp[:, :8, None]) ** 2).sum(-1)
                <= K8_RADIUS ** 2)
        d = np.abs(n(kp_lab)[:, :8, None] - n(pt_lab)[:, None])
        raw = ((d[..., 0] + (d[..., 1] + d[..., 2]) * np.float32(0.5))
               * np.float32(tcolor._recip(3.0)))
        if case == "colour_edges":
            v = np.clip(raw, 0, 1) * np.float32(30)
            hit = near & (v == np.round(v)) & (v > 0)
        else:
            hit = near & (raw > 1)
        assert hit.sum() > 20, hit.sum()


_K9_CODE = """
import jax
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.short_shot import short_shot_descriptor_dense
out = {}
for case, bins in %r:
    g = lambda key: jnp.asarray(a[case + "__" + key])
    f = jax.jit(jax.vmap(lambda *x: short_shot_descriptor_dense(
        *x, %r, *bins)))
    res = f(*(g(key) for key in %r))
    out[case + "__desc"] = np.asarray(res.descriptors)
    out[case + "__valid"] = np.asarray(res.valid)
""" % (tuple((c, k9_bins(c)) for c in K9_CASES), K9_RADIUS, K9_KEYS)


@pytest.fixture(scope="module")
def jax_k9(tmp_path_factory):
    """The JAX dense SHORT_SHOT (vmapped over the clouds) at every K9
    case, on _jax_input's clouds."""
    arrays = {}
    for case in K9_CASES:
        x = dict(zip(K9_KEYS, k9_case(case)))
        x["points"], x["mask"], _ = _jax_input(x["points"], x["mask"])
        arrays.update({f"{case}__{key}": v for key, v in x.items()})
    return pallas_interpret(_K9_CODE, str(tmp_path_factory.mktemp("k9")),
                            **arrays)


@pytest.mark.parametrize("case", K9_CASES)
def test_short_shot_twin_matches_jax_at_edge_cases(jax_k9, case):
    """K9's twin (the slot arrays of each chunk of clouds, then their
    histogram) through `short_shot_descriptor_dense` vs the JAX dense
    SHORT_SHOT: validity equal, descriptor cosine > 0.999 with fewer than
    1e-4 of the entries off by more than 1e-3; rows that are not live stay
    zero.  Where the geometry is exact -- z_l = 0 (theta = 90, the e-bin
    edge), y_l = +0 with x_l < 0 (phi = 180, the cyclic a-bin edge) and r
    at exactly r/2 (the r-bin edge) -- the descriptors agree to 1e-6."""
    kp, fr, fv, pts, mask = k9_case(case)
    bins = k9_bins(case)
    j = lambda key: jax_k9[f"{case}__{key}"]          # noqa: E731
    got = tss.short_shot_descriptor_dense(t(kp), t(fr), t(fv), t(pts),
                                          t(mask), K9_RADIUS, *bins)
    assert got.descriptors.shape[-1] == np.prod(bins)
    hist = tk9.short_shot_hist(t(kp), t(fr), t(fv), t(pts), t(mask),
                               K9_RADIUS, *bins)
    assert not n(hist)[~fv].any()
    assert_descriptors_close(got.descriptors, got.valid, j("desc"),
                             j("valid"))
    if case == "empty_cloud":
        assert not n(got.valid)[1].any()
    if case in ("theta_90", "phi_180", "r_half"):
        np.testing.assert_allclose(n(got.descriptors)[:, :4],
                                   j("desc")[:, :4], atol=1e-6)


def test_short_shot_bins_past_256_are_refused():
    """K9 holds a lane's bins in registers: up to 256 bins (every
    AUTO_BINS size), and a larger grid raises on either device."""
    kp, fr, fv, pts, mask = map(t, k9_case("dead_rows"))
    hist = tk9.short_shot_hist(kp, fr, fv, pts, mask, K9_RADIUS, 8, 4, 8)
    assert hist.shape[-1] == max(tss.AUTO_BINS) == tk9.MAX_BINS
    with pytest.raises(ValueError, match="256"):
        tk9.short_shot_hist(kp, fr, fv, pts, mask, K9_RADIUS, 4, 9, 8)
