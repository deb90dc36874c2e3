"""The port's sorted-axis windowed sweeps (ops/binned.py, K5/K6's plain
twins through ops/kernels/lrf_moments.shot_lrf_windowed) against the JAX
package's ops/binned.py and its windowed Pallas LRF run in interpret mode
(in a process of its own: torch_parity.pallas_interpret), on
bench-geometry clouds made from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapes
from torch_parity import assert_frames_close, n, pallas_interpret, t

from point_cloud_donkey_tpu.ops import binned as jb
from point_cloud_donkey_tpu_torch.ops import binned as tb
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm
from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast

RADIUS = 0.25   # the bench's normal radius


def _clouds(b, npts, seed, pad_last=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([shapes.make_instance(rng, i % 5, n=npts, rotate=True)
                    for i in range(b)]).astype(np.float32)
    mask = np.ones((b, npts), bool)
    if pad_last:
        mask[-1, -pad_last:] = False
        pts[-1, -pad_last:] = 1e9
    return pts, mask


@pytest.fixture(scope="module")
def clouds():
    """Two clouds of 1024 points, the second with 124 padded points."""
    return _clouds(2, 1024, 21, pad_last=124)


def test_sort_order_matches_jax_up_to_near_ties(clouds):
    """Same principal axes, keys within f32 round-off, and the same sorted
    order wherever neighbouring keys are not near-equal; invalid points
    sort last."""
    pts, mask = clouds
    jp, jm, jk, jo, ja = (np.asarray(x) for x in jb.sort_clouds_ex(
        jnp.asarray(pts), jnp.asarray(mask)))
    s = tb.sort_clouds_ex(t(pts), t(mask))
    np.testing.assert_allclose(n(s.axis), ja, atol=1e-5)
    np.testing.assert_array_equal(n(s.mask), jm)
    np.testing.assert_allclose(n(s.keys), jk, rtol=1e-6, atol=1e-5)
    gap = np.diff(jk, axis=1)
    near = np.zeros_like(jk, bool)
    near[:, 1:] |= gap < 1e-5
    near[:, :-1] |= gap < 1e-5
    assert (n(s.order)[~near] == jo[~near]).all()
    assert not n(s.mask)[-1, -124:].any()
    np.testing.assert_array_equal(n(tb.sort_clouds(t(pts), t(mask))[3]),
                                  n(s.order))


@pytest.mark.parametrize("window", [128, 384, 1024])
def test_window_starts_match_jax(clouds, window):
    """On the same sorted keys: the same starts per tile, the same
    exactness flag (it trips at 128) and the same calibration span."""
    pts, mask = clouds
    _, jm, jk, _, _ = jb.sort_clouds_ex(jnp.asarray(pts), jnp.asarray(mask))
    plans = [jb.window_starts(jk[i], jm[i], jk[i], RADIUS, 256, window,
                              align=128) for i in range(len(pts))]
    tp = tb.window_starts(t(jk), t(jm), t(jk), RADIUS, window)
    np.testing.assert_array_equal(n(tp.starts),
                                  np.stack([p.starts for p in plans]))
    assert bool(tp.exact) == all(bool(p.exact) for p in plans)
    assert int(tp.span) == max(int(p.span) for p in plans)
    if window == 128:
        assert not bool(tp.exact)


def test_required_window_matches_jax():
    pts, mask = _clouds(4, 2048, 3, pad_last=300)
    jw = jb.required_window(jnp.asarray(pts), jnp.asarray(mask), RADIUS,
                            tile_q=256, align=128)
    tw = tb.required_window(t(pts), t(mask), RADIUS)
    assert tw == jw
    assert 128 <= tw < 2048 and tw % 128 == 0


def test_query_tail_is_planned_not_dropped():
    """Q % 256 != 0: the port plans ceil(Q / 256) tiles and masks the tail
    (JAX drops it), so with an exact window every normal, the tail's
    included, equals the dense one."""
    pts, mask = _clouds(2, 1000, 8)
    s = tb.sort_clouds_ex(t(pts), t(mask))
    win = tb.required_window(t(pts), t(mask), RADIUS)
    plan = tb.window_starts(s.keys, s.mask, s.keys, RADIUS, win)
    assert tuple(plan.starts.shape) == (2, 4) and bool(plan.exact)
    wn, exact = tb.compute_normals_fast_windowed(s.points, s.mask, s.keys,
                                                 RADIUS, win)
    dense = compute_normals_fast(s.points, s.mask, RADIUS)
    assert bool(exact)
    err = np.abs(n(wn - dense)).max(-1)
    assert (err < 1e-4).mean() >= 0.99
    assert (err[:, 768:] < 1e-4).mean() >= 0.99


def test_padding_does_not_change_the_windowed_normals():
    """A cloud padded with masked far points gets the same sort and plan
    flag, and the same normals on its valid points, as the cloud alone."""
    pts, mask = _clouds(1, 900, 9)
    padded = np.concatenate([pts, np.full((1, 124, 3), 1e9, np.float32)], 1)
    pmask = np.concatenate([mask, np.zeros((1, 124), bool)], 1)
    outs = []
    for p, m in ((pts, mask), (padded, pmask)):
        s = tb.sort_clouds_ex(t(p), t(m))
        nrm, exact = tb.compute_normals_fast_windowed(s.points, s.mask,
                                                      s.keys, RADIUS, 512)
        outs.append((n(s.points)[0, :900], n(nrm)[0, :900], bool(exact)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    # the windows differ in length near the end of the cloud, and with it
    # the order of the sums: normals agree to f32 round-off through the EVD
    err = np.abs(outs[0][1] - outs[1][1]).max(-1)
    assert (err < 1e-3).mean() >= 0.99
    assert outs[0][2] == outs[1][2]


_WINDOWED_CODE = """
import jax
import jax.numpy as jnp
from point_cloud_donkey_tpu.ops.pallas.lrf_moments import (
    lrf_moments, shot_lrf_pallas_windowed)
jp, jm, jk = (jnp.asarray(a[k]) for k in ("jp", "jm", "jk"))
out = {}
out["f"], out["v"], out["x"] = shot_lrf_pallas_windowed(
    jp, jm, jk, %r, int(a["win"]))
_, _, out["c"] = jax.vmap(lambda p, m: lrf_moments(p, m, p, m, %r))(jp, jm)
""" % (RADIUS, RADIUS)


def test_windowed_lrf_matches_pallas_interpret(clouds, tmp_path):
    """K5/K6 twins through shot_lrf_windowed vs the JAX windowed Pallas
    LRF (interpret mode) at the calibrated window, both on the JAX sort:
    validity equal, >= 97% of frames within 2e-3, the flag agrees, and the
    in-radius counts within +-1 of the JAX dense Pallas moments."""
    pts, mask = clouds
    win = tb.required_window(t(pts), t(mask), RADIUS)
    jp, jm, jk, _, _ = (np.asarray(x) for x in jb.sort_clouds_ex(
        jnp.asarray(pts), jnp.asarray(mask)))
    ref = pallas_interpret(_WINDOWED_CODE, str(tmp_path), jp=jp, jm=jm,
                           jk=jk, win=np.int64(win))
    jf, jv, jx, jc = ref["f"], ref["v"], ref["x"], ref["c"]
    plan = tb.window_starts(t(jk), t(jm), t(jk), RADIUS, win)
    assert bool(plan.exact) and bool(jx)
    frames, valid = tlrfm.shot_lrf_windowed(t(jp), t(jm), plan.starts, win,
                                            RADIUS)
    assert_frames_close(frames, valid, jf, jv)
    q_s, p_s = tlrfm.prep_shift(t(jp), t(jp), t(jm))
    _, cnt = tlrfm.moments_windowed(q_s, p_s, t(jm), plan.starts, win,
                                    RADIUS)
    ok = np.asarray(jm)
    assert (np.abs(n(cnt) - np.asarray(jc))[ok] <= 1).all()


def test_windowed_twins_equal_dense_twins_on_an_exact_plan(clouds):
    """With an exact plan the windows hold every in-radius point: K5's and
    K6's twins give the dense twins' counts exactly and their sums to f32
    round-off."""
    pts, mask = clouds
    s = tb.sort_clouds_ex(t(pts), t(mask))
    win = tb.required_window(t(pts), t(mask), RADIUS)
    plan = tb.window_starts(s.keys, s.mask, s.keys, RADIUS, win)
    q, p = tlrfm.prep_shift(s.points, s.points, s.mask)
    mom, cnt = tlrfm.moments_windowed(q, p, s.mask, plan.starts, win, RADIUS)
    dmom, dcnt = tlrfm.moments(q, p, s.mask, RADIUS)
    assert torch.equal(cnt, dcnt)
    torch.testing.assert_close(mom, dmom, rtol=1e-4, atol=1e-5)
    axes = torch.nn.functional.normalize(
        torch.randn(*q.shape[:2], 6, generator=torch.Generator().manual_seed(
            4)), dim=-1)
    v = tlrfm.sign_votes_windowed(q, p, s.mask, axes, plan.starts, win,
                                  RADIUS)
    assert torch.equal(v, tlrfm.sign_votes(q, p, s.mask, axes, RADIUS))


@pytest.mark.parametrize("case", ["window", "starts"])
def test_windowed_wrappers_check_inputs(case):
    q = torch.zeros(1, 300, 3)
    m = torch.ones(1, 300, dtype=torch.bool)
    starts = torch.zeros(1, 2, dtype=torch.int32)
    window = 128
    if case == "window":
        window = 301
    else:
        starts = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tlrfm.moments_windowed(q, q, m, starts, window, 0.5)
