"""The port's scene-scale tiles (point_cloud_donkey_tpu_torch/ops/tiled.py)
and principal curvatures (ops/curvature.py) against the JAX package's on
the CPU, on the same sorted cloud and the same plan.

The cloud is tests/test_tiled.py's noisy ellipsoid shell (3000 points,
sorted along x); the chunks are 512 queries, as there.  Tolerances:
  * plan_tiles: equal (the same host arithmetic);
  * moments: count equal, covariance rtol 2e-3 / atol 2e-5 and mean rtol
    1e-4 / atol 1e-5 (tests/test_tiled.py's tiled-vs-dense contract);
  * normals: >= 99.5% of the directions within 1 - |cos| < 1e-3 and the
    curvature rtol 5e-3 / atol 5e-5 (tests/test_tiled.py);
  * SOR and ROR masks equal; MLS positions rtol 1e-3 / atol 1e-4
    (tests/test_tiled.py:135-137);
  * principal curvatures rtol 1e-3 / atol 1e-5 (the moment identity's
    float sums in another order), KPQ aggregates: counts equal, sums
    rtol 1e-3 / atol 1e-6, extrema rtol 1e-4 / atol 1e-6 (taken over
    the same point sets);
  * Lab colours within 1e-6 of the jitted JAX conversion (ops/color.py
    repeats its float operations; tests/test_torch_cshot.py), colour
    counts equal on equal Lab values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import n, t

from point_cloud_donkey_tpu.ops import curvature as jcurv
from point_cloud_donkey_tpu.ops import tiled as jt
from point_cloud_donkey_tpu.ops.color import \
    rgb_to_cielab_normalized as jlab
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.ops import curvature as tcurv
from point_cloud_donkey_tpu_torch.ops import tiled as tt
from point_cloud_donkey_tpu_torch.ops.color import \
    rgb_to_cielab_normalized as tlab
from point_cloud_donkey_tpu_torch.ops.neighbors import radius_covariance

RADIUS = 0.35
CHUNK = 512


def _cloud(n_pts=3000, seed=0):
    """tests/test_tiled.py's cloud: a noisy ellipsoid shell, sorted on x."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= np.array([1.5, 1.0, 0.6], np.float32)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return pts[np.argsort(pts[:, 0], kind="stable")]


def _pad(pts, bucket):
    out = np.full((bucket, 3), 1e9, np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(bucket, bool)
    mask[:len(pts)] = True
    return out, mask


@pytest.fixture(scope="module")
def cloud():
    p, m = _pad(_cloud(), 3072)
    plan = jt.plan_tiles(p[:, 0], m, p[:, 0], RADIUS, chunk=CHUNK,
                         min_window=256)
    return p, m, plan


@pytest.mark.parametrize("radius,chunk,min_window", [
    (0.35, 512, 256), (0.0, 512, 2048), (0.05, 64, 1024), (2.0, 100, 64)])
def test_plan_tiles_equal_jax(radius, chunk, min_window):
    p, m = _pad(_cloud(), 3072)
    q, qm = _pad(_cloud(700, seed=3), 768)
    for qk, qv in ((p[:, 0], m), (q[:, 0], qm)):
        want = jt.plan_tiles(qk, qv, p[:, 0], radius, chunk, min_window)
        got = tt.plan_tiles(qk, qv, p[:, 0], radius, chunk, min_window)
        assert (got.window, got.chunk, got.n_chunks) == \
            (want.window, want.chunk, want.n_chunks)
        np.testing.assert_array_equal(got.starts, want.starts)


def test_plan_is_exact_and_slabs_bounded():
    """Every chunk's window holds every point within the radius of its
    queries (plan_tiles asserts it); slab groups stay under SLAB_BYTES."""
    p, m = _pad(_cloud(), 3072)
    plan = tt.plan_tiles(p[:, 0], m, p[:, 0], RADIUS, CHUNK, 256)
    for c in range(plan.n_chunks):
        qv = m[c * CHUNK:(c + 1) * CHUNK]
        if not qv.any():
            continue
        qx = p[c * CHUNK:(c + 1) * CHUNK, 0][qv]
        inside = np.nonzero((p[:, 0] >= qx.min() - RADIUS)
                            & (p[:, 0] <= qx.max() + RADIUS) & m)[0]
        s = plan.starts[c]
        assert inside.min() >= s and inside.max() < s + plan.window
    slab = tt.window_slabs(torch.from_numpy(p), plan)
    assert slab.shape == (plan.n_chunks, plan.window, 3)
    np.testing.assert_array_equal(n(slab[1]),
                                  p[plan.starts[1]:plan.starts[1]
                                    + plan.window])
    for c0, c1 in tt.slab_groups(10_000, 4096):
        assert (c1 - c0) * 4096 * 12 <= tt.SLAB_BYTES


def test_tiled_moments_match_jax(cloud):
    p, m, plan = cloud
    want = jt.tiled_radius_moments(p, p, m, plan, RADIUS)
    got = tt.tiled_radius_moments(t(p), t(p), t(m), plan, RADIUS)
    np.testing.assert_array_equal(n(got.count)[m], np.asarray(want.count)[m])
    np.testing.assert_allclose(n(got.cov)[m], np.asarray(want.cov)[m],
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(n(got.mean)[m], np.asarray(want.mean)[m],
                               rtol=1e-4, atol=1e-5)
    # and the port's tiles equal its dense moments
    dense = radius_covariance(t(p)[None], t(p)[None], t(m)[None], RADIUS)
    np.testing.assert_allclose(n(got.cov)[m], n(dense.cov[0])[m],
                               rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("method", [0, 1, 2])
def test_tiled_normals_match_jax(cloud, method):
    p, m, plan = cloud
    want = jt.tiled_compute_normals(p, m, plan, RADIUS, method)
    build.reset_launch_counts()
    got = tt.tiled_compute_normals(t(p), t(m), plan, RADIUS, method)
    assert set(build.launch_counts().values()) == {0}
    dots = np.abs(np.sum(n(got.normals)[m] * np.asarray(want.normals)[m],
                         axis=1))
    assert np.mean(dots > 0.999) > 0.995
    np.testing.assert_allclose(n(got.curvature)[m],
                               np.asarray(want.curvature)[m],
                               rtol=5e-3, atol=5e-5)
    np.testing.assert_array_equal(n(got.valid)[m], np.asarray(want.valid)[m])


def test_tiled_filters_match_jax():
    pts = _cloud(2000, seed=5)
    pts[::97] += 3.0    # outliers
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    p, m = _pad(pts, 2048)
    pj, mj = jnp.asarray(p), jnp.asarray(m)
    plan0 = jt.plan_tiles(p[:, 0], m, p[:, 0], 0.0, 512, min_window=1024)
    np.testing.assert_array_equal(
        n(tt.tiled_statistical_outlier_removal(t(p), t(m), plan0, 10, 1.0)),
        np.asarray(jt.tiled_statistical_outlier_removal(pj, mj, plan0, 10,
                                                        1.0)))
    plan = jt.plan_tiles(p[:, 0], m, p[:, 0], 0.2, 512, min_window=256)
    np.testing.assert_array_equal(
        n(tt.tiled_radius_outlier_removal(t(p), t(m), plan, 0.2, 5)),
        np.asarray(jt.tiled_radius_outlier_removal(pj, mj, plan, 0.2, 5)))
    np.testing.assert_allclose(
        n(tt.tiled_mls_smooth(t(p), t(m), plan, 0.2))[m],
        np.asarray(jt.tiled_mls_smooth(pj, mj, plan, 0.2))[m],
        rtol=1e-3, atol=1e-4)


def _normals(pts, seed=1):
    """Unnormalised, roughly outward normals (the voxel-averaged normals
    the culling reads are unnormalised too)."""
    rng = np.random.default_rng(seed)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    nrm += rng.normal(scale=0.05, size=nrm.shape)
    return nrm.astype(np.float32)


def test_principal_curvatures_match_jax():
    pts = _cloud(1500, seed=2)
    nrm = _normals(pts)
    q, qn = pts[::7], nrm[::7]
    m = np.ones(len(pts), bool)
    want = jcurv.principal_curvatures(q, qn, pts, nrm, m, 0.3)
    got = tcurv.principal_curvatures(t(q), t(qn), t(pts), t(nrm), t(m), 0.3)
    for f in ("pc1", "pc2"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-3, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))


def test_tiled_curvatures_and_kpq_match_jax(cloud):
    p, m, plan = cloud
    nrm = np.zeros_like(p)
    nrm[m] = _normals(p[m])
    want = jt.tiled_principal_curvatures(p, nrm, p, nrm, m, plan, RADIUS)
    got = tt.tiled_principal_curvatures(t(p), t(nrm), t(p), t(nrm), t(m),
                                        plan, RADIUS)
    for f in ("pc1", "pc2"):
        np.testing.assert_allclose(n(getattr(got, f))[m],
                                   np.asarray(getattr(want, f))[m],
                                   rtol=1e-3, atol=1e-5, err_msg=f)
    k1, k2 = np.asarray(want.pc1), np.asarray(want.pc2)
    kp, kpm = _pad(p[m][::11], 320)
    plan_kp = jt.plan_tiles(kp[:, 0], kpm, p[:, 0], RADIUS, 64)
    want_a = jt.tiled_kpq_aggregate(kp, p, k1, k2, m, plan_kp, RADIUS)
    got_a = tt.tiled_kpq_aggregate(t(kp), t(p), t(k1), t(k2), t(m), plan_kp,
                                   RADIUS)
    np.testing.assert_array_equal(n(got_a[0])[kpm],
                                  np.asarray(want_a[0])[kpm])
    np.testing.assert_allclose(n(got_a[1])[kpm], np.asarray(want_a[1])[kpm],
                               rtol=1e-3, atol=1e-6)
    for g, w in zip(got_a[2:], want_a[2:]):
        np.testing.assert_allclose(n(g)[kpm], np.asarray(w)[kpm], rtol=1e-4,
                                   atol=1e-6)


def test_tiled_color_counts_match_jax(cloud):
    p, m, plan = cloud
    rng = np.random.default_rng(4)
    rgb = (rng.integers(0, 256, size=(len(p), 3)) / 255.0).astype(
        np.float32)
    # the port repeats the jitted JAX conversion (ops/color.py); both
    # packages' counts then read the same Lab values
    lab_j = np.asarray(jax.jit(jlab)(jnp.asarray(rgb)))
    np.testing.assert_allclose(n(tlab(t(rgb))), lab_j, rtol=0, atol=1e-6)
    lab_t = lab_j
    kp, kpm = _pad(p[m][::9], 384)
    klab = np.zeros_like(kp)
    klab[kpm] = lab_j[m][::9]
    plan_kp = jt.plan_tiles(kp[:, 0], kpm, p[:, 0], 0.2, 64)
    want = jt.tiled_color_counts(kp, klab, p, lab_j, m, plan_kp, 0.2, 0.05)
    got = tt.tiled_color_counts(t(kp), t(klab), t(p), t(lab_t), t(m),
                                plan_kp, 0.2, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g)[kpm], np.asarray(w)[kpm])
