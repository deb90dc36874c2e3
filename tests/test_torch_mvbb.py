"""The port's MVBB (ops/geometry.compute_mvbb_batch) and quaternion
rotations against the JAX package's ``compute_mvbb`` (its batched
``_mvbb_host_batch``) and ``quat_rotate`` / ``quat_rotate_inv`` on the CPU,
on seeded clouds of the five test shapes.

The contract: sorted sizes within rtol 1e-4, the 8 corners within
1e-4 x the box's extent, and the quaternion equal up to sign wherever the
covariance's eigenvalues differ by more than 1e-3 relative (where two are
closer, the PCA frame -- and with it the candidate set -- is ill-posed and
an equal-volume box may come under another rotation)."""

import numpy as np
import pytest

import shapes
from torch_parity import n, t

from point_cloud_donkey_tpu.models.ism import _mvbb_host_batch
from point_cloud_donkey_tpu.ops import geometry as jgeo
from point_cloud_donkey_tpu_torch.models.features import pad_cloud
from point_cloud_donkey_tpu_torch.ops import geometry as tgeo

CORNERS = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                    for z in (-.5, .5)], np.float32)


def corners(pos, size, quat):
    return (CORNERS * size) @ tgeo.quat_to_matrix_np(quat) + pos


def clouds(seed, count=5, rotate=True):
    rng = np.random.default_rng(seed)
    return [shapes.make_instance(rng, i % 5, n=600 + 53 * i, rotate=rotate,
                                 noise=0.005).astype(np.float32)
            for i in range(count)]


def eigen_gap(xyz):
    c = xyz.astype(np.float64) - xyz.mean(0)
    vals = np.linalg.eigvalsh(c.T @ c / len(c))
    return np.min(np.diff(vals)) / max(vals[-1], 1e-30)


@pytest.mark.parametrize("seed,rotate", [(3, True), (8, True), (42, False)])
def test_mvbb_matches_jax(seed, rotate):
    cl = clouds(seed, rotate=rotate)
    want = _mvbb_host_batch(cl)
    bucket = 2048
    pts = np.stack([pad_cloud(c, bucket)[0] for c in cl])
    mask = np.stack([pad_cloud(c, bucket)[1] for c in cl])
    pos, size, quat = (n(x) for x in tgeo.compute_mvbb_batch(t(pts),
                                                             t(mask)))
    for i, w in enumerate(want):
        ext = float(np.max(w.size))
        np.testing.assert_allclose(np.sort(size[i]), np.sort(w.size),
                                   rtol=1e-4)
        assert np.abs(corners(pos[i], size[i], quat[i])
                      - corners(w.position, w.size, w.quat)).max() \
            <= 1e-4 * ext
        if eigen_gap(cl[i]) > 1e-3:
            err = min(np.abs(quat[i] - w.quat).max(),
                      np.abs(quat[i] + w.quat).max())
            assert err <= 1e-4, (i, err)


def test_mvbb_ignores_the_padding():
    """Masked points hold whatever they hold (1e9 or garbage): the boxes
    are equal bit for bit."""
    cl = clouds(5, count=2)
    pts = np.stack([pad_cloud(c, 4096)[0] for c in cl])
    mask = np.stack([pad_cloud(c, 4096)[1] for c in cl])
    a = tgeo.compute_mvbb_batch(t(pts), t(mask))
    pts[~mask] = np.float32(123.0)
    b = tgeo.compute_mvbb_batch(t(pts), t(mask))
    for got, want in zip(b, a):
        np.testing.assert_array_equal(n(got), n(want))


def test_quat_rotations_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    import jax.numpy as jnp
    for fn, jfn in ((tgeo.quat_rotate, jgeo.quat_rotate),
                    (tgeo.quat_rotate_inv, jgeo.quat_rotate_inv)):
        np.testing.assert_allclose(n(fn(t(q), t(v))),
                                   np.asarray(jfn(jnp.asarray(q),
                                                  jnp.asarray(v))),
                                   rtol=1e-6, atol=1e-6)
