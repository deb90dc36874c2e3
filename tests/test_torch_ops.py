"""Module parity of the PyTorch port against the JAX package on CPU:
eigh3, geometry quaternions, voxel grid, kNN (l2 and exact chi-square)
and vote casting.  Same seeded numpy inputs through both."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapes
from torch_parity import assert_topk_close, n, t

from point_cloud_donkey_tpu.models import codebook as jcb
from point_cloud_donkey_tpu.ops import eigh3 as jeigh
from point_cloud_donkey_tpu.ops import geometry as jgeo
from point_cloud_donkey_tpu.ops import neighbors as jnb
from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid as jvoxel
from point_cloud_donkey_tpu_torch.models import codebook as tcb
from point_cloud_donkey_tpu_torch.ops import eigh3 as teigh
from point_cloud_donkey_tpu_torch.ops import geometry as tgeo
from point_cloud_donkey_tpu_torch.ops import neighbors as tnb
from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid as tvoxel

CODEBOOK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "point_cloud_donkey_tpu_torch", "data",
    "bench_codebook.ism")


def _sym(rng, m):
    a = rng.normal(size=(m, 3, 3)).astype(np.float32)
    return (a + np.swapaxes(a, 1, 2)) * np.float32(0.5)


def test_eigh3_matches_jax():
    """Same closed form: eigenvalues to f32 round-off; eigenvectors with
    the same signs (the LRF tie rule reads them) to 1e-4."""
    rng = np.random.default_rng(0)
    a = _sym(rng, 2000)
    a[:100] *= 1e-6                                  # tiny scales
    a[100:200] += 5.0 * np.eye(3, dtype=np.float32)  # shifted spectra
    jv, jvec = jeigh.eigh3x3(jnp.asarray(a))
    tv, tvec = teigh.eigh3x3(t(a))
    scale = np.abs(a).max(axis=(1, 2))[:, None]
    assert (np.abs(n(tv) - n(jv)) <= 1e-5 * scale).all()
    assert np.abs(n(tvec) - n(jvec)).max() < 1e-4
    np.testing.assert_allclose(n(teigh.eigvals3x3(t(a))),
                               n(jeigh.eigvals3x3(jnp.asarray(a))),
                               atol=1e-4)


@pytest.mark.parametrize("name,mat", [
    ("zero", np.zeros((3, 3))),
    ("identity", np.eye(3)),
    ("double", np.diag([1.0, 1.0, 2.0])),
    ("rank1", np.outer([1.0, 2.0, 2.0], [1.0, 2.0, 2.0])),
])
def test_eigh3_degenerate_fallbacks(name, mat):
    """Repeated eigenvalues and the zero matrix take the same fallbacks
    (e_x, then any vector orthogonal to v2) and stay orthonormal."""
    a = mat.astype(np.float32)[None]
    jv, jvec = jeigh.eigh3x3(jnp.asarray(a))
    tv, tvec = teigh.eigh3x3(t(a))
    np.testing.assert_allclose(n(tv), n(jv), atol=1e-6)
    np.testing.assert_allclose(n(tvec), n(jvec), atol=1e-5)
    v = n(tvec)[0]
    np.testing.assert_allclose(v.T @ v, np.eye(3), atol=1e-5)


def test_matrix_to_quat_and_multiply_match_jax():
    rng = np.random.default_rng(1)
    rots = np.stack([shapes.random_rotation(rng) for _ in range(400)])
    # hit every Shepperd case: rotations by ~pi about each axis
    for ax in range(3):
        r = -np.eye(3, dtype=np.float32)
        r[ax, ax] = 1.0
        rots = np.concatenate([rots, r[None]])
    jq = jax.vmap(jgeo.matrix_to_quat)(jnp.asarray(rots))
    tq = tgeo.matrix_to_quat(t(rots))
    np.testing.assert_allclose(n(tq), n(jq), atol=1e-6)
    q2 = rng.normal(size=(len(rots), 4)).astype(np.float32)
    np.testing.assert_allclose(
        n(tgeo.quat_multiply(tq, t(q2))),
        n(jgeo.quat_multiply(jq, jnp.asarray(q2))), atol=1e-5)


@pytest.mark.parametrize("capacity", [192, 12])
def test_voxel_grid_matches_jax(capacity):
    """Keypoint contract: mask equal, centroids within 1e-5; with a small
    capacity, voxel ids past it are dropped the same way."""
    rng = np.random.default_rng(2)
    b, npts = 3, 2048
    pts = np.stack([shapes.make_instance(rng, i, n=npts, rotate=True)
                    for i in range(b)])
    mask = np.ones((b, npts), bool)
    mask[1, 1500:] = False
    pts[1, 1500:] = 777.0                       # garbage behind the mask
    mask[2] = False                             # an empty cloud
    jr = jax.vmap(lambda p, m: jvoxel(p, m, 0.35, capacity=capacity))(
        jnp.asarray(pts), jnp.asarray(mask))
    tr = tvoxel(t(pts), t(mask), 0.35, capacity=capacity)
    np.testing.assert_array_equal(n(tr.mask), n(jr.mask))
    np.testing.assert_allclose(n(tr.centroids), n(jr.centroids)[..., :3],
                               atol=1e-5)
    # valid rows first (the compact SHOT stage relies on it)
    m = n(tr.mask)
    for row in m:
        c = row.sum()
        assert row[:c].all() and not row[c:].any()
    # single cloud form
    single = tvoxel(t(pts[0]), t(mask[0]), 0.35, capacity=capacity)
    np.testing.assert_array_equal(n(single.mask), m[0])


def _histograms(rng, rows, dim=352):
    x = rng.random((rows, dim)).astype(np.float32)
    x[rng.random((rows, dim)) < 0.6] = 0.0      # sparse, like SHOT
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)


@pytest.mark.parametrize("metric", ["chisq", "l2"])
@pytest.mark.parametrize("k", [1, 3])
def test_knn_matches_jax(metric, k):
    """Chi-square contract: distances rtol 1e-5, indices equal except at
    ties; masked codewords are +inf; exact ties go to the lower index."""
    rng = np.random.default_rng(3)
    q = _histograms(rng, 150)
    db = _histograms(rng, 120)
    db[7] = db[3]                                # exact tie: 3 before 7
    q[0] = db[3]
    db_mask = np.ones(120, bool)
    db_mask[[10, 50]] = False
    q[1] = db[10]                                # nearest one is masked
    jd, ji = jnb.knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(db_mask),
                     k=k, metric=metric, exact=True)
    td, ti = tnb.knn(t(q), t(db), t(db_mask), k, metric)
    assert_topk_close(td, ti, jd, ji)
    if k == 3:
        assert n(ti)[0, :2].tolist() == [3, 7]
    assert 10 not in n(ti)[1]


def test_knn_all_masked_gives_inf_lowest_indices():
    rng = np.random.default_rng(4)
    q, db = _histograms(rng, 5), _histograms(rng, 6)
    mask = np.zeros(6, bool)
    jd, ji = jnb.knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(mask),
                     k=2, metric="chisq", exact=True)
    td, ti = tnb.knn(t(q), t(db), t(mask), 2, "chisq")
    assert np.isinf(n(td)).all()
    np.testing.assert_array_equal(n(ti), n(ji))


def test_distance_matrix_and_descriptor_distance_match_jax():
    rng = np.random.default_rng(5)
    a, b = _histograms(rng, 40), _histograms(rng, 30)
    np.testing.assert_allclose(
        n(tnb.chi_square_distance_matrix(t(a), t(b))),
        n(jnb.chi_square_distance_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        n(tnb.pairwise_sqdist(t(a), t(b))),
        n(jnb.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    for metric in ("l2", "chisq"):
        np.testing.assert_allclose(
            n(tnb.descriptor_distance(t(a[:30]), t(b), metric)),
            n(jnb.descriptor_distance(jnp.asarray(a[:30]), jnp.asarray(b),
                                      metric)), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def codebooks():
    with np.load(CODEBOOK + "d.npz") as z:
        arrays = {k: z[k] for k in z.files}
    jax_cb = jcb.TrainedCodebook(**{k[3:]: jnp.asarray(v)
                                    for k, v in arrays.items()
                                    if k.startswith("cb_")})
    return jax_cb, tcb.Codebook.from_numpy(arrays)


@pytest.mark.parametrize("flags", [
    {},
    {"use_matching_weight": True, "use_vote_weight": True},
    {"use_distance_ratio": True, "distance_ratio_threshold": 0.9,
     "use_class_weight": True, "use_codeword_weight": True},
])
def test_cast_votes_matches_jax(codebooks, flags):
    """KNN vote casting on the fixture codebook: descriptors near real
    codewords, random frames and positions, some rows masked."""
    jax_cb, t_cb = codebooks
    rng = np.random.default_rng(6)
    cw = np.asarray(jax_cb.codewords)
    f = 64
    desc = cw[rng.integers(0, len(cw), f)] + 0.02 * rng.random(
        (f, cw.shape[1])).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    frames = np.stack([shapes.random_rotation(rng) for _ in range(f)])
    pos = rng.normal(size=(f, 3)).astype(np.float32)
    fmask = rng.random(f) > 0.2
    jp = jcb.CodebookParams(knn_k=1, flann_exact=True, **flags)
    tp = tcb.CodebookParams(knn_k=1, **flags)
    jv = jcb.cast_votes(jax_cb, jnp.asarray(desc), jnp.asarray(pos),
                        jnp.asarray(frames), jnp.asarray(fmask), jp, "chisq")
    tv = tcb.cast_votes(t_cb, t(desc), t(pos), t(frames), t(fmask), tp,
                        "chisq")
    np.testing.assert_array_equal(n(tv.valid), n(jv.valid))
    np.testing.assert_array_equal(n(tv.class_id), n(jv.class_id))
    np.testing.assert_array_equal(n(tv.instance_id), n(jv.instance_id))
    for name in ("position", "weight", "keypoint", "keypoint_training",
                 "bbox_size", "bbox_quat"):
        np.testing.assert_allclose(n(getattr(tv, name)),
                                   n(getattr(jv, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert n(tv.valid).any()


def test_cast_votes_rejects_unported_activation(codebooks):
    """The training activation raises ValueError on an unknown activation
    name, as the JAX ``training_activation`` does; serving treats such a
    name as KNN (the JAX ``cast_votes``'s else branch)."""
    _, t_cb = codebooks
    params = tcb.CodebookParams(activation_type="Nearest")
    q = t_cb.codewords[:4].contiguous()
    with pytest.raises(ValueError, match="Nearest"):
        tcb.training_activation(q, q, params, "chisq")
    args = (t_cb, q, torch.zeros(4, 3), torch.eye(3).expand(4, 3, 3),
            torch.ones(4, dtype=bool))
    got = tcb.cast_votes(*args, params, "chisq")
    want = tcb.cast_votes(*args, tcb.CodebookParams(), "chisq")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_codebook_is_a_module_of_buffers(codebooks):
    """The codebook moves with .to(); load_codebook reads the saved model."""
    _, t_cb = codebooks
    names = {name for name, _ in t_cb.named_buffers()}
    assert names == set(tcb.CODEBOOK_FIELDS)
    assert t_cb.codewords.shape == (458, 352) and t_cb.num_classes == 5
    loaded = tcb.load_codebook(CODEBOOK)
    assert torch.equal(loaded.codewords, t_cb.codewords)
    assert loaded.to(torch.float64).codewords.dtype == torch.float64
