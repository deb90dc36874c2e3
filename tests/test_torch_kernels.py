"""The port's kernel modules (ops/kernels/) against the JAX Pallas kernels
they replace, run as the JAX package's own tests run them on the CPU
(interpret mode, in processes of their own: torch_parity.StartedReference),
and against the golden descriptors.  On the CPU every wrapper runs its
plain PyTorch twin; tests/test_torch_cuda.py holds each CUDA kernel
against that twin on the card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapes
from torch_parity import (assert_descriptors_close, assert_frames_close,
                          StartedReference, assert_topk_close, n, t)

from point_cloud_donkey_tpu.ops.lrf import shot_lrf as j_shot_lrf
from point_cloud_donkey_tpu.ops.normals import \
    compute_normals_fast as j_normals
from point_cloud_donkey_tpu.ops.shot import \
    shot_descriptor_dense as j_shot_dense
from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid as j_voxel
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.ops.kernels import chisq as tchisq
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm
from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as tshot
from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf as t_shot_lrf
from point_cloud_donkey_tpu_torch.ops.normals import \
    compute_normals_fast as t_normals
from point_cloud_donkey_tpu_torch.ops.shot import \
    shot_descriptor_dense as t_shot_dense

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "descriptors.npz")


@pytest.fixture(scope="module")
def cloud():
    pts = shapes.make_instance(np.random.default_rng(7), 1, n=700,
                               rotate=False).astype(np.float32)
    return pts, np.ones(len(pts), bool)


@pytest.fixture(scope="module")
def bench_clouds():
    """Two bench-geometry clouds at N=1024 (interpret mode stays small),
    their normals, voxel keypoints and keypoint LRFs from the JAX path."""
    rng = np.random.default_rng(5)
    b, npts, k = 2, 1024, 32
    pts = np.stack([shapes.make_instance(rng, i % 5, n=npts, rotate=True)
                    for i in range(b)]).astype(np.float32)
    mask = np.ones((b, npts), bool)

    def per_cloud(p, m):
        nrm = j_normals(p, m, 0.25)
        kres = j_voxel(p, m, 0.35, capacity=k)
        kp = jnp.where(kres.mask[:, None], kres.centroids[:, :3], 1e9)
        lrf = j_shot_lrf(kp, kres.mask, p, m, 0.5)
        return nrm, kp, kres.mask, lrf.frames, lrf.valid

    out = jax.vmap(per_cloud)(jnp.asarray(pts), jnp.asarray(mask))
    return (pts, mask) + tuple(np.asarray(x) for x in out)


def _ties_case():
    """A centre of symmetry: coordinates on a 1/64 grid keep the centroid
    shift exactly 0 and the offsets of each point pair exactly opposite."""
    rng = np.random.default_rng(12)
    half = rng.integers(-32, 33, size=(80, 3)).astype(np.float32) / 64
    pts = np.concatenate([half, -half])
    return (np.zeros((1, 3), np.float32), np.ones(1, bool), pts,
            np.ones(len(pts), bool))


def _chisq_case():
    """Sparse non-negative descriptors (60% zeros) and a codebook with
    ~10% of its codewords masked."""
    rng = np.random.default_rng(8)
    a = rng.random((70, 352)).astype(np.float32)
    a[rng.random(a.shape) < 0.6] = 0.0
    b = rng.random((150, 352)).astype(np.float32)
    b[rng.random(b.shape) < 0.6] = 0.0
    return a, b, rng.random(150) > 0.1


_LRF_CODE = """
import jax
import jax.numpy as jnp
from point_cloud_donkey_tpu.ops.pallas.lrf_moments import (lrf_moments,
                                                           shot_lrf_pallas)
g = lambda *keys: [jnp.asarray(a[k]) for k in keys]
out = {}
p, m = g("p", "m")
out["cov"], out["w"], out["cnt"] = lrf_moments(
    p[::9], jnp.ones(len(p[::9]), bool), p, m, 0.4, weighting="shot",
    center="query")
for z in (0, 1):
    out["f%d" % z], out["v%d" % z] = shot_lrf_pallas(p, m, p, m, 0.3,
                                                     z_only=bool(z))
out["kf"], out["kv"] = jax.vmap(lambda q, qm, pp, mm: shot_lrf_pallas(
    q, qm, pp, mm, 0.5))(*g("kp", "kmask", "pts", "mask"))
out["tf"], out["tv"] = shot_lrf_pallas(*g("tq", "tqm", "tp", "tm"), 0.9)
"""

_SHOT_CHISQ_CODE = """
import jax.numpy as jnp
from point_cloud_donkey_tpu.ops.pallas.chisq import \\
    chi_square_distance_matrix_pallas
from point_cloud_donkey_tpu.ops.pallas.shot_fused import \\
    shot_descriptor_fused_compact
g = lambda *keys: [jnp.asarray(a[k]) for k in keys]
out = {}
res = shot_descriptor_fused_compact(
    *g("kp", "fr", "fv", "kmask", "pts", "nrm", "mask"), 0.6,
    int(a["tiles"]) + 2, interpret=True)
for name, r in zip("dvkfcx", res):
    out["c" + name] = r
out["chisq"] = chi_square_distance_matrix_pallas(*g("ca", "cb"))
"""


@pytest.fixture(scope="module")
def pallas_refs(cloud, bench_clouds, tmp_path_factory):
    """Every interpret-mode reference of this file, in two processes of
    their own that run at once: K1's moments and K1/K2's LRFs on `cloud`, the keypoint LRFs
    on `bench_clouds` and the LRF at a centre of symmetry; the compact
    SHOT (K3) on `bench_clouds` and K4's chi-square matrix."""
    p, m = cloud
    pts, mask, nrm, kp, kmask, fr, fv = bench_clouds
    tq, tqm, tp, tm = _ties_case()
    ca, cb, _ = _chisq_case()
    tiles = int(np.ceil(kmask.sum(1) / tshot.TK).sum())
    lrf = StartedReference(
        _LRF_CODE, str(tmp_path_factory.mktemp("k1k2")), p=p, m=m, pts=pts,
        mask=mask, kp=kp, kmask=kmask, tq=tq, tqm=tqm, tp=tp, tm=tm)
    shot = StartedReference(
        _SHOT_CHISQ_CODE, str(tmp_path_factory.mktemp("k3k4")), pts=pts,
        mask=mask, nrm=nrm, kp=kp, kmask=kmask, fr=fr, fv=fv,
        tiles=np.int64(tiles), ca=ca, cb=cb)
    return {**lrf.result(), **shot.result()}


# --- K1 / K2: lrf_moments ---------------------------------------------------

def test_moments_match_pallas_interpret(cloud, pallas_refs):
    """Moments contract: weight sums rtol 2e-4, counts within +-1,
    covariance atol 5e-4 (the JAX package's own bound)."""
    p, m = cloud
    kp, km = p[::9], np.ones(len(p[::9]), bool)
    jcov, jw, jc = (pallas_refs[k] for k in ("cov", "w", "cnt"))
    q_s, p_s = tlrfm.prep_shift(t(kp)[None], t(p)[None], t(m)[None])
    mom, tc = tlrfm.moments(q_s, p_s, t(m)[None], 0.4)
    tcov, tw = tlrfm.cov_from_moments(mom, q_s, t(km)[None])
    np.testing.assert_allclose(n(tw)[0], n(jw), rtol=2e-4)
    assert (np.abs(n(tc)[0] - n(jc)) <= 1).all()
    np.testing.assert_allclose(n(tcov)[0], n(jcov), atol=5e-4)


@pytest.mark.parametrize("z_only", [False, True])
def test_shot_lrf_matches_pallas_interpret(cloud, z_only, pallas_refs):
    """Frame contract: valid flags equal, >= 97% of frames within 2e-3."""
    p, m = cloud
    jf, jv = pallas_refs[f"f{int(z_only)}"], pallas_refs[f"v{int(z_only)}"]
    res = t_shot_lrf(t(p), t(m), t(p), t(m), 0.3, z_only=z_only)
    assert_frames_close(res.frames, res.valid, jf, jv)


def test_keypoint_lrfs_match_pallas_interpret(bench_clouds, pallas_refs):
    """LRFs at voxel keypoints of bench-geometry clouds (the K1/K2 call
    at Q=K of the slice), batched, invalid keypoints included."""
    pts, mask, _, kp, kmask, _, _ = bench_clouds
    jf, jv = pallas_refs["kf"], pallas_refs["kv"]
    res = t_shot_lrf(t(kp), t(kmask), t(pts), t(mask), 0.5)
    assert_frames_close(res.frames, res.valid, jf, jv)


def test_lrf_sign_ties_keep_the_eigh_sign(pallas_refs):
    """At a centre of symmetry every sign vote ties, and a tie keeps the
    closed-form EVD's sign, as in the Pallas kernel (`_ties_case`)."""
    q, qm, pts, m = _ties_case()
    jf, jv = pallas_refs["tf"], pallas_refs["tv"]
    res = t_shot_lrf(t(q), t(qm), t(pts), t(m), 0.9)
    assert n(res.valid).all() and np.asarray(jv).all()
    np.testing.assert_allclose(n(res.frames), np.asarray(jf), atol=1e-5)


def test_normals_of_isolated_points_fall_back_to_plus_z():
    """A point with < 5 neighbours in the normal radius gets +z (not a
    PCA normal), as in the JAX serving normals."""
    pts = shapes.make_instance(np.random.default_rng(13), 2, n=300,
                               rotate=False).astype(np.float32)
    lonely = np.array([[9.0, 0.0, 0.0], [0.0, 9.0, 0.0], [0.0, 0.0, -9.0]],
                      np.float32)
    pts = np.concatenate([pts, lonely])
    m = np.ones(len(pts), bool)
    tn = n(t_normals(t(pts), t(m), 0.25))
    jn = np.asarray(j_normals(jnp.asarray(pts), jnp.asarray(m), 0.25))
    np.testing.assert_array_equal(tn[-3:], np.tile([0.0, 0.0, 1.0], (3, 1)))
    np.testing.assert_array_equal(tn[-3:], jn[-3:])
    assert (np.abs(tn - jn).max(-1) < 2e-3).mean() >= 0.97


def test_normals_match_jax(bench_clouds):
    """compute_normals_fast vs the JAX serving normals (matmul-identity
    moments): >= 97% of normals within 2e-3, +z where the LRF is invalid."""
    pts, mask, jn, _, _, _, _ = bench_clouds
    tn = n(t_normals(t(pts), t(mask), 0.25))
    err = np.abs(tn - jn).max(-1)
    assert (err < 2e-3).mean() >= 0.97
    np.testing.assert_allclose(np.linalg.norm(tn, axis=-1), 1.0, atol=1e-5)


def test_lrf_matches_golden():
    g = np.load(GOLDEN)
    pts, kp = g["points"], g["keypoints"]
    res = t_shot_lrf(t(kp), torch.ones(len(kp), dtype=bool), t(pts),
                     torch.ones(len(pts), dtype=bool), 0.6)
    assert n(res.valid).all()
    np.testing.assert_allclose(n(res.frames), g["frames"], atol=2e-3)


# --- K3: shot_fused ---------------------------------------------------------

def test_shot_plain_matches_golden():
    g = np.load(GOLDEN)
    pts, nrm, kp = g["points"], g["normals"], g["keypoints"]
    res = t_shot_dense(t(kp), t(g["frames"], np.float32),
                       torch.ones(len(kp), dtype=bool), t(pts), t(nrm),
                       torch.ones(len(pts), dtype=bool), 0.6)
    assert n(res.valid).all()
    np.testing.assert_allclose(n(res.descriptors), g["shot"], atol=2e-3)


def test_shot_plain_matches_jax_dense(bench_clouds):
    """Descriptor contract vs the JAX XLA SHOT (matmul-identity
    distances): valid equal, cosine > 0.999, < 1e-4 entries off > 1e-3."""
    pts, mask, nrm, kp, _, fr, fv = bench_clouds
    jr = jax.vmap(lambda *a: j_shot_dense(*a, 0.6))(
        jnp.asarray(kp), jnp.asarray(fr), jnp.asarray(fv), jnp.asarray(pts),
        jnp.asarray(nrm), jnp.asarray(mask))
    tr = t_shot_dense(t(kp), t(fr), t(fv), t(pts), t(nrm), t(mask), 0.6)
    assert_descriptors_close(tr.descriptors, tr.valid, jr.descriptors,
                             jr.valid)


def test_shot_compact_matches_pallas_interpret(bench_clouds, pallas_refs):
    """Tile-compacted SHOT vs the Pallas compact kernel: the same flat
    layout row for row (cloud ids, keypoints, frames), descriptors under
    the descriptor contract, and no rows past the batch's tiles."""
    pts, mask, nrm, kp, kmask, fr, fv = bench_clouds
    tiles = int(np.ceil(kmask.sum(1) / tshot.TK).sum())
    jd, jv, jk, jf, jc, jx = (pallas_refs["c" + k] for k in "dvkfcx")
    assert bool(jx)
    rows = tiles * tshot.TK
    td, tv, tkf, tff, tc = tshot.shot_descriptor_fused_compact(
        t(kp), t(fr), t(fv), t(kmask), t(pts), t(nrm), t(mask), 0.6)
    assert td.shape == (rows, 352)
    np.testing.assert_array_equal(n(tc), n(jc)[:rows])
    assert not n(jv)[rows:].any()
    assert_descriptors_close(td, tv, n(jd)[:rows], n(jv)[:rows])
    np.testing.assert_allclose(n(tkf), n(jk)[:rows], atol=1e-6)
    np.testing.assert_allclose(n(tff), n(jf)[:rows], atol=1e-6)


def test_compact_layout_handles_uneven_and_empty_clouds():
    kmask = np.zeros((3, 24), bool)
    kmask[0, :17] = True       # 3 tiles, 7 dead rows in the last
    kmask[2, :8] = True        # cloud 1 empty: no tiles
    gidx, alive, tile_cloud = tshot.compact_layout(t(kmask))
    assert n(tile_cloud).tolist() == [0, 0, 0, 2]
    assert n(alive).sum() == 25
    assert n(gidx)[:17].tolist() == list(range(17))
    assert n(gidx)[24:32].tolist() == list(range(48, 56))


# --- K4: chisq --------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_chisq_topk_matches_pallas_interpret(k, pallas_refs):
    """Chi-square contract vs the Pallas distance matrix + lax.top_k:
    distances rtol 1e-5, indices equal except at ties."""
    a, b, bmask = _chisq_case()
    d = jnp.asarray(pallas_refs["chisq"])
    d = jnp.where(jnp.asarray(bmask)[None, :], d, jnp.inf)
    neg, ji = jax.lax.top_k(-d, k)
    td, ti = tchisq.chisq_topk(t(a), t(b), t(bmask), k)
    assert_topk_close(td, ti, -neg, ji)


# --- wrapper contracts ------------------------------------------------------

def _k1_args():
    q = torch.zeros(1, 4, 3)
    p = torch.zeros(1, 8, 3)
    return q, p, torch.ones(1, 8, dtype=torch.bool)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device"])
def test_wrappers_check_inputs(case):
    """Wrong dtype, shape or layout raises; a device other than cpu/cuda
    raises instead of falling back to the plain twin."""
    q, p, m = _k1_args()
    if case == "dtype":
        q = q.double()
    elif case == "shape":
        p = torch.zeros(1, 8, 4)
    elif case == "contiguity":
        q = torch.zeros(1, 3, 4).transpose(1, 2)
    else:
        q, p, m = q.to("meta"), p.to("meta"), m.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tlrfm.moments(q, p, m, 0.5)


def test_chisq_topk_rejects_k_above_three():
    a, b = torch.rand(4, 8), torch.rand(6, 8)
    with pytest.raises(ValueError):
        tchisq.chisq_topk(a, b, torch.ones(6, dtype=bool), 4)


def test_cpu_tensors_launch_no_kernel(cloud):
    """CPU inputs run the plain twins: no launch is counted."""
    p, m = cloud
    build.reset_launch_counts()
    t_shot_lrf(t(p), t(m), t(p), t(m), 0.3)
    assert build.launch_counts() == {name: 0 for name in build.KERNELS}


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
