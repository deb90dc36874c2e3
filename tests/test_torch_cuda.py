"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no jax (the machine with the card has none), so it runs there on
its own, without tests/conftest.py:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

import shapes
from bench_data import KEYPOINT_CAPACITY, bench_clouds, bench_colors
from redesign_cases import (K1_CASES, K1_RADIUS, K2_CASES, K3_CASES,
                            K3_RADIUS, K4_DIMS, K5_CASES, K7_CASES,
                            K7_RADIUS, K8_CASES, K8_LAB_CASES, K8_RADIUS,
                            K9_CASES, K9_RADIUS, k1_case, k2_case, k3_case,
                            k4_case, k5_case, k5_windows_exact, k6_case,
                            k7_case, k8_case, k9_bins, k9_case)
from torch_parity import (assert_decisions_match, assert_descriptors_close,
                          assert_topk_close, cuda_device, n, t)  # noqa: F401

from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                          IsmDetector,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import binned
from point_cloud_donkey_tpu_torch.ops import short_shot as tss
from point_cloud_donkey_tpu_torch.ops.color import rgb_to_cielab_normalized
from point_cloud_donkey_tpu_torch.ops.kernels import chisq as tchisq
from point_cloud_donkey_tpu_torch.ops.kernels import histogram as thist
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm
from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as tshot
from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as tsh
from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast
from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "point_cloud_donkey_tpu_torch", "data", "")


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(11)
    pts = np.stack([shapes.make_instance(rng, i % 5, n=2048, rotate=True)
                    for i in range(4)])
    return t(pts), torch.ones(pts.shape[:2], dtype=torch.bool)


def test_moments_and_sign_votes_match_plain(cuda_device, clouds):
    """K1: moments rtol 2e-4, counts +-1; K2: counts +-1 (the radius gate
    is the same float computation, so in practice they are equal)."""
    pts, mask = (x.to(cuda_device) for x in clouds)
    q, p = tlrfm.prep_shift(pts, pts, mask)
    mom, cnt = tlrfm.moments(q, p, mask, 0.25)
    pmom, pcnt = tlrfm.moments_plain(q, p, mask, 0.25)
    torch.testing.assert_close(mom, pmom, rtol=2e-4, atol=1e-5)
    assert (cnt - pcnt).abs().max() <= 1
    axes = torch.nn.functional.normalize(
        torch.randn(*q.shape[:2], 6, device=cuda_device), dim=-1)
    for z_only in (False, True):
        v = tlrfm.sign_votes(q, p, mask, axes, 0.25, z_only)
        pv = tlrfm.sign_votes_plain(q, p, mask, axes, 0.25, z_only)
        assert (v - pv).abs().max() <= 1


def test_shot_tiles_match_plain(cuda_device, clouds):
    """K3 vs its twin on compacted bench keypoints: counts equal, raw
    histograms within f32 summation order (atomics)."""
    pts, mask = (x.to(cuda_device) for x in clouds)
    nrm = compute_normals_fast(pts, mask, 0.25)
    kres = voxel_grid(pts, mask, 0.35, capacity=KEYPOINT_CAPACITY)
    lrf = shot_lrf(kres.centroids, kres.mask, pts, mask, 0.5)
    gidx, alive, tile_cloud = tshot.compact_layout(kres.mask)
    kp = torch.where(alive[:, None], kres.centroids.reshape(-1, 3)[gidx],
                     torch.full((1, 3), 1e9, device=cuda_device))
    fr = lrf.frames.reshape(-1, 3, 3)[gidx].contiguous()
    h, c = tshot.shot_tiles(kp, fr, tile_cloud, pts, nrm, mask, 0.6)
    ph, pc = tshot.shot_tiles_plain(kp, fr, tile_cloud, pts, nrm, mask, 0.6)
    assert torch.equal(c, pc)
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-4)


def test_windowed_moments_and_sign_votes_match_plain(cuda_device, clouds):
    """K5 / K6 on sorted clouds at their calibrated window: the K1 / K2
    contracts against their twins (which run the same windows)."""
    pts, mask = (x.to(cuda_device) for x in clouds)
    s = binned.sort_clouds_ex(pts, mask)
    win = binned.required_window(pts, mask, 0.25)
    assert win < pts.shape[1]
    plan = binned.window_starts(s.keys, s.mask, s.keys, 0.25, win)
    assert bool(plan.exact)
    q, p = tlrfm.prep_shift(s.points, s.points, s.mask)
    mom, cnt = tlrfm.moments_windowed(q, p, s.mask, plan.starts, win, 0.25)
    pmom, pcnt = tlrfm.moments_windowed_plain(q, p, s.mask, plan.starts, win,
                                              0.25)
    torch.testing.assert_close(mom, pmom, rtol=2e-4, atol=1e-5)
    assert (cnt - pcnt).abs().max() <= 1
    axes = torch.nn.functional.normalize(
        torch.randn(*q.shape[:2], 6, device=cuda_device), dim=-1)
    for z_only in (False, True):
        v = tlrfm.sign_votes_windowed(q, p, s.mask, axes, plan.starts, win,
                                      0.25, z_only)
        pv = tlrfm.sign_votes_windowed_plain(q, p, s.mask, axes, plan.starts,
                                             win, 0.25, z_only)
        assert (v - pv).abs().max() <= 1


def test_shot_dense_matches_plain(cuda_device, clouds):
    """K7 vs its twin on the dense keypoint grid, some rows not live:
    counts equal, raw histograms within f32 summation order (the kernel
    sums in lane order, the twin by index_add_)."""
    pts, mask = (x.to(cuda_device) for x in clouds)
    nrm = compute_normals_fast(pts, mask, 0.25)
    kres = voxel_grid(pts, mask, 0.35, capacity=KEYPOINT_CAPACITY)
    lrf = shot_lrf(kres.centroids, kres.mask, pts, mask, 0.5)
    live = lrf.valid.clone()
    live[:, ::7] = False
    args = (kres.centroids.contiguous(), lrf.frames.contiguous(), live, pts,
            nrm, mask, 0.6)
    h, c = tshot.shot_dense(*args)
    ph, pc = tshot.shot_dense_plain(*args)
    assert torch.equal(c, pc)
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-4)


def test_detector_matches_jax_reference(cuda_device):
    """IsmDetector on the card vs the committed JAX-CPU detect_maxima_jit
    densities of the first 32 bench clouds; K7 was launched once a step,
    and two steps give equal densities and positions bit for bit."""
    ref = np.load(DATA + "bench_reference.npz")
    config = IsmConfig.load(DATA + "bench_codebook.ism")
    cb = load_codebook(DATA + "bench_codebook.ism").to(cuda_device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY)
    model = IsmDetector(cb, cfg,
                        CodebookParams.from_config(config.child("Codebook")))
    _, _, pts, labels = bench_clouds(len(ref["detect_densities"]))
    pts = t(pts).to(cuda_device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=cuda_device)
    build.reset_launch_counts()
    with torch.no_grad():
        dens, pos = model(pts, mask)
        again = model(pts, mask)
    assert build.launch_counts()["shot_dense"] == 2
    assert _same_bits(dens, again[0]) and _same_bits(pos, again[1])
    assert_decisions_match(dens, ref["detect_densities"])
    assert (n(dens).argmax(1) == labels).all()


@pytest.mark.parametrize("k", [1, 3])
def test_chisq_topk_matches_plain(cuda_device, k):
    g = torch.Generator().manual_seed(9)
    a = torch.rand(300, 352, generator=g)
    a[torch.rand(a.shape, generator=g) < 0.6] = 0.0
    b = torch.rand(458, 352, generator=g)
    b[torch.rand(b.shape, generator=g) < 0.6] = 0.0
    b[7] = b[3]                                  # an exact tie
    bmask = torch.rand(458, generator=g) > 0.05
    a, b, bmask = a.to(cuda_device), b.to(cuda_device), bmask.to(cuda_device)
    d, i = tchisq.chisq_topk(a, b, bmask, k)
    pd, pi = tchisq.chisq_topk_plain(a, b, bmask, k)
    assert_topk_close(d, i, pd, pi)


@pytest.mark.parametrize("case", K1_CASES + ("beyond_smem",))
def test_moments_edge_cases_match_plain(cuda_device, case):
    """K1 (the cell-binned sweep) vs its twin at tests/redesign_cases.py's
    edge cases, and at N = 20000 (points binned and swept in chunks):
    weight sums rtol 2e-4, counts +-1, covariance atol 5e-4 on the valid
    queries, exactly 0 on the invalid ones; two launches equal bit for
    bit."""
    arrays = (k1_case("ragged_n", n_points=20000) if case == "beyond_smem"
              else k1_case(case))
    q, q_mask, p, mask = (t(x).to(cuda_device) for x in arrays)
    mom, cnt = tlrfm.moments(q, p, mask, K1_RADIUS)
    again = tlrfm.moments(q, p, mask, K1_RADIUS)
    assert torch.equal(mom, again[0]) and torch.equal(cnt, again[1])
    pmom, pcnt = tlrfm.moments_plain(q, p, mask, K1_RADIUS)
    _assert_moments_close(mom, cnt, pmom, pcnt, q, q_mask)


def _assert_moments_close(mom, cnt, pmom, pcnt, q, q_mask):
    """The moments contract on the valid queries: weight sums rtol 2e-4,
    counts +-1, covariance atol 5e-4; exactly 0 on the invalid ones."""
    assert torch.isfinite(mom).all()
    assert not cnt[~q_mask].any() and not mom[~q_mask].any()
    torch.testing.assert_close(mom[q_mask][:, 0], pmom[q_mask][:, 0],
                               rtol=2e-4, atol=1e-6)
    assert (cnt - pcnt).abs().max() <= 1
    cov, _ = tlrfm.cov_from_moments(mom, q, q_mask)
    pcov, _ = tlrfm.cov_from_moments(pmom, q, q_mask)
    assert ((cov - pcov)[q_mask].abs() <= 5e-4).all()


@pytest.mark.parametrize("weighting", ["shot", "uniform"])
@pytest.mark.parametrize("case", K1_CASES + ("beyond_smem",))
def test_moments_v2_edge_cases_match_plain(cuda_device, case, weighting):
    """K10 (K1's cell-binned sweep with the identity gate and the bf16x3
    body) vs its twin at tests/redesign_cases.py's K1 edge cases -- among
    them the grid's cap trip (`wide_extent`, where the identity's rounding
    widens the cells) -- and at N = 20000 (points binned and swept in
    chunks), with either weighting: the moments contract on the valid
    queries, exactly 0 on the invalid ones, uniform weight sums equal to
    the counts; two launches equal bit for bit."""
    arrays = (k1_case("ragged_n", n_points=20000) if case == "beyond_smem"
              else k1_case(case))
    q, q_mask, p, mask = (t(x).to(cuda_device) for x in arrays)
    mom, cnt = tlrfm.moments_v2(q, p, mask, K1_RADIUS, weighting)
    again = tlrfm.moments_v2(q, p, mask, K1_RADIUS, weighting)
    assert torch.equal(mom, again[0]) and torch.equal(cnt, again[1])
    pmom, pcnt = tlrfm.moments_v2_plain(q, p, mask, K1_RADIUS, weighting)
    if weighting == "uniform":
        assert torch.equal(mom[..., 0], cnt.to(mom.dtype))
    _assert_moments_close(mom, cnt, pmom, pcnt, q, q_mask)


@pytest.mark.parametrize("case", K5_CASES + ("beyond_one_chunk",))
def test_windowed_moments_edge_cases_match_plain(cuda_device, case):
    """K5 (K1's cell-binned sweep over the union of a CTA's windows, each
    query kept to its own tile's window) vs its twin at
    tests/redesign_cases.py's K5 cases, and with W = 2560 over N = 6000
    (a CTA's windows binned and swept in chunks): the moments contract on
    the valid queries, exactly 0 on the masked ones; two launches equal bit
    for bit; on an exact plan, K1 over the whole cloud within the same
    contract."""
    pts, mask, starts, window = (
        k5_case("query_tail", n_points=6000, window=2560)
        if case == "beyond_one_chunk" else k5_case(case))
    p, m, s = (t(x).to(cuda_device) for x in (pts, mask, starts))
    mom, cnt = tlrfm.moments_windowed(p, p, m, s, window, K1_RADIUS)
    again = tlrfm.moments_windowed(p, p, m, s, window, K1_RADIUS)
    assert torch.equal(mom, again[0]) and torch.equal(cnt, again[1])
    pmom, pcnt = tlrfm.moments_windowed_plain(p, p, m, s, window, K1_RADIUS)
    _assert_moments_close(mom, cnt, pmom, pcnt, p, m)
    assert cnt[m].max() > 1
    if case != "beyond_one_chunk" and k5_windows_exact(pts, mask, starts,
                                                       window):
        k1, k1_cnt = tlrfm.moments(p, p, m, K1_RADIUS)
        _assert_moments_close(mom, cnt, k1, k1_cnt, p, m)


@pytest.mark.parametrize("z_only", [False, True])
@pytest.mark.parametrize("case", K2_CASES)
def test_sign_votes_edge_cases_match_plain(cuda_device, case, z_only):
    """K2 (the cell-binned sweep) vs its twin at tests/redesign_cases.py's
    edge cases -- K1's, points at exactly r and offsets orthogonal to an
    axis, N = 2500 (binned in chunks): votes +-1 on the valid queries,
    exactly 0 on the invalid ones and in x when z_only; two launches equal
    bit for bit."""
    q, q_mask, p, mask, axes = (t(x).to(cuda_device) for x in k2_case(case))
    v = tlrfm.sign_votes(q, p, mask, axes, K1_RADIUS, z_only)
    assert torch.equal(v, tlrfm.sign_votes(q, p, mask, axes, K1_RADIUS,
                                           z_only))
    pv = tlrfm.sign_votes_plain(q, p, mask, axes, K1_RADIUS, z_only)
    assert not v[~q_mask].any()
    if z_only:
        assert not v[..., 0].any()
    assert (v - pv).abs().max() <= 1


@pytest.mark.parametrize("case", K2_CASES)
def test_sign_votes_v2_edge_cases_match_plain(cuda_device, case):
    """K11 (K2's body on the cell-binned sweep under K10's identity gate)
    vs its twin at tests/redesign_cases.py's K2 edge cases -- among them
    the grid's cap trip (`wide_extent`, where the identity's rounding
    widens the cells, so a pair the sweep missed would change a count),
    masked NaN / +-1e30 / +-inf points, points at exactly r and N = 2500
    (binned in chunks): votes equal (the gate and both dots are the twin's
    float operations on the same coordinates, and the sums are integers),
    exactly 0 on the invalid queries; two launches equal bit for bit."""
    q, q_mask, p, mask, axes = (t(x).to(cuda_device) for x in k2_case(case))
    v = tlrfm.sign_votes_v2(q, p, mask, axes, K1_RADIUS)
    assert torch.equal(v, tlrfm.sign_votes_v2(q, p, mask, axes, K1_RADIUS))
    assert torch.equal(v, tlrfm.sign_votes_v2_plain(q, p, mask, axes,
                                                    K1_RADIUS))
    assert not v[~q_mask].any()


@pytest.mark.parametrize("z_only", [False, True])
@pytest.mark.parametrize("case", K5_CASES)
def test_windowed_sign_votes_edge_cases_match_plain(cuda_device, case,
                                                    z_only):
    """K6 (K2's body on K5's binned sweep of the windows) vs its twin at
    tests/redesign_cases.py's K5 cases: votes equal (the gate and the dot
    products are the twin's float operations on p - q, negated exactly),
    0 on the masked queries and in x when z_only; two launches equal bit
    for bit; on an exact plan, equal to K2 over the whole cloud."""
    pts, mask, starts, window, axes = k6_case(case)
    p, m, s, ax = (t(x).to(cuda_device) for x in (pts, mask, starts, axes))
    v = tlrfm.sign_votes_windowed(p, p, m, ax, s, window, K1_RADIUS, z_only)
    assert torch.equal(v, tlrfm.sign_votes_windowed(p, p, m, ax, s, window,
                                                    K1_RADIUS, z_only))
    pv = tlrfm.sign_votes_windowed_plain(p, p, m, ax, s, window, K1_RADIUS,
                                         z_only)
    assert torch.equal(v, pv)
    assert not v[~m].any() and v[m].max() > 1
    if z_only:
        assert not v[..., 0].any()
    if k5_windows_exact(pts, mask, starts, window):
        full = tlrfm.sign_votes(p, p, m, ax, K1_RADIUS, z_only)
        assert torch.equal(v[m], full[m])


def _k3_inputs(arrays, device, dead_tile=False):
    """The rows K3 gets from shot_descriptor_fused_compact for one case
    (plus a tile of 1e9 keypoints when dead_tile): (shot_tiles arguments,
    frame validity of the rows)."""
    kp, frames, fv, kp_mask, pts, nrm, mask = (t(x).to(device)
                                               for x in arrays)
    gidx, alive, tile_cloud = tshot.compact_layout(kp_mask)
    kp_rows = torch.where(alive[:, None], kp.reshape(-1, 3)[gidx],
                          torch.full((1, 3), 1e9, device=device))
    fr_rows = frames.reshape(-1, 3, 3)[gidx]
    fv_rows = fv.reshape(-1)[gidx] & alive
    if dead_tile:
        kp_rows = torch.cat([kp_rows, torch.full((tshot.TK, 3), 1e9,
                                                 device=device)])
        fr_rows = torch.cat([fr_rows, fr_rows[:tshot.TK]])
        fv_rows = torch.cat([fv_rows, fv_rows[:tshot.TK] & False])
        tile_cloud = torch.cat([tile_cloud, tile_cloud[:1]])
    return (kp_rows.contiguous(), fr_rows.contiguous(), tile_cloud, pts,
            nrm, mask, K3_RADIUS), fv_rows


@pytest.mark.parametrize("case", K3_CASES + ("beyond_one_chunk",
                                             "dead_tile"))
def test_shot_tiles_edge_cases_match_plain(cuda_device, case):
    """K3 (compacted in-radius pairs, warp-owned histograms) vs its twin at
    tests/redesign_cases.py's edge cases, at N = 2500 (three staged chunks)
    and with a tile of dead rows: counts equal, validity equal, descriptor
    cosine > 0.999 with fewer than 1e-4 of the entries off by more than
    1e-3; dead rows zero; two launches equal bit for bit."""
    arrays = (k3_case("nan_normals", n=2500) if case == "beyond_one_chunk"
              else k3_case("masked_garbage" if case == "dead_tile" else case))
    args, fv_rows = _k3_inputs(arrays, cuda_device, case == "dead_tile")
    h, c = tshot.shot_tiles(*args)
    h2, c2 = tshot.shot_tiles(*args)
    assert torch.equal(h, h2) and torch.equal(c, c2)
    ph, pc = tshot.shot_tiles_plain(*args)
    assert torch.equal(c, pc)
    dead = args[0][:, 0] == 1e9
    assert not h[dead].any() and not c[dead].any()
    got = normalize_descriptors(h, c, fv_rows)
    want = normalize_descriptors(ph, pc, fv_rows)
    assert_descriptors_close(got.descriptors, got.valid, want.descriptors,
                             want.valid)


def _k7_inputs(case, device, all_live=False):
    """shot_dense's arguments for a K7 case on `device`; with all_live,
    every row whose frame is finite -- the 1e9 pad rows too -- is
    described."""
    kp, fr, fv, pts, nrm, mask = (t(x) for x in k7_case(case))
    live = torch.isfinite(fr).all(-1).all(-1) if all_live else fv
    return tuple(x.contiguous().to(device) for x in (
        kp, fr, live, pts, nrm, mask)) + (K7_RADIUS,)


def _assert_k7_matches_plain(args, frame_valid):
    """K7 vs its twin on shot_dense's arguments: counts equal, rows that
    are not live zero, two launches equal bit for bit, and the descriptor
    contract (validity equal, cosine > 0.999, fewer than 1e-4 of the
    entries off by more than 1e-3) on the rows with a valid frame."""
    h, c = tshot.shot_dense(*args)
    h2, c2 = tshot.shot_dense(*args)
    assert _same_bits(h, h2) and torch.equal(c, c2)
    ph, pc = tshot.shot_dense_plain(*args)
    assert torch.equal(c, pc)
    live = args[2]
    assert not h[~live].any() and not c[~live].any()
    got = normalize_descriptors(h, c, frame_valid)
    want = normalize_descriptors(ph, pc, frame_valid)
    assert_descriptors_close(got.descriptors.reshape(-1, 352),
                             got.valid.reshape(-1),
                             want.descriptors.reshape(-1, 352),
                             want.valid.reshape(-1))
    return c


@pytest.mark.parametrize("all_live", [False, True])
@pytest.mark.parametrize("case", K7_CASES)
def test_shot_dense_edge_cases_match_plain(cuda_device, case, all_live):
    """K7 (K3's warp-owned histograms on the dense [B, K] grid) vs its twin
    at tests/redesign_cases.py's K7 cases -- dead rows and all-dead tiles,
    masked garbage, exact self pairs and on-radius pairs, invalid frames,
    an empty cloud, N = 2500 and 1100, NaN and +-inf normals, real
    keypoints that are not live between live tiles, K = 22 -- with the
    rows of a valid frame live and with every row of a finite frame live
    (the 1e9 rows meet no point): counts equal, the descriptor contract,
    rows that are not live zero, two launches equal bit for bit."""
    args = _k7_inputs(case, cuda_device, all_live)
    fv = t(k7_case(case)[2]).to(cuda_device)
    c = _assert_k7_matches_plain(args, fv)
    dead = args[0][..., 0] == 1e9
    assert not c[dead].any()


@pytest.mark.parametrize("b", [1, 8])
def test_shot_dense_small_batches_match_plain(cuda_device, b):
    """K7 at one cloud and at 8 (24 and 192 CTAs, where the grid fills a
    fraction of the card's SMs) on bench-geometry clouds: the twin's
    counts, the descriptor contract, two launches bit-equal."""
    rng = np.random.default_rng(23 + b)
    pts = t(np.stack([shapes.make_instance(rng, i % 5, n=2048, rotate=True)
                      for i in range(b)]).astype(np.float32)).to(cuda_device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=cuda_device)
    nrm = compute_normals_fast(pts, mask, 0.25)
    kres = voxel_grid(pts, mask, 0.35, capacity=KEYPOINT_CAPACITY)
    kp = torch.where(kres.mask[..., None], kres.centroids,
                     torch.full_like(kres.centroids, 1e9))
    lrf = shot_lrf(kp, kres.mask, pts, mask, 0.5)
    args = (kp.contiguous(), lrf.frames.contiguous(), lrf.valid, pts, nrm,
            mask, 0.6)
    _assert_k7_matches_plain(args, lrf.valid)


def test_sign_votes_and_shot_tiles_repeat_bit_for_bit(cuda_device, clouds):
    """K2 at the normals (Q = N = 2048, z only and full, as serving and
    training call it) and at the keypoint LRFs, K6 over the calibrated
    windows of the sorted clouds, K3 on compacted keypoints and K7 on the
    dense keypoint grid: two launches equal bit for bit and agree with the
    twins."""
    pts, mask = (x.to(cuda_device) for x in clouds)
    kres = voxel_grid(pts, mask, 0.35, capacity=KEYPOINT_CAPACITY)
    kp = torch.where(kres.mask[..., None], kres.centroids,
                     torch.full_like(kres.centroids, 1e9))
    for queries, radius in ((pts, 0.25), (kp, 0.5)):
        q, p = tlrfm.prep_shift(queries, pts, mask)
        axes = torch.nn.functional.normalize(
            torch.randn(*q.shape[:2], 6, device=cuda_device), dim=-1)
        for z_only in (False, True):
            v = tlrfm.sign_votes(q, p, mask, axes, radius, z_only)
            assert torch.equal(v, tlrfm.sign_votes(q, p, mask, axes, radius,
                                                   z_only))
            pv = tlrfm.sign_votes_plain(q, p, mask, axes, radius, z_only)
            assert (v - pv).abs().max() <= 1
    nrm = compute_normals_fast(pts, mask, 0.25)
    lrf = shot_lrf(kp, kres.mask, pts, mask, 0.5)
    gidx, alive, tile_cloud = tshot.compact_layout(kres.mask)
    kp_rows = torch.where(alive[:, None], kp.reshape(-1, 3)[gidx],
                          torch.full((1, 3), 1e9, device=cuda_device))
    args = (kp_rows.contiguous(), lrf.frames.reshape(-1, 3, 3)[gidx]
            .contiguous(), tile_cloud, pts, nrm, mask, 0.6)
    h, c = tshot.shot_tiles(*args)
    h2, c2 = tshot.shot_tiles(*args)
    assert torch.equal(h, h2) and torch.equal(c, c2)
    assert torch.equal(c, tshot.shot_tiles_plain(*args)[1])
    dense = (kp.contiguous(), lrf.frames.contiguous(), lrf.valid, pts, nrm,
             mask, 0.6)
    h, c = tshot.shot_dense(*dense)
    h2, c2 = tshot.shot_dense(*dense)
    assert _same_bits(h, h2) and torch.equal(c, c2)
    assert torch.equal(c, tshot.shot_dense_plain(*dense)[1])
    s = binned.sort_clouds_ex(pts, mask)
    win = binned.required_window(pts, mask, 0.25)
    plan = binned.window_starts(s.keys, s.mask, s.keys, 0.25, win)
    q, p = tlrfm.prep_shift(s.points, s.points, s.mask)
    axes = torch.nn.functional.normalize(
        torch.randn(*q.shape[:2], 6, device=cuda_device), dim=-1)
    for z_only in (False, True):
        v = tlrfm.sign_votes_windowed(q, p, s.mask, axes, plan.starts, win,
                                      0.25, z_only)
        assert torch.equal(v, tlrfm.sign_votes_windowed(
            q, p, s.mask, axes, plan.starts, win, 0.25, z_only))
        assert torch.equal(v, tlrfm.sign_votes_windowed_plain(
            q, p, s.mask, axes, plan.starts, win, 0.25, z_only))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dim", K4_DIMS)
def test_chisq_edge_cases_match_plain(cuda_device, dim, k, signed):
    """K4 vs its twin at tests/redesign_cases.py's edge cases: distances
    rtol 1e-5, indices equal except at ties, the duplicated codeword's tie
    to the lower index, the all-zero pair at 0; two launches equal; with
    signed, tiny and huge values too (terms with a + b <= 0 count 0)."""
    a, b, b_mask = (t(x).to(cuda_device)
                    for x in k4_case(dim, signed=signed))
    d, i = tchisq.chisq_topk(a, b, b_mask, k)
    d2, i2 = tchisq.chisq_topk(a, b, b_mask, k)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    pd, pi = tchisq.chisq_topk_plain(a, b, b_mask, k)
    assert_topk_close(d, i, pd, pi)
    assert int(i[9, 0]) == 3 and float(d[9, 0]) == 0.0
    if k >= 2:
        assert int(i[9, 1]) == 7
    assert int(i[5, 0]) == 11 and float(d[5, 0]) == 0.0


@pytest.mark.parametrize("q,c,dim", [(12000, 458, 352), (6000, 200, 35),
                                     (2000, 2000, 352), (300, 458, 1344),
                                     (0, 458, 352)])
def test_chisq_grid_shapes_match_plain(cuda_device, q, c, dim):
    """K4 at the shapes that pick each codeword-group count (serving:
    one group; mid-size: two; the training self-kNN and CSHOT's D = 1344
    at few descriptors: four) and at Q = 0, against its twin."""
    a, b, b_mask = (t(x).to(cuda_device)
                    for x in k4_case(dim, q=max(q, 12), c=c, seed=3))
    a = a[:q].contiguous()
    d, i = tchisq.chisq_topk(a, b, b_mask, 3)
    assert d.shape == (q, 3) and i.shape == (q, 3)
    pd, pi = tchisq.chisq_topk_plain(a, b, b_mask, 3)
    assert_topk_close(d, i, pd, pi)


def test_slice_matches_jax_reference(cuda_device):
    """IsmClassifier on the card vs the committed JAX-CPU scores; every
    kernel was launched."""
    ref = np.load(DATA + "bench_reference.npz")
    config = IsmConfig.load(DATA + "bench_codebook.ism")
    cb = load_codebook(DATA + "bench_codebook.ism").to(cuda_device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY)
    model = IsmClassifier(cb, cfg,
                          CodebookParams.from_config(config.child("Codebook")))
    pts = t(ref["points"]).to(cuda_device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=cuda_device)
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(pts, mask)
        again = model(pts, mask)
    counts = build.launch_counts()
    assert all(counts[k] for k in ("lrf_moments", "sign_votes",
                                   "shot_fused", "chisq_topk")), counts
    assert_decisions_match(scores, ref["scores"])
    assert (n(scores).argmax(1) == ref["labels"]).all()
    # deterministic sums (voxel grid, scores): two runs agree bit for bit
    assert torch.equal(scores, again)


def test_windowed_slice_matches_jax_reference(cuda_device):
    """IsmClassifier with the committed calibrated window vs the committed
    JAX-CPU windowed scores; K5 and K6 were launched, nothing recomputed."""
    ref = np.load(DATA + "bench_reference.npz")
    config = IsmConfig.load(DATA + "bench_codebook.ism")
    cb = load_codebook(DATA + "bench_codebook.ism").to(cuda_device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY,
                                  normals_window=int(ref["normals_window"]))
    model = IsmClassifier(cb, cfg,
                          CodebookParams.from_config(config.child("Codebook")))
    pts = t(ref["points"]).to(cuda_device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=cuda_device)
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(pts, mask)
    counts = build.launch_counts()
    assert counts["lrf_moments_windowed"] == counts["sign_votes_windowed"] \
        == 1, counts
    assert model.dense_recomputes == 0
    assert_decisions_match(scores, ref["scores_windowed"])
    assert (n(scores).argmax(1) == ref["labels"]).all()


def _same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _k8_inputs(case, device, all_live=False):
    """cshot_hist's arguments for a K8 case (Lab from the port's
    conversion, or the case's own Lab), on `device`; with all_live, every
    row -- the 1e9 pad rows too -- is described."""
    kp, kp_col, fr, fv, pts, nrm, col, mask = (t(x) for x in k8_case(case))
    if case not in K8_LAB_CASES:
        kp_col = rgb_to_cielab_normalized(kp_col)
        col = rgb_to_cielab_normalized(col)
    live = torch.ones_like(fv) if all_live else fv
    return tuple(x.contiguous().to(device) for x in (
        kp, kp_col, fr, live, pts, nrm, col, mask)) + (K8_RADIUS,)


@pytest.mark.parametrize("all_live", [False, True])
@pytest.mark.parametrize("case", K8_CASES)
def test_cshot_hist_edge_cases_match_plain(cuda_device, case, all_live):
    """K8 (the CSHOT pairs binned on chip) vs its CPU twin (slot arrays,
    then their histograms) at tests/redesign_cases.py's edge cases --
    dead rows and all-dead tiles, masked garbage, exact self pairs and
    on-radius pairs, invalid frames, an empty cloud, N = 2500, NaN and
    +-inf normals, colour distances on a bin edge and past 1 -- with the
    live rows as the descriptor gives them and with every row live (the
    1e9 rows meet no point): counts equal, validity equal, descriptor
    cosine > 0.999 with fewer than 1e-4 of the entries off by more than
    1e-3; rows that are not live zero; two launches equal bit for bit."""
    args = _k8_inputs(case, cuda_device, all_live)
    h, c = tsh.cshot_hist(*args)
    h2, c2 = tsh.cshot_hist(*args)
    assert _same_bits(h, h2) and torch.equal(c, c2)
    ph, pc = tsh.cshot_hist(*(a.cpu() if torch.is_tensor(a) else a
                              for a in args))
    assert torch.equal(c.cpu(), pc)
    live = args[3]
    assert not h[~live].any() and not c[~live].any()
    dead = args[0][..., 0] == 1e9
    assert not h[dead].any() and not c[dead].any()
    fv = t(k8_case(case)[3]).to(cuda_device)
    got = normalize_descriptors(h, c, fv)
    want = normalize_descriptors(ph, pc, fv.cpu())
    assert_descriptors_close(got.descriptors, got.valid, want.descriptors,
                             want.valid)


def _short_shot_unit(hist, frame_valid):
    """(descriptors, valid) of raw SHORT_SHOT histograms, as
    short_shot_descriptor_dense makes them."""
    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    desc = hist / norm.clamp(min=1e-30)
    return desc, (frame_valid & (norm[..., 0] > 0)
                  & torch.isfinite(desc).all(-1))


@pytest.mark.parametrize("all_live", [False, True])
@pytest.mark.parametrize("case", K9_CASES)
def test_short_shot_hist_edge_cases_match_plain(cuda_device, case,
                                                all_live):
    """K9 (the SHORT_SHOT pairs binned on chip, the histogram in
    registers) vs its CPU twin at tests/redesign_cases.py's edge cases --
    those of K8 without normals and colours, and theta = 90, phi = 180 and
    r = r/2 bin edges and a 2 x 4 x 8 grid: validity equal, descriptor
    cosine > 0.999 with fewer than 1e-4 of the entries off by more than
    1e-3 (every bin adds in the twin's (point, slot) order, so only
    acosf / atan2f can move a pair); rows that are not live zero; two
    launches equal bit for bit."""
    kp, fr, fv, pts, mask = (t(x) for x in k9_case(case))
    live = torch.ones_like(fv) if all_live else fv
    args = (kp, fr, live, pts, mask, K9_RADIUS) + k9_bins(case)
    dargs = tuple(a.to(cuda_device) if torch.is_tensor(a) else a
                  for a in args)
    h = thist.short_shot_hist(*dargs)
    assert _same_bits(h, thist.short_shot_hist(*dargs))
    ph = thist.short_shot_hist(*args)
    assert not h[~dargs[2]].any()
    assert not h[dargs[0][..., 0] == 1e9].any()
    assert_descriptors_close(*_short_shot_unit(h.cpu(), fv),
                             *_short_shot_unit(ph, fv))


@pytest.mark.parametrize("dims", sorted(tss.AUTO_BINS))
def test_short_shot_hist_every_auto_bin_size(cuda_device, dims):
    """K9 at every AUTO_BINS grid (1 to 8 registers a lane) vs its CPU
    twin on masked garbage: raw histograms within f32 rounding of the
    bins' edges (rtol 1e-5 on the row sums, each entry within 1e-3 of the
    row's largest)."""
    kp, fr, fv, pts, mask = (t(x) for x in k9_case("masked_garbage"))
    args = (kp, fr, fv, pts, mask, K9_RADIUS) + tss.AUTO_BINS[dims]
    h = thist.short_shot_hist(*(a.to(cuda_device) if torch.is_tensor(a)
                                else a for a in args)).cpu()
    ph = thist.short_shot_hist(*args)
    assert h.shape[-1] == dims
    torch.testing.assert_close(h.sum(-1), ph.sum(-1), rtol=1e-5, atol=1e-5)
    scale = ph.amax(-1, keepdim=True).clamp(min=1e-30)
    assert ((h - ph).abs() / scale).max() <= 1e-3


@pytest.mark.parametrize("descriptor", ["CSHOT", "SHORT_SHOT"])
def test_fused_k8_k9_at_serving_shapes(cuda_device, descriptor):
    """K8 / K9 at the serving step's shapes (16 bench clouds x 192
    keypoints x 2048 points, their voxel keypoints and keypoint LRFs, the
    bench colours) vs their twins on the card: counts equal, descriptor
    contract; two launches equal bit for bit."""
    ref = np.load(DATA + "bench_reference.npz")
    pts = t(ref["points"]).to(cuda_device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=cuda_device)
    rgb = t(bench_colors(ref["points"])).to(cuda_device)
    kres = voxel_grid(pts, mask, 0.35, capacity=KEYPOINT_CAPACITY,
                      features=rgb)
    kp = torch.where(kres.mask[..., None], kres.centroids[..., :3],
                     torch.full_like(kres.centroids[..., :3], 1e9))
    lrf = shot_lrf(kp, kres.mask, pts, mask, 0.5)
    if descriptor == "CSHOT":
        nrm = compute_normals_fast(pts, mask, 0.25)
        args = (kp.contiguous(),
                rgb_to_cielab_normalized(kres.centroids[..., 3:6]),
                lrf.frames, lrf.valid, pts, nrm,
                rgb_to_cielab_normalized(rgb), mask, 0.6)
        h, c = tsh.cshot_hist(*args)
        h2, c2 = tsh.cshot_hist(*args)
        ph, pc = tsh.cshot_hist_plain(*args)
        assert torch.equal(c, c2) and torch.equal(c, pc)
        got = normalize_descriptors(h, c, lrf.valid)
        want = normalize_descriptors(ph, pc, lrf.valid)
        got, want = (got.descriptors, got.valid), (want.descriptors,
                                                   want.valid)
    else:
        args = (kp.contiguous(), lrf.frames, lrf.valid, pts, mask, 0.6)
        h = thist.short_shot_hist(*args)
        h2 = thist.short_shot_hist(*args)
        ph = thist.short_shot_hist_plain(*args, 2, 2, 8)
        got = _short_shot_unit(h, lrf.valid)
        want = _short_shot_unit(ph, lrf.valid)
    assert torch.equal(h, h2)
    assert_descriptors_close(*got, *want)


@pytest.mark.parametrize("descriptor,kernel", [("CSHOT", "shot_hist"),
                                               ("SHORT_SHOT", "histogram")])
def test_descriptor_slices_match_jax_reference(cuda_device, descriptor,
                                               kernel):
    """The CSHOT / SHORT_SHOT classify step on the card vs the committed
    JAX-CPU scores of the 16 reference clouds; K8 / K9 launched once; two
    runs equal."""
    ref = np.load(DATA + "bench_reference.npz")
    dref = np.load(DATA + "descriptor_reference.npz")
    path = DATA + descriptor.lower() + "_codebook.ism"
    config = IsmConfig.load(path)
    cb = load_codebook(path).to(cuda_device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY)
    model = IsmClassifier(cb, cfg,
                          CodebookParams.from_config(config.child("Codebook")))
    pts = t(ref["points"]).to(cuda_device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=cuda_device)
    rgb = t(bench_colors(ref["points"])).to(cuda_device) \
        if descriptor == "CSHOT" else None
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(pts, mask, rgb)
        counts = build.launch_counts()
        again = model(pts, mask, rgb)
    assert counts[kernel] == 1, counts
    assert_decisions_match(scores, dref["scores_" + descriptor.lower()])
    assert torch.equal(scores, again)


@pytest.mark.parametrize("weighting", ["shot", "uniform"])
def test_moments_v2_and_sign_votes_v2_match_plain(cuda_device, clouds,
                                                  weighting):
    """K10 vs its twin: weight sums rtol 2e-4, counts +-1, covariance
    atol 5e-4 (the sweep sums pair by pair, the twin by matrix products);
    K11 vs its twin: votes equal (the same float operations, integer
    sums), at a small shape with a masked tail and a ragged last chunk
    (N = 1500)."""
    pts, mask = (x[:2, :1500].contiguous().to(cuda_device) for x in clouds)
    mask[1, 1400:] = False
    q, p = tlrfm.prep_shift(pts[:, :300].contiguous(), pts, mask)
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device=cuda_device)
    mom, cnt = tlrfm.moments_v2(q, p, mask, 0.4, weighting)
    pmom, pcnt = tlrfm.moments_v2_plain(q, p, mask, 0.4, weighting)
    torch.testing.assert_close(mom[..., 0], pmom[..., 0], rtol=2e-4,
                               atol=1e-5)
    assert (cnt - pcnt).abs().max() <= 1
    cov, _ = tlrfm.cov_from_moments(mom, q, qm)
    pcov, _ = tlrfm.cov_from_moments(pmom, q, qm)
    assert (cov - pcov).abs().max() <= 5e-4
    axes = torch.nn.functional.normalize(
        torch.randn(*q.shape[:2], 6, device=cuda_device), dim=-1)
    v = tlrfm.sign_votes_v2(q, p, mask, axes, 0.4)
    assert torch.equal(v, tlrfm.sign_votes_v2_plain(q, p, mask, axes, 0.4))


def test_training_on_the_card_matches_the_cpu_twins(cuda_device, tmp_path):
    """ImplicitShapeModel.train on the card (K1/K2, K7, K4) against the same
    training on the CPU (the plain twins): the same codeword count and vote
    classes, >= 97% of the codewords at cosine > 0.999; K7 and K4
    launched."""
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    from bench_data import BENCH_CONFIG
    rng = np.random.default_rng(11)
    files = []
    for i in range(6):
        path = str(tmp_path / f"m{i}.pcd")
        save_pcd(path, shapes.make_instance(rng, i % 3, n=1024, rotate=True,
                                            noise=0.005))
        files.append((path, i % 3))
    books = []
    for device in (cuda_device, "cpu"):
        ism = ImplicitShapeModel(IsmConfig.from_json(BENCH_CONFIG), device)
        for path, cid in files:
            ism.add_training_model(path, cid, cid)
        build.reset_launch_counts()
        ism.train()
        if device != "cpu":
            got = build.launch_counts()
            assert got["shot_dense"] and got["chisq_topk"], got
        books.append(ism.state.codebook)
    a, b = books
    assert a.codewords.shape == b.codewords.shape
    np.testing.assert_array_equal(a.vote_class, b.vote_class)
    cos = (a.codewords * b.codewords).sum(1) / np.maximum(
        np.linalg.norm(a.codewords, axis=1)
        * np.linalg.norm(b.codewords, axis=1), 1e-30)
    assert (cos > 0.999).mean() >= 0.97
