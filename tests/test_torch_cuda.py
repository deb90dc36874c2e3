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
from torch_parity import (assert_decisions_match, assert_topk_close,
                          cuda_device, n, t)  # noqa: F401

from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                          IsmDetector,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import binned
from point_cloud_donkey_tpu_torch.ops.kernels import chisq as tchisq
from point_cloud_donkey_tpu_torch.ops.kernels import histogram as thist
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm
from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as tshot
from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as tsh
from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast
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
    counts equal, raw histograms within f32 summation order (atomics)."""
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
    densities of the first 32 bench clouds; K7 was launched."""
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
    assert build.launch_counts()["shot_dense"] == 1
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


@pytest.mark.parametrize("n_bin", [11, 31])
def test_shot_hist_matches_plain(cuda_device, n_bin):
    """K8 vs its twin on random slot arrays with ~20% live columns and
    some out-of-range indices: both add each row's slots in (column,
    slot) order, so the kernel equals the CPU twin bit for bit."""
    g = torch.Generator().manual_seed(n_bin)
    r, m = 300, 2048
    ints = [torch.randint(-1, hi + 1, (r, m), generator=g, dtype=torch.int32)
            for hi in (32, n_bin, n_bin, 32, 32, 32)]
    ws = [torch.rand(r, m, generator=g)
          * (torch.rand(r, m, generator=g) < 0.2) for _ in range(5)]
    d, st, cb, rv, iv, av = ints
    cw, cosw, rw, iw, aw = ws
    args = [d, st, cw, cb, cosw, rv, rw, iv, iw, av, aw]
    h = tsh.shot_hist(*(a.to(cuda_device) for a in args), n_bin)
    assert torch.equal(h.cpu(), tsh.shot_hist_plain(*args, n_bin))


def test_histogram_matches_plain(cuda_device):
    """K9 vs its twin: bit-equal to the CPU twin (column order)."""
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(-2, 34, (300, 8192), generator=g, dtype=torch.int32)
    w = torch.rand(300, 8192, generator=g) \
        * (torch.rand(300, 8192, generator=g) < 0.1)
    h = thist.histogram(idx.to(cuda_device), w.to(cuda_device), 32)
    assert torch.equal(h.cpu(), thist.histogram_plain(idx, w, 32))


@pytest.mark.parametrize("descriptor,kernel", [("CSHOT", "shot_hist"),
                                               ("SHORT_SHOT", "histogram")])
def test_descriptor_slices_match_jax_reference(cuda_device, descriptor,
                                               kernel):
    """The CSHOT / SHORT_SHOT classify step on the card vs the committed
    JAX-CPU scores of the 16 reference clouds; K8 (twice) / K9 (once)
    launched; two runs equal."""
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
    assert counts[kernel] == (2 if descriptor == "CSHOT" else 1), counts
    assert_decisions_match(scores, dref["scores_" + descriptor.lower()])
    assert torch.equal(scores, again)


@pytest.mark.parametrize("weighting", ["shot", "uniform"])
def test_moments_v2_and_sign_votes_v2_match_plain(cuda_device, clouds,
                                                  weighting):
    """K10 vs its twin: weight sums rtol 2e-4, counts +-1, covariance
    atol 5e-4 (the tensor cores accumulate in their own order); K11 vs its
    twin: counts +-1 (the same float operations: in practice equal), at a
    small shape with a masked tail and a ragged last chunk (N = 1500)."""
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
    assert (v - tlrfm.sign_votes_v2_plain(q, p, mask, axes, 0.4)).abs() \
        .max() <= 1


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
