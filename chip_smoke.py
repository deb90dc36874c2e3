#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (point_cloud_donkey_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and agrees
with the JAX reference on the card.

    python3 chip_smoke.py        # from the repo root; needs a GPU and nvcc

Phases (each prints its results; any failure raises and exits nonzero):
  1. environment and the nvcc build of csrc/*.cu;
  2. each kernel against its plain PyTorch twin on the card, timed, at the
     shapes its main path gives it: K1-K4 at the dense classify step's on
     the 128-cloud bench batch, K5/K6 at the windowed step's (the sorted
     batch, window calibrated on it), K7 at the mean-shift step's (32
     clouds x 192 keypoints), and K7 with and without its point-chunk
     split at 1, 8 and 32 clouds;
  2c. K8 (n_bin 11 and 31) and K9 at the CSHOT and SHORT_SHOT steps'
     shapes (the slot arrays of the 128 bench clouds, coloured by
     tests/bench_data.bench_colors: 24576 rows x 2048 points, x 4 slots
     for K9) against their twins, timed with the twin and the one PyTorch
     call that computes the same function (scatter_add_);
  2d. K10 (and K11) at the v2 LRF passes' shapes -- the serving normals
     (Q=N=2048, K10 with K2 z-only), the training normals' full LRF
     (Q=N=2048, K11) and the keypoint LRFs (Q=192) -- against their twins
     and against K1 / K2, timed beside their twins and K1 / K2;
  3. LRF frames and SHOT descriptors against tests/golden/descriptors.npz;
  4. the dense classify step: IsmClassifier on the 128 x 2048 bench batch
     with the committed codebook -- per-stage ms, clouds/s, K1-K4 launched,
     decisions against the committed JAX-CPU reference, two runs equal;
  4b. the windowed classify step: the same with the calibrated normals
     window -- K5/K6 launched, no dense recompute, decisions against the
     committed JAX-CPU windowed reference; then a forced flag trip
     (window 128) recomputes densely: bit-equal to the dense step on the
     same sorted clouds, and the same decisions as on the unsorted ones;
  4c. the dense classify step with lrf_version 2: K10 / K11 launched, K1
     not, the same decisions;
  5. the serve entry point on 8 PCD files with --device cuda;
  6. the mean-shift detection step: IsmDetector on the first 32 bench
     clouds -- per-stage ms, clouds/s, K7 launched, densities (decisions,
     rms and max relative delta) and the best class's maximum against the
     committed JAX-CPU detect_maxima_jit reference; then
     serve --maxima --device cuda on 8 PCD files;
  5b. serve --device cuda with the CSHOT model on 8 coloured PCD files, and
     its --maxima refusal;
  7. the CSHOT classify step: IsmClassifier with the committed CSHOT
     codebook on the coloured 128-cloud batch -- per-stage ms, clouds/s, K8
     launched twice, decisions against the committed JAX-CPU reference,
     accuracy, two runs equal;
  8. the SHORT_SHOT classify step, the same with its codebook: K9 launched,
     K1/K2 once each (keypoint LRFs only: no normal stage);
  9. training on the card: the five bench training clouds through
     ImplicitShapeModel.train (SHOT with K1/K2 and with
     PCD_PALLAS_LRF_V=2, CSHOT, SHORT_SHOT) against the committed
     JAX-trained codebooks, each served on the bench batch against the
     committed references; training clouds/s on 24 clouds; the train entry
     point on 8 PCD files, then serve on its model.
Before the last line it prints one JSON line with every kernel's launches
(summed over one run of each path, counted from 0 just before each),
error against its twin, times and bound, then the card's name and power
limit.  The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

BATCH = 128
ROUNDS = 8
MS_BATCH = 32     # bench.py's mean-shift batch and rounds
MS_ROUNDS = 16
HERE = os.path.dirname(os.path.abspath(__file__))

# kernel -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "lrf_moments": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
                    "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:94"),
    "sign_votes": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
                   "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:312"),
    "shot_fused": ("point_cloud_donkey_tpu_torch/csrc/shot_fused.cu",
                   "point_cloud_donkey_tpu/ops/pallas/shot_fused.py:395"),
    "chisq_topk": ("point_cloud_donkey_tpu_torch/csrc/chisq.cu",
                   "point_cloud_donkey_tpu/ops/pallas/chisq.py:48"),
    "lrf_moments_windowed": (
        "point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
        "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:434"),
    "sign_votes_windowed": (
        "point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
        "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:492"),
    "shot_dense": ("point_cloud_donkey_tpu_torch/csrc/shot_fused.cu",
                   "point_cloud_donkey_tpu/ops/pallas/shot_fused.py:267"),
    "shot_hist": ("point_cloud_donkey_tpu_torch/csrc/shot_hist.cu",
                  "point_cloud_donkey_tpu/ops/pallas/shot_hist.py:62"),
    "histogram": ("point_cloud_donkey_tpu_torch/csrc/histogram.cu",
                  "point_cloud_donkey_tpu/ops/pallas/histogram.py:51"),
    "lrf_moments_v2": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments_v2.cu",
                       "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:161"),
    "sign_votes_v2": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments_v2.cu",
                      "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:237"),
}
# the path whose step must launch each kernel
PATH_KERNELS = {
    "dense": ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "windowed": ("lrf_moments_windowed", "sign_votes_windowed",
                 "lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "detect": ("lrf_moments", "sign_votes", "shot_dense", "chisq_topk"),
    "cshot": ("lrf_moments", "sign_votes", "shot_hist", "chisq_topk"),
    "short_shot": ("lrf_moments", "sign_votes", "histogram", "chisq_topk"),
    # lrf_version 2: K10 everywhere, K11 at the keypoints, K2 for the
    # z-only normals
    "dense_v2": ("lrf_moments_v2", "sign_votes_v2", "sign_votes",
                 "shot_fused", "chisq_topk"),
    # training: the full normals LRF and the keypoint LRFs, K7 (SHOT), K8
    # (CSHOT) or K9 (SHORT_SHOT), the self-kNN activation (K4)
    "train": ("lrf_moments", "sign_votes", "shot_dense", "chisq_topk"),
    "train_v2": ("lrf_moments_v2", "sign_votes_v2", "shot_dense",
                 "chisq_topk"),
    "train_cshot": ("lrf_moments", "sign_votes", "shot_hist", "chisq_topk"),
    "train_short_shot": ("lrf_moments", "sign_votes", "histogram",
                         "chisq_topk"),
}

# Least time of a kernel call: the larger of its bytes (inputs read once,
# outputs written once) over the H100's memory rate and its fp32
# operations over the fp32 peak outside the tensor cores (data sheet, SXM,
# 700 W).  Operations per (query, point) pair, counted from csrc/*.cu:
# every pair pays the radius gate (3 sub, 3 mul, 2 add, 2 compares); the
# pairs inside the radius (counted from this run's data) pay the body.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
GATE_OPS = 10
MOMENT_BODY_OPS = 21   # sqrt, r - d, w p (3), s0 + s1 (4), s2 (6 mul, 6 add)
VOTE_BODY_OPS = 6      # one (p - q) . axis (3 mul, 2 add) and its compare
SHOT_BODY_OPS = 100    # frame coords, cosine, binning, 5 slot adds;
#                        sqrtf, acosf and atan2f count one each
CHISQ_TERM_OPS = 6     # a + b, a - b, square, divide, compare, accumulate
# K10 / K11 (csrc/lrf_moments_v2.cu) gate every pair by the matmul identity:
# q.p (3 mul, 2 add), d2 (add, mul, sub), the compare.  K10 then selects
# every pair's weight (w or 0) and splits it (2 conversions, sub,
# conversion), and its tensor cores do 3 products x 2 x 16 columns of bf16
# flops a pair; its in-radius pairs pay the weight (max, sqrt, r - d) and
# the count (1 add).  K11's in-radius pairs pay two dots (5 each), two
# subtracts, two compares and two adds.
MOMENT_V2_PAIR_OPS = 14
MOMENT_V2_BODY_OPS = 4
MOMENT_V2_TC_FLOPS = 3 * 2 * 16
VOTE_V2_GATE_OPS = 9
VOTE_V2_BODY_OPS = 16
# K8 / K9 (csrc/shot_hist.cu, csrc/histogram.cu): every column pays its
# weights' zero tests (5 for K8, 1 for K9); a live column reads its indices
# and adds its slots (5 adds for K8, 1 for K9).  Bytes: the weights of every
# column, the indices of the live ones, the histograms written.

# detection against the JAX-CPU detect_maxima_jit reference: the best
# class's maximum within a few times mean-shift's 1e-3 stopping shift, its
# densities within a relative 2e-3 (PERF.md gives the readings behind both)
POS_TOL = 1e-2
DENS_RTOL = 2e-3


def phase(name):
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn over reps calls after one warm-up, from CUDA
    events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, tc_flops=0):
    """(least ms, what bounds it) of a call moving nbytes with ops fp32
    operations and tc_flops bf16 tensor-core flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, tc_flops / BF16_TC_FLOPS_PER_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's kernels need an NVIDIA GPU")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np

    from bench_data import KEYPOINT_CAPACITY, bench_clouds, bench_colors
    from point_cloud_donkey_tpu_torch import serve
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.codebook import (
        CodebookParams, load_codebook)
    from point_cloud_donkey_tpu_torch.models.pipeline import (
        DETECT_STAGES, STAGES, IsmClassifier, IsmDetector, PipelineConfig)
    from point_cloud_donkey_tpu_torch.ops import binned
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops import shot as kshot_ops
    from point_cloud_donkey_tpu_torch.ops.color import \
        rgb_to_cielab_normalized
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    from point_cloud_donkey_tpu_torch.ops.kernels import histogram as khist
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as kshot
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as ksh
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast
    from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
    from point_cloud_donkey_tpu_torch.ops.short_shot import \
        short_shot_slot_arrays
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

    dev = torch.device("cuda:0")
    card = gpu_name_and_power()
    data = os.path.join(HERE, "point_cloud_donkey_tpu_torch", "data")
    model_path = os.path.join(data, "bench_codebook.ism")
    ref = np.load(os.path.join(data, "bench_reference.npz"))
    dref = np.load(os.path.join(data, "descriptor_reference.npz"))

    # -- 1. environment + build ------------------------------------------
    phase("1. environment and build")
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc_ver.splitlines()[-1]}")
    print(f"card: {card}; {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.lib()
    print(f"built {os.path.relpath(lib_path, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 2. kernels vs plain twins at the main path's shapes -------------
    phase(f"2. kernels vs plain twins on the card ({card})")
    _, _, clouds, labels = bench_clouds(BATCH)
    pts = torch.from_numpy(clouds).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    config = IsmConfig.load(model_path)
    codebook = load_codebook(model_path).to(dev)
    cfg = PipelineConfig.from_ism(config, codebook.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY)
    report = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "bound_by": None, "library_ms": None} for name in KERNELS}

    def record(name, err, ms, plain_ms, what, nbytes_, ops, library_ms=None,
               tc_flops=0):
        """One main-path call of a kernel: error vs its twin, times (and
        the one PyTorch call's time, where there is one), and its bound from
        this call's bytes and operations."""
        r = report[name]
        r["err"] = max(r["err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        b_ms, by = bound(nbytes_, ops, tc_flops)
        r["bound_ms"] += b_ms
        r["bound_by"] = by
        lib = ""
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
            lib = f"  library {library_ms:8.3f} ms"
        print(f"{name:20s} {what:36s} max|kernel-plain| {float(err):.3e}  "
              f"kernel {ms:8.3f} ms  plain {plain_ms:9.3f} ms{lib}  bound "
              f"{b_ms:7.4f} ms ({by}, {nbytes_:.3e} B, {ops:.3e} ops)",
              flush=True)

    def lrf_pair(queries, q_mask, radius, z_only, what, starts=None,
                 window=0):
        """K1 and K2 (K5 and K6 with a window plan) at one main-path call:
        moments rtol 2e-4 and counts +-1, sign votes +-1."""
        q, p = klrf.prep_shift(queries, pts_l, mask_l)
        if starts is None:
            k_mom, k_vote = "lrf_moments", "sign_votes"
            swept = p.shape[1]

            def mom_fn(plain=False):
                f = klrf.moments_plain if plain else klrf.moments
                return f(q, p, mask_l, radius)

            def vote_fn(axes, plain=False):
                f = klrf.sign_votes_plain if plain else klrf.sign_votes
                return f(q, p, mask_l, axes, radius, z_only)
        else:
            k_mom, k_vote = "lrf_moments_windowed", "sign_votes_windowed"
            swept = window

            def mom_fn(plain=False):
                f = (klrf.moments_windowed_plain if plain
                     else klrf.moments_windowed)
                return f(q, p, mask_l, starts, window, radius)

            def vote_fn(axes, plain=False):
                f = (klrf.sign_votes_windowed_plain if plain
                     else klrf.sign_votes_windowed)
                return f(q, p, mask_l, axes, starts, window, radius, z_only)
        mom, cnt = mom_fn()
        pmom, pcnt = mom_fn(plain=True)
        s0, ps0 = mom[..., 0], pmom[..., 0]
        rel = ((s0 - ps0).abs() / ps0.abs().clamp(min=1e-6)).max()
        assert rel <= 2e-4, f"K1 weight sums off by rtol {rel:.2e} ({what})"
        assert (cnt - pcnt).abs().max() <= 1, f"K1 counts ({what})"
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        pcov, _ = klrf.cov_from_moments(pmom, q, q_mask)
        cerr = (cov - pcov).abs().max()
        assert cerr <= 5e-4, f"K1 covariance off by {cerr:.2e} ({what})"
        pairs = q.shape[0] * q.shape[1] * swept
        inside = int(cnt.sum())
        print(f"{'':20s} {what}: {pairs:.3e} pairs swept, in-radius share "
              f"{inside / pairs:.4f}")
        extra = (starts,) if starts is not None else ()
        record(k_mom, (mom - pmom).abs().max(), cuda_ms(mom_fn, 5),
               cuda_ms(lambda: mom_fn(plain=True), 2), what,
               nbytes(q, p, mask_l, mom, cnt, *extra),
               pairs * GATE_OPS + inside * MOMENT_BODY_OPS)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        v = vote_fn(axes)
        pv = vote_fn(axes, plain=True)
        err = (v - pv).abs().max()
        assert err <= 1, f"K2/K6 votes off by {err} ({what})"
        record(k_vote, err, cuda_ms(lambda: vote_fn(axes), 5),
               cuda_ms(lambda: vote_fn(axes, plain=True), 2), what,
               nbytes(q, p, mask_l, axes, v, *extra),
               pairs * GATE_OPS
               + inside * VOTE_BODY_OPS * (1 if z_only else 2))
        return cnt

    pts_l, mask_l = pts, mask
    with torch.no_grad():
        lrf_pair(pts, mask, cfg.normal_radius, True,
                 f"normals B={BATCH} Q=N={pts.shape[1]}")
        normals = compute_normals_fast(pts, mask, cfg.normal_radius)
        kres = voxel_grid(pts, mask, cfg.leaf_size,
                          capacity=cfg.keypoint_capacity)
        kp = torch.where(kres.mask[..., None], kres.centroids,
                         torch.full_like(kres.centroids, 1e9))
        lrf_pair(kp, kres.mask, cfg.ref_frame_radius, False,
                 f"keypoint LRF B={BATCH} Q={kp.shape[1]}")
        lrf = shot_lrf(kp, kres.mask, pts, mask, cfg.ref_frame_radius)

        gidx, alive, tile_cloud = kshot.compact_layout(kres.mask)
        kp_rows = torch.where(alive[:, None], kp.reshape(-1, 3)[gidx],
                              torch.full((1, 3), 1e9, device=dev))
        fr_rows = lrf.frames.reshape(-1, 3, 3)[gidx].contiguous()
        fv_rows = lrf.valid.reshape(-1)[gidx] & alive
        shot_args = (kp_rows, fr_rows, tile_cloud, pts, normals, mask,
                     cfg.radius)
        hist, cnt = kshot.shot_tiles(*shot_args)
        phist, pcnt = kshot.shot_tiles_plain(*shot_args)
        assert torch.equal(cnt, pcnt), "K3 in-radius counts differ"
        got = normalize_descriptors(hist, cnt, fv_rows)
        want = normalize_descriptors(phist, pcnt, fv_rows)
        assert torch.equal(got.valid, want.valid), "K3 validity differs"
        both = got.valid & want.valid
        cos = (got.descriptors[both] * want.descriptors[both]).sum(-1)
        off = ((got.descriptors[both] - want.descriptors[both]).abs()
               > 1e-3).float().mean()
        assert cos.min() > 0.999 and off < 1e-4, (cos.min(), off)
        rows = kp_rows.shape[0]
        gate = rows * int(mask.sum()) // BATCH
        record("shot_fused", (hist - phist).abs().max(),
               cuda_ms(lambda: kshot.shot_tiles(*shot_args), 5),
               cuda_ms(lambda: kshot.shot_tiles_plain(*shot_args), 2),
               f"SHOT {tile_cloud.shape[0]} tiles x N={pts.shape[1]}",
               nbytes(kp_rows, fr_rows, tile_cloud, pts, normals, mask, hist,
                      cnt),
               gate * GATE_OPS + int(cnt.sum()) * SHOT_BODY_OPS)

        desc = got.descriptors[got.valid].contiguous()
        cw, cw_mask = codebook.codewords, codebook.cw_mask
        for k in (1, 3):
            d, i = kchisq.chisq_topk(desc, cw, cw_mask, k)
            pd, pi = kchisq.chisq_topk_plain(desc, cw, cw_mask, k)
            rel = ((d - pd).abs() / pd.abs().clamp(min=1e-6)).max()
            assert rel <= 1e-5, f"K4 distances off by rtol {rel:.2e}"
            differ = i != pi
            assert torch.allclose(d[differ], pd[differ], rtol=1e-5), \
                "K4 indices differ beyond ties"
            ms = cuda_ms(lambda: kchisq.chisq_topk(desc, cw, cw_mask, k), 5)
            pms = cuda_ms(lambda: kchisq.chisq_topk_plain(desc, cw, cw_mask,
                                                          k), 2)
            what = f"chisq Q={desc.shape[0]} C={cw.shape[0]} D=352 k={k}"
            if k == 1:    # the main path's k
                record("chisq_topk", (d - pd).abs().max(), ms, pms, what,
                       nbytes(desc, cw, cw_mask, d, i),
                       desc.shape[0] * cw.shape[0]
                       * (352 * CHISQ_TERM_OPS + 1))
            else:
                print(f"{'chisq_topk':20s} {what:36s} max|kernel-plain| "
                      f"{float((d - pd).abs().max()):.3e}  kernel "
                      f"{ms:8.3f} ms  plain {pms:9.3f} ms")

        # K5 / K6 at the windowed step's shapes: the sorted batch, the
        # window calibrated on it
        window = binned.required_window(pts, mask, cfg.normal_radius)
        srt = binned.sort_clouds_ex(pts, mask)
        plan = binned.window_starts(srt.keys, srt.mask, srt.keys,
                                    cfg.normal_radius, window)
        print(f"normals window calibrated on the batch: {window} of "
              f"N={pts.shape[1]}, exact {bool(plan.exact)}")
        assert window < pts.shape[1] and bool(plan.exact), \
            "the calibrated window does not prune or is not exact"
        pts_l, mask_l = srt.points, srt.mask
        lrf_pair(srt.points, srt.mask, cfg.normal_radius, True,
                 f"windowed normals B={BATCH} W={window}", plan.starts,
                 window)

        # K7 at the mean-shift step's shapes: the dense [32, 192] grid
        mp, mm = pts[:MS_BATCH].contiguous(), mask[:MS_BATCH].contiguous()
        mn = compute_normals_fast(mp, mm, cfg.normal_radius)
        mk = voxel_grid(mp, mm, cfg.leaf_size, capacity=cfg.keypoint_capacity)
        mkp = torch.where(mk.mask[..., None], mk.centroids,
                          torch.full_like(mk.centroids, 1e9)).contiguous()
        mlrf = shot_lrf(mkp, mk.mask, mp, mm, cfg.ref_frame_radius)
        dense_args = (mkp, mlrf.frames.contiguous(), mlrf.valid.contiguous(),
                      mp, mn, mm, cfg.radius)
        dh, dc = kshot.shot_dense(*dense_args)
        pdh, pdc = kshot.shot_dense_plain(*dense_args)
        assert torch.equal(dc, pdc), "K7 in-radius counts differ"
        got = normalize_descriptors(dh, dc, mlrf.valid)
        want = normalize_descriptors(pdh, pdc, mlrf.valid)
        assert torch.equal(got.valid, want.valid), "K7 validity differs"
        both = got.valid & want.valid
        cos = (got.descriptors[both] * want.descriptors[both]).sum(-1)
        off = ((got.descriptors[both] - want.descriptors[both]).abs()
               > 1e-3).float().mean()
        assert cos.min() > 0.999 and off < 1e-4, (cos.min(), off)
        live = int(mlrf.valid.sum())
        tiles = mkp.shape[0] * mkp.shape[1] // kshot.TK
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chunks = kshot.dense_chunks(tiles, mp.shape[1], sms)
        # K7 with one point chunk per tile against the wrapper's rule, at a
        # single cloud, a small serving batch and the mean-shift batch
        rule = kshot.dense_chunks
        for nb in (1, 8, MS_BATCH):
            args_b = tuple(a[:nb].contiguous() for a in dense_args[:6]) \
                + (cfg.radius,)
            tiles_b = nb * mkp.shape[1] // kshot.TK
            pick = rule(tiles_b, mp.shape[1], sms)
            try:
                kshot.dense_chunks = lambda *a: 1
                one = cuda_ms(lambda: kshot.shot_dense(*args_b), 5)
                _, c1 = kshot.shot_dense(*args_b)
            finally:
                kshot.dense_chunks = rule
            split = cuda_ms(lambda: kshot.shot_dense(*args_b), 5)
            _, cr = kshot.shot_dense(*args_b)
            assert torch.equal(c1, cr), "K7 counts depend on the chunks"
            print(f"{'shot_dense':20s} B={nb} ({tiles_b} tiles): 1 chunk "
                  f"{one:.4f} ms, the rule's {pick} chunks {split:.4f} ms")
        record("shot_dense", (dh - pdh).abs().max(),
               cuda_ms(lambda: kshot.shot_dense(*dense_args), 5),
               cuda_ms(lambda: kshot.shot_dense_plain(*dense_args), 2),
               f"SHOT {tiles} tiles x {chunks} chunks, {live} live",
               nbytes(*dense_args[:6], dh, dc),
               live * int(mm.sum()) // MS_BATCH * GATE_OPS
               + int(dc.sum()) * SHOT_BODY_OPS)

    # -- 2c. K8 / K9 at the CSHOT and SHORT_SHOT steps' shapes -------------
    phase(f"2c. K8 / K9 vs plain twins and scatter_add_ on the card ({card})")
    rgb = torch.from_numpy(bench_colors(clouds)).to(dev)
    with torch.no_grad():
        ck = voxel_grid(pts, mask, cfg.leaf_size,
                        capacity=cfg.keypoint_capacity, features=rgb)
        ckp = torch.where(ck.mask[..., None], ck.centroids[..., :3],
                          torch.full_like(ck.centroids[..., :3], 1e9))
        clrf = shot_lrf(ckp, ck.mask, pts, mask, cfg.ref_frame_radius)
        channels, _ = kshot_ops.cshot_slot_arrays(
            ckp, rgb_to_cielab_normalized(ck.centroids[..., 3:6]),
            clrf.frames, pts, normals,
            rgb_to_cielab_normalized(rgb),
            mask & torch.isfinite(normals).all(-1), cfg.radius)
        for args in channels:
            hist_k8(args, ksh, record)
        del channels
        idx, w = short_shot_slot_arrays(ckp, clrf.frames, pts, mask,
                                        cfg.radius)
        hist_k9(idx, w, khist, record)
        del idx, w

    # -- 2d. K10 / K11 at the main paths' shapes ----------------------------
    phase(f"2d. K10 / K11 vs plain twins and vs K1 / K2 on the card ({card})")

    def moments_v2_check(q, p, q_mask, radius, what, mom, cnt, cov, pairs,
                         inside):
        """K10's moments against its twin and against K1, timed beside
        both and recorded."""
        pmom, pcnt = klrf.moments_v2_plain(q, p, mask, radius)
        m1, c1 = klrf.moments(q, p, mask, radius)
        for other, ocnt, vs in ((pmom, pcnt, "its twin"), (m1, c1, "K1")):
            rel = ((mom[..., 0] - other[..., 0]).abs()
                   / other[..., 0].abs().clamp(min=1e-6)).max()
            ocov, _ = klrf.cov_from_moments(other, q, q_mask)
            cerr = (cov - ocov).abs().max()
            dc = int((cnt - ocnt).abs().max())
            print(f"{'lrf_moments_v2':20s} {what} vs {vs}: weight sums "
                  f"rtol {float(rel):.2e}, counts +-{dc}, covariance "
                  f"{float(cerr):.2e}")
            assert rel <= 2e-4 and dc <= 1 and cerr <= 5e-4, \
                f"K10 differs from {vs} ({what})"
        k1_ms = cuda_ms(lambda: klrf.moments(q, p, mask, radius), 5)
        ms = cuda_ms(lambda: klrf.moments_v2(q, p, mask, radius), 5)
        print(f"{'':20s} {what}: K10 {ms:.4f} ms, K1 {k1_ms:.4f} ms at the "
              f"same inputs ({card})")
        record("lrf_moments_v2", (mom - pmom).abs().max(), ms,
               cuda_ms(lambda: klrf.moments_v2_plain(q, p, mask, radius), 2),
               what, nbytes(q, p, mask, mom, cnt),
               pairs * MOMENT_V2_PAIR_OPS + inside * MOMENT_V2_BODY_OPS,
               tc_flops=pairs * MOMENT_V2_TC_FLOPS)

    def lrf_v2(queries, q_mask, radius, z_only, what, moments=True):
        """K10 (and K11 unless z_only: the z-only normals vote with K2)
        at one main-path call against its twin -- moments: weight sums
        rtol 2e-4, counts +-1, covariance atol 5e-4; votes +-1 -- and
        against K1 / K2 to the JAX package's v1-vs-v2 contract
        (tests/test_pallas_kernels.py:101-125): the same, valid flags
        equal, >= 97% of frames with every axis at |cos| > 0.999.  With
        moments False, K10 is held and recorded by another call at the same
        shape (its moments do not depend on z_only), and only its
        covariance feeds K11 here."""
        q, p = klrf.prep_shift(queries, pts, mask)
        mom, cnt = klrf.moments_v2(q, p, mask, radius)
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        pairs = q.shape[0] * q.shape[1] * p.shape[1]
        inside = int(cnt.sum())
        if moments:
            moments_v2_check(q, p, q_mask, radius, what, mom, cnt, cov, pairs,
                             inside)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        if not z_only:
            v = klrf.sign_votes_v2(q, p, mask, axes, radius)
            pv = klrf.sign_votes_v2_plain(q, p, mask, axes, radius)
            err = int((v - pv).abs().max())
            err1 = int((v - klrf.sign_votes(q, p, mask, axes, radius))
                       .abs().max())
            print(f"{'sign_votes_v2':20s} {what}: votes vs its twin +-{err}, "
                  f"vs K2 +-{err1}")
            assert err <= 1 and err1 <= 1, f"K11 votes differ ({what})"
            k2_ms = cuda_ms(lambda: klrf.sign_votes(q, p, mask, axes,
                                                    radius), 5)
            ms = cuda_ms(lambda: klrf.sign_votes_v2(q, p, mask, axes,
                                                    radius), 5)
            print(f"{'':20s} {what}: K11 {ms:.4f} ms, K2 {k2_ms:.4f} ms at "
                  f"the same inputs ({card})")
            record("sign_votes_v2", err, ms,
                   cuda_ms(lambda: klrf.sign_votes_v2_plain(
                       q, p, mask, axes, radius), 2), what,
                   nbytes(q, p, mask, axes, v),
                   pairs * VOTE_V2_GATE_OPS + inside * VOTE_V2_BODY_OPS)
        one = shot_lrf(queries, q_mask, pts, mask, radius, z_only=z_only)
        two = shot_lrf(queries, q_mask, pts, mask, radius, z_only=z_only,
                       lrf_version=2)
        assert torch.equal(one.valid, two.valid), f"valid flags ({what})"
        cosf = torch.einsum("...ij,...ij->...i", one.frames, two.frames) \
            .abs().amin(-1)[one.valid]
        share = float((cosf > 0.999).float().mean())
        print(f"{'':20s} {what}: frames v2 vs v1 |cos| > 0.999 on "
              f"{100 * share:.2f}% of {int(one.valid.sum())} valid frames")
        assert share >= 0.97, f"v2 frames differ from v1 ({what})"

    with torch.no_grad():
        lrf_v2(pts, mask, cfg.normal_radius, True,
               f"normals B={BATCH} Q=N={pts.shape[1]}")
        # the training normals: the full LRF, K11 at Q = N
        lrf_v2(pts, mask, cfg.normal_radius, False,
               f"full-LRF normals B={BATCH} Q=N={pts.shape[1]}",
               moments=False)
        lrf_v2(kp, kres.mask, cfg.ref_frame_radius, False,
               f"keypoint LRF B={BATCH} Q={kp.shape[1]}")

    # -- 3. goldens ---------------------------------------------------------
    phase("3. goldens (tests/golden/descriptors.npz, atol 2e-3)")
    g = np.load(os.path.join(HERE, "tests", "golden", "descriptors.npz"))
    gp = torch.from_numpy(g["points"]).to(dev)
    gn = torch.from_numpy(g["normals"]).to(dev)
    gk = torch.from_numpy(g["keypoints"]).to(dev)
    ones_p = torch.ones(len(gp), dtype=torch.bool, device=dev)
    ones_k = torch.ones(len(gk), dtype=torch.bool, device=dev)
    with torch.no_grad():
        res = shot_lrf(gk, ones_k, gp, ones_p, 0.6)
        assert bool(res.valid.all())
        ferr = np.abs(res.frames.cpu().numpy() - g["frames"]).max()
        assert ferr <= 2e-3, f"golden frames off by {ferr}"
        rows = kshot.TK
        kp8 = torch.full((rows, 3), 1e9, device=dev)
        kp8[:len(gk)] = gk
        fr8 = torch.eye(3, device=dev).repeat(rows, 1, 1)
        fr8[:len(gk)] = torch.from_numpy(g["frames"].astype(np.float32)).to(dev)
        h, c = kshot.shot_tiles(kp8, fr8.contiguous(),
                                torch.zeros(1, dtype=torch.int32, device=dev),
                                gp[None], gn[None], ones_p[None], 0.6)
        gd = normalize_descriptors(h, c, torch.ones(rows, dtype=torch.bool,
                                                    device=dev))
        assert bool(gd.valid[:len(gk)].all())
        serr = np.abs(gd.descriptors[:len(gk)].cpu().numpy()
                      - g["shot"]).max()
        assert serr <= 2e-3, f"golden SHOT off by {serr}"
    print(f"frames max err {ferr:.2e}, SHOT (K3) max err {serr:.2e}")

    # -- 4. the dense classify step ------------------------------------------
    phase(f"4. dense classify step: IsmClassifier, B={BATCH} x "
          f"N={pts.shape[1]} ({card})")
    params = CodebookParams.from_config(config.child("Codebook"))
    model = IsmClassifier(codebook, cfg, params)
    assert np.array_equal(clouds[:len(ref["points"])], ref["points"]), \
        "bench batch differs from the committed reference clouds"
    launches = {}
    scores, launches["dense"] = drive("dense", model, STAGES, pts, mask,
                                      ROUNDS, card)
    with torch.no_grad():
        again = model(pts, mask)
    assert torch.equal(scores, again), "two runs of the step differ"
    print("two runs of the step: scores identical")
    dense_scores = scores
    s = scores.cpu().numpy()
    assert s.shape == (BATCH, cfg.num_classes) and np.isfinite(s).all()
    check_decisions(s, ref["scores"], labels)

    # -- 4b. the windowed classify step -------------------------------------
    phase(f"4b. windowed classify step: IsmClassifier, normals window "
          f"{window}, B={BATCH} x N={pts.shape[1]} ({card})")
    wmodel = IsmClassifier(codebook, cfg._replace(normals_window=window),
                           params)
    scores, launches["windowed"] = drive("windowed", wmodel, STAGES, pts,
                                         mask, ROUNDS, card)
    print(f"dense recomputes: {wmodel.dense_recomputes} (committed reference "
          f"window {int(ref['normals_window'])})")
    assert wmodel.dense_recomputes == 0, "the calibrated window tripped"
    with torch.no_grad():
        assert torch.equal(scores, wmodel(pts, mask)), \
            "two runs of the windowed step differ"
    check_decisions(scores.cpu().numpy(), ref["scores_windowed"], labels)
    tripped = IsmClassifier(codebook, cfg._replace(normals_window=128),
                            params)
    with torch.no_grad():
        tscores = tripped(pts, mask)
        # the tripped step runs dense on the sorted clouds: the dense step
        # on the same sorted clouds gives the same scores, bit for bit
        sorted_dense = model(srt.points, srt.mask)
        again = tripped(pts, mask)
    assert tripped.dense_recomputes == 2
    assert torch.equal(tscores, again), "two tripped steps differ"
    assert torch.equal(tscores, sorted_dense), \
        "the dense recompute differs from the dense step"
    # against the dense step on the unsorted clouds the scores differ by
    # the summation order of the sorted points only
    diff = (tscores - dense_scores).abs()
    flips = (tscores.argmax(1) != dense_scores.argmax(1)).nonzero()[:, 0]
    print(f"forced trip (window 128): dense recomputes 1 a step; scores "
          f"equal to the dense step on the sorted clouds; sorted vs unsorted "
          f"dense step: max |delta| {float(diff.max()):.3e} on cloud "
          f"{int(diff.max(1).values.argmax())}, {int((diff.max(1).values > 0).sum())}"
          f"/{BATCH} clouds moved, argmax differs on clouds {flips.tolist()}")
    check_decisions(tscores.cpu().numpy(), dense_scores.cpu().numpy(),
                    labels, "the unsorted dense step")
    check_decisions(tscores.cpu().numpy(), ref["scores"], labels)

    # -- 4c. the dense classify step with the v2 LRF kernels ----------------
    phase(f"4c. dense classify step, lrf_version 2 (K10 / K11): "
          f"IsmClassifier, B={BATCH} x N={pts.shape[1]} ({card})")
    v2model = IsmClassifier(codebook, cfg._replace(lrf_version=2), params)
    scores, launches["dense_v2"] = drive("dense_v2", v2model, STAGES, pts,
                                         mask, ROUNDS, card)
    assert launches["dense_v2"]["lrf_moments"] == 0, \
        f"K1 launched by the v2 step: {launches['dense_v2']}"
    with torch.no_grad():
        assert torch.equal(scores, v2model(pts, mask)), \
            "two runs of the v2 step differ"
    print("two runs of the step: scores identical")
    check_decisions(scores.cpu().numpy(), ref["scores"], labels)

    # -- 5. serve -------------------------------------------------------------
    phase("5. serve --device cuda on 8 PCD files")
    text = serve_files(serve, model_path, ref["points"][:8],
                       ref["labels"][:8], [])
    ref_acc = 100.0 * (ref["scores"][:8].argmax(1)
                       == ref["labels"][:8]).mean()
    assert f" Accuracy: {ref_acc:.0f} % " in text, \
        f"serve accuracy differs from the reference {ref_acc:.0f} %"

    # -- 5b. serve a CSHOT model on coloured files ----------------------------
    phase("5b. serve --device cuda with the CSHOT model on 8 coloured PCD "
          "files")
    cshot_path = os.path.join(data, "cshot_codebook.ism")
    text = serve_files(serve, cshot_path, ref["points"][:8],
                       ref["labels"][:8], [], colours=bench_colors)
    cs_acc = 100.0 * (dref["scores_cshot"][:8].argmax(1)
                      == ref["labels"][:8]).mean()
    assert f" Accuracy: {cs_acc:.0f} % " in text, \
        f"CSHOT serve accuracy differs from the reference {cs_acc:.0f} %"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = serve.main(["-d", cshot_path, "-f", os.devnull, "--device",
                         "cuda", "--maxima"])
    print(f"serve --maxima with the CSHOT model: exit {rc}, "
          f"{err.getvalue().strip()!r}")
    assert rc == 1 and "--maxima does not support CSHOT yet" \
        in err.getvalue(), "serve --maxima did not refuse the CSHOT model"

    # -- 6. the mean-shift detection step -----------------------------------
    phase(f"6. detection step: IsmDetector, B={MS_BATCH} x N={pts.shape[1]} "
          f"({card})")
    detector = IsmDetector(codebook, cfg, params)
    mp, mm = pts[:MS_BATCH].contiguous(), mask[:MS_BATCH].contiguous()
    (dens, pos), launches["detect"] = drive("detect", detector,
                                            DETECT_STAGES, mp, mm, MS_ROUNDS,
                                            card)
    d, p = dens.cpu().numpy(), pos.cpu().numpy()
    assert np.isfinite(d).all() and np.isfinite(p).all()
    rd, rp = ref["detect_densities"], ref["detect_positions"]
    check_decisions(d, rd, labels[:MS_BATCH])
    best = rd.argmax(1)
    perr = float(np.abs(p[np.arange(MS_BATCH), best]
                        - rp[np.arange(MS_BATCH), best]).max())
    drel = float((np.abs(d - rd) / np.maximum(np.abs(rd), 1.0)).max())
    print(f"best-class maximum vs JAX-CPU: max |position delta| {perr:.3e} "
          f"(limit {POS_TOL}); densities max relative delta {drel:.3e} "
          f"(limit {DENS_RTOL})")
    assert perr <= POS_TOL, "maxima differ from the JAX reference"
    assert drel <= DENS_RTOL, "densities differ from the JAX reference"
    text = serve_files(serve, model_path, ref["points"][:8],
                       ref["labels"][:8], ["--maxima"])
    rows = re.findall(r"predicted \d+, ground truth \d+ (?:OK|WRONG) "
                      r"maximum \(\S+ \S+ \S+\)$", text, re.M)
    assert len(rows) == 8 and " Accuracy: 100 % " in text, \
        "serve --maxima did not report 8 correct predictions with maxima"

    # -- 7. / 8. the CSHOT and SHORT_SHOT classify steps ----------------------
    for num, desc in (("7", "CSHOT"), ("8", "SHORT_SHOT")):
        key = desc.lower()
        phase(f"{num}. {desc} classify step: IsmClassifier, B={BATCH} x "
              f"N={pts.shape[1]} ({card})")
        path = os.path.join(data, f"{key}_codebook.ism")
        dconfig = IsmConfig.load(path)
        dcb = load_codebook(path).to(dev)
        dmodel = IsmClassifier(
            dcb, PipelineConfig.from_ism(dconfig, dcb.num_classes,
                                         keypoint_capacity=KEYPOINT_CAPACITY),
            CodebookParams.from_config(dconfig.child("Codebook")))
        assert dmodel.cfg.descriptor == desc
        extra = (rgb,) if desc == "CSHOT" else ()
        scores, launches[key] = drive(key, dmodel, STAGES, pts, mask,
                                      ROUNDS, card, extra)
        with torch.no_grad():
            again = dmodel(pts, mask, *extra)
        same = bool(torch.equal(scores, again))
        print(f"two runs of the step: scores identical {same}; max |delta| "
              f"{float((scores - again).abs().max()):.3e}")
        assert same, f"two runs of the {desc} step differ"
        if desc == "CSHOT":
            assert launches[key]["shot_hist"] == 2, launches[key]
        else:
            assert launches[key]["histogram"] == 1 and \
                launches[key]["lrf_moments"] == 1 and \
                launches[key]["sign_votes"] == 1, \
                f"SHORT_SHOT must run K1/K2 at the keypoints only: " \
                f"{launches[key]}"
        s_np = scores.cpu().numpy()
        assert s_np.shape == (BATCH, cfg.num_classes) and \
            np.isfinite(s_np).all()
        check_decisions(s_np, dref["scores_" + key], labels,
                        require_accuracy=desc == "CSHOT")

    # -- 9. training on the card -------------------------------------------------
    phase(f"9. training: ImplicitShapeModel.train on the fused route ({card})")
    training(launches, card, data, pts, mask, rgb, labels, ref, dref)

    # -- results ----------------------------------------------------------------
    total = {k: sum(run[k] for run in launches.values()) for k in KERNELS}
    assert all(total.values()), f"kernels never launched: {total}"
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": total[name],
                "max_abs_err": report[name]["err"],
                "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
                "bound_ms": report[name]["bound_ms"],
                "bound_by": report[name]["bound_by"],
                "library_ms": report[name]["library_ms"]}
               for name, (src, tpu) in KERNELS.items()]
    print()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def drive(path, model, stages, pts, mask, rounds, card, extra=()):
    """One step of a main path with the launch counts set to 0 just before
    and read just after (per-stage ms from CUDA events), then `rounds`
    steps timed on the host clock; `extra` follows points and mask into
    the model.  Returns (output, launches)."""
    import torch

    from point_cloud_donkey_tpu_torch.kernels import build
    with torch.no_grad():
        model(pts, mask, *extra)                          # warm-up
        torch.cuda.synchronize()
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        build.reset_launch_counts()
        events["start"].record()
        out = model(pts, mask, *extra, on_stage=mark)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        prev, stage_ms = "start", {}
        for name in stages:
            stage_ms[name] = events[prev].elapsed_time(events[name])
            prev = name
        t0 = time.perf_counter()
        for _ in range(rounds):
            model(pts, mask, *extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print("stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f" (sum {sum(stage_ms.values()):.3f})")
    print(f"throughput: {pts.shape[0] * rounds / dt:.1f} clouds/s over "
          f"{rounds} rounds of {pts.shape[0]} clouds ({card})")
    print(f"launches in one step: {launches}")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    assert not missing, f"kernels not launched by the {path} path: {missing}"
    return out, launches


def training(launches, card, data, pts, mask, rgb, labels, ref, dref):
    """Phase 9: train on the bench's five training clouds (SHOT with K1/K2
    and with K10/K11, CSHOT on their colours, SHORT_SHOT) through the
    port's ImplicitShapeModel on the card, each with the launch counts set
    to 0 just before and read just after; hold each codebook against the
    committed JAX-trained one and serve it on the bench batch against the
    committed JAX-CPU references; time the training of 24 rotated clouds;
    run the train entry point on 8 PCD files and serve its model."""
    import copy

    import numpy as np
    import torch

    from bench_data import (BENCH_CONFIG, KEYPOINT_CAPACITY, NUM_CLASSES,
                            bench_clouds, bench_colors)
    from point_cloud_donkey_tpu_torch import serve, train
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.codebook import (
        Codebook, CodebookParams)
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                              PipelineConfig)
    from point_cloud_donkey_tpu_torch.ops.lrf import lrf_version_from_env
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd

    import shapes

    def config(descriptor):
        cfg = copy.deepcopy(BENCH_CONFIG)
        cfg["ObjectConfig"]["Children"]["Features"]["Type"] = descriptor
        return IsmConfig.from_json(cfg)

    tmp = tempfile.mkdtemp(prefix="pcd_smoke_train_")
    try:
        def files(clouds, cls, prefix, colours=None):
            out = []
            for i, (cloud, c) in enumerate(zip(clouds, cls)):
                path = os.path.join(tmp, f"{prefix}{i}.pcd")
                save_pcd(path, cloud,
                         rgb=None if colours is None else colours(cloud))
                out.append((path, int(c)))
            return out

        def run(descriptor, items, path, lrf_version=1):
            """Train; with a path, the launch counts of the call are
            checked against PATH_KERNELS[path] and kept."""
            ism = ImplicitShapeModel(config(descriptor), "cuda", lrf_version)
            for p, c in items:
                ism.add_training_model(p, c, c)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            ism.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = build.launch_counts()
            if path is not None:
                print(f"{path}: {len(items)} clouds in {dt:.3f} s, "
                      f"{ism.state.codebook.num_codewords} codewords; "
                      f"launches {got}")
                missing = [k for k in PATH_KERNELS[path] if got[k] == 0]
                assert not missing, \
                    f"kernels not launched by the {path} path: {missing}"
                launches[path] = got
            return ism, dt

        def served(ism, extra=()):
            cb = Codebook.from_numpy(ism.state.codebook._asdict()).to(
                pts.device)
            model = IsmClassifier(
                cb, PipelineConfig.from_ism(
                    ism.config, cb.num_classes,
                    keypoint_capacity=KEYPOINT_CAPACITY),
                CodebookParams.from_config(ism.config.child("Codebook")))
            with torch.no_grad():
                return model(pts, mask, *extra).cpu().numpy()

        def compare(cb, want, what):
            """The training contract against a committed JAX-trained
            codebook: codeword count and mask equal, the same vote classes,
            >= 97% of the codewords at cosine > 0.999 in the same order,
            class sigmas within rtol 5e-2."""
            assert cb.codewords.shape == want["cb_codewords"].shape and \
                np.array_equal(cb.cw_mask, want["cb_cw_mask"]), \
                f"{what}: codewords {cb.codewords.shape} vs " \
                f"{want['cb_codewords'].shape}"
            assert np.array_equal(cb.vote_class, want["cb_vote_class"]), \
                f"{what}: vote classes differ"
            a, b = cb.codewords, want["cb_codewords"]
            cos = (a * b).sum(1) / np.maximum(
                np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-30)
            share = float((cos > 0.999).mean())
            srel = float(np.abs(cb.class_sigma / want["cb_class_sigma"]
                                - 1).max())
            print(f"{what} vs the committed JAX-trained codebook: "
                  f"{cb.num_codewords} codewords, cosine > 0.999 on "
                  f"{100 * share:.2f}% (min {cos.min():.6f}), class sigma "
                  f"max relative delta {srel:.3e}")
            assert share >= 0.97 and srel <= 5e-2, f"{what} differs"

        train_pts, train_cls, _, _ = bench_clouds(0)
        shot_items = files(train_pts, train_cls, "s")
        want = np.load(os.path.join(data, "bench_codebook.ismd.npz"))
        ism, _ = run("SHOT", shot_items, "train")
        compare(ism.state.codebook, want, "SHOT")
        check_decisions(served(ism), ref["scores"], labels)

        old = os.environ.get("PCD_PALLAS_LRF_V")
        os.environ["PCD_PALLAS_LRF_V"] = "2"
        try:
            version = lrf_version_from_env()
        finally:
            if old is None:
                del os.environ["PCD_PALLAS_LRF_V"]
            else:
                os.environ["PCD_PALLAS_LRF_V"] = old
        ism, _ = run("SHOT", shot_items, "train_v2", version)
        assert launches["train_v2"]["lrf_moments"] == 0, "K1 launched"
        compare(ism.state.codebook, want, "SHOT, PCD_PALLAS_LRF_V=2")
        check_decisions(served(ism), ref["scores"], labels)

        for desc, items, extra in (
                ("CSHOT", files(train_pts, train_cls, "c", bench_colors),
                 (rgb,)),
                ("SHORT_SHOT", shot_items, ())):
            key = desc.lower()
            ism, _ = run(desc, items, "train_" + key)
            with np.load(os.path.join(data, f"{key}_codebook.ismd.npz")) as z:
                count = int(z["cb_cw_mask"].sum())
            print(f"{desc}: {ism.state.codebook.num_codewords} codewords "
                  f"(committed JAX-trained: {count})")
            assert ism.state.codebook.num_codewords == count
            check_decisions(served(ism, extra), dref["scores_" + key],
                            labels, require_accuracy=False)

        # throughput: 24 rotated clouds drawn as bench.py:380-416 draws
        # them, after one untimed run on another 24
        rng = np.random.default_rng(42)
        sets = []
        for prefix in ("w", "t"):
            cls = [i % NUM_CLASSES for i in range(24)]
            sets.append(files([shapes.make_instance(rng, c, n=pts.shape[1],
                                                    rotate=True, noise=0.005)
                               for c in cls], cls, prefix))
        run("SHOT", sets[0], None)
        ism, dt = run("SHOT", sets[1], None)
        per = {k: round(v * 1e3 / 24, 3)
               for k, v in ism.processing_times.items()}
        print(f"training throughput: {24 / dt:.2f} clouds/s over 24 clouds "
              f"({card}); train_* ms per cloud: {per}")

        # the train entry point on 8 PCD files, then serve its model
        items = files(ref["points"][:8], ref["labels"][:8], "f")
        cfg_path = os.path.join(tmp, "config.ism")
        config("SHOT").save(cfg_path)
        flist = os.path.join(tmp, "train.txt")
        with open(flist, "w") as f:
            f.write("\n".join(["# train"] + [f"{p} {c}" for p, c in items])
                    + "\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train.main(["-t", cfg_path, "-f", flist, "-o",
                             os.path.join(tmp, "model")])
        print(out.getvalue().rstrip())
        assert rc == 0, "train failed"
        text = serve_files(serve, os.path.join(tmp, "model.ism"),
                           ref["points"][:8], ref["labels"][:8], [])
        assert " Accuracy: 100 % " in text, \
            "serve of the trained model missed its own training clouds"
    finally:
        shutil.rmtree(tmp)


def check_decisions(s, rs, labels, what="JAX-CPU reference",
                    require_accuracy=True):
    """Accuracy 1.0 against the labels (unless not required: then it is
    only printed), argmax equal to the reference rs (by default the
    committed JAX-CPU one) on every firm cloud (margin > 3) and an rms
    delta <= 5% of the scale."""
    import numpy as np
    acc = float((s.argmax(1) == labels[:len(s)]).mean())
    srt = np.sort(rs, axis=1)
    firm = srt[:, -1] - srt[:, -2] > 3.0
    sub = s[:len(rs)]
    agree = sub.argmax(1)[firm] == rs.argmax(1)[firm]
    rms = float(np.sqrt(((sub - rs) ** 2).mean()))
    scale = float(np.abs(rs).max())
    print(f"accuracy vs labels {acc:.4f} on {len(s)} clouds; vs {what}: "
          f"argmax agrees on {int(agree.sum())}/{int(firm.sum())} "
          f"firm clouds, rms delta {rms:.3e} (scale {scale:.2f}, "
          f"{100 * rms / scale:.4f}%)")
    assert firm.any() and agree.all(), f"decisions differ from the {what}"
    assert acc == 1.0 or not require_accuracy, f"accuracy {acc} below 1.0"
    assert rms <= 0.05 * scale, f"scores differ from the {what}"


def hist_k8(args, ksh, record):
    """K8 at one channel of the CSHOT step: against its twin on the card
    (the same sums in another order: relative delta <= 1e-5) and, on the
    first 1024 rows, against the CPU twin bit for bit (the same order);
    timed with the twin and one scatter_add_ over the five slots."""
    import torch
    *arrays, n_bin = args
    r, m = arrays[0].shape
    h = ksh.shot_hist(*arrays, n_bin)
    p = ksh.shot_hist_plain(*arrays, n_bin)
    err = (h - p).abs().max()
    rel = float(err / p.abs().max().clamp(min=1e-30))
    sub = ksh.shot_hist_plain(*(a[:1024].cpu() for a in arrays), n_bin)
    exact = bool(torch.equal(h[:1024].cpu(), sub))
    d, s, cw, cb, cosw, rv, rw, iv, iw, av, aw = arrays
    live = int(((cw != 0) | (cosw != 0) | (rw != 0) | (iw != 0)
                | (aw != 0)).sum())
    print(f"{'':20s} n_bin {n_bin}: {r} rows x {m} columns, live-column "
          f"share {live / (r * m):.4f}; kernel vs twin relative delta "
          f"{rel:.3e}; first 1024 rows equal to the CPU twin: {exact}")
    assert rel <= 1e-5 and exact, f"K8 differs from its twin (n_bin {n_bin})"
    # the library call: one scatter_add_ over the five slots side by side
    length = 32 * n_bin
    flat = torch.cat([d * n_bin + s, d * n_bin + cb, rv * n_bin + s,
                      iv * n_bin + s, av * n_bin + s], 1).long()
    wcat = torch.cat([cw, cosw, rw, iw, aw], 1)
    lib = cuda_ms(lambda: torch.zeros(r, length, device=flat.device)
                  .scatter_add_(1, flat, wcat), 5)
    del flat, wcat
    record("shot_hist", err, cuda_ms(lambda: ksh.shot_hist(*arrays, n_bin), 5),
           cuda_ms(lambda: ksh.shot_hist_plain(*arrays, n_bin), 2),
           f"CSHOT n_bin {n_bin} R={r} M={m}",
           5 * r * m * 4 + 6 * live * 4 + r * length * 4,
           5 * r * m + 5 * live, lib)


def hist_k9(idx, w, khist, record):
    """K9 at the SHORT_SHOT step: as hist_k8, with one scatter_add_."""
    import torch
    r, c = idx.shape
    h = khist.histogram(idx, w, 32)
    p = khist.histogram_plain(idx, w, 32)
    err = (h - p).abs().max()
    rel = float(err / p.abs().max().clamp(min=1e-30))
    exact = bool(torch.equal(h[:1024].cpu(), khist.histogram_plain(
        idx[:1024].cpu(), w[:1024].cpu(), 32)))
    live = int((w != 0).sum())
    print(f"{'':20s} {r} rows x {c} entries, live share {live / (r * c):.4f}"
          f"; kernel vs twin relative delta {rel:.3e}; first 1024 rows "
          f"equal to the CPU twin: {exact}")
    assert rel <= 1e-5 and exact, "K9 differs from its twin"
    il = idx.long()
    lib = cuda_ms(lambda: torch.zeros(r, 32, device=w.device)
                  .scatter_add_(1, il, w), 5)
    del il
    record("histogram", err, cuda_ms(lambda: khist.histogram(idx, w, 32), 5),
           cuda_ms(lambda: khist.histogram_plain(idx, w, 32), 2),
           f"SHORT_SHOT R={r} C={c} L=32",
           r * c * 4 + live * 4 + r * 32 * 4, r * c + live, lib)


def serve_files(serve, model_path, clouds, labels, extra, colours=None):
    """serve.main --device cuda over PCD files of `clouds` (painted by
    `colours`, when given); returns its output after checking one
    prediction line per cloud."""
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    tmp = tempfile.mkdtemp(prefix="pcd_smoke_")
    try:
        shutil.copy(model_path, os.path.join(tmp, "model.ism"))
        shutil.copy(model_path + "d.npz", os.path.join(tmp, "model.ismd.npz"))
        lines = ["# test"]
        for i, (cloud, label) in enumerate(zip(clouds, labels)):
            path = os.path.join(tmp, f"c{i}.pcd")
            save_pcd(path, cloud,
                     rgb=None if colours is None else colours(cloud))
            lines.append(f"{path} {label}")
        flist = os.path.join(tmp, "test.txt")
        with open(flist, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["-d", os.path.join(tmp, "model.ism"), "-f", flist,
                             "--device", "cuda", "--batch", str(len(clouds)),
                             *extra])
    finally:
        shutil.rmtree(tmp)
    text = out.getvalue()
    print(text.rstrip())
    preds = re.findall(r": predicted (\d+), ground truth (\d+) ", text)
    assert rc == 0 and len(preds) == len(clouds), \
        f"serve did not report {len(clouds)} predictions"
    return text


if __name__ == "__main__":
    main()
