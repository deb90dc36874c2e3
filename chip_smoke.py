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
     clouds x 192 keypoints), and K7 also at 1 and 8 clouds; K1 and K2
     (the cell-binned sweep, K1 also at the detection batch, B=32; the
     bits of their outputs), K3 and K7 (compacted in-radius pairs into
     warp-owned histograms, with their swept pairs and in-radius share;
     K7 also beside one scatter_add_ over SHOT's slot arrays), K4
     (register-tiled, also at CSHOT's D=1344 and at the training
     self-kNN, Q=C=2000), K5 and K6 (the binned sweep over the windows,
     K5 beside K1 on the same sorted batch) each beside its previous
     design's time, its bound (K4 also its special-function floor) and
     torch.profiler's device time, with two launches bit-equal;
  2c. K8 and K9, which bin the CSHOT and SHORT_SHOT pairs on chip, at
     those steps' shapes (the 128 bench clouds, coloured by
     tests/bench_data.bench_colors, 128 x 192 keypoints x 2048 points)
     against their twins (the slot arrays, then their histograms), with
     their swept pairs and in-radius share, two launches bit-equal, each
     timed beside its previous design's time (the slot-array kernel, plus
     the slot build timed here), its bound, torch.profiler's device time,
     the twin, one scatter_add_ over the slot arrays and the eager slot
     build plus that scatter_add_;
  2d. K10 (and K11) at the v2 LRF passes' shapes -- the serving normals
     (Q=N=2048, K10 with K2 z-only), the training normals' full LRF
     (Q=N=2048, K11) and the keypoint LRFs (Q=192) -- against their twins
     and against K1 / K2 (K11: the rows whose votes differ from the
     twin's), timed beside their twins, K1 / K2 and their previous
     designs, with their bounds and torch.profiler's device time, two
     launches of each bit-equal, the bits of K10's and K11's outputs, and
     K10's uniform weighting against its twin at the keypoint LRFs'
     shape;
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
     committed JAX-CPU detect_maxima_jit reference, two runs equal; then
     serve --maxima --device cuda on 8 PCD files;
  5b. serve --device cuda with the CSHOT model on 8 coloured PCD files, and
     its --maxima refusal;
  7. the CSHOT classify step: IsmClassifier with the committed CSHOT
     codebook on the coloured 128-cloud batch -- per-stage ms, clouds/s,
     peak device memory, K8 launched once, decisions against the committed
     JAX-CPU reference, accuracy, two runs equal;
  8. the SHORT_SHOT classify step, the same with its codebook: K9 launched,
     K1/K2 once each (keypoint LRFs only: no normal stage);
  9. training on the card: the five bench training clouds through
     ImplicitShapeModel.train (SHOT with K1/K2 and with
     PCD_PALLAS_LRF_V=2, CSHOT, SHORT_SHOT) against the committed
     JAX-trained codebooks, each served on the bench batch against the
     committed references, and whether a second SHOT training gives the
     same codebook bit for bit (printed); training clouds/s on 24 clouds;
     the train entry point on 8 PCD files, then serve on its model.
Every step of phases 4-8 also prints its peak device memory, and phase 2
the bits (sha256) of K1's, K2's, K3's and K6's outputs and of K7's
in-radius counts and histograms (tests/port_fingerprint.py prints the
same for any checkout).
Before the last line it prints one JSON line with every kernel's launches
(summed over one run of each path, counted from 0 just before each),
error against its twin, times and bound, then the card's name and power
limit.  The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import hashlib
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
    "lrf_moments_v2": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
                       "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:161"),
    "sign_votes_v2": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
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
# 700 W).  The operations are what this run's inputs need: a radius-gated
# kernel (K1, K2, K3, K5, K6, K7, K10, K11) is charged its in-radius pairs
# (counted from this run's data) times the gate (3 sub, 3 mul, 2 add, 2
# compares) and the body, not the gate on every pair it sweeps, so a
# function has one bound whatever implements it (K10 is charged as K1,
# K11 as K2).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The special-function unit (reciprocal, sqrt) issues 16 results a clock
# per SM against 128 fp32 lanes: 1/16 of the fp32 peak's 2 x 128 flops a
# clock (132 SMs at the data sheet's 1.98 GHz).
SFU_OPS_PER_S = FP32_OPS_PER_S / (2 * 128) * 16
GATE_OPS = 10
MOMENT_BODY_OPS = 21   # sqrt, r - d, w p (3), s0 + s1 (4), s2 (6 mul, 6 add)
VOTE_BODY_OPS = 6      # one (p - q) . axis (3 mul, 2 add) and its compare
SHOT_BODY_OPS = 100    # frame coords, cosine, binning, 5 slot adds;
#                        sqrtf, acosf and atan2f count one each
CHISQ_TERM_OPS = 6     # a + b, a - b, square, divide, compare, accumulate
CSHOT_BODY_OPS = 130   # SHOT's body, the colour distance (~12) and the
#                        colour channel's soft bin and weight (~8), five
#                        more slot adds
SHORT_SHOT_BODY_OPS = 75   # frame coords (15), r (6), theta and phi (7),
#                            three raw bins (9), bins and interpolation
#                            (~20), four weights (~12), four adds
# Times of the previous designs -- K1's and K2's all-pairs sweeps, K3's
# threads over points with shared-memory atomics, K4's one thread per
# (descriptor, codeword) pair at the dense step's shapes; K8 (both
# channels) and K9 over slot arrays at the CSHOT and SHORT_SHOT steps'
# shapes, not counting the slot build; K5's and K6's all-pairs sweeps of
# the windows and K10's dense bf16x3 mma.sync tiles at their steps'
# shapes; K7's threads over points with atomic sums (and its point-chunk
# split) at 32, 1 and 8 clouds; K11's one thread per query over the whole
# cloud at the training normals' full LRF and the keypoint LRFs -- from
# PERF.md's kernel table and findings (H100 80GB HBM3 at 700 W), printed
# beside this run's
PREVIOUS_MS = {"K1 normals": 0.834, "K1 keypoints": 0.279,
               "K4 serving": 2.079, "K2 normals": 0.482,
               "K2 keypoints": 0.170, "K3 serving": 0.874,
               "K8 CSHOT": 0.684 + 0.715, "K9 SHORT_SHOT": 0.829,
               "K5 windowed": 0.441, "K10 normals": 1.184,
               "K10 keypoints": 0.180, "K6 windowed": 0.271,
               "K7 detect": 0.277, "K7 B=1": 0.1225, "K7 B=8": 0.1057,
               "K11 keypoints": 0.180, "K11 full-LRF normals": 0.580}

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


def device_ms(fn, kernel, reps):
    """Mean device time of the CUDA kernels whose name holds `kernel` over
    reps calls of fn, from torch.profiler (CUDA events around back-to-back
    calls also count the host's time per call when a kernel is shorter
    than it); None where the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def digest(*tensors):
    """sha256 (16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes, ops):
    """(least ms, what bounds it) of a call moving nbytes with ops fp32
    operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
    from port_fingerprint import lrf_bits, lrf_v2_bits
    from point_cloud_donkey_tpu_torch import serve
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.codebook import (
        CodebookParams, load_codebook)
    from point_cloud_donkey_tpu_torch.models.pipeline import (
        DETECT_STAGES, STAGES, IsmClassifier, IsmDetector, PipelineConfig)
    from point_cloud_donkey_tpu_torch.ops import binned
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops import shot as kshot_ops
    from point_cloud_donkey_tpu_torch.ops import short_shot as kss_ops
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

    def record(name, err, ms, plain_ms, what, nbytes_, ops, library_ms=None):
        """One main-path call of a kernel: error vs its twin, times (and
        the one PyTorch call's time, where there is one), and its bound from
        this call's bytes and operations."""
        r = report[name]
        r["err"] = max(r["err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        b_ms, by = bound(nbytes_, ops)
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

    def k1_check(q, p, pmask, q_mask, radius, what, mom, cnt, pmom, pcnt,
                 timed=False, previous=None):
        """K1 (or K5) against its twin -- weight sums rtol 2e-4, counts +-1,
        covariance atol 5e-4 -- and, if timed, K1 launched twice (bit-equal)
        and timed beside its bound and its previous design's time
        (PREVIOUS_MS[previous], where given).  Returns (covariance, K1's ms or None)."""
        s0, ps0 = mom[..., 0], pmom[..., 0]
        rel = ((s0 - ps0).abs() / ps0.abs().clamp(min=1e-6)).max()
        assert rel <= 2e-4, f"K1 weight sums off by rtol {rel:.2e} ({what})"
        assert (cnt - pcnt).abs().max() <= 1, f"K1 counts ({what})"
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        pcov, _ = klrf.cov_from_moments(pmom, q, q_mask)
        cerr = (cov - pcov).abs().max()
        assert cerr <= 5e-4, f"K1 covariance off by {cerr:.2e} ({what})"
        if not timed:
            return cov, None
        again = klrf.moments(q, p, pmask, radius)
        assert torch.equal(mom, again[0]) and torch.equal(cnt, again[1]), \
            f"two K1 launches differ ({what})"
        ms = cuda_ms(lambda: klrf.moments(q, p, pmask, radius), 20)
        dev_ms = device_ms(lambda: klrf.moments(q, p, pmask, radius),
                           "MomentsBody", 20)
        b_ms, by = bound(nbytes(q, p, pmask, mom, cnt),
                         int(cnt.sum()) * (GATE_OPS + MOMENT_BODY_OPS))
        before = (f"previous design {PREVIOUS_MS[previous]:.3f} ms, "
                  if previous else "")
        print(f"{'lrf_moments':20s} {what}: binned sweep {ms:.4f} ms, device "
              f"{fmt_ms(dev_ms)} ({before}"
              f"bound {b_ms:.4f} ms by {by}); rtol {float(rel):.2e}, counts "
              f"+-{int((cnt - pcnt).abs().max())}, covariance "
              f"{float(cerr):.2e}; two launches bit-equal ({card})",
              flush=True)
        return cov, ms

    def lrf_pair(queries, q_mask, radius, z_only, what, starts=None,
                 window=0, previous=None):
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
        cov, ms = k1_check(q, p, mask_l, q_mask, radius, what, mom, cnt, pmom,
                           pcnt, timed=starts is None, previous=previous)
        pairs = q.shape[0] * q.shape[1] * swept
        inside = int(cnt.sum())
        if starts is not None:
            again = mom_fn()
            assert torch.equal(mom, again[0]) and torch.equal(cnt, again[1]), \
                f"two K5 launches differ ({what})"
            ms = cuda_ms(mom_fn, 20)
            dev_ms = device_ms(mom_fn, "MomentsBody", 20)
            k1_ms = cuda_ms(lambda: klrf.moments(q, p, mask_l, radius), 20)
            b_ms, by = bound(nbytes(q, p, mask_l, mom, cnt, starts),
                             inside * (GATE_OPS + MOMENT_BODY_OPS))
            print(f"{'lrf_moments_windowed':20s} {what}: binned sweep of the "
                  f"windows {ms:.4f} ms, device {fmt_ms(dev_ms)}; K1 over all "
                  f"N on the same batch {k1_ms:.4f} ms (previous design "
                  f"{PREVIOUS_MS['K5 windowed']:.3f} ms, bound {b_ms:.4f} ms "
                  f"by {by}); two launches bit-equal ({card})", flush=True)
        print(f"{'':20s} {what}: {pairs:.3e} pairs swept, in-radius share "
              f"{inside / pairs:.4f}")
        extra = (starts,) if starts is not None else ()
        record(k_mom, (mom - pmom).abs().max(),
               ms if ms is not None else cuda_ms(mom_fn, 5),
               cuda_ms(lambda: mom_fn(plain=True), 2), what,
               nbytes(q, p, mask_l, mom, cnt, *extra),
               inside * (GATE_OPS + MOMENT_BODY_OPS))
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        v = vote_fn(axes)
        pv = vote_fn(axes, plain=True)
        err = (v - pv).abs().max()
        assert err <= 1, f"K2/K6 votes off by {err} ({what})"
        vote_bytes = nbytes(q, p, mask_l, axes, v, *extra)
        vote_ops = inside * (GATE_OPS + VOTE_BODY_OPS * (1 if z_only else 2))
        if starts is None:
            assert torch.equal(v, vote_fn(axes)), \
                f"two K2 launches differ ({what})"
            vms = cuda_ms(lambda: vote_fn(axes), 20)
            dev_ms = device_ms(lambda: vote_fn(axes), "VotesBody", 20)
            b_ms, by = bound(vote_bytes, vote_ops)
            before = (f"previous design "
                      f"{PREVIOUS_MS[previous.replace('K1', 'K2')]:.3f} ms, "
                      if previous else "")
            print(f"{'sign_votes':20s} {what}: binned sweep {vms:.4f} ms, "
                  f"device {fmt_ms(dev_ms)} ({before}bound {b_ms:.4f} ms by "
                  f"{by}); votes +-{int(err)}; two launches bit-equal "
                  f"({card})", flush=True)
        else:
            assert torch.equal(v, vote_fn(axes)), \
                f"two K6 launches differ ({what})"
            vms = cuda_ms(lambda: vote_fn(axes), 20)
            dev_ms = device_ms(lambda: vote_fn(axes), "VotesBody", 20)
            b_ms, by = bound(vote_bytes, vote_ops)
            print(f"{'sign_votes_windowed':20s} {what}: binned sweep of the "
                  f"windows {vms:.4f} ms, device {fmt_ms(dev_ms)} (previous "
                  f"design {PREVIOUS_MS['K6 windowed']:.3f} ms, bound "
                  f"{b_ms:.4f} ms by {by}); votes +-{int(err)}; two launches "
                  f"bit-equal ({card})", flush=True)
            print(f"{'sign_votes_windowed':20s} output bits: sha256 "
                  f"{digest(v)}")
        record(k_vote, err, vms,
               cuda_ms(lambda: vote_fn(axes, plain=True), 2), what,
               vote_bytes, vote_ops)
        return cnt

    pts_l, mask_l = pts, mask
    with torch.no_grad():
        lrf_pair(pts, mask, cfg.normal_radius, True,
                 f"normals B={BATCH} Q=N={pts.shape[1]}",
                 previous="K1 normals")
        normals = compute_normals_fast(pts, mask, cfg.normal_radius)
        kres = voxel_grid(pts, mask, cfg.leaf_size,
                          capacity=cfg.keypoint_capacity)
        kp = torch.where(kres.mask[..., None], kres.centroids,
                         torch.full_like(kres.centroids, 1e9))
        lrf_pair(kp, kres.mask, cfg.ref_frame_radius, False,
                 f"keypoint LRF B={BATCH} Q={kp.shape[1]}",
                 previous="K1 keypoints")
        print(f"{'lrf_moments':20s} output bits (K1 and K2, normals and "
              f"keypoint LRFs): {json.dumps(lrf_bits(pts, mask, kp, kres.mask, cfg))}")
        # K1 at the detection batch's shapes (B=32): timed, not recorded
        for queries, q_mask, radius, what in (
                (pts, mask, cfg.normal_radius, "normals"),
                (kp, kres.mask, cfg.ref_frame_radius, "keypoint LRF")):
            qb, mb = queries[:MS_BATCH], q_mask[:MS_BATCH]
            q32, p32 = klrf.prep_shift(qb, pts[:MS_BATCH], mask[:MS_BATCH])
            m32 = mask[:MS_BATCH].contiguous()
            mom, cnt = klrf.moments(q32, p32, m32, radius)
            pmom, pcnt = klrf.moments_plain(q32, p32, m32, radius)
            k1_check(q32, p32, m32, mb, radius,
                     f"{what} B={MS_BATCH} Q={qb.shape[1]}", mom, cnt, pmom,
                     pcnt, timed=True)
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
        cos, off = contract(got, normalize_descriptors(phist, pcnt, fv_rows),
                            "K3")
        again = kshot.shot_tiles(*shot_args)
        assert torch.equal(hist, again[0]) and torch.equal(cnt, again[1]), \
            "two K3 launches differ"
        k3_ms = cuda_ms(lambda: kshot.shot_tiles(*shot_args), 20)
        k3_dev = device_ms(lambda: kshot.shot_tiles(*shot_args),
                           "CompactTiles", 20)
        k3_bytes = nbytes(kp_rows, fr_rows, tile_cloud, pts, normals, mask,
                          hist, cnt)
        k3_ops = int(cnt.sum()) * (GATE_OPS + SHOT_BODY_OPS)
        b_ms, by = bound(k3_bytes, k3_ops)
        pairs = tile_cloud.shape[0] * kshot.TK * pts.shape[1]
        print(f"{'shot_fused':20s} SHOT {tile_cloud.shape[0]} tiles: "
              f"{pairs:.3e} pairs swept, in-radius share "
              f"{int(cnt.sum()) / pairs:.4f}; warp-owned histograms "
              f"{k3_ms:.4f} ms, device {fmt_ms(k3_dev)} (previous design "
              f"{PREVIOUS_MS['K3 serving']:.3f} ms, bound {b_ms:.4f} ms by "
              f"{by}); counts equal, cosine min {cos:.7f}, "
              f"{off:.2e} of entries off by > 1e-3; two launches "
              f"bit-equal ({card})", flush=True)
        print(f"{'shot_fused':20s} output bits: sha256 {digest(hist, cnt)}")
        record("shot_fused", (hist - phist).abs().max(), k3_ms,
               cuda_ms(lambda: kshot.shot_tiles_plain(*shot_args), 2),
               f"SHOT {tile_cloud.shape[0]} tiles x N={pts.shape[1]}",
               k3_bytes, k3_ops)

        desc = got.descriptors[got.valid].contiguous()
        cw, cw_mask = codebook.codewords, codebook.cw_mask

        def k4_check(a, b, b_mask, k, what, previous=None):
            """K4 against its twin (distances rtol 1e-5, indices equal
            except ties), two launches bit-equal, timed beside its fp32
            bound and its special-function floor (one reciprocal a term);
            returns (error, ms, plain ms, bytes, ops)."""
            d, i = kchisq.chisq_topk(a, b, b_mask, k)
            d2, i2 = kchisq.chisq_topk(a, b, b_mask, k)
            assert torch.equal(d, d2) and torch.equal(i, i2), \
                f"two K4 launches differ ({what})"
            pd, pi = kchisq.chisq_topk_plain(a, b, b_mask, k)
            rel = ((d - pd).abs() / pd.abs().clamp(min=1e-6)).max()
            assert rel <= 1e-5, f"K4 distances off by rtol {rel:.2e} ({what})"
            differ = i != pi
            assert torch.allclose(d[differ], pd[differ], rtol=1e-5), \
                f"K4 indices differ beyond ties ({what})"
            ms = cuda_ms(lambda: kchisq.chisq_topk(a, b, b_mask, k), 20)
            dev_ms = device_ms(lambda: kchisq.chisq_topk(a, b, b_mask, k),
                               "chisq_topk_kernel", 20)
            pms = cuda_ms(lambda: kchisq.chisq_topk_plain(a, b, b_mask, k), 2)
            terms = a.shape[0] * b.shape[0] * a.shape[1]
            ops = terms * CHISQ_TERM_OPS + a.shape[0] * b.shape[0]
            nb = nbytes(a, b, b_mask, d, i)
            b_ms, by = bound(nb, ops)
            before = (f"previous design {PREVIOUS_MS[previous]:.3f} ms, "
                      if previous else "")
            print(f"{'chisq_topk':20s} {what}: kernel {ms:.4f} ms, device "
                  f"{fmt_ms(dev_ms)} ({before}"
                  f"plain {pms:.3f} ms), bound {b_ms:.4f} ms by {by}, "
                  f"special-function floor {terms / SFU_OPS_PER_S * 1e3:.4f} "
                  f"ms; rtol {float(rel):.2e}, {int(differ.sum())} tied "
                  f"indices differ; two launches bit-equal ({card})",
                  flush=True)
            return (d - pd).abs().max(), ms, pms, nb, ops

        for k in (1, 3):
            what = f"Q={desc.shape[0]} C={cw.shape[0]} D=352 k={k}"
            res = k4_check(desc, cw, cw_mask, k, what,
                           "K4 serving" if k == 1 else None)
            if k == 1:    # the main path's k
                record("chisq_topk", res[0], res[1], res[2], "chisq " + what,
                       res[3], res[4])
        # CSHOT's width (D=1344) against its codebook, at the serving
        # descriptor count (the kernel's work does not depend on the values:
        # sparse non-negative rows made from a seed), and the training
        # self-kNN (Q=C=2000 SHOT descriptors against themselves)
        ccb = load_codebook(os.path.join(data, "cshot_codebook.ism")).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        cq = torch.rand(desc.shape[0], ccb.codewords.shape[1], device=dev,
                        generator=gen)
        cq = torch.where(cq < 0.6, torch.zeros_like(cq), cq)
        cq = (cq / cq.sum(1, keepdim=True)).contiguous()
        k4_check(cq, ccb.codewords, ccb.cw_mask, 1,
                 f"CSHOT Q={cq.shape[0]} C={ccb.codewords.shape[0]} "
                 f"D={cq.shape[1]} k=1")
        self_q = desc[:2000].contiguous()
        k4_check(self_q, self_q, torch.ones(len(self_q), dtype=torch.bool,
                                            device=dev), 1,
                 "training self-kNN Q=C=2000 D=352 k=1")
        del cq, ccb

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
        cos, off = contract(normalize_descriptors(dh, dc, mlrf.valid),
                            normalize_descriptors(pdh, pdc, mlrf.valid), "K7")
        again = kshot.shot_dense(*dense_args)
        assert torch.equal(dh.view(torch.int32),
                           again[0].view(torch.int32)) and \
            torch.equal(dc, again[1]), "two K7 launches differ"
        live = int(mlrf.valid.sum())
        b7, k7 = mlrf.valid.shape
        ctas = b7 * -(-k7 // kshot.TK)
        k7_ms = cuda_ms(lambda: kshot.shot_dense(*dense_args), 20)
        k7_dev = device_ms(lambda: kshot.shot_dense(*dense_args),
                           "DenseTiles", 20)
        k7_bytes = nbytes(*dense_args[:6], dh, dc)
        k7_ops = int(dc.sum()) * (GATE_OPS + SHOT_BODY_OPS)
        b_ms, by = bound(k7_bytes, k7_ops)
        swept = live * mp.shape[1]
        print(f"{'shot_dense':20s} SHOT B={b7} K={k7} ({ctas} CTAs, {live} "
              f"live rows): {swept:.3e} live pairs, in-radius share "
              f"{int(dc.sum()) / swept:.4f}; warp-owned histograms "
              f"{k7_ms:.4f} ms, device {fmt_ms(k7_dev)} (previous design "
              f"{PREVIOUS_MS['K7 detect']:.3f} ms, bound {b_ms:.4f} ms by "
              f"{by}); counts equal, cosine min {cos:.7f}, {off:.2e} of "
              f"entries off by > 1e-3; two launches bit-equal ({card})",
              flush=True)
        # K7 at a single cloud and a small serving batch, where the grid
        # (24 and 192 CTAs) fills a fraction of the card
        for nb in (1, 8):
            args_b = tuple(a[:nb].contiguous() for a in dense_args[:6]) \
                + (cfg.radius,)
            hb, cb = kshot.shot_dense(*args_b)
            assert torch.equal(cb, dc[:nb]) and torch.equal(hb, dh[:nb]), \
                f"K7 at B={nb} differs from its rows at B={MS_BATCH}"
            ms_b = cuda_ms(lambda: kshot.shot_dense(*args_b), 20)
            print(f"{'shot_dense':20s} B={nb} ({nb * -(-k7 // kshot.TK)} "
                  f"CTAs): {ms_b:.4f} ms (previous design "
                  f"{PREVIOUS_MS[f'K7 B={nb}']:.4f} ms); equal to its rows "
                  f"at B={MS_BATCH} ({card})", flush=True)
        print(f"{'shot_dense':20s} output bits (B={MS_BATCH}): counts "
              f"sha256 {digest(dc)}, histograms sha256 {digest(dh)}")
        k7_lib = shot_slot_library(dense_args, kshot_ops, card)
        record("shot_dense", (dh - pdh).abs().max(), k7_ms,
               cuda_ms(lambda: kshot.shot_dense_plain(*dense_args), 2),
               f"SHOT {ctas} CTAs, {live} live", k7_bytes, k7_ops, k7_lib)

    # -- 2c. K8 / K9 at the CSHOT and SHORT_SHOT steps' shapes -------------
    phase(f"2c. K8 / K9 (pairs binned on chip) vs plain twins, the slot "
          f"arrays and scatter_add_ on the card ({card})")
    rgb = torch.from_numpy(bench_colors(clouds)).to(dev)
    with torch.no_grad():
        ck = voxel_grid(pts, mask, cfg.leaf_size,
                        capacity=cfg.keypoint_capacity, features=rgb)
        ckp = torch.where(ck.mask[..., None], ck.centroids[..., :3],
                          torch.full_like(ck.centroids[..., :3], 1e9))
        clrf = shot_lrf(ckp, ck.mask, pts, mask, cfg.ref_frame_radius)
        fused_k8((ckp.contiguous(),
                  rgb_to_cielab_normalized(ck.centroids[..., 3:6]),
                  clrf.frames.contiguous(), clrf.valid.contiguous(), pts,
                  normals, rgb_to_cielab_normalized(rgb), mask, cfg.radius),
                 ksh, kshot_ops, record, card)
        fused_k9((ckp.contiguous(), clrf.frames.contiguous(),
                  clrf.valid.contiguous(), pts, mask, cfg.radius), khist,
                 kss_ops, record, card)
        del ck, ckp, clrf

    # -- 2d. K10 / K11 at the main paths' shapes ----------------------------
    phase(f"2d. K10 / K11 vs plain twins and vs K1 / K2 on the card ({card})")

    def moments_v2_check(q, p, q_mask, radius, what, mom, cnt, cov, inside,
                         previous):
        """K10's moments against its twin and against K1, two launches
        bit-equal, timed beside both and its previous design
        (PREVIOUS_MS[previous]) and recorded."""
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
        again = klrf.moments_v2(q, p, mask, radius)
        assert torch.equal(mom, again[0]) and torch.equal(cnt, again[1]), \
            f"two K10 launches differ ({what})"
        k1_ms = cuda_ms(lambda: klrf.moments(q, p, mask, radius), 20)
        ms = cuda_ms(lambda: klrf.moments_v2(q, p, mask, radius), 20)
        dev_ms = device_ms(lambda: klrf.moments_v2(q, p, mask, radius),
                           "MomentsV2Body", 20)
        print(f"{'':20s} {what}: K10 (binned sweep) {ms:.4f} ms, device "
              f"{fmt_ms(dev_ms)}, K1 {k1_ms:.4f} ms at the same inputs "
              f"(previous design {PREVIOUS_MS[previous]:.3f} ms); two "
              f"launches bit-equal ({card})")
        record("lrf_moments_v2", (mom - pmom).abs().max(), ms,
               cuda_ms(lambda: klrf.moments_v2_plain(q, p, mask, radius), 2),
               what, nbytes(q, p, mask, mom, cnt),
               inside * (GATE_OPS + MOMENT_BODY_OPS))

    def lrf_v2(queries, q_mask, radius, z_only, what, moments=None,
               votes=None):
        """K10 (and K11 unless z_only: the z-only normals vote with K2)
        at one main-path call against its twin -- moments: weight sums
        rtol 2e-4, counts +-1, covariance atol 5e-4; votes +-1 -- and
        against K1 / K2 to the JAX package's v1-vs-v2 contract
        (tests/test_pallas_kernels.py:101-125): the same, valid flags
        equal, >= 97% of frames with every axis at |cos| > 0.999.  moments
        names K10's previous-design time (PREVIOUS_MS) where K10 is held and
        recorded here; without it, K10 is held and recorded by another call
        at the same shape (its moments do not depend on z_only), and only
        its covariance feeds K11 here.  votes names K11's previous-design
        time where K11 runs (not z_only)."""
        q, p = klrf.prep_shift(queries, pts, mask)
        mom, cnt = klrf.moments_v2(q, p, mask, radius)
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        inside = int(cnt.sum())
        if moments:
            moments_v2_check(q, p, q_mask, radius, what, mom, cnt, cov,
                             inside, moments)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        if not z_only:
            v = klrf.sign_votes_v2(q, p, mask, axes, radius)
            pv = klrf.sign_votes_v2_plain(q, p, mask, axes, radius)
            err = int((v - pv).abs().max())
            rows = int((v != pv).any(-1).sum())
            err1 = int((v - klrf.sign_votes(q, p, mask, axes, radius))
                       .abs().max())
            print(f"{'sign_votes_v2':20s} {what}: votes vs its twin +-{err} "
                  f"({rows} of {v.shape[0] * v.shape[1]} rows differ), vs "
                  f"K2 +-{err1}")
            assert err <= 1 and err1 <= 1, f"K11 votes differ ({what})"
            assert torch.equal(v, klrf.sign_votes_v2(q, p, mask, axes,
                                                     radius)), \
                f"two K11 launches differ ({what})"
            k2_ms = cuda_ms(lambda: klrf.sign_votes(q, p, mask, axes,
                                                    radius), 20)
            k2_dev = device_ms(lambda: klrf.sign_votes(q, p, mask, axes,
                                                       radius),
                               "VotesBody", 20)
            ms = cuda_ms(lambda: klrf.sign_votes_v2(q, p, mask, axes,
                                                    radius), 20)
            dev_ms = device_ms(lambda: klrf.sign_votes_v2(q, p, mask, axes,
                                                          radius),
                               "VotesV2Body", 20)
            v_bytes = nbytes(q, p, mask, axes, v)
            v_ops = inside * (GATE_OPS + 2 * VOTE_BODY_OPS)
            b_ms, by = bound(v_bytes, v_ops)
            print(f"{'':20s} {what}: K11 (binned sweep) {ms:.4f} ms, device "
                  f"{fmt_ms(dev_ms)} (previous design "
                  f"{PREVIOUS_MS[votes]:.3f} ms, bound {b_ms:.4f} ms by "
                  f"{by}); K2 {k2_ms:.4f} ms, device {fmt_ms(k2_dev)} at "
                  f"the same inputs; two launches bit-equal ({card})")
            record("sign_votes_v2", err, ms,
                   cuda_ms(lambda: klrf.sign_votes_v2_plain(
                       q, p, mask, axes, radius), 2), what, v_bytes, v_ops)
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
               f"normals B={BATCH} Q=N={pts.shape[1]}", "K10 normals")
        # the training normals: the full LRF, K11 at Q = N
        lrf_v2(pts, mask, cfg.normal_radius, False,
               f"full-LRF normals B={BATCH} Q=N={pts.shape[1]}",
               votes="K11 full-LRF normals")
        lrf_v2(kp, kres.mask, cfg.ref_frame_radius, False,
               f"keypoint LRF B={BATCH} Q={kp.shape[1]}", "K10 keypoints",
               "K11 keypoints")
        print(f"{'sign_votes_v2':20s} output bits (K10's moments and "
              f"counts, K11's votes on their axes; full-LRF normals and "
              f"keypoint LRFs): "
              f"{json.dumps(lrf_v2_bits(pts, mask, kp, kres.mask, cfg))}")
        # K10's uniform weighting (no main path calls it: the training
        # normals' uniform PCA covariance is ops/neighbors.radius_covariance)
        # at the keypoint LRFs' shape: its twin's contract, its weight sums
        # equal to its counts, two launches bit-equal
        q, p = klrf.prep_shift(kp, pts, mask)
        mom, cnt = klrf.moments_v2(q, p, mask, cfg.ref_frame_radius,
                                   "uniform")
        pmom, pcnt = klrf.moments_v2_plain(q, p, mask, cfg.ref_frame_radius,
                                           "uniform")
        assert torch.equal(mom, klrf.moments_v2(
            q, p, mask, cfg.ref_frame_radius, "uniform")[0]), \
            "two uniform K10 launches differ"
        assert torch.equal(mom[..., 0], cnt.to(mom.dtype)), \
            "uniform K10 weight sums differ from its counts"
        rel = ((mom[..., 0] - pmom[..., 0]).abs()
               / pmom[..., 0].abs().clamp(min=1e-6)).max()
        cov, _ = klrf.cov_from_moments(mom, q, kres.mask)
        pcov, _ = klrf.cov_from_moments(pmom, q, kres.mask)
        cerr = (cov - pcov).abs().max()
        dc = int((cnt - pcnt).abs().max())
        print(f"{'lrf_moments_v2':20s} uniform keypoint LRF B={BATCH} "
              f"Q={kp.shape[1]} vs its twin: weight sums rtol "
              f"{float(rel):.2e}, counts +-{dc}, covariance {float(cerr):.2e}; "
              f"two launches bit-equal")
        assert rel <= 2e-4 and dc <= 1 and cerr <= 5e-4, \
            "uniform K10 differs from its twin"

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
    assert launches["dense_v2"]["sign_votes_v2"] == 1, \
        f"K11 not launched once by the v2 step: {launches['dense_v2']}"
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
    with torch.no_grad():
        again = detector(mp, mm)
    assert torch.equal(dens.view(torch.int32), again[0].view(torch.int32)) \
        and torch.equal(pos.view(torch.int32), again[1].view(torch.int32)), \
        "two runs of the detection step differ"
    print("two runs of the step: densities and positions identical")
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
            assert launches[key]["shot_hist"] == 1, launches[key]
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

        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        build.reset_launch_counts()
        events["start"].record()
        out = model(pts, mask, *extra, on_stage=mark)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
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
    print(f"peak device memory of the step: {peak / 2**20:.1f} MiB "
          f"({(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} "
          f"MiB held before it) ({card})")
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
        # a second training on the same files: the same codebook bit for
        # bit?  (printed, not asserted: PERF.md names what differs)
        twice, _ = run("SHOT", shot_items, None)
        a, b = ism.state.codebook._asdict(), twice.state.codebook._asdict()
        differ = [key for key in a if not np.array_equal(
            np.asarray(a[key]), np.asarray(b[key]), equal_nan=True)]
        print(f"two SHOT trainings on the same files: codebooks equal bit "
              f"for bit {not differ}; fields that differ: {differ}")

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
        got = launches["train_v2"]
        # per chunk: the normals' full LRF and the keypoint LRFs
        assert got["sign_votes_v2"] == got["lrf_moments_v2"] and \
            got["sign_votes_v2"] % 2 == 0, \
            f"K11 not launched twice a chunk: {got}"
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


def contract(got, want, what):
    """The descriptor contract between two (descriptors, valid) pairs:
    validity equal, cosine > 0.999 and fewer than 1e-4 of the entries off
    by more than 1e-3 on the valid rows; returns (min cosine, share
    off)."""
    assert bool((got[1] == want[1]).all()), f"{what}: validity differs"
    both = got[1] & want[1]
    a, b = got[0][both], want[0][both]
    cos = float((a * b).sum(-1).min())
    off = float(((a - b).abs() > 1e-3).float().mean())
    assert cos > 0.999 and off < 1e-4, f"{what}: cosine {cos}, {off} off"
    return cos, off


def slot_library(name, slots, length, rows, card):
    """The library yardsticks of K8 / K9: one scatter_add_ over the slot
    arrays that `slots()` builds (a list of (flat index [R, M], weight
    [R, M]), one a slot), and the eager slot build plus that scatter_add_;
    returns (scatter ms, build + scatter ms)."""
    import torch

    def flat():
        pairs = slots()
        return (torch.cat([i for i, _ in pairs], 1).long(),
                torch.cat([w for _, w in pairs], 1))

    idx, w = flat()
    dev = w.device
    scatter = cuda_ms(lambda: torch.zeros(rows, length, device=dev)
                      .scatter_add_(1, idx, w), 5)
    del idx, w
    total = cuda_ms(lambda: torch.zeros(rows, length, device=dev)
                    .scatter_add_(1, *flat()), 3)
    print(f"{name:20s} library: one scatter_add_ over the slot arrays "
          f"{scatter:.4f} ms; the eager slot build plus that scatter_add_ "
          f"{total:.4f} ms ({card})", flush=True)
    return scatter, total


def shot_slot_library(args, shot_ops, card):
    """K7's library yardstick: one scatter_add_ over SHOT's five slot
    arrays (ops/shot.shot_bin_slots) of every (row, point) pair of the
    dense grid, weights zero where the pair is not used or its row is not
    live; returns its ms."""
    import torch
    kp, frames, live, pts, nrm, mask, radius = args
    b, k = live.shape
    n = pts.shape[1]

    def slots():
        d = pts[:, None] - kp[:, :, None]                    # [B, K, N, 3]
        d2 = (d * d).sum(-1)
        use = (d2 <= radius * radius) & (d2 > 1e-15) & live[..., None] \
            & (mask & torch.isfinite(nrm).all(-1))[:, None]
        loc = torch.einsum("bknc,bkac->bkna", d, frames)
        cos = torch.clamp((nrm[:, None] * frames[:, :, None, 2]).sum(-1),
                          -1.0, 1.0)
        out = []
        for idx, w in shot_ops.shot_bin_slots(
                *(x.reshape(-1) for x in (loc[..., 0], loc[..., 1],
                                           loc[..., 2], cos)),
                torch.sqrt(d2).reshape(-1), radius):
            keep = use.reshape(-1)
            out.append((torch.where(keep, idx, 0).reshape(b * k, n),
                        torch.where(keep, w, 0.0).reshape(b * k, n)))
        return out

    scatter, _ = slot_library("shot_dense", slots, shot_ops.DESC_LEN, b * k,
                              card)
    return scatter


def fused_k8(args, ksh, shot_ops, record, card):
    """K8 at the CSHOT step: against its twin on the card (counts equal,
    the descriptor contract), two launches bit-equal, timed with CUDA
    events and torch.profiler beside its previous design (PREVIOUS_MS plus
    this run's slot build), its bound by in-radius pairs, the twin and the
    library yardsticks."""
    import torch

    from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
    kp, kp_lab, frames, live, pts, nrm, lab, mask, radius = args
    h, c = ksh.cshot_hist(*args)
    h2, c2 = ksh.cshot_hist(*args)
    assert torch.equal(h, h2) and torch.equal(c, c2), "two K8 launches differ"
    ph, pc = ksh.cshot_hist_plain(*args)
    assert torch.equal(c, pc), "K8 in-radius counts differ from its twin"
    cos, off = contract(normalize_descriptors(h, c, live),
                        normalize_descriptors(ph, pc, live), "K8")
    ms = cuda_ms(lambda: ksh.cshot_hist(*args), 20)
    dev_ms = device_ms(lambda: ksh.cshot_hist(*args), "cshot_hist_kernel",
                       20)
    plain_ms = cuda_ms(lambda: ksh.cshot_hist_plain(*args), 2)
    nrm_ok = mask & torch.isfinite(nrm).all(-1)

    def slots():
        channels, _ = shot_ops.cshot_slot_arrays(kp, kp_lab, frames, pts,
                                                 nrm, lab, nrm_ok, radius)
        out = []
        for base, (d, st, cw, cb, cosw, rv, rw, iv, iw, av, aw, nb) in zip(
                (0, 32 * 11), channels):
            out += [(base + d * nb + st, cw), (base + d * nb + cb, cosw),
                    (base + rv * nb + st, rw), (base + iv * nb + st, iw),
                    (base + av * nb + st, aw)]
        return out

    build_ms = cuda_ms(lambda: shot_ops.cshot_slot_arrays(
        kp, kp_lab, frames, pts, nrm, lab, nrm_ok, radius), 3)
    b, k = live.shape
    lib_ms, _ = slot_library("shot_hist", slots, h.shape[-1], b * k, card)
    inside = int(c.sum())
    swept = int(live.sum()) * pts.shape[1]
    nb_ = nbytes(*args[:8], h, c)
    ops = inside * (GATE_OPS + CSHOT_BODY_OPS)
    b_ms, by = bound(nb_, ops)
    print(f"{'shot_hist':20s} CSHOT B={b} K={k} N={pts.shape[1]}: "
          f"{swept:.3e} pairs swept ({int(live.sum())} live rows), in-radius "
          f"share {inside / swept:.4f}; fused {ms:.4f} ms, device "
          f"{fmt_ms(dev_ms)} (previous design "
          f"{PREVIOUS_MS['K8 CSHOT']:.3f} ms + the slot build {build_ms:.3f} "
          f"ms, bound {b_ms:.4f} ms by {by}); counts equal, cosine min "
          f"{cos:.7f}, {off:.2e} of entries off by > 1e-3; two launches "
          f"bit-equal ({card})", flush=True)
    record("shot_hist", (h - ph).abs().max(), ms, plain_ms,
           f"CSHOT B={b} K={k} N={pts.shape[1]}", nb_, ops, lib_ms)


def fused_k9(args, khist, ss_ops, record, card):
    """K9 at the SHORT_SHOT step: as fused_k8 (its in-radius pairs counted
    here by distance, K9 returns no counts)."""
    import torch
    kp, frames, live, pts, mask, radius = args
    h = khist.short_shot_hist(*args)
    assert torch.equal(h, khist.short_shot_hist(*args)), \
        "two K9 launches differ"
    ph = khist.short_shot_hist_plain(*args, 2, 2, 8)

    def unit(x):
        norm = torch.linalg.norm(x, dim=-1, keepdim=True)
        d = x / norm.clamp(min=1e-30)
        return d, live & (norm[..., 0] > 0) & torch.isfinite(d).all(-1)

    cos, off = contract(unit(h), unit(ph), "K9")
    ms = cuda_ms(lambda: khist.short_shot_hist(*args), 20)
    dev_ms = device_ms(lambda: khist.short_shot_hist(*args),
                       "short_shot_hist_kernel", 20)
    plain_ms = cuda_ms(lambda: khist.short_shot_hist_plain(*args, 2, 2, 8),
                       2)

    def slots():
        idx, w = ss_ops.short_shot_slot_arrays(kp, frames, pts, mask, radius)
        return [(idx, w)]

    build_ms = cuda_ms(lambda: ss_ops.short_shot_slot_arrays(
        kp, frames, pts, mask, radius), 3)
    b, k = live.shape
    lib_ms, _ = slot_library("histogram", slots, h.shape[-1], b * k, card)
    d2 = ((pts[:, None] - kp[:, :, None]) ** 2).sum(-1)
    inside = int(((d2 <= radius * radius) & (d2 > 1e-15) & mask[:, None]
                  & live[..., None]).sum())
    del d2
    swept = int(live.sum()) * pts.shape[1]
    nb_ = nbytes(*args[:5], h)
    ops = inside * (GATE_OPS + SHORT_SHOT_BODY_OPS)
    b_ms, by = bound(nb_, ops)
    print(f"{'histogram':20s} SHORT_SHOT B={b} K={k} N={pts.shape[1]} "
          f"D={h.shape[-1]}: {swept:.3e} pairs swept, in-radius share "
          f"{inside / swept:.4f}; fused {ms:.4f} ms, device "
          f"{fmt_ms(dev_ms)} (previous design "
          f"{PREVIOUS_MS['K9 SHORT_SHOT']:.3f} ms + the slot build "
          f"{build_ms:.3f} ms, bound {b_ms:.4f} ms by {by}); cosine min "
          f"{cos:.7f}, {off:.2e} of entries off by > 1e-3; two launches "
          f"bit-equal ({card})", flush=True)
    record("histogram", (h - ph).abs().max(), ms, plain_ms,
           f"SHORT_SHOT B={b} K={k} N={pts.shape[1]} D=32", nb_, ops, lib_ms)


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
