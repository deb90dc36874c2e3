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
  2e. K3w, the windowed descriptor (K7's grid, each 8-keypoint tile over
     a window of its principal-axis-sorted cloud), at the windowed step's
     shapes (the sorted batch, 128 x 192 co-sorted keypoints) for the
     window required_window calibrates on the keypoints and for 1024 (an
     inexact plan): against its twin, two launches bit-equal, counts equal
     K7's on the same sorted inputs where the plan is exact, timed beside
     K3 and K7, its bound, torch.profiler's device time and one
     scatter_add_ over SHOT's slot arrays of the windows;
  2f. K4m, the [Q, C] chi-square matrix (K4's sweep with a storing
     epilogue), at the classify step's features against the bench
     codebook (D=352), its partial-SHOT front half (D=176) and at CSHOT's
     width (D=1344): against its twin, the k=64 selection under the k-NN
     contract, the k=1..3 selections equal to K4's fused top-k, two
     launches bit-equal, timed beside its bound and special-function
     floor, torch.profiler's device time, the selection's time and K4's
     time on the same inputs;
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
  4d. the windowed-descriptor classify step (descriptor_window, K3w), with
     and without the normals window, against the committed dense and
     windowed references; then descriptor_window 1024: the plan trips, K7
     recomputes the descriptor, the decisions hold;
  4e. the classify step (128 clouds) under every configuration of
     data/config_reference.npz -- KNN K=5, KNNRule, INN, Threshold,
     partial SHOT, normals methods 0, 1 and 3, and the CSHOT model under
     method 0 -- each against its committed JAX-CPU reference, two runs
     equal, with its launches (INN: 6 K4 launches a step; Threshold and
     K=5: one K4m and no K4);
  5. the serve entry point on 8 PCD files with --device cuda;
  5d. serve --device cuda on a `.off` mesh the script writes (a
     tessellated box), sampled on the fly;
  6. the mean-shift detection step: IsmDetector on the first 32 bench
     clouds -- per-stage ms, clouds/s, K7 launched, densities (decisions,
     rms and max relative delta) and the best class's maximum against the
     committed JAX-CPU detect_maxima_jit reference, two runs equal; then
     serve --maxima --device cuda on 8 PCD files;
  5b. serve --device cuda with the CSHOT model on 8 coloured PCD files, and
     its --maxima refusal;
  5c. the CSHOT classify step with the committed normals window (K5, K6,
     K8) against the committed JAX-CPU reference;
  6b. SHORT_SHOT detection (K9, no normals) on the first 32 bench clouds
     against the committed JAX-CPU reference, two runs equal, and serve
     --maxima with the SHORT_SHOT model on 8 PCD files;
  6d. detection under Threshold (K4m) on the first 32 bench clouds against
     the committed JAX-CPU reference, two runs equal: phase 6's bounds on
     every cloud whose votes' validity equals that from the plain twins'
     features; the others (where a descriptor, within the descriptor
     contract, moves a vote across the threshold or the 2-sigma gate), at
     most MOVED_MAX, are held to phase 6's bounds against the plain
     mean-shift of the CPU votes from the card's features, and printed;
     the densities' bound and the decisions on all;
  6c. the batched entry points (classify_scores for SHOT, CSHOT and
     SHORT_SHOT against the committed references, classify_intermediates,
     classify_scores_instances and classify_scores_mean_shift against
     classify_scores and IsmDetector bit for bit);
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
     the train entry point on 8 PCD files, then serve on its model;
  9b. the training configurations of tests/bench_data.TRAIN_CONFIGS
     against data/train_reference.npz (the JAX package on the CPU): K4m
     at the rankers' self-kNN (k = 11) and Lloyd's [F, 256] matrix, K4 at
     k = 3, K1/K2/K7/K8/K9 at one keypoint a cloud with the cloud's radius
     (the global descriptors) against their twins; the MVBBs, the SOR +
     z cut-off keep masks and MLS positions, each ranker's keep mask and
     k-means (KMeansCount 256, Hartigan) from JAX's seeds -- Lloyd through
     K4m and through its twin -- and the SVM on JAX's descriptors; then
     each configuration's training (files with normals on the staged
     route, MVBB, SOR + voxel + z cut, MLS, normals method 3, the five
     rankers, KMeansCount, KMeansHartigan, CSHOT_GLOBAL with the
     auto-trained SVM, SHOT_GLOBAL, SHORT_SHOT_GLOBAL, the feature cache)
     with its launches, run twice and compared bit for bit, held to the
     JAX codeword count, boxes, global descriptors, SVM or decisions (the
     two k-means trainings started from the features JAX's training
     seeded at, and held to its codebook), with
     its train_* ms per cloud and training clouds/s on 24 views; train.py
     on configs/quickstart.ism and configs/default.ism as shipped (views
     scaled to millimetres and to 0.3 m).
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
import dataclasses
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
    "shot_windowed": ("point_cloud_donkey_tpu_torch/csrc/shot_fused.cu",
                      "point_cloud_donkey_tpu/ops/pallas/shot_fused.py:432"),
    "chisq_matrix": ("point_cloud_donkey_tpu_torch/csrc/chisq.cu",
                     "point_cloud_donkey_tpu/ops/pallas/chisq.py:48"),
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
    # the windowed descriptor (K3w), CSHOT with a normals window, SHORT_SHOT
    # detection (no normals: K1/K2 at the keypoints only) and the batched
    # entry points (classify_scores: the dense grid through K7)
    "windowed_desc": ("lrf_moments", "sign_votes", "shot_windowed",
                      "chisq_topk"),
    "cshot_windowed": ("lrf_moments_windowed", "sign_votes_windowed",
                       "lrf_moments", "sign_votes", "shot_hist",
                       "chisq_topk"),
    "detect_short_shot": ("lrf_moments", "sign_votes", "histogram",
                          "chisq_topk"),
    "entry": ("lrf_moments", "sign_votes", "shot_dense", "chisq_topk"),
    # the activations (K4m where k > 3: KNN K=5, Threshold's 64), partial
    # SHOT, the PCA normals of methods 0, 1 and 3 (K1/K2 at the keypoints
    # only) and CSHOT under method 0; detection under Threshold
    "knn5": ("lrf_moments", "sign_votes", "shot_fused", "chisq_matrix"),
    "knnrule": ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "inn": ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "threshold": ("lrf_moments", "sign_votes", "shot_fused",
                  "chisq_matrix"),
    "partial_front": ("lrf_moments", "sign_votes", "shot_fused",
                      "chisq_topk"),
    "normals_m0": ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "normals_m1": ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "normals_m3": ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk"),
    "cshot_m0": ("lrf_moments", "sign_votes", "shot_hist", "chisq_topk"),
    "detect_threshold": ("lrf_moments", "sign_votes", "shot_dense",
                         "chisq_matrix"),
    # phase 9b: the training configurations (the staged route with the
    # files' normals and with normals method 3; MVBB; preprocessing; the
    # rankers' self-kNN at k = 11 and Lloyd's [F, k] matrix through K4m;
    # the global descriptors at one keypoint a cloud: K7, K8, K9), and
    # train.py on the shipped configs (default.ism: CSHOT under l2)
    **{"train_" + name: ("lrf_moments", "sign_votes", "shot_dense",
                         "chisq_topk")
       for name in ("normals", "mvbb", "sor", "mls", "normals_m3", "cache",
                    "shot_global")},
    **{"train_" + name: ("lrf_moments", "sign_votes", "shot_dense",
                         "chisq_matrix", "chisq_topk")
       for name in ("naive_bayes", "incremental", "knn_activation",
                    "strangeness", "similarity", "kmeans_count")},
    # Hartigan keeps k = 1 on the bench features, as the JAX package does:
    # the activation of one codeword needs no search
    "train_kmeans_hartigan": ("lrf_moments", "sign_votes", "shot_dense",
                              "chisq_matrix"),
    "train_cshot_global": ("lrf_moments", "sign_votes", "shot_dense",
                           "shot_hist", "chisq_topk"),
    "train_short_shot_global": ("lrf_moments", "sign_votes", "shot_dense",
                                "histogram", "chisq_topk"),
    "shipped_quickstart": ("lrf_moments", "sign_votes", "shot_dense",
                           "chisq_topk"),
    "shipped_default": ("lrf_moments", "sign_votes", "shot_hist"),
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
# detection under Threshold: at most this many of the 32 clouds may have a
# vote whose validity differs between the card's features and the plain
# twins' (3 on the H100, clouds 12, 15 and 22; PERF.md)
MOVED_MAX = 3


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
    from point_cloud_donkey_tpu_torch.models import pipeline as kpipe
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
        # the library yardstick: K3's tiles as the "clouds" of a dense grid
        # of 8 rows, each over its cloud's points (every row is binned)
        tcl = tile_cloud.long()
        t3 = tile_cloud.shape[0]
        k3_lib = shot_slot_library(
            (kp_rows.reshape(t3, kshot.TK, 3),
             fr_rows.reshape(t3, kshot.TK, 3, 3),
             torch.ones(t3, kshot.TK, dtype=torch.bool, device=dev),
             pts[tcl], normals[tcl], mask[tcl], cfg.radius),
            kshot_ops, card, "shot_fused")
        record("shot_fused", (hist - phist).abs().max(), k3_ms,
               cuda_ms(lambda: kshot.shot_tiles_plain(*shot_args), 2),
               f"SHOT {tile_cloud.shape[0]} tiles x N={pts.shape[1]}",
               k3_bytes, k3_ops, k3_lib)

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
                               "chisq_kernel", 20)
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

    # -- 2e. K3w at the windowed descriptor step's shapes -------------------
    phase(f"2e. K3w (the windowed descriptor) vs its plain twin, K7 and K3 "
          f"on the card ({card})")
    with torch.no_grad():
        desc_window = windowed_descriptor_phase(
            pts, mask, kres, srt, cfg, k3_ms, record, card)

    # -- 2f. K4m at the classify step's features ---------------------------
    phase(f"2f. K4m (the [Q, C] chi-square matrix) vs its plain twin and K4 "
          f"on the card ({card})")
    with torch.no_grad():
        k4m_phase(desc, codebook, data, dev, record, card)

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

    # -- 4d. the windowed-descriptor classify step ---------------------------
    phase(f"4d. windowed-descriptor classify step (K3w): IsmClassifier, "
          f"descriptor window {desc_window}, B={BATCH} x N={pts.shape[1]} "
          f"({card})")
    for nw, key, want in ((0, "windowed_desc", "scores"),
                          (window, "windowed_desc_normals",
                           "scores_windowed")):
        print(f"-- normals window {nw or 'none'}")
        dwmodel = IsmClassifier(codebook, cfg._replace(
            descriptor_window=desc_window, normals_window=nw), params)
        scores, launches[key] = drive("windowed_desc", dwmodel, STAGES, pts,
                                      mask, ROUNDS, card)
        print(f"dense recomputes: {dwmodel.dense_recomputes}")
        assert dwmodel.dense_recomputes == 0 and \
            launches[key]["shot_dense"] == 0, "the calibrated windows tripped"
        with torch.no_grad():
            assert torch.equal(scores, dwmodel(pts, mask)), \
                "two runs of the windowed-descriptor step differ"
        print("two runs of the step: scores identical")
        check_decisions(scores.cpu().numpy(), ref[want], labels)
    tripped = IsmClassifier(codebook, cfg._replace(descriptor_window=1024),
                            params)
    with torch.no_grad():
        build.reset_launch_counts()
        tscores = tripped(pts, mask)
        torch.cuda.synchronize()
        got = build.launch_counts()
    print(f"descriptor window 1024: dense recomputes {tripped.dense_recomputes}"
          f", launches {got}")
    assert tripped.dense_recomputes == 1 and got["shot_dense"] == 1 and \
        got["shot_windowed"] == 1, "the 1024 window did not trip to K7"
    check_decisions(tscores.cpu().numpy(), ref["scores"], labels)

    # -- 4e. every activation, partial SHOT and the normals methods ---------
    cref = np.load(os.path.join(data, "config_reference.npz"))
    config_steps(data, dev, pts, mask, rgb, labels, cref, launches, card)

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

    # -- 5c. CSHOT with the normals window ------------------------------------
    phase(f"5c. CSHOT classify step with the normals window {window}: "
          f"IsmClassifier, B={BATCH} x N={pts.shape[1]} ({card})")
    cs_model = served_model(data, "cshot", dev, normals_window=window)
    scores, launches["cshot_windowed"] = drive(
        "cshot_windowed", cs_model, STAGES, pts, mask, ROUNDS, card, (rgb,))
    print(f"dense recomputes: {cs_model.dense_recomputes}")
    assert cs_model.dense_recomputes == 0, "the calibrated window tripped"
    assert launches["cshot_windowed"]["shot_hist"] == 1, \
        launches["cshot_windowed"]
    with torch.no_grad():
        assert torch.equal(scores, cs_model(pts, mask, rgb)), \
            "two runs of the windowed CSHOT step differ"
    print("two runs of the step: scores identical")
    check_decisions(scores.cpu().numpy(), dref["scores_cshot_windowed"],
                    labels)

    # -- 5d. serve a .off mesh ------------------------------------------------
    phase("5d. serve --device cuda on a .off mesh (a tessellated box, sampled "
          "on the fly)")
    serve_off(serve, model_path)

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
    shot_dens = dens

    # -- 6b. SHORT_SHOT detection --------------------------------------------
    phase(f"6b. SHORT_SHOT detection step: IsmDetector, B={MS_BATCH} x "
          f"N={pts.shape[1]} ({card})")
    ss_path = os.path.join(data, "short_shot_codebook.ism")
    ss_model = served_model(data, "short_shot", dev)
    ss_det = IsmDetector(ss_model.codebook, ss_model.cfg, ss_model.params)
    (dens, pos), launches["detect_short_shot"] = drive(
        "detect_short_shot", ss_det, DETECT_STAGES, mp, mm, MS_ROUNDS, card)
    got = launches["detect_short_shot"]
    assert got["lrf_moments"] == 1 and got["sign_votes"] == 1 and \
        got["histogram"] == 1, \
        f"SHORT_SHOT detection must run K1/K2 at the keypoints only: {got}"
    with torch.no_grad():
        again = ss_det(mp, mm)
    assert torch.equal(dens.view(torch.int32), again[0].view(torch.int32)) \
        and torch.equal(pos.view(torch.int32), again[1].view(torch.int32)), \
        "two runs of the SHORT_SHOT detection step differ"
    print("two runs of the step: densities and positions identical")
    d, p = dens.cpu().numpy(), pos.cpu().numpy()
    assert np.isfinite(d).all() and np.isfinite(p).all()
    rd = dref["detect_densities_short_shot"]
    rp = dref["detect_positions_short_shot"]
    best = rd.argmax(1)
    perr = float(np.abs(p[np.arange(MS_BATCH), best]
                        - rp[np.arange(MS_BATCH), best]).max())
    drel = float((np.abs(d - rd) / np.maximum(np.abs(rd), 1.0)).max())
    print(f"best-class maximum vs JAX-CPU: max |position delta| {perr:.3e} "
          f"(phase 6's limit {POS_TOL}); densities max relative delta "
          f"{drel:.3e} (limit {DENS_RTOL})")
    if perr <= POS_TOL and drel <= DENS_RTOL:
        print("within phase 6's bounds")
    else:
        print("beyond phase 6's bounds: SHORT_SHOT's edge pairs (the card's "
              "atan2f / acosf against JAX's) move votes; held to the "
              "SHORT_SHOT classify contract instead")
    check_decisions(d, rd, labels[:MS_BATCH], require_accuracy=False)
    text = serve_files(serve, ss_path, ref["points"][:8], ref["labels"][:8],
                       ["--maxima"])
    rows = re.findall(r"predicted \d+, ground truth \d+ (?:OK|WRONG) "
                      r"maximum \(\S+ \S+ \S+\)$", text, re.M)
    assert len(rows) == 8, \
        "serve --maxima with the SHORT_SHOT model did not print 8 maxima"

    # -- 6d. detection under Threshold -------------------------------------------
    phase(f"6d. detection step under Threshold (K4m): IsmDetector, "
          f"B={MS_BATCH} x N={pts.shape[1]} ({card})")
    moved = threshold_detection(codebook, cfg, params, mp, mm, labels, cref,
                                launches, card)

    # -- 6c. the batched entry points -----------------------------------------
    phase(f"6c. batched entry points: classify_scores, "
          f"classify_intermediates, classify_scores_instances (B={BATCH}), "
          f"classify_scores_mean_shift (B={MS_BATCH}) ({card})")
    with torch.no_grad():
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        cs = kpipe.classify_scores(pts, mask, codebook, cfg, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches["entry"] = build.launch_counts()
        print(f"classify_scores: {dt * 1e3:.3f} ms for {BATCH} clouds; "
              f"launches {launches['entry']}")
        missing = [k_ for k_ in PATH_KERNELS["entry"]
                   if launches["entry"][k_] == 0]
        assert not missing, f"kernels not launched by the entry path: " \
            f"{missing}"
        check_decisions(cs.cpu().numpy(), ref["scores"], labels)
        inter = kpipe.classify_intermediates(pts, mask, codebook, cfg,
                                             params)
        assert torch.equal(inter.scores, cs), \
            "classify_intermediates' scores differ from classify_scores"
        ninst = int(codebook.vote_instance.max()) + 1
        cls, inst = kpipe.classify_scores_instances(pts, mask, codebook, cfg,
                                                    params, ninst)
        assert torch.equal(cls, cs), \
            "classify_scores_instances' class scores differ"
        isum = float(((inst.sum(1) - cls.sum(1)).abs()
                      / cls.sum(1).abs().clamp(min=1e-6)).max())
        print(f"classify_intermediates and classify_scores_instances: class "
              f"scores equal classify_scores bit for bit; {ninst} instances, "
              f"per-cloud instance sums within {isum:.2e} of the class sums")
        assert isum <= 1e-5, "instance scores do not sum to the class scores"
        for name, extra in (("cshot", (rgb,)), ("short_shot", ())):
            m_ = served_model(data, name, dev)
            s_ = kpipe.classify_scores(pts, mask, m_.codebook, m_.cfg,
                                       m_.params, *extra)
            print(f"classify_scores {name}:")
            check_decisions(s_.cpu().numpy(), dref["scores_" + name], labels,
                            require_accuracy=name == "cshot")
        msd = kpipe.classify_scores_mean_shift(mp, mm, codebook, cfg, params)
        assert torch.equal(msd.view(torch.int32),
                           shot_dens.view(torch.int32)), \
            "classify_scores_mean_shift differs from IsmDetector's densities"
        print("classify_scores_mean_shift: equal to IsmDetector's densities "
              "bit for bit")

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
    training_configs(launches, card, data, pts, mask, labels)

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
    print(json.dumps({"detect_threshold": {
        "clouds": MS_BATCH, "moved_clouds": moved, "moved_max": MOVED_MAX}}))
    print()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def k4m_phase(desc, codebook, data, dev, record, card):
    """Phase 2f: K4m at the classify step's features (`desc`, the valid
    rows of the bench batch) against the bench codebook, its partial-SHOT
    front half and, at CSHOT's width, sparse rows from a seed against the
    CSHOT codebook: distances within rtol 1e-5 of its twin (+inf exactly at
    the masked codewords), the k=64 selection under the k-NN contract, the
    k=1..3 selections equal to K4's fused top-k bit for bit, two launches
    bit-equal; timed beside its bound, K4's special-function floor, the
    profiler's device time, the selection's time and K4's time."""
    import torch

    from point_cloud_donkey_tpu_torch.models.codebook import load_codebook
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    cols, pcw = codebook.partial("front", desc.shape[1])
    ccb = load_codebook(os.path.join(data, "cshot_codebook.ism")).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cq = torch.rand(desc.shape[0], ccb.codewords.shape[1], device=dev,
                    generator=gen)
    cq = torch.where(cq < 0.6, torch.zeros_like(cq), cq)
    cq = (cq / cq.sum(1, keepdim=True)).contiguous()
    cases = (("D=352", desc, codebook.codewords, codebook.cw_mask),
             ("partial front D=176", desc.index_select(1, cols).contiguous(),
              pcw, codebook.cw_mask),
             ("CSHOT D=1344", cq, ccb.codewords, ccb.cw_mask))
    for name, a, b, m in cases:
        what = f"{name} Q={a.shape[0]} C={b.shape[0]}"
        d = kchisq.chisq_matrix(a, b, m)
        again = kchisq.chisq_matrix(a, b, m)
        assert torch.equal(d.view(torch.int32), again.view(torch.int32)), \
            f"two K4m launches differ ({what})"
        pd = kchisq.chisq_matrix_plain(a, b, m)
        masked = (~m)[None, :].expand_as(d)
        assert torch.equal(torch.isinf(d), masked) and \
            torch.equal(torch.isinf(pd), masked), \
            f"K4m's +inf entries are not the masked codewords ({what})"
        fin = torch.isfinite(pd)
        rel = ((d - pd).abs() / pd.abs().clamp(min=1e-6))[fin].max()
        assert rel <= 1e-5, f"K4m distances off by rtol {rel:.2e} ({what})"
        sd, si = kchisq.smallest_k(d, 64)
        psd, psi = kchisq.smallest_k(pd, 64)
        srel = ((sd - psd).abs() / psd.abs().clamp(min=1e-6)).max()
        differ = si != psi
        assert srel <= 1e-5 and torch.allclose(sd[differ], psd[differ],
                                               rtol=1e-5), \
            f"K4m's k=64 selection differs beyond ties ({what})"
        for k in (1, 2, 3):
            fd, fi = kchisq.chisq_topk(a, b, m, k)
            kd, ki = kchisq.smallest_k(d, k)
            assert torch.equal(fd, kd) and torch.equal(fi, ki), \
                f"K4m's k={k} selection differs from K4's top-k ({what})"
        ms = cuda_ms(lambda: kchisq.chisq_matrix(a, b, m), 20)
        dev_ms = device_ms(lambda: kchisq.chisq_matrix(a, b, m),
                           "chisq_kernel", 20)
        sel_ms = cuda_ms(lambda: kchisq.smallest_k(d, 64), 20)
        k4_ms = cuda_ms(lambda: kchisq.chisq_topk(a, b, m, 1), 20)
        pms = cuda_ms(lambda: kchisq.chisq_matrix_plain(a, b, m), 2)
        terms = a.shape[0] * b.shape[0] * a.shape[1]
        ops = terms * CHISQ_TERM_OPS + a.shape[0] * b.shape[0]
        nb = nbytes(a, b, m, d)
        b_ms, by = bound(nb, ops)
        print(f"{'chisq_matrix':20s} {what}: kernel {ms:.4f} ms, device "
              f"{fmt_ms(dev_ms)} (K4's fused top-k {k4_ms:.4f} ms, plain "
              f"{pms:.3f} ms), k=64 selection {sel_ms:.4f} ms; bound "
              f"{b_ms:.4f} ms by {by} ({nb:.3e} B), special-function floor "
              f"{terms / SFU_OPS_PER_S * 1e3:.4f} ms; rtol {float(rel):.2e}, "
              f"k=64: {int(differ.sum())} tied indices differ, k=1..3 equal "
              f"to K4; two launches bit-equal ({card})", flush=True)
        if name == "D=352":   # the Threshold and K=5 steps' call
            record("chisq_matrix", (d - pd)[fin].abs().max(), ms, pms,
                   "chisq matrix " + what, nb, ops)


def config_steps(data, dev, pts, mask, rgb, labels, cref, launches, card):
    """Phase 4e: the classify step under each configuration of
    data/config_reference.npz (`cref`), with the launch counts of one step
    in launches[name]: its decisions against the committed JAX-CPU scores
    (accuracy required where the reference has it), two runs equal, and
    its K4 / K4m launches (INN 6 K4; Threshold and K=5 one K4m, no K4;
    the others one K4), no LRF kernel for the PCA normals."""
    import torch

    from torch_fixtures import CONFIGS
    from point_cloud_donkey_tpu_torch.models.pipeline import (STAGES,
                                                              IsmClassifier)
    for name, (fields, method, descriptor) in CONFIGS.items():
        phase(f"4e. classify step under {name} ({fields or 'KNN K=1'}, "
              f"ConsistentNormalsMethod {method}, {descriptor}): "
              f"IsmClassifier, B={pts.shape[0]} x N={pts.shape[1]} ({card})")
        served = served_model(data, "cshot" if descriptor == "CSHOT"
                              else "bench", dev)
        model = IsmClassifier(served.codebook,
                              served.cfg._replace(normals_method=method),
                              dataclasses.replace(served.params, **fields))
        extra = (rgb,) if descriptor == "CSHOT" else ()
        scores, launches[name] = drive(name, model, STAGES, pts, mask, 2,
                                       card, extra)
        got = launches[name]
        want_k4 = {"inn": (6, 0), "threshold": (0, 1), "knn5": (0, 1)}.get(
            name, (1, 0))
        assert (got["chisq_topk"], got["chisq_matrix"]) == want_k4, \
            f"{name}: K4 / K4m launches {got}, want {want_k4}"
        if method != 2:
            assert got["lrf_moments"] == 1 and got["sign_votes"] == 1, \
                f"{name}: the PCA normals launch no LRF kernel: {got}"
        with torch.no_grad():
            assert torch.equal(scores, model(pts, mask, *extra)), \
                f"two runs of the {name} step differ"
        print("two runs of the step: scores identical")
        rs = cref["scores_" + name]
        check_decisions(scores.cpu().numpy(), rs, labels,
                        require_accuracy=bool(
                            (rs.argmax(1) == labels[:len(rs)]).all()))


def serve_off(serve, model_path):
    """Phase 5d: serve.main --device cuda on a `.off` mesh written here (a
    tessellated box): one prediction line."""
    from bench_data import write_box_off
    tmp = tempfile.mkdtemp(prefix="pcd_smoke_off_")
    try:
        mesh = os.path.join(tmp, "box.off")
        write_box_off(mesh)
        flist = os.path.join(tmp, "test.txt")
        with open(flist, "w") as f:
            f.write(f"# test\n{mesh} 0\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["-d", model_path, "-f", flist, "--device",
                             "cuda"])
    finally:
        shutil.rmtree(tmp)
    text = out.getvalue()
    print(text.rstrip())
    assert rc == 0 and len(re.findall(
        r"\.off: predicted \d+, ground truth 0 ", text)) == 1, \
        "serve did not print one prediction for the .off mesh"


def threshold_detection(codebook, cfg, params, pts, mask, labels, cref,
                        launches, card):
    """Phase 6d: IsmDetector under Threshold (K4m, no K4) on `pts` against
    the committed JAX-CPU detection; two runs equal bit for bit.  A vote
    is cast only below the threshold and within the 2-sigma gate, so a
    descriptor that differs within the descriptor contract can move a vote
    across a cut, and Threshold's 17-64 votes a feature carry that into
    the densities.  The clouds where a vote's validity differs between the
    card's features and the plain twins' (which compute the JAX package's
    arithmetic) may number at most MOVED_MAX and are held, each, to phase
    6's bounds against the plain mean-shift of the votes cast on the CPU
    from the card's own features; every other cloud is held to phase 6's
    bounds against the JAX reference, and every cloud to the densities'
    bound and the decision contract.  Returns the moved clouds."""
    import numpy as np
    import torch

    from torch_fixtures import CONFIGS
    from point_cloud_donkey_tpu_torch.models.codebook import (
        CODEBOOK_FIELDS, Codebook, cast_votes)
    from point_cloud_donkey_tpu_torch.models.pipeline import (
        DETECT_STAGES, MAX_ITER, SEED_CAPACITY, IsmDetector, _best_maxima,
        extract_features)
    from point_cloud_donkey_tpu_torch.ops.neighbors import full_fp32
    tparams = dataclasses.replace(params, **CONFIGS["threshold"][0])
    det = IsmDetector(codebook, cfg, tparams)
    b = pts.shape[0]
    (dens, pos), launches["detect_threshold"] = drive(
        "detect_threshold", det, DETECT_STAGES, pts, mask, 2, card)
    assert launches["detect_threshold"]["chisq_topk"] == 0, \
        launches["detect_threshold"]
    with torch.no_grad():
        again = det(pts, mask)
    assert torch.equal(dens.view(torch.int32), again[0].view(torch.int32)) \
        and torch.equal(pos.view(torch.int32), again[1].view(torch.int32)), \
        "two runs of the Threshold detection step differ"
    print("two runs of the step: densities and positions identical")

    # the votes' validity from the card's features and from the twins'
    cpu_cb = Codebook(**{name: getattr(codebook, name).cpu()
                         for name in CODEBOOK_FIELDS})
    votes = []
    with torch.no_grad(), full_fp32():
        for f in (extract_features(pts, mask, cfg),
                  extract_features(pts.cpu(), mask.cpu(), cfg)):
            k = f.valid.shape[1]
            votes.append(cast_votes(
                cpu_cb, f.descriptors.cpu().reshape(b * k, -1),
                f.keypoints.cpu().reshape(b * k, 3),
                f.frames.cpu().reshape(b * k, 3, 3),
                f.valid.cpu().reshape(b * k), tparams, cfg.metric))
    moved = (votes[0].valid.reshape(b, -1)
             != votes[1].valid.reshape(b, -1)).any(1).numpy()
    idx = np.nonzero(moved)[0]
    assert len(idx) <= MOVED_MAX, \
        f"{len(idx)} clouds' votes differ from the twins' features' " \
        f"(at most {MOVED_MAX})"

    d, p = dens.cpu().numpy(), pos.cpu().numpy()
    assert np.isfinite(d).all() and np.isfinite(p).all()
    rd = cref["detect_densities_threshold"][:b]
    rp = cref["detect_positions_threshold"][:b]
    best = rd.argmax(1)
    perr = np.abs(p[np.arange(b), best] - rp[np.arange(b), best]).max(1)
    drel = float((np.abs(d - rd) / np.maximum(np.abs(rd), 1.0)).max())
    held = ~moved
    # the moved clouds against the mean-shift (plain torch, no kernel) of
    # the votes cast on the CPU from the card's features
    terr, tdrel = np.zeros(0), 0.0
    if len(idx):
        v = votes[0].position.shape[0] // b
        rows = torch.from_numpy((idx[:, None] * v
                                 + np.arange(v)).reshape(-1))
        with torch.no_grad(), full_fp32():     # the plain mean-shift
            td, tp = _best_maxima(
                type(votes[0])(*(x[rows].to(pts.device) for x in votes[0])),
                len(idx), cfg.num_classes, cfg.bandwidth, SEED_CAPACITY,
                MAX_ITER)
        td, tp = td.cpu().numpy(), tp.cpu().numpy()
        terr = np.abs(p[idx, best[idx]]
                      - tp[np.arange(len(idx)), best[idx]]).max(-1)
        tdrel = float((np.abs(d[idx] - td)
                       / np.maximum(np.abs(td), 1.0)).max())
    print(f"votes whose validity differs from the twins' features: clouds "
          f"{idx.tolist()} (at most {MOVED_MAX}; best-maximum deltas to JAX "
          f"{[f'{x:.3e}' for x in perr[moved]]}, to the plain mean-shift of "
          f"the card's features' votes {[f'{x:.3e}' for x in terr]}, "
          f"densities {tdrel:.3e}); the other {int(held.sum())} clouds: max "
          f"|position delta| {perr[held].max():.3e} (limit {POS_TOL}); all: "
          f"densities max relative delta {drel:.3e} (limit {DENS_RTOL})")
    check_decisions(d, rd, labels[:b], require_accuracy=bool(
        (rd.argmax(1) == labels[:b]).all()))
    assert perr[held].max() <= POS_TOL, \
        "Threshold maxima differ from the JAX reference"
    assert (terr <= POS_TOL).all() and tdrel <= DENS_RTOL, \
        "Threshold maxima of the moved clouds differ from the plain " \
        "mean-shift of their votes"
    assert drel <= DENS_RTOL, \
        "Threshold densities differ from the JAX reference"
    return idx.tolist()


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


def training_configs(launches, card, data, pts, mask, labels):
    """Phase 9b: the training configurations of bench_data.TRAIN_CONFIGS
    on the card, each held to data/train_reference.npz (the JAX package on
    the CPU): first each new role of a kernel against its plain twin at the
    slice's shapes, then the pieces each configuration changes, then each
    configuration's whole training -- on the five bench training clouds
    (the *_GLOBAL ones on the 24 coloured training_views, for the SVM),
    with the launch counts set to 0 just before and read just after, run
    twice and compared bit for bit, its train_* ms per cloud -- and its
    training clouds/s on the 24 views; then train.py on
    configs/quickstart.ism and configs/default.ism as shipped, on views
    scaled to their units.  Agglomerative clustering is O(F^3) host Python
    in both packages and is held on the CPU only, by the tests."""
    import copy

    import numpy as np
    import torch

    from bench_data import (BENCH_CONFIG, GLOBALS, RANKERS, TRAIN_CONFIGS,
                            bench_clouds,
                            bench_colors, feature_centre_distances,
                            seeded_kmeans, split_seeds, train_config,
                            training_views)
    from point_cloud_donkey_tpu_torch import train as train_cli
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.clustering import (
        kmeans, kmeans_hartigan)
    from point_cloud_donkey_tpu_torch.models.codebook import (
        Codebook, CodebookParams)
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                              PipelineConfig)
    from point_cloud_donkey_tpu_torch.models.ranking import (RankingParams,
                                                             rank_features)
    from point_cloud_donkey_tpu_torch.models.svm import SVMModel, train_svm
    from point_cloud_donkey_tpu_torch.ops import preprocess as pp
    from point_cloud_donkey_tpu_torch.ops.color import \
        rgb_to_cielab_normalized
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.geometry import (compute_mvbb_batch,
                                                           quat_to_matrix_np)
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    from point_cloud_donkey_tpu_torch.ops.kernels import histogram as khist
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as kshot
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as ksh
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals
    from point_cloud_donkey_tpu_torch.utils.config import (ComponentConfig,
                                                           IsmConfig)
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd

    dev = pts.device
    tref = np.load(os.path.join(data, "train_reference.npz"))
    train_pts, train_cls, _, _ = bench_clouds(0)
    views, view_labels = training_views()
    with np.load(os.path.join(data, "bench_codebook.ismd.npz")) as z:
        committed = dict(z)
    feats, feat_cls, feat_cdist = feature_centre_distances(committed,
                                                           train_pts)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # -- the kernels' new roles against their twins --------------------------
    fd = t(feats)
    ones = torch.ones(fd.shape[0], dtype=torch.bool, device=dev)
    for what, a, b in (("ranker self-kNN", fd, fd),
                       ("Lloyd [F, 256]", fd, t(tref["kmeans_seeds"]))):
        m = torch.ones(b.shape[0], dtype=torch.bool, device=dev)
        d = kchisq.chisq_matrix(a, b, m)
        again = kchisq.chisq_matrix(a, b, m)
        pd = kchisq.chisq_matrix_plain(a, b, m)
        rel = float(((d - pd).abs() / pd.clamp(min=1e-6)).max())
        assert torch.equal(d, again) and rel <= 1e-5, \
            f"K4m {what}: rtol {rel:.2e}"
        k = 11 if what.startswith("ranker") else 1
        sd, si = kchisq.smallest_k(d, k)
        psd, psi = kchisq.smallest_k(pd, k)
        differ = si != psi
        assert torch.allclose(sd, psd, rtol=1e-5) and torch.allclose(
            sd[differ], psd[differ], rtol=1e-5), f"K4m {what}: selection"
        ms = cuda_ms(lambda: kchisq.chisq_matrix(a, b, m), 20)
        dev_ms = device_ms(lambda: kchisq.chisq_matrix(a, b, m),
                           "chisq_kernel", 20)
        pms = cuda_ms(lambda: kchisq.chisq_matrix_plain(a, b, m), 3)
        ops = a.shape[0] * b.shape[0] * (a.shape[1] * CHISQ_TERM_OPS + 1)
        b_ms, by = bound(nbytes(a, b, m, d), ops)
        print(f"{'chisq_matrix':20s} {what} Q={a.shape[0]} C={b.shape[0]} "
              f"D={a.shape[1]} (k={k}): kernel {ms:.4f} ms, device "
              f"{fmt_ms(dev_ms)}, plain {pms:.3f} "
              f"ms, bound {b_ms:.4f} ms by {by}; rtol {rel:.2e}, "
              f"{int(differ.sum())} tied indices differ; two launches "
              f"bit-equal ({card})")
    fk, ik = kchisq.chisq_topk(fd, fd, ones, 3)
    pk, pik = kchisq.chisq_topk_plain(fd, fd, ones, 3)
    assert torch.allclose(fk, pk, rtol=1e-5) and \
        torch.equal(ik[~torch.isclose(fk, pk)], pik[~torch.isclose(fk, pk)])
    k4_ms = cuda_ms(lambda: kchisq.chisq_topk(fd, fd, ones, 3), 20)
    k4_dev = device_ms(lambda: kchisq.chisq_topk(fd, fd, ones, 3),
                       "chisq_kernel", 20)
    k4_plain = cuda_ms(lambda: kchisq.chisq_topk_plain(fd, fd, ones, 3), 3)
    b_ms, by = bound(nbytes(fd, fd, ones, fk, ik), fd.shape[0] ** 2 * (
        fd.shape[1] * CHISQ_TERM_OPS + 1))
    print(f"{'chisq_topk':20s} ranker self-kNN k=3 Q=C={fd.shape[0]}: "
          f"{k4_ms:.4f} ms, device {fmt_ms(k4_dev)}, plain {k4_plain:.4f} "
          f"ms, bound {b_ms:.4f} ms by {by}; equal to its twin within rtol "
          f"1e-5 ({card})")

    # one keypoint at each bench training cloud's centroid, radius = the
    # cloud radius: K1 / K2 (LRF, ReferenceFrameRadius 1.0), K7, K8, K9
    gpts = t(train_pts)
    gmask = torch.ones(gpts.shape[:2], dtype=torch.bool, device=dev)
    gnrm = compute_normals(gpts, gmask, 0.25, 2).normals.contiguous()
    grgb = t(bench_colors(train_pts))
    lab = rgb_to_cielab_normalized(grgb).contiguous()
    for r in range(len(train_pts)):
        c = train_pts[r].mean(axis=0).astype(np.float32)
        radius = float(np.linalg.norm(train_pts[r] - c, axis=1).max())
        kp = t(c[None, None])
        kpm = torch.ones((1, 1), dtype=torch.bool, device=dev)
        p, msk, nr = gpts[r:r + 1], gmask[r:r + 1], gnrm[r:r + 1]
        # K1 and K2 as shot_lrf launches them: on the centroid-shifted
        # cloud, the votes along the axes of the K1 covariance
        q, ps = klrf.prep_shift(kp, p, msk)
        mom, cnt = klrf.moments(q, ps, msk, 1.0)
        pmom, pcnt = klrf.moments_plain(q, ps, msk, 1.0)
        assert torch.equal(cnt, pcnt) and torch.allclose(
            mom, pmom, rtol=2e-4, atol=5e-4), "K1 at the centroid"
        cov, _ = klrf.cov_from_moments(mom, q, kpm)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        v = klrf.sign_votes(q, ps, msk, axes, 1.0)
        pv = klrf.sign_votes_plain(q, ps, msk, axes, 1.0)
        verr = int((v - pv).abs().max())
        assert verr <= 1, f"K2 at the centroid: votes off by {verr}"
        lrf = shot_lrf(kp, kpm, p, msk, 1.0)
        fr, live = lrf.frames.contiguous(), lrf.valid.contiguous()
        h, n = kshot.shot_dense(kp, fr, live, p, nr, msk, radius)
        ph, pn = kshot.shot_dense_plain(kp, fr, live, p, nr, msk, radius)
        assert torch.equal(n, pn) and torch.allclose(h, ph, atol=1e-3), \
            "K7 at the centroid"
        kl = rgb_to_cielab_normalized(t(bench_colors(train_pts[r]).mean(
            axis=0)[None, None])).contiguous()
        h8, n8 = ksh.cshot_hist(kp, kl, fr, live, p, nr, lab[r:r + 1], msk,
                                radius)
        ph8, pn8 = ksh.cshot_hist_plain(kp, kl, fr, live, p, nr,
                                        lab[r:r + 1], msk, radius)
        assert torch.equal(n8, pn8) and torch.allclose(h8, ph8, atol=1e-3), \
            "K8 at the centroid"
        h9 = khist.short_shot_hist(kp, fr, live, p, msk, radius)
        ph9 = khist.short_shot_hist_plain(kp, fr, live, p, msk, radius,
                                          2, 2, 8)
        assert torch.allclose(h9, ph9, atol=1e-3), "K9 at the centroid"
        if r == 0:
            # (name, kernel, launch, plain twin, bytes, operations)
            inside = int(cnt.sum())
            calls = (
                ("K1", "MomentsBody",
                 lambda: klrf.moments(q, ps, msk, 1.0),
                 lambda: klrf.moments_plain(q, ps, msk, 1.0),
                 nbytes(q, ps, msk, mom, cnt),
                 inside * (GATE_OPS + MOMENT_BODY_OPS)),
                ("K2", "VotesBody",
                 lambda: klrf.sign_votes(q, ps, msk, axes, 1.0),
                 lambda: klrf.sign_votes_plain(q, ps, msk, axes, 1.0),
                 nbytes(q, ps, msk, axes, v),
                 inside * (GATE_OPS + 2 * VOTE_BODY_OPS)),
                ("K7", "DenseTiles",
                 lambda: kshot.shot_dense(kp, fr, live, p, nr, msk, radius),
                 lambda: kshot.shot_dense_plain(kp, fr, live, p, nr, msk,
                                                radius),
                 nbytes(kp, fr, live, p, nr, msk, h, n),
                 int(n.sum()) * (GATE_OPS + SHOT_BODY_OPS)),
                ("K8", "cshot_hist_kernel",
                 lambda: ksh.cshot_hist(kp, kl, fr, live, p, nr,
                                        lab[r:r + 1], msk, radius),
                 lambda: ksh.cshot_hist_plain(kp, kl, fr, live, p, nr,
                                              lab[r:r + 1], msk, radius),
                 nbytes(kp, kl, fr, live, p, nr, lab[r:r + 1], msk, h8, n8),
                 int(n8.sum()) * (GATE_OPS + CSHOT_BODY_OPS)),
                ("K9", "short_shot_hist_kernel",
                 lambda: khist.short_shot_hist(kp, fr, live, p, msk, radius),
                 lambda: khist.short_shot_hist_plain(kp, fr, live, p, msk,
                                                     radius, 2, 2, 8),
                 nbytes(kp, fr, live, p, msk, h9),
                 int(n.sum()) * (GATE_OPS + SHORT_SHOT_BODY_OPS)))
            print(f"global descriptor at one keypoint, radius {radius:.3f} "
                  f"(every point of the cloud in it: K7 count {int(n)} of "
                  f"{p.shape[1]}; K1 / K2 at ReferenceFrameRadius 1.0, "
                  f"{inside} points in it) ({card}):")
            for name, kernel, fn, plain_fn, nb, ops in calls:
                b_ms, by = bound(nb, ops)
                print(f"  {name}: {cuda_ms(fn, 20):.4f} ms a launch, device "
                      f"{fmt_ms(device_ms(fn, kernel, 20))}, plain twin "
                      f"{cuda_ms(plain_fn, 3):.4f} ms, bound {b_ms:.6f} ms "
                      f"by {by}", flush=True)
        assert int(n) >= p.shape[1] - 1, "the global radius misses points"
    print(f"K1, K2 (votes within +-1), K7, K8, K9 at one keypoint a cloud "
          f"(radius = the cloud radius) equal to their twins on the "
          f"{len(train_pts)} bench training clouds")

    # -- the pieces each configuration changes, vs the JAX-CPU reference ----
    pos, size, quat = (x.cpu().numpy() for x in compute_mvbb_batch(
        gpts, gmask))
    corner = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                       for sz in (-.5, .5)], np.float32)

    def corners(p_, s_, q_):
        return (corner * s_) @ quat_to_matrix_np(q_) + p_

    for r in range(len(train_pts)):
        w = (tref["mvbb_position"][r], tref["mvbb_size"][r],
             tref["mvbb_quat"][r])
        ext = float(w[1].max())
        assert np.allclose(np.sort(size[r]), np.sort(w[1]), rtol=1e-4)
        assert np.abs(corners(pos[r], size[r], quat[r])
                      - corners(*w)).max() <= 1e-4 * ext, f"MVBB {r}"
    print(f"MVBB of the {len(train_pts)} bench training clouds: sizes within "
          f"rtol 1e-4 and corners within 1e-4 x extent of the JAX-CPU boxes; "
          f"quaternion max |delta| up to sign "
          f"{float(np.minimum(np.abs(quat - tref['mvbb_quat']), np.abs(quat + tref['mvbb_quat'])).max()):.2e}")

    sor = TRAIN_CONFIGS["sor"]
    mls = TRAIN_CONFIGS["mls"]
    flips, moved, close = 0, 0.0, []
    for r in range(len(train_pts)):
        p, m = gpts[r], gmask[r]
        k = pp.statistical_outlier_removal(
            p, m, sor["Parameters.OutlierRemovalMeanK"],
            sor["Parameters.OutlierRemovalStddevMul"])
        removed = 1 - float(k.float().mean())
        k = pp.z_cutoff(p, k, sor["Parameters.CutoffDistanceZAxis"])
        flips += int((k.cpu().numpy() != tref["sor_keep"][r]).sum())
        sm = pp.mls_smooth(p, m, mls["Parameters.SmoothingRadius"])
        err = (sm - t(tref["mls_xyz"][r])).abs().amax(1)
        moved = max(moved, float(err.max()))
        close.append(err <= 1e-5)
        shift = float(((sm - p).norm(dim=1) > 1e-4).float().mean())
        assert removed >= 0.01 and shift >= 0.01, \
            f"a filter tests nothing: SOR removed {removed}, MLS moved {shift}"
    # MLS: within 1e-5 but where the neighbourhood's PCA is ill-posed;
    # there the fp32 moment identity of both packages is up to ~8e-5 off a
    # float64 MLS (PERF.md), so 1e-4 bounds every point
    share = float(torch.cat(close).float().mean())
    assert flips <= 0.001 * train_pts.size // 3 and share >= 0.98 and \
        moved <= 1e-4, f"preprocessing: {flips} keep flips, MLS max " \
        f"|delta| {moved}, {100 * share:.2f}% within 1e-5"
    print(f"SOR + z cut-off keep masks: {flips} points differ from the "
          f"JAX-CPU masks; MLS positions within 1e-5 on {100 * share:.2f}%, "
          f"max |delta| {moved:.2e}")

    for name in RANKERS:
        cfg = train_config(name)["ObjectConfig"]["Children"][
            "FeatureWeighting"]
        params = RankingParams.from_config(ComponentConfig.from_json(cfg))
        keep = rank_features(feats, feat_cls, feat_cdist, params, dev)
        diff = int((keep != tref["rank_" + name]).sum())
        print(f"ranker {name}: keep mask of {keep.sum()} / {len(keep)} "
              f"features, {diff} differ from the JAX-CPU mask")
        assert diff == 0, f"{name}'s keep mask differs"

    got = {}
    for route, device in (("K4m", dev), ("plain twin", torch.device("cpu"))):
        c, a = kmeans(feats, tref["kmeans_seeds"].shape[0], "chisq", 100,
                      device=device, init_centers=tref["kmeans_seeds"])
        got[route] = (c, a)
        agree = float((a == tref["kmeans_assign"]).mean())
        crel = float(np.abs(c - tref["kmeans_centers"]).max()
                     / np.abs(tref["kmeans_centers"]).max())
        print(f"KMeansCount 256 from JAX's seeds, Lloyd through {route}: "
              f"assignments equal on {100 * agree:.2f}%, centres max "
              f"|delta| / max {crel:.2e}")
        assert agree == 1.0 and crel <= 1e-4, f"k-means ({route})"
    max_k = TRAIN_CONFIGS["kmeans_hartigan"]["Children.Clustering"][
        "Parameters"]["MaxK"]
    seeds = np.split(tref["hartigan_seeds"], np.cumsum(np.arange(1, max_k)))
    c, a = kmeans_hartigan(feats, max_k, "chisq", 100, dev, seeds)
    assert c.shape == tref["hartigan_centers"].shape and \
        np.array_equal(a, tref["hartigan_assign"]) and np.allclose(
            c, tref["hartigan_centers"], rtol=1e-4, atol=1e-6), "Hartigan"
    print(f"KMeansHartigan (MaxK {max_k}) from JAX's seeds: k = {len(c)} as "
          f"JAX's, assignments equal, centres within rtol 1e-4")

    ref_svm = SVMModel.from_arrays(_Prefixed(tref, "ref_"))
    gdesc, gcls = tref["glob_cshot_global"], tref["glob_cls_cshot_global"]
    svm = train_svm(gdesc, gcls, one_vs_all=False, auto_train=True)
    same = all(np.allclose(x.sv, y.sv) and np.allclose(x.coeffs, y.coeffs)
               and abs(x.b - y.b) < 1e-9 and x.gamma == y.gamma
               for x, y in zip(svm.binaries, ref_svm.binaries))
    assert same and len(svm.binaries) == len(ref_svm.binaries), "SVM"
    print(f"SVM auto-trained on JAX's {len(gdesc)} CSHOT_GLOBAL descriptors: "
          f"the reference's (C, gamma), support vectors and coefficients")

    # -- each configuration's training ---------------------------------------
    tmp = tempfile.mkdtemp(prefix="pcd_smoke_train9b_")
    try:
        def files(clouds, cls, prefix, colours=False, normals=None):
            out = []
            for i, (cloud, c) in enumerate(zip(clouds, cls)):
                path = os.path.join(tmp, f"{prefix}{i}.pcd")
                save_pcd(path, cloud, binary=True,
                         rgb=bench_colors(cloud) if colours else None,
                         normals=None if normals is None else normals[i])
                out.append((path, int(c)))
            return out

        plain = files(train_pts, train_cls, "s")
        gnrm_np = gnrm.cpu().numpy()
        with_normals = files(train_pts, train_cls, "n", normals=gnrm_np)
        coloured_views = files(views, view_labels, "v", colours=True)
        plain_views = files(views, view_labels, "w")

        def state_arrays(ism):
            st = ism.state
            out = {"cb_" + k: np.asarray(v)
                   for k, v in st.codebook._asdict().items()}
            out["dims"] = np.array([st.dims_map[k] for k in sorted(
                st.dims_map)] + [st.variance_map[k] for k in sorted(
                    st.variance_map)])
            if st.global_descriptors is not None:
                out["glob"] = st.global_descriptors
            if st.svm is not None:
                out.update(st.svm.to_arrays())
            return out

        def compare_codebook(cb, want, what):
            """The training contract against a committed codebook."""
            assert cb.codewords.shape == want["cb_codewords"].shape and \
                np.array_equal(cb.vote_class, want["cb_vote_class"]), what
            live = cb.cw_mask
            x, y = cb.codewords[live], want["cb_codewords"][live]
            cos = (x * y).sum(1) / np.maximum(np.linalg.norm(
                x, axis=1) * np.linalg.norm(y, axis=1), 1e-30)
            share = float((cos > 0.999).mean()) if live.any() else 1.0
            srel = float(np.abs(cb.class_sigma / want["cb_class_sigma"]
                                - 1).max())
            print(f"{what} vs the committed JAX-trained codebook: cosine "
                  f"> 0.999 on {100 * share:.2f}% of {int(live.sum())} "
                  f"codewords, class sigma max relative delta {srel:.3e}")
            assert share >= 0.97 and srel <= 5e-2, f"{what} differs"

        def run(cfg, items, path):
            ism = ImplicitShapeModel(IsmConfig.from_json(cfg), dev)
            for p, c in items:
                ism.add_training_model(p, c, c)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            ism.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if path is not None:
                got = build.launch_counts()
                missing = [k for k in PATH_KERNELS[path] if got[k] == 0]
                assert not missing, \
                    f"kernels not launched by the {path} path: {missing}"
                launches[path] = got
            return ism, dt

        def served(ism):
            cb = Codebook.from_numpy(ism.state.codebook._asdict()).to(dev)
            model = IsmClassifier(
                cb, PipelineConfig.from_ism(ism.config, cb.num_classes,
                                            keypoint_capacity=192),
                CodebookParams.from_config(ism.config.child("Codebook")))
            with torch.no_grad():
                return model(pts, mask).cpu().numpy()

        summary = {}
        for name in ("normals",) + tuple(TRAIN_CONFIGS):
            cfg = train_config(name) if name in TRAIN_CONFIGS \
                else copy.deepcopy(BENCH_CONFIG)
            if name == "cache":
                cfg["ObjectConfig"]["Parameters"]["CacheFeaturesFolder"] = \
                    os.path.join(tmp, "cache")
            items = coloured_views if name in GLOBALS else \
                with_normals if name == "normals" else plain
            path = "train_" + name
            what = TRAIN_CONFIGS.get(name, "the files carry normals")
            phase(f"9b. training: {name} ({what}) ({card})")
            # k-means from the features JAX's training seeded at
            seeded = seeded_kmeans(split_seeds(
                tref["train_seeds_" + name], tref["train_seed_ks_" + name])) \
                if "train_seeds_" + name in tref.files \
                else contextlib.nullcontext()
            with seeded:
                ism, dt = run(cfg, items, path)
                twice, _ = run(cfg, items, None)
            if name == "cache":
                again = build.launch_counts()
                print(f"cache: the second run read every file's features "
                      f"from the cache; its launches {again}")
                assert again["shot_dense"] == 0, "the cache was not read"
            a, b = state_arrays(ism), state_arrays(twice)
            differ = [k for k in a if not np.array_equal(a[k], b[k])]
            assert not differ and sorted(a) == sorted(b), \
                f"{name}: two trainings differ in {differ}"
            count = ism.state.codebook.num_codewords
            per = {k: round(v * 1e3 / len(items), 3)
                   for k, v in ism.processing_times.items()}
            print(f"{name}: {len(items)} clouds in {dt:.3f} s, {count} "
                  f"codewords; two runs bit-equal; launches "
                  f"{launches[path]}; train_* ms per cloud: {per}")
            if "count_" + name in tref.files:
                want = int(tref["count_" + name])
                print(f"{name}: the JAX-CPU training has {want} codewords")
                assert count == want, f"{name}: codeword count"
            if "train_seeds_" + name in tref.files:
                cb = ism.state.codebook
                for field in ("cw_mask", "vote_mask", "vote_class",
                              "vote_instance"):
                    assert np.array_equal(getattr(cb, field),
                                          tref[f"cb_{name}_{field}"]), \
                        f"{name}: {field} differs from JAX's"
                compare_codebook(cb, {
                    "cb_" + k: tref[f"cb_{name}_{k}"]
                    for k in ("codewords", "vote_class", "class_sigma")},
                    f"{name} from JAX's seeds")
            if name == "mvbb":
                for r, box in enumerate(ism.boxes):
                    assert np.allclose(np.sort(box.size),
                                       np.sort(tref["mvbb_size"][r]),
                                       rtol=1e-4), "MVBB in training"
            if name == "normals":
                fused, _ = run(cfg, plain, None)
                fa = state_arrays(fused)
                differ = [k for k in fa if not np.array_equal(fa[k], a[k])]
                print(f"normals from the files (staged route) vs computed "
                      f"(fused route), same values: fields that differ "
                      f"{differ}")
                compare_codebook(ism.state.codebook, committed,
                                 "the staged route's codebook")
            if name == "normals_m3":
                check_decisions(served(ism), tref["scores_normals_m3"],
                                labels, "JAX-CPU method-3 reference",
                                require_accuracy=False)
            if name in GLOBALS:
                g, w = ism.state.global_descriptors, tref["glob_" + name]
                assert g.shape == w.shape and np.array_equal(
                    ism.state.global_classes, tref["glob_cls_" + name])
                cos = (g * w).sum(1) / np.maximum(np.linalg.norm(
                    g, axis=1) * np.linalg.norm(w, axis=1), 1e-30)
                print(f"{name}: {len(g)} global descriptors, cosine to "
                      f"JAX-CPU's min {cos.min():.6f}")
                assert cos.min() > 0.999, f"{name}'s global descriptors"
            if ism.state.svm is not None:
                svm = ism.state.svm
                got_p = [(round(x.gamma, 6), len(x.coeffs))
                         for x in svm.binaries]
                want_p = [(round(x.gamma, 6), len(x.coeffs))
                          for x in ref_svm.binaries]
                pred = np.array([svm.predict(d)[0] for d in
                                 ism.state.global_descriptors])
                print(f"SVM: (gamma, support vectors) {got_p}; JAX-CPU "
                      f"{want_p}; predictions equal JAX's on "
                      f"{int((pred == tref['svm_pred']).sum())}/{len(pred)}")
                assert [g for g, _ in got_p] == [g for g, _ in want_p] and \
                    np.array_equal(pred, tref["svm_pred"]), "SVM differs"
            if name != "normals":
                views_items = coloured_views if name in GLOBALS \
                    else plain_views
                run(cfg, views_items, None)        # warm
                ism, dt = run(cfg, views_items, None)
                summary[name] = round(len(views_items) / dt, 2)
                per = {k: round(v * 1e3 / len(views_items), 3)
                       for k, v in ism.processing_times.items()}
                print(f"{name}: training throughput {summary[name]} "
                      f"clouds/s over {len(views_items)} views ({card}); "
                      f"train_* ms per cloud: {per}")
        print(json.dumps({"training_clouds_per_s": summary}))

        # -- the shipped configs, verbatim, on views at their units --------
        for shipped, scale, colours in (("quickstart", 70.0, False),
                                        ("default", 0.3, True)):
            phase(f"9b. train.py on configs/{shipped}.ism as shipped ({card})")
            items = files(views * np.float32(scale), view_labels,
                          shipped[0], colours=colours)
            flist = os.path.join(tmp, f"{shipped}.txt")
            with open(flist, "w") as f:
                f.write("\n".join(["# train"] + [f"{p} {c}"
                                                 for p, c in items]) + "\n")
            out = io.StringIO()
            build.reset_launch_counts()
            with contextlib.redirect_stdout(out):
                rc = train_cli.main([
                    "-t", os.path.join(HERE, "configs", f"{shipped}.ism"),
                    "-f", flist, "-o", os.path.join(tmp, shipped),
                    "--device", str(dev)])
            print(out.getvalue().rstrip())
            assert rc == 0, f"train.py on {shipped}.ism failed"
            got = build.launch_counts()
            missing = [k for k in PATH_KERNELS["shipped_" + shipped]
                       if got[k] == 0]
            assert not missing, f"{shipped}.ism: not launched {missing}"
            launches["shipped_" + shipped] = got
            with np.load(os.path.join(tmp, shipped + ".ismd.npz")) as z:
                assert z["cb_cw_mask"].sum() > 0
                if shipped == "default":
                    assert "glob_desc" in z.files and "svm_mode" in z.files
    finally:
        shutil.rmtree(tmp)


class _Prefixed:
    """The arrays of an npz whose names start with a prefix, under their
    names without it (SVMModel.from_arrays reads such a mapping)."""

    def __init__(self, z, prefix):
        self.z, self.prefix = z, prefix
        self.files = [k[len(prefix):] for k in z.files if k.startswith(prefix)]

    def __getitem__(self, key):
        return self.z[self.prefix + key]


def served_model(data, name, dev, **overrides):
    """IsmClassifier of the committed `name`_codebook.ism on `dev`, at the
    bench's keypoint capacity."""
    from bench_data import KEYPOINT_CAPACITY
    from point_cloud_donkey_tpu_torch.models.codebook import (
        CodebookParams, load_codebook)
    from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                              PipelineConfig)
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    path = os.path.join(data, f"{name}_codebook.ism")
    config = IsmConfig.load(path)
    cb = load_codebook(path).to(dev)
    return IsmClassifier(
        cb, PipelineConfig.from_ism(config, cb.num_classes,
                                    keypoint_capacity=KEYPOINT_CAPACITY,
                                    **overrides),
        CodebookParams.from_config(config.child("Codebook")))


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


def shot_slot_library(args, shot_ops, card, name="shot_dense"):
    """The library yardstick of K7 (and of K3 and K3w, their tiles given
    as the clouds of a grid of 8 rows): one scatter_add_ over SHOT's five
    slot arrays (ops/shot.shot_bin_slots) of every (row, point) pair of the
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

    scatter, _ = slot_library(name, slots, shot_ops.DESC_LEN, b * k, card)
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


def windowed_descriptor_phase(pts, mask, kres, srt, cfg, k3_ms, record,
                              card):
    """Phase 2e: K3w at the windowed step's shapes -- the sorted batch, its
    normals, keypoints and LRFs, the keypoints co-sorted -- for the window
    required_window calibrates on the batch's keypoints (recorded) and for
    1024 (an inexact plan): its twin (counts equal, histograms within rtol
    1e-5 of the largest, the descriptor contract), two launches
    bit-equal, K7's counts and histograms (rtol 1e-6) where the plan is
    exact, its time beside K7's on the same sorted inputs and K3's, its
    bound and device time, and (calibrated window) one scatter_add_ over
    the windows' slot arrays.  Returns the calibrated window."""
    import torch

    from point_cloud_donkey_tpu_torch.models.pipeline import cosort_keypoints
    from point_cloud_donkey_tpu_torch.ops import binned
    from point_cloud_donkey_tpu_torch.ops import shot as kshot_ops
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as kshot
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast
    from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid

    n = pts.shape[1]
    window = binned.required_window(pts, mask, cfg.radius, tile_q=kshot.TK,
                                    q_points=kres.centroids,
                                    q_mask=kres.mask)
    print(f"descriptor window calibrated on the batch's keypoints "
          f"(required_window, tile_q=8, q_points): {window} of N={n}")
    sp, sm = srt.points, srt.mask
    nrm = compute_normals_fast(sp, sm, cfg.normal_radius)
    sk = voxel_grid(sp, sm, cfg.leaf_size, capacity=cfg.keypoint_capacity)
    skp = torch.where(sk.mask[..., None], sk.centroids,
                      torch.full_like(sk.centroids, 1e9))
    lrf = shot_lrf(skp, sk.mask, sp, sm, cfg.ref_frame_radius)
    kp, kk, fr, fv = (x.contiguous() for x in cosort_keypoints(
        skp, sk.mask, lrf.frames, lrf.valid, srt.axis))
    b, k = fv.shape
    tiles = k // kshot.TK
    live_ctas = int(fv.reshape(b, tiles, kshot.TK).any(-1).sum())
    dense_args = (kp, fr, fv, sp, nrm, sm, cfg.radius)
    dh, dc = kshot.shot_dense(*dense_args)
    k7_ms = cuda_ms(lambda: kshot.shot_dense(*dense_args), 20)
    # where K3w's time over K3's comes from: K7 on the unsorted batch's
    # grid (valid rows first, not co-sorted) and K3 on the sorted batch's
    # compacted tiles
    unrm = compute_normals_fast(pts, mask, cfg.normal_radius)
    ukp = torch.where(kres.mask[..., None], kres.centroids,
                      torch.full_like(kres.centroids, 1e9)).contiguous()
    ulrf = shot_lrf(ukp, kres.mask, pts, mask, cfg.ref_frame_radius)
    u_args = (ukp, ulrf.frames.contiguous(), ulrf.valid.contiguous(), pts,
              unrm, mask, cfg.radius)
    k7_unsorted_ms = cuda_ms(lambda: kshot.shot_dense(*u_args), 20)
    gidx, alive, tile_cloud = kshot.compact_layout(sk.mask)
    s_args = (torch.where(alive[:, None], skp.reshape(-1, 3)[gidx],
                          torch.full((1, 3), 1e9, device=pts.device)),
              lrf.frames.reshape(-1, 3, 3)[gidx].contiguous(), tile_cloud,
              sp, nrm, sm, cfg.radius)
    k3_sorted_ms = cuda_ms(lambda: kshot.shot_tiles(*s_args), 20)
    print(f"{'shot_windowed':20s} beside: K7 on the sorted batch's "
          f"co-sorted grid {k7_ms:.4f} ms, on the unsorted batch's grid "
          f"{k7_unsorted_ms:.4f} ms; K3 on the unsorted batch's tiles "
          f"{k3_ms:.4f} ms, on the sorted batch's {k3_sorted_ms:.4f} ms "
          f"({card})", flush=True)
    for w in (window, 1024):
        plan = binned.window_starts(kk, kk < binned.PARK, srt.keys,
                                    cfg.radius, w, tile_q=kshot.TK,
                                    align=128)
        starts = plan.starts.reshape(-1).contiguous()
        args = (kp, fr, fv, starts, sp, nrm, sm, w, cfg.radius)
        h, c = kshot.shot_windowed(*args)
        ph, pc = kshot.shot_windowed_plain(*args)
        assert torch.equal(c, pc), f"K3w counts differ from its twin (W={w})"
        herr = float((h - ph).abs().max())
        scale = float(ph.abs().max())
        assert herr <= 1e-5 * scale, \
            f"K3w histograms off by {herr:.3e} of {scale:.3e} (W={w})"
        cos, off = contract(normalize_descriptors(h, c, fv),
                            normalize_descriptors(ph, pc, fv), "K3w")
        again = kshot.shot_windowed(*args)
        assert torch.equal(h.view(torch.int32), again[0].view(torch.int32)) \
            and torch.equal(c, again[1]), f"two K3w launches differ (W={w})"
        exact = bool(plan.exact)
        vs_k7 = ""
        if exact:
            assert torch.equal(c, dc), f"K3w counts differ from K7's (W={w})"
            rel = float(((h - dh).abs() / dh.abs().clamp(min=1.0)).max())
            assert rel <= 1e-6, f"K3w histograms off K7's by {rel:.2e}"
            vs_k7 = f"; counts equal K7's, histograms within {rel:.2e} of K7's"
        ms = cuda_ms(lambda: kshot.shot_windowed(*args), 20)
        dev_ms = device_ms(lambda: kshot.shot_windowed(*args),
                           "WindowedTiles", 20)
        nb = nbytes(kp, fr, fv, starts, sp, nrm, sm, h, c)
        ops = int(c.sum()) * (GATE_OPS + SHOT_BODY_OPS)
        b_ms, by = bound(nb, ops)
        swept = int(fv.sum()) * w
        what = f"SHOT B={b} K={k} W={w}"
        print(f"{'shot_windowed':20s} {what} ({b * tiles} CTAs, {live_ctas} "
              f"with a live row, {int(fv.sum())} live rows; plan exact "
              f"{exact}): {swept:.3e} live pairs swept, in-radius share "
              f"{int(c.sum()) / swept:.4f}; {ms:.4f} ms, device "
              f"{fmt_ms(dev_ms)}; K7 on the same sorted inputs {k7_ms:.4f} "
              f"ms, K3 {k3_ms:.4f} ms (bound {b_ms:.4f} ms by {by}); counts "
              f"equal its twin's, histograms within {herr:.2e} (scale "
              f"{scale:.2e}), cosine min {cos:.7f}, {off:.2e} of entries off "
              f"by > 1e-3{vs_k7}; two launches bit-equal ({card})",
              flush=True)
        print(f"{'shot_windowed':20s} output bits (W={w}): sha256 "
              f"{digest(h, c)}")
        if w != window:
            continue
        # the library yardstick over the windows: the tiles as the clouds
        # of a grid of 8 rows, each over its window's points
        tcl = torch.div(torch.arange(b * tiles, device=pts.device), tiles,
                        rounding_mode="floor")[:, None]
        idx = starts.long()[:, None] + torch.arange(w, device=pts.device)
        inside = idx < n
        idx = idx.clamp(max=n - 1)
        lib = shot_slot_library(
            (kp.reshape(b * tiles, kshot.TK, 3),
             fr.reshape(b * tiles, kshot.TK, 3, 3),
             fv.reshape(b * tiles, kshot.TK), sp[tcl, idx], nrm[tcl, idx],
             sm[tcl, idx] & inside, cfg.radius), kshot_ops, card,
            "shot_windowed")
        record("shot_windowed", herr, ms,
               cuda_ms(lambda: kshot.shot_windowed_plain(*args), 2), what,
               nb, ops, lib)
    return window


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
