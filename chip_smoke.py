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
     scaled to millimetres and to 0.3 m);
 10. detection through ImplicitShapeModel (load, detect_batch, detect)
     against data/detect_reference.npz (the JAX package on the CPU): 10a
     configs/default.ism as shipped on 16 coloured scenes of 4 bench
     objects (8192 points, x0.3; CSHOT_GLOBAL + SVM verification), 10b
     configs/quickstart.ism as shipped on 32 bench clouds (x70), 10c the
     bench SHOT model with Hough3D, RANSAC and Merge on the scenes at unit
     scale -- each with clouds/s, processing_times per cloud, launches and
     peak memory, two runs and detect() of each cloud bit-equal to
     detect_batch, the voting stage on the committed JAX votes to the
     maxima contracts and the run end to end to the detection contract
     (tests/bench_data.py); 10d eval_detection.py --device cuda trains a
     SHORT_SHOT model and detects a scene;
 11. scene scale and keypoint culling against data/scene_reference.npz
     (tests/scene_fixtures.py: the JAX package on the CPU, with control
     runs of the JAX package against itself): 11a configs/rgbd_kinect.ism
     as shipped detecting two synthetic 640 x 480 Kinect frames
     (tests/kinect_data.py), K1 / K2 and K8 against their twins on the
     frame's window slabs and timed there, K4's time, the LRFs read
     against the exact float64 LRF (tests/scene_timing.py times K5 / K6
     fed the plan's starts); 11b default.ism with SOR, ROR and MLS on two
     100k-point scenes, each filter point by point; 11c VoxelGridCulling
     on a frame and on 16 bench clouds (tests/culling_check.py); 11d
     detect_batch of [frame, small, frame,
     small]; 11e training of rgbd_kinect.ism with a view above the scene
     threshold; 11f Hough3D + RANSAC + Merge on a 100k-point scene -- each
     with clouds/s, processing_times, launches and peak memory, and the
     phase's wall time; 11a also runs a frame's detect_batch with every
     plain twin on the card, each K1 / K2 / K8 / K4 call held to its
     twin on the same inputs at phase 2's tolerances, which bf16
     descriptors and bf16 codewords fail;
 12. the descriptor zoo and the keypoint detectors against
     data/zoo_reference.npz (tests/zoo_fixtures.py; configurations in
     tests/zoo_data.py, contracts in tests/detector_check.py): 12a
     quickstart.ism with Harris3D + FPFH, 12b default.ism with ISS3D +
     SHORT_CSHOT (SHORT_CSHOT_GLOBAL + SVM verification, chi-square), 12c
     quickstart.ism with SIFT3D + SHORT_SHOT (UseMinRadius, log radius;
     K9's new modes against its twin first) -- each trained and detecting
     through ImplicitShapeModel, every training cloud's keypoints and
     features against JAX's, the maxima end to end; 12d Harris3D / ISS3D
     + FPFH on a 1e5-point scene (the tiled detectors, FPFH's doubled
     window; peak memory); 12e eval_classification.py -t / -d on the card
     (the JAX CLI's labels);
 13. the rest of the descriptor zoo against data/zoo2_reference.npz
     (tests/zoo2_fixtures.py; configurations in tests/zoo2_data.py,
     contracts in tests/zoo2_check.py): 13a quickstart.ism with BSHOT,
     SHORT_SHOT_PCL, SpinImage, PFH, 3DSC, USC, RSD (both modes), RoPS and
     ESF_LOCAL; 13b default.ism verified by ESF, VFH, GRSD, GASD with and
     without colour, CVFH, OURCVFH and USC_GLOBAL, with COSPAIR, RIFT and
     GASD as local types; 13c NARF on rendered camera views -- each
     trained and detecting through ImplicitShapeModel (codebook, global
     rows, BSHOT's bits in their band, the maxima end to end: 12a's firm
     decisions on quickstart.ism, 12b's firm detections on default.ism);
     13d K4 and K4m against their twins on each new descriptor's rows (D
     up to 1980, negative entries);
 14. CGF, its embedding trainer and the LRF variants against
     data/zoo3_reference.npz (tests/zoo3_fixtures.py; configurations in
     tests/zoo3_data.py, contracts in tests/zoo2_check.py): 14a
     quickstart.ism with SHOT under SHOTNA, BOARD and FLARE and SHORT_SHOT
     under FLARE; 14b default.ism with CSHOT and CSHOT_GLOBAL + SVM under
     BOARD; 14c quickstart.ism with CGF and the shipped embedding under
     Euclidean distances (its raw rows on JAX's frames in their rounding
     band) -- each trained and detecting through ImplicitShapeModel (the
     codebook, the global rows, the maxima end to end); 14d K4 and K4m
     against their twins on 14c's CGF rows; 14e train_cgf_embedding.py's
     pairs generated on the card against the JAX tool's and 20 steps from
     its pairs and initial weights against its losses.
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
    # phase 10: detection through ImplicitShapeModel -- default.ism (CSHOT
    # under l2: K8 at the keypoints and at each ROI's centroid for
    # CSHOT_GLOBAL; no K4), quickstart.ism and the Hough3D detection (SHOT
    # under chi-square: K7, K4), eval_detection's SHORT_SHOT model (K9)
    "detect_default": ("lrf_moments", "sign_votes", "shot_hist"),
    "detect_quickstart": ("lrf_moments", "sign_votes", "shot_dense",
                          "chisq_topk"),
    "detect_hough": ("lrf_moments", "sign_votes", "shot_dense",
                     "chisq_topk"),
    "eval_detection": ("lrf_moments", "sign_votes", "histogram",
                       "chisq_topk"),
    # phase 11: scene scale and culling -- rgbd_kinect.ism (method 0 PCA
    # normals: K1 / K2 at the keypoint LRFs only; CSHOT under chi-square)
    # on frames, with culling, beside small clouds and in training;
    # default.ism with the filters (K1 / K2 for the method-2 normals too,
    # l2: no K4); the bench SHOT model's culling and Hough3D
    **{"scene_" + name: ("lrf_moments", "sign_votes", "shot_hist",
                         "chisq_topk")
       for name in ("kinect", "culling", "mixed", "train")},
    "scene_filters": ("lrf_moments", "sign_votes", "shot_hist"),
    **{"scene_" + name: ("lrf_moments", "sign_votes", "shot_dense",
                         "chisq_topk")
       for name in ("culling_curvature_auto", "culling_gaussian_threshold",
                    "hough")},
    # phase 12: the zoo -- Harris3D + FPFH (method-2 normals: K1 / K2; K4
    # at D = 33), ISS3D + SHORT_CSHOT (no normals: K1 / K2 at the keypoint
    # LRFs; K4 at D = 512), SIFT3D + SHORT_SHOT (K9's new modes), training
    # (the activation's K4) and detection; the scene's features (K1 / K2);
    # eval_classification on 12a's config
    **{pre + name: ("lrf_moments", "sign_votes", "chisq_topk")
       for pre in ("zoo_", "zoo_train_")
       for name in ("harris_fpfh", "iss_short_cshot")},
    "zoo_sift_short_shot": ("lrf_moments", "sign_votes", "histogram",
                            "chisq_topk"),
    "zoo_train_sift_short_shot": ("lrf_moments", "sign_votes", "histogram",
                                  "chisq_topk"),
    "zoo_scene_harris_fpfh": ("lrf_moments", "sign_votes"),
    "zoo_scene_iss_fpfh": ("lrf_moments", "sign_votes"),
    "zoo_eval": ("lrf_moments", "sign_votes", "chisq_topk"),
    # phase 13: the rest of the zoo -- 13a quickstart.ism (ChiSquared:
    # K4; the SHOT LRFs at the keypoints: K1 / K2; BSHOT and
    # SHORT_SHOT_PCL through K7), 13b default.ism (Euclidean: no K4; CSHOT
    # through K8 where it is the local type), 13c NARF (its own keypoints,
    # no LRF: K4 only)
    **{pre + name: ("lrf_moments", "sign_votes", "chisq_topk")
       + (("shot_dense",) if name in ("bshot", "short_shot_pcl") else ())
       for pre in ("zoo2_", "zoo2_train_")
       for name in ("bshot", "short_shot_pcl", "spin_image", "pfh", "3dsc",
                    "usc", "rsd", "rsd_min_max", "rops", "esf_local")},
    **{pre + name: ("lrf_moments", "sign_votes")
       + (("shot_hist",) if name.startswith("cshot_") else ())
       for pre in ("zoo2_", "zoo2_train_")
       for name in ("cospair_esf", "rift_vfh", "gasd_grsd", "cshot_gasd",
                    "cshot_gasd_shape", "cshot_cvfh", "cshot_ourcvfh",
                    "cshot_usc_global")},
    "zoo2_narf": ("chisq_topk",),
    "zoo2_train_narf": ("chisq_topk",),
    # phase 14: the LRF variants (plain torch) beside the method-2
    # normals' K1 / K2 (none for SHORT_SHOT), SHOT through K7 (14a,
    # ChiSquared: K4), SHORT_SHOT through K9, CSHOT and CSHOT_GLOBAL
    # through K8 (14b, Euclidean: no K4); CGF's own SHOT LRF and the
    # normals through K1 / K2 (14c, Euclidean); the trainer's pairs (14e:
    # the normals and CGF's LRF through K1 / K2)
    **{pre + name: ("lrf_moments", "sign_votes", "shot_dense", "chisq_topk")
       for pre in ("zoo3_", "zoo3_train_")
       for name in ("shot_shotna", "shot_board", "shot_flare")},
    **{pre + "short_shot_flare": ("histogram", "chisq_topk")
       for pre in ("zoo3_", "zoo3_train_")},
    **{pre + "cshot_board": ("lrf_moments", "sign_votes", "shot_hist")
       for pre in ("zoo3_", "zoo3_train_")},
    **{pre + "cgf": ("lrf_moments", "sign_votes")
       for pre in ("zoo3_", "zoo3_train_")},
    "zoo3_trainer": ("lrf_moments", "sign_votes"),
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
# phase 11: at NormalRadius 5 mm the frames' and views' normals rest on
# a few noisy neighbours, and the JAX package does not agree with itself
# when only its sums run in another order (scene_reference.npz's control
# runs): the card's share of a frame's descriptors at cosine > 0.999 may
# fall SPREAD_MARGIN below the control's, its share of entries off by more
# than 1e-3 rise ENTRY_MARGIN above it; its trained codewords at cosine >
# 0.999 may fall CODEBOOK_MARGIN below the control training's.  Each
# margin lies between the card's reading and that of its descriptors or
# codewords with 2% noise, which the phase checks it rejects (PERF.md
# gives the readings)
SPREAD_MARGIN = 0.02
ENTRY_MARGIN = 0.015
CODEBOOK_MARGIN = 0.01
# scene_reference.npz keeps every DESC_STRIDE-th scene feature
DESC_STRIDE = 100


def descriptor_spread(x, y):
    """(share of rows at cosine > 0.999, share of entries off by more than
    1e-3, median cosine) of descriptors x against y."""
    import numpy as np
    cos = (x * y).sum(1) / np.maximum(np.linalg.norm(x, axis=1)
                                      * np.linalg.norm(y, axis=1), 1e-30)
    return (float((cos > 0.999).mean()), float((np.abs(x - y) > 1e-3).mean()),
            float(np.median(cos)))


def within_spread(reading, control):
    """A descriptor_spread reading within the control's plus the margins."""
    return reading[0] >= control[0] - SPREAD_MARGIN and \
        reading[1] <= control[1] + ENTRY_MARGIN


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

    # -- 10. detection through ImplicitShapeModel ---------------------------
    detection_ism(launches, card, data, dev)

    # -- 11. scene scale and keypoint culling ---------------------------------
    scene_phase(launches, card, data, dev)

    # -- 12. the descriptor zoo and the keypoint detectors -------------------
    zoo_phase(launches, card, data, dev)

    # -- 13. the rest of the descriptor zoo and the whole-cloud globals -------
    zoo2_phase(launches, card, data, dev)

    # -- 14. CGF, its embedding trainer and the LRF variants -------------------
    zoo3_phase(launches, card, data, dev)

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


def detection_ism(launches, card, data, dev):
    """Phase 10: detection through ImplicitShapeModel (load, detect_batch,
    detect) on the card, for each detection of tests/bench_data (default,
    quickstart, hough), against data/detect_reference.npz (the JAX package
    on the CPU, dense descriptors): one counted detect_batch with clouds/s,
    processing_times per cloud, launches and peak memory; a second run
    and detect() of every cloud equal to it bit for bit; the voting stage
    on the committed JAX votes to the maxima contracts
    (bench_data.maxima_mismatches); the run's maxima end to end to the
    detection contract (bench_data.firm_mismatches; quickstart: the best
    class on every firm cloud).  Then 10d: eval_detection.py on the card,
    training a SHORT_SHOT model and detecting a scene, as the JAX
    package's tests/test_detection.py drives its CLI."""
    import numpy as np
    import torch

    from bench_data import (DETECT_SCALES, GLOBAL_RTOL_CARD, HOUGH_VOTING,
                            detect_inputs, firm_decision, firm_mismatches,
                            firm_pairs, firm_rtol, maxima_mismatches,
                            unpack_maxima, unpack_votes, with_voting)
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.codebook import CastVotes
    from point_cloud_donkey_tpu_torch.models.ism import (
        DETECT_STAGES, ImplicitShapeModel, _voting_params)
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

    with np.load(os.path.join(data, "detect_reference.npz")) as z:
        ref = dict(z)
    what = {"default": "10a. configs/default.ism as shipped (CSHOT, MVBB, "
                       "AverageRotation, CSHOT_GLOBAL + SVM verification)",
            "quickstart": "10b. configs/quickstart.ism as shipped (SHOT, "
                          "chi-square, single-object, max type None)",
            "hough": "10c. the bench SHOT model: Hough3D with interpolation, "
                     "RANSAC, Merge"}
    for name in ("default", "quickstart", "hough"):
        clouds, rgbs = detect_inputs(name)
        scale = DETECT_SCALES[name]
        phase(f"{what[name]}: detect_batch of {len(clouds)} clouds x "
              f"{clouds.shape[1]} points, x{scale:g} ({card})")
        if name == "hough":
            path = os.path.join(data, "bench_codebook.ism")
            ism = ImplicitShapeModel.load(path, device=dev)
            with open(path) as f:
                ism.config = IsmConfig.from_json(with_voting(json.load(f),
                                                             HOUGH_VOTING))
        else:
            ism = ImplicitShapeModel.load(
                os.path.join(data, f"{name}_model.ism"), device=dev)
        clist = list(clouds)
        rlist = None if rgbs is None else list(rgbs)
        ism.detect_batch(clist[:2], None, None if rlist is None
                         else rlist[:2])                      # warm-up
        torch.cuda.synchronize()
        before = dict(ism.processing_times)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = ism.detect_batch(clist, None, rlist)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        launches["detect_" + name] = counts
        per = {k: round((res[-1][1][k] - before.get(k, 0.0)) * 1e3
                        / len(clist), 3) for k in DETECT_STAGES}
        print(f"throughput: {len(clist) / dt:.2f} clouds/s (one detect_batch "
              f"of {len(clist)}, host clock) ({card})")
        print(f"processing_times ms per cloud: {per}")
        print(f"launches: { {k: v for k, v in counts.items() if v} }")
        print(f"peak device memory: {peak / 2**20:.1f} MiB "
              f"({(peak - held) / 2**20:.1f} MiB above the "
              f"{held / 2**20:.1f} MiB held before it) ({card})")
        missing = [k for k in PATH_KERNELS["detect_" + name]
                   if counts[k] == 0]
        assert not missing, f"{name}: kernels not launched {missing}"
        got = [m for m, _ in res]
        again = ism.detect_batch(clist, None, rlist)
        for i, (a, (b, _)) in enumerate(zip(got, again)):
            assert maxima_bits(a) == maxima_bits(b), \
                f"{name}: two runs differ on cloud {i}"
        for i in range(len(clist)):
            one = ism.detect(clist[i], None,
                             None if rlist is None else rlist[i])[0]
            assert maxima_bits(one) == maxima_bits(got[i]), \
                f"{name}: detect of cloud {i} differs from detect_batch"
        print(f"two runs equal bit for bit; detect() of each cloud equals "
              f"its detect_batch row; {sum(map(len, got))} maxima")

        pre = f"{name}_max_"
        want = unpack_maxima({k[len(pre):]: v for k, v in ref.items()
                              if k.startswith(pre)})
        pre = f"{name}_vote_"
        votes = [CastVotes(valid=np.ones(len(v["weight"]), bool), **{
            k: a.astype(np.int64 if k in ("class_id", "instance_id")
                        else np.float32) for k, a in v.items()})
            for v in unpack_votes({k[len(pre):]: v for k, v in ref.items()
                                   if k.startswith(pre)})]
        vparams = _voting_params(ism.config.child("Voting"))
        t0 = time.perf_counter()
        ms_pre = ism._precompute_mean_shift_batch(votes, vparams)
        stage = [ism._finish_detect(votes[i], clist[i], None,
                                    None if rlist is None else rlist[i],
                                    vparams, None, ms_pre[i])
                 for i in range(len(votes))]
        t_stage = time.perf_counter() - t0
        bad = [(i, b) for i, (g, w) in enumerate(zip(stage, want))
               for b in [maxima_mismatches(g, w, scale, GLOBAL_RTOL_CARD)]
               if b]
        pairs = [(m.glob_class_weight, float(r["glob_class_weight"]))
                 for g, w in zip(stage, want) if len(g) == len(w)
                 for m, r in zip(g, w) if r["glob_class_weight"] > 0]
        if name == "default" and pairs:
            print(f"global scores: max relative difference to JAX's "
                  f"{max(abs(a - b) / b for a, b in pairs):.3e} over "
                  f"{len(pairs)} maxima (rank order)")
        print(f"voting stage on the committed JAX votes "
              f"({sum(len(v.weight) for v in votes)} votes, "
              f"{t_stage * 1e3 / len(votes):.2f} ms a cloud): "
              f"{len(votes) - len(bad)}/{len(votes)} clouds meet the maxima "
              f"contracts ({sum(map(len, want))} JAX maxima)")
        assert not bad, f"{name}: voting stage vs the JAX maxima: {bad[:3]}"
        full = sum(not maxima_mismatches(g, w, scale, GLOBAL_RTOL_CARD)
                   for g, w in zip(got, want))
        if name == "quickstart":
            firm = [i for i, w in enumerate(want) if firm_decision(w)]
            agree = [i for i in firm if got[i] and got[i][0].class_id
                     == int(want[i][0]["class_id"])]
            print(f"end to end: maxima[0].class_id equals JAX's on "
                  f"{len(agree)}/{len(firm)} firm clouds (margin > 0.1); "
                  f"{full}/{len(got)} clouds meet the maxima contracts too")
            assert firm and len(agree) == len(firm), \
                f"quickstart: decisions differ on {set(firm) - set(agree)}"
        else:
            bw = ism.config.child("Voting").get("Bandwidth", 0.1)
            bad = [(i, b) for i, (g, w) in enumerate(zip(got, want))
                   for b in [firm_mismatches(g, w, bw, firm_rtol(
                       vparams.voting_type))] if b]
            matched = [(float(g.weight), float(w["weight"]))
                       for gs, ws in zip(got, want)
                       for _, w, g in firm_pairs(gs, ws, bw) if g is not None]
            dev_w = max((abs(a - b) / b for a, b in matched), default=0.0)
            print(f"end to end: {len(matched)} firm JAX maxima matched (max "
                  f"relative weight difference {dev_w:.3e}), "
                  f"{len(got) - len(bad)}/{len(got)} clouds meet the "
                  f"detection contract; {full}/{len(got)} clouds meet the "
                  f"maxima contracts too")
            assert not bad, f"{name}: end to end vs JAX: {bad[:3]}"
            if name == "default":
                glob = sum(m.glob_class_weight > 0 for ms_ in got
                           for m in ms_)
                print(f"global verification: {glob} maxima with an SVM "
                      f"score")

    phase(f"10d. eval_detection.py --device cuda: train a SHORT_SHOT model, "
          f"detect a scene ({card})")
    eval_detection_on_card(launches, str(dev))


def timed_detect(ism, clouds, rgbs, key, launches, card):
    """One counted detect_batch of `clouds` (host clock): prints clouds/s,
    processing_times ms per cloud, launches and peak memory above what was
    held; asserts the launches of PATH_KERNELS[key]; returns the maxima
    lists."""
    import torch
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.ism import DETECT_STAGES
    torch.cuda.synchronize()
    before = dict(ism.processing_times)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = ism.detect_batch(list(clouds), None,
                           None if rgbs is None else list(rgbs))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches[key] = counts
    per = {k: round((res[-1][1][k] - before.get(k, 0.0)) * 1e3
                    / len(clouds), 3) for k in DETECT_STAGES}
    print(f"throughput: {len(clouds) / dt:.3f} clouds/s (one detect_batch "
          f"of {len(clouds)}, {dt:.3f} s, host clock) ({card})")
    print(f"processing_times ms per cloud: {per}")
    print(f"launches: { {k: v for k, v in counts.items() if v} }")
    print(f"peak device memory: {peak / 2**20:.1f} MiB "
          f"({(peak - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB held before it) ({card})")
    missing = [k for k in PATH_KERNELS[key] if counts[k] == 0]
    assert not missing, f"{key}: kernels not launched {missing}"
    return [m for m, _ in res]


def scene_phase(launches, card, data, dev):
    """Phase 11: scene scale (the tiled path of ops/tiled.py) and keypoint
    culling on the card, against data/scene_reference.npz (the JAX package
    on the CPU, dense descriptors; tests/scene_fixtures.py):
      11a configs/rgbd_kinect.ism as shipped (the JAX-trained
          data/kinect_model.ism) detecting two synthetic 640 x 480 Kinect
          frames (tests/kinect_data.py): keypoints equal to JAX's, the
          descriptors and the firm detections within the spread of the
          JAX package against itself under another exact tiling (the
          reference's control run; the card's descriptors with 2% noise
          fall outside it), the LRFs read against their plain twins and
          the exact float64 LRF, detect() = detect_batch bit for bit;
          K1 / K2 and K8 against their twins on four of the frame's
          slabs, their times at the frame's shapes and K4's, with bounds;
      11b configs/default.ism's model with SOR, ROR and MLS on
          (kinect_data.FILTER_PARAMS) on two ~100k-point scenes: each
          filter's mask point by point against JAX's (a point decided
          otherwise lies at the filter's rounding), the MLS positions,
          the firm detections;
      11c VoxelGridCulling: KPQ + ColorDistance on a frame (the tiled
          culling, on JAX's normals): the same voxel keypoints, the
          geometry scores within the JAX package's own spread under an
          ulp move of the frame, each colour score JAX's but at a pair
          of the radius gate's rounding, each culling its scores'
          decisions and no more keypoints moved than that control moves
          (tests/culling_check.py); Curvature + Auto, Gaussian +
          Threshold on 16 bench clouds (the batched culling): the kept
          voxel keypoints JAX's but within rtol 1e-4 of a threshold;
      11d detect_batch of [frame, small, frame, small]: the order kept,
          each row detect() of its cloud bit for bit;
      11e ImplicitShapeModel.train of rgbd_kinect.ism on the views, one
          above the scene threshold: the codebook against the committed
          JAX-trained one, within the spread of a JAX control training
          (its codewords with 2% noise fall outside it);
      11f the bench SHOT model with Hough3D, RANSAC and Merge on one
          ~100k-point scene at unit scale: the firm detections."""
    import numpy as np
    import torch

    import kinect_data as kd
    from bench_data import (FIRM_RTOL, FIRM_RTOL_HOUGH, HOUGH_VOTING,
                            bench_clouds, bench_scenes, firm_mismatches,
                            unpack_maxima, with_voting)
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                         preprocess_cloud)
    from point_cloud_donkey_tpu_torch.ops import tiled
    from point_cloud_donkey_tpu_torch.utils.config import (ComponentConfig,
                                                           IsmConfig)
    from point_cloud_donkey_tpu_torch.utils.io import PointCloud, save_pcd

    t_phase = time.perf_counter()
    with np.load(os.path.join(data, "scene_reference.npz")) as z:
        ref = dict(z)
    frames = [kd.kinect_frame(s) for s in kd.FRAME_SEEDS]
    hashes = [kd.frame_hash(f) for f in frames]
    assert hashes == [str(h) for h in ref["frame_hash"]], \
        f"the frames differ from the reference's: {hashes}"
    ctx = SceneContext(launches, card, data, dev, ref, frames)
    for step in (scene_frames, scene_filters, scene_culling, scene_mixed,
                 scene_training, scene_hough):
        step(ctx)
    print(f"phase 11 wall time: {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


@dataclasses.dataclass
class SceneContext:
    launches: dict
    card: str
    data: str
    dev: object
    ref: dict
    frames: list

    def ref_maxima(self, prefix):
        from bench_data import unpack_maxima
        pre = prefix + "max_"
        return unpack_maxima({k[len(pre):]: v for k, v in self.ref.items()
                              if k.startswith(pre)})

    def model_json(self, name):
        with open(os.path.join(self.data, name)) as f:
            return json.load(f)

    def path(self, name):
        return os.path.join(self.data, name)


def scene_frames(ctx):
    """11a."""
    import numpy as np
    from scipy.spatial import cKDTree
    import kinect_data as kd
    from bench_data import FIRM_RTOL
    from culling_check import coord_tol
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    launches, card, dev, ref, frames = (ctx.launches, ctx.card, ctx.dev,
                                        ctx.ref, ctx.frames)
    kinect_path = ctx.path("kinect_model.ism")
    phase(f"11a. configs/rgbd_kinect.ism as shipped (CSHOT r 0.05, LRF "
          f"0.05, leaf 0.02, NormalRadius 0.005, method 0, chi-square "
          f"1-NN): detect_batch of {len(frames)} Kinect frames, "
          f"{kd.WIDTH} x {kd.HEIGHT}, "
          f"{', '.join(str(len(f.xyz)) for f in frames)} points ({card})")
    ism = ImplicitShapeModel.load(kinect_path, device=dev)
    view = kd.training_views()[0][0]
    ism.detect_batch([view.xyz], None, [view.rgb])              # warm-up
    got = timed_detect(ism, [f.xyz for f in frames],
                       [f.rgb for f in frames], "scene_kinect", launches,
                       card)
    for i, f in enumerate(frames):
        one = ism.detect(f.xyz, None, f.rgb)[0]
        assert maxima_bits(one) == maxima_bits(got[i]), \
            f"11a: detect of frame {i} differs from detect_batch"
    print("detect() of each frame equals its detect_batch row bit for bit")
    fcfg = FeatureConfig.from_config(ism.config.child("Features"))
    kpp = tkp.KeypointParams.from_config(ism.config.child("Keypoints"))
    nr = ism.root.get("NormalRadius", 0.05)
    cm = ism.root.get("ConsistentNormalsMethod", 2)
    bw = ism.config.child("Voting").get("Bandwidth", 0.1)
    for i, (s, f) in enumerate(zip(kd.FRAME_SEEDS, frames)):
        pre = f"a_{s}_"
        fs = extract_local_features_batch(
            [f.xyz], [None], [f.rgb], fcfg, kpp, nr, cm, dev,
            ism.lrf_version, is_training=False)[0]
        # equal sets: the same count, each JAX keypoint's nearest within
        # coord_tol (keys tied along the sort axis may come in another
        # order; voxel means summed in another order differ by ulps)
        want_kp = ref[pre + "kp"]
        assert fs.positions.shape == want_kp.shape, \
            f"11a frame {s}: {len(fs.positions)} keypoints, JAX " \
            f"{len(want_kp)}"
        dist, near_i = cKDTree(fs.positions).query(want_kp)
        moved = int((dist > coord_tol(want_kp)).sum())
        print(f"frame {s}: {len(fs.positions)} keypoints, {moved} off "
              f"JAX's by more than {coord_tol(want_kp):.1e} m (largest "
              f"{float(dist.max()):.2e} m)")
        assert moved == 0, f"11a frame {s}: {moved} keypoints off JAX's"
        rows = near_i[::DESC_STRIDE]
        got_d = fs.descriptors[rows]
        want_d = ref[pre + "desc"]
        ctl = descriptor_spread(ref[pre + "ctl_desc"], want_d)
        sound = descriptor_spread(got_d, want_d)
        rng = np.random.default_rng(0)
        noise2 = descriptor_spread(got_d * (1 + 0.02 * rng.standard_normal(
            got_d.shape)).astype(np.float32), want_d)
        frames_ok = float((np.abs(fs.frames[rows] - ref[pre + "frames"]).max(
            axis=(1, 2)) < 2e-3).mean())
        print(f"frame {s}, every {DESC_STRIDE}th feature ({len(rows)}) vs "
              f"JAX's: cosine > 0.999 on {100 * sound[0]:.2f}%, "
              f"{100 * sound[1]:.3f}% of entries off by > 1e-3, median "
              f"cosine {sound[2]:.5f}, LRFs within 2e-3 "
              f"{100 * frames_ok:.1f}%; the JAX control "
              f"{100 * ctl[0]:.2f}%, {100 * ctl[1]:.3f}%, {ctl[2]:.5f}; the "
              f"card's with 2% noise {100 * noise2[0]:.2f}%, "
              f"{100 * noise2[1]:.3f}%, {noise2[2]:.5f}")
        assert within_spread(sound, ctl), \
            f"11a frame {s}: descriptors outside the reference's spread"
        assert not within_spread(noise2, ctl), \
            f"11a frame {s}: the spread check passes 2% noise"
        if i == 0:
            shares = lrf_witness(f, want_kp[::DESC_STRIDE],
                                 ref[pre + "frames"], fcfg, kpp, dev)
            assert shares["exact_kernel"] >= shares["exact_jax"], \
                "11a: the card's LRFs are farther from the exact ones " \
                "than JAX's"
        bad, unstable = kd.stable_mismatches(
            got[i], ctx.ref_maxima(pre)[0], ctx.ref_maxima(pre + "ctl_")[0], bw,
            FIRM_RTOL)
        print(f"frame {s}: {len(got[i])} maxima, firm JAX maxima the "
              f"control also finds met ({unstable} the control misses)")
        assert not bad, f"11a frame {s}: {bad[:3]}"
    frame_kernel_times(frames[0], fcfg, kpp, nr, dev, card, ism)
    frame_twin_route(frames[0], dev, card, ism)


def scene_filters(ctx):
    """11b."""
    import numpy as np
    import torch
    import kinect_data as kd
    from bench_data import FIRM_RTOL, bench_scenes, firm_mismatches
    from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                         preprocess_cloud)
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    from point_cloud_donkey_tpu_torch.utils.io import PointCloud
    launches, card, dev, ref = ctx.launches, ctx.card, ctx.dev, ctx.ref
    scenes, srgb, _ = bench_scenes(kd.FILTER_SCENES, scale=kd.FILTER_SCALE,
                                   n=kd.FILTER_POINTS, seed=kd.FILTER_SEED)
    phase(f"11b. configs/default.ism with {kd.FILTER_PARAMS} on "
          f"{len(scenes)} scenes x {scenes.shape[1]} points "
          f"(x{kd.FILTER_SCALE:g}) ({card})")
    ism = ImplicitShapeModel.load(ctx.path("default_model.ism"), device=dev)
    ism.config = IsmConfig.from_json(kd.with_params(
        ctx.model_json("default_model.ism"), kd.FILTER_PARAMS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_c = [preprocess_cloud(PointCloud(xyz=c, rgb=r), ism.root, dev)
             for c, r in zip(scenes, srgb)]
    torch.cuda.synchronize()
    print(f"preprocessing (tiled SOR, ROR, MLS): "
          f"{(time.perf_counter() - t0) * 1e3 / len(scenes):.1f} ms a "
          f"scene; kept {[len(p.xyz) for p in pre_c]} (JAX "
          f"{ref['b_size'].tolist()})")
    for i, (c, p) in enumerate(zip(scenes, pre_c)):
        filter_contract(c, p.xyz, ism.root, ref, i, dev)
    got = timed_detect(ism, [p.xyz for p in pre_c], [p.rgb for p in pre_c],
                       "scene_filters", launches, card)
    bw = ism.config.child("Voting").get("Bandwidth", 0.1)
    bad = [(i, b) for i, (g, w) in enumerate(zip(got, ctx.ref_maxima("b_")))
           for b in [firm_mismatches(g, w, bw, FIRM_RTOL)] if b]
    print(f"{sum(map(len, got))} maxima; {len(got) - len(bad)}/{len(got)} "
          f"scenes meet the detection contract")
    assert not bad, f"11b: {bad[:3]}"


def filter_contract(xyz, kept_xyz, root, ref, i, dev):
    """11b's per-point contract for scene i: the steps of preprocess_cloud's
    scene branch again on the card (their output equal to `kept_xyz`, what
    the path kept), each mask against JAX's (scene_reference.npz): a point
    SOR decides otherwise lies within rtol 1e-4 of the SOR threshold on the
    card; one ROR decides otherwise has an in-radius count that JAX's may
    reach through pairs at the radius gate's rounding band or SOR's other
    decisions within the radius; MLS positions of the points both keep,
    with no point kept by one side only within the smoothing radius,
    within rtol 1e-3, atol 1e-4 of JAX's (tests/test_tiled.py's MLS
    contract) but where a neighbour lies at the smoothing radius's
    rounding band."""
    import numpy as np
    import torch
    from point_cloud_donkey_tpu_torch.models.features import pad_cloud
    from point_cloud_donkey_tpu_torch.ops import tiled
    from point_cloud_donkey_tpu_torch.ops.neighbors import full_fp32
    eps = float(np.finfo(np.float32).eps)
    axis = tiled.sort_key_axis(xyz)
    xyz = xyz[np.argsort(xyz[:, axis], kind="stable")]
    n = len(xyz)
    pts_h, mask_h = pad_cloud(xyz)
    key = pts_h[:, axis]
    pts = torch.from_numpy(pts_h).to(dev)
    mask = torch.from_numpy(mask_h).to(dev)
    with full_fp32():
        plan = tiled.plan_tiles(key, mask_h, key, 0.0, tiled.NORMALS_CHUNK,
                                min_window=4096)
        mean_d = tiled.tiled_knn_mean_distances(
            pts, mask, plan, root.get("OutlierRemovalMeanK", 20))
        thresh = tiled.sor_threshold(mean_d, mask, root.get(
            "OutlierRemovalStddevMul", 2.0))
        sor = mask & (mean_d <= thresh)
        r = root.get("OutlierRemovalRadius", 0.005)
        ror = tiled.tiled_radius_outlier_removal(
            pts, sor, tiled.plan_tiles(key, mask_h, key, r,
                                       tiled.NORMALS_CHUNK), r,
            root.get("OutlierRemovalMinNeighbors", 10))
        rs = root.get("SmoothingRadius", 0.01)
        mls = tiled.tiled_mls_smooth(pts, ror, tiled.plan_tiles(
            key, mask_h, key, rs, tiled.NORMALS_CHUNK), rs)
    keep = ror[:n].cpu().numpy()
    assert np.array_equal(mls[:n].cpu().numpy()[keep], kept_xyz), \
        f"11b scene {i}: the steps differ from preprocess_cloud"
    sor_j = np.unpackbits(ref[f"b_{i}_sor"])[:n].astype(bool)
    ror_j = np.unpackbits(ref[f"b_{i}_ror"])[:n].astype(bool)
    sor_c = sor[:n].cpu().numpy()
    t = float(thresh)
    md = mean_d[:n].cpu().numpy()
    sor_diff = np.nonzero(sor_c != sor_j)[0]
    sor_bad = [int(j) for j in sor_diff
               if abs(md[j] - t) > 1e-4 * t]
    # ROR: each differing point's in-radius count against the minimum,
    # with the pairs that can go either way
    ror_diff = np.nonzero((ror[:n].cpu().numpy() != ror_j) & sor_c & sor_j)[0]
    r2 = float(np.float32(r * r))
    flip = torch.from_numpy(sor_c != sor_j).to(dev)
    p = pts[:n]
    p2 = (p * p).sum(-1)
    ror_bad = []
    for j in ror_diff.tolist():
        d2 = tiled.sqdist(p[j][None, None], p[None])[0, 0]
        band = (d2 - r2).abs() <= 8 * eps * (p2[j] + p2)
        inside = (d2 <= r2) & sor[:n]
        slack = int((band | ((d2 <= r2) & flip)).sum())
        count = int(inside.sum()) - 1
        need = root.get("OutlierRemovalMinNeighbors", 10)
        if not (count - need < slack if count >= need
                else need - count <= slack):
            ror_bad.append(j)
    # MLS: the points both keep, but those whose smoothing radius holds a
    # point one side keeps only (their neighbourhoods differ)
    one_side = torch.from_numpy(np.nonzero(keep != ror_j)[0]).to(dev)
    both = keep & ror_j
    if len(one_side):
        d2 = tiled.sqdist(p[None], p[one_side][None])[0]
        both &= ~(d2 <= (rs * (1 + 1e-3)) ** 2).any(1).cpu().numpy()
    got = mls[:n].cpu().numpy()[both]
    want = np.zeros((n, 3), np.float32)
    want[ror_j] = ref[f"b_{i}_xyz"]
    want = want[both]
    err = (np.abs(got - want) - 1e-3 * np.abs(want)).max(1)
    # a point off the MLS contract must have a neighbour at the smoothing
    # radius's rounding band: one side may count it, the other not
    rs2 = float(np.float32(rs * rs))
    ror_k = ror[:n]
    mls_bad = []
    for j in np.nonzero(both)[0][err > 1e-4].tolist():
        d2 = tiled.sqdist(p[j][None, None], p[None])[0, 0]
        band = ((d2 - rs2).abs() <= 8 * eps * (p2[j] + p2)) & ror_k
        if not bool(band.any()):
            mls_bad.append(j)
    print(f"scene {i}: SOR kept {int(sor_c.sum())} (JAX {int(sor_j.sum())}), "
          f"{len(sor_diff)} decided otherwise, each within rtol 1e-4 of the "
          f"threshold {t:.6g} but {len(sor_bad)}; ROR kept "
          f"{int(keep.sum())} (JAX {int(ror_j.sum())}), {len(ror_diff)} "
          f"decided otherwise, each at a pair of the gate's rounding or "
          f"SOR's other decisions but {len(ror_bad)}; MLS of the "
          f"{int(both.sum())} both keep with the same neighbours: largest "
          f"|d| - 1e-3 |p| {float(err.max(initial=0.0)):.2e} m, "
          f"{int((err > 1e-4).sum())} over atol 1e-4, each with a neighbour "
          f"at the smoothing radius's rounding but {len(mls_bad)}")
    assert not sor_bad, f"11b scene {i}: SOR decides {sor_bad[:5]} otherwise"
    assert not ror_bad, f"11b scene {i}: ROR decides {ror_bad[:5]} otherwise"
    assert not mls_bad, f"11b scene {i}: MLS positions {mls_bad[:5]}"


def scene_culling(ctx):
    """11c."""
    import numpy as np
    import torch
    import culling_check as cc
    import kinect_data as kd
    from bench_data import bench_clouds
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.ops import tiled
    from point_cloud_donkey_tpu_torch.utils.config import (ComponentConfig,
                                                           IsmConfig)
    launches, card, dev, ref = ctx.launches, ctx.card, ctx.dev, ctx.ref
    kinect_path = ctx.path("kinect_model.ism")
    f = ctx.frames[0]
    axis = tiled.sort_key_axis(f.xyz)
    order = np.argsort(f.xyz[:, axis], kind="stable")
    xyz_s, rgb_s = f.xyz[order], f.rgb[order]
    nrm = ref["c_normals"]
    params = tkp.KeypointParams.from_config(ComponentConfig.from_json(
        kd.KINECT_CULLING))
    phase(f"11c. VoxelGridCulling on a frame (KPQ + ColorDistance, CutOff "
          f"0.5, RequireCombinedList, refined), the tiled culling on JAX's "
          f"normals ({card})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tkp.detect_keypoints(xyz_s, nrm, rgb_s, params, dev)[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"culling: {len(got)} keypoints kept (JAX {len(ref['c_kp'])}), "
          f"{dt * 1e3:.1f} ms ({card})")
    # the same voxel keypoints, then the scores, then the decisions
    kp, kn, kr = tkp.voxel_keypoints(xyz_s, nrm, rgb_s, params.leaf_size,
                                     dev)
    assert kp.shape == ref["c_voxel"].shape and np.abs(
        kp - ref["c_voxel"]).max() <= cc.coord_tol(kp), \
        "11c: the voxel keypoints differ from JAX's"
    geo, col = tkp.cloud_culling_scores(kp, kn, kr, xyz_s, nrm, rgb_s,
                                        params, dev)
    want = (ref["c_geo"], ref["c_col"])
    ctl = (ref["c_ctl_geo"], ref["c_ctl_col"])
    rng = np.random.default_rng(0)
    spreads = {name: cc.score_spread(g, want[0]) for name, g in (
        ("card", geo), ("control", ctl[0]),
        ("card with 0.1% noise", (geo * (1 + 1e-3 * rng.standard_normal(
            len(geo)))).astype(np.float32)))}
    print("geometry (KPQ) scores vs JAX's -- share off by rtol > 1e-4, "
          "share off by rtol > 1e-2, largest: " + "; ".join(
              f"{k} {100 * a:.2f}%, {100 * b:.2f}%, {c:.4f}"
              for k, (a, b, c) in spreads.items()))
    assert cc.within_score_spread(spreads["card"], spreads["control"]), \
        "11c: the geometry scores outside the JAX control's spread"
    assert not cc.within_score_spread(spreads["card with 0.1% noise"],
                                      spreads["control"]), \
        "11c: the score spread check passes 0.1% noise"
    stats = colour_pair_stats(kp, kr, xyz_s, rgb_s, params, dev)
    assert np.array_equal((stats[:, 1] / np.maximum(stats[:, 0], 1)).astype(
        np.float32), col), "11c: the tiled colour counts differ from the " \
        "brute-force ones"
    explained = cc.colour_explained(stats, want[1])
    print(f"colour scores: {int((col != want[1]).sum())} differ from JAX's "
          f"(the JAX control: {int((ctl[1] != want[1]).sum())}), each at "
          f"a pair of the radius gate's rounding band ({int(stats[:, 3].sum())}"
          f" such pairs) or of the colour threshold's rtol {cc.RTOL:g} "
          f"({int(stats[:, 2].sum())}); unexplained: "
          f"{int((~explained).sum())}")
    assert explained.all(), \
        f"11c: colour scores {np.nonzero(~explained)[0][:10]} unexplained"
    cc.check_culled(kp, want, (geo, col), ref["c_kp"], got, params,
                    "11c frame", control=(ctl, ref["c_ctl_kp"]))
    kism = ImplicitShapeModel.load(kinect_path, device=dev)
    kism.config = IsmConfig.from_json(kd.with_child(
        ctx.model_json("kinect_model.ism"), "Keypoints", kd.KINECT_CULLING))
    got = timed_detect(kism, [f.xyz], [f.rgb], "scene_culling", launches,
                       card)
    assert got[0] and all(np.isfinite(m.weight) for m in got[0])
    _, _, bclouds, _ = bench_clouds(kd.CULL_CLOUDS)
    bench_path = ctx.path("bench_codebook.ism")
    for name, node in kd.BENCH_CULLING.items():
        phase(f"11c. {name} on {kd.CULL_CLOUDS} bench clouds, the batched "
              f"culling ({card})")
        bism = ImplicitShapeModel.load(bench_path, device=dev)
        bism.config = IsmConfig.from_json(kd.with_child(
            ctx.model_json("bench_codebook.ism"), "Keypoints", node))
        timed_detect(bism, list(bclouds), None, "scene_culling_" + name,
                     launches, card)
        bp = tkp.KeypointParams.from_config(ComponentConfig.from_json(node))
        fss = extract_local_features_batch(
            list(bclouds), [None] * len(bclouds), [None] * len(bclouds),
            FeatureConfig.from_config(bism.config.child("Features")), bp,
            bism.root.get("NormalRadius", 0.05),
            bism.root.get("ConsistentNormalsMethod", 2), dev,
            bism.lrf_version, is_training=False)
        pos = np.split(ref[f"c_{name}_pos"],
                       np.cumsum(ref[f"c_{name}_count"])[:-1])
        geos = np.split(ref[f"c_{name}_geo"],
                        np.cumsum(ref[f"c_{name}_geo_count"])[:-1])
        near_all = 0
        for i, (c, fs, w, g) in enumerate(zip(bclouds, fss, pos, geos)):
            vk = tkp.voxel_keypoints(c, None, None, bp.leaf_size, dev)[0]
            assert len(vk) == len(g), f"11c {name} cloud {i}: voxel count"
            near_all += cc.check_culled_features(
                vk, (g, np.zeros_like(g)), w, fs.positions, bp,
                f"11c {name} cloud {i}")
        print(f"{name}: {sum(len(fs.positions) for fs in fss)} features "
              f"(JAX {len(ref[f'c_{name}_pos'])}), the same voxel "
              f"keypoints kept; {near_all} voxel keypoints within rtol "
              f"{cc.RTOL:g} of a threshold")


def colour_pair_stats(kp, kp_rgb, xyz, rgb, params, dev):
    """[K, 5] int per voxel keypoint, over every point of the cloud on the
    card (culling_check.colour_explained): in-radius points (the radius
    gate as ops/tiled.sqdist computes it), those whose colour distance
    exceeds the threshold, those whose distance lies within rtol 1e-4 of
    it, the points whose squared distance lies within the gate's rounding
    band (8 float32 ulps of |q|^2 + |p|^2 from the squared radius: the
    matmul identity's rounding on either side), and those of them whose
    colour distance exceeds the threshold."""
    import numpy as np
    import torch
    from point_cloud_donkey_tpu_torch.ops import tiled
    from point_cloud_donkey_tpu_torch.ops.color import (
        color_distance, rgb_to_cielab_normalized)
    eps = float(np.finfo(np.float32).eps)
    p = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(dev)
    lab = rgb_to_cielab_normalized(torch.from_numpy(np.ascontiguousarray(
        rgb, np.float32)).to(dev))
    q_all = torch.from_numpy(np.ascontiguousarray(kp, np.float32)).to(dev)
    q_lab = rgb_to_cielab_normalized(torch.from_numpy(np.ascontiguousarray(
        kp_rgb, np.float32)).to(dev))
    r2 = float(np.float32(params.leaf_size ** 2))
    mx = float(params.max_similar_color_distance)
    p2 = (p * p).sum(-1)
    out = np.zeros((len(kp), 5), np.int64)
    for k0 in range(0, len(kp), 256):
        q = q_all[k0:k0 + 256]
        d2 = tiled.sqdist(q[None], p[None])[0]
        inside = d2 <= r2
        gate = (d2 - r2).abs() <= 8 * eps * ((q * q).sum(-1)[:, None]
                                            + p2[None])
        qi, pi = torch.nonzero(inside | gate, as_tuple=True)
        dist = color_distance(q_lab[k0:k0 + 256][qi], lab[pi])
        far = dist > mx
        st = torch.zeros((len(q), 5), dtype=torch.int64, device=dev)
        st[:, 0] = inside.sum(1)
        st[:, 1].index_add_(0, qi, (far & inside[qi, pi]).long())
        near = (dist - mx).abs() <= 1e-4 * mx
        st[:, 2].index_add_(0, qi, (near & inside[qi, pi]).long())
        st[:, 3] = gate.sum(1)
        st[:, 4].index_add_(0, qi, (gate[qi, pi] & far).long())
        out[k0:k0 + 256] = st.cpu().numpy()
    return out


def scene_mixed(ctx):
    """11d."""
    import kinect_data as kd
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    launches, card, dev, frames = ctx.launches, ctx.card, ctx.dev, \
        ctx.frames
    kinect_path = ctx.path("kinect_model.ism")
    views = [v for v, _ in kd.training_views()]
    small = [views[0], views[4]]
    mixed = [frames[0], small[0], frames[1], small[1]]
    phase(f"11d. detect_batch of [frame, small, frame, small] "
          f"({', '.join(str(len(c.xyz)) for c in mixed)} points) ({card})")
    ism = ImplicitShapeModel.load(kinect_path, device=dev)
    got = timed_detect(ism, [c.xyz for c in mixed], [c.rgb for c in mixed],
                       "scene_mixed", launches, card)
    for i, c in enumerate(mixed):
        one = ism.detect(c.xyz, None, c.rgb)[0]
        assert maxima_bits(one) == maxima_bits(got[i]), \
            f"11d: row {i} differs from detect() of its cloud"
    print("the order kept; each row equals detect() of its cloud bit for "
          "bit")


def scene_training(ctx):
    """11e."""
    import numpy as np
    import torch
    import kinect_data as kd
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    launches, card, dev, ref, data = (ctx.launches, ctx.card, ctx.dev,
                                      ctx.ref, ctx.data)
    tviews = kd.training_views()
    phase(f"11e. ImplicitShapeModel.train of configs/rgbd_kinect.ism on "
          f"{len(tviews)} views ({', '.join(str(len(v.xyz)) for v, _ in tviews)}"
          f" points: the last above the scene threshold) ({card})")
    tmp = tempfile.mkdtemp(prefix="pcd_smoke_scene_")
    try:
        with open(os.path.join(HERE, "configs", "rgbd_kinect.ism")) as fh:
            tism = ImplicitShapeModel(IsmConfig.from_json(json.load(fh)),
                                      dev)
        for i, (v, cid) in enumerate(tviews):
            p = os.path.join(tmp, f"view{i}.pcd")
            save_pcd(p, v.xyz, rgb=v.rgb)
            tism.add_training_model(p, cid, cid)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        tism.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches["scene_train"] = build.launch_counts()
    finally:
        shutil.rmtree(tmp)
    print(f"training: {len(tviews) / dt:.3f} clouds/s ({dt:.3f} s, host "
          f"clock); train_* ms per cloud "
          f"{ {k: round(v * 1e3 / len(tviews), 3) for k, v in tism.processing_times.items()} }; "
          f"launches "
          f"{ {k: v for k, v in launches['scene_train'].items() if v} }")
    missing = [k for k in PATH_KERNELS["scene_train"]
               if launches["scene_train"][k] == 0]
    assert not missing, f"11e: kernels not launched {missing}"
    with np.load(os.path.join(data, "kinect_model.ismd.npz")) as z:
        want = dict(z)
    cb = tism.state.codebook
    assert cb.codewords.shape == want["cb_codewords"].shape and \
        np.array_equal(cb.vote_class, want["cb_vote_class"]), \
        f"11e: codebook {cb.codewords.shape} vs {want['cb_codewords'].shape}"
    a, b = cb.codewords, want["cb_codewords"]

    def share(x):
        cos = (x * b).sum(1) / np.maximum(np.linalg.norm(x, axis=1)
                                          * np.linalg.norm(b, axis=1), 1e-30)
        return float((cos > 0.999).mean())
    rng = np.random.default_rng(0)
    got, noise2 = share(a), share((a * (1 + 0.02 * rng.standard_normal(
        a.shape))).astype(np.float32))
    ctl = float((ref["e_ctl_cos"] > 0.999).mean())
    print(f"codebook vs the committed JAX-trained one: {len(a)} codewords, "
          f"cosine > 0.999 on {100 * got:.2f}% (the JAX control, each view's "
          f"points reversed and moved an ulp: {100 * ctl:.2f}%; the card's "
          f"codewords with 2% noise: {100 * noise2:.2f}%)")
    assert got >= ctl - CODEBOOK_MARGIN, "11e: codebook outside the spread"
    assert noise2 < ctl - CODEBOOK_MARGIN, \
        "11e: the codebook check passes 2% noise"


def scene_hough(ctx):
    """11f."""
    import kinect_data as kd
    from bench_data import (FIRM_RTOL_HOUGH, HOUGH_VOTING, bench_scenes,
                            firm_mismatches, with_voting)
    from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    launches, card, dev, ref = ctx.launches, ctx.card, ctx.dev, ctx.ref
    bench_path = ctx.path("bench_codebook.ism")
    hs, _, _ = bench_scenes(1, scale=1.0, n=kd.FILTER_POINTS,
                            seed=kd.FILTER_SEED)
    phase(f"11f. the bench SHOT model, Hough3D + RANSAC + Merge, on one "
          f"scene of {hs.shape[1]} points ({card})")
    hism = ImplicitShapeModel.load(bench_path, device=dev)
    hism.config = IsmConfig.from_json(with_voting(
        ctx.model_json("bench_codebook.ism"), HOUGH_VOTING))
    got = timed_detect(hism, [hs[0]], None, "scene_hough", launches, card)
    bw = hism.config.child("Voting").get("Bandwidth", 0.1)
    bad = firm_mismatches(got[0], ctx.ref_maxima("f_")[0], bw, FIRM_RTOL_HOUGH)
    print(f"{len(got[0])} maxima; detection contract "
          f"{'met' if not bad else bad}")
    assert not bad, f"11f: {bad[:3]}"


@contextlib.contextmanager
def shadowed_kernels(calls):
    """While open, every K1, K2, K8 and K4 call runs its plain twin on the
    card, which the caller's route goes on with, and also launches the
    kernel on the same inputs; `calls[name]` collects (kernel output, twin
    output, inputs) of each call."""
    from point_cloud_donkey_tpu_torch.ops import neighbors as tnb
    from point_cloud_donkey_tpu_torch.ops import shot as tshot
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as ksh
    sites = [(klrf, "moments", klrf.moments, klrf.moments_plain, "K1"),
             (klrf, "sign_votes", klrf.sign_votes, klrf.sign_votes_plain,
              "K2"),
             (tshot, "cshot_hist", ksh.cshot_hist, ksh.cshot_hist_plain,
              "K8"),
             (tnb, "chisq_topk", kchisq.chisq_topk, kchisq.chisq_topk_plain,
              "K4")]

    def shadow(kernel, twin, name):
        def call(*args):
            got = kernel(*args)
            want = twin(*args)
            calls.setdefault(name, []).append((got, want, args))
            return want
        return call

    for mod, attr, kernel, twin, name in sites:
        setattr(mod, attr, shadow(kernel, twin, name))
    try:
        yield
    finally:
        for mod, attr, kernel, _, _ in sites:
            setattr(mod, attr, kernel)


def frame_twin_route(frame, dev, card, ism):
    """11a's precision check: detect_batch of the frame (the tiled route)
    with every plain twin on the card, each K1, K2, K8 and K4 call also
    launched on the same inputs and held to phase 2's tolerances: K1's weight sums within rtol 2e-4
    and counts within +-1, K2's votes within +-1, K8's in-radius counts
    equal and its descriptors under the descriptor contract, K4's
    distances within rtol 1e-5 and its indices equal but at ties.  Then
    the same checks must fail on K8's descriptors rounded to bf16 and on
    K4 against the codewords rounded to bf16: the faults 11a's spread
    checks cannot see."""
    import torch
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
    phase(f"11a. the frame's route with the plain twins on the card, each "
          f"kernel call held to its twin on the same inputs ({card})")
    calls = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), shadowed_kernels(calls):
        ism.detect_batch([frame.xyz], None, [frame.rgb])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert all(calls.get(k) for k in ("K1", "K2", "K8", "K4")), \
        f"11a twins: calls {sorted(calls)}"
    rel, dcount = 0.0, 0
    for (mom, cnt), (pmom, pcnt), _ in calls["K1"]:
        w = pmom[..., 0].abs() > 1e-6
        rel = max(rel, float(((mom[..., 0] - pmom[..., 0]).abs()[w]
                              / pmom[..., 0].abs()[w]).max()))
        dcount = max(dcount, int((cnt - pcnt).abs().max()))
    dv = max(int((v - pv).abs().max()) for v, pv, _ in calls["K2"])
    got, want = [], []
    for (h, c), (ph, pc), args in calls["K8"]:
        assert torch.equal(c, pc), "11a twins: K8 counts differ"
        live = args[3]
        a = normalize_descriptors(h, c, live)
        b = normalize_descriptors(ph, pc, live)
        assert torch.equal(a.valid, b.valid), "11a twins: K8 validity"
        got.append((a.descriptors[a.valid], b.descriptors[b.valid]))
    dk = torch.cat([a for a, _ in got])
    dp = torch.cat([b for _, b in got])
    ok = torch.ones(len(dk), dtype=torch.bool, device=dev)
    cos, off = contract((dk, ok), (dp, ok), "11a twins: K8")
    bcos, boff = contract_reading((dk.to(torch.bfloat16).float(), ok),
                                  (dp, ok))
    k4, bk4 = 0.0, 0.0
    for (d, i), (pd, pi), (a, b, b_mask, k) in calls["K4"]:
        k4 = max(k4, k4_rel(d, pd))
        differ = i != pi
        assert torch.allclose(d[differ], pd[differ], rtol=1e-5), \
            "11a twins: K4 indices differ away from ties"
        bd, _ = kchisq.chisq_topk(a, b.to(torch.bfloat16).float(), b_mask, k)
        bk4 = max(bk4, k4_rel(bd, pd))
    print(f"{len(frame.xyz)} points in {dt:.2f} s: "
          f"K1 x{len(calls['K1'])} weight sums rtol {rel:.2e}, counts "
          f"+-{dcount}; K2 x{len(calls['K2'])} votes +-{dv}; K8 "
          f"x{len(calls['K8'])} ({len(dk)} descriptors) cosine min "
          f"{cos:.7f}, {off:.2e} of entries off by > 1e-3 (bf16: "
          f"{bcos:.7f}, {boff:.2e}); K4 x{len(calls['K4'])} rtol {k4:.2e} "
          f"(bf16 codewords: {bk4:.2e}) ({card})")
    assert rel <= 2e-4 and dcount <= 1 and dv <= 1 and k4 <= 1e-5, \
        "11a twins: a kernel off its twin"
    assert not (bcos > 0.999 and boff < 1e-4), \
        "11a twins: the descriptor contract passes bf16 descriptors"
    assert bk4 > 1e-5, "11a twins: K4's tolerance passes bf16 codewords"


def k4_rel(d, pd):
    """The largest relative difference of finite distances."""
    import torch
    fin = torch.isfinite(pd)
    return float(((d[fin] - pd[fin]).abs()
                  / pd[fin].abs().clamp(min=1e-30)).max()) if fin.any() \
        else 0.0


def twin_slabs(n_chunks, count=4):
    """`count` chunk indices spread over a plan's chunks."""
    import numpy as np
    return sorted(set(np.linspace(0, n_chunks - 1, count).round()
                      .astype(int).tolist()))


def frame_twin_k1k2(q_s, p_s, pms, qms, r, what, dev):
    """K1 and K2 against their plain twins on the card, on the same slabs,
    at phase 2's tolerances: weight sums rtol 2e-4, counts +-1,
    covariance atol 5e-4, sign votes +-1 (the votes along the slabs' own
    LRF axes).  Prints the errors."""
    import torch
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    mom, cnt = klrf.moments(q_s, p_s, pms, r)
    pmom, pcnt = klrf.moments_plain(q_s, p_s, pms, r)
    rel = float(((mom[..., 0] - pmom[..., 0]).abs()
                 / pmom[..., 0].abs().clamp(min=1e-6)).max())
    dc = int((cnt - pcnt).abs().max())
    cov, _ = klrf.cov_from_moments(mom, q_s, qms)
    pcov, _ = klrf.cov_from_moments(pmom, q_s, qms)
    cerr = float((cov - pcov).abs().max())
    _, vecs = eigh3x3(pcov)
    axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
    verr = int((klrf.sign_votes(q_s, p_s, pms, axes, r)
                - klrf.sign_votes_plain(q_s, p_s, pms, axes, r)).abs().max())
    print(f"{what}: K1 vs its twin on {q_s.shape[0]} of the frame's slabs "
          f"of {p_s.shape[1]}: weight sums rtol {rel:.2e}, counts +-{dc}, "
          f"covariance {cerr:.2e}; K2 votes +-{verr}")
    assert rel <= 2e-4 and dc <= 1 and cerr <= 5e-4, \
        f"{what}: K1 vs its twin (rtol {rel}, counts {dc}, cov {cerr})"
    assert verr <= 1, f"{what}: K2 votes off by {verr}"
    return mom, cnt


def frame_kernel_times(frame, fcfg, kpp, normal_radius, dev, card, ism):
    """The frame's kernels on the slabs of ops/tiled.py: K1 / K2 at the
    normals (Q = N, NormalRadius) and keypoint LRFs (Q = K,
    ReferenceFrameRadius), K8 on the descriptor slabs -- each against its
    plain twin on four of the slabs (phase 2's tolerances), then timed
    over all of them with CUDA events -- and K4 against the codebook,
    each beside its in-radius pairs and bound.  tests/scene_timing.py
    times K5 / K6 fed the plan's starts on the same frame."""
    import numpy as np
    import torch
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.models.features import pad_cloud
    from point_cloud_donkey_tpu_torch.ops import tiled
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as ksh
    from point_cloud_donkey_tpu_torch.ops.color import \
        rgb_to_cielab_normalized
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
    phase(f"11a. the frame's kernels on its slabs: K1 / K2, K8 vs their "
          f"twins and timed, K4 ({card})")
    axis = tiled.sort_key_axis(frame.xyz)
    order = np.argsort(frame.xyz[:, axis], kind="stable")
    xyz, rgb = frame.xyz[order], frame.rgb[order]
    pts_h, mask_h = pad_cloud(xyz)
    pts = torch.from_numpy(pts_h).to(dev)
    mask = torch.from_numpy(mask_h).to(dev)
    kp_h, _, krgb = tkp.voxel_keypoints(xyz, None, rgb, kpp.leaf_size, dev)
    kord = np.argsort(kp_h[:, axis], kind="stable")
    kp = torch.from_numpy(kp_h[kord]).to(dev)
    krgb = torch.from_numpy(np.ascontiguousarray(krgb[kord])).to(dev)
    key = pts_h[:, axis]
    cases = (("normals", pts, mask, normal_radius, tiled.NORMALS_CHUNK,
              1024),
             ("keypoint LRFs", kp, torch.ones(len(kp), dtype=torch.bool,
                                             device=dev),
              fcfg.ref_frame_radius, tiled.KEYPOINT_CHUNK, 4096))
    for what, q, qm, r, chunk, minw in cases:
        qm_h = qm.cpu().numpy()
        plan = tiled.plan_tiles(np.where(qm_h, q[:, axis].cpu().numpy(),
                                         1e9), qm_h, key, r, chunk, minw)
        qs = tiled.chunk_queries(q, plan, 1e9)
        qms = tiled.chunk_queries(qm, plan, False)
        ps, pms = tiled.window_slabs(pts, plan), tiled.window_slabs(mask,
                                                                    plan)
        q_s, p_s = klrf.prep_shift(qs, ps, pms)
        sel = torch.tensor(twin_slabs(plan.n_chunks), device=dev)
        frame_twin_k1k2(q_s[sel], p_s[sel], pms[sel], qms[sel], r, what,
                        dev)
        k1 = cuda_ms(lambda: klrf.moments(q_s, p_s, pms, r), 5)
        mom, cnt = klrf.moments(q_s, p_s, pms, r)
        pairs = int(cnt[qms].sum())
        axes = torch.zeros((*q_s.shape[:2], 6), device=dev)
        axes[..., 0] = 1.0
        axes[..., 5] = 1.0
        k2 = cuda_ms(lambda: klrf.sign_votes(q_s, p_s, pms, axes, r), 5)
        b1 = bound(nbytes(q_s, p_s, pms, mom, cnt),
                   pairs * (GATE_OPS + MOMENT_BODY_OPS))
        b2 = bound(nbytes(q_s, p_s, pms, axes), pairs * (GATE_OPS
                                                         + 2 * VOTE_BODY_OPS))
        print(f"{what} (Q = {int(qm.sum())}, N = {int(mask.sum())}, r "
              f"{r:g}, {pairs} in-radius pairs): K1 on {plan.n_chunks} "
              f"slabs of {plan.window} {k1:.3f} ms (bound {b1[0]:.4f} ms, "
              f"{b1[1]}), K2 {k2:.3f} ms (bound {b2[0]:.4f}) ({card})")
    # K8 on the descriptor slabs, K4 against the codebook
    plan = tiled.plan_tiles(
        kp[:, axis].cpu().numpy(), np.ones(len(kp), bool), key,
        max(fcfg.radius, fcfg.ref_frame_radius), tiled.KEYPOINT_CHUNK, 4096)
    rgb_h = np.zeros((len(pts_h), 3), np.float32)
    rgb_h[:len(xyz)] = rgb
    lab_pts = rgb_to_cielab_normalized(torch.from_numpy(rgb_h).to(dev))
    nrm_pts = torch.nn.functional.normalize(torch.randn(
        pts.shape, device=dev, generator=torch.Generator(dev).manual_seed(
            0)), dim=-1)

    def k8_args(sel):
        kq = tiled.chunk_queries(kp, plan, 1e9)[sel]
        kqm = tiled.chunk_queries(torch.ones(len(kp), dtype=torch.bool,
                                             device=dev), plan, False)[sel]
        klab = tiled.chunk_queries(rgb_to_cielab_normalized(krgb), plan,
                                   0.0)[sel]
        ps = tiled.window_slabs(pts, plan, sel)
        pms = tiled.window_slabs(mask, plan, sel)
        lrf = shot_lrf(kq, kqm, ps, pms, fcfg.ref_frame_radius)
        return tuple(x.contiguous() for x in (
            kq, klab, lrf.frames, lrf.valid & kqm, ps,
            tiled.window_slabs(nrm_pts, plan, sel), tiled.window_slabs(
                lab_pts, plan, sel), pms))

    args = k8_args(torch.tensor(twin_slabs(plan.n_chunks), device=dev))
    h, c = ksh.cshot_hist(*args, fcfg.radius)
    ph, pc = ksh.cshot_hist_plain(*args, fcfg.radius)
    assert torch.equal(c, pc), "K8 on the frame: counts differ from its twin"
    cos, off = contract(normalize_descriptors(h, c, args[3]),
                        normalize_descriptors(ph, pc, args[3]),
                        "K8 on the frame")
    print(f"K8 vs its twin on {args[0].shape[0]} of the frame's slabs: "
          f"counts equal, cosine min {cos:.7f}, {off:.2e} of entries off "
          f"by > 1e-3")
    sl = tiled.slab_groups(plan.n_chunks, plan.window, 40)[0]
    args = k8_args(torch.arange(sl[0], sl[1], device=dev))
    k8 = cuda_ms(lambda: ksh.cshot_hist(*args, fcfg.radius), 5)
    hist, count = ksh.cshot_hist(*args, fcfg.radius)
    p8 = int(count.sum())
    b8 = bound(nbytes(*args, hist), p8 * (GATE_OPS + CSHOT_BODY_OPS))
    print(f"K8 on {sl[1] - sl[0]} slabs of {plan.window} "
          f"({int(args[3].sum())} keypoints, {p8} in-radius pairs): "
          f"{k8:.3f} ms (bound {b8[0]:.4f} ms, {b8[1]}) ({card})")
    cb = ism._device_codebook()
    desc = torch.rand((len(kp), cb.codewords.shape[1]), device=dev)
    desc = desc / desc.norm(dim=1, keepdim=True)
    k4 = cuda_ms(lambda: kchisq.chisq_topk(desc, cb.codewords, cb.cw_mask,
                                           1), 5)
    ops = len(kp) * int(cb.cw_mask.sum()) * cb.codewords.shape[1] \
        * CHISQ_TERM_OPS
    b4 = bound(nbytes(desc, cb.codewords), ops)
    print(f"K4 at the frame's Q = {len(kp)} against C = "
          f"{int(cb.cw_mask.sum())}, D = {cb.codewords.shape[1]}: "
          f"{k4:.3f} ms (bound {b4[0]:.4f} ms, {b4[1]}) ({card})")


def lrf_witness(frame, wk, want, fcfg, kpp, dev):
    """The frame's LRF disagreement with JAX read at its source: at JAX's
    keypoints `wk` (every DESC_STRIDE-th scene feature), on the slab the
    scene path gives each, the LRF of K1 / K2 and of their plain twins on
    the card, and the exact LRF in float64 on the host, each against JAX's
    frames `want` and against each other (frames within 2e-3).  Returns
    the shares."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.models.features import pad_cloud
    from point_cloud_donkey_tpu_torch.ops import tiled
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    axis = tiled.sort_key_axis(frame.xyz)
    xyz = frame.xyz[np.argsort(frame.xyz[:, axis], kind="stable")]
    pts_h, mask_h = pad_cloud(xyz)
    pts = torch.from_numpy(pts_h).to(dev)
    mask = torch.from_numpy(mask_h).to(dev)
    r = fcfg.ref_frame_radius
    vk = tkp.voxel_keypoints(xyz, None, None, kpp.leaf_size, dev)[0]
    vk = vk[np.argsort(vk[:, axis], kind="stable")]
    plan = tiled.plan_tiles(vk[:, axis], np.ones(len(vk), bool),
                            pts_h[:, axis], max(fcfg.radius, r),
                            tiled.KEYPOINT_CHUNK, 4096)
    dist, idx = cKDTree(vk).query(wk)
    assert dist.max() == 0.0, "the witness keypoints are not voxel keypoints"
    sel = torch.from_numpy(idx // plan.chunk).to(dev)
    ps = tiled.window_slabs(pts, plan, sel)
    pms = tiled.window_slabs(mask, plan, sel)
    q = torch.from_numpy(wk).to(dev)[:, None, :].contiguous()
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    kernel = shot_lrf(q, qm, ps, pms, r).frames[:, 0].cpu().numpy()
    q_s, p_s = klrf.prep_shift(q, ps, pms)
    mom, cnt = klrf.moments_plain(q_s, p_s, pms, r)
    v1, v3, axes, s0 = klrf._evd_axes(mom, q_s, qm, False)
    votes = klrf.sign_votes_plain(q_s, p_s, pms, axes, r)
    plain = klrf._frames(v1, v3, votes, cnt, s0, qm, 5, False)[0][
        :, 0].cpu().numpy()
    exact = np.zeros((len(wk), 3, 3))
    for i, nb in enumerate(cKDTree(xyz).query_ball_point(wk, r * 1.01)):
        d = xyz[nb].astype(np.float64) - wk[i].astype(np.float64)
        dn = np.sqrt((d ** 2).sum(1))
        d, dn = d[dn <= r], dn[dn <= r]
        w = r - dn
        vecs = np.linalg.eigh((w[:, None, None] * d[:, :, None]
                               * d[:, None, :]).sum(0) / w.sum())[1]
        x, z = vecs[:, 2], vecs[:, 0]
        x = -x if ((d @ x) >= 0).sum() < len(d) - ((d @ x) >= 0).sum() else x
        z = -z if ((d @ z) >= 0).sum() < len(d) - ((d @ z) >= 0).sum() else z
        exact[i] = np.stack([x, np.cross(z, x), z])

    def agree(a, b):
        return float((np.abs(a - b).max(axis=(1, 2)) < 2e-3).mean())
    shares = {"kernel_jax": agree(kernel, want),
              "plain_jax": agree(plain, want),
              "kernel_plain": agree(kernel, plain),
              "exact_jax": agree(exact, want),
              "exact_kernel": agree(exact, kernel),
              "exact_plain": agree(exact, plain)}
    print(f"LRF witness at {len(wk)} of JAX's keypoints on their slabs "
          f"(frames within 2e-3): K1 / K2 vs JAX "
          f"{100 * shares['kernel_jax']:.1f}%, their plain twins on the card "
          f"vs JAX {100 * shares['plain_jax']:.1f}%, K1 / K2 vs the twins "
          f"{100 * shares['kernel_plain']:.1f}%; the exact float64 LRF vs "
          f"JAX {100 * shares['exact_jax']:.1f}%, vs K1 / K2 "
          f"{100 * shares['exact_kernel']:.1f}%, vs the twins "
          f"{100 * shares['exact_plain']:.1f}%")
    return shares


def maxima_bits(maxima):
    """The bytes of every field of a maxima list, in order."""
    import numpy as np
    return b"".join(np.asarray(getattr(m, f)).tobytes() for m in maxima
                    for f in ("class_id", "instance_id", "position", "weight",
                              "instance_weight", "bb_size", "bb_quat",
                              "num_votes", "glob_class_id",
                              "glob_class_weight", "glob_instance_id",
                              "glob_instance_weight"))


def eval_detection_on_card(launches, device):
    """eval_detection.main -t / -d --device `device` on the JAX package's
    tests/test_detection.py data (box and torus, two isolated models
    each, one scene of both): summary.txt and the per-cloud log."""
    import numpy as np

    import shapes
    from point_cloud_donkey_tpu_torch import eval_detection
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="pcd_smoke_det_")
    try:
        config = {"ObjectConfig": {
            "Children": {
                "Clustering": {"Type": "None"},
                "Codebook": {"Children": {"ActivationStrategy": {
                    "Parameters": {"K": 1}, "Type": "KNN"}}},
                "FeatureWeighting": {"Type": "Uniform"},
                "Features": {"Parameters": {"Radius": 0.6,
                                            "ReferenceFrameRadius": 0.5},
                             "Type": "SHORT_SHOT"},
                "GlobalFeatures": {"Type": "Dummy"},
                "Keypoints": {"Parameters": {"LeafSize": 0.3},
                              "Type": "VoxelGrid"},
                "Voting": {"Parameters": {
                    "Bandwidth": 0.6, "SingleObjectMode": False,
                    "MinThreshold": -0.5, "MaxFilterType": "Merge",
                    "MinVotesThreshold": 3}, "Type": "MeanShift"}},
            "Parameters": {"DistanceType": "ChiSquared",
                           "BoundingBoxType": "AABB",
                           "DistanceThresholdDetection": 0.8}}}
        cfg = os.path.join(tmp, "config.ism")
        with open(cfg, "w") as f:
            json.dump(config, f)
        train = ["# train detection"]
        for cid, name in [(1, "box"), (2, "torus")]:
            for j in range(2):
                p = os.path.join(tmp, f"train_{name}_{j}.pcd")
                save_pcd(p, shapes.make_instance(rng, cid, n=900,
                                                 rotate=False))
                train.append(f"{p} {name}")
        with open(os.path.join(tmp, "train.txt"), "w") as f:
            f.write("\n".join(train) + "\n")
        box = shapes.make_instance(rng, 1, n=900, rotate=False)
        torus = shapes.make_instance(rng, 2, n=900, rotate=False) \
            + [4.0, 0, 0]
        scene = os.path.join(tmp, "scene.pcd")
        save_pcd(scene, np.concatenate([box, torus]).astype(np.float32))
        ann = os.path.join(tmp, "scene_ann.txt")
        with open(ann, "w") as f:
            for name, pts in (("box", box), ("torus", torus)):
                c = pts.mean(0)
                f.write(f"{name} (0.0) {c[0]} {c[1]} {c[2]}\n")
        tlist = os.path.join(tmp, "test.txt")
        with open(tlist, "w") as f:
            f.write(f"# test detection\n{scene} {ann}\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = eval_detection.main(["-t", cfg, "-f",
                                      os.path.join(tmp, "train.txt"), "-o",
                                      os.path.join(tmp, "model"),
                                      "--device", device])
        assert rc == 0, "eval_detection -t failed"
        build.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            rc = eval_detection.main(["-d", os.path.join(tmp, "model.ism"),
                                      "-f", tlist, "-o",
                                      os.path.join(tmp, "out"),
                                      "--device", device])
        assert rc == 0, "eval_detection -d failed"
        counts = build.launch_counts()
        launches["eval_detection"] = counts
        missing = [k for k in PATH_KERNELS["eval_detection"]
                   if counts[k] == 0]
        assert not missing, f"eval_detection: kernels not launched {missing}"
        with open(os.path.join(tmp, "out", "summary.txt")) as f:
            summary = f.read()
        print(summary.rstrip())
        with open(os.path.join(tmp, "out", "scene.pcd.txt")) as f:
            log = f.read().splitlines()
        assert log[0].startswith("ISM3D detection log") and \
            log[1].startswith("number, classID, weight") and len(log) >= 3
        assert all(len(row.split(", ")) == 16 for row in log[2:])
        recall = re.search(r"mean recall:\s+([0-9.]+)", summary)
        assert recall and float(recall.group(1)) >= 0.5, "recall below 0.5"
        print(f"launches of the detection: "
              f"{ {k: v for k, v in counts.items() if v} }")
    finally:
        shutil.rmtree(tmp)


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
    cos, off = contract_reading(got, want)
    assert cos > 0.999 and off < 1e-4, f"{what}: cosine {cos}, {off} off"
    return cos, off


def contract_reading(got, want):
    """(min cosine, share of entries off by more than 1e-3) of two
    (descriptors, valid) pairs on the rows valid in both."""
    both = got[1] & want[1]
    a, b = got[0][both], want[0][both]
    if not len(a):
        return 1.0, 0.0
    cos = float((a * b).sum(-1).min())
    off = float(((a - b).abs() > 1e-3).float().mean())
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


# -- phase 12: the descriptor zoo and the keypoint detectors ------------------

def zoo_phase(launches, card, data, dev):
    """Phase 12: the gathered-neighbour descriptors (FPFH, SHORT_CSHOT,
    SHORT_SHOT's minimum and log radius) and the Harris3D / ISS3D / SIFT3D
    detectors through ImplicitShapeModel on the card, against
    data/zoo_reference.npz (the JAX package on the CPU,
    tests/zoo_fixtures.py; configurations and inputs: tests/zoo_data.py):
      12a quickstart.ism with Harris3D + FPFH (x70): training on the five
          bench training clouds, detect_batch of the 32 bench clouds;
      12b default.ism with ISS3D + SHORT_CSHOT, SHORT_CSHOT_GLOBAL + SVM
          verification, chi-square (x0.3): training on 10 coloured views,
          detect_batch of 10a's 16 coloured scenes; 12a-12c also hold K4
          and K4m to their twins at D = 33, 512 and 32;
      12c K9's minimum-radius and log-radius modes against its twin at
          phase 2's tolerances on the bench batch, then quickstart.ism with
          SIFT3D + SHORT_SHOT (UseMinRadius, log radius; x70) as 12a;
      12d Harris3D / ISS3D + FPFH on a 1e5-point scene: the tiled
          detectors and FPFH's doubled window (features, peak memory);
      12e eval_classification.py -t / -d --device cuda on a file list of
          the bench clouds (12a's config): every file's label JAX's.
    Training: the detector's keypoints on every training cloud against
    JAX's under tests/detector_check.py's contract, the features at the
    keypoints both found within the training contract (>= 97% of the
    descriptors at cosine > 0.999), and where the keypoints are JAX's on
    every cloud the codebook under the training contract; detection: the
    maxima end to end (10a's detection contract for default.ism, 10b's
    firm decisions for quickstart.ism).  Each step prints its clouds/s,
    stage times, launches and peak memory."""
    import numpy as np

    import zoo_data as zd
    t_phase = time.perf_counter()
    with np.load(os.path.join(data, "zoo_reference.npz")) as z:
        ref = dict(z)
    what = {"harris_fpfh": "12a. quickstart.ism with Harris3D + FPFH",
            "iss_short_cshot": "12b. default.ism with ISS3D + SHORT_CSHOT "
                               "(+ SHORT_CSHOT_GLOBAL, SVM, chi-square)",
            "sift_short_shot": "12c. quickstart.ism with SIFT3D + SHORT_SHOT "
                               "(UseMinRadius, log radius)"}
    for name in zd.DETECTIONS:
        if name == "sift_short_shot":
            k9_modes(card, dev)
        zoo_detection(launches, card, dev, ref, name, what[name])
    for name in zd.SCENE_CONFIGS:
        zoo_scene(launches, card, dev, ref, name)
    zoo_eval(launches, card, ref)
    print(f"phase 12 wall time: {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


# a zoo reference's per-cloud arrays of the feature contract
FEATURE_KEYS = ("kp_keep", "kp_pos", "feat_pos", "feat_desc")


def zoo_setup(name, dev):
    """(ism config, FeatureConfig, KeypointParams, NormalRadius, method)
    of a zoo configuration."""
    import zoo_data as zd
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    cfg = IsmConfig.from_json(zd.zoo_config(name))
    return (cfg, FeatureConfig.from_config(cfg.child("Features")),
            KeypointParams.from_config(cfg.child("Keypoints")),
            cfg.root.get("NormalRadius", 0.05),
            cfg.root.get("ConsistentNormalsMethod", 2))


def cloud_normals(xyz, nr, method, dev):
    """The normals the batched extraction hands a detector on one cloud
    (ops/normals.compute_normals over the cloud padded to its bucket)."""
    import torch
    from point_cloud_donkey_tpu_torch.models.features import pad_cloud
    from point_cloud_donkey_tpu_torch.ops.neighbors import full_fp32
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals
    pts, mask = pad_cloud(xyz)
    with full_fp32():
        nrm = compute_normals(torch.from_numpy(pts)[None].to(dev),
                              torch.from_numpy(mask)[None].to(dev), nr,
                              method).normals
    return nrm[0, :len(xyz)].cpu().numpy()


def detector_contract(xyz, normals, kpp, want_keep, want_pos, dev,
                      jax_intensity=None, what="", jax_normals=None):
    """The port's detector on one cloud against JAX's flags and positions
    (tests/detector_check.py); returns (port keypoints, JAX keypoints,
    decisions that differ, the port's flags and positions)."""
    import numpy as np
    import torch
    import detector_check as dc
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.ops.normals import pca_normals_at
    keep, pos = tkp.detector_mask(xyz, normals, kpp, dev)
    diff = int((keep != want_keep).sum())
    bad = []
    if kpp.type == "ISS3D":
        if diff:
            near = dc.iss_near(dc.iss_terms(xyz, kpp, dev), kpp)
            bad = dc.unexplained(keep, want_keep, near)
    else:
        radius = float(kpp.radius)
        p = torch.from_numpy(xyz).to(dev)
        m = torch.ones(len(xyz), dtype=torch.bool, device=dev)
        nres = pca_normals_at(p[None], m[None], p[None], m[None], radius)
        if kpp.type == "Harris3D":
            nrm = normals if normals is not None else \
                nres.normals[0].cpu().numpy()
            terms = dc.harris_terms(xyz, nrm, radius,
                                    float(kpp.harris_threshold), dev)
            spread = None if jax_normals is None else dc.harris_spread(
                xyz, nrm, jax_normals, radius, dev)
            bad = dc.unexplained(keep, want_keep, dc.harris_near(
                terms, radius, float(kpp.harris_threshold), spread))
            jax_pos = np.zeros_like(pos)
            jax_pos[want_keep] = want_pos
            moved = dc.harris_positions_unexplained(
                pos, jax_pos, keep & want_keep, terms, radius, spread)
            for j in list(bad[:3]) + list(moved[:3]):
                print(f"{what}: point {j}: kept {keep[j]} (JAX "
                      f"{want_keep[j]}), r {terms['r'][j]:.6g}, max "
                      f"{terms['nmax'][j]:.6g}, terms {terms['scale'][j]:.6g}"
                      f", spread {0.0 if spread is None else spread['r'][j]:.3g}"
                      f", position off {np.linalg.norm(pos[j] - jax_pos[j]):.3g}"
                      f", cond {terms['cond'][j]:.3g}")
            bad = np.concatenate([bad, moved])
        elif diff:
            inten = torch.where(nres.valid[0], nres.curvature[0],
                                torch.zeros_like(nres.curvature[0]))
            spread = dc.sift_spread(inten.cpu().numpy(), jax_intensity)
            terms = dc.sift_terms(xyz, inten, radius, dev)
            bad = dc.unexplained(keep, want_keep, dc.sift_near(terms,
                                                               spread))
    assert len(bad) == 0, f"{what}: {len(bad)} keypoint decisions off " \
        f"JAX's away from a tie, e.g. {list(bad[:5])}"
    return int(keep.sum()), int(want_keep.sum()), diff, keep, pos


def features_contract(pos, keep, fs, ref, pre, what):
    """The features at the keypoints both sides keep, paired through the
    keypoint (tests/detector_check.feature_pairs): a feature on one side
    only where the keypoint did not move fails, and >= 97% of the pairs
    lie at cosine > 0.999; returns (pairs, share, min cosine)."""
    import detector_check as dc
    cos, unexplained = dc.feature_pairs(
        pos, keep, fs.positions, fs.descriptors, ref[pre + "kp_keep"],
        ref[pre + "kp_pos"], ref[pre + "feat_pos"], ref[pre + "feat_desc"])
    share = float((cos > 0.999).mean()) if len(cos) else 1.0
    assert unexplained == 0, f"{what}: {unexplained} features on one side " \
        "only at keypoints that did not move"
    assert share >= 0.97, f"{what}: {100 * share:.2f}% of the features " \
        "at cosine > 0.999"
    return len(cos), share, float(cos.min()) if len(cos) else 1.0


def zoo_detection(launches, card, dev, ref, name, what):
    """One of 12a-12c (zoo_phase)."""
    import numpy as np
    import torch
    import zoo_data as zd
    from bench_data import (firm_decision, firm_mismatches, firm_rtol,
                            unpack_maxima)
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                         _voting_params)
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    cfg, fcfg, kpp, nr, cm = zoo_setup(name, dev)
    clouds, labels, rgbs = zd.training_set(name)
    phase(f"{what}: training on {len(clouds)} clouds x {clouds.shape[1]} "
          f"points, x{zd.scale_of(name):g} ({card})")
    pre = name + "_"
    tmp = tempfile.mkdtemp(prefix="pcd_zoo_")
    try:
        ism = ImplicitShapeModel(cfg, dev)
        for i, (pts, cid) in enumerate(zip(clouds, labels)):
            f = os.path.join(tmp, f"m{i}.pcd")
            save_pcd(f, pts, rgb=None if rgbs is None else rgbs[i])
            ism.add_training_model(f, int(cid), int(cid))
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        ism.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = build.launch_counts()
        launches["zoo_train_" + name] = counts
    finally:
        shutil.rmtree(tmp)
    print(f"training: {len(clouds) / dt:.2f} clouds/s ({dt:.3f} s, host "
          f"clock), launches { {k: v for k, v in counts.items() if v} } "
          f"({card})")
    missing = [k for k in PATH_KERNELS["zoo_train_" + name]
               if counts[k] == 0]
    assert not missing, f"{name} training: kernels not launched {missing}"

    same_kp = True
    fss = extract_local_features_batch(
        list(clouds), [None] * len(clouds),
        [None] * len(clouds) if rgbs is None else list(rgbs), fcfg, kpp, nr,
        cm, dev)
    for i, xyz in enumerate(clouds):
        nrm = cloud_normals(xyz, nr, cm, dev) if fcfg.needs_normals() \
            else None
        got_n, want_n, diff, keep, pos = detector_contract(
            xyz, nrm, kpp, ref[pre + f"kp_keep{i}"], ref[pre + f"kp_pos{i}"],
            dev, ref.get(pre + f"intensity{i}"), f"{name} cloud {i}",
            ref.get(pre + f"normals{i}"))
        same_kp &= diff == 0
        pairs, share, cmin = features_contract(
            pos, keep, fss[i], {pre + k: ref[pre + k + str(i)]
                                for k in FEATURE_KEYS},
            pre, f"{name} cloud {i}")
        print(f"cloud {i}: {got_n} keypoints (JAX {want_n}, {diff} "
              f"decisions differ, each at a tie); {len(fss[i].positions)} "
              f"features, {pairs} paired with JAX's, {100 * share:.2f}% at "
              f"cosine > 0.999 (min {cmin:.5f})")
    cb = ism.state.codebook
    if same_kp:
        want = {k[len(pre) + 3:]: ref[k] for k in ref
                if k.startswith(pre + "cb_")}
        assert cb.codewords.shape == want["codewords"].shape, \
            f"{name}: codebook {cb.codewords.shape}, JAX " \
            f"{want['codewords'].shape}"
        for k in ("cw_mask", "vote_mask", "vote_class"):
            assert np.array_equal(getattr(cb, k), want[k]), f"{name}: {k}"
        a, b = cb.codewords, want["codewords"]
        cos = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1)
                                          * np.linalg.norm(b, axis=1), 1e-30)
        share = float((cos > 0.999).mean())
        print(f"codebook: {len(a)} codewords as JAX's, {100 * share:.2f}% "
              f"at cosine > 0.999")
        assert share >= 0.97, f"{name}: codebook {share}"
    else:
        print(f"codebook: {len(cb.codewords)} codewords (JAX "
              f"{len(ref[pre + 'cb_codewords'])}); a keypoint at a tie "
              f"moved, so the codebooks are not compared row by row")

    dclouds, drgbs = zd.detection_set(name)
    if cfg.root.get("DistanceType", "Euclidean") == "ChiSquared":
        # K4 and K4m at the zoo descriptor's width (FPFH's D = 33, not a
        # multiple of 4; SHORT_CSHOT's 512): four detection clouds'
        # features against the trained codewords
        fss = extract_local_features_batch(
            list(dclouds[:4]), [None] * 4,
            [None] * 4 if drgbs is None else list(drgbs[:4]), fcfg, kpp, nr,
            cm, dev, is_training=False)
        k4_on_rows(torch.from_numpy(np.concatenate(
            [f.descriptors for f in fss])).to(dev),
            torch.from_numpy(np.asarray(cb.codewords, np.float32)).to(dev),
            torch.from_numpy(np.asarray(cb.cw_mask)).to(dev), card, name)
    phase(f"{what}: detect_batch of {len(dclouds)} clouds x "
          f"{dclouds.shape[1]} points ({card})")
    ism.detect_batch(list(dclouds[:2]), None,
                     None if drgbs is None else list(drgbs[:2]))  # warm-up
    got = timed_detect(ism, dclouds, drgbs, "zoo_" + name, launches, card)
    want = unpack_maxima({k[len(pre) + 4:]: v for k, v in ref.items()
                          if k.startswith(pre + "max_")})
    want = want[:len(got)]
    if zd.ZOO[name]["base"] == "quickstart":
        firm = [i for i, w in enumerate(want) if firm_decision(w)]
        agree = [i for i in firm if got[i] and got[i][0].class_id
                 == int(want[i][0]["class_id"])]
        print(f"end to end: maxima[0].class_id equals JAX's on "
              f"{len(agree)}/{len(firm)} firm clouds (margin > 0.1)")
        assert firm and len(agree) == len(firm), \
            f"{name}: decisions differ on {set(firm) - set(agree)}"
    else:
        vparams = _voting_params(ism.config.child("Voting"))
        bw = ism.config.child("Voting").get("Bandwidth", 0.1)
        bad = [(i, b) for i, (g, w) in enumerate(zip(got, want))
               for b in [firm_mismatches(g, w, bw, firm_rtol(
                   vparams.voting_type))] if b]
        glob = sum(m.glob_class_weight > 0 for ms_ in got for m in ms_)
        print(f"end to end: {len(got) - len(bad)}/{len(got)} clouds meet "
              f"the detection contract; {sum(map(len, got))} maxima "
              f"({sum(map(len, want))} JAX's), {glob} with an SVM score")
        assert not bad, f"{name}: end to end vs JAX: {bad[:3]}"


def k4_on_rows(a, b, m, card, what):
    """K4 (k = 1) and K4m against their twins on the card on the rows a
    [Q, D] against b [C, D] (live where m): phase 2's tolerances
    (distances within rtol 1e-5, indices equal but at ties; K4m's matrix
    within rtol 1e-5)."""
    import torch
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    a, b, m = a.contiguous(), b.contiguous(), m.contiguous()
    d, i = kchisq.chisq_topk(a, b, m, 1)
    pd, pi = kchisq.chisq_topk_plain(a, b, m, 1)
    rel = float(((d - pd).abs() / pd.abs().clamp(min=1e-6)).max())
    differ = i != pi
    mat = kchisq.chisq_matrix(a, b, m)
    pmat = kchisq.chisq_matrix_plain(a, b, m)
    fin = torch.isfinite(pmat)
    mrel = float(((mat - pmat).abs()[fin] / pmat.abs()[fin].clamp(min=1e-6)
                  ).max())
    print(f"{what}: K4 and K4m at D = {a.shape[1]} ({a.shape[0]} rows x "
          f"{b.shape[0]}, values in [{float(a.min()):.3g}, "
          f"{float(a.max()):.3g}], {float((a == 0).float().mean()):.2f} "
          f"zero): K4 rtol {rel:.2e}, {int(differ.sum())} tied indices "
          f"differ; K4m rtol {mrel:.2e} ({card})")
    assert rel <= 1e-5 and torch.allclose(d[differ], pd[differ], rtol=1e-5), \
        f"{what}: K4 off its twin at D = {a.shape[1]}"
    assert mrel <= 1e-5 and torch.equal(fin, torch.isfinite(mat)), \
        f"{what}: K4m off its twin at D = {a.shape[1]}"


def k9_modes(card, dev):
    """12c's kernel check: K9 with a minimum radius, with the log radius
    and both, against its twin at phase 2's tolerances (the descriptor
    contract) on the bench batch's SHORT_SHOT step shapes, timed beside
    the linear mode."""
    import torch
    from bench_data import KEYPOINT_CAPACITY, bench_clouds
    from point_cloud_donkey_tpu_torch.ops.kernels import histogram as khist
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    phase(f"12c. K9's minimum and log radius vs its plain twin on the card "
          f"({card})")
    _, _, clouds, _ = bench_clouds(BATCH)
    pts = torch.from_numpy(clouds).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    with torch.no_grad():
        k = voxel_grid(pts, mask, 0.35, capacity=KEYPOINT_CAPACITY)
        kp = torch.where(k.mask[..., None], k.centroids[..., :3],
                         torch.full_like(k.centroids[..., :3], 1e9)
                         ).contiguous()
        lrf = shot_lrf(kp, k.mask, pts, mask, 0.5)
        args = (kp, lrf.frames.contiguous(), lrf.valid.contiguous(), pts,
                mask, 0.6, 2, 2, 8)
        live = args[2]

        def unit(x):
            norm = torch.linalg.norm(x, dim=-1, keepdim=True)
            d = x / norm.clamp(min=1e-30)
            return d, live & (norm[..., 0] > 0) & torch.isfinite(d).all(-1)

        base_ms = cuda_ms(lambda: khist.short_shot_hist(*args), 20)
        for mr, lr in ((0.06, False), (0.0, True), (0.06, True)):
            h = khist.short_shot_hist(*args, mr, lr)
            assert torch.equal(h, khist.short_shot_hist(*args, mr, lr)), \
                "two K9 launches differ"
            ph = khist.short_shot_hist_plain(*args, mr, lr)
            cos, off = contract(unit(h), unit(ph), f"K9 min {mr} log {lr}")
            ms = cuda_ms(lambda: khist.short_shot_hist(*args, mr, lr), 20)
            plain_ms = cuda_ms(lambda: khist.short_shot_hist_plain(
                *args, mr, lr), 2)
            print(f"{'histogram':20s} min radius {mr}, log radius {lr}: "
                  f"B={pts.shape[0]} K={kp.shape[1]} N={pts.shape[1]}, "
                  f"{ms:.4f} ms (linear mode {base_ms:.4f} ms), twin "
                  f"{plain_ms:.3f} ms; cosine min {cos:.7f}, {off:.2e} of "
                  f"entries off by > 1e-3, two launches bit-equal ({card})")


def zoo_scene(launches, card, dev, ref, name):
    """12d (zoo_phase)."""
    import torch
    import zoo_data as zd
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.ops import tiled
    cfg, fcfg, kpp, nr, cm = zoo_setup(name, dev)
    xyz = zd.scene()
    phase(f"12d. {kpp.type} + FPFH (r {fcfg.radius}, the tiled route's "
          f"window at twice max(r, LRF r)) on a scene of {len(xyz)} points "
          f"({card})")
    assert len(xyz) > tiled.SCENE_TILE_THRESHOLD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    times = {}
    fs = extract_local_features_batch([xyz], [None], [None], fcfg, kpp, nr,
                                      cm, dev, is_training=False,
                                      times=times)[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches["zoo_" + name] = counts
    print(f"features of the scene: {dt:.3f} s (normals "
          f"{times.get('normals', 0.0):.3f} s, keypoints "
          f"{times.get('keypoints', 0.0):.3f} s), {len(fs.positions)} "
          f"features; launches { {k: v for k, v in counts.items() if v} }; "
          f"peak device memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} "
          f"MiB above the {held / 2**20:.1f} MiB held) ({card})")
    missing = [k for k in PATH_KERNELS["zoo_" + name] if counts[k] == 0]
    assert not missing, f"{name}: kernels not launched {missing}"
    pre = name + "_"
    nrm = None
    if kpp.type == "Harris3D":
        from point_cloud_donkey_tpu_torch.models.features import scene_normals
        nrm = scene_normals(xyz, None, nr, cm, dev)
    got_n, want_n, diff, keep, pos = detector_contract(
        xyz, nrm, kpp, ref[pre + "kp_keep"], ref[pre + "kp_pos"], dev,
        what=name, jax_normals=ref.get(pre + "normals"))
    pairs, share, cmin = features_contract(pos, keep, fs, ref, pre, name)
    print(f"{got_n} keypoints (JAX {want_n}, {diff} decisions differ, each "
          f"at a tie); {pairs} features paired with JAX's, "
          f"{100 * share:.2f}% at cosine > 0.999 (min {cmin:.5f})")


def zoo_eval(launches, card, ref):
    """12e (zoo_phase)."""
    import numpy as np
    import zoo_data as zd
    from point_cloud_donkey_tpu_torch import eval_classification
    from point_cloud_donkey_tpu_torch.kernels import build
    phase(f"12e. eval_classification.py -t / -d --device cuda, "
          f"quickstart.ism with Harris3D + FPFH ({card})")
    tmp = tempfile.mkdtemp(prefix="pcd_eval_")
    try:
        cfg = os.path.join(tmp, "eval.ism")
        with open(cfg, "w") as f:
            json.dump(zd.zoo_config("harris_fpfh"), f)
        train, test = zd.eval_lists(tmp)
        model = os.path.join(tmp, "model")
        out = os.path.join(tmp, "out")
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc_t = eval_classification.main(
                ["-t", cfg, "-f", train, "-o", model, "--device", "cuda"])
            rc_d = eval_classification.main(
                ["-d", model + ".ism", "-f", test, "-o", out,
                 "--device", "cuda"])
        dt = time.perf_counter() - t0
        launches["zoo_eval"] = build.launch_counts()
        got = zd.summary_labels(os.path.join(out, "summary.txt"))
    finally:
        shutil.rmtree(tmp)
    want = ref["eval_labels"]
    print(f"rc {rc_t}, {rc_d}; {dt:.2f} s; labels {got[:, 1].tolist()} "
          f"(JAX CLI {want[:, 1].tolist()}, ground truth "
          f"{want[:, 0].tolist()})")
    assert rc_t == 0 and rc_d == 0 and np.array_equal(got, want), \
        "12e: eval_classification's labels differ from the JAX CLI's"
    missing = [k for k in PATH_KERNELS["zoo_eval"]
               if launches["zoo_eval"][k] == 0]
    assert not missing, f"12e: kernels not launched {missing}"


# -- phase 13: the rest of the descriptor zoo and the whole-cloud globals -----

def zoo2_phase(launches, card, data, dev):
    """Phase 13: the rest of the descriptor zoo through ImplicitShapeModel
    on the card, against data/zoo2_reference.npz (the JAX package on the
    CPU, tests/zoo2_fixtures.py; configurations and inputs:
    tests/zoo2_data.py):
      13a quickstart.ism (x70, ChiSquared) with BSHOT, SHORT_SHOT_PCL,
          SpinImage, PFH, 3DSC, USC, RSD (both modes), RoPS and ESF_LOCAL:
          training on the five bench clouds, detect_batch of the 32 bench
          clouds;
      13b default.ism (x0.3) on 10a's 16 coloured scenes: COSPAIR + ESF,
          RIFT + VFH, GASD (local) + GRSD, CSHOT + GASD with and without
          colour, CVFH, OURCVFH and USC_GLOBAL (the SVM per maximum);
      13c quickstart.ism with NARF on rendered camera views;
      13d K4 and K4m against their twins on each new descriptor's rows
          (13a-13c's detection features against the codebook, the global
          rows against themselves): D = 1980, 984, 640, negative entries.
    Each configuration: the codebook contract (the same codeword count,
    masks and vote classes, >= 97% of the codewords at cosine > 0.999),
    the global rows each at cosine > 0.999, BSHOT's bits against JAX's
    within their rounding band (tests/zoo2_check.py, the count printed),
    and end to end 12a's firm decisions (quickstart.ism) or 12b's firm
    detections (default.ism, tests/bench_data.firm_mismatches) against
    JAX's; each step prints its clouds/s, stage times, launches
    and peak memory."""
    import numpy as np
    import zoo2_data as zd
    t_phase = time.perf_counter()
    with np.load(os.path.join(data, "zoo2_reference.npz")) as z:
        ref = dict(z)
    rows = []
    for name in zd.CONFIGS:
        part = "13a" if name in zd.LOCAL_13A else \
            "13b" if name in zd.GLOBAL_13B else "13c"
        rows += zoo2_step(launches, card, dev, ref, name, part)
    phase(f"13d. K4 and K4m against their twins on the new descriptors' "
          f"rows ({card})")
    for what, a, b, m in rows:
        k4_on_rows(a, b, m, card, what)
    print(f"phase 13 wall time: {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


def zoo2_step(launches, card, dev, ref, name, part):
    """One configuration of 13a-13c (zoo2_phase); returns 13d's rows
    [(what, rows, codewords, live)] on the device."""
    import numpy as np
    import torch
    import zoo2_data as zd
    from bench_data import (firm_decision, firm_mismatches, firm_rtol,
                            unpack_maxima)
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                         _voting_params)
    from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    cfg = IsmConfig.from_json(zd.zoo2_config(name))
    clouds, labels, rgbs = zd.training_set(name)
    fcfg = FeatureConfig.from_config(cfg.child("Features"))
    gcfg = FeatureConfig.from_config(cfg.child("GlobalFeatures"))
    phase(f"{part}. {zd.base_of(name)}.ism with {fcfg.type} (global "
          f"{gcfg.type}): training on {len(clouds)} clouds ({card})")
    pre = name + "_"
    tmp = tempfile.mkdtemp(prefix="pcd_zoo2_")
    try:
        ism = ImplicitShapeModel(cfg, dev)
        for i, (pts, cid) in enumerate(zip(clouds, labels)):
            f = os.path.join(tmp, f"m{i}.pcd")
            save_pcd(f, pts, rgb=None if rgbs is None else rgbs[i])
            ism.add_training_model(f, int(cid), int(cid))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        ism.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = build.launch_counts()
        launches["zoo2_train_" + name] = counts
    finally:
        shutil.rmtree(tmp)
    tt = {k: round(v * 1e3, 3) for k, v in ism.processing_times.items()
          if k.startswith("train_")}
    print(f"training: {len(clouds) / dt:.2f} clouds/s ({dt:.3f} s, host "
          f"clock), stage ms {tt}, launches "
          f"{ {k: v for k, v in counts.items() if v} }, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    missing = [k for k in PATH_KERNELS["zoo2_train_" + name]
               if counts[k] == 0]
    assert not missing, f"{name} training: kernels not launched {missing}"

    cb = ism.state.codebook
    want = {k[len(pre) + 3:]: ref[k] for k in ref
            if k.startswith(pre + "cb_")}
    assert cb.codewords.shape == want["codewords"].shape, \
        f"{name}: codebook {cb.codewords.shape}, JAX " \
        f"{want['codewords'].shape}"
    for k in ("cw_mask", "vote_mask", "vote_class"):
        assert np.array_equal(getattr(cb, k), want[k]), f"{name}: {k}"
    share, cmin = zoo2_cosines(cb.codewords, want["codewords"],
                               zd.CODEWORD_ATOL.get(name))
    print(f"codebook: {len(cb.codewords)} codewords as JAX's, "
          f"{100 * share:.2f}% at cosine > 0.999"
          + (f" or within atol {zd.CODEWORD_ATOL[name]}"
             if name in zd.CODEWORD_ATOL else "")
          + f" (min cosine {cmin:.5f}, max |delta| "
          f"{np.abs(cb.codewords - want['codewords']).max():.3g})")
    if name == "bshot":
        # a flipped bit of ~100 ones moves the cosine below 0.999: BSHOT's
        # codewords (its training features, Clustering None) are held to
        # the bits' decision contract instead
        zoo2_bshot_bits(clouds, ref, cfg, dev)
    elif name == "pfh":
        # a PFH codeword reads the normals of 64 neighbours: held feature by
        # feature, each off JAX's explained by a normal off JAX's
        zoo2_pfh_normals(clouds, ref, cfg, dev)
    else:
        assert share >= 0.97, f"{name}: codebook {share}"
    glob = ism.state.global_descriptors
    if pre + "glob" in ref:
        assert glob is not None and glob.shape == ref[pre + "glob"].shape, \
            f"{name}: global rows {None if glob is None else glob.shape}"
        share, cmin = zoo2_cosines(glob, ref[pre + "glob"])
        print(f"global descriptors: {len(glob)} {gcfg.type} rows as JAX's, "
              f"min cosine {cmin:.6f}, max |delta| "
              f"{np.abs(glob - ref[pre + 'glob']).max():.3g}")
        assert cmin > 0.999, f"{name}: global rows off JAX's"

    dclouds, drgbs = zd.detection_set(name)
    phase(f"{part}. {name}: detect_batch of {len(dclouds)} clouds x "
          f"{dclouds[0].shape[0]} points ({card})")
    ism.detect_batch(dclouds[:2], None, None if drgbs is None
                     else drgbs[:2])  # warm-up
    got = timed_detect(ism, dclouds, drgbs, "zoo2_" + name, launches, card)
    want = unpack_maxima({k[len(pre) + 4:]: v for k, v in ref.items()
                          if k.startswith(pre + "max_")})[:len(got)]
    same = sum(bool(g) == bool(w) and (not g or g[0].class_id
                                       == int(w[0]["class_id"]))
               for g, w in zip(got, want))
    if zd.base_of(name) == "quickstart" or name in zd.DECISIONS_ONLY:
        # 12a's contract: the firm decisions (margin > 0.1)
        firm = [i for i, w in enumerate(want) if firm_decision(w)]
        agree = [i for i in firm if got[i] and got[i][0].class_id
                 == int(want[i][0]["class_id"])]
        print(f"end to end: maxima[0].class_id equals JAX's on "
              f"{len(agree)}/{len(firm)} firm clouds (margin > 0.1), the "
              f"top class on {same}/{len(got)}; {sum(map(len, got))} maxima "
              f"({sum(map(len, want))} JAX's)")
        assert len(agree) == len(firm), \
            f"{name}: decisions differ on {set(firm) - set(agree)}"
    else:
        # 12b's: the firm detections
        vparams = _voting_params(ism.config.child("Voting"))
        bw = ism.config.child("Voting").get("Bandwidth", 0.1)
        bad = [(i, b) for i, (g, w) in enumerate(zip(got, want))
               for b in [firm_mismatches(g, w, bw, firm_rtol(
                   vparams.voting_type))] if b]
        print(f"end to end: {len(got) - len(bad)}/{len(got)} clouds meet "
              f"the detection contract, the top class as JAX's on {same}; "
              f"{sum(map(len, got))} maxima ({sum(map(len, want))} JAX's)")
        assert not bad, f"{name}: end to end vs JAX: {bad[:3]}"

    kpp = KeypointParams.from_config(cfg.child("Keypoints"))
    fss = extract_local_features_batch(
        dclouds[:4], [None] * 4, [None] * 4 if drgbs is None else drgbs[:4],
        fcfg, kpp, cfg.root.get("NormalRadius", 0.05),
        cfg.root.get("ConsistentNormalsMethod", 2), dev, is_training=False)
    a = np.concatenate([f.descriptors for f in fss])
    out = [(f"{name} ({fcfg.type})", torch.from_numpy(a).to(dev),
            torch.from_numpy(np.asarray(cb.codewords, np.float32)).to(dev),
            torch.from_numpy(np.asarray(cb.cw_mask)).to(dev))]
    if glob is not None:
        g = torch.from_numpy(np.asarray(glob, np.float32)).to(dev)
        out.append((f"{name} ({gcfg.type} rows)", g, g,
                    torch.ones(len(g), dtype=torch.bool, device=dev)))
    return out


def zoo2_cosines(a, b, atol=None):
    """(share of rows at cosine > 0.999 -- or, with `atol`, within it of
    b's --, the least cosine)."""
    import numpy as np
    cos = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1)
                                      * np.linalg.norm(b, axis=1), 1e-30)
    ok = cos > 0.999
    if atol is not None:
        ok |= (np.abs(a - b) <= atol).all(1)
    return float(ok.mean()), float(cos.min())


def zoo2_pfh_normals(clouds, ref, cfg, dev):
    """13a's PFH contract on each training cloud: the normals within 1e-3
    of JAX's on >= 99.5% of the points (tests/test_torch_scene.py's
    normals contract); the features at the keypoints both keep at cosine >
    0.999 or within the golden atol 0.15 of JAX's, but where a neighbour
    within the radius has a normal off JAX's by more than 1e-4 (a point
    whose SHOT LRF's eigenvalues nearly tie turns its normal)."""
    import numpy as np
    import torch
    import zoo2_data as zd
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import (
        FeatureConfig, pad_cloud)
    from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
    from point_cloud_donkey_tpu_torch.ops.neighbors import full_fp32
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals
    fcfg = FeatureConfig.from_config(cfg.child("Features"))
    kpp = KeypointParams.from_config(cfg.child("Keypoints"))
    nr = cfg.root.get("NormalRadius", 0.05)
    cm = cfg.root.get("ConsistentNormalsMethod", 2)
    none = [None] * len(clouds)
    fss = extract_local_features_batch(clouds, none, none, fcfg, kpp, nr,
                                       cm, dev)
    off_rows = explained = turned = 0
    for i, (xyz, fs) in enumerate(zip(clouds, fss)):
        pts, mask = pad_cloud(xyz)
        with full_fp32():
            nrm = compute_normals(torch.from_numpy(pts)[None].to(dev),
                                  torch.from_numpy(mask)[None].to(dev), nr,
                                  cm).normals[0, :len(xyz)].cpu().numpy()
        dots = np.abs((nrm * ref[f"pfh_normals{i}"]).sum(1))
        assert (dots > 0.999).mean() >= 0.995, f"pfh cloud {i}: normals"
        moved = xyz[dots < 1 - 1e-4]
        turned += len(moved)
        wpos = ref[f"pfh_feat_pos{i}"]
        d2 = ((fs.positions[:, None] - wpos[None]) ** 2).sum(-1)
        j = d2.argmin(1)
        assert (d2[np.arange(len(j)), j] == 0).all(), f"pfh cloud {i}"
        a, b = fs.descriptors, ref[f"pfh_feat_desc{i}"][j]
        share, _ = zoo2_cosines(a, b, zd.CODEWORD_ATOL["pfh"])
        cos = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1)
                                          * np.linalg.norm(b, axis=1), 1e-30)
        off = (cos <= 0.999) & ~(np.abs(a - b) <= 0.15).all(1)
        for r in np.flatnonzero(off):
            near = ((moved - fs.positions[r]) ** 2).sum(1) <= fcfg.radius ** 2
            assert near.any(), f"pfh cloud {i} feature {r}: off JAX's " \
                f"(cosine {cos[r]:.5f}) with every normal in its support " \
                "as JAX's"
        off_rows += int(off.sum())
    print(f"13a PFH: {turned} normals of {sum(map(len, clouds))} off JAX's "
          f"by > 1e-4; {off_rows} features off JAX's, each with such a "
          "normal within its radius")


def zoo2_bshot_bits(clouds, ref, cfg, dev):
    """13a's decision contract of BSHOT's bits: on each training cloud,
    the port's BSHOT (K7's SHOT binarised) against JAX's at the keypoints
    both keep, each group that differs within its rounding band of JAX's
    and the port's SHOT (tests/zoo2_check.bshot_near)."""
    import dataclasses
    import numpy as np
    import zoo2_check as zc
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
    fcfg = FeatureConfig.from_config(cfg.child("Features"))
    kpp = KeypointParams.from_config(cfg.child("Keypoints"))
    args = (cfg.root.get("NormalRadius", 0.05),
            cfg.root.get("ConsistentNormalsMethod", 2), dev)
    none = [None] * len(clouds)
    bits = extract_local_features_batch(clouds, none, none, fcfg, kpp, *args)
    shot = extract_local_features_batch(
        clouds, none, none, dataclasses.replace(fcfg, type="SHOT"), kpp,
        *args)
    differ, near = [], []
    for i, (fb, fs) in enumerate(zip(bits, shot)):
        assert np.array_equal(fb.positions, fs.positions)
        wpos = ref[f"bshot_feat_pos{i}"]
        d2 = ((fb.positions[:, None] - wpos[None]) ** 2).sum(-1)
        j = d2.argmin(1)
        hit = d2[np.arange(len(j)), j] <= (1e-4 * kpp.leaf_size) ** 2
        differ.append(zc.bits_differ(fb.descriptors[hit],
                                     ref[f"bshot_feat_desc{i}"][j[hit]]))
        near.append(zc.bshot_near(fs.descriptors[hit],
                                  ref[f"bshot_shot_desc{i}"][j[hit]]))
    zc.report("13a BSHOT groups on the training clouds",
              np.concatenate(differ), np.concatenate(near))


# -- phase 14: CGF, its embedding trainer and the LRF variants -----------------

def zoo3_phase(launches, card, data, dev):
    """Phase 14 (module docstring) against data/zoo3_reference.npz (the
    JAX package on the CPU, tests/zoo3_fixtures.py; configurations and
    inputs: tests/zoo3_data.py).  Each configuration: the codebook
    contract (the same codeword count, masks and vote classes, >= 97% of
    the codewords at cosine > 0.999), the global rows each at cosine >
    0.999, 12a's firm decisions (quickstart.ism) or 12b's firm detections
    (default.ism) end to end; CGF's raw rows on JAX's frames and normals
    each equal or moved by pairs in their rounding band
    (tests/zoo2_check.cgf_rows_near).  Each step prints its clouds/s,
    stage times, launches, peak memory and the card."""
    import numpy as np
    import zoo3_data as zd
    t_phase = time.perf_counter()
    with np.load(os.path.join(data, "zoo3_reference.npz")) as z:
        ref = dict(z)
    rows = []
    for name in zd.CONFIGS:
        part = "14a" if name in zd.LRF_14A else \
            "14b" if name == zd.CSHOT_BOARD else "14c"
        rows += zoo3_step(launches, card, dev, ref, name, part)
    phase(f"14d. K4 and K4m against their twins on 14c's CGF rows ({card})")
    for what, a, b, m in rows:
        k4_on_rows(a, b, m, card, what)
    zoo3_trainer(launches, card, dev, ref)
    print(f"phase 14 wall time: {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


def zoo3_step(launches, card, dev, ref, name, part):
    """One configuration of 14a-14c (zoo3_phase); returns 14d's rows
    [(what, rows, codewords, live)] on the device (CGF's only)."""
    import numpy as np
    import torch
    import zoo3_data as zd
    from bench_data import (firm_decision, firm_mismatches, firm_rtol,
                            unpack_maxima)
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu_torch.models.features import FeatureConfig
    from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                         _voting_params)
    from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    cfg = IsmConfig.from_json(zd.zoo3_config(name))
    clouds, labels, rgbs = zd.training_set(name)
    fcfg = FeatureConfig.from_config(cfg.child("Features"))
    gcfg = FeatureConfig.from_config(cfg.child("GlobalFeatures"))
    phase(f"{part}. {zd.base_of(name)}.ism with {fcfg.type} under "
          f"{fcfg.ref_frame_type} (global {gcfg.type}): training on "
          f"{len(clouds)} clouds ({card})")
    pre = name + "_"
    tmp = tempfile.mkdtemp(prefix="pcd_zoo3_")
    try:
        ism = ImplicitShapeModel(cfg, dev)
        for i, (pts, cid) in enumerate(zip(clouds, labels)):
            f = os.path.join(tmp, f"m{i}.pcd")
            save_pcd(f, pts, rgb=None if rgbs is None else rgbs[i])
            ism.add_training_model(f, int(cid), int(cid))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        ism.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = build.launch_counts()
        launches["zoo3_train_" + name] = counts
    finally:
        shutil.rmtree(tmp)
    tt = {k: round(v * 1e3, 3) for k, v in ism.processing_times.items()
          if k.startswith("train_")}
    print(f"training: {len(clouds) / dt:.2f} clouds/s ({dt:.3f} s, host "
          f"clock), stage ms {tt}, launches "
          f"{ {k: v for k, v in counts.items() if v} }, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    missing = [k for k in PATH_KERNELS["zoo3_train_" + name]
               if counts[k] == 0]
    assert not missing, f"{name} training: kernels not launched {missing}"

    cb = ism.state.codebook
    want = {k[len(pre) + 3:]: ref[k] for k in ref
            if k.startswith(pre + "cb_")}
    assert cb.codewords.shape == want["codewords"].shape, \
        f"{name}: codebook {cb.codewords.shape}, JAX " \
        f"{want['codewords'].shape}"
    for k in ("cw_mask", "vote_mask", "vote_class"):
        assert np.array_equal(getattr(cb, k), want[k]), f"{name}: {k}"
    share, cmin = zoo2_cosines(cb.codewords, want["codewords"])
    print(f"codebook: {len(cb.codewords)} codewords as JAX's, "
          f"{100 * share:.2f}% at cosine > 0.999 (min cosine {cmin:.5f}, "
          f"max |delta| {np.abs(cb.codewords - want['codewords']).max():.3g})")
    assert share >= 0.97, f"{name}: codebook {share}"
    glob = ism.state.global_descriptors
    if pre + "glob" in ref:
        assert glob is not None and glob.shape == ref[pre + "glob"].shape, \
            f"{name}: global rows {None if glob is None else glob.shape}"
        _, gmin = zoo2_cosines(glob, ref[pre + "glob"])
        print(f"global descriptors: {len(glob)} {gcfg.type} rows as JAX's, "
              f"min cosine {gmin:.6f}")
        assert gmin > 0.999, f"{name}: global rows off JAX's"
    if name == zd.CGF:
        zoo3_cgf_raw(ref, clouds, fcfg, dev)

    dclouds, drgbs = zd.detection_set(name)
    phase(f"{part}. {name}: detect_batch of {len(dclouds)} clouds x "
          f"{dclouds[0].shape[0]} points ({card})")
    ism.detect_batch(dclouds[:2], None, None if drgbs is None
                     else drgbs[:2])  # warm-up
    got = timed_detect(ism, dclouds, drgbs, "zoo3_" + name, launches, card)
    want = unpack_maxima({k[len(pre) + 4:]: v for k, v in ref.items()
                          if k.startswith(pre + "max_")})
    assert len(got) == len(want)
    same = sum(bool(g) == bool(w) and (not g or g[0].class_id
                                       == int(w[0]["class_id"]))
               for g, w in zip(got, want))
    if zd.base_of(name) == "quickstart":
        firm = [i for i, w in enumerate(want) if firm_decision(w)]
        agree = [i for i in firm if got[i] and got[i][0].class_id
                 == int(want[i][0]["class_id"])]
        print(f"end to end: maxima[0].class_id equals JAX's on "
              f"{len(agree)}/{len(firm)} firm clouds (margin > 0.1), the "
              f"top class on {same}/{len(got)}; {sum(map(len, got))} maxima "
              f"({sum(map(len, want))} JAX's)")
        assert firm and len(agree) == len(firm), \
            f"{name}: decisions differ on {set(firm) - set(agree)}"
    else:
        vparams = _voting_params(ism.config.child("Voting"))
        bw = ism.config.child("Voting").get("Bandwidth", 0.1)
        bad = [(i, b) for i, (g, w) in enumerate(zip(got, want))
               for b in [firm_mismatches(g, w, bw, firm_rtol(
                   vparams.voting_type))] if b]
        print(f"end to end: {len(got) - len(bad)}/{len(got)} clouds meet "
              f"the detection contract, the top class as JAX's on {same}; "
              f"{sum(map(len, got))} maxima ({sum(map(len, want))} JAX's)")
        assert not bad, f"{name}: end to end vs JAX: {bad[:3]}"
    if name != zd.CGF:
        return []
    kpp = KeypointParams.from_config(cfg.child("Keypoints"))
    fss = extract_local_features_batch(
        dclouds[:4], [None] * 4, [None] * 4, fcfg, kpp,
        cfg.root.get("NormalRadius", 0.05),
        cfg.root.get("ConsistentNormalsMethod", 2), dev, is_training=False)
    a = np.concatenate([f.descriptors for f in fss])
    return [(f"{name} ({fcfg.type})", torch.from_numpy(a).to(dev),
             torch.from_numpy(np.asarray(cb.codewords, np.float32)).to(dev),
             torch.from_numpy(np.asarray(cb.cw_mask)).to(dev))]


def zoo3_cgf_raw(ref, clouds, fcfg, dev):
    """14c's raw-row contract on the first training clouds: the card's
    cgf_raw_histogram on JAX's keypoints, frames and keypoint normals over
    its own gather, each row equal to JAX's or moved by pairs in their
    rounding band (tests/zoo2_check.cgf_rows_near)."""
    import numpy as np
    import torch
    import zoo2_check as zc
    import zoo3_data as zd
    from point_cloud_donkey_tpu_torch.models.features import pad_cloud
    from point_cloud_donkey_tpu_torch.ops.cgf import cgf_raw_histogram
    from point_cloud_donkey_tpu_torch.ops.neighbors import \
        gather_radius_neighbors
    differ, near = [], []
    for i in range(zd.CGF_RAW_CLOUDS):
        pts, mask = pad_cloud(clouds[i])
        kp = ref[f"cgf_raw_pos{i}"]
        kpn = ref[f"cgf_raw_kpn{i}"]
        frames = ref[f"cgf_raw_frames{i}"]
        fvalid = ref[f"cgf_raw_fvalid{i}"]

        def d(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)[None]

        nbr = gather_radius_neighbors(d(kp), d(pts), d(mask), fcfg.radius,
                                      min(fcfg.neighbor_capacity, len(pts)))
        raw = cgf_raw_histogram(d(kp), d(kpn), d(frames), d(fvalid), d(pts),
                                nbr, fcfg.radius)[0].cpu().numpy()
        count = (nbr.valid & (nbr.dist > 1e-15)).sum(-1)[0].cpu().numpy()
        want = ref[f"cgf_raw_rows{i}"]
        differ.append(np.abs(raw - want).max(1) > 1e-6)
        near.append(zc.cgf_rows_near(raw, want, count, kp, frames, kpn,
                                     fvalid, clouds[i], fcfg.radius))
    zc.report("14c CGF raw rows on JAX's frames (card)",
              np.concatenate(differ), np.concatenate(near))


def zoo3_trainer(launches, card, dev, ref):
    """14e: train_cgf_embedding.py on the card -- its pairs
    (generate_pairs, zoo3_data.TRAIN_PAIRS) against the JAX tool's at
    cosine > 0.999 on >= 97% of the rows, then TRAIN_STEPS steps from the
    JAX tool's pairs and initial weights (the port's draw of the seed with
    the committed corrections: entries a few ulps off, from XLA's log1p):
    each step's loss within rtol 1e-4 of JAX's, each final layer at
    cosine > 0.9999 (w0 on its committed rows)."""
    import numpy as np
    import torch
    import zoo3_data as zd
    from point_cloud_donkey_tpu_torch import train_cgf_embedding as tce
    from point_cloud_donkey_tpu_torch.kernels import build
    phase(f"14e. train_cgf_embedding.py --device cuda: {zd.TRAIN_PAIRS} "
          f"pairs, {zd.TRAIN_STEPS} steps ({card})")
    a, p = ref["train_a"], ref["train_p"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ga, gp = tce.generate_pairs(zd.TRAIN_PAIRS, 1024, 0.6, zd.TRAIN_SEED,
                                device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = build.launch_counts()
    launches["zoo3_trainer"] = counts
    missing = [k for k in PATH_KERNELS["zoo3_trainer"] if counts[k] == 0]
    assert not missing, f"trainer pairs: kernels not launched {missing}"
    assert ga.shape == a.shape and gp.shape == p.shape
    share, _ = zoo2_cosines(np.concatenate([ga, gp]), np.concatenate([a, p]))
    print(f"pairs: {len(ga)} in {dt:.3f} s ({2 * len(ga) / dt:.1f} raw "
          f"rows/s, host clock), {100 * share:.2f}% of the rows at cosine > "
          f"0.999 of JAX's, launches "
          f"{ {k: v for k, v in counts.items() if v} }, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    assert share >= 0.97, f"trainer pairs off JAX's: {share}"
    init = tce.initial_layers(a.shape[1], zd.TRAIN_DIMS, zd.TRAIN_SEED)
    for i, (w, _) in enumerate(init):
        flat = w.reshape(-1)
        flat[ref[f"train_fix_idx{i}"]] = ref[f"train_fix_val{i}"]
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = tce.train(a, p, zd.TRAIN_DIMS, zd.TRAIN_STEPS, zd.TRAIN_BATCH,
                      1e-3, zd.TRAIN_SEED, device=dev, init=init,
                      losses=losses)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = np.abs(np.array(losses) / ref["train_losses"] - 1.0)
    cos = []
    for i, (w, b) in enumerate(final):
        if i == 0:
            w = w[ref["train_w0_rows"]]
        for x, y in ((w, ref[f"train_w{i}"]), (b, ref[f"train_b{i}"])):
            cos.append(float((x * y).sum() / max(
                np.linalg.norm(x) * np.linalg.norm(y), 1e-30)))
    print(f"training: {zd.TRAIN_STEPS} steps in {dt:.3f} s "
          f"({zd.TRAIN_STEPS * zd.TRAIN_BATCH / dt:.1f} pairs/s, host "
          f"clock), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, max rel off JAX's "
          f"{rel.max():.2e}; final layers' min cosine {min(cos):.7f} "
          f"({card})")
    assert rel.max() <= 1e-4, f"trainer losses off JAX's: {rel}"
    assert min(cos) > 0.9999, f"trainer final layers off JAX's: {cos}"


if __name__ == "__main__":
    main()
