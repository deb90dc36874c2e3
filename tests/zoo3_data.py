"""The configurations and inputs of CGF and the LRF variants, shared by
tests/zoo3_fixtures.py (the JAX-CPU reference,
point_cloud_donkey_tpu_torch/data/zoo3_reference.npz) and chip_smoke.py's
phase 14.  numpy only (chip_smoke.py reads it on the card).

Each configuration is a shipped config with its Features (and
GlobalFeatures) changed in code, as tests/zoo2_data.py changes them:

  14a  configs/quickstart.ism (ChiSquared, millimetres) x70 with SHOT
       under ReferenceFrameType SHOTNA, BOARD and FLARE and SHORT_SHOT
       under FLARE: trained on the five bench training clouds, detecting
       the 32 bench clouds (phase 10b's inputs);
  14b  configs/default.ism (Euclidean) x0.3 on phase 10a's 16 coloured
       scenes with CSHOT under BOARD, verified by CSHOT_GLOBAL + the SVM
       under BOARD, trained on bench_data.DEFAULT_VIEWS coloured views;
  14c  configs/quickstart.ism x70 with CGF and the shipped embedding,
       detecting the 32 bench clouds and the five training clouds
       (detection_set says why).  One key differs from the shipped
       config: DistanceType Euclidean (CGF_CHANGED).  CGF's embedded rows
       are signed, and under ChiSquared a term whose a + b lies at the
       rounding of 0 takes any size, the class sigma with it (ROADMAP C,
       RoPS).

14e trains the embedding (train_cgf_embedding.py) for TRAIN_STEPS steps
on TRAIN_PAIRS pairs that the JAX tool generated (its defaults otherwise).
"""

import copy
import json
import os

import numpy as np

from bench_data import (DEFAULT_VIEWS, DETECT_SCALES, bench_clouds,
                        bench_colors, detect_inputs, training_views)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LRF_14A = {
    "shot_shotna": ("SHOT", "SHOTNA"),
    "shot_board": ("SHOT", "BOARD"),
    "shot_flare": ("SHOT", "FLARE"),
    "short_shot_flare": ("SHORT_SHOT", "FLARE"),
}
CSHOT_BOARD = "cshot_board"
CGF = "cgf"
CGF_CHANGED = {"DistanceType": "Euclidean"}
CONFIGS = tuple(LRF_14A) + (CSHOT_BOARD, CGF)
# the training clouds whose CGF raw rows, frames and keypoint normals the
# reference keeps (14c's raw-row contract)
CGF_RAW_CLOUDS = 2
# 14e: the JAX tool's pairs (generate_pairs(TRAIN_PAIRS, 1024, 0.6, 0)),
# then TRAIN_STEPS steps at its defaults but the batch
TRAIN_PAIRS = 256
TRAIN_STEPS = 20
TRAIN_BATCH = 128
TRAIN_DIMS = (512, 64, 32)
TRAIN_SEED = 0


def shipped(name: str) -> dict:
    with open(os.path.join(REPO, "configs", f"{name}.ism")) as f:
        return json.load(f)


def base_of(name: str) -> str:
    return "default" if name == CSHOT_BOARD else "quickstart"


def zoo3_config(name: str) -> dict:
    """The .ism JSON of configuration `name`."""
    cfg = copy.deepcopy(shipped(base_of(name)))
    ch = cfg["ObjectConfig"]["Children"]
    if name in LRF_14A:
        ch["Features"]["Type"], frame = LRF_14A[name]
        ch["Features"]["Parameters"]["ReferenceFrameType"] = frame
    elif name == CSHOT_BOARD:
        ch["Features"]["Parameters"]["ReferenceFrameType"] = "BOARD"
        ch["GlobalFeatures"]["Parameters"]["ReferenceFrameType"] = "BOARD"
    else:
        ch["Features"]["Type"] = "CGF"
        cfg["ObjectConfig"]["Parameters"].update(CGF_CHANGED)
    return cfg


def training_set(name: str):
    """(clouds, labels, colours or None) that `name` trains on, scaled."""
    if base_of(name) == "default":
        clouds, labels = training_views(DEFAULT_VIEWS)
        scale = np.float32(DETECT_SCALES["default"])
        return list(clouds * scale), labels, list(bench_colors(clouds))
    train, labels, _, _ = bench_clouds(0)
    return list(train * np.float32(DETECT_SCALES["quickstart"])), labels, \
        None


def detection_set(name: str):
    """(clouds, colours or None) that `name` detects; CGF the five
    training clouds after the 32 bench clouds: the shipped embedding's
    rows lie ~1e-3 apart and the class sigma (a variance) ~1e-7, so the
    vote gate |d| <= 2 sigma (codeword_distribution.cpp:131-135) passes a
    training cloud's own features only, in both packages."""
    clouds, rgbs = detect_inputs(base_of(name))
    if name == CGF:
        return list(clouds) + training_set(name)[0], None
    return list(clouds), None if rgbs is None else list(rgbs)
