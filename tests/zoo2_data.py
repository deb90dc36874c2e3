"""The rest of the descriptor zoo's configurations and inputs, shared by
tests/zoo2_fixtures.py (the JAX-CPU reference,
point_cloud_donkey_tpu_torch/data/zoo2_reference.npz) and chip_smoke.py's
phase 13.  numpy only (chip_smoke.py reads it on the card).

Each configuration is a shipped config with its Features (and
GlobalFeatures) swapped in code, as tests/zoo_data.py swaps them:

  13a  configs/quickstart.ism (ChiSquared, millimetres) with BSHOT,
       SHORT_SHOT_PCL, SpinImage, PFH, 3DSC, USC, RSD (both
       UseFullRSDHistogram modes), RoPS and ESF_LOCAL as shipped
       otherwise: trained on the five bench training clouds x70, detecting
       the 32 bench clouds x70 (phase 10b's inputs);
  13b  configs/default.ism (Euclidean, CSHOT local features, SVM
       verification per maximum) x0.3 on phase 10a's 16 coloured scenes,
       trained on bench_data.DEFAULT_VIEWS coloured views: COSPAIR and
       RIFT as the local features (verified by ESF and VFH), GASD as the
       local feature (verified by GRSD), and CSHOT verified by GASD with
       and without colour, CVFH, OURCVFH (on the first 5 views, detecting
       the first 8 scenes) and USC_GLOBAL;
  13c  configs/quickstart.ism with NARF on rendered camera views
       (tests/kinect_data.object_view, metres x1000: the bench shapes are
       centred on the camera, half behind it) at a 320 x 240 range image
       (focal 525 / 2), trained on two views of each class, detecting one
       more of each.

The bench configs' own radii are kept (Radius 60 mm / 0.4, the SHOT LRF
at ReferenceFrameRadius); a global descriptor's LRF (USC_GLOBAL) at 1.0
x0.3 so the centroid of a view has its 5 neighbours; CVFH's cluster
tolerance at 0.03 (the views' point spacing is ~1 cm after x0.3).
"""

import copy
import json
import os

import numpy as np

from bench_data import (DEFAULT_VIEWS, DETECT_SCALES, bench_clouds,
                        bench_colors, detect_inputs, training_views)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOCAL_13A = {
    "bshot": {"Type": "BSHOT"},
    "short_shot_pcl": {"Type": "SHORT_SHOT_PCL"},
    "spin_image": {"Type": "SpinImage"},
    "pfh": {"Type": "PFH"},
    "3dsc": {"Type": "3DSC"},
    "usc": {"Type": "USC"},
    "rsd": {"Type": "RSD"},
    "rsd_min_max": {"Type": "RSD",
                    "Parameters": {"UseFullRSDHistogram": False}},
    "rops": {"Type": "RoPS"},
    "esf_local": {"Type": "ESF_LOCAL"},
}
_G = {"Radius": 0.3, "ReferenceFrameRadius": 0.3,
      "ReferenceFrameType": "SHOT"}
_CVFH = {**_G, "CvfhClusterTolerance": 0.03}
GLOBAL_13B = {
    "cospair_esf": ({"Type": "COSPAIR"}, {"Type": "ESF", "Parameters": _G}),
    "rift_vfh": ({"Type": "RIFT"}, {"Type": "VFH", "Parameters": _G}),
    "gasd_grsd": ({"Type": "GASD"}, {"Type": "GRSD", "Parameters": _G}),
    "cshot_gasd": (None, {"Type": "GASD", "Parameters": _G}),
    "cshot_gasd_shape": (None, {"Type": "GASD", "Parameters": {
        **_G, "GasdWithColor": False}}),
    "cshot_cvfh": (None, {"Type": "CVFH", "Parameters": _CVFH}),
    "cshot_ourcvfh": (None, {"Type": "OURCVFH", "Parameters": _CVFH}),
    "cshot_usc_global": (None, {"Type": "USC_GLOBAL", "Parameters": {
        **_G, "ReferenceFrameRadius": 1.0}}),
}
NARF_13C = {"Type": "NARF", "Parameters": {
    "Radius": 60.0, "ReferenceFrameRadius": 50.0, "NarfImageWidth": 320,
    "NarfImageHeight": 240, "NarfFocalLength": 262.5}}
NARF_SCALE = 1000.0
# (class, yaw) of 13c's training views and of its detection views
NARF_TRAIN = [(c, y) for c in range(4) for y in (0.3, 2.4)]
NARF_DETECT = [(c, 1.3) for c in range(4)]
CONFIGS = tuple(LOCAL_13A) + tuple(GLOBAL_13B) + ("narf",)
# a codeword may miss cosine > 0.999 where its entries lie within the JAX
# golden test's tolerance of JAX's (tests/test_golden_descriptors.py):
# PFH's bins move 100 / C(k, 2) a pair on a bin edge, and the card's
# normals move its pair features' edges
CODEWORD_ATOL = {"pfh": 0.15}
# held end to end to the firm decisions (the top class where its margin is
# > 0.1), not the weights: RIFT's intensity gradients solve a 3 x 3 system
# a point from moments of raw coordinates, whose rounding cond(A) (up to
# 1e7 on these scenes) amplifies past the weights' 10% (tests/zoo2_check.py)
DECISIONS_ONLY = ("rift_vfh",)
# CVFH / OURCVFH cut to the first few training views and detection scenes:
# their region rows (~4 and ~7 a view) make the SVM's host grid search
# (train_rest) 13-35 s on 10 views, and the host region growing and the
# SVM a ROI take ~0.9 s a scene
TRAIN_VIEWS = {"cshot_cvfh": 5, "cshot_ourcvfh": 5}
DETECT_CLOUDS = {"cshot_cvfh": 8, "cshot_ourcvfh": 8}


def shipped(name: str) -> dict:
    with open(os.path.join(REPO, "configs", f"{name}.ism")) as f:
        return json.load(f)


def base_of(name: str) -> str:
    return "default" if name in GLOBAL_13B else "quickstart"


def zoo2_config(name: str) -> dict:
    """The .ism JSON of configuration `name`."""
    cfg = copy.deepcopy(shipped(base_of(name)))
    ch = cfg["ObjectConfig"]["Children"]
    if name in LOCAL_13A or name == "narf":
        spec = LOCAL_13A.get(name, NARF_13C)
        ch["Features"]["Type"] = spec["Type"]
        ch["Features"]["Parameters"].update(spec.get("Parameters", {}))
        return cfg
    local, glob = GLOBAL_13B[name]
    if local is not None:
        ch["Features"]["Type"] = local["Type"]
    ch["GlobalFeatures"] = copy.deepcopy(glob)
    return cfg


def _camera_view(cid: int, yaw: float, seed: int):
    import kinect_data
    v = kinect_data.object_view(cid, 0.8, yaw, seed=seed)
    return (v.xyz * np.float32(NARF_SCALE)).astype(np.float32)


def training_set(name: str):
    """(clouds, labels, colours or None) that `name` trains on, scaled."""
    if name == "narf":
        clouds = [_camera_view(c, y, 300 + i)
                  for i, (c, y) in enumerate(NARF_TRAIN)]
        return clouds, np.array([c for c, _ in NARF_TRAIN]), None
    if base_of(name) == "default":
        clouds, labels = training_views(DEFAULT_VIEWS)
        k = TRAIN_VIEWS.get(name, DEFAULT_VIEWS)
        scale = np.float32(DETECT_SCALES["default"])
        return list(clouds[:k] * scale), labels[:k], \
            list(bench_colors(clouds[:k]))
    train, labels, _, _ = bench_clouds(0)
    return list(train * np.float32(DETECT_SCALES["quickstart"])), labels, \
        None


def detection_set(name: str):
    """(clouds, colours or None) that `name` detects."""
    if name == "narf":
        return [_camera_view(c, y, 400 + i)
                for i, (c, y) in enumerate(NARF_DETECT)], None
    clouds, rgbs = detect_inputs(base_of(name))
    k = DETECT_CLOUDS.get(name, len(clouds))
    return list(clouds[:k]), None if rgbs is None else list(rgbs[:k])
