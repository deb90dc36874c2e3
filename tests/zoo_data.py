"""The descriptor zoo's and the keypoint detectors' configurations, their
inputs and their contracts, shared by tests/zoo_fixtures.py (the JAX-CPU
reference, point_cloud_donkey_tpu_torch/data/zoo_reference.npz),
chip_smoke.py's phase 12 and the CPU tests (tests/test_torch_zoo.py,
tests/test_torch_detectors.py, tests/test_torch_eval_classification.py).

Each configuration is a shipped config (configs/quickstart.ism, which is
in millimetres, or configs/default.ism) with its Keypoints and Features
swapped in code, as phase 4e swaps the bench config's:

  harris_fpfh      quickstart.ism, Harris3D + FPFH, trained on the five
                   bench training clouds x70, detecting the first 32 bench
                   clouds x70 (phase 10b's inputs);
  iss_short_cshot  default.ism, ISS3D + SHORT_CSHOT with
                   SHORT_CSHOT_GLOBAL verification under chi-square,
                   trained on bench_data.DEFAULT_VIEWS coloured views
                   x0.3, detecting phase 10a's 16 coloured scenes x0.3;
  sift_short_shot  quickstart.ism, SIFT3D + SHORT_SHOT with UseMinRadius
                   and the log radius, phase 10b's inputs;
  scene_harris_fpfh, scene_iss_fpfh
                   default.ism, Harris3D / ISS3D + FPFH at unit scale on
                   the 1e5-point scene of phase 11f (bench_scenes, four
                   25000-point objects): the tiled detectors and FPFH's
                   doubled window (features only).

The detector parameters are the JAX package's tests'
(tests/test_keypoint_detectors.py, tests/test_tiled.py:240) scaled to these
clouds, so that every cloud keeps at least 32 keypoints: the bench shapes
are smooth, so Harris3D's threshold is off (-1e9: every local maximum of
the response within its radius, as non-max suppression leaves them).
"""

import copy
import json
import os

import numpy as np

from bench_data import (DEFAULT_VIEWS, DETECT_SCALES, bench_clouds,
                        bench_colors, bench_scenes, detect_inputs,
                        training_views)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ZOO = {
    "harris_fpfh": {
        "base": "quickstart",
        "Keypoints": {"Type": "Harris3D", "Parameters": {
            "Radius": 9.0, "Threshold": -1e9, "NonMaxSupression": True,
            "Refine": True}},
        "Features": {"Type": "FPFH", "Parameters": {
            "Radius": 60.0, "ReferenceFrameRadius": 50.0,
            "ReferenceFrameType": "SHOT"}}},
    "iss_short_cshot": {
        "base": "default",
        "Keypoints": {"Type": "ISS3D", "Parameters": {
            "SalientRadius": 0.06, "NonMaxRadius": 0.03, "Gamma21": 0.975,
            "Gamma32": 0.975, "MinNeighbors": 5}},
        "Features": {"Type": "SHORT_CSHOT", "Parameters": {
            "Radius": 0.4, "ReferenceFrameRadius": 0.3,
            "ReferenceFrameType": "SHOT"}},
        "GlobalFeatures": {"Type": "SHORT_CSHOT_GLOBAL", "Parameters": {
            "Radius": 0.3, "ReferenceFrameRadius": 0.3,
            "ReferenceFrameType": "SHOT"}},
        "Parameters": {"DistanceType": "ChiSquared"}},
    "sift_short_shot": {
        "base": "quickstart",
        "Keypoints": {"Type": "SIFT3D", "Parameters": {"Radius": 3.5}},
        "Features": {"Type": "SHORT_SHOT", "Parameters": {
            "Radius": 60.0, "ReferenceFrameRadius": 50.0,
            "ReferenceFrameType": "SHOT", "UseMinRadius": True,
            "ShortShotMinRadius": 0.1, "ShortShotLogRadius": True}}},
    "scene_harris_fpfh": {
        "base": "default",
        "Keypoints": {"Type": "Harris3D", "Parameters": {
            "Radius": 0.05, "Threshold": -1e9, "NonMaxSupression": True,
            "Refine": True}},
        "Features": {"Type": "FPFH", "Parameters": {
            "Radius": 0.1, "ReferenceFrameRadius": 0.1,
            "ReferenceFrameType": "SHOT"}}},
    "scene_iss_fpfh": {
        "base": "default",
        "Keypoints": {"Type": "ISS3D", "Parameters": {
            "SalientRadius": 0.05, "NonMaxRadius": 0.03, "MinNeighbors": 5}},
        "Features": {"Type": "FPFH", "Parameters": {
            "Radius": 0.1, "ReferenceFrameRadius": 0.1,
            "ReferenceFrameType": "SHOT"}}},
}
DETECTIONS = ("harris_fpfh", "iss_short_cshot", "sift_short_shot")
SCENE_CONFIGS = ("scene_harris_fpfh", "scene_iss_fpfh")
# the scene of phase 11f: bench_scenes(1, scale 1, SCENE_POINTS an
# object, SCENE_SEED)
SCENE_POINTS = 25000
SCENE_SEED = 31
# phase 12e: eval_classification's file lists (harris_fpfh's config)
EVAL_TEST_CLOUDS = 10
# at least this many keypoints on every cloud of the zoo
MIN_KEYPOINTS = 32


def shipped(name: str) -> dict:
    with open(os.path.join(REPO, "configs", f"{name}.ism")) as f:
        return json.load(f)


def zoo_config(name: str) -> dict:
    """The .ism JSON of the zoo configuration `name`."""
    spec = ZOO[name]
    cfg = copy.deepcopy(shipped(spec["base"]))
    obj = cfg["ObjectConfig"]
    for child in ("Keypoints", "Features", "GlobalFeatures"):
        if child in spec:
            obj["Children"][child] = copy.deepcopy(spec[child])
    obj["Parameters"].update(spec.get("Parameters", {}))
    return cfg


def scale_of(name: str) -> float:
    return DETECT_SCALES[ZOO[name]["base"]] if name in DETECTIONS else 1.0


def training_set(name: str):
    """(clouds [M, n, 3], labels [M], colours [M, n, 3] or None): the
    models `name` trains on, scaled."""
    scale = np.float32(scale_of(name))
    if ZOO[name]["base"] == "default":
        clouds, labels = training_views(DEFAULT_VIEWS)
        return clouds * scale, labels, bench_colors(clouds)
    clouds, labels, _, _ = bench_clouds(0)
    return clouds * scale, labels, None


def detection_set(name: str):
    """(clouds [B, N, 3], colours or None) that `name` detects."""
    base = ZOO[name]["base"]
    return detect_inputs(base)


def scene():
    """The 1e5-point scene of phase 12d (phase 11f's)."""
    clouds, _, _ = bench_scenes(1, scale=1.0, n=SCENE_POINTS,
                                seed=SCENE_SEED)
    return clouds[0]


def eval_lists(root: str):
    """Write eval_classification's file lists under `root` (the five bench
    training clouds x70, the first EVAL_TEST_CLOUDS bench clouds x70, as
    PCD files named by class): (train list, test list)."""
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd
    names = ["c0", "c1", "c2", "c3", "c4"]
    scale = np.float32(DETECT_SCALES["quickstart"])
    train, labels, clouds, test_labels = bench_clouds(EVAL_TEST_CLOUDS)
    lines = ["# train"]
    for i, (c, lab) in enumerate(zip(train, labels)):
        p = os.path.join(root, f"train{i}.pcd")
        save_pcd(p, c * scale)
        lines.append(f"{p} {names[lab]}")
    tr = os.path.join(root, "train.txt")
    with open(tr, "w") as f:
        f.write("\n".join(lines) + "\n")
    lines = ["# test"]
    for i, (c, lab) in enumerate(zip(clouds, test_labels)):
        p = os.path.join(root, f"test{i}.pcd")
        save_pcd(p, c * scale)
        lines.append(f"{p} {names[lab]}")
    te = os.path.join(root, "test.txt")
    with open(te, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tr, te


def summary_labels(path: str) -> np.ndarray:
    """[files, 2] (ground truth, classified class) of a summary.txt."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("file: "):
                parts = dict(p.split(": ") for p in line.strip().split(", ")
                             if ": " in p)
                out.append((int(parts["ground truth class"]),
                            int(parts["classified class"])))
    return np.asarray(out, np.int64).reshape(-1, 2)
