"""Detection metrics: greedy GT matching, precision/recall/AP, PR curves
(the port's copy of point_cloud_donkey_tpu/models/metrics.py).

Reference: eval_tool/eval_helpers_detection.h:125-339.
  * match_gt_objects: detections sorted by descending confidence greedily
    claim the nearest unused ground-truth object of the same class within the
    per-class distance threshold; everything else is a false positive.
  * computeAllMetrics: precision = tp/(tp+fp), recall = tp/num_gt, AP =
    sum over tp hits of (cumul_tp / rank) / num_gt.
  * computePrecisionRecallForPlotting: pool all classes' detections by
    confidence for the dataset-level PR curve and overall AP.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class DetectionObject:
    """One detected or ground-truth object instance
    (eval_helpers_detection.h:42-72)."""
    class_label: str
    instance_label: str
    global_class_label: str
    position: np.ndarray
    occlusion_ratio: float = 0.0
    confidence: float = 1.0
    filepath: str = ""
    cloud_filepath: str = ""
    bb_extent: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    bb_quat: np.ndarray = field(default_factory=lambda: np.array([1, 0, 0, 0], np.float32))


def parse_annotation_file(filename: str, cloud_filename: str = ""
                          ) -> List[DetectionObject]:
    """Annotation line format: `class (occlusion) x y z [ex ey ez qw qx qy qz]`
    (eval_helpers_detection.h:441-499)."""
    objects = []
    with open(filename) as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            if len(tokens) not in (5, 12):
                raise ValueError(
                    f"{filename}: expected 5 or 12 tokens, got {len(tokens)}")
            class_name = tokens[0]
            if class_name in ("book", "books", "dress"):  # sun-rgbd fix
                continue
            occl = float(tokens[1].strip("()"))
            pos = np.array([float(t) for t in tokens[2:5]], np.float32)
            box = np.zeros(3, np.float32)
            quat = np.array([1, 0, 0, 0], np.float32)
            if len(tokens) == 12:
                box = np.array([float(t) for t in tokens[5:8]], np.float32)
                quat = np.array([float(t) for t in tokens[8:12]], np.float32)
            objects.append(DetectionObject(
                class_label=class_name, instance_label=class_name,
                global_class_label=class_name, position=pos,
                occlusion_ratio=occl, confidence=1.0, filepath=filename,
                cloud_filepath=cloud_filename, bb_extent=box, bb_quat=quat))
    return objects


def rearrange_objects(objects: List[DetectionObject],
                      use_global: bool = False
                      ) -> Dict[str, List[DetectionObject]]:
    """Group objects by (global) class label."""
    out: Dict[str, List[DetectionObject]] = {}
    for o in objects:
        label = o.global_class_label if use_global else o.class_label
        out.setdefault(label, []).append(o)
    return out


def match_gt_objects(gt: List[DetectionObject], det: List[DetectionObject],
                     dist_threshold: float
                     ) -> Tuple[List[int], List[int], List[DetectionObject]]:
    """Greedy confidence-ordered matching (eval_helpers_detection.h:225-280).
    Returns (tp flags, fp flags, detections sorted by confidence)."""
    det_sorted = sorted(det, key=lambda o: -o.confidence)
    used = [False] * len(gt)
    tp = [0] * len(det_sorted)
    fp = [0] * len(det_sorted)
    for di, d in enumerate(det_sorted):
        best_dist, best_idx = np.inf, -1
        for gi, g in enumerate(gt):
            if d.filepath != g.filepath or d.class_label != g.class_label:
                continue
            dist = float(np.linalg.norm(g.position - d.position))
            if dist < best_dist and not used[gi]:
                best_dist, best_idx = dist, gi
        if best_dist > dist_threshold or best_idx == -1:
            fp[di] = 1
        else:
            tp[di] = 1
            used[best_idx] = True
    return tp, fp, det_sorted


def compute_all_metrics(gt: List[DetectionObject], det: List[DetectionObject],
                        dist_threshold: float):
    """computeAllMetrics (eval_helpers_detection.h:305-339): returns
    (precision, recall, ap, cumul_tp, cumul_fp, tp list, fp list)."""
    tp, fp, _ = match_gt_objects(gt, det, dist_threshold)
    num_gt = len(gt)
    tp_sum, fp_sum = sum(tp), sum(fp)
    precision = tp_sum / (tp_sum + fp_sum) if (tp_sum + fp_sum) else 0.0
    recall = tp_sum / num_gt if num_gt else 0.0
    ap = 0.0
    cumul = 0
    for i, t in enumerate(tp):
        if t == 1:
            cumul += 1
            ap += (cumul / (i + 1)) * (1.0 / num_gt)
    return precision, recall, ap, tp_sum, fp_sum, tp, fp


def precision_recall_curve(
    det_class_map: Dict[str, List[DetectionObject]],
    gt_class_map: Dict[str, List[DetectionObject]],
    tps_per_class: Dict[str, List[int]],
    fps_per_class: Dict[str, List[int]],
) -> Tuple[List[float], List[float], float]:
    """Dataset-level PR curve + overall AP
    (eval_helpers_detection.h:147-220)."""
    num_gt = sum(len(v) for v in gt_class_map.values())
    all_det = []
    for label, det_list in det_class_map.items():
        det_sorted = sorted(det_list, key=lambda o: -o.confidence)
        tps = tps_per_class.get(label, [])
        fps = fps_per_class.get(label, [])
        for i, o in enumerate(det_sorted):
            if not tps and not fps:
                all_det.append((0.0, 0, 0))
            else:
                all_det.append((o.confidence, tps[i], fps[i]))
    all_det.sort(key=lambda t: -t[0])

    tp_sum = fp_sum = 0
    ap = 0.0
    precisions, recalls = [], []
    for conf, tp, fp in all_det:
        tp_sum += tp
        fp_sum += fp
        precisions.append(tp_sum / (tp_sum + fp_sum) if (tp_sum + fp_sum) else 0.0)
        recalls.append(tp_sum / num_gt if num_gt else 0.0)
        if tp == 1 and num_gt:
            ap += (tp_sum / (tp_sum + fp_sum)) / num_gt
    return precisions, recalls, ap
