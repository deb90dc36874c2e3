"""The global classifier: each maximum verified with global descriptors
(port of point_cloud_donkey_tpu/models/classifier.py).

Reference: classifier/global_classifier.cpp.
  * segmentROI: the points within the per-class average radius of the
    maximum (global_classifier.cpp:132-171); the radii are the per-class
    means of the training global features' globalDescriptorRadius
    (:55-67);
  * KNN: the k nearest training global descriptors (ops/neighbors.knn on
    the device: squared L2 through the matmul identity, chi-square through
    K4), score exp(-sqrt(d)) accumulated per class and instance;
    single-object mode takes the most frequent class, otherwise the score
    of the maximum's own class (:242-347);
  * SVM: the chi-square SVM (models/svm.py), instance labels from KNN
    (:199-227);
  * merge functions 1-7 of the global and local hypotheses (:457-577),
    with the rank-gated useHighRankedGlobalHypothesis (:579-601).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.neighbors import full_fp32, knn
from .svm import SVMModel
from .voting import VotingMaximum, VotingParams


@dataclass
class GlobalClassifier:
    descriptors: np.ndarray   # [G, Dg] the training global descriptors
    classes: np.ndarray       # [G]
    instances: np.ndarray     # [G]
    average_radii: Dict[int, float]   # class -> mean training global radius
    metric: str = "l2"
    method: str = "KNN"       # "KNN" | "SVM"
    k: int = 1
    single_object_mode: bool = False
    svm: Optional[SVMModel] = None
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self._db = None

    def segment_roi(self, points: np.ndarray, normals: Optional[np.ndarray],
                    maximum: VotingMaximum
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        radius = self.average_radii.get(maximum.class_id, 0.0)
        d = np.linalg.norm(points - maximum.position[None, :], axis=1)
        sel = d <= radius
        return points[sel], (None if normals is None else normals[sel])

    def classify(self, global_desc: np.ndarray, maximum: VotingMaximum,
                 min_points_ok: bool = True) -> None:
        """Fill maximum.glob_* from the global descriptor(s) [Q, Dg] of its
        segment."""
        if not min_points_ok or global_desc.shape[0] == 0:
            maximum.glob_class_id = maximum.class_id
            maximum.glob_class_weight = 0.0
            maximum.glob_instance_id = maximum.instance_id
            maximum.glob_instance_weight = 0.0
            return
        if self.method == "SVM" and self.svm is not None:
            self._classify_svm(global_desc, maximum)
            # instance labels through KNN when the widths match
            if self.descriptors is not None and \
                    global_desc.shape[1] == self.descriptors.shape[1]:
                tmp = VotingMaximum(class_id=maximum.class_id)
                self._classify_knn(global_desc, tmp)
                maximum.glob_instance_id = tmp.glob_instance_id
                maximum.glob_instance_weight = tmp.glob_instance_weight
        else:
            self._classify_knn(global_desc, maximum)

    def _database(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training descriptors and their mask on the device, uploaded
        once."""
        if self._db is None:
            db = torch.from_numpy(np.ascontiguousarray(
                self.descriptors, np.float32)).to(self.device)
            self._db = (db, torch.ones(db.shape[0], dtype=torch.bool,
                                       device=self.device))
        return self._db

    def _classify_knn(self, global_desc: np.ndarray,
                      maximum: VotingMaximum) -> None:
        db, mask = self._database()
        k = min(self.k, db.shape[0])
        with full_fp32():
            d, idx = knn(torch.from_numpy(np.ascontiguousarray(
                global_desc, np.float32)).to(self.device), db, mask, k,
                self.metric)
        d, idx = d.cpu().numpy(), idx.cpu().numpy()
        occ: Dict[int, List[float]] = {}
        inst_acc: Dict[int, Dict[int, List[float]]] = {}
        for q in range(d.shape[0]):
            for i in range(k):
                cid = int(self.classes[idx[q, i]])
                iid = int(self.instances[idx[q, i]])
                score = float(np.exp(-np.sqrt(max(d[q, i], 0.0))))
                occ.setdefault(cid, []).append(score)
                inst_acc.setdefault(cid, {}).setdefault(iid, []).append(
                    score)
        if not occ:
            return
        if self.single_object_mode:
            best_cls = max(occ, key=lambda c: len(occ[c]))
        else:
            best_cls = maximum.class_id
            if best_cls not in occ:
                return
        scores = occ[best_cls]
        maximum.glob_class_id = best_cls
        maximum.glob_class_weight = float(np.sum(scores) / len(scores))
        insts = inst_acc[best_cls]
        best_inst = max(insts, key=lambda i: len(insts[i]))
        maximum.glob_instance_id = best_inst
        maximum.glob_instance_weight = float(
            np.sum(insts[best_inst]) / len(insts[best_inst]))

    def _classify_svm(self, global_desc: np.ndarray,
                      maximum: VotingMaximum) -> None:
        responses = [self.svm.predict(global_desc[q])
                     for q in range(global_desc.shape[0])]
        if len(responses) > 1:
            # the most frequent label, then its best score
            # (global_classifier.cpp:371-407)
            labels = [r[0] for r in responses]
            best_label = max(set(labels), key=labels.count)
            best = max((r for r in responses if r[0] == best_label),
                       key=lambda r: r[1])
        else:
            best = responses[0]
        label, score, all_scores = best
        if self.single_object_mode:
            maximum.glob_class_id = label
            maximum.glob_class_weight = score
        else:
            maximum.glob_class_id = maximum.class_id
            cls_list = list(self.svm.classes)
            maximum.glob_class_weight = float(
                all_scores[cls_list.index(maximum.class_id)]) \
                if maximum.class_id in cls_list else 0.0


def merge_global_and_local(maxima: List[VotingMaximum], params: VotingParams,
                           roi_centroid: np.ndarray) -> None:
    """mergeGlobalAndLocalHypotheses (global_classifier.cpp:457-577)."""
    if not maxima:
        return
    mf = params.merge_function
    radius = params.bandwidth
    dont_care = float(np.linalg.norm(roi_centroid)) == 0.0

    if mf == 1:
        if maxima[0].glob_class_weight > params.min_svm_score:
            maxima[0].class_id = maxima[0].glob_class_id
            maxima[0].instance_id = maxima[0].glob_instance_id
    elif mf == 2:
        if maxima[0].glob_class_weight > params.min_svm_score:
            _use_high_ranked(maxima, params.rate_limit)
    elif mf == 3:
        _use_high_ranked(maxima, params.rate_limit)
    elif mf == 4:
        for m in maxima:
            dist = float(np.linalg.norm(m.position - roi_centroid))
            close = dont_care or dist < radius / 2.0
            if m.class_id == m.glob_class_id and close:
                m.weight = 0.0 if m.glob_class_weight == 0 \
                    else m.weight * params.weight_factor
            if m.instance_id == m.glob_instance_id and close:
                m.instance_weight = 0.0 if m.glob_instance_weight == 0 \
                    else m.instance_weight * params.weight_factor
    elif mf == 5:
        for m in maxima:
            dist = float(np.linalg.norm(m.position - roi_centroid))
            if dont_care or dist < radius / 2.0:
                if m.class_id == m.glob_class_id:
                    m.weight *= 1 + m.glob_class_weight
                if m.instance_id == m.glob_instance_id:
                    m.instance_weight *= 1 + m.glob_instance_weight
    elif mf == 6:
        for m in maxima:
            if m.class_id == m.glob_class_id:
                m.weight *= m.glob_class_weight
            if m.instance_id == m.glob_instance_id:
                m.instance_weight *= m.glob_instance_weight
    elif mf == 7:
        for m in maxima:
            if m.class_id == m.glob_class_id:
                dist = float(np.linalg.norm(m.position - roi_centroid))
                if dont_care or dist < radius / 2.0:
                    w1, w2 = m.weight, m.glob_class_weight
                    m.weight = w1 + w2 - w1 * w2
                    if m.instance_id == m.glob_instance_id:
                        w1, w2 = m.instance_weight, m.glob_instance_weight
                        m.instance_weight = w1 + w2 - w1 * w2


def _use_high_ranked(maxima: List[VotingMaximum], rate_limit: float) -> None:
    """useHighRankedGlobalHypothesis (global_classifier.cpp:579-601)."""
    top_weight = maxima[0].weight
    global_class = maxima[0].glob_class_id
    for m in maxima:
        if m.weight >= top_weight * rate_limit and m.class_id == global_class:
            maxima[0].class_id = maxima[0].glob_class_id
            maxima[0].instance_id = maxima[0].glob_instance_id
            break
        if m.weight < top_weight * rate_limit:
            break
