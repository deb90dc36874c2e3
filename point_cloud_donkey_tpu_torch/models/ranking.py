"""Feature ranking, "redundancy-free codebooks" (port of
point_cloud_donkey_tpu/models/ranking.py, feature_ranking/).

Every training feature is scored, each class's features are sorted by
score (ascending, stable) and the window [offset, offset + factor) of that
list is kept (extractSubsetFromRankedList, feature_ranking.cpp:160-202;
ExtractFromList front / center / back is offset 0 / (1 - factor) / 2 /
1 - factor, feature_ranking.cpp:135-147).

Every ranker measures with the chi-square distance whatever DistanceType
says (the reference hardcodes flann::ChiSquareDistance): its k-NN is
``ops/neighbors.knn`` under "chisq" on the device the caller names -- K4
for k <= 3, K4m's [Q, C] matrix and a stable selection above.  The search
is always exact: FLANNExactMatch false selected the TPU's feature-map
approximation in the JAX package, which the port leaves out.  The scores
are then accumulated on the host in the JAX package's order.

Types: Uniform (keeps all), NaiveBayes, Incremental, KNNActivation
(increment types 0-3, UseFeaturePosition), Strangeness and Similarity --
see each scorer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.neighbors import knn
from ..utils.config import ComponentConfig


@dataclass
class RankingParams:
    type: str = "Uniform"
    k_search: int = 10
    dist_thresh: float = 0.1
    factor: float = 0.75
    extract_list: str = "invalid"
    extract_offset: float = 0.0
    use_feature_position: bool = False
    score_increment_type: int = 0
    similarity_update_type: str = "score"
    intra_pos: str = "center"
    inter_pos: str = "front"

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "RankingParams":
        return cls(
            type=cfg.type or "Uniform",
            k_search=cfg.get("KSearch", 10),
            dist_thresh=cfg.get("DistanceThreshold", 0.1),
            factor=cfg.get("Factor", 0.75),
            extract_list=cfg.get("ExtractFromList", "invalid"),
            extract_offset=cfg.get("ExtractOffset", 0.0),
            use_feature_position=cfg.get("UseFeaturePosition", False),
            score_increment_type=cfg.get("ScoreIncrementType", 0),
            similarity_update_type=cfg.get("UpdateType", "score"),
            intra_pos=cfg.get("IntraPosition", "center"),
            inter_pos=cfg.get("InterPosition", "front"),
        )

    def resolved_offset(self) -> float:
        if self.extract_list != "invalid":
            if self.extract_list == "front":
                return 0.0
            if self.extract_list in ("center", "middle"):
                return 0.5 * (1.0 - self.factor)
            if self.extract_list == "back":
                return 1.0 - self.factor
        return self.extract_offset


def _knn_chi(queries: np.ndarray, db: np.ndarray, k: int,
             device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """(distances [Q, k] ascending, indices [Q, k]) of each query's k
    nearest database rows under the chi-square distance, k capped at the
    database size."""
    k = min(k, db.shape[0])
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    b = torch.from_numpy(np.ascontiguousarray(db, np.float32)).to(device)
    d, idx = knn(q, b, torch.ones(b.shape[0], dtype=torch.bool,
                                  device=device), k=k, metric="chisq")
    return d.cpu().numpy(), idx.cpu().numpy()


def rank_features(descriptors: np.ndarray,   # [F, D] all training features
                  class_ids: np.ndarray,     # [F]
                  center_dists: np.ndarray,  # [F] keypoint-to-centroid
                  params: RankingParams,
                  device: torch.device = torch.device("cpu")) -> np.ndarray:
    """Keep mask [F]: each class's ranked window [offset, offset + factor)
    under the configured scorer."""
    f = descriptors.shape[0]
    if params.type == "Uniform" or f == 0:
        return np.ones(f, bool)
    scores = _compute_scores(descriptors, class_ids, center_dists, params,
                             device)
    keep = np.zeros(f, bool)
    offset = params.resolved_offset()
    for cid in np.unique(class_ids):
        sel = np.nonzero(class_ids == cid)[0]
        order = sel[np.argsort(scores[sel], kind="stable")]   # ascending
        n = len(order)
        lo = max(0.0, n * offset)
        hi = min(float(n), n * (params.factor + offset))
        for j, fi in enumerate(order):
            if lo <= j < hi:
                keep[fi] = True
    return keep


def _compute_scores(desc, cls, cdist, params, device) -> np.ndarray:
    t = params.type
    if t == "NaiveBayes":
        return _naive_bayes(desc, cls, params, device)
    if t == "Incremental":
        return _incremental(desc, params, device)
    if t == "KNNActivation":
        return _knn_activation(desc, cdist, params, device)
    if t == "Strangeness":
        return _strangeness(desc, cls, params, device)
    if t == "Similarity":
        return _similarity(desc, cls, params, device)
    raise ValueError(f"unknown ranking type {t!r}")


def _naive_bayes(desc, cls, params, device) -> np.ndarray:
    """P(similar | class) / P(similar), "similar" = among the k nearest and
    within DistanceThreshold (ranking_naive_bayes.cpp)."""
    scores = np.zeros(len(desc), np.float32)
    for cid in np.unique(cls):
        own = np.nonzero(cls == cid)[0]
        other = np.nonzero(cls != cid)[0]
        if len(other) == 0:
            scores[own] = 1.0
            continue
        d_own, _ = _knn_chi(desc[own], desc[own], params.k_search, device)
        d_oth, _ = _knn_chi(desc[own], desc[other], params.k_search, device)
        num_pos = (d_own < params.dist_thresh).sum(axis=1).astype(np.float32)
        num_neg = (d_oth < params.dist_thresh).sum(axis=1).astype(np.float32)
        n_cur, n_oth = float(len(own)), float(len(other))
        pos_prob = num_pos / n_cur
        denom = (num_pos + num_neg) / (n_cur + n_oth)
        scores[own] = np.where(denom > 0,
                               pos_prob / np.maximum(denom, 1e-30), 0.0)
    return scores


def _incremental(desc, params, device) -> np.ndarray:
    """Each query's k nearest accumulate d_j - d_{j+1} on the neighbour's
    score, d_{k+1} the background distance (ranking_incremental.cpp)."""
    scores = np.zeros(len(desc), np.float32)
    d, idx = _knn_chi(desc, desc, params.k_search + 1, device)
    for q in range(len(desc)):
        for j in range(d.shape[1] - 1):
            scores[idx[q, j]] += d[q, j] - d[q, j + 1]
    return scores


def _knn_activation(desc, cdist, params, device) -> np.ndarray:
    """Neighbours accumulate activations: 1, 1 / (d + 1) or exp(d)
    (increment types 1-3; 0 and others are 1), scaled by exp(|centre
    distance difference|) under UseFeaturePosition
    (ranking_knn_activation.cpp:75-105)."""
    scores = np.zeros(len(desc), np.float32)
    inc_type = params.score_increment_type
    if inc_type == 0 or inc_type > 3 or inc_type < 1:
        inc_type = 1
    d, idx = _knn_chi(desc, desc, params.k_search + 1, device)
    for q in range(len(desc)):
        for j in range(idx.shape[1] - 1):
            fi = idx[q, j]
            rate = np.exp(abs(cdist[fi] - cdist[q])) \
                if params.use_feature_position else 1.0
            if inc_type == 1:
                scores[fi] += rate
            elif inc_type == 2:
                scores[fi] += rate / (d[q, j] + 1.0)
            else:
                scores[fi] += rate * np.exp(d[q, j])
    return scores


def _strangeness(desc, cls, params, device) -> np.ndarray:
    """The sum of the k nearest distances within the own class over the
    smallest such sum among the other classes (ranking_strangeness.cpp)."""
    scores = np.zeros(len(desc), np.float32)
    classes = np.unique(cls)
    sums = np.zeros((len(desc), len(classes)), np.float32)
    for ci, cid in enumerate(classes):
        members = np.nonzero(cls == cid)[0]
        d, _ = _knn_chi(desc, desc[members], params.k_search, device)
        sums[:, ci] = d.sum(axis=1)
    for q in range(len(desc)):
        own_ci = int(np.nonzero(classes == cls[q])[0][0])
        own = sums[q, own_ci]
        others = np.delete(sums[q], own_ci)
        best_other = np.sort(others)[0] if len(others) else 1.0
        scores[q] = own / max(best_other, 1e-30)
    return scores


def _sigmoid_score(distance: np.ndarray) -> np.ndarray:
    """2 * (1/(1+exp(-d)) - 0.5) (ranking_similarity.cpp:303-310)."""
    return 2.0 * (1.0 / (1.0 + np.exp(-distance)) - 0.5)


def _similarity(desc, cls, params, device) -> np.ndarray:
    """Intra-class penalties from the k nearest of the own class and
    inter-class ones from the 100 nearest of the others, each normalised
    per class and moved to its IntraPosition / InterPosition, summed
    (ranking_similarity.cpp)."""
    n = len(desc)
    intra = np.zeros(n, np.float32)
    inter = np.zeros(n, np.float32)
    ut = params.similarity_update_type

    def update_value(dist):
        if ut == "count":
            return np.ones_like(dist)
        if ut == "dist":
            return -dist
        return -_sigmoid_score(dist)

    for cid in np.unique(cls):
        own = np.nonzero(cls == cid)[0]
        other = np.nonzero(cls != cid)[0]
        d_own, i_own = _knn_chi(desc[own], desc[own], params.k_search,
                                device)
        np.add.at(intra, own[i_own.reshape(-1)],
                  update_value(d_own).reshape(-1))
        if len(other):
            d_oth, i_oth = _knn_chi(desc[own], desc[other],
                                    min(100, len(other)), device)
            np.add.at(inter, other[i_oth.reshape(-1)],
                      update_value(d_oth).reshape(-1))

    def transform(arr, pos):
        out = arr.copy()
        for cid in np.unique(cls):
            sel = np.nonzero(cls == cid)[0]
            vals = out[sel]
            if ut in ("score", "dist"):
                mn = vals.min()
                vals = np.where(vals == 0, mn * 1.1, vals)
            mn, mx = vals.min(), vals.max()
            rng_lo = abs(mx) + abs(mn) if mn < 0 else abs(mx) - abs(mn)
            rng_lo = rng_lo if rng_lo != 0 else 1.0
            if mn < 0:
                vals = (vals + abs(mn)) / rng_lo
            else:
                vals = (vals - abs(mn)) / rng_lo
            if pos == "back":
                vals = np.abs(vals - 1.0)
            elif pos == "center":
                median = np.sort(vals)[len(vals) // 2]
                vals = np.abs(vals - median)
            out[sel] = vals
        return out

    return transform(intra, params.intra_pos) \
        + transform(inter, params.inter_pos)
