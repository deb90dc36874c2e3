"""Voting: the maxima search of detection and the hypotheses it builds
(port of point_cloud_donkey_tpu/models/voting.py).

Reference: voting/voting.cpp (the class loop), voting/voting_mean_shift.cpp
(continuous space), voting/voting_hough_3d.cpp (discrete space),
voting/maxima_handler.cpp (post-processing).

Per class of a cloud (Voting::findMaxima, voting.cpp:79-328):
  1. the maxima: mean-shift (seeds -> shift -> density -> average ->
     suppress; ops/mean_shift.py, batched over every (cloud, class) group
     of a detect_batch by :func:`class_mean_shift_batch`), the Hough3D
     accumulator (ops/hough.py) or, in single-object mode with the
     BandwidthVotes / ModelRadiusVotes / VotingSpaceVotes max types, the
     cloud's centroid;
  2. optional RANSAC vote filtering (:func:`filter_votes_with_ransac`,
     host numpy with the JAX package's seeds, so it draws JAX's samples);
  3. per maximum: the sequential vote reweighting and density, the
     instance weights, the weighted box and, with AverageRotation, the
     averaged rotation (ops/geometry.quat_weighted_average).
Then across classes: filtering (None / Simple / Merge), weight
normalisation, the minimum threshold (negative: relative to the best) and
the best-k cut.

The votes come in as numpy arrays (one read of a cloud's cast votes); the
mean-shift, the density reweighting above _REWEIGHT_HOST_LIMIT kernel
evaluations and the Hough accumulation run on `device`; the rest is the
JAX package's host code.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import mean_shift as ms
from ..ops.geometry import quat_weighted_average
from ..ops.hough import hough_accumulate
from .codebook import CastVotes
from .features import bucket_size

# a chunk of mean-shift groups holds [G, S, V] float32 tensors of at most
# this many bytes each (~4 are alive at once in an iteration)
MS_CHUNK_BYTES = 256 << 20
# below this many kernel evaluations, the sequential reweighting runs on
# the host (the JAX package's rule, models/voting.py:220-246)
_REWEIGHT_HOST_LIMIT = 1 << 20


@dataclass
class VotingParams:
    """Voting parameters (voting/voting.cpp:28-50 +
    voting_mean_shift.cpp:22-26), with the JAX package's defaults."""
    min_threshold: float = 0.0
    min_votes_threshold: int = 1
    best_k: int = -1
    average_rotation: bool = False
    radius_type: str = "Config"        # BinOrBandwidthType
    radius_factor: float = 1.0
    max_filter_type: str = "None"
    single_object_max_type: str = "Default"
    single_object_mode: bool = False
    voting_type: str = "MeanShift"     # MeanShift | Hough3D
    # Hough3D (voting_hough_3d.cpp:19-23)
    use_interpolation: bool = True
    min_coord: tuple = (-5.0, -5.0, -5.0)
    rel_threshold: float = 0.8
    bandwidth: float = 0.2
    threshold: float = 1e-3
    max_iter: int = 1000
    kernel: str = "Gaussian"
    maxima_suppression: str = "Average"
    # global feature verification (models/classifier.py)
    use_global_features: bool = False
    global_feature_method: str = "KNN"
    k_global_features: int = 1
    merge_function: int = 3
    min_svm_score: float = 0.70
    rate_limit: float = 0.60
    weight_factor: float = 1.5
    global_min_points: int = 500
    # RANSAC vote filtering
    use_ransac: bool = False
    ransac_inlier_threshold: float = 0.1
    ransac_inlier_threshold_type: str = "Fixed"
    # the most mean-shift seeds of a (cloud, class) group
    seed_capacity: int = 1024


@dataclass
class VotingMaximum:
    """One detection hypothesis (voting/voting_maximum.h:51-88)."""
    class_id: int = 0
    instance_id: int = 0
    position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    weight: float = 0.0
    instance_weight: float = 0.0
    bb_size: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    bb_quat: np.ndarray = field(
        default_factory=lambda: np.array([1, 0, 0, 0], np.float32))
    num_votes: int = 0
    vote_indices: Optional[np.ndarray] = None  # into the class's votes
    # the global classifier's hypothesis (models/classifier.py)
    glob_class_id: int = -1
    glob_class_weight: float = 0.0
    glob_instance_id: int = -1
    glob_instance_weight: float = 0.0


def get_search_dist(class_id: int, params: VotingParams,
                    dims_map: Dict[int, Tuple[float, float]]) -> float:
    """MaximaHandler::getSearchDistForClass (maxima_handler.cpp:509-521)."""
    rt = params.radius_type
    if rt in ("Config", "Fixed"):
        return params.bandwidth
    if rt in ("FirstDim", "ObjectRadius"):
        return dims_map[class_id][0] * params.radius_factor
    if rt in ("SecondDim", "BoundingBoxMedian"):
        return dims_map[class_id][1] * params.radius_factor
    return params.bandwidth


def _pad_rows(a: np.ndarray, cap: int, fill: float = 0.0) -> np.ndarray:
    out = np.full((cap,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


def _mean_shift_chunk(items, params: VotingParams, cap: int, seed_cap: int,
                      device: torch.device):
    """The maxima of a chunk of groups padded to `cap` votes: (positions,
    densities) of each, in descending-density order."""
    dev = torch.device(device)
    v = torch.from_numpy(np.stack([_pad_rows(np.asarray(p, np.float32),
                                             cap, 1e9)
                                   for p, _, _ in items])).to(dev)
    w = torch.from_numpy(np.stack([_pad_rows(np.asarray(x, np.float32), cap)
                                   for _, x, _ in items])).to(dev)
    val = torch.from_numpy(np.stack([np.arange(cap) < len(p)
                                     for p, _, _ in items])).to(dev)
    bw_np = np.asarray([b for _, _, b in items], np.float32)
    bw = torch.from_numpy(bw_np).to(dev)
    seeds, _, seed_mask = ms.create_seeds(v, w, val, ms.seeds_range(bw),
                                          seed_cap)
    centers, alive = ms.mean_shift(seeds, seed_mask, v, w, val, bw,
                                   params.threshold, params.max_iter,
                                   params.kernel, batch_invariant=True)
    dens = ms.estimate_density(centers, v, w, val, bw, params.kernel,
                               batch_invariant=True)
    centers, alive, dens = (x.cpu().numpy() for x in (centers, alive, dens))
    if params.maxima_suppression == "Average":
        avg = [ms.average_neighbor_maxima(c, a, d, float(b))
               for c, a, d, b in zip(centers, alive, dens, bw_np)]
        centers = np.stack([c for c, _ in avg])
        alive = np.stack([o for _, o in avg])
        dens = ms.estimate_density(torch.from_numpy(centers).to(dev), v, w,
                                   val, bw, params.kernel,
                                   batch_invariant=True).cpu().numpy()
    out = []
    for c, a, d, b in zip(centers, alive, dens, bw_np):
        keep = ms.suppress_neighbor_maxima(c, a, d, float(b))
        kept_pos, kept_dens = c[keep], d[keep]
        # the sequential reweighting that follows depends on this order
        # (voting_mean_shift.cpp:158-176)
        order = np.argsort(-kept_dens, kind="stable")
        out.append((kept_pos[order], kept_dens[order]))
    return out


def class_mean_shift_batch(items: Sequence[Tuple[np.ndarray, np.ndarray,
                                                 float]],
                           params: VotingParams, device: torch.device
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Mean-shift maxima (positions [M, 3], densities [M], descending
    density) of many (positions, weights, bandwidth) vote groups -- the
    reference's per-class iFindMaxima (voting.cpp:130) of every (cloud,
    class) of a batch.  Groups are bucketed by their padded vote count
    (the JAX package's buckets, whose seed capacity min(seed_capacity,
    cap) decides which bins seed) and each bucket runs in chunks whose
    [G, S, V] tensors hold at most MS_CHUNK_BYTES.  A group's maxima do
    not depend on the other groups of its chunk (ops/mean_shift.py,
    batch_invariant)."""
    out: List = [None] * len(items)
    buckets: Dict[int, List[int]] = {}
    for idx, (p, _, _) in enumerate(items):
        buckets.setdefault(bucket_size(len(p), minimum=64), []).append(idx)
    for cap, idxs in buckets.items():
        seed_cap = min(params.seed_capacity, cap)
        width = max(1, MS_CHUNK_BYTES // (4 * seed_cap * cap))
        for c0 in range(0, len(idxs), width):
            chunk = idxs[c0:c0 + width]
            res = _mean_shift_chunk([items[j] for j in chunk], params, cap,
                                    seed_cap, device)
            for j, r in zip(chunk, res):
                out[j] = r
    return out


def _class_mean_shift(positions: np.ndarray, weights: np.ndarray,
                      bandwidth: float, params: VotingParams,
                      device: torch.device
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean-shift, averaging and suppression of one class's votes:
    (maxima [M, 3] in descending-density order, densities)."""
    return class_mean_shift_batch([(positions, weights, bandwidth)], params,
                                  device)[0]


def _reweight_host(m_pos: np.ndarray, v_pos: np.ndarray, v_w: np.ndarray,
                   bandwidth: float, kernel: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The sequential estimateDensityAndReweightVotes in host numpy: each
    maximum reweights the votes inside its window in place, so a later
    maximum with an overlapping window sees the updated weights
    (voting_mean_shift.cpp:158-176, 289-328); float32 as
    ops/mean_shift.density_and_reweight."""
    b2 = np.float32(bandwidth) ** 2
    w = v_w.astype(np.float32).copy()
    membership = np.zeros((len(m_pos), len(v_pos)), bool)
    for mi in range(len(m_pos)):
        d2 = np.sum((v_pos.astype(np.float32)
                     - m_pos[mi].astype(np.float32)[None, :]) ** 2,
                    axis=1).astype(np.float32)
        in_r = d2 <= b2
        if kernel == "Gaussian":
            k = np.exp(np.float32(-0.5) * d2 / b2).astype(np.float32)
        else:
            k = np.ones_like(d2)
        w = np.where(in_r, (k * w).astype(np.float32), w)
        membership[mi] = in_r
    return w, membership


def _reweight_device(m_pos: np.ndarray, v_pos: np.ndarray, v_w: np.ndarray,
                     bandwidth: float, kernel: str, device: torch.device
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`_reweight_host` on the device (ops/mean_shift
    .density_and_reweight), for problems past _REWEIGHT_HOST_LIMIT."""
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)[None]).to(
            device=device, dtype=dtype)
    _, final_w, membership = ms.density_and_reweight(
        t(m_pos), torch.ones((1, len(m_pos)), dtype=torch.bool,
                             device=device),
        t(v_pos), t(v_w), torch.ones((1, len(v_pos)), dtype=torch.bool,
                                     device=device),
        float(bandwidth), kernel)
    return final_w[0].cpu().numpy(), membership[0].cpu().numpy()


def find_maxima(votes: CastVotes,           # numpy fields, flat
                cloud_points: np.ndarray,   # [N, 3]
                cloud_mask: np.ndarray,     # [N]
                params: VotingParams,
                dims_map: Dict[int, Tuple[float, float]],
                device: torch.device,
                ms_precomputed: Optional[Dict[int, np.ndarray]] = None
                ) -> List[VotingMaximum]:
    """Voting::findMaxima without the global verification (which the
    orchestrator applies after it).  `ms_precomputed` holds each class's
    mean-shift maxima when :func:`class_mean_shift_batch` has computed
    them across clouds; everything after (RANSAC, reweighting, the
    maxima) is unchanged."""
    valid = np.asarray(votes.valid)
    if not valid.any():
        return []
    pos = np.asarray(votes.position)[valid]
    weight = np.asarray(votes.weight)[valid]
    cls = np.asarray(votes.class_id)[valid]
    inst = np.asarray(votes.instance_id)[valid]
    bsize = np.asarray(votes.bbox_size)[valid]
    bquat = np.asarray(votes.bbox_quat)[valid]
    v_scene_kp = np.asarray(votes.keypoint)[valid]
    v_train_kp = np.asarray(votes.keypoint_training)[valid]

    maxima: List[VotingMaximum] = []
    single = params.single_object_mode
    max_type = params.single_object_max_type
    shifts = (not single) or max_type in ("None", "Default")
    for class_id in sorted(set(cls.tolist())):
        sel = cls == class_id
        v_pos, v_w = pos[sel], weight[sel]
        v_inst, v_bs, v_bq = inst[sel], bsize[sel], bquat[sel]
        bandwidth = get_search_dist(class_id, params, dims_map)

        hough_members = None
        if params.voting_type == "Hough3D":
            if single:
                warnings.warn("SingleObjectMode is not supported with "
                              "Hough3D")
            m_pos, _, hough_members = _class_hough_device(
                v_pos, v_w, bandwidth, params, device)
        elif shifts and ms_precomputed is not None \
                and class_id in ms_precomputed:
            m_pos = ms_precomputed[class_id]
        elif shifts:
            m_pos, _ = _class_mean_shift(v_pos, v_w, bandwidth, params,
                                         device)
        else:
            # single-object mode with a special max type: the centroid
            m = cloud_mask.astype(np.float32)
            centroid = (cloud_points * m[:, None]).sum(0) / max(m.sum(), 1.0)
            if max_type == "ModelRadiusVotes":
                d = np.linalg.norm(cloud_points - centroid, axis=1)
                bandwidth = float(np.max(np.where(cloud_mask, d, 0.0)))
            elif max_type == "VotingSpaceVotes":
                bandwidth = float(np.linalg.norm(
                    v_pos - centroid, axis=1).max()) if len(v_pos) \
                    else bandwidth
            # BandwidthVotes keeps the class's search distance
            m_pos = centroid[None, :].astype(np.float32)

        if len(m_pos) == 0:
            continue

        if params.use_ransac:
            # RANSAC vote filtering (voting.cpp:110-127); the inlier
            # threshold may scale with the trained per-class dimensions
            thr = params.ransac_inlier_threshold
            if params.ransac_inlier_threshold_type == "ObjectRadius":
                thr *= dims_map[class_id][0]
            elif params.ransac_inlier_threshold_type == "BoundingBoxMedian":
                thr *= dims_map[class_id][1]
            if hough_members is not None:
                mem0 = np.zeros((len(m_pos), len(v_pos)), bool)
                for mi, mm in enumerate(hough_members):
                    mem0[mi, mm] = True
            else:
                d_mv = np.linalg.norm(
                    m_pos[:, None, :] - v_pos[None, :, :], axis=2)
                mem0 = d_mv <= bandwidth
            # the JAX package's input-derived seed, so the samples are its
            seed = (len(v_pos) * 1000003 + len(m_pos) * 101
                    + int(class_id) * 7919) & 0x7FFFFFFF
            m_pos, mem_f = filter_votes_with_ransac(
                m_pos, mem0, v_scene_kp[sel], v_train_kp[sel], thr,
                params.min_votes_threshold, seed=seed)
            if hough_members is not None:
                hough_members = [np.nonzero(r)[0] for r in mem_f]

        if hough_members is not None:
            # the clusters and weights come from the accumulator's bins
            # (voting_hough_3d.cpp:72-95): no reweighting
            final_w = v_w
            membership = np.zeros((len(m_pos), len(v_pos)), bool)
            for mi, mem in enumerate(hough_members):
                membership[mi, mem] = True
        elif len(m_pos) * len(v_pos) <= _REWEIGHT_HOST_LIMIT:
            final_w, membership = _reweight_host(m_pos, v_pos, v_w,
                                                 bandwidth, params.kernel)
        else:
            final_w, membership = _reweight_device(
                m_pos, v_pos, v_w, bandwidth, params.kernel, device)

        for mi in range(len(m_pos)):
            members = membership[mi]
            n_votes = int(members.sum())
            if n_votes < max(params.min_votes_threshold, 1):
                continue
            w_members = final_w[members]
            inst_w: Dict[int, float] = {}
            for iid, wv in zip(v_inst[members].tolist(), w_members.tolist()):
                inst_w[iid] = inst_w.get(iid, 0.0) + wv
            best_inst = max(inst_w, key=inst_w.get)
            max_weight = float(w_members.sum())
            bb = (v_bs[members] * w_members[:, None]).sum(0) \
                / max(max_weight, 1e-30)
            m_out = VotingMaximum(
                class_id=int(class_id), instance_id=int(best_inst),
                position=m_pos[mi].astype(np.float32), weight=max_weight,
                instance_weight=float(inst_w[best_inst]),
                bb_size=bb.astype(np.float32), num_votes=n_votes,
                vote_indices=np.nonzero(members)[0],
                glob_class_id=int(class_id), glob_class_weight=max_weight,
                glob_instance_id=int(best_inst),
                glob_instance_weight=float(inst_w[best_inst]))
            if params.average_rotation:
                m_out.bb_quat = quat_weighted_average(
                    v_bq[members], w_members / max(max_weight, 1e-30))
            maxima.append(m_out)
    return maxima


# ---------------------------------------------------------------------------
# cross-class filtering and the final selection (maxima_handler.cpp:272-507)
# ---------------------------------------------------------------------------

def filter_maxima(maxima: List[VotingMaximum], params: VotingParams,
                  dims_map: Dict[int, Tuple[float, float]]
                  ) -> List[VotingMaximum]:
    ft = params.max_filter_type
    if ft == "None" or not maxima:
        return maxima
    if ft == "Simple":
        return _suppress_maxima2(maxima, params.bandwidth)
    if ft == "Merge":
        return _merge_and_filter(maxima, params, dims_map)
    return maxima


def _suppress_maxima2(maxima: List[VotingMaximum], radius: float
                      ) -> List[VotingMaximum]:
    """suppressNeighborMaxima2 (maxima_handler.cpp:228-269): greedy
    weight-ordered cross-class NMS."""
    out = []
    alive = np.ones(len(maxima), bool)
    weights = np.array([m.weight for m in maxima])
    positions = np.stack([m.position for m in maxima])
    while alive.any():
        i = int(np.argmax(np.where(alive, weights, -np.inf)))
        out.append(maxima[i])
        d = np.linalg.norm(positions - positions[i], axis=1)
        alive &= ~(d < radius)
        alive[i] = False
    return out


def _merge_and_filter(maxima: List[VotingMaximum], params: VotingParams,
                      dims_map: Dict[int, Tuple[float, float]]
                      ) -> List[VotingMaximum]:
    """mergeAndFilterMaxima(merge=True) (maxima_handler.cpp:298-383)."""
    dirty = [False] * len(maxima)
    filtered: List[VotingMaximum] = []
    for i, mi in enumerate(maxima):
        if dirty[i]:
            continue
        search_dist = get_search_dist(mi.class_id, params, dims_map)
        close = []
        for j in range(i + 1, len(maxima)):
            if dirty[j]:
                continue
            mj = maxima[j]
            dist = float(np.linalg.norm(mj.position - mi.position))
            other_dist = get_search_dist(mj.class_id, params, dims_map)
            if dist < search_dist and other_dist <= search_dist:
                close.append(mj)
                dirty[j] = True
        if close:
            close.append(mi)
            by_class: Dict[int, List[VotingMaximum]] = {}
            for m in close:
                by_class.setdefault(m.class_id, []).append(m)
            merged = [merge_maxima(group) for group in by_class.values()]
            filtered.append(max(merged, key=lambda m: m.weight))
        else:
            filtered.append(mi)
    return filtered


def merge_maxima(max_list: List[VotingMaximum]) -> VotingMaximum:
    """mergeMaxima (maxima_handler.cpp:386-440): running weight-fused
    position, box and rotation, accumulated instance weights, and the
    merged global hypotheses (:442-507)."""
    result = VotingMaximum()
    inst_w: Dict[int, float] = {}
    glob_hyps = []
    for m in max_list:
        tot = result.weight + m.weight
        result.position = (result.position * result.weight
                           + m.position * m.weight) / max(tot, 1e-30)
        result.bb_size = (result.bb_size * result.weight
                          + m.bb_size * m.weight) / max(tot, 1e-30)
        result.bb_quat = quat_weighted_average(
            np.stack([result.bb_quat, m.bb_quat]),
            np.array([result.weight, m.weight], np.float32))
        result.class_id = m.class_id
        result.weight = tot
        result.num_votes += m.num_votes
        inst_w[m.instance_id] = inst_w.get(m.instance_id, 0.0) \
            + m.instance_weight
        best = max(inst_w, key=inst_w.get)
        result.instance_id = best
        result.instance_weight = inst_w[best]
        glob_hyps.append((m.glob_class_id, m.glob_class_weight,
                          m.glob_instance_id, m.glob_instance_weight))
    cls_w: Dict[int, float] = {}
    for c, wv, _, _ in glob_hyps:
        cls_w[c] = cls_w.get(c, 0.0) + wv
    best_c = max(cls_w, key=cls_w.get)
    iw: Dict[int, float] = {}
    for c, _, iid, iwv in glob_hyps:
        if c == best_c:
            iw[iid] = iw.get(iid, 0.0) + iwv
    result.glob_class_id = best_c
    result.glob_class_weight = cls_w[best_c]
    if iw:
        best_i = max(iw, key=iw.get)
        result.glob_instance_id = best_i
        result.glob_instance_weight = iw[best_i]
    return result


def normalize_weights(maxima: List[VotingMaximum]) -> None:
    """Weights into probabilities (voting.cpp:441-462)."""
    s = sum(m.weight for m in maxima)
    si = sum(m.instance_weight for m in maxima)
    sg = sum(m.glob_class_weight for m in maxima)
    sgi = sum(m.glob_instance_weight for m in maxima)
    for m in maxima:
        m.weight = m.weight / s if s != 0 else 0.0
        m.instance_weight = m.instance_weight / si if si != 0 else 0.0
        m.glob_class_weight = m.glob_class_weight / sg if sg != 0 else 0.0
        m.glob_instance_weight = m.glob_instance_weight / sgi \
            if sgi != 0 else 0.0


def select_maxima(maxima: List[VotingMaximum], params: VotingParams
                  ) -> List[VotingMaximum]:
    """Sort, threshold (negative: relative to the best), best k
    (voting.cpp:272, 297-323)."""
    maxima = sorted(maxima, key=lambda m: -m.weight)
    thresh = params.min_threshold
    if thresh < 0:
        thresh = -thresh * (maxima[0].weight if maxima else 0.0)
    maxima = [m for m in maxima if m.weight >= thresh]
    if params.best_k > 0 and len(maxima) >= params.best_k:
        maxima = maxima[:params.best_k]
    return maxima


# ---------------------------------------------------------------------------
# Hough3D (voting/voting_hough_3d.cpp + PCL HoughSpace3D)
# ---------------------------------------------------------------------------

def _hough_nms(values_keys, rel_threshold: float):
    """Greedy 26-neighbourhood non-maximum suppression over (value, key)
    bins, in descending order (PCL HoughSpace3D::findMaxima)."""
    if not values_keys:
        return []
    thresh = rel_threshold * max(v for v, _ in values_keys)
    candidates = sorted(((v, k) for v, k in values_keys if v >= thresh),
                        reverse=True)
    accepted = []
    suppressed = set()
    for val, key in candidates:
        if key in suppressed:
            continue
        accepted.append((val, key))
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    suppressed.add((key[0] + dx, key[1] + dy, key[2] + dz))
    return accepted


def _class_hough_device(positions: np.ndarray, weights: np.ndarray,
                        bandwidth: float, params: VotingParams,
                        device: torch.device):
    """Discrete Hough voting of one class (voting_hough_3d.cpp:33-95): bin
    edge 2 x the search distance from MinCoord, optional trilinear voting,
    the bins above RelThreshold x the best after 26-neighbourhood NMS, each
    maximum the weighted mean of its bin's voters.  The accumulation runs
    on `device` (ops/hough.py).  Returns (maxima [M, 3], bin values [M],
    per-maximum vote indices)."""
    empty = (np.zeros((0, 3), np.float32), np.zeros(0), [])
    if len(positions) == 0:
        return empty
    grid, key_min, dims, keys, w8 = hough_accumulate(
        torch.from_numpy(np.ascontiguousarray(positions, np.float32)).to(
            device),
        torch.from_numpy(np.ascontiguousarray(weights, np.float32)).to(
            device),
        np.asarray(params.min_coord, np.float32), 2.0 * bandwidth,
        params.use_interpolation)
    _, dy, dz = dims
    occupied = np.nonzero(grid != 0.0)[0]
    if len(occupied) == 0:
        return empty
    kx = occupied // (dy * dz) + key_min[0]
    ky = (occupied // dz) % dy + key_min[1]
    kz = occupied % dz + key_min[2]
    accepted = _hough_nms([(float(grid[f]), (int(x), int(y), int(z)))
                           for f, x, y, z in zip(occupied, kx, ky, kz)],
                          params.rel_threshold)
    if not accepted:
        return empty
    # a vote belongs to a bin it touches through a corner of positive
    # interpolation weight
    local = keys - key_min[None, None, :]
    flat_keys = (local[..., 0] * dy + local[..., 1]) * dz + local[..., 2]
    touch = (w8 > 0) if params.use_interpolation \
        else np.ones_like(w8, bool)
    acc_flat = np.array([((k[0] - key_min[0]) * dy + (k[1] - key_min[1]))
                         * dz + (k[2] - key_min[2]) for _, k in accepted])
    member = ((flat_keys[:, :, None] == acc_flat[None, None, :])
              & touch[:, :, None]).any(axis=1)           # [V, M]
    m_pos, m_dens, members = [], [], []
    for mi, (val, _) in enumerate(accepted):
        ids = np.nonzero(member[:, mi])[0]
        w = weights[ids]
        m_pos.append((positions[ids] * w[:, None]).sum(0)
                     / max(w.sum(), 1e-30))
        m_dens.append(val)
        members.append(ids)
    return np.asarray(m_pos, np.float32), np.asarray(m_dens), members


# ---------------------------------------------------------------------------
# RANSAC vote filtering (voting.cpp:356-433)
# ---------------------------------------------------------------------------

def filter_votes_with_ransac(m_pos: np.ndarray,       # [M, 3]
                             membership: np.ndarray,  # [M, V] bool
                             scene_kp: np.ndarray,    # [V, 3]
                             train_kp: np.ndarray,    # [V, 3]
                             inlier_threshold: float, min_votes: int,
                             iterations: int = 1000, seed: int = 0):
    """Per-cluster rigid-correspondence RANSAC (the analogue of PCL's
    CorrespondenceRejectorSampleConsensus): from seeded triples of the
    cluster's votes, Kabsch transforms of the codewords' training
    keypoints onto the scene keypoints; a cluster with a transform of at
    least 3 inliers keeps its inlier votes, the others go.  Returns (kept
    centres [M', 3], memberships [M', V])."""
    rng = np.random.default_rng(seed)
    kept_pos, kept_members = [], []
    for mi in range(len(m_pos)):
        ids = np.nonzero(membership[mi])[0]
        if len(ids) < max(min_votes, 3):
            continue
        src = train_kp[ids]
        dst = scene_kp[ids]
        n = len(ids)
        s = min(iterations, 1000)
        tri = rng.integers(0, n, size=(s, 3))
        a = src[tri]
        b = dst[tri]
        am = a.mean(axis=1, keepdims=True)
        bm = b.mean(axis=1, keepdims=True)
        h = np.einsum("sij,sik->sjk", a - am, b - bm)
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(np.einsum(
            "sij,sjk->sik", np.transpose(vt, (0, 2, 1)),
            np.transpose(u, (0, 2, 1)))))
        dm = np.zeros((s, 3, 3))
        dm[:, 0, 0] = 1.0
        dm[:, 1, 1] = 1.0
        dm[:, 2, 2] = d
        rot = np.einsum("sij,sjk,skl->sil", np.transpose(vt, (0, 2, 1)), dm,
                        np.transpose(u, (0, 2, 1)))
        t = bm[:, 0, :] - np.einsum("sij,sj->si", rot, am[:, 0, :])
        proj = np.einsum("sij,vj->svi", rot, src) + t[:, None, :]
        err = np.linalg.norm(proj - dst[None], axis=2)
        inliers = err < inlier_threshold
        counts = inliers.sum(axis=1)
        best = int(np.argmax(counts))
        if counts[best] >= 3:
            new_members = np.zeros(membership.shape[1], bool)
            new_members[ids[inliers[best]]] = True
            kept_pos.append(m_pos[mi])
            kept_members.append(new_members)
    if not kept_pos:
        return (np.zeros((0, 3), np.float32),
                np.zeros((0, membership.shape[1]), bool))
    return np.stack(kept_pos), np.stack(kept_members)
