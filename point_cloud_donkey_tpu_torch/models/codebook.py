"""Codebook training and serving (port of point_cloud_donkey_tpu/models/
codebook.py, every activation strategy: KNN, KNNRule, INN and Threshold,
and partial SHOT matching).

Training (codebook.cpp:64-365): every training feature activates its
codewords (KNN: its k nearest, the self-kNN through K4 -- K4m for k > 3 --
when the codewords are the features; KNNRule: the nearest; INN: the
nearest of its refined query; Threshold: its 64 nearest within the
threshold), each activation records a vote (the object centre seen from
the feature's LRF), KNN k=1 and INN keep the codewords with exactly one
vote, and the votes get their centre weights and statistical class
weights.  The host
half is the JAX package's numpy code, so the same activations give the
same arrays; the kNN and the class-sigma distance sums run in torch on the
device of the descriptors.

Serving: a trained codebook is saved as the ``cb_*`` arrays of
``<model>.ismd.npz`` (models/ism.py save); the :class:`Codebook` module
holds them as registered buffers, so ``.to(device)`` moves them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.geometry import (BoundingBox, matrix_to_quat,
                            matrix_to_quat_batch_np, quat_multiply,
                            quat_multiply_np)
from ..ops.neighbors import (chi_square_distance_matrix, full_fp32, knn,
                             pairwise_sqdist)
from ..utils.config import ComponentConfig
from .types import FeatureSet

CODEBOOK_FIELDS = ("codewords", "cw_mask", "cw_weight", "cw_position",
                   "votes", "vote_mask", "vote_class", "vote_instance",
                   "vote_weight", "class_weight", "bbox_size", "bbox_quat",
                   "class_sigma")
_INT_FIELDS = ("vote_class", "vote_instance")
_BOOL_FIELDS = ("cw_mask", "vote_mask")


class Codebook(nn.Module):
    """The TrainedCodebook arrays as buffers: codewords [C, D], cw_mask [C],
    cw_weight [C], cw_position [C, 3], votes [C, MV, 3], vote_mask /
    vote_class / vote_instance / vote_weight / class_weight [C, MV],
    bbox_size [C, MV, 3], bbox_quat [C, MV, 4], class_sigma [classes]
    (a variance)."""

    def __init__(self, **arrays: torch.Tensor):
        super().__init__()
        missing = set(CODEBOOK_FIELDS) - set(arrays)
        if missing:
            raise ValueError(f"codebook arrays missing: {sorted(missing)}")
        for name in CODEBOOK_FIELDS:
            self.register_buffer(name, arrays[name])
        self._partial: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def partial(self, partial_type: str, dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(column index [D'], partial codewords [C, D']) of a partial-SHOT
        type at descriptor width `dim`, on the codewords' device; built
        once per (type, width, device)."""
        key = (partial_type, dim, self.codewords.device)
        if key not in self._partial:
            cols = torch.from_numpy(partial_shot_columns(
                signature_mask(partial_type), dim)).to(self.codewords.device)
            self._partial[key] = (
                cols, self.codewords.index_select(1, cols).contiguous())
        return self._partial[key]

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray]) -> "Codebook":
        """From a TrainedCodebook's ``_asdict()`` or the ``cb_*`` entries of
        a saved ``.ismd.npz`` (other entries are ignored)."""
        if any(k.startswith("cb_") for k in arrays):
            arrays = {k[3:]: v for k, v in arrays.items()
                      if k.startswith("cb_")}
        out = {}
        for name in CODEBOOK_FIELDS:
            a = np.asarray(arrays[name])
            if name in _INT_FIELDS:
                out[name] = torch.from_numpy(a.astype(np.int64))
            elif name in _BOOL_FIELDS:
                out[name] = torch.from_numpy(a.astype(bool))
            else:
                out[name] = torch.from_numpy(a.astype(np.float32))
        return cls(**out)

    @property
    def num_classes(self) -> int:
        return int(self.class_sigma.shape[0])


def load_codebook(path: str) -> Codebook:
    """Codebook of a saved model: ``model.ism`` (reads ``model.ismd.npz``)
    or the ``.npz`` itself."""
    data = path if path.endswith(".npz") else path + "d.npz"
    if not os.path.exists(data):
        raise FileNotFoundError(f"no trained codebook at {data}")
    with np.load(data, allow_pickle=False) as z:
        return Codebook.from_numpy({k: z[k] for k in z.files})


@dataclass
class CodebookParams:
    """Codebook + ActivationStrategy parameters (codebook.cpp:32-41,
    activation_strategy*.h), with the JAX package's defaults."""
    use_class_weight: bool = False
    use_vote_weight: bool = False
    use_matching_weight: bool = False
    use_codeword_weight: bool = False
    activation_type: str = "KNN"
    knn_k: int = 1
    use_distance_ratio: bool = False
    distance_ratio_threshold: float = 0.8
    threshold: float = 1.0         # ActivationStrategyThreshold distance
    threshold_capacity: int = 64   # cap on the within-threshold activations
    inn_iterations: int = 5        # ActivationStrategyINN
    inn_residual_weight: float = 0.01
    # partial SHOT/CSHOT matching at detection (codebook.cpp:37-38,
    # :416-475, :952-1036); training ignores it, as the JAX package does
    use_partial_shot: bool = False
    partial_shot_type: str = "front"

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "CodebookParams":
        """From the ``Codebook`` child of an ``.ism`` config (the JAX
        ``models/ism._codebook_params``)."""
        act = cfg.child("ActivationStrategy")
        return cls(
            use_class_weight=cfg.get("UseClassWeight", False),
            use_vote_weight=cfg.get("UseVoteWeight", False),
            use_matching_weight=cfg.get("UseMatchingWeight", False),
            use_codeword_weight=cfg.get("UseCodewordWeight", False),
            activation_type=act.type or "KNN",
            knn_k=act.get("K", 1),
            use_distance_ratio=act.get("UseDistanceRatio", False),
            distance_ratio_threshold=act.get("DistanceRatioThreshold", 0.8),
            threshold=act.get("Threshold", 1.0),
            threshold_capacity=act.get("TpuThresholdCapacity", 64),
            inn_iterations=act.get("Iterations", 5),
            inn_residual_weight=act.get("ResidualWeight", 0.01),
            use_partial_shot=cfg.get("UsePartialShot", False),
            partial_shot_type=cfg.get("PartialShotType", "front"))


class CastVotes(NamedTuple):
    """Flat vote tensor, leading axis T = F * k * MV."""
    position: torch.Tensor    # [T, 3] voted object center
    weight: torch.Tensor      # [T]
    class_id: torch.Tensor    # [T]
    instance_id: torch.Tensor  # [T]
    keypoint: torch.Tensor    # [T, 3] scene keypoint that cast the vote
    keypoint_training: torch.Tensor  # [T, 3] codeword's training position
    bbox_size: torch.Tensor   # [T, 3]
    bbox_quat: torch.Tensor   # [T, 4]
    valid: torch.Tensor       # [T]


def signature_mask(partial_type: str) -> np.ndarray:
    """[32] bool mask over SHOT signature bins (Codebook::getSignatureMask,
    codebook.cpp:952-1036).  Unknown types keep the complete descriptor."""
    m = np.zeros(32, bool)
    t = partial_type
    if t in ("front", "dense_x"):
        m[8:24] = True
    elif t in ("back", "sparse_x"):
        m[0:8] = True
        m[24:32] = True
    elif t in ("left", "positive_y"):
        m[16:32] = True
    elif t in ("right", "negative_y"):
        m[0:16] = True
    elif t in ("top", "dense_z"):
        m[1::2] = True
    elif t in ("bottom", "sparse_z"):
        m[0::2] = True
    elif t == "dense_x_or_z":
        m[8:24] = True
        m[1::2] = True
    elif t == "dense_x_and_z":
        m[9:24:2] = True
    elif t == "front_turn_left":
        m[12:28] = True
    elif t == "front_turn_right":
        m[4:20] = True
    else:
        return np.ones(32, bool)
    return m


def partial_shot_columns(mask: np.ndarray, dim: int) -> np.ndarray:
    """Descriptor column indices kept by the signature mask: SHOT-352 has 32
    signature bins x 11; CSHOT-1344 appends 32 x 31 color bins
    (codebook.cpp:418-422, :438-470)."""
    cols = [np.arange(s * 11, (s + 1) * 11) for s in range(32) if mask[s]]
    if dim > 352:
        cols += [352 + np.arange(s * 31, (s + 1) * 31)
                 for s in range(32) if mask[s]]
    return np.concatenate(cols)


def inn_refine_queries(descriptors: torch.Tensor,  # [F, D]
                       codewords: torch.Tensor,    # [C, D]
                       cw_mask: torch.Tensor,      # [C]
                       metric: str, iterations: int,
                       residual_weight: float) -> torch.Tensor:
    """INN activation's query refinement (activation_strategy_inn.h:37-75):
    `iterations` rounds of the 1-NN, each pushing the query away from its
    projection onto that neighbour, q + w (q - <nb, q> nb).  The dot
    product is elementwise (no matmul, so no TF32 question); the refined
    queries can hold negative entries, whose chi-square terms with a + b
    <= 0 count 0."""
    q = descriptors
    for _ in range(iterations):
        _, idx = knn(q, codewords, cw_mask, 1, metric)
        nb = codewords[idx[:, 0]]
        factor = torch.sum(nb * q, dim=1, keepdim=True)
        q = q + residual_weight * (q - factor * nb)
    return q


def cast_votes(cb: Codebook,
               descriptors: torch.Tensor,  # [F, D]
               positions: torch.Tensor,    # [F, 3]
               frames: torch.Tensor,       # [F, 3, 3] rows = LRF axes
               f_mask: torch.Tensor,       # [F]
               params: CodebookParams,
               metric: str) -> CastVotes:
    """Codebook::castVotes + CodewordDistribution::castVotes: each feature
    activates codewords by the activation strategy -- KNN (any K, with the
    distance ratio at K = 1), KNNRule's 3-NN class rule, Threshold (the
    min(capacity, C) nearest, kept below the threshold) or INN (the 1-NN of
    the refined query); any other name is KNN, as in the JAX package --
    after partial SHOT has cut descriptors and codewords to the masked
    signature bins (D in (352, 1344) only).  The activated codewords'
    votes are rotated back into the scene frame, with the 2-sigma gate and
    the epsilon weight cut."""
    cw, cw_mask = cb.codewords, cb.cw_mask
    dim = descriptors.shape[1]
    if params.use_partial_shot and dim in (352, 1344) \
            and not signature_mask(params.partial_shot_type).all():
        cols, cw = cb.partial(params.partial_shot_type, dim)
        descriptors = descriptors.index_select(1, cols)
    n_feat = descriptors.shape[0]
    strategy = params.activation_type
    if strategy == "KNNRule":
        # the detection-time 3-NN class rule
        # (activation_strategy_knn_rule.h:60-115)
        dists3, idx3 = knn(descriptors, cw, cw_mask, min(3, cw.shape[0]),
                           metric)
        vc = cb.vote_class[idx3, 0]            # class of each neighbour
        c0, c1, c2 = vc[:, 0], vc[:, 1], vc[:, 2]
        rt = params.distance_ratio_threshold
        r02 = dists3[:, 0] / torch.clamp(dists3[:, 2], min=1e-30)
        r01 = dists3[:, 0] / torch.clamp(dists3[:, 1], min=1e-30)
        all_same = (c0 == c1) & (c0 == c2)
        first_two = (c0 == c1) & (c0 != c2)
        last_two = (c0 != c1) & (c1 == c2)
        none_same = (c0 != c1) & (c1 != c2)
        accept_first = all_same | (first_two & (r02 < rt)) \
            | (none_same & (r01 < rt))
        accept_second = last_two & (r01 >= rt)
        sel = accept_second.long()[:, None]
        idx = torch.gather(idx3, 1, sel)
        dists = torch.gather(dists3, 1, sel)
        keep = (accept_first | accept_second)[:, None]
        k = 1
    elif strategy == "Threshold":
        # every codeword within the threshold, capped
        # (activation_strategy_threshold.cpp:27-44)
        k = min(params.threshold_capacity, cw.shape[0])
        dists, idx = knn(descriptors, cw, cw_mask, k, metric)
        keep = dists < params.threshold
    elif strategy == "INN":
        q = inn_refine_queries(descriptors, cw, cw_mask, metric,
                               params.inn_iterations,
                               params.inn_residual_weight)
        dists, idx = knn(q, cw, cw_mask, 1, metric)
        keep = torch.ones((n_feat, 1), dtype=torch.bool,
                          device=descriptors.device)
        k = 1
    else:  # KNN
        k = params.knn_k
        search_k = k + 1 if (params.use_distance_ratio and k == 1) else k
        dists, idx = knn(descriptors, cw, cw_mask,
                         min(search_k, cw.shape[0]), metric)
        keep = torch.ones((n_feat, k), dtype=torch.bool,
                          device=descriptors.device)
        if params.use_distance_ratio and k == 1 and dists.shape[1] >= 2:
            ratio_bad = dists[:, 0] / torch.clamp(dists[:, 1], min=1e-30) \
                > params.distance_ratio_threshold
            keep = (~ratio_bad)[:, None]
        dists, idx = dists[:, :k], idx[:, :k]
    keep = keep & f_mask[:, None]

    votes = cb.votes[idx]                   # [F, k, MV, 3]
    v_class = cb.vote_class[idx]            # [F, k, MV]
    sigma = cb.class_sigma[v_class]         # variance
    dist = dists[:, :, None]                # [F, k, 1]
    matching_w = (1.0 / torch.sqrt(2.0 * math.pi * sigma)) * torch.exp(
        -(dist ** 2) / (2.0 * sigma))

    weight = torch.ones_like(sigma)
    if params.use_class_weight:
        weight = weight * cb.class_weight[idx]
    if params.use_vote_weight:
        weight = weight * cb.vote_weight[idx]
    if params.use_matching_weight:
        weight = weight * matching_w
    if params.use_codeword_weight:
        weight = weight * cb.cw_weight[idx][:, :, None]

    # the 2-sigma gate (codeword_distribution.cpp:131-135) and epsilon cut
    gate = torch.abs(dist) <= 2.0 * sigma
    eps = torch.finfo(torch.float32).eps
    valid = cb.vote_mask[idx] & keep[:, :, None] & gate & (weight >= eps)

    # vote position: keypoint + frames^T @ vote, written out elementwise
    # (no matmul, so no TF32 question)
    back = (frames[:, None, None, :, :] * votes[..., :, None]).sum(-2)
    center = positions[:, None, None, :] + back

    frame_quat = matrix_to_quat(frames)                     # [F, 4]
    out_quat = quat_multiply(cb.bbox_quat[idx], frame_quat[:, None, None, :])

    f, mv = n_feat, votes.shape[2]
    t = f * k * mv

    def flat(x):
        return x.reshape((t,) + tuple(x.shape[3:]))

    return CastVotes(
        position=flat(center),
        weight=flat(weight),
        class_id=flat(v_class),
        instance_id=flat(cb.vote_instance[idx]),
        keypoint=flat(positions[:, None, None, :].expand(f, k, mv, 3)),
        keypoint_training=flat(cb.cw_position[idx][:, :, None, :].expand(
            f, k, mv, 3)),
        bbox_size=flat(cb.bbox_size[idx]),
        bbox_quat=flat(out_quat),
        valid=flat(valid),
    )


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class TrainedCodebook(NamedTuple):
    """The trained codebook arrays (numpy; saved as ``cb_*``)."""
    codewords: np.ndarray        # [C, D]
    cw_mask: np.ndarray          # [C]
    cw_weight: np.ndarray        # [C] (1.0, as in the reference)
    cw_position: np.ndarray      # [C, 3] feature position of each codeword
    votes: np.ndarray            # [C, MV, 3] vote vectors in LRF coordinates
    vote_mask: np.ndarray        # [C, MV]
    vote_class: np.ndarray       # [C, MV] int32
    vote_instance: np.ndarray    # [C, MV] int32
    vote_weight: np.ndarray      # [C, MV] centre weight (median gaussian)
    class_weight: np.ndarray     # [C, MV] statistical class weight
    bbox_size: np.ndarray        # [C, MV, 3]
    bbox_quat: np.ndarray        # [C, MV, 4] composed with conj(frame)
    class_sigma: np.ndarray      # [classes] variance of the activation dists

    @property
    def num_codewords(self) -> int:
        return int(self.cw_mask.sum())


def activate_knn(queries: torch.Tensor,    # [F, D]
                 codewords: torch.Tensor,  # [C, D]
                 k: int, metric: str) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN activation of the training features (the JAX
    ``activate_knn_batch``): (dists [F, k], idx [F, k]) as numpy, ties to
    the lower index; with C <= k every feature activates every codeword at
    distance 0."""
    c = codewords.shape[0]
    f = queries.shape[0]
    if c <= k:
        return (np.zeros((f, c), np.float32),
                np.tile(np.arange(c), (f, 1)))
    mask = torch.ones(c, dtype=torch.bool, device=codewords.device)
    with full_fp32():
        d, i = knn(queries.contiguous(), codewords.contiguous(), mask, k,
                   metric)
    return d.cpu().numpy(), i.cpu().numpy()


def training_activation(queries: torch.Tensor,    # [F, D]
                        codewords: torch.Tensor,  # [C, D]
                        params: CodebookParams, metric: str
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The training activation (codebook.cpp:109-142, the JAX
    ``training_activation``) as numpy (dists, idx): KNN takes its K
    nearest; KNNRule trains like KNN k=1 (activation_strategy_knn_rule.h);
    INN refines the queries, then takes the 1-NN; Threshold takes the
    min(capacity, C) nearest with index -1 at or beyond the threshold."""
    t = params.activation_type
    if t == "KNN":
        return activate_knn(queries, codewords, params.knn_k, metric)
    if t == "KNNRule":
        return activate_knn(queries, codewords, 1, metric)
    if t == "INN":
        mask = torch.ones(codewords.shape[0], dtype=torch.bool,
                          device=codewords.device)
        q, c = queries.contiguous(), codewords.contiguous()
        with full_fp32():
            q = inn_refine_queries(q, c, mask, metric, params.inn_iterations,
                                   params.inn_residual_weight)
            d, i = knn(q, c, mask, 1, metric)
        return d.cpu().numpy(), i.cpu().numpy()
    if t == "Threshold":
        cap = min(params.threshold_capacity, codewords.shape[0])
        d, idx = activate_knn(queries, codewords, cap, metric)
        return d, np.where(d < params.threshold, idx, -1)
    raise ValueError(f"unknown activation strategy {t!r}")


def _pair_distance_sums(a: torch.Tensor, b: torch.Tensor, metric: str
                        ) -> torch.Tensor:
    """[sum, sum of squares] of the [A, B] distance matrix (exact
    chi-square or squared l2), f32, on a's device."""
    with full_fp32():
        dm = (chi_square_distance_matrix(a, b) if metric == "chisq"
              else pairwise_sqdist(a, b))
    return torch.stack([dm.sum(), (dm * dm).sum()])


def train_codebook(
        features_per_model: List[FeatureSet],   # compacted per model
        class_per_model: List[int],
        instance_per_model: List[int],
        boxes_per_model: List[BoundingBox],
        codeword_data: np.ndarray,              # [C, D] cluster centres
        codeword_positions: np.ndarray,         # [C, 3]
        params: CodebookParams,
        metric: str,
        descriptor_rows: torch.Tensor,          # [F, D] on the device
        ) -> TrainedCodebook:
    """Codebook training (the JAX ``train_codebook``, codebook.cpp:64-365):
    one activation of every model's features (:func:`training_activation`),
    vote recording per class (Threshold's -1 entries record none), the
    class sigma from sampled feature x codeword distances, the KNN k=1 and
    INN clean-up, centre weights and statistical class weights.  Partial
    SHOT is a detection option; training ignores it, as the JAX package
    does.
    `descriptor_rows` are every model's descriptors, concatenated in model
    order, as the extraction left them on the device. Under Clustering
    None they are also the codewords, so the activation is their
    self-kNN."""
    num_models = len(features_per_model)
    assert num_models == len(class_per_model) == len(boxes_per_model)
    classes = sorted(set(class_per_model))
    class_sigmas: Dict[int, float] = {}
    sigma_pending: Dict[int, Tuple[torch.Tensor, int]] = {}
    device = descriptor_rows.device

    # step 0: one activation over every model's features
    sizes = [fs.descriptors.shape[0] for fs in features_per_model]
    assert tuple(descriptor_rows.shape) == codeword_data.shape == \
        (sum(sizes), codeword_data.shape[1]), \
        (tuple(descriptor_rows.shape), codeword_data.shape, sum(sizes))
    act_nonzero = [i for i, s in enumerate(sizes) if s]
    act_per_model: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if act_nonzero:
        all_d, all_i = training_activation(descriptor_rows, descriptor_rows,
                                           params, metric)
        off = 0
        for i in act_nonzero:
            act_per_model[i] = (all_d[off:off + sizes[i]],
                                all_i[off:off + sizes[i]])
            off += sizes[i]

    # step 1: vote recording, per class
    rec = {name: [] for name in ("cw", "vote", "class", "inst", "pos",
                                 "frame", "center", "bsize", "bquat")}
    for class_id in classes:
        model_idx = [i for i, c in enumerate(class_per_model)
                     if c == class_id]
        num_features = sum(int(features_per_model[i].mask.sum())
                           for i in model_idx)
        max_elements = int(math.isqrt(max(num_features, 0)))
        sample_feature_descs: List[np.ndarray] = []
        sample_cw_descs: List[np.ndarray] = []
        n_feat_acc = 0
        n_cw_acc = 0
        for mi in model_idx:
            fs = features_per_model[mi]
            box = boxes_per_model[mi]
            n = fs.descriptors.shape[0]
            if n == 0:
                continue
            _, idx = act_per_model[mi]
            center = np.asarray(box.position, np.float32)
            box_quat = np.asarray(box.quat, np.float32)
            # vote = (centre - keypoint) rotated into the LRF; bbox quat
            # composed with conj(frame) (codeword_distribution.cpp:37-71)
            frames = np.asarray(fs.frames, np.float32)
            frame_quats = matrix_to_quat_batch_np(frames)
            vote_world = center[None, :] - np.asarray(fs.positions,
                                                      np.float32)
            vote_local = np.einsum("jab,jb->ja", frames, vote_world)
            conj = frame_quats * np.array([1, -1, -1, -1], np.float32)
            new_quat = quat_multiply_np(box_quat[None, :], conj)

            jj, kk = np.nonzero(idx >= 0)   # Threshold: -1 beyond the cut
            rec["cw"].append(idx[jj, kk].astype(np.int64))
            rec["vote"].append(vote_local[jj].astype(np.float32))
            rec["class"].append(np.full(len(jj), class_id, np.int32))
            rec["inst"].append(np.full(len(jj), instance_per_model[mi],
                                       np.int32))
            rec["pos"].append(np.asarray(fs.positions, np.float32)[jj])
            rec["frame"].append(frames[jj])
            rec["center"].append(np.tile(center, (len(jj), 1)))
            rec["bsize"].append(np.tile(np.asarray(box.size, np.float32),
                                        (len(jj), 1)))
            rec["bquat"].append(new_quat[jj].astype(np.float32))

            # capped samples for the class sigma
            if n_feat_acc < max_elements:
                sample_feature_descs.append(np.asarray(fs.descriptors))
                n_feat_acc += n
            if n_cw_acc < max_elements:
                flat_idx = idx.reshape(-1)
                sample_cw_descs.append(codeword_data[flat_idx[flat_idx >= 0]])
                n_cw_acc += idx.size

        if sample_feature_descs and sample_cw_descs:
            fd = np.concatenate(sample_feature_descs, axis=0)
            cd = np.concatenate(sample_cw_descs, axis=0)
            sigma_pending[class_id] = (_pair_distance_sums(
                torch.from_numpy(np.ascontiguousarray(fd, np.float32)).to(
                    device),
                torch.from_numpy(np.ascontiguousarray(cd, np.float32)).to(
                    device), metric), len(fd) * len(cd))
        else:
            class_sigmas[class_id] = 1.0

    if sigma_pending:
        # one host read for every class's (sum, sum of squares)
        cids = list(sigma_pending)
        sums = torch.stack([sigma_pending[c][0] for c in cids]).cpu().numpy()
        for c, (s, ss) in zip(cids, sums):
            n = sigma_pending[c][1]
            mean = float(s) / n
            var = (float(ss) - n * mean * mean) / max(n - 1, 1)
            class_sigmas[c] = max(var, 0.0)

    empty = {"cw": np.zeros(0, np.int64), "vote": np.zeros((0, 3), np.float32),
             "class": np.zeros(0, np.int32), "inst": np.zeros(0, np.int32),
             "pos": np.zeros((0, 3), np.float32),
             "frame": np.zeros((0, 3, 3), np.float32),
             "center": np.zeros((0, 3), np.float32),
             "bsize": np.zeros((0, 3), np.float32),
             "bquat": np.zeros((0, 4), np.float32)}
    arr = {name: np.concatenate(parts) if parts else empty[name]
           for name, parts in rec.items()}
    cw_arr = arr["cw"]

    # group votes by codeword, insertion order within a group
    order = np.argsort(cw_arr, kind="stable")
    uniq_cw, group_start, group_size = np.unique(
        cw_arr[order], return_index=True, return_counts=True)

    # KNN k=1 / INN clean-up: keep single-vote codewords only
    if (params.activation_type == "KNN" and params.knn_k == 1) \
            or params.activation_type == "INN":
        keep_g = group_size == 1
        uniq_cw = uniq_cw[keep_g]
        group_start = group_start[keep_g]
        group_size = group_size[keep_g]

    if len(uniq_cw):
        sel = np.concatenate([order[s:s + z]
                              for s, z in zip(group_start, group_size)])
    else:
        sel = np.zeros(0, np.int64)
    g_of_vote = np.repeat(np.arange(len(uniq_cw)), group_size)
    slot_of_vote = (np.arange(len(sel))
                    - np.repeat(np.cumsum(group_size) - group_size,
                                group_size)) \
        if len(sel) else np.zeros(0, np.int64)
    arr = {name: a[sel] for name, a in arr.items() if name != "cw"}

    weight_arr = _center_weights_batched(arr["vote"], arr["pos"],
                                         arr["frame"], arr["center"],
                                         g_of_vote, group_size)
    clsw_arr = _statistical_class_weights_arrays(
        np.repeat(uniq_cw, group_size), arr["class"])

    # pack to serving arrays
    c_used = len(uniq_cw)
    mv = int(group_size.max()) if c_used else 1
    dim = codeword_data.shape[1]
    num_classes = (max(classes) + 1) if classes else 1
    rows = max(c_used, 1)
    out = TrainedCodebook(
        codewords=np.zeros((rows, dim), np.float32),
        cw_mask=np.zeros(rows, bool),
        cw_weight=np.ones(rows, np.float32),
        cw_position=np.zeros((rows, 3), np.float32),
        votes=np.zeros((rows, mv, 3), np.float32),
        vote_mask=np.zeros((rows, mv), bool),
        vote_class=np.zeros((rows, mv), np.int32),
        vote_instance=np.zeros((rows, mv), np.int32),
        vote_weight=np.zeros((rows, mv), np.float32),
        class_weight=np.ones((rows, mv), np.float32),
        bbox_size=np.zeros((rows, mv, 3), np.float32),
        bbox_quat=np.zeros((rows, mv, 4), np.float32),
        class_sigma=np.ones(num_classes, np.float32),
    )
    for cid, var in class_sigmas.items():
        out.class_sigma[cid] = var
    if c_used:
        out.codewords[:c_used] = codeword_data[uniq_cw]
        out.cw_mask[:c_used] = True
        out.cw_position[:c_used] = codeword_positions[uniq_cw]
        r, s = g_of_vote, slot_of_vote
        out.votes[r, s] = arr["vote"]
        out.vote_mask[r, s] = True
        out.vote_class[r, s] = arr["class"]
        out.vote_instance[r, s] = arr["inst"]
        out.vote_weight[r, s] = weight_arr
        out.class_weight[r, s] = clsw_arr
        out.bbox_size[r, s] = arr["bsize"]
        out.bbox_quat[r, s] = arr["bquat"]
    return out


def _center_weights_batched(vote, pos, frame, center, g_of_vote, group_size
                            ) -> np.ndarray:
    """CodewordDistribution::computeWeights (codeword_distribution.cpp:
    171-243): weight of vote i = median over the votes j of its codeword of
    exp(-|pos_j + R_j^T v_i - center_i|^2 / 0.5^2); groups padded to the
    largest and batched, NaN padding + nanmedian for numpy's midpoint
    rule."""
    sigma = 0.5
    nv = len(vote)
    if nv == 0:
        return np.zeros(0, np.float32)
    m = int(group_size.max())
    if m == 1:
        # each vote is its own median (the KNN k=1 case)
        back = np.einsum("jab,ja->jb", frame, vote)     # F^T v (rotateBack)
        dist = np.linalg.norm(pos + back - center, axis=1)
        return np.exp(-(dist ** 2) / (sigma ** 2)).astype(np.float32)
    ng = len(group_size)
    gi = np.full((ng, m), -1, np.int64)
    slot = np.arange(nv) - np.repeat(np.cumsum(group_size) - group_size,
                                     group_size)
    gi[g_of_vote, slot] = np.arange(nv)
    valid = gi >= 0
    gi0 = np.where(valid, gi, 0)
    out = np.zeros(nv, np.float32)
    # chunk over groups so the [chunk, m, m, 3] intermediate stays bounded
    gchunk = max(1, (1 << 22) // max(m * m, 1))
    for g0 in range(0, ng, gchunk):
        gs = slice(g0, min(g0 + gchunk, ng))
        idx = gi0[gs]
        val = valid[gs]
        back = np.einsum("gjab,gia->gijb", frame[idx], vote[idx])
        world = pos[idx][:, None, :, :] + back
        dist = np.linalg.norm(world - center[idx][:, :, None, :], axis=3)
        w = np.exp(-(dist ** 2) / (sigma ** 2))
        w = np.where(val[:, None, :], w, np.nan)
        med = np.nanmedian(w, axis=2)
        out[idx[val]] = med[val].astype(np.float32)
    return out


def _statistical_class_weights_arrays(cw_of_vote: np.ndarray,
                                      class_of_vote: np.ndarray
                                      ) -> np.ndarray:
    """The 9-step statistical weights (codebook.cpp:226-365) per vote:
    term1[class] * term2[cw] * term3[cw, class], with term1 = 1 /
    #codewords voting for the class, term2 = 1 / #votes of the codeword and
    term3 the codeword's share of the class's votes normalised over
    classes (per (codeword, class), the JAX package's reading)."""
    nv = len(cw_of_vote)
    if nv == 0:
        return np.ones(0, np.float32)
    u_cw, cw_id = np.unique(cw_of_vote, return_inverse=True)
    u_cls, cls_id = np.unique(class_of_vote, return_inverse=True)
    n_cw, n_cls = len(u_cw), len(u_cls)
    nfeat_cls = np.bincount(cls_id, minlength=n_cls).astype(np.float64)
    pair_key = cw_id.astype(np.int64) * n_cls + cls_id
    u_pair, pair_inv, nv_pair = np.unique(pair_key, return_inverse=True,
                                          return_counts=True)
    pair_cw = (u_pair // n_cls).astype(np.int64)
    pair_cls = (u_pair % n_cls).astype(np.int64)
    sum_cw = np.zeros(n_cw, np.float64)
    np.add.at(sum_cw, pair_cw, nv_pair / nfeat_cls[pair_cls])
    ncw_cls = np.zeros(n_cls, np.int64)
    np.add.at(ncw_cls, pair_cls, 1)
    term1 = 1.0 / ncw_cls
    term2 = 1.0 / np.bincount(cw_id, minlength=n_cw).astype(np.float64)
    t3_pair = (nv_pair / nfeat_cls[pair_cls]) / sum_cw[pair_cw]
    w_pair = term1[pair_cls] * term2[pair_cw] * t3_pair
    return w_pair[pair_inv].astype(np.float32)
