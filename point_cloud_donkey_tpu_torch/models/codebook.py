"""Serving codebook and vote casting (port of the detection half of
point_cloud_donkey_tpu/models/codebook.py, KNN activation).

Weights carried across: a codebook trained by the JAX package is saved as
the ``cb_*`` arrays of ``<model>.ismd.npz`` (models/ism.py save); the
:class:`Codebook` module holds them as registered buffers, so ``.to(device)``
moves them.  Training stays in the JAX package for now.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.geometry import matrix_to_quat, quat_multiply
from ..ops.neighbors import knn
from ..utils.config import ComponentConfig

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
    """Codebook + KNN activation parameters (codebook.cpp:32-41)."""
    use_class_weight: bool = False
    use_vote_weight: bool = False
    use_matching_weight: bool = False
    use_codeword_weight: bool = False
    activation_type: str = "KNN"
    knn_k: int = 1
    use_distance_ratio: bool = False
    distance_ratio_threshold: float = 0.8
    use_partial_shot: bool = False

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
            use_partial_shot=cfg.get("UsePartialShot", False))


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


def cast_votes(cb: Codebook,
               descriptors: torch.Tensor,  # [F, D]
               positions: torch.Tensor,    # [F, 3]
               frames: torch.Tensor,       # [F, 3, 3] rows = LRF axes
               f_mask: torch.Tensor,       # [F]
               params: CodebookParams,
               metric: str) -> CastVotes:
    """Codebook::castVotes + CodewordDistribution::castVotes for the KNN
    activation: k nearest codewords per feature, their votes rotated back
    into the scene frame, the 2-sigma gate and the epsilon weight cut."""
    if params.activation_type != "KNN":
        raise NotImplementedError(
            f"activation {params.activation_type!r}: the port serves KNN only")
    if params.use_partial_shot:
        raise NotImplementedError("partial SHOT matching is not ported")
    k = params.knn_k
    search_k = k + 1 if (params.use_distance_ratio and k == 1) else k
    dists, idx = knn(descriptors, cb.codewords, cb.cw_mask,
                     min(search_k, cb.codewords.shape[0]), metric)
    keep = torch.ones((descriptors.shape[0], k), dtype=torch.bool,
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

    f, mv = descriptors.shape[0], votes.shape[2]
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
