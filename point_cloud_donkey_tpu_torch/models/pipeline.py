"""The batched classification step (port of the tile-compacted branch of
``classify_scores_batch`` in point_cloud_donkey_tpu/models/pipeline_jit.py).

Stages, for B clouds of N points:
  1. normals: the sign-voted z axis of every point's own SHOT LRF (K1, K2);
  2. keypoints: voxel-grid centroids, valid rows first;
  3. LRF: SHOT LRFs at the keypoints (K1, K2);
  4. SHOT: SHOT-352 over the tile-compacted keypoints of the whole batch
     (K3); the tile count comes from one host read of the [B] keypoint
     counts;
  5. kNN + votes: chi-square nearest codewords (K4) and vote casting;
  6. scores: per-class Gaussian vote density at each cloud's centroid
     (single-object mode, bandwidth = the voting bandwidth).
Scores are point-order invariant and each cloud's are independent of the
rest of the batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..ops.kernels.shot_fused import shot_descriptor_fused_compact
from ..ops.lrf import shot_lrf
from ..ops.neighbors import full_fp32
from ..ops.normals import compute_normals_fast
from ..ops.voxel_grid import voxel_grid
from ..utils.config import IsmConfig
from .codebook import Codebook, CodebookParams, cast_votes

STAGES = ("normals", "keypoints", "lrf", "shot", "knn_votes", "scores")


class PipelineConfig(NamedTuple):
    """Static configuration of the classification step (the fields of the
    JAX ``JitPipelineConfig`` that the port reads)."""
    descriptor: str = "SHOT"
    radius: float = 0.6
    ref_frame_radius: float = 0.5
    leaf_size: float = 0.35
    normal_radius: float = 0.25
    normals_method: int = 2
    metric: str = "chisq"
    keypoint_capacity: int = 512
    bandwidth: float = 0.5
    num_classes: int = 5
    # sorted-axis windowed sweeps (ops/binned.py) are not ported yet
    normals_window: int = 0
    descriptor_window: int = 0

    @classmethod
    def from_ism(cls, config: IsmConfig, num_classes: int,
                 **overrides) -> "PipelineConfig":
        """From an ``.ism`` config, with the reference's defaults, as the
        JAX serve CLI builds its JitPipelineConfig."""
        feat = config.child("Features")
        root = config.root
        return cls(
            descriptor=feat.type or "SHOT",
            radius=feat.get("Radius", 0.1),
            ref_frame_radius=feat.get("ReferenceFrameRadius", 0.2),
            leaf_size=config.child("Keypoints").get("LeafSize", 0.02),
            normal_radius=root.get("NormalRadius", 0.05),
            normals_method=root.get("ConsistentNormalsMethod", 2),
            metric="chisq" if root.get("DistanceType", "Euclidean")
            == "ChiSquared" else "l2",
            bandwidth=config.child("Voting").get("Bandwidth", 0.1),
            num_classes=num_classes,
            **overrides)


def _check_supported(cfg: PipelineConfig) -> None:
    if cfg.descriptor != "SHOT":
        raise NotImplementedError(
            f"descriptor {cfg.descriptor!r}: the port serves SHOT only")
    if cfg.normals_method != 2:
        raise NotImplementedError(
            "ConsistentNormalsMethod != 2 (PCA normals) is not ported")
    if cfg.normals_window or cfg.descriptor_window:
        raise NotImplementedError(
            "windowed normals / descriptors (ops/binned.py) are not ported")


class IsmClassifier(nn.Module):
    """Per-class scores [B, num_classes] of a batch of clouds against a
    trained codebook (the JAX ``classify_scores_batch``)."""

    def __init__(self, codebook: Codebook, cfg: PipelineConfig,
                 params: Optional[CodebookParams] = None):
        super().__init__()
        _check_supported(cfg)
        self.codebook = codebook
        self.cfg = cfg
        self.params = params or CodebookParams()

    def forward(self, points: torch.Tensor,   # [B, N, 3] f32
                mask: torch.Tensor,           # [B, N] bool
                on_stage: Optional[Callable[[str], None]] = None
                ) -> torch.Tensor:
        """on_stage(name) is called after each stage of STAGES (for
        timing with CUDA events)."""
        mark = on_stage or (lambda name: None)
        cfg = self.cfg
        points = points.contiguous()
        mask = mask.contiguous()
        with full_fp32():
            normals = compute_normals_fast(points, mask, cfg.normal_radius)
            mark("normals")

            kres = voxel_grid(points, mask, cfg.leaf_size,
                              capacity=cfg.keypoint_capacity)
            kp_mask = kres.mask
            kp = torch.where(kp_mask[..., None], kres.centroids,
                             torch.full_like(kres.centroids, 1e9))
            mark("keypoints")

            lrf = shot_lrf(kp, kp_mask, points, mask, cfg.ref_frame_radius)
            mark("lrf")

            desc, valid, kp_f, fr_f, cloud_id = \
                shot_descriptor_fused_compact(
                    kp, lrf.frames, lrf.valid, kp_mask, points, normals,
                    mask, cfg.radius)
            mark("shot")

            votes = cast_votes(self.codebook, desc, kp_f, fr_f, valid,
                               self.params, cfg.metric)
            mark("knn_votes")

            scores = self._scores(points, mask, votes, cloud_id)
            mark("scores")
        return scores

    def _scores(self, points, mask, votes, cloud_id):
        """Gaussian vote density at each cloud's centroid, per class (the
        JAX ``_scores_from_features_flat``)."""
        cfg = self.cfg
        b = points.shape[0]
        m = mask.to(points.dtype)
        centroid = (points * m[..., None]).sum(1) \
            / torch.clamp(m.sum(1), min=1.0)[:, None]             # [B, 3]
        rep = votes.position.shape[0] // max(cloud_id.shape[0], 1)
        vcloud = cloud_id.repeat_interleave(rep)
        d2 = torch.sum((votes.position - centroid[vcloud]) ** 2, dim=1)
        b2 = cfg.bandwidth * cfg.bandwidth
        in_r = (d2 <= b2) & votes.valid
        w = torch.where(in_r, torch.exp(-0.5 * d2 / b2) * votes.weight,
                        torch.zeros_like(d2))
        seg = vcloud * cfg.num_classes + votes.class_id
        scores = torch.zeros(b * cfg.num_classes, dtype=points.dtype,
                             device=points.device)
        scores.index_add_(0, seg, w)
        return scores.reshape(b, cfg.num_classes)

