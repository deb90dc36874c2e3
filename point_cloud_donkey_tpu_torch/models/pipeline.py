"""The batched classification step (port of ``classify_scores_batch``) and
the batched mean-shift detection step (port of
``jax.vmap(detect_maxima_jit)``), from
point_cloud_donkey_tpu/models/pipeline_jit.py.

Classification stages (STAGES) of the SHOT step, for B clouds of N points
(the compacted branch of ``classify_scores_batch``):
  0. sort: with a normals window (0 < normals_window < N), each cloud is
     sorted along its principal axis (ops/binned.py); the other stages then
     run on the sorted clouds;
  1. normals: the sign-voted z axis of every point's own SHOT LRF -- over
     each 256-point tile's window (K5, K6) or over the whole cloud (K1, K2);
  2. keypoints: voxel-grid centroids, valid rows first;
  3. LRF: SHOT LRFs at the keypoints (K1, K2);
  4. SHOT: SHOT-352 over the tile-compacted keypoints of the whole batch
     (K3); the tile count comes from one host read of the [B] keypoint
     counts, which also reads the window plan's exactness flag;
  5. kNN + votes: chi-square nearest codewords (K4) and vote casting;
  6. scores: per-class Gaussian vote density at each cloud's centroid
     (single-object mode, bandwidth = the voting bandwidth).
The CSHOT and SHORT_SHOT steps are the ``jax.vmap(classify_scores)``
branch, on the dense [B, K] keypoint grid: no sort; normals (K1, K2) for
CSHOT only -- SHORT_SHOT reads none, the stage is empty; keypoints carry
the mean colour of their voxel for CSHOT; LRF (K1, K2); the descriptor
over every (keypoint, point) pair -- CSHOT-1344 accumulated by K8 twice
(shape and colour channel), SHORT_SHOT-32 by K9; then kNN + votes (K4)
over the valid rows of the grid and the same scores, each cloud's rows
one run.
With ``lrf_version`` 2 (PCD_PALLAS_LRF_V=2) every dense LRF pass runs the
v2 kernels instead: K10 for the moments, K11 for the keypoint LRFs' votes,
K2 for the z-only normals' votes.
Each cloud's scores are independent of the rest of the batch.  They are
not bit-invariant to the order of its points, which sets the
floating-point summation order of every sum over points.
On the 128-cloud bench batch on an H100, sorting the clouds moved the
dense step's scores by up to 0.28 (rms 0.011, scores up to 111) and
changed no cloud's argmax (PERF.md).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..ops import mean_shift as ms
from ..ops.binned import compute_normals_fast_windowed, sort_clouds_ex
from ..ops.kernels.shot_fused import (shot_descriptor_fused,
                                      shot_descriptor_fused_compact)
from ..ops.lrf import shot_lrf
from ..ops.neighbors import full_fp32
from ..ops.normals import compute_normals_fast
from ..ops.shot import cshot_descriptor_dense
from ..ops.short_shot import short_shot_descriptor_dense
from ..ops.voxel_grid import voxel_grid
from ..utils.config import IsmConfig
from .codebook import Codebook, CodebookParams, cast_votes

STAGES = ("sort", "normals", "keypoints", "lrf", "shot", "knn_votes",
          "scores")
DETECT_STAGES = ("normals", "keypoints", "lrf", "shot", "knn_votes",
                 "mean_shift")
DESCRIPTORS = ("SHOT", "CSHOT", "SHORT_SHOT")
# mean-shift seeds per (cloud, class) group and iterations at most: the
# defaults of the JAX detect_maxima_jit, which bench.py and the serve CLI use
SEED_CAPACITY = 256
MAX_ITER = 100


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
    # sorted-axis window of the normals (ops/binned.py); 0 = dense.
    # Calibrate with ops.binned.required_window; a window >= N runs dense.
    # SHOT only; SHORT_SHOT has no normals and ignores it, as the JAX step
    normals_window: int = 0
    # the windowed descriptor (shot_descriptor_fused_windowed) is not ported
    descriptor_window: int = 0
    # SHOT LRF kernels (ops/lrf.py): 1 = K1/K2, 2 = K10/K11 (K2 for the
    # z-only normals), the JAX package's PCD_PALLAS_LRF_V; the windowed
    # normals have no v2 and keep K5/K6
    lrf_version: int = 1

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
    if cfg.descriptor not in DESCRIPTORS:
        raise NotImplementedError(
            f"descriptor {cfg.descriptor!r}: the port serves "
            f"{', '.join(DESCRIPTORS)}")
    if cfg.descriptor == "CSHOT" and cfg.normals_window:
        raise NotImplementedError(
            "CSHOT with a normals window (normals_window) is not ported")
    if cfg.normals_method != 2:
        raise NotImplementedError(
            "ConsistentNormalsMethod != 2 (PCA normals) is not ported")
    if cfg.descriptor_window:
        raise NotImplementedError(
            "the windowed descriptor (descriptor_window) is not ported")


def _keypoints(points, mask, cfg, rgb=None):
    """Voxel-grid keypoints, invalid rows parked at 1e9: (kp [B, K, 3],
    kp_mask [B, K], the mean colour of each voxel [B, K, 3] or None
    without `rgb`)."""
    kres = voxel_grid(points, mask, cfg.leaf_size,
                      capacity=cfg.keypoint_capacity, features=rgb)
    xyz = kres.centroids[..., :3]
    kp = torch.where(kres.mask[..., None], xyz, torch.full_like(xyz, 1e9))
    return kp, kres.mask, None if rgb is None else kres.centroids[..., 3:6]


class IsmClassifier(nn.Module):
    """Per-class scores [B, num_classes] of a batch of clouds against a
    trained codebook (the JAX ``classify_scores_batch``).

    With 0 < cfg.normals_window < N the normals run over the sorted-axis
    windows.  Results are never approximate: the window plan's exactness
    flag is read in the same host read as the keypoint counts of the SHOT
    stage, and when it is False the normals are recomputed densely (K1, K2)
    inside the same call; ``dense_recomputes`` counts those calls.  The
    JAX bench's second fallback, on the tile capacity of the compacted
    SHOT, has no counterpart: the compacted layout is sized from the batch
    itself."""

    def __init__(self, codebook: Codebook, cfg: PipelineConfig,
                 params: Optional[CodebookParams] = None):
        super().__init__()
        _check_supported(cfg)
        self.codebook = codebook
        self.cfg = cfg
        self.params = params or CodebookParams()
        self.dense_recomputes = 0

    def forward(self, points: torch.Tensor,   # [B, N, 3] f32
                mask: torch.Tensor,           # [B, N] bool
                rgb: Optional[torch.Tensor] = None,  # [B, N, 3] in [0, 1]
                on_stage: Optional[Callable[[str], None]] = None
                ) -> torch.Tensor:
        """on_stage(name) is called after each stage of STAGES (for
        timing with CUDA events).  `rgb` is read by CSHOT only, which
        needs it."""
        mark = on_stage or (lambda name: None)
        cfg = self.cfg
        points = points.contiguous()
        mask = mask.contiguous()
        if cfg.descriptor != "SHOT":
            if cfg.descriptor == "CSHOT" and rgb is None:
                raise ValueError("CSHOT needs RGB data (rgb [B, N, 3])")
            with full_fp32():
                return self._forward_dense_grid(
                    points, mask,
                    rgb.contiguous() if cfg.descriptor == "CSHOT" else None,
                    mark)
        b, n = points.shape[0], points.shape[1]
        windowed = 0 < cfg.normals_window < n
        with full_fp32():
            if windowed:
                srt = sort_clouds_ex(points, mask)
                points, mask = srt.points, srt.mask
            mark("sort")

            exact = None
            if windowed:
                normals, exact = compute_normals_fast_windowed(
                    points, mask, srt.keys, cfg.normal_radius,
                    cfg.normals_window)
            else:
                normals = compute_normals_fast(points, mask,
                                               cfg.normal_radius,
                                               cfg.lrf_version)
            mark("normals")

            kp, kp_mask, _ = _keypoints(points, mask, cfg)
            mark("keypoints")

            lrf = shot_lrf(kp, kp_mask, points, mask, cfg.ref_frame_radius,
                           lrf_version=cfg.lrf_version)
            mark("lrf")

            # the step's one host read: the [B] keypoint counts that size
            # the compacted layout, and the window plan's exactness flag
            host = kp_mask.sum(1)
            if exact is not None:
                host = torch.cat([host, exact.to(host.dtype)[None]])
            host = host.cpu().numpy()
            if exact is not None and not host[b]:
                normals = compute_normals_fast(points, mask,
                                               cfg.normal_radius,
                                               cfg.lrf_version)
                self.dense_recomputes += 1
            desc, valid, kp_f, fr_f, cloud_id = \
                shot_descriptor_fused_compact(
                    kp, lrf.frames, lrf.valid, kp_mask, points, normals,
                    mask, cfg.radius, counts=host[:b])
            mark("shot")

            votes = cast_votes(self.codebook, desc, kp_f, fr_f, valid,
                               self.params, cfg.metric)
            mark("knn_votes")

            scores = self._scores(points, mask, votes, cloud_id)
            mark("scores")
        return scores

    def _forward_dense_grid(self, points, mask, rgb, mark):
        """The CSHOT / SHORT_SHOT step (``jax.vmap(classify_scores)``) on
        the dense [B, K] keypoint grid."""
        cfg = self.cfg
        b = points.shape[0]
        mark("sort")
        normals = None
        if cfg.descriptor == "CSHOT":
            normals = compute_normals_fast(points, mask, cfg.normal_radius,
                                           cfg.lrf_version)
        mark("normals")

        kp, kp_mask, kp_rgb = _keypoints(points, mask, cfg, rgb)
        k = kp.shape[1]
        mark("keypoints")

        lrf = shot_lrf(kp, kp_mask, points, mask, cfg.ref_frame_radius,
                       lrf_version=cfg.lrf_version)
        mark("lrf")

        if rgb is None:
            res = short_shot_descriptor_dense(kp, lrf.frames, lrf.valid,
                                              points, mask, cfg.radius)
        else:
            res = cshot_descriptor_dense(kp, kp_rgb, lrf.frames, lrf.valid,
                                         points, normals, rgb, mask,
                                         cfg.radius)
        mark("shot")

        # only valid descriptors cast votes: the kNN runs on those rows alone
        # (the step's one host read; ~45% of the grid is padding at the
        # bench geometry), kept in cloud order for the scores' runs
        rows = res.valid.reshape(b * k).nonzero()[:, 0]
        votes = cast_votes(self.codebook,
                           res.descriptors.reshape(b * k, -1)[rows],
                           kp.reshape(b * k, 3)[rows],
                           lrf.frames.reshape(b * k, 3, 3)[rows],
                           res.valid.reshape(b * k)[rows], self.params,
                           cfg.metric)
        mark("knn_votes")

        scores = self._scores(points, mask, votes, rows // k)
        mark("scores")
        return scores

    def _scores(self, points, mask, votes, cloud_id):
        """Gaussian vote density at each cloud's centroid, per class (the
        JAX ``_scores_from_features_flat``).  The compacted rows are grouped
        by cloud, so each cloud's votes are one contiguous run, summed in a
        fixed order (no atomics: the same scores on every run)."""
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
        classes = torch.arange(cfg.num_classes, device=w.device)
        per_class = torch.where(votes.class_id[:, None] == classes,
                                w[:, None], torch.zeros_like(w)[:, None])
        lengths = torch.bincount(vcloud, minlength=b)
        return torch.segment_reduce(per_class, "sum", lengths=lengths,
                                    axis=0)


class IsmDetector(nn.Module):
    """Per-class best mean-shift maximum of a batch of clouds: (densities
    [B, C], positions [B, C, 3]), the JAX ``jax.vmap(detect_maxima_jit)``.
    A class with no surviving maximum reports density 0 at position 0.

    Stages (DETECT_STAGES): dense normals (K1, K2), voxel keypoints,
    keypoint LRFs (K1, K2), SHOT-352 on the dense [B, K] keypoint grid
    (K7), kNN + votes (K4), then per (cloud, class) group: grid seeds ->
    mean-shift -> density -> the densest surviving seed.  The JAX per-cloud
    path computes the descriptor with the XLA ``shot_descriptor_dense``;
    the port computes the same function with K7, the port of
    ``_shot_fused_call``, whose parity target is that function."""

    def __init__(self, codebook: Codebook, cfg: PipelineConfig,
                 params: Optional[CodebookParams] = None):
        super().__init__()
        _check_supported(cfg)
        if cfg.descriptor != "SHOT":
            raise NotImplementedError(
                f"detection with descriptor {cfg.descriptor!r}: the port's "
                "mean-shift detection serves SHOT only")
        self.codebook = codebook
        self.cfg = cfg
        self.params = params or CodebookParams()

    def forward(self, points: torch.Tensor,   # [B, N, 3] f32
                mask: torch.Tensor,           # [B, N] bool
                on_stage: Optional[Callable[[str], None]] = None):
        """on_stage(name) is called after each stage of DETECT_STAGES."""
        mark = on_stage or (lambda name: None)
        cfg = self.cfg
        b = points.shape[0]
        points = points.contiguous()
        mask = mask.contiguous()
        with full_fp32():
            normals = compute_normals_fast(points, mask, cfg.normal_radius,
                                           cfg.lrf_version)
            mark("normals")

            kp, kp_mask, _ = _keypoints(points, mask, cfg)
            k = kp.shape[1]
            mark("keypoints")

            lrf = shot_lrf(kp, kp_mask, points, mask, cfg.ref_frame_radius,
                           lrf_version=cfg.lrf_version)
            mark("lrf")

            desc, valid = shot_descriptor_fused(kp, lrf.frames, lrf.valid,
                                                points, normals, mask,
                                                cfg.radius)
            mark("shot")

            votes = cast_votes(self.codebook, desc.reshape(b * k, -1),
                               kp.reshape(b * k, 3),
                               lrf.frames.reshape(b * k, 3, 3),
                               valid.reshape(b * k), self.params, cfg.metric)
            mark("knn_votes")

            dens, pos = self._best_maxima(votes, b)
            mark("mean_shift")
        return dens, pos

    def _best_maxima(self, votes, b):
        """Mean-shift over every (cloud, class) group of the votes, which
        are grouped by cloud (each cloud casts V votes)."""
        c = self.cfg.num_classes
        v = votes.position.shape[0] // b
        classes = torch.arange(c, device=votes.position.device)
        sel = (votes.valid.reshape(b, 1, v)
               & (votes.class_id.reshape(b, 1, v) == classes[:, None]))
        sel = sel.reshape(b * c, v)
        w = votes.weight.reshape(b, 1, v).expand(b, c, v).reshape(b * c, v)
        w = torch.where(sel, w, torch.zeros_like(w))
        pos = votes.position.reshape(b, 1, v, 3).expand(b, c, v, 3) \
            .reshape(b * c, v, 3)
        pos = torch.where(sel[..., None], pos, torch.full_like(pos, 1e9))
        bw = self.cfg.bandwidth
        seeds, _, seed_mask = ms.create_seeds(pos, w, sel,
                                              ms.seeds_range(bw),
                                              SEED_CAPACITY)
        centers, alive = ms.mean_shift(seeds, seed_mask, pos, w, sel, bw,
                                       max_iter=MAX_ITER)
        dens = ms.estimate_density(centers, pos, w, sel, bw)
        dens = torch.where(alive, dens, torch.zeros_like(dens))
        best = dens.argmax(-1)                       # first of equal maxima
        best_dens = dens.gather(1, best[:, None])[:, 0]
        best_pos = centers.gather(
            1, best[:, None, None].expand(-1, 1, 3))[:, 0]
        has = alive.any(-1) & (best_dens > 0)
        best_pos = torch.where(has[:, None], best_pos,
                               torch.zeros_like(best_pos))
        return best_dens.reshape(b, c), best_pos.reshape(b, c, 3)
