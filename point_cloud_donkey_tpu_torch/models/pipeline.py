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
With 0 < descriptor_window the SHOT step takes the windowed-descriptor
route of ``classify_scores_batch`` instead (``descriptor_tile_capacity =
0``): the clouds are sorted (always), the keypoints of the dense [B, K]
grid are co-sorted by the same key and each 8-keypoint tile sweeps only
its window of the sorted cloud (K3w); kNN + votes and the scores run on
the whole grid.
The CSHOT and SHORT_SHOT steps are the ``jax.vmap(classify_scores)``
branch, on the dense [B, K] keypoint grid (:func:`extract_features`):
sort only for a CSHOT normals window; normals (K1, K2; windowed K5, K6)
for CSHOT only -- SHORT_SHOT reads none, the stage is empty; keypoints
carry the mean colour of their voxel for CSHOT; LRF (K1, K2); the
descriptor over every (keypoint, point) pair -- CSHOT-1344 accumulated by
K8 twice (shape and colour channel), SHORT_SHOT-32 by K9; then kNN + votes
(K4) over the valid rows of the grid and the same scores, each cloud's
rows one run.
The per-cloud entry points of the JAX module (``classify_scores``,
``classify_intermediates``, ``classify_scores_instances``,
``classify_scores_mean_shift``) are here as batched functions, each
computing what ``jax.vmap`` of its JAX counterpart computes, on the dense
grid through :func:`extract_features`.
With ConsistentNormalsMethod 0, 1 or 3 every normal stage is the PCA
normal of ``ops/normals.compute_normals`` (oriented towards the origin,
away from the centroid, or as it comes), as the JAX step computes it; the
normals window is then ignored.
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
from ..ops.binned import PARK, compute_normals_fast_windowed, sort_clouds_ex
from ..ops.kernels.shot_fused import (TK, shot_descriptor_fused,
                                      shot_descriptor_fused_compact,
                                      shot_descriptor_fused_windowed)
from ..ops.lrf import shot_lrf
from ..ops.neighbors import full_fp32
from ..ops.normals import compute_normals, compute_normals_fast
from ..ops.shot import cshot_descriptor_dense
from ..ops.short_shot import short_shot_descriptor_dense
from ..ops.voxel_grid import voxel_grid
from ..utils.config import IsmConfig
from .codebook import CastVotes, Codebook, CodebookParams, cast_votes

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
    # SHOT and CSHOT classify at ConsistentNormalsMethod 2; SHORT_SHOT has
    # no normals, and the other methods and detection (detect_maxima_jit)
    # ignore it, as the JAX step does
    normals_window: int = 0
    # sorted-axis window of the SHOT descriptor (points swept per
    # 8-keypoint tile, K3w); 0 = the compacted route (K3).  Calibrate with
    # ops.binned.required_window(points, mask, radius, tile_q=8,
    # q_points=keypoints, q_mask=...); the plan's exactness flag falls
    # back to K7 over the whole sorted cloud.  SHOT classify only
    descriptor_window: int = 0
    # SHOT LRF kernels (ops/lrf.py): 1 = K1/K2, 2 = K10/K11 (K2 for the
    # z-only normals), the JAX package's PCD_PALLAS_LRF_V; the windowed
    # normals have no v2 and keep K5/K6
    lrf_version: int = 1

    @classmethod
    def from_ism(cls, config: IsmConfig, num_classes: int,
                 **overrides) -> "PipelineConfig":
        """From an ``.ism`` config, with the reference's defaults, as the
        JAX serve CLI builds its JitPipelineConfig.  A model that asks for
        the global-feature verification (Voting.UseGlobalFeatures) is
        refused: its classifier (JAX models/classifier.py) is ROADMAP A13,
        and serving without it would give other decisions than the JAX
        package's."""
        if config.child("Voting").get("UseGlobalFeatures", False):
            raise NotImplementedError(
                "Voting.UseGlobalFeatures: the global-feature verification "
                "(JAX models/classifier.py) is not ported (ROADMAP A13)")
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


def _dense_normals(points, mask, cfg):
    """The normal stage over whole clouds, as the JAX ``_pre_descriptor``
    computes it: ConsistentNormalsMethod 2's fast path (the inverted z axis
    of each point's z-only SHOT LRF, +z where it is invalid), or
    ``compute_normals`` for the other methods (ops/normals.py)."""
    if cfg.normals_method == 2:
        return compute_normals_fast(points, mask, cfg.normal_radius,
                                    cfg.lrf_version)
    return compute_normals(points, mask, cfg.normal_radius,
                           cfg.normals_method, cfg.lrf_version).normals


def _keypoints(points, mask, cfg, rgb=None):
    """Voxel-grid keypoints, invalid rows parked at 1e9: (kp [B, K, 3],
    kp_mask [B, K], the mean colour of each voxel [B, K, 3] or None
    without `rgb`)."""
    kres = voxel_grid(points, mask, cfg.leaf_size,
                      capacity=cfg.keypoint_capacity, features=rgb)
    xyz = kres.centroids[..., :3]
    kp = torch.where(kres.mask[..., None], xyz, torch.full_like(xyz, 1e9))
    return kp, kres.mask, None if rgb is None else kres.centroids[..., 3:6]


class Features(NamedTuple):
    """The dense [B, K] grid's features (:func:`extract_features`)."""
    keypoints: torch.Tensor    # [B, K, 3], invalid rows at 1e9
    frames: torch.Tensor       # [B, K, 3, 3] rows = LRF axes
    descriptors: torch.Tensor  # [B, K, D]
    valid: torch.Tensor        # [B, K]
    kp_mask: torch.Tensor      # [B, K]


def extract_features(points: torch.Tensor,   # [B, N, 3]
                     mask: torch.Tensor,     # [B, N] bool
                     cfg: PipelineConfig,
                     rgb: Optional[torch.Tensor] = None,      # [B, N, 3]
                     normals: Optional[torch.Tensor] = None,  # [B, N, 3]
                     on_stage: Optional[Callable[[str], None]] = None
                     ) -> Features:
    """The stages before the votes on the dense [B, K] keypoint grid (the
    JAX ``_pre_descriptor`` + ``extract_features_jit``, batched): normals
    (:func:`_dense_normals`: K1, K2; none for SHORT_SHOT; `normals`
    short-circuits the stage),
    voxel keypoints (with their voxel's mean colour for CSHOT, which needs
    `rgb`), keypoint LRFs (K1, K2), and the descriptor -- SHOT through K7,
    CSHOT through K8, SHORT_SHOT through K9.  A row is valid when its
    descriptor is and is finite.  on_stage(name) is called after each of
    "normals", "keypoints", "lrf" and "shot"."""
    mark = on_stage or (lambda name: None)
    if cfg.descriptor == "CSHOT" and rgb is None:
        raise ValueError("CSHOT needs RGB data (rgb [B, N, 3])")
    with full_fp32():
        if normals is None and cfg.descriptor != "SHORT_SHOT":
            normals = _dense_normals(points, mask, cfg)
        mark("normals")

        kp, kp_mask, kp_rgb = _keypoints(
            points, mask, cfg, rgb if cfg.descriptor == "CSHOT" else None)
        mark("keypoints")

        lrf = shot_lrf(kp, kp_mask, points, mask, cfg.ref_frame_radius,
                       lrf_version=cfg.lrf_version)
        mark("lrf")

        if cfg.descriptor == "SHOT":
            desc, valid = shot_descriptor_fused(kp, lrf.frames, lrf.valid,
                                                points, normals, mask,
                                                cfg.radius)
        elif cfg.descriptor == "CSHOT":
            res = cshot_descriptor_dense(kp, kp_rgb, lrf.frames, lrf.valid,
                                         points, normals, rgb, mask,
                                         cfg.radius)
            desc, valid = res.descriptors, res.valid
        else:
            res = short_shot_descriptor_dense(kp, lrf.frames, lrf.valid,
                                              points, mask, cfg.radius)
            desc, valid = res.descriptors, res.valid
        valid = valid & torch.isfinite(desc).all(-1)
        mark("shot")
    return Features(kp, lrf.frames, desc, valid, kp_mask)


def _grid_votes(cb, f: Features, params, metric) -> CastVotes:
    """Votes of every row of the [B, K] grid, grouped by cloud."""
    b, k = f.valid.shape
    return cast_votes(cb, f.descriptors.reshape(b * k, -1),
                      f.keypoints.reshape(b * k, 3),
                      f.frames.reshape(b * k, 3, 3), f.valid.reshape(b * k),
                      params, metric)


def _centroid_weights(points, mask, votes, cloud_id, bandwidth):
    """Each vote's Gaussian weight at its cloud's centroid (0 outside the
    bandwidth or for an invalid vote) and whether it is inside: the JAX
    single-object-mode density query.  `cloud_id` [F] is the cloud of each
    feature row; every row casts the same number of votes."""
    m = mask.to(points.dtype)
    centroid = (points * m[..., None]).sum(1) \
        / torch.clamp(m.sum(1), min=1.0)[:, None]             # [B, 3]
    rep = votes.position.shape[0] // max(cloud_id.shape[0], 1)
    vcloud = cloud_id.repeat_interleave(rep)
    d2 = torch.sum((votes.position - centroid[vcloud]) ** 2, dim=1)
    b2 = bandwidth * bandwidth
    in_r = (d2 <= b2) & votes.valid
    w = torch.where(in_r, torch.exp(-0.5 * d2 / b2) * votes.weight,
                    torch.zeros_like(d2))
    return w, in_r, vcloud


def cosort_keypoints(kp: torch.Tensor,           # [B, K, 3]
                     kp_mask: torch.Tensor,      # [B, K]
                     frames: torch.Tensor,       # [B, K, 3, 3]
                     frame_valid: torch.Tensor,  # [B, K]
                     axis: torch.Tensor):        # [B, 3] the clouds' axes
    """The keypoints sorted by their clouds' principal-axis key (invalid
    ones last, key PARK; one stable sort), so that a tile of 8 needs one
    window of the sorted points, and padded to a multiple of 8 rows (at
    1e9, key PARK, zero frames, invalid): (kp, kp_keys, frames,
    frame_valid)."""
    keys = torch.where(kp_mask, (kp * axis[:, None, :]).sum(-1),
                       torch.full_like(kp[..., 0], PARK))
    keys, order = torch.sort(keys, dim=1, stable=True)
    kp = torch.gather(kp, 1, order[..., None].expand_as(kp))
    frames = torch.gather(frames, 1, order[..., None, None].expand_as(frames))
    frame_valid = torch.gather(frame_valid, 1, order)
    pad = -kp.shape[1] % TK
    if pad:
        kp = torch.nn.functional.pad(kp, (0, 0, 0, pad), value=1e9)
        keys = torch.nn.functional.pad(keys, (0, pad), value=PARK)
        frames = torch.nn.functional.pad(frames, (0, 0, 0, 0, 0, pad))
        frame_valid = torch.nn.functional.pad(frame_valid, (0, pad))
    return kp, keys, frames, frame_valid


class IsmClassifier(nn.Module):
    """Per-class scores [B, num_classes] of a batch of clouds against a
    trained codebook (the JAX ``classify_scores_batch``).

    With 0 < cfg.normals_window < N (SHOT, CSHOT; ConsistentNormalsMethod
    2 only: the other methods ignore the window, as the JAX step does) the
    normals run over the sorted-axis windows; with 0 < cfg.descriptor_window (SHOT) so does the
    descriptor (K3w, the JAX route with ``descriptor_tile_capacity = 0``:
    the port has no tile capacity).  Results are never approximate: a
    window plan's exactness flag is read in the step's one host read (SHOT:
    with the keypoint counts of the compacted route, or the descriptor
    plan's flag; CSHOT: right after the normals), and when it is False the
    normals are recomputed densely (K1, K2) -- with the windowed
    descriptor, the descriptor too, by K7 over the whole sorted cloud --
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
        windowed = 0 < cfg.normals_window < n and cfg.normals_method == 2
        with full_fp32():
            srt = None
            if windowed or cfg.descriptor_window > 0:
                srt = sort_clouds_ex(points, mask)
                points, mask = srt.points, srt.mask
            mark("sort")

            exact = None
            if windowed:
                normals, exact = compute_normals_fast_windowed(
                    points, mask, srt.keys, cfg.normal_radius,
                    cfg.normals_window)
            else:
                normals = _dense_normals(points, mask, cfg)
            mark("normals")

            kp, kp_mask, _ = _keypoints(points, mask, cfg)
            mark("keypoints")

            lrf = shot_lrf(kp, kp_mask, points, mask, cfg.ref_frame_radius,
                           lrf_version=cfg.lrf_version)
            mark("lrf")

            if cfg.descriptor_window > 0:
                desc, valid, kp_f, fr_f, cloud_id = \
                    self._windowed_descriptor(points, mask, srt, normals,
                                              exact, kp, kp_mask, lrf)
            else:
                # the step's one host read: the [B] keypoint counts that
                # size the compacted layout, and the window plan's flag
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

    def _windowed_descriptor(self, points, mask, srt, normals, n_exact, kp,
                             kp_mask, lrf):
        """The descriptor stage of the ``descriptor_window`` route of
        ``classify_scores_batch`` on the sorted clouds: the keypoints
        co-sorted by the clouds' key and padded to a multiple of 8, K3w,
        and the step's one host read -- the descriptor plan's exactness
        flag and the normals plan's (`n_exact`, None without a normals
        window); a tripped flag recomputes the normals (if theirs tripped)
        and the descriptor by K7 over the whole sorted cloud.  Returns the
        whole [B, K] grid as flat rows (descriptors, valid, keypoints,
        frames, cloud id)."""
        cfg = self.cfg
        b = points.shape[0]
        kp, kp_keys, frames, f_valid = cosort_keypoints(
            kp, kp_mask, lrf.frames, lrf.valid, srt.axis)
        desc, valid, exact = shot_descriptor_fused_windowed(
            kp, kp_keys, frames, f_valid, points, srt.keys, normals, mask,
            cfg.radius, cfg.descriptor_window)
        flags = exact[None] if n_exact is None \
            else torch.stack([exact, n_exact])
        flags = flags.cpu().numpy()
        if not flags.all():
            if n_exact is not None and not flags[1]:
                normals = compute_normals_fast(points, mask,
                                               cfg.normal_radius,
                                               cfg.lrf_version)
            desc, valid = shot_descriptor_fused(kp, frames, f_valid, points,
                                                normals, mask, cfg.radius)
            self.dense_recomputes += 1
        k = kp.shape[1]
        rows = torch.arange(b * k, device=points.device)
        return (desc.reshape(b * k, -1), valid.reshape(b * k),
                kp.reshape(b * k, 3), frames.reshape(b * k, 3, 3),
                torch.div(rows, k, rounding_mode="floor"))

    def _forward_dense_grid(self, points, mask, rgb, mark):
        """The CSHOT / SHORT_SHOT step (``jax.vmap(classify_scores)``) on
        the dense [B, K] keypoint grid; CSHOT with a normals window sorts
        the clouds (and their colours) and computes the normals over the
        windows (K5, K6), densely when the plan's flag trips."""
        cfg = self.cfg
        b, n = points.shape[0], points.shape[1]
        normals = None
        if cfg.descriptor == "CSHOT" and 0 < cfg.normals_window < n \
                and cfg.normals_method == 2:
            srt = sort_clouds_ex(points, mask)
            points, mask = srt.points, srt.mask
            rgb = torch.gather(rgb, 1, srt.order[..., None].expand_as(rgb))
            mark("sort")
            normals, exact = compute_normals_fast_windowed(
                points, mask, srt.keys, cfg.normal_radius, cfg.normals_window)
            if not bool(exact):       # a host read
                normals = compute_normals_fast(points, mask,
                                               cfg.normal_radius,
                                               cfg.lrf_version)
                self.dense_recomputes += 1
        else:
            mark("sort")
        f = extract_features(points, mask, cfg, rgb, normals, mark)
        k = f.keypoints.shape[1]

        # only valid descriptors cast votes: the kNN runs on those rows alone
        # (the step's one host read; ~45% of the grid is padding at the
        # bench geometry), kept in cloud order for the scores' runs
        rows = f.valid.reshape(b * k).nonzero()[:, 0]
        votes = cast_votes(self.codebook,
                           f.descriptors.reshape(b * k, -1)[rows],
                           f.keypoints.reshape(b * k, 3)[rows],
                           f.frames.reshape(b * k, 3, 3)[rows],
                           f.valid.reshape(b * k)[rows], self.params,
                           cfg.metric)
        mark("knn_votes")

        scores = self._scores(points, mask, votes, rows // k)
        mark("scores")
        return scores

    def _scores(self, points, mask, votes, cloud_id):
        """Gaussian vote density at each cloud's centroid, per class (the
        JAX ``_scores_from_features_flat``).  The rows are grouped by
        cloud, so each cloud's votes are one contiguous run, summed in a
        fixed order (no atomics: the same scores on every run)."""
        cfg = self.cfg
        b = points.shape[0]
        w, _, vcloud = _centroid_weights(points, mask, votes, cloud_id,
                                         cfg.bandwidth)
        classes = torch.arange(cfg.num_classes, device=w.device)
        per_class = torch.where(votes.class_id[:, None] == classes,
                                w[:, None], torch.zeros_like(w)[:, None])
        lengths = torch.bincount(vcloud, minlength=b)
        return torch.segment_reduce(per_class, "sum", lengths=lengths,
                                    axis=0)


def _check_detection(cfg: PipelineConfig) -> None:
    _check_supported(cfg)
    if cfg.descriptor == "CSHOT":
        raise NotImplementedError(
            "detection with descriptor 'CSHOT': the JAX detection step "
            "(detect_maxima_jit) passes no colours, and its serve CLI "
            "refuses CSHOT under --maxima")


def _best_maxima(votes, b, num_classes, bandwidth, seed_capacity, max_iter):
    """Mean-shift over every (cloud, class) group of the votes, which are
    grouped by cloud (each cloud casts V votes): the best density [B, C]
    and its position [B, C, 3] (0 where no maximum survives)."""
    c = num_classes
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
    seeds, _, seed_mask = ms.create_seeds(pos, w, sel,
                                          ms.seeds_range(bandwidth),
                                          seed_capacity)
    centers, alive = ms.mean_shift(seeds, seed_mask, pos, w, sel, bandwidth,
                                   max_iter=max_iter)
    dens = ms.estimate_density(centers, pos, w, sel, bandwidth)
    dens = torch.where(alive, dens, torch.zeros_like(dens))
    best = dens.argmax(-1)                       # first of equal maxima
    best_dens = dens.gather(1, best[:, None])[:, 0]
    best_pos = centers.gather(1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    has = alive.any(-1) & (best_dens > 0)
    best_pos = torch.where(has[:, None], best_pos, torch.zeros_like(best_pos))
    return best_dens.reshape(b, c), best_pos.reshape(b, c, 3)


def _detect(points, mask, cb, cfg, params, seed_capacity, max_iter,
            mark=lambda name: None):
    """The detection step (``jax.vmap(detect_maxima_jit)``): (densities
    [B, C], positions [B, C, 3])."""
    b = points.shape[0]
    points, mask = points.contiguous(), mask.contiguous()
    with full_fp32():
        f = extract_features(points, mask, cfg, on_stage=mark)
        votes = _grid_votes(cb, f, params, cfg.metric)
        mark("knn_votes")
        out = _best_maxima(votes, b, cfg.num_classes, cfg.bandwidth,
                           seed_capacity, max_iter)
        mark("mean_shift")
    return out


class IsmDetector(nn.Module):
    """Per-class best mean-shift maximum of a batch of clouds: (densities
    [B, C], positions [B, C, 3]), the JAX ``jax.vmap(detect_maxima_jit)``.
    A class with no surviving maximum reports density 0 at position 0.

    Stages (DETECT_STAGES): :func:`extract_features` -- dense normals (K1,
    K2; SHORT_SHOT reads none, the stage is empty), voxel keypoints,
    keypoint LRFs (K1, K2), the descriptor on the dense [B, K] keypoint
    grid (SHOT: K7; SHORT_SHOT: K9) -- kNN + votes (K4), then per (cloud,
    class) group: grid seeds -> mean-shift -> density -> the densest
    surviving seed.  The JAX per-cloud path computes the SHOT descriptor
    with the XLA ``shot_descriptor_dense``; the port computes the same
    function with K7, the port of ``_shot_fused_call``, whose parity
    target is that function.  CSHOT is refused: the JAX step passes no
    colours.  The windows (normals_window, descriptor_window) are
    classification options and are ignored here, as in the JAX step."""

    def __init__(self, codebook: Codebook, cfg: PipelineConfig,
                 params: Optional[CodebookParams] = None):
        super().__init__()
        _check_detection(cfg)
        self.codebook = codebook
        self.cfg = cfg
        self.params = params or CodebookParams()

    def forward(self, points: torch.Tensor,   # [B, N, 3] f32
                mask: torch.Tensor,           # [B, N] bool
                on_stage: Optional[Callable[[str], None]] = None):
        """on_stage(name) is called after each stage of DETECT_STAGES."""
        return _detect(points, mask, self.codebook, self.cfg, self.params,
                       SEED_CAPACITY, MAX_ITER,
                       on_stage or (lambda name: None))


# ---------------------------------------------------------------------------
# the per-cloud entry points of the JAX module, batched
# ---------------------------------------------------------------------------

class ClassifyIntermediates(NamedTuple):
    """Every stage output of :func:`classify_intermediates` (the JAX
    ``ClassifyIntermediates`` with a leading B)."""
    scores: torch.Tensor         # [B, num_classes]
    keypoints: torch.Tensor      # [B, K, 3]
    descriptors: torch.Tensor    # [B, K, D]
    desc_valid: torch.Tensor     # [B, K]
    vote_position: torch.Tensor  # [B, T, 3]
    vote_weight: torch.Tensor    # [B, T] Gaussian-weighted, 0 outside
    vote_class: torch.Tensor     # [B, T]
    vote_valid: torch.Tensor     # [B, T] inside the bandwidth and valid


def _segment_sums(w: torch.Tensor, ids: torch.Tensor, num: int):
    """[B, num] sums of w [B, T] over the ids [B, T] in [0, num) (others
    are dropped, as by jax.ops.segment_sum), in a fixed order."""
    seg = torch.arange(num, device=w.device)
    return torch.where(ids[..., None] == seg, w[..., None],
                       torch.zeros_like(w)[..., None]).sum(1)


def _classify(points, mask, cb, cfg, cb_params, rgb, normals):
    _check_supported(cfg)
    b = points.shape[0]
    points, mask = points.contiguous(), mask.contiguous()
    with full_fp32():
        f = extract_features(points, mask, cfg,
                             None if rgb is None else rgb.contiguous(),
                             normals)
        votes = _grid_votes(cb, f, cb_params, cfg.metric)
        k = f.valid.shape[1]
        rows = torch.arange(b * k, device=points.device)
        w, in_r, _ = _centroid_weights(
            points, mask, votes, torch.div(rows, k, rounding_mode="floor"),
            cfg.bandwidth)
        w, in_r = w.reshape(b, -1), in_r.reshape(b, -1)
        cls = votes.class_id.reshape(b, -1)
        inter = ClassifyIntermediates(
            scores=_segment_sums(w, cls, cfg.num_classes),
            keypoints=f.keypoints, descriptors=f.descriptors,
            desc_valid=f.valid, vote_position=votes.position.reshape(b, -1, 3),
            vote_weight=w, vote_class=cls, vote_valid=in_r)
    return inter, votes.instance_id.reshape(b, -1)


def classify_intermediates(points: torch.Tensor,   # [B, N, 3]
                           mask: torch.Tensor,     # [B, N]
                           cb: Codebook, cfg: PipelineConfig,
                           cb_params: CodebookParams,
                           rgb: Optional[torch.Tensor] = None,
                           normals: Optional[torch.Tensor] = None
                           ) -> ClassifyIntermediates:
    """``jax.vmap(classify_intermediates)``: :func:`classify_scores` and
    every stage output, on the dense [B, K] grid (`rgb` for CSHOT;
    `normals` short-circuits the normal stage)."""
    return _classify(points, mask, cb, cfg, cb_params, rgb, normals)[0]


def classify_scores(points: torch.Tensor, mask: torch.Tensor, cb: Codebook,
                    cfg: PipelineConfig, cb_params: CodebookParams,
                    rgb: Optional[torch.Tensor] = None,
                    normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.vmap(classify_scores)``: per-class scores [B, num_classes] by
    the centroid density query (single-object mode)."""
    return classify_intermediates(points, mask, cb, cfg, cb_params, rgb,
                                  normals).scores


def classify_scores_instances(points: torch.Tensor, mask: torch.Tensor,
                              cb: Codebook, cfg: PipelineConfig,
                              cb_params: CodebookParams, num_instances: int,
                              rgb: Optional[torch.Tensor] = None):
    """``jax.vmap(classify_scores_instances)``: (class scores [B, C], the
    same votes' centroid densities per training instance [B,
    num_instances]), both summed in a fixed order."""
    inter, inst = _classify(points, mask, cb, cfg, cb_params, rgb, None)
    return inter.scores, _segment_sums(inter.vote_weight, inst,
                                       num_instances)


def classify_scores_mean_shift(points: torch.Tensor, mask: torch.Tensor,
                               cb: Codebook, cfg: PipelineConfig,
                               cb_params: CodebookParams,
                               seed_capacity: int = SEED_CAPACITY,
                               max_iter: int = MAX_ITER) -> torch.Tensor:
    """``jax.vmap(classify_scores_mean_shift)``: the density of each
    class's best mean-shift maximum [B, C] -- :class:`IsmDetector`'s
    densities."""
    _check_detection(cfg)
    return _detect(points, mask, cb, cfg, cb_params, seed_capacity,
                   max_iter)[0]
