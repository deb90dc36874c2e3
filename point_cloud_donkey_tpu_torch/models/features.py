"""Descriptor configuration, cloud padding, the training extraction's
chunk helpers and normals, and the global features (port of
``FeatureConfig``, ``bucket_size``, ``pad_cloud``,
``compute_cloud_normals`` and ``extract_global_features`` of
point_cloud_donkey_tpu/models/features.py, for the descriptors the port
computes: SHOT, CSHOT and SHORT_SHOT, and their *_GLOBAL forms).

:func:`compute_cloud_normals` gives the normals of the JAX staged route
(normals provided by the cloud files, ConsistentNormalsMethod 3's EMST
orientation on the host) to the training extraction
(models/detect_batch.py).

A global descriptor (:func:`extract_global_features`) is the local
descriptor at the cloud's centroid with the cloud's radius, so every point
of the cloud is a neighbour; its LRF is taken at the centroid with
ReferenceFrameRadius, and CSHOT_GLOBAL's keypoint colour is the cloud's
mean colour.  The descriptor kernels take one radius a launch, so each
cloud is one launch of K7, K8 or K9 (with its K1 / K2 LRF).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.lrf import shot_lrf
from ..ops.neighbors import full_fp32
from ..ops.normals import compute_normals, orient_emst
from ..ops.kernels.shot_fused import shot_descriptor_fused
from ..ops.shot import cshot_descriptor_dense
from ..ops.short_shot import resolve_bins, short_shot_descriptor_dense
from ..utils.config import ComponentConfig
from .types import FeatureSet, make_feature_set

DESCRIPTORS = ("SHOT", "CSHOT", "SHORT_SHOT")
GLOBAL_DESCRIPTORS = ("Dummy", "SHOT_GLOBAL", "CSHOT_GLOBAL",
                      "SHORT_SHOT_GLOBAL")


def bucket_size(n: int, minimum: int = 256) -> int:
    """The next power of two at or above n (at least `minimum`); above 64k,
    the next multiple of 32768."""
    b = minimum
    while b < n and b < 65536:
        b *= 2
    if n <= b:
        return b
    return -(-n // 32768) * 32768


@dataclass(frozen=True)
class FeatureConfig:
    """The ``Features`` component of an .ism config (the SHOT, CSHOT and
    SHORT_SHOT fields of the JAX FeatureConfig)."""
    type: str = "SHOT"
    radius: float = 0.1
    ref_frame_radius: float = 0.2
    ref_frame_type: str = "SHOT"
    # SHORT_SHOT (features_short_shot.cpp:23-31)
    short_shot_dims: int = 32
    short_shot_bin_type: str = "auto"
    short_shot_r_bins: int = 2
    short_shot_e_bins: int = 2
    short_shot_a_bins: int = 8
    short_shot_log_radius: bool = False
    short_shot_min_radius: float = 0.0
    use_min_radius: bool = False

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "FeatureConfig":
        return cls(
            type=cfg.type or "SHOT",
            radius=cfg.get("Radius", 0.1),
            ref_frame_radius=cfg.get("ReferenceFrameRadius", 0.2),
            ref_frame_type=cfg.get("ReferenceFrameType", "SHOT"),
            short_shot_dims=cfg.get("ShortShotDims", 32),
            short_shot_bin_type=cfg.get("ShortShotBinType", "auto"),
            short_shot_r_bins=cfg.get("ShortShotRBins", 2),
            short_shot_e_bins=cfg.get("ShortShotEBins", 2),
            short_shot_a_bins=cfg.get("ShortShotABins", 8),
            short_shot_log_radius=cfg.get("ShortShotLogRadius", False),
            short_shot_min_radius=cfg.get("ShortShotMinRadius", 0.0),
            use_min_radius=cfg.get("UseMinRadius", False),
        )

    @property
    def local_type(self) -> str:
        """The local descriptor of a *_GLOBAL type (the type itself
        otherwise)."""
        return self.type[:-len("_GLOBAL")] if self.type.endswith("_GLOBAL") \
            else self.type

    def needs_normals(self) -> bool:
        return self.local_type not in ("SHORT_SHOT", "Dummy")

    def needs_rgb(self) -> bool:
        return self.local_type == "CSHOT"

    def short_shot_bins(self) -> Tuple[int, int, int, int]:
        """(dims, r_bins, e_bins, a_bins) of the SHORT_SHOT grid."""
        return resolve_bins(self.short_shot_dims, self.short_shot_bin_type,
                            self.short_shot_r_bins, self.short_shot_e_bins,
                            self.short_shot_a_bins)

    def descriptor_dim(self) -> int:
        if self.local_type == "SHOT":
            return 352
        if self.local_type == "CSHOT":
            return 1344
        if self.local_type == "SHORT_SHOT":
            return self.short_shot_bins()[0]
        raise NotImplementedError(
            f"descriptor {self.type!r}: the port computes "
            f"{', '.join(DESCRIPTORS + GLOBAL_DESCRIPTORS)}")


def pad_cloud(xyz: np.ndarray, bucket: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """A cloud padded to its bucket: (points [b, 3] with the padding parked
    at 1e9, mask [b])."""
    n = len(xyz)
    b = bucket or bucket_size(n)
    pts = np.zeros((b, 3), np.float32)
    pts[:n] = xyz
    pts[n:] = 1e9
    mask = np.zeros(b, bool)
    mask[:n] = True
    return pts, mask


def chunk_width(n_clouds: int) -> int:
    """Clouds of one extraction chunk: the JAX chunk width rule, 8 to 32."""
    return min(32, max(8, -(-n_clouds // 8) * 8))


def bucket_groups(clouds: Sequence[np.ndarray], width: int
                  ) -> List[Tuple[int, List[int]]]:
    """(bucket size, cloud indices) of each chunk: clouds grouped by bucket
    size, in order, each group cut into chunks of at most `width`."""
    groups = {}
    for i, xyz in enumerate(clouds):
        groups.setdefault(bucket_size(len(xyz)), []).append(i)
    return [(n, idxs[i:i + width]) for n, idxs in groups.items()
            for i in range(0, len(idxs), width)]


def padded_chunk(clouds: Sequence[np.ndarray], chunk: Sequence[int], n: int,
                 per_point: Optional[Sequence[Optional[np.ndarray]]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(points [b, n, 3] with the padding at 1e9, mask [b, n], the
    clouds' `per_point` arrays [b, n, 3] zero-padded, or None)."""
    pts = np.zeros((len(chunk), n, 3), np.float32)
    mask = np.zeros((len(chunk), n), bool)
    extra = None if per_point is None else \
        np.zeros((len(chunk), n, 3), np.float32)
    for r, ci in enumerate(chunk):
        pts[r], mask[r] = pad_cloud(clouds[ci], bucket=n)
        if extra is not None:
            extra[r, :len(clouds[ci])] = per_point[ci]
    return pts, mask, extra


def compute_cloud_normals(clouds: Sequence[np.ndarray],
                          normals_list: Sequence[Optional[np.ndarray]],
                          chunk: Sequence[int], pts: torch.Tensor,
                          mask: torch.Tensor, normal_radius: float,
                          method: int, lrf_version: int = 1,
                          emst: bool = True) -> torch.Tensor:
    """The normals [b, n, 3] of a padded chunk of clouds (the JAX
    ``compute_cloud_normals`` / ``_batch_normals``): a cloud's provided
    normals as given (the reference's normal check,
    implicit_shape_model.cpp:374-384), the others from
    ``ops/normals.compute_normals`` under `method` -- with `emst`, method 3
    as method 0's PCA normals oriented by :func:`orient_emst` on the host
    (the local features); without, the PCA normal as it comes (the JAX
    global features' normal stage).  Padding rows are zero."""
    provided = [normals_list[ci] is not None
                and len(normals_list[ci]) == len(clouds[ci]) for ci in chunk]
    orient = emst and method == 3
    comp = None
    if not all(provided):
        comp = compute_normals(pts, mask, normal_radius,
                               0 if orient else method,
                               lrf_version).normals.cpu().numpy()
    out = np.zeros(tuple(pts.shape), np.float32)
    for r, ci in enumerate(chunk):
        m = len(clouds[ci])
        if provided[r]:
            out[r, :m] = normals_list[ci]
        elif orient:
            out[r, :m] = orient_emst(clouds[ci], comp[r, :m])
        else:
            out[r, :m] = comp[r, :m]
    return torch.from_numpy(out).to(pts.device)


def _global_descriptor(gcfg: FeatureConfig, kp, kp_rgb, pts, nrm, rgb,
                       mask, radius: float, lrf_version: int):
    """(descriptor [1, 1, D], valid [1, 1], frame [1, 1, 3, 3]) of one
    cloud at one keypoint."""
    kpm = torch.ones(kp.shape[:2], dtype=torch.bool, device=kp.device)
    lrf = shot_lrf(kp, kpm, pts, mask, gcfg.ref_frame_radius,
                   lrf_version=lrf_version)
    base = gcfg.local_type
    if base == "SHOT":
        desc, valid = shot_descriptor_fused(kp, lrf.frames, lrf.valid, pts,
                                            nrm, mask, radius)
    elif base == "CSHOT":
        res = cshot_descriptor_dense(kp, kp_rgb, lrf.frames, lrf.valid, pts,
                                     nrm, rgb, mask, radius)
        desc, valid = res.descriptors, res.valid
    else:
        _, rb, eb, ab = gcfg.short_shot_bins()
        res = short_shot_descriptor_dense(kp, lrf.frames, lrf.valid, pts,
                                          mask, radius, rb, eb, ab)
        desc, valid = res.descriptors, res.valid
    return desc, valid & torch.isfinite(desc).all(-1), lrf.frames


def extract_global_features(
        clouds: Sequence[np.ndarray],
        normals_list: Sequence[Optional[np.ndarray]],
        rgb_list: Sequence[Optional[np.ndarray]],
        gcfg: FeatureConfig, normal_radius: float,
        consistent_normals_method: int, device: torch.device,
        lrf_version: int = 1) -> List[FeatureSet]:
    """Each cloud's global feature set (the JAX ``extract_global_features``
    for Dummy and the *_GLOBAL descriptors): Dummy gives none; otherwise one
    row, the descriptor at the centroid (module docstring) with
    ``global_radius`` the cloud radius, dropped when invalid.  The normals
    are a cloud's provided ones or ``compute_normals`` under the method,
    batched per chunk; the descriptor is one launch per cloud."""
    if gcfg.type == "Dummy":
        return [make_feature_set(np.zeros((0, 1), np.float32),
                                 np.zeros((0, 3), np.float32),
                                 np.zeros((0, 3, 3), np.float32),
                                 np.zeros(0, bool)) for _ in clouds]
    if gcfg.type not in GLOBAL_DESCRIPTORS:
        raise NotImplementedError(
            f"global features {gcfg.type!r}: the port computes "
            f"{', '.join(GLOBAL_DESCRIPTORS)}; the whole-cloud ones wait on "
            "the descriptor zoo (ROADMAP A15)")
    if gcfg.needs_rgb() and any(r is None for r in rgb_list):
        raise ValueError(f"{gcfg.type} needs RGB data but a cloud has none")
    out: List[Optional[FeatureSet]] = [None] * len(clouds)
    for n, chunk in bucket_groups(clouds, chunk_width(len(clouds))):
        pts_b, mask_b, rgb_b = padded_chunk(
            clouds, chunk, n, rgb_list if gcfg.needs_rgb() else None)
        pts = torch.from_numpy(pts_b).to(device)
        mask = torch.from_numpy(mask_b).to(device)
        with full_fp32():
            nrm = compute_cloud_normals(
                clouds, normals_list, chunk, pts, mask, normal_radius,
                consistent_normals_method, lrf_version, emst=False) \
                if gcfg.needs_normals() else torch.zeros_like(pts)
            rgb = None if rgb_b is None else torch.from_numpy(rgb_b).to(device)
            for r, ci in enumerate(chunk):
                xyz = clouds[ci]
                centroid = xyz.mean(axis=0).astype(np.float32)
                radius = float(np.linalg.norm(xyz - centroid, axis=1).max())
                kp = torch.from_numpy(centroid[None, None]).to(device)
                kp_rgb = None
                if rgb is not None:
                    kp_rgb = torch.from_numpy(np.asarray(
                        rgb_list[ci].mean(axis=0), np.float32)[None, None]
                    ).to(device)
                desc, valid, frame = _global_descriptor(
                    gcfg, kp, kp_rgb, pts[r:r + 1], nrm[r:r + 1],
                    None if rgb is None else rgb[r:r + 1], mask[r:r + 1],
                    radius, lrf_version)
                out[ci] = make_feature_set(
                    desc[0].cpu().numpy(), centroid[None],
                    frame[0].cpu().numpy(), valid[0].cpu().numpy(),
                    np.zeros(1, np.float32),
                    np.full(1, radius, np.float32)).compact()
    return out  # type: ignore[return-value]
