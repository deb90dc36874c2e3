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

Scene scale (above ``ops.tiled.SCENE_TILE_THRESHOLD`` points, read at call
time): :func:`scene_normals` and :func:`extract_local_features_scene` (the
JAX ``_compute_normals_scene`` and ``_extract_local_features_scene``) sort
the cloud once along its longest axis and run every [Q, N] stage on the
windows of ops/tiled.py: the normals in NORMALS_CHUNK queries, the voxel
grid (and its culling, models/keypoints.py) on the sorted cloud, so the
keypoints' float sums are the JAX package's, then the keypoints sorted
along the same axis in KEYPOINT_CHUNK chunks, planned at max(Radius,
ReferenceFrameRadius) with a window of at least 4096 points: each group
of chunks is one batch of K1 / K2 (the LRFs) and K7 / K8 / K9 (the
descriptor) over the chunks' window slabs.  A scene's global descriptor
takes its normals from the same tiled route; its one centroid keypoint
stays dense.
"""

from __future__ import annotations

from dataclasses import dataclass
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import tiled
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


def local_descriptors(fcfg: FeatureConfig, kp, kpm, kp_rgb, pts, nrm, rgb,
                      mask, radius: float, lrf_version: int = 1):
    """(descriptors [B, K, D], valid [B, K], frames [B, K, 3, 3]) of the
    keypoint rows `kp` [B, K, 3] (live where `kpm`) against their clouds
    [B, N]: the SHOT LRF at ReferenceFrameRadius (K1 / K2), then the
    descriptor of `fcfg`'s local type at `radius` (K7, K8, K9).  valid
    also requires a finite descriptor."""
    lrf = shot_lrf(kp, kpm, pts, mask, fcfg.ref_frame_radius,
                   lrf_version=lrf_version)
    base = fcfg.local_type
    if base == "SHOT":
        desc, valid = shot_descriptor_fused(kp, lrf.frames, lrf.valid, pts,
                                            nrm, mask, radius)
    elif base == "CSHOT":
        desc, valid = cshot_descriptor_dense(kp, kp_rgb, lrf.frames,
                                             lrf.valid, pts, nrm, rgb, mask,
                                             radius)
    else:
        _, rb, eb, ab = fcfg.short_shot_bins()
        desc, valid = short_shot_descriptor_dense(kp, lrf.frames, lrf.valid,
                                                  pts, mask, radius, rb, eb,
                                                  ab)
    return desc, valid & torch.isfinite(desc).all(-1), lrf.frames


def scene_normals(xyz: np.ndarray, normals_in: Optional[np.ndarray],
                  normal_radius: float, method: int, device: torch.device,
                  lrf_version: int = 1, emst: bool = True) -> np.ndarray:
    """A scene's normals [N, 3] (the JAX ``compute_cloud_normals`` above
    the threshold): provided ones as given, else sorted along the longest
    axis, the tiled normals of ConsistentNormalsMethod `method` (with
    `emst`, method 3 as method 0's PCA normals oriented by
    :func:`orient_emst` on the host), un-permuted."""
    if normals_in is not None and len(normals_in) == len(xyz):
        return np.asarray(normals_in, np.float32)
    tiled.check_lrf_version(lrf_version)
    n_real = len(xyz)
    axis = tiled.sort_key_axis(xyz)
    order = np.argsort(xyz[:, axis], kind="stable")
    xyz_s = xyz[order]
    pts, mask = pad_cloud(xyz_s)   # the padding at 1e9 keeps the order
    key = pts[:, axis]
    plan = tiled.plan_tiles(key, mask, key, normal_radius,
                            tiled.NORMALS_CHUNK)
    orient = emst and method == 3
    with full_fp32():
        res = tiled.tiled_compute_normals(
            torch.from_numpy(pts).to(device),
            torch.from_numpy(mask).to(device), plan, normal_radius,
            0 if orient else method, lrf_version)
    nrm_s = res.normals.cpu().numpy()[:n_real]
    if orient:
        nrm_s = orient_emst(xyz_s, nrm_s).astype(np.float32)
    out = np.empty_like(nrm_s)
    out[order] = nrm_s
    return out


def extract_local_features_scene(
        xyz: np.ndarray, normals: Optional[np.ndarray],
        rgb: Optional[np.ndarray], fcfg: FeatureConfig, kp_params,
        normal_radius: float, consistent_normals_method: int,
        device: torch.device, lrf_version: int = 1,
        is_training: bool = False,
        times: Optional[Dict[str, float]] = None):
    """One scene's local features (module docstring): (the compact feature
    set, the descriptors of every keypoint row [1, K, D] on the device with
    zeros where not kept, keep [1, K] on the host).  `times` accumulates
    the normals and keypoints stages' wall times."""
    from .keypoints import culling_needs_normals, detect_keypoints
    tiled.check_lrf_version(lrf_version)
    axis = tiled.sort_key_axis(xyz)
    order = np.argsort(xyz[:, axis], kind="stable")
    xyz_s = np.ascontiguousarray(xyz[order], np.float32)
    normals_s = None if normals is None else np.asarray(normals)[order]
    rgb_s = None if rgb is None else np.asarray(rgb, np.float32)[order]
    if fcfg.needs_rgb() and rgb_s is None:
        raise ValueError(f"{fcfg.type} needs RGB data but the cloud has none")

    cloud_normals = None
    if fcfg.needs_normals() or culling_needs_normals(kp_params,
                                                     is_training):
        t0 = time.perf_counter()
        cloud_normals = scene_normals(xyz_s, normals_s, normal_radius,
                                      consistent_normals_method, device,
                                      lrf_version)
        if times is not None:
            times["normals"] = times.get("normals", 0.0) \
                + time.perf_counter() - t0

    t0 = time.perf_counter()
    with full_fp32():
        kp, kp_rgb = detect_keypoints(xyz_s, cloud_normals, rgb_s, kp_params,
                                      device, is_training)
    if times is not None:
        times["keypoints"] = times.get("keypoints", 0.0) \
            + time.perf_counter() - t0

    # the keypoints sorted along the same axis: chunks get tight windows
    kp_order = np.argsort(kp[:, axis], kind="stable")
    kp = kp[kp_order]
    if kp_rgb is not None:
        kp_rgb = kp_rgb[kp_order]
    pts, mask = pad_cloud(xyz_s)
    n = pts.shape[0]
    chunk = tiled.KEYPOINT_CHUNK
    n_chunks = max(1, -(-len(kp) // chunk))
    k_bucket = n_chunks * chunk
    kp_pad = np.full((k_bucket, 3), 1e9, np.float32)
    kp_pad[:len(kp)] = kp
    kp_mask = np.zeros(k_bucket, bool)
    kp_mask[:len(kp)] = True
    plan = tiled.plan_tiles(kp_pad[:, axis], kp_mask, pts[:, axis],
                            max(fcfg.radius, fcfg.ref_frame_radius), chunk,
                            min_window=4096)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    nrm = np.zeros((n, 3), np.float32)
    if fcfg.needs_normals() and cloud_normals is not None:
        nrm[:len(xyz_s)] = cloud_normals
    rgb_p = np.zeros((n, 3), np.float32)
    kp_rgb_p = np.zeros((k_bucket, 3), np.float32)
    if fcfg.needs_rgb():
        rgb_p[:len(xyz_s)] = rgb_s
        if kp_rgb is not None:
            kp_rgb_p[:len(kp)] = kp_rgb
    pts_d, mask_d, nrm_d, rgb_d = dev(pts), dev(mask), dev(nrm), dev(rgb_p)
    kp_d, kpm_d, kprgb_d = dev(kp_pad), dev(kp_mask), dev(kp_rgb_p)
    d = fcfg.descriptor_dim()

    def inner(qs, ps):
        q, qm, qr = qs
        p, pm, pn, pr = ps
        desc, valid, frames = local_descriptors(
            fcfg, q, qm, qr if fcfg.needs_rgb() else None, p, pn,
            pr if fcfg.needs_rgb() else None, pm, fcfg.radius, lrf_version)
        return desc, valid & qm, frames

    with full_fp32():
        desc, keep, frames = tiled.map_chunks(
            inner, (kp_d, kpm_d, kprgb_d), (1e9, False, 0.0),
            (pts_d, mask_d, nrm_d, rgb_d), plan, q_valid=kpm_d,
            row_bytes=40)
        desc = torch.where(keep[:, None], desc, torch.zeros_like(desc))
    packed = torch.cat([desc, frames.reshape(-1, 9),
                        keep[:, None].to(desc.dtype)], 1).cpu().numpy()
    keep_h = packed[:, d + 9] > 0
    centroid = xyz.mean(axis=0)
    center_dist = np.linalg.norm(kp_pad - centroid, axis=1)
    fs = make_feature_set(packed[:, :d], kp_pad,
                          packed[:, d:d + 9].reshape(-1, 3, 3), keep_h,
                          center_dist).compact()
    return fs, desc[None], keep_h[None]


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
    batched per chunk (a scene's: :func:`scene_normals`, without EMST, as
    the JAX global normals stage); the descriptor is one launch per
    cloud."""
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
            if not gcfg.needs_normals():
                nrm = torch.zeros_like(pts)
            elif n > tiled.SCENE_TILE_THRESHOLD:
                nrm_b = np.zeros(pts_b.shape, np.float32)
                for r, ci in enumerate(chunk):
                    nrm_b[r, :len(clouds[ci])] = scene_normals(
                        clouds[ci], normals_list[ci], normal_radius,
                        consistent_normals_method, device, lrf_version,
                        emst=False)
                nrm = torch.from_numpy(nrm_b).to(device)
            else:
                nrm = compute_cloud_normals(
                    clouds, normals_list, chunk, pts, mask, normal_radius,
                    consistent_normals_method, lrf_version, emst=False)
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
                desc, valid, frame = local_descriptors(
                    gcfg, kp, torch.ones((1, 1), dtype=torch.bool,
                                         device=device), kp_rgb,
                    pts[r:r + 1], nrm[r:r + 1],
                    None if rgb is None else rgb[r:r + 1], mask[r:r + 1],
                    radius, lrf_version)
                out[ci] = make_feature_set(
                    desc[0].cpu().numpy(), centroid[None],
                    frame[0].cpu().numpy(), valid[0].cpu().numpy(),
                    np.zeros(1, np.float32),
                    np.full(1, radius, np.float32)).compact()
    return out  # type: ignore[return-value]
