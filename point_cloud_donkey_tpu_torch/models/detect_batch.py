"""The training extraction (port of ``train_fused_eligible``,
``host_voxel_count``, ``_chunk_indices``, ``_fused_extract_dense_program``,
``_extract_local_features_fused_train`` and the staged branch of
``extract_local_features_batch`` of
point_cloud_donkey_tpu/models/detect_batch.py).

Per chunk of clouds padded to one bucket size, one batched torch function
(:func:`extract_chunk`): normals -> voxel-grid keypoints, valid first in
voxel-key order -> SHOT LRFs at the keypoints -> the descriptor of every
keypoint on the dense [B, K] grid (SHOT through K7, CSHOT through K8,
SHORT_SHOT through K9).  The normals are computed on the device
(ops/normals.compute_normals; method 2: the full SHOT LRF of every point,
PCA where it is invalid; methods 0 and 1: the oriented PCA normal) -- the
JAX fused route -- unless a cloud of the chunk carries its own normals or
the method is 3 (EMST on the host): then the chunk takes
models/features.compute_cloud_normals -- the JAX staged route.  A cloud
without normals gets the same normals either way, so the route does not
change its features.  The kept rows' descriptors stay on the device for
the activation (:class:`FusedChunk`); the host reads one packed array per
chunk to build the per-cloud feature sets.  Neither route trains keypoint
culling or the other descriptors (:func:`train_unsupported`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels.shot_fused import shot_descriptor_fused
from ..ops.lrf import shot_lrf
from ..ops.neighbors import full_fp32
from ..ops.normals import compute_normals
from ..ops.shot import cshot_descriptor_dense
from ..ops.short_shot import short_shot_descriptor_dense
from ..ops.voxel_grid import voxel_grid
from .features import (FeatureConfig, bucket_groups, chunk_width,
                       compute_cloud_normals, padded_chunk)
from .keypoints import KeypointParams, culling_disabled
from .types import FeatureSet, make_feature_set


def train_unsupported(fcfg: FeatureConfig, kp_params: KeypointParams
                      ) -> Optional[str]:
    """Why neither training route of the port can extract this
    configuration's features, with the queue that ports it, or None."""
    if fcfg.type not in ("SHOT", "CSHOT", "SHORT_SHOT"):
        return f"descriptor {fcfg.type!r} (the port computes SHOT, CSHOT " \
               "and SHORT_SHOT; the descriptor zoo is ROADMAP A15)"
    if fcfg.ref_frame_type != "SHOT":
        return f"ReferenceFrameType {fcfg.ref_frame_type!r} (SHOT only; " \
               "the LRF variants are ROADMAP A15)"
    if kp_params.type not in ("VoxelGrid", "VoxelGridCulling"):
        return f"keypoint type {kp_params.type!r} (VoxelGrid only; the " \
               "detectors are ROADMAP A13)"
    if not culling_disabled(kp_params, is_training=True):
        return "keypoint culling in training (DisableFilterInTraining " \
               "false; the culling is ROADMAP A13)"
    if fcfg.type == "SHORT_SHOT" and (fcfg.use_min_radius
                                      or fcfg.short_shot_log_radius):
        return "SHORT_SHOT with a minimum or logarithmic radius (ROADMAP " \
               "A15)"
    return None


def host_voxel_count(xyz: np.ndarray, leaf: float) -> int:
    """Occupied-voxel count of the voxel grid, on the host: floor(p / leaf)
    in float32, as the device computes it."""
    q = np.floor(xyz.astype(np.float32) / np.float32(leaf))
    return len(np.unique(q, axis=0))


class FusedChunk(NamedTuple):
    """The device-resident descriptors of one extraction chunk (the JAX
    ``FusedChunkCache``): activation reads the kept rows from here."""
    desc: torch.Tensor   # [len(chunk), k_cap, D] on the device
    chunk: List[int]     # cloud index of each row
    keep: np.ndarray     # [len(chunk), k_cap] host keep masks


def unpack_chunk(desc: torch.Tensor, kp: torch.Tensor, frames: torch.Tensor,
                 keep: torch.Tensor, clouds: Sequence[np.ndarray],
                 chunk: List[int], out: List[Optional[FeatureSet]],
                 device_cache: Optional[List[FusedChunk]]) -> None:
    """One host read of a chunk's grid (descriptors [b, K, D], keypoints,
    frames, keep [b, K]) into the compact feature set of each cloud (the
    keypoints' distances to the cloud's centroid computed on the host);
    the chunk's descriptors go to `device_cache` when given."""
    d = desc.shape[-1]
    packed = torch.cat([desc, kp, frames.reshape(*kp.shape[:2], 9),
                        keep[..., None].to(desc.dtype)], -1).cpu().numpy()
    keeps = packed[..., d + 12] > 0
    for r, ci in enumerate(chunk):
        kp_r = packed[r, :, d:d + 3]
        centroid = clouds[ci].mean(axis=0)
        center_dist = np.linalg.norm(kp_r - centroid, axis=1)
        out[ci] = make_feature_set(
            packed[r, :, :d], kp_r,
            packed[r, :, d + 3:d + 12].reshape(-1, 3, 3), keeps[r],
            center_dist).compact()
    if device_cache is not None:
        device_cache.append(FusedChunk(desc=desc, chunk=list(chunk),
                                       keep=keeps))


def extract_chunk(pts: torch.Tensor,    # [B, n, 3], padding parked at 1e9
                  mask: torch.Tensor,   # [B, n]
                  rgb: Optional[torch.Tensor],  # [B, n, 3] (CSHOT)
                  k_cap: int, fcfg: FeatureConfig, leaf: float,
                  normal_radius: float, n_method: int, lrf_version: int = 1,
                  normals: Optional[torch.Tensor] = None  # [B, n, 3]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One chunk of the fused extraction (`_fused_extract_dense_program`):
    (descriptors [B, k_cap, D], keypoints [B, k_cap, 3], frames [B, k_cap,
    3, 3], keep [B, k_cap]).  Keypoints are the voxel centroids, valid
    first in voxel-key order; rows not kept carry a zero descriptor and
    keypoint and the identity frame."""
    with full_fp32():
        if fcfg.needs_normals():
            nrm = normals if normals is not None else compute_normals(
                pts, mask, normal_radius, n_method, lrf_version).normals
            nrm = torch.where(mask[..., None], nrm, torch.zeros_like(nrm))
        else:
            nrm = torch.zeros_like(pts)
        res = voxel_grid(pts, mask, leaf, capacity=k_cap,
                         features=rgb if fcfg.needs_rgb() else None)
        kpm = res.mask
        xyz = res.centroids[..., :3]
        kp = torch.where(kpm[..., None], xyz, torch.full_like(xyz, 1e9))
        lrf = shot_lrf(kp, kpm, pts, mask, fcfg.ref_frame_radius,
                       lrf_version=lrf_version)
        if fcfg.type == "SHOT":
            desc, valid = shot_descriptor_fused(kp, lrf.frames, lrf.valid,
                                                pts, nrm, mask, fcfg.radius)
        elif fcfg.type == "CSHOT":
            desc, valid = cshot_descriptor_dense(
                kp, res.centroids[..., 3:6], lrf.frames, lrf.valid, pts, nrm,
                rgb, mask, fcfg.radius)
        else:
            _, rb, eb, ab = fcfg.short_shot_bins()
            desc, valid = short_shot_descriptor_dense(
                kp, lrf.frames, lrf.valid, pts, mask, fcfg.radius, rb, eb, ab)
        keep = valid & torch.isfinite(desc).all(-1) & kpm
        desc = torch.where(keep[..., None], desc, torch.zeros_like(desc))
        eye = torch.eye(3, dtype=lrf.frames.dtype, device=lrf.frames.device)
        frames = torch.where(keep[..., None, None], lrf.frames, eye)
        kp = torch.where(keep[..., None], kp, torch.zeros_like(kp))
    return desc, kp, frames, keep


def extract_local_features_batch(
        clouds: Sequence[np.ndarray],
        normals_list: Sequence[Optional[np.ndarray]],
        rgb_list: Sequence[Optional[np.ndarray]],
        fcfg: FeatureConfig, kp_params: KeypointParams, normal_radius: float,
        consistent_normals_method: int, device: torch.device,
        lrf_version: int = 1,
        device_cache: Optional[List[FusedChunk]] = None
        ) -> List[FeatureSet]:
    """The per-cloud compact feature sets of the training extraction:
    clouds grouped by bucket size, chunks of at most 8-32 clouds (the JAX
    chunk width rule), the keypoint capacity the group's largest exact
    voxel count rounded up to a multiple of 64; each chunk one
    :func:`extract_chunk`, its normals as the module docstring says.  Each
    chunk's kept descriptors go to `device_cache` when given.  A chunk is
    not padded to its width: each cloud's result is independent of the
    rest of its chunk."""
    if fcfg.needs_rgb() and any(r is None for r in rgb_list):
        raise ValueError(f"{fcfg.type} needs RGB data but a cloud has none")
    out: List[Optional[FeatureSet]] = [None] * len(clouds)
    chunks = bucket_groups(clouds, chunk_width(len(clouds)))
    caps: Dict[int, int] = {}
    for n, chunk in chunks:
        caps[n] = max(caps.get(n, 64), -(-max(
            host_voxel_count(clouds[i], kp_params.leaf_size)
            for i in chunk) // 64) * 64)
    for n, chunk in chunks:
        pts_b, mask_b, rgb_b = padded_chunk(
            clouds, chunk, n, rgb_list if fcfg.needs_rgb() else None)
        pts = torch.from_numpy(pts_b).to(device)
        mask = torch.from_numpy(mask_b).to(device)
        nrm = None
        if fcfg.needs_normals() and (
                consistent_normals_method == 3
                or any(normals_list[ci] is not None for ci in chunk)):
            nrm = compute_cloud_normals(
                clouds, normals_list, chunk, pts, mask, normal_radius,
                consistent_normals_method, lrf_version)
        desc, kp, frames, keep = extract_chunk(
            pts, mask,
            None if rgb_b is None else torch.from_numpy(rgb_b).to(device),
            caps[n], fcfg, float(kp_params.leaf_size), float(normal_radius),
            int(consistent_normals_method), lrf_version, nrm)
        unpack_chunk(desc, kp, frames, keep, clouds, chunk, out,
                     device_cache)
    return out  # type: ignore[return-value]
