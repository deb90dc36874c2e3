"""The fused training extraction (port of ``train_fused_eligible``,
``host_voxel_count``, ``_chunk_indices``, ``_fused_extract_dense_program``
and ``_extract_local_features_fused_train`` of
point_cloud_donkey_tpu/models/detect_batch.py).

Per chunk of clouds padded to one bucket size, one batched torch function:
normals (ops/normals.compute_normals; method 2: the full SHOT LRF of every
point, PCA where it is invalid; methods 0 and 1: the oriented PCA normal)
-> voxel-grid keypoints, valid first in voxel-key order -> SHOT
LRFs at the keypoints -> the descriptor of every keypoint on the dense
[B, K] grid (SHOT through K7, CSHOT through K8, SHORT_SHOT through K9).
The kept rows' descriptors stay on the device for the activation
(:class:`FusedChunk`); the host reads one packed array per chunk to build
the per-cloud feature sets.  This is the route the JAX package trains on
accelerators; its staged route (provided normals, normals method 3,
keypoint culling, the other descriptors) is not ported.
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
from .features import FeatureConfig, bucket_size, pad_cloud
from .keypoints import KeypointParams, culling_disabled
from .types import FeatureSet, make_feature_set


def train_fused_ineligible(fcfg: FeatureConfig, kp_params: KeypointParams,
                           normals_list: Sequence[Optional[np.ndarray]],
                           consistent_normals_method: int) -> Optional[str]:
    """Why the fused route cannot train this configuration (the conditions
    of the JAX ``train_fused_eligible`` and of the batched path), or None
    when it can."""
    if fcfg.type not in ("SHOT", "CSHOT", "SHORT_SHOT"):
        return f"descriptor {fcfg.type!r} (the fused route computes SHOT, " \
               "CSHOT and SHORT_SHOT)"
    if fcfg.ref_frame_type != "SHOT":
        return f"ReferenceFrameType {fcfg.ref_frame_type!r} (SHOT only)"
    if kp_params.type not in ("VoxelGrid", "VoxelGridCulling"):
        return f"keypoint type {kp_params.type!r} (VoxelGrid only)"
    if not culling_disabled(kp_params, is_training=True):
        return "keypoint culling in training"
    if any(nl is not None for nl in normals_list):
        return "normals provided by the cloud files"
    if fcfg.needs_normals() and consistent_normals_method == 3:
        return "ConsistentNormalsMethod 3 (its EMST orientation runs on " \
               "the staged route)"
    if fcfg.type == "SHORT_SHOT" and (fcfg.use_min_radius
                                      or fcfg.short_shot_log_radius):
        return "SHORT_SHOT with a minimum or logarithmic radius"
    return None


def host_voxel_count(xyz: np.ndarray, leaf: float) -> int:
    """Occupied-voxel count of the voxel grid, on the host: floor(p / leaf)
    in float32, as the device computes it."""
    q = np.floor(xyz.astype(np.float32) / np.float32(leaf))
    return len(np.unique(q, axis=0))


def _chunk_indices(order: List[int], width: int) -> List[List[int]]:
    return [order[i:i + width] for i in range(0, len(order), width)]


class FusedChunk(NamedTuple):
    """The device-resident descriptors of one extraction chunk (the JAX
    ``FusedChunkCache``): activation reads the kept rows from here."""
    desc: torch.Tensor   # [len(chunk), k_cap, D] on the device
    chunk: List[int]     # cloud index of each row
    keep: np.ndarray     # [len(chunk), k_cap] host keep masks


def extract_chunk(pts: torch.Tensor,    # [B, n, 3], padding parked at 1e9
                  mask: torch.Tensor,   # [B, n]
                  rgb: Optional[torch.Tensor],  # [B, n, 3] (CSHOT)
                  k_cap: int, fcfg: FeatureConfig, leaf: float,
                  normal_radius: float, n_method: int, lrf_version: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One chunk of the fused extraction (`_fused_extract_dense_program`):
    (descriptors [B, k_cap, D], keypoints [B, k_cap, 3], frames [B, k_cap,
    3, 3], keep [B, k_cap]).  Keypoints are the voxel centroids, valid
    first in voxel-key order; rows not kept carry a zero descriptor and
    keypoint and the identity frame."""
    with full_fp32():
        if fcfg.needs_normals():
            nrm = compute_normals(pts, mask, normal_radius, n_method,
                                  lrf_version).normals
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


def extract_features_fused_train(
        clouds: Sequence[np.ndarray], rgb_list: Sequence[Optional[np.ndarray]],
        fcfg: FeatureConfig, kp_params: KeypointParams, normal_radius: float,
        consistent_normals_method: int, chunk_width: int,
        device: torch.device, lrf_version: int = 1,
        device_cache: Optional[List[FusedChunk]] = None
        ) -> List[FeatureSet]:
    """The per-cloud compact feature sets of the fused training extraction
    (`_extract_local_features_fused_train`): clouds grouped by bucket size,
    chunks of at most 8-32 clouds (the JAX chunk width rule), the keypoint
    capacity the group's largest exact voxel count rounded up to a multiple
    of 64.  Each chunk's kept descriptors go to `device_cache` when given.
    A chunk is not padded to its width: each cloud's result is independent
    of the rest of its chunk."""
    if fcfg.needs_rgb() and any(r is None for r in rgb_list):
        raise ValueError(f"{fcfg.type} needs RGB data but a cloud has none")
    mb = min(32, max(8, -(-chunk_width // 8) * 8))
    out: List[Optional[FeatureSet]] = [None] * len(clouds)
    groups: Dict[int, List[int]] = {}
    for i, xyz in enumerate(clouds):
        groups.setdefault(bucket_size(len(xyz)), []).append(i)
    for n, idxs in groups.items():
        k_cap = max(64, -(-max(host_voxel_count(clouds[i],
                                                kp_params.leaf_size)
                               for i in idxs) // 64) * 64)
        for chunk in _chunk_indices(idxs, width=mb):
            pts_b = np.zeros((len(chunk), n, 3), np.float32)
            mask_b = np.zeros((len(chunk), n), bool)
            rgb_b = np.zeros((len(chunk), n, 3), np.float32)
            for r, ci in enumerate(chunk):
                pts_b[r], mask_b[r] = pad_cloud(clouds[ci], bucket=n)
                if fcfg.needs_rgb():
                    rgb_b[r, :len(clouds[ci])] = rgb_list[ci]
            rgb_t = (torch.from_numpy(rgb_b).to(device) if fcfg.needs_rgb()
                     else None)
            desc, kp, frames, keep = extract_chunk(
                torch.from_numpy(pts_b).to(device),
                torch.from_numpy(mask_b).to(device), rgb_t, k_cap, fcfg,
                float(kp_params.leaf_size), float(normal_radius),
                int(consistent_normals_method), lrf_version)
            # the chunk's one host read
            d = desc.shape[-1]
            packed = torch.cat([desc, kp, frames.reshape(*kp.shape[:2], 9),
                                keep[..., None].to(desc.dtype)],
                               -1).cpu().numpy()
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
    return out  # type: ignore[return-value]
