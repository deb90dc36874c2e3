"""The batched feature extraction of training and detection (port of
``train_fused_eligible``, ``host_voxel_count``, ``_chunk_indices``,
``_fused_extract_dense_program``, ``_extract_local_features_fused_train``
and ``extract_local_features_batch`` of
point_cloud_donkey_tpu/models/detect_batch.py).

Per chunk of clouds padded to one bucket size, one batched torch function
(:func:`extract_chunk`): normals -> voxel-grid keypoints, valid first in
voxel-key order -> (VoxelGridCulling: the culling scores of the chunk on
the device in one go, models/keypoints.culling_scores, then the
thresholds and the refinement row by row on the host,
models/keypoints.apply_culling_host) -> SHOT LRFs at the keypoints -> the
descriptor of every keypoint on the dense [B, K] grid (SHOT through K7,
CSHOT through K8, SHORT_SHOT through K9, FPFH and SHORT_CSHOT over
neighbour gathers).  The normals are computed on the
device (ops/normals.compute_normals; method 2: the full SHOT LRF of every
point, PCA where it is invalid; methods 0 and 1: the oriented PCA normal)
-- the JAX fused route -- unless a cloud of the chunk carries its own
normals or the method is 3 (EMST on the host): then the chunk takes
models/features.compute_cloud_normals -- the JAX staged route.  A cloud
without normals gets the same normals either way, so the route does not
change its features.  Gaussian and KPQ culling compute normals even where
the descriptor reads none.  A cloud above ``ops.tiled.SCENE_TILE_THRESHOLD``
points takes the scene route of one cloud
(models/features.extract_local_features_scene), decided per cloud; the
order of the clouds is kept.  The kept rows' descriptors stay on the
device for the activation (:class:`FusedChunk`); the host reads one packed
array per chunk to build the per-cloud feature sets.  With a keypoint
detector (Harris3D, ISS3D, SIFT3D: the JAX per-cloud route) each cloud's
keypoints come from models/keypoints.detector_mask over the chunk's
normals, and the chunk's descriptors are computed on them.  The
descriptors and LRFs the port does not compute are refused
(:func:`extraction_unsupported`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import tiled
from ..ops.neighbors import full_fp32
from ..ops.normals import compute_normals
from ..ops.voxel_grid import voxel_grid
from .features import (DESCRIPTORS, FeatureConfig, bucket_groups,
                       chunk_width, compute_cloud_normals,
                       extract_local_features_scene, local_descriptors,
                       padded_chunk)
from .keypoints import (DETECTORS, KeypointParams, apply_culling_host,
                        check_culling_methods, culling_disabled,
                        culling_needs_normals, culling_scores,
                        detector_mask)
from .types import FeatureSet, make_feature_set


# the descriptors still to port, each with its ROADMAP queue item
UNPORTED_DESCRIPTORS = {
    **{t: "A15.4" for t in ("BSHOT", "PFH", "SpinImage", "3DSC", "USC",
                            "USC_GLOBAL", "RSD", "RoPS", "COSPAIR", "RIFT",
                            "ESF_LOCAL", "NARF", "SHORT_SHOT_PCL", "GASD",
                            "ESF", "VFH", "GRSD", "CVFH", "OURCVFH")},
    "CGF": "A15.5",
}


def extraction_unsupported(fcfg: FeatureConfig) -> Optional[str]:
    """Why the port cannot extract this descriptor's features, with the
    queue that ports it, or None.  A keypoint type or culling filter the
    reference lacks raises ValueError when keypoints are detected or
    scored, as in the JAX package."""
    if fcfg.type not in DESCRIPTORS:
        queue = UNPORTED_DESCRIPTORS.get(fcfg.type)
        where = f"ROADMAP {queue}" if queue else "not a local descriptor"
        return f"descriptor {fcfg.type!r} (the port computes " \
               f"{', '.join(DESCRIPTORS)}; {where})"
    if fcfg.ref_frame_type != "SHOT":
        return f"ReferenceFrameType {fcfg.ref_frame_type!r} (SHOT only; " \
               "the LRF variants SHOTNA, BOARD and FLARE are ROADMAP A15.6)"
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


def _cull_chunk(kp, kpm, kp_normals, kp_rgb, pts, mask, nrm, rgb,
                kp_params: KeypointParams):
    """VoxelGridCulling of a chunk: the scores of every keypoint row in one
    call on the device, one host read, apply_culling_host row by row, the
    culled rows re-padded (live first, padding at 1e9): (kp [B, K', 3],
    kpm [B, K'], kp_rgb [B, K', 3] or None)."""
    geo = kp_params.filter_method_geometry.lower()
    col = kp_params.filter_method_color.lower()
    check_culling_methods(kp_params)
    zeros = torch.zeros_like(kp)
    g, c = culling_scores(kp, kpm, zeros if kp_normals is None else
                          kp_normals, zeros if kp_rgb is None else kp_rgb,
                          pts, mask, torch.zeros_like(pts) if nrm is None
                          else nrm, torch.zeros_like(pts) if rgb is None
                          else rgb, geo, col, float(kp_params.leaf_size),
                          float(kp_params.max_similar_color_distance))
    parts = [kp, zeros if kp_rgb is None else kp_rgb, g[..., None],
             c[..., None], kpm[..., None].to(kp.dtype)]
    host = torch.cat(parts, -1).cpu().numpy()
    rows = []
    for r in range(host.shape[0]):
        kk = int((host[r, :, 8] > 0).sum())
        kp_r = host[r, :kk, 0:3]
        rgb_r = host[r, :kk, 3:6] if kp_rgb is not None else None
        if kk:
            kp_r, rgb_r = apply_culling_host(
                kp_r, rgb_r, host[r, :kk, 6], host[r, :kk, 7], kp_params,
                return_colors=True)
        rows.append((kp_r, rgb_r))
    cap = max(64, -(-max(len(k) for k, _ in rows) // 64) * 64)
    b = len(rows)
    kp_h = np.full((b, cap, 3), 1e9, np.float32)
    kpm_h = np.zeros((b, cap), bool)
    rgb_h = np.zeros((b, cap, 3), np.float32)
    for r, (kp_r, rgb_r) in enumerate(rows):
        kp_h[r, :len(kp_r)] = kp_r
        kpm_h[r, :len(kp_r)] = True
        if rgb_r is not None:
            rgb_h[r, :len(kp_r)] = rgb_r
    dev = kp.device
    return (torch.from_numpy(kp_h).to(dev), torch.from_numpy(kpm_h).to(dev),
            None if kp_rgb is None else torch.from_numpy(rgb_h).to(dev))


def extract_chunk(pts: torch.Tensor,    # [B, n, 3], padding parked at 1e9
                  mask: torch.Tensor,   # [B, n]
                  rgb: Optional[torch.Tensor],  # [B, n, 3] (colour needed)
                  k_cap: int, fcfg: FeatureConfig, leaf: float,
                  normal_radius: float, n_method: int, lrf_version: int = 1,
                  normals: Optional[torch.Tensor] = None,  # [B, n, 3]
                  kp_params: Optional[KeypointParams] = None,
                  is_training: bool = True,
                  keypoints: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One chunk of the batched extraction (`_fused_extract_dense_program`,
    with the culling of the staged route when `kp_params` culls):
    (descriptors [B, K, D], keypoints [B, K, 3], frames [B, K, 3, 3], keep
    [B, K]).  Keypoints are the voxel centroids, valid first in voxel-key
    order (culled: the kept ones in that order); rows not kept carry a zero
    descriptor and keypoint and the identity frame.  With `keypoints` (kp
    [B, K, 3] with the padding at 1e9, live [B, K]: a detector's) the
    voxel grid and the culling are skipped and the keypoints' colours are
    zero: the JAX per-cloud route gives a detector's keypoints none."""
    cull = keypoints is None and kp_params is not None \
        and not culling_disabled(kp_params, is_training)
    want_normals = fcfg.needs_normals() or (
        cull and culling_needs_normals(kp_params, is_training))
    with full_fp32():
        if want_normals:
            nrm = normals if normals is not None else compute_normals(
                pts, mask, normal_radius, n_method, lrf_version).normals
            nrm = torch.where(mask[..., None], nrm, torch.zeros_like(nrm))
        else:
            nrm = torch.zeros_like(pts)
        if keypoints is not None:
            kp, kpm = keypoints
            kp_rgb = torch.zeros_like(kp) if rgb is not None else None
        else:
            feats = ([nrm] if cull and want_normals else []) \
                + ([rgb] if rgb is not None else [])
            res = voxel_grid(pts, mask, leaf, capacity=k_cap,
                             features=torch.cat(feats, -1) if feats
                             else None)
            kpm = res.mask
            xyz = res.centroids[..., :3]
            kp = torch.where(kpm[..., None], xyz, torch.full_like(xyz, 1e9))
            off = 6 if cull and want_normals else 3
            kp_rgb = res.centroids[..., off:off + 3] if rgb is not None \
                else None
        if cull:
            kp, kpm, kp_rgb = _cull_chunk(
                kp, kpm, res.centroids[..., 3:6] if want_normals else None,
                kp_rgb, pts, mask, nrm if want_normals else None, rgb,
                kp_params)
        desc, valid, frames = local_descriptors(
            fcfg, kp, kpm, kp_rgb, pts, nrm, rgb, mask, fcfg.radius,
            lrf_version)
        keep = valid & kpm
        desc = torch.where(keep[..., None], desc, torch.zeros_like(desc))
        eye = torch.eye(3, dtype=frames.dtype, device=frames.device)
        frames = torch.where(keep[..., None, None], frames, eye)
        kp = torch.where(keep[..., None], kp, torch.zeros_like(kp))
    return desc, kp, frames, keep


def detector_rows(clouds: Sequence[np.ndarray], chunk: List[int],
                  nrm: Optional[torch.Tensor], kp_params: KeypointParams,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A detector's keypoints of each cloud of a chunk (on the chunk's
    normals [b, n, 3] where it has them), as a padded grid: (kp [b, K, 3]
    with the padding at 1e9, live [b, K]), K a multiple of 64."""
    nrm_h = None if nrm is None else nrm.cpu().numpy()
    rows = []
    for r, ci in enumerate(chunk):
        keep, pos = detector_mask(
            clouds[ci], None if nrm_h is None else nrm_h[r, :len(clouds[ci])],
            kp_params, device)
        rows.append(pos[keep])
    cap = max(64, -(-max(len(k) for k in rows) // 64) * 64)
    kp = np.full((len(rows), cap, 3), 1e9, np.float32)
    live = np.zeros((len(rows), cap), bool)
    for r, k in enumerate(rows):
        kp[r, :len(k)] = k
        live[r, :len(k)] = True
    return torch.from_numpy(kp).to(device), torch.from_numpy(live).to(device)


def extract_local_features_batch(
        clouds: Sequence[np.ndarray],
        normals_list: Sequence[Optional[np.ndarray]],
        rgb_list: Sequence[Optional[np.ndarray]],
        fcfg: FeatureConfig, kp_params: KeypointParams, normal_radius: float,
        consistent_normals_method: int, device: torch.device,
        lrf_version: int = 1,
        device_cache: Optional[List[FusedChunk]] = None,
        is_training: bool = True,
        times: Optional[Dict[str, float]] = None
        ) -> List[FeatureSet]:
    """The per-cloud compact feature sets of the batched extraction: each
    scene (above tiled.SCENE_TILE_THRESHOLD points) on its own scene
    route, the other clouds grouped by bucket size, chunks of at most 8-32
    clouds (the JAX chunk width rule over those clouds), the keypoint
    capacity the group's largest exact voxel count rounded up to a
    multiple of 64; each chunk one :func:`extract_chunk`, its normals as
    the module docstring says.  Each chunk's (each scene's) kept
    descriptors go to `device_cache` when given.  `is_training` decides
    whether VoxelGridCulling culls (DisableFilterInTraining).  A chunk is
    not padded to its width: each cloud's result is independent of the
    rest of its chunk."""
    geo_cull = not culling_disabled(kp_params, is_training)
    col_cull = geo_cull and \
        kp_params.filter_method_color.lower() == "colordistance"
    if fcfg.needs_rgb() and any(r is None for r in rgb_list):
        raise ValueError(f"{fcfg.type} needs RGB data but a cloud has none")
    if col_cull and any(r is None for r in rgb_list):
        raise ValueError("color culling needs RGB data")
    out: List[Optional[FeatureSet]] = [None] * len(clouds)
    small = [i for i, c in enumerate(clouds)
             if len(c) <= tiled.SCENE_TILE_THRESHOLD]
    for i in range(len(clouds)):
        if len(clouds[i]) > tiled.SCENE_TILE_THRESHOLD:
            fs, desc, keep = extract_local_features_scene(
                np.asarray(clouds[i], np.float32), normals_list[i],
                rgb_list[i], fcfg, kp_params, normal_radius,
                consistent_normals_method, device, lrf_version, is_training,
                times)
            out[i] = fs
            if device_cache is not None:
                device_cache.append(FusedChunk(desc=desc, chunk=[i],
                                               keep=keep))
    if not small:
        return out  # type: ignore[return-value]
    sub = [clouds[i] for i in small]
    chunks = bucket_groups(sub, chunk_width(len(sub)))
    detector = kp_params.type in DETECTORS
    caps: Dict[int, int] = {}
    for n, chunk in chunks:
        caps[n] = 64 if detector else max(caps.get(n, 64), -(-max(
            host_voxel_count(sub[i], kp_params.leaf_size)
            for i in chunk) // 64) * 64)
    want_rgb = fcfg.needs_rgb() or col_cull
    for n, chunk in chunks:
        glob = [small[i] for i in chunk]
        pts_b, mask_b, rgb_b = padded_chunk(
            clouds, glob, n, rgb_list if want_rgb else None)
        pts = torch.from_numpy(pts_b).to(device)
        mask = torch.from_numpy(mask_b).to(device)
        nrm = None
        if (fcfg.needs_normals()
                or culling_needs_normals(kp_params, is_training)) and (
                consistent_normals_method == 3
                or any(normals_list[ci] is not None for ci in glob)):
            nrm = compute_cloud_normals(
                clouds, normals_list, glob, pts, mask, normal_radius,
                consistent_normals_method, lrf_version)
        keypoints = None
        if detector:
            if fcfg.needs_normals() and nrm is None:
                with full_fp32():
                    nrm = compute_normals(pts, mask, float(normal_radius),
                                          int(consistent_normals_method),
                                          lrf_version).normals
                nrm = torch.where(mask[..., None], nrm, torch.zeros_like(nrm))
            keypoints = detector_rows(clouds, glob, nrm, kp_params, device)
        desc, kp, frames, keep = extract_chunk(
            pts, mask,
            None if rgb_b is None else torch.from_numpy(rgb_b).to(device),
            caps[n], fcfg, float(kp_params.leaf_size), float(normal_radius),
            int(consistent_normals_method), lrf_version, nrm, kp_params,
            is_training, keypoints)
        unpack_chunk(desc, kp, frames, keep, clouds, glob, out,
                     device_cache)
    return out  # type: ignore[return-value]
