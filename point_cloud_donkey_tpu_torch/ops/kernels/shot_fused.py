"""K3: SHOT-352 over tile-compacted keypoints.

Port of point_cloud_donkey_tpu/ops/pallas/shot_fused.py:
`_shot_fused_call_windowed` over `_shot_tile_body` -> :func:`shot_tiles`
(kernel in csrc/shot_fused.cu, plain twin :func:`shot_tiles_plain` on
ops/shot.py), `shot_descriptor_fused_compact` ->
:func:`shot_descriptor_fused_compact`.

Compaction: the valid keypoints of every cloud are packed into tiles of
TK = 8 rows (tiles never span clouds).  The tile count is sized from the
batch's own keypoint counts -- one host read of a [B] vector -- so there is
no capacity knob (`required_tile_capacity`), no exactness flag and no
dense fallback (`_shot_fused_call`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...kernels import build
from ..shot import DESC_LEN, normalize_descriptors, shot_histogram_rows
from . import check, f32, stream_of, uses_kernel

TK = 8  # keypoints per tile


def _check(kp, frames, tile_cloud, points, normals, mask):
    t = tile_cloud.shape[0]
    b, n = points.shape[0], points.shape[1]
    check("kp", kp, torch.float32, (t * TK, 3))
    check("frames", frames, torch.float32, (t * TK, 3, 3))
    check("tile_cloud", tile_cloud, torch.int32, (t,))
    check("points", points, torch.float32, (b, n, 3))
    check("normals", normals, torch.float32, (b, n, 3))
    check("mask", mask, torch.bool, (b, n))


def shot_tiles_plain(kp, frames, tile_cloud, points, normals, mask, radius):
    """Plain twin of K3: (hist [T*8, 352] raw, count [T*8] i32)."""
    cloud = tile_cloud.long().repeat_interleave(TK)
    return shot_histogram_rows(kp, frames, cloud, points, normals, mask,
                               radius)


def shot_tiles(kp: torch.Tensor,          # [T*8, 3]
               frames: torch.Tensor,      # [T*8, 3, 3] rows = axes
               tile_cloud: torch.Tensor,  # [T] int32
               points: torch.Tensor,      # [B, N, 3]
               normals: torch.Tensor,     # [B, N, 3]
               mask: torch.Tensor,        # [B, N] bool
               radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: raw SHOT histograms and in-radius counts of 8-keypoint tiles,
    each against the points of its cloud."""
    _check(kp, frames, tile_cloud, points, normals, mask)
    if not uses_kernel(kp, frames, tile_cloud, points, normals, mask):
        return shot_tiles_plain(kp, frames, tile_cloud, points, normals,
                                mask, radius)
    t = tile_cloud.shape[0]
    hist = torch.empty((t * TK, DESC_LEN), dtype=torch.float32,
                       device=kp.device)
    count = torch.empty((t * TK,), dtype=torch.int32, device=kp.device)
    if t:
        with torch.cuda.device(kp.device):
            err = build.lib().pcd_shot_fused(
                kp.data_ptr(), frames.data_ptr(), tile_cloud.data_ptr(),
                points.data_ptr(), normals.data_ptr(), mask.data_ptr(),
                hist.data_ptr(), count.data_ptr(), t, points.shape[1],
                f32(radius), stream_of(kp))
        build.check(err, "shot_fused")
        build.count_launch("shot_fused")
    return hist, count


def compact_layout(kp_mask: torch.Tensor):
    """Host plan of the tile-compacted layout from the [B] keypoint counts
    (the one host read): (gather index [T*8] into the [B*K] rows, row
    alive [T*8], tile cloud [T]) as tensors on kp_mask's device."""
    b, k = kp_mask.shape
    counts = kp_mask.sum(1).cpu().numpy().astype(np.int64)
    tiles = -(-counts // TK)
    tile_cloud = np.repeat(np.arange(b, dtype=np.int32), tiles)
    toff = np.concatenate([[0], np.cumsum(tiles)[:-1]]).astype(np.int64)
    tin = np.arange(len(tile_cloud)) - toff[tile_cloud]
    rows = tin[:, None] * TK + np.arange(TK)[None, :]              # [T, TK]
    alive = rows < counts[tile_cloud][:, None]
    gidx = tile_cloud[:, None].astype(np.int64) * k + np.minimum(rows, k - 1)
    dev = kp_mask.device
    return (torch.from_numpy(gidx.reshape(-1)).to(dev),
            torch.from_numpy(alive.reshape(-1)).to(dev),
            torch.from_numpy(tile_cloud).to(dev))


def shot_descriptor_fused_compact(
        keypoints: torch.Tensor,    # [B, K, 3], valid rows FIRST per cloud
        frames: torch.Tensor,       # [B, K, 3, 3]
        frame_valid: torch.Tensor,  # [B, K]
        kp_mask: torch.Tensor,      # [B, K] (valid-first, contiguous)
        points: torch.Tensor,       # [B, N, 3]
        normals: torch.Tensor,      # [B, N, 3]
        mask: torch.Tensor,         # [B, N]
        radius: float,
        min_neighbors: int = 5):
    """SHOT over tile-compacted keypoints.  Returns (descriptors [T*8, 352],
    valid [T*8], kp_flat [T*8, 3], frames_flat [T*8, 3, 3], cloud_id
    [T*8]) in the flat compacted layout; rows past a cloud's keypoint count
    are invalid, with keypoint 0 and frame eye like every invalid row."""
    b, k, _ = keypoints.shape
    gidx, alive, tile_cloud = compact_layout(kp_mask)
    kp_rows = keypoints.reshape(b * k, 3)[gidx]
    fr_rows = frames.reshape(b * k, 3, 3)[gidx]
    fv_rows = frame_valid.reshape(b * k)[gidx] & alive
    kp_rows = torch.where(alive[:, None], kp_rows,
                          torch.full_like(kp_rows, 1e9))
    hist, count = shot_tiles(kp_rows.contiguous(), fr_rows.contiguous(),
                             tile_cloud, points.contiguous(),
                             normals.contiguous(), mask.contiguous(), radius)
    res = normalize_descriptors(hist, count, fv_rows, min_neighbors)
    valid = res.valid
    cloud_id = tile_cloud.long().repeat_interleave(TK)
    kp_out = torch.where(valid[:, None], kp_rows, torch.zeros_like(kp_rows))
    eye = torch.eye(3, dtype=fr_rows.dtype, device=fr_rows.device)
    fr_out = torch.where(valid[:, None, None], fr_rows, eye)
    return res.descriptors, valid, kp_out, fr_out, cloud_id
