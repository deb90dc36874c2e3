"""Voxel-grid keypoints: per-voxel centroids in voxel-key order (port of
point_cloud_donkey_tpu/ops/voxel_grid.py, batched over clouds).

PCL semantics: voxel index = floor(p / leaf) - floor(min / leaf) per axis;
output = mean of the points (and of any per-point features, such as the
colours CSHOT reads) of each occupied voxel, ordered lexicographically by
(i, j, k).  The order comes from three stable sorts
(k, then j, then i), so equal keys keep the input order and no composite
key can overflow.  Voxel ids at or past `capacity` are dropped, not
clipped.  Each voxel's sum runs over its points in sorted order, the same
on every run and device.  Valid rows come first in the output; the tile-compacted SHOT
stage relies on it.

p / leaf is computed as the JAX route being mirrored computes it, since a
point on a voxel edge changes voxel with the last bit: the JAX programs
that close over the leaf as a constant (the batched feature and detection
programs) multiply by its float32 reciprocal, because XLA folds the
division; its per-cloud keypoint program, which takes the leaf at run
time, and its eager preprocessing filter divide (``exact_division``).  A
CUDA tensor divided by a Python float is multiplied by the reciprocal, so
the exact division divides by a device tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class VoxelGridResult(NamedTuple):
    centroids: torch.Tensor  # [..., K, 3 + F] per-voxel means of [xyz, features]
    mask: torch.Tensor       # [..., K] validity


def voxel_grid(points: torch.Tensor,   # [N, 3] or [B, N, 3]
               mask: torch.Tensor,     # [N] or [B, N]
               leaf_size: float,
               capacity: Optional[int] = None,
               features: Optional[torch.Tensor] = None,  # [(B,) N, F]
               exact_division: bool = False) -> VoxelGridResult:
    """Per-voxel means of [points, features] (features ride through the
    same sorts and the same fixed-order sums as the coordinates)."""
    single = points.dim() == 2
    if single:
        points, mask = points[None], mask[None]
        features = None if features is None else features[None]
    b, n, _ = points.shape
    cap = capacity or n

    if exact_division:
        step = torch.tensor(leaf_size, dtype=points.dtype,
                            device=points.device)

        def cell(x):
            return torch.floor(x / step)
    else:
        inv = float(np.float32(1.0) / np.float32(leaf_size))

        def cell(x):
            return torch.floor(x * inv)
    big = torch.full_like(points, float("inf"))
    mn = cell(torch.amin(torch.where(mask[..., None], points, big),
                         dim=1))                                     # [B, 3]
    ijk = cell(points) - mn[:, None, :]
    # invalid points (and empty clouds) sort to the end; a non-finite point
    # is invalid, so the valid points form one sorted prefix
    max_c = torch.iinfo(torch.int32).max
    valid = mask & torch.isfinite(ijk).all(-1)
    ijk = torch.where(valid[..., None], ijk, float(max_c)).to(torch.int64)

    # stable lexicographic order on (i, j, k): least significant key first
    order = torch.arange(n, device=points.device).expand(b, n)
    for axis in (2, 1, 0):
        key = torch.gather(ijk[..., axis], 1, order)
        _, perm = torch.sort(key, dim=1, stable=True)
        order = torch.gather(order, 1, perm)
    sorted_ijk = torch.gather(ijk, 1, order[..., None].expand(b, n, 3))
    payload = points if features is None else torch.cat(
        [points, features.to(points.dtype)], dim=-1)
    f = payload.shape[-1]
    sorted_pay = torch.gather(payload, 1, order[..., None].expand(b, n, f))
    sorted_valid = torch.gather(valid, 1, order)

    is_new = torch.ones((b, n), dtype=torch.bool, device=points.device)
    is_new[:, 1:] = torch.any(sorted_ijk[:, 1:] != sorted_ijk[:, :-1], dim=2)
    is_new &= sorted_valid
    seg = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    # invalid points and voxel ids past capacity go to the dump slot
    seg = torch.where(sorted_valid & (seg < cap), seg,
                      torch.full_like(seg, cap))

    # the segments are contiguous runs of the sorted points: count them
    # (integer adds, exact in any order) and sum each run in a fixed order,
    # so the centroids do not depend on the order of atomic adds
    lengths = torch.zeros((b, cap + 1), dtype=torch.int64,
                          device=points.device)
    lengths.scatter_add_(1, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(
        torch.where(sorted_valid[..., None], sorted_pay,
                    torch.zeros_like(sorted_pay)), "sum", lengths=lengths,
        axis=1)[:, :cap]
    counts = lengths[:, :cap].to(points.dtype)

    out_mask = counts > 0
    centroids = sums / torch.clamp(counts, min=1.0)[..., None]
    centroids = torch.where(out_mask[..., None], centroids,
                            torch.zeros_like(centroids))
    if single:
        centroids, out_mask = centroids[0], out_mask[0]
    return VoxelGridResult(centroids=centroids, mask=out_mask)
