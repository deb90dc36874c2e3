"""Hough3D vote accumulation (port of point_cloud_donkey_tpu/ops/hough.py).

Reference: voting/voting_hough_3d.cpp:33-95 and PCL's HoughSpace3D (vote /
voteInt).  The O(V) work -- each vote's bin keys and corner weights, and
the sum of the weights per bin -- runs in torch on the votes' device; the
candidate NMS and the clusters stay on the host (models/voting.py).

The JAX module scatter-adds into a dense grid; a floating-point
``index_add_`` on the card sums by atomics in no fixed order.  Here the
flat bin keys are sorted (stably, so each run keeps the votes' order) and
each run is summed by ``segment_reduce`` in that order, so two runs give
the same bits.  The grid is then filled on the host from the occupied
bins, over the integer key range the votes touch (the JAX module's grid,
sized the same way).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# the 8 corners of the trilinear cell, in (x, y, z) minor-to-major order
_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)], np.int64)


def _bucket(n: int, step: int = 8) -> int:
    return max(step, -(-n // step) * step)


def hough_accumulate(positions: torch.Tensor,   # [V, 3] float32
                     weights: torch.Tensor,     # [V]
                     min_coord: np.ndarray, bin_size: float,
                     interpolate: bool
                     ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int],
                                np.ndarray, np.ndarray]:
    """One class's votes into a Hough grid.  Returns (grid flat [Dx*Dy*Dz]
    float32, key_min [3], dims (Dx, Dy, Dz), keys [V, C, 3] int64, corner
    weights [V, C]), C = 8 with trilinear interpolation (voteInt: the
    corners of the cell around rel - 0.5), else 1 (the vote's own bin)."""
    dev = positions.device
    mn = torch.as_tensor(np.asarray(min_coord, np.float32), device=dev)
    bs = torch.tensor(np.float32(bin_size), device=dev)
    rel = (positions - mn[None, :]) / bs
    if interpolate:
        base = torch.floor(rel - 0.5)
        frac = (rel - 0.5) - base
        offs = torch.as_tensor(_CORNERS, device=dev)             # [8, 3]
        keys = base.to(torch.int64)[:, None, :] + offs[None]     # [V, 8, 3]
        o = offs.to(torch.float32)
        w = (torch.abs(1 - o[None, :, 0] - frac[:, None, 0])
             * torch.abs(1 - o[None, :, 1] - frac[:, None, 1])
             * torch.abs(1 - o[None, :, 2] - frac[:, None, 2])
             ) * weights[:, None]                                 # [V, 8]
    else:
        keys = torch.floor(rel).to(torch.int64)[:, None, :]      # [V, 1, 3]
        w = weights[:, None]
    keys_np = keys.cpu().numpy()
    base_np = keys_np[:, 0, :]
    key_min = base_np.min(axis=0) - 1
    key_max = base_np.max(axis=0) + (1 if interpolate else 0) + 1
    dims = tuple(_bucket(int(e) + 1, 4) for e in (key_max - key_min))
    dx, dy, dz = dims
    local = keys - torch.as_tensor(key_min, device=dev)[None, None, :]
    flat = ((local[..., 0] * dy + local[..., 1]) * dz + local[..., 2]
            ).reshape(-1)
    srt, order = torch.sort(flat, stable=True)
    is_new = torch.ones_like(srt, dtype=torch.bool)
    is_new[1:] = srt[1:] != srt[:-1]
    starts = torch.nonzero(is_new)[:, 0]
    lengths = torch.diff(starts, append=torch.tensor([srt.numel()],
                                                     device=dev))
    sums = torch.segment_reduce(w.reshape(-1)[order], "sum",
                                lengths=lengths, axis=0)
    grid = np.zeros(dx * dy * dz, np.float32)
    grid[srt[starts].cpu().numpy()] = sums.cpu().numpy()
    return grid, key_min.astype(np.int64), dims, keys_np, w.cpu().numpy()
