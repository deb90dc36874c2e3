"""Sorted-axis windowed neighbour sweeps (port of
point_cloud_donkey_tpu/ops/binned.py, batched over clouds).

Each cloud is sorted along its principal axis (the largest-spread
eigenvector of its covariance).  A tile of TQ consecutive sorted queries
then finds every in-radius neighbour in one contiguous range of the sorted
points (keys within [tile min - r, tile max + r]), so it sweeps a window of
fixed width W instead of all N points.  The window is a capacity,
calibrated on a workload with :func:`required_window`; every plan also
returns an exactness flag -- True iff each tile's candidate range fit its
window -- and a caller that sees it False recomputes densely, so results
are never silently approximate.

Differences from the JAX module: everything is batched over [B, ...]; the
plan covers ceil(Q / tile_q) tiles and masks the tail, where the JAX
``window_starts`` drops a query tail that does not fill a tile; the sweep
is K5/K6 (ops/kernels/lrf_moments.py) on the card and their plain twins
on the CPU, on exact coordinate differences.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .eigh3 import eigh3x3
from .kernels.lrf_moments import TQW, shot_lrf_windowed

PARK = 1e9    # sort key of invalid points: they sort last
ALIGN = 128   # window starts are aligned down to this many points


def principal_axes(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-cloud principal (largest-spread) axis [B, 3]."""
    m = mask.to(points.dtype)
    cnt = torch.clamp(m.sum(1), min=1.0)                          # [B]
    mean = (points * m[..., None]).sum(1) / cnt[:, None]
    d = torch.where(mask[..., None], points - mean[:, None, :],
                    torch.zeros_like(points))
    cov = (d[..., :, None] * d[..., None, :]).sum(1) / cnt[:, None, None]
    _, vecs = eigh3x3(cov)
    return vecs[..., :, 2]


def _keys(points, mask, axis):
    keys = (points * axis[:, None, :]).sum(-1)
    return torch.where(mask, keys, torch.full_like(keys, PARK))


def principal_axis_keys(points: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Sort keys [B, N]: projection onto each cloud's principal axis;
    invalid points key to +PARK."""
    return _keys(points, mask, principal_axes(points, mask))


class SortedClouds(NamedTuple):
    points: torch.Tensor  # [B, N, 3] sorted by key
    mask: torch.Tensor    # [B, N]
    keys: torch.Tensor    # [B, N] ascending
    order: torch.Tensor   # [B, N] original index of each sorted point
    axis: torch.Tensor    # [B, 3] principal axis


def sort_clouds_ex(points: torch.Tensor, mask: torch.Tensor) -> SortedClouds:
    """Sort each cloud by its principal-axis key with one stable sort (equal
    keys keep their input order, as JAX's stable payload sort does)."""
    axis = principal_axes(points, mask)
    keys = _keys(points, mask, axis)
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand_as(points))
    return SortedClouds(pts_s, torch.gather(mask, 1, order), keys_s, order,
                        axis)


def sort_clouds(points: torch.Tensor, mask: torch.Tensor):
    """(points_sorted, mask_sorted, keys_sorted, order) of
    :func:`sort_clouds_ex`."""
    return tuple(sort_clouds_ex(points, mask))[:4]


class WindowPlan(NamedTuple):
    starts: torch.Tensor  # [B, T] int32 window start per query tile
    exact: torch.Tensor   # [] bool: every tile's candidate range fit
    span: torch.Tensor    # [] int64: widest candidate range over tiles,
    #                        from the aligned, unclamped starts


def window_starts(q_keys: torch.Tensor,   # [B, Q] sorted query keys
                  q_mask: torch.Tensor,   # [B, Q]
                  p_keys: torch.Tensor,   # [B, N] sorted point keys
                  radius: float, window: int, tile_q: int = TQW,
                  align: int = ALIGN) -> WindowPlan:
    """Per-tile window starts into the sorted points.  The window of tile t
    must cover every point with key in [min valid query key of the tile -
    radius, max + radius]; starts are aligned down to `align` and clamped
    so the window stays inside [0, N].  T = ceil(Q / tile_q): the last
    tile's missing queries count as invalid."""
    b, nq = q_keys.shape
    n = p_keys.shape[1]
    t = -(-nq // tile_q)
    pad = t * tile_q - nq
    qk = torch.nn.functional.pad(q_keys, (0, pad), value=PARK)
    qm = torch.nn.functional.pad(q_mask, (0, pad), value=False)
    qk, qm = qk.reshape(b, t, tile_q), qm.reshape(b, t, tile_q)
    big = torch.full_like(qk, PARK)
    lo_key = torch.where(qm, qk, big).amin(-1)
    hi_key = torch.where(qm, qk, -big).amax(-1)
    any_valid = qm.any(-1)

    p_keys = p_keys.contiguous()
    lo = torch.searchsorted(p_keys, (lo_key - radius).contiguous(),
                            side="left")
    hi = torch.searchsorted(p_keys, (hi_key + radius).contiguous(),
                            side="right")
    lo = torch.where(any_valid, lo, torch.zeros_like(lo))
    hi = torch.where(any_valid, hi, torch.zeros_like(hi))

    win = min(window, n)
    aligned_lo = (lo // align) * align
    start = aligned_lo.clamp(0, max(n - win, 0))
    # the window used covers [start, start + win) and must reach hi (a
    # start clamped to n - win covers up to n, so a window >= n is exact)
    exact = torch.where(any_valid, hi - start <= win,
                        torch.ones_like(any_valid)).all()
    span = torch.where(any_valid, hi - aligned_lo,
                       torch.zeros_like(hi)).amax() if t else \
        torch.zeros((), dtype=torch.int64, device=q_keys.device)
    return WindowPlan(starts=start.to(torch.int32), exact=exact, span=span)


def required_window(points: torch.Tensor, mask: torch.Tensor, radius: float,
                    tile_q: int = TQW, align: int = ALIGN,
                    q_points: Optional[torch.Tensor] = None,
                    q_mask: Optional[torch.Tensor] = None) -> int:
    """Calibrate the window capacity on a workload: the widest candidate
    range over every tile of every cloud, rounded up to `align` (one host
    read).  A result >= N means the window cannot prune: run dense.  The
    queries default to the points themselves (the self-LRF of the normals);
    `q_points` [B, Q, 3] with `q_mask` [B, Q] (the keypoints, with
    tile_q=8 for the windowed descriptor) are projected on each cloud's
    principal axis and sorted, as the windowed descriptor sorts them."""
    s = sort_clouds_ex(points, mask)
    if q_points is None:
        q_keys, q_m = s.keys, s.mask
    else:
        q_keys = torch.sort(_keys(q_points, q_mask, s.axis), dim=1).values
        q_m = q_keys < PARK
    plan = window_starts(q_keys, q_m, s.keys, radius, s.keys.shape[1],
                         tile_q, align)
    span = int(plan.span)
    return max(align, -(-span // align) * align)


def compute_normals_fast_windowed(
        points_sorted: torch.Tensor,  # [B, N, 3] sorted by key
        mask_sorted: torch.Tensor,    # [B, N]
        keys_sorted: torch.Tensor,    # [B, N]
        radius: float,
        window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving normals (ConsistentNormalsMethod 2) of a sorted batch through
    the windowed self-LRF: normal = inverted z axis, +z where the LRF is
    invalid (ops/normals.compute_normals_fast, to which it is equal when
    the plan is exact).  Returns (normals [B, N, 3] in the sorted order,
    exact [] bool on the device)."""
    window = min(window, points_sorted.shape[1])
    plan = window_starts(keys_sorted, mask_sorted, keys_sorted, radius,
                         window)
    frames, valid = shot_lrf_windowed(points_sorted, mask_sorted,
                                      plan.starts.contiguous(), window,
                                      radius, z_only=True)
    z = -frames[..., 2, :]
    up = torch.zeros_like(z)
    up[..., 2] = 1.0
    return torch.where(valid[..., None], z, up), plan.exact
