"""K9: SHORT_SHOT histograms over the dense [B, K] keypoint grid, the
(keypoint, point) pairs binned on chip.

Port of point_cloud_donkey_tpu/ops/pallas/histogram.py (`_hist_kernel`,
`batched_histogram`), whose function is ops/shot.py `_histogram_from_slots`
over the slots of ops/short_shot.py `_short_shot_core`: here the slot math
is fused in front of the histogram, so the kernel reads points, keypoints
and frames, and no [B * K, N * 4] slot array exists.
:func:`short_shot_hist` (kernel in csrc/histogram.cu) and its plain twin
:func:`short_shot_hist_plain` -- the slot arrays of ops/short_shot.py
`short_shot_slot_arrays`, one chunk of clouds at a time, through
:func:`histogram_plain` -- compute the same raw histograms; rows that are
not live come out zero.  Bin grids of up to MAX_BINS = 256 bins (every
SHORT_SHOT `AUTO_BINS` size); a larger one is refused.  A minimum radius
(pairs with r < min_radius add nothing) and the log radius (the JAX
`_short_shot_core`'s `log_radius`) enter both.

:func:`histogram_plain` is the function of the TPU kernel itself:
H[r, b] = sum_c w[r, c] [idx[r, c] = b], an index outside [0, L) adding
nothing, summed with one fixed-order ``index_add_`` in column order.
"""

from __future__ import annotations

import torch

from ...kernels import build
from . import check, f32, stream_of, uses_kernel

MAX_BINS = 256                # 8 f32 registers a lane (csrc/histogram.cu)
_ELEM_BUDGET = 1 << 24        # [rows, C] entries per chunk of the twin


def histogram_plain(idx: torch.Tensor, w: torch.Tensor,
                    length: int) -> torch.Tensor:
    """The weighted histograms [R, length] f32 of the rows of (idx [R, C]
    i32, w [R, C] f32)."""
    r, c = idx.shape
    hist = torch.zeros((r * length,), dtype=torch.float32, device=idx.device)
    step_rows = max(1, _ELEM_BUDGET // max(c, 1))
    for r0 in range(0, r, step_rows):
        i, wc = idx[r0:r0 + step_rows].long(), w[r0:r0 + step_rows]
        rows = torch.arange(r0, r0 + i.shape[0], device=idx.device)
        ok = (i >= 0) & (i < length) & (wc != 0)
        flat = rows[:, None] * length + i
        hist.index_add_(0, flat[ok], wc[ok])
    return hist.reshape(r, length)


def _check(kp, frames, live, points, mask, r_bins, e_bins, a_bins):
    b, k = live.shape if live.dim() == 2 else (None, None)
    n = points.shape[1] if points.dim() == 3 else None
    check("kp", kp, torch.float32, (b, k, 3))
    check("frames", frames, torch.float32, (b, k, 3, 3))
    check("live", live, torch.bool, (b, k))
    check("points", points, torch.float32, (b, n, 3))
    check("mask", mask, torch.bool, (b, n))
    if min(r_bins, e_bins, a_bins) < 1 or \
            r_bins * e_bins * a_bins > MAX_BINS:
        raise ValueError(f"SHORT_SHOT bins {r_bins} x {e_bins} x {a_bins}: "
                         f"each at least 1 and at most {MAX_BINS} in all")


def short_shot_hist_plain(kp, frames, live, points, mask, radius, r_bins,
                          e_bins, a_bins, min_radius=0.0,
                          log_radius=False) -> torch.Tensor:
    """Plain twin of K9: raw histograms [B, K, D] from the slot arrays of
    each chunk of clouds; rows that are not live stay zero."""
    # ops/short_shot.py imports this module for short_shot_hist
    from ..shot import cloud_chunks
    from ..short_shot import short_shot_slot_arrays
    b, k, _ = kp.shape
    dims = r_bins * e_bins * a_bins
    hist = torch.zeros((b, k, dims), dtype=torch.float32, device=kp.device)
    for b0, b1 in cloud_chunks(b, k, points.shape[1]):
        idx, w = short_shot_slot_arrays(kp[b0:b1], frames[b0:b1],
                                        points[b0:b1], mask[b0:b1], radius,
                                        r_bins, e_bins, a_bins, min_radius,
                                        log_radius)
        hist[b0:b1] = histogram_plain(idx, w, dims).reshape(b1 - b0, k, dims)
    return torch.where(live[..., None], hist, torch.zeros_like(hist))


def short_shot_hist(kp: torch.Tensor,      # [B, K, 3] keypoints
                    frames: torch.Tensor,  # [B, K, 3, 3] rows = axes
                    live: torch.Tensor,    # [B, K] bool rows to describe
                    points: torch.Tensor,  # [B, N, 3]
                    mask: torch.Tensor,    # [B, N] bool
                    radius: float, r_bins: int = 2, e_bins: int = 2,
                    a_bins: int = 8, min_radius: float = 0.0,
                    log_radius: bool = False) -> torch.Tensor:
    """K9: raw SHORT_SHOT histograms [B, K, r_bins * e_bins * a_bins] of
    every live row of the dense keypoint grid, each against the points of
    its cloud."""
    # ops/short_shot.py imports this module for short_shot_hist
    from ..short_shot import log_radius_params
    _check(kp, frames, live, points, mask, r_bins, e_bins, a_bins)
    if not uses_kernel(kp, frames, live, points, mask):
        return short_shot_hist_plain(kp, frames, live, points, mask, radius,
                                     r_bins, e_bins, a_bins, min_radius,
                                     log_radius)
    ln_rmin, ln_span = log_radius_params(radius, min_radius)
    b, k = live.shape
    hist = torch.empty((b, k, r_bins * e_bins * a_bins), dtype=torch.float32,
                       device=kp.device)
    if b and k:
        with torch.cuda.device(kp.device):
            err = build.lib().pcd_short_shot_hist(
                kp.data_ptr(), frames.data_ptr(), live.data_ptr(),
                points.data_ptr(), mask.data_ptr(), hist.data_ptr(), b, k,
                points.shape[1], f32(radius), r_bins, e_bins, a_bins,
                f32(min_radius), int(log_radius), f32(ln_rmin),
                f32(ln_span), stream_of(kp))
        build.check(err, "histogram")
        build.count_launch("histogram")
    return hist
