"""K8: CSHOT-1344 histograms over the dense [B, K] keypoint grid, the
(keypoint, point) pairs binned on chip.

Port of point_cloud_donkey_tpu/ops/pallas/shot_hist.py (`_hist_call`,
`shot_histogram_pallas`), whose function is ops/shot.py
`_shot_histogram_2pass` over the slot arrays of `_cshot_core_from_coords`:
here the slot math is fused in front of the histogram, so the kernel reads
points, normals, Lab colours, keypoints and frames, and no [B * K, N] slot
array exists.  :func:`cshot_hist` (kernel in csrc/shot_hist.cu) and its
plain twin :func:`cshot_hist_plain` -- the slot arrays of
ops/shot.py `cshot_slot_arrays`, one chunk of clouds at a time, through
:func:`shot_hist_plain` -- compute the same raw histograms and in-radius
counts; rows that are not live come out zero.

:func:`shot_hist_plain` is the function of the TPU kernel itself: eleven
[R, M] slot arrays (volume and bin indices, weights) -> [R, 32 * n_bin]
histograms, volume-major, for any bin count n_bin (11 for SHOT and the
shape channel of CSHOT, 31 for its colour channel); an index outside
[0, 32) or [0, n_bin) adds nothing, as in the one-hot products.  It adds
each row's slots with one fixed-order ``index_add_`` in (column, slot)
order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...kernels import build
from . import check, f32, stream_of, uses_kernel

NR_SECTORS = 32
CSHOT_LEN = 1344              # 32 x 11 shape slots, then 32 x 31 colour
_SLOT_BUDGET = 1 << 24        # [rows, M, 5] slots per chunk of the twin


def shot_hist_plain(desc, step, central_w, cos_bin, cos_w, rad_vol, rad_w,
                    incl_vol, incl_w, az_vol, az_w, n_bin: int
                    ) -> torch.Tensor:
    """The two-pass SHOT / CSHOT histogram of the slot arrays ([R, M] each:
    i32 indices, f32 weights): [R, 32 * n_bin] f32."""
    r, m = desc.shape
    length = NR_SECTORS * n_bin
    hist = torch.zeros((r * length,), dtype=torch.float32,
                       device=desc.device)
    step_rows = max(1, _SLOT_BUDGET // max(5 * m, 1))
    for r0 in range(0, r, step_rows):
        sl = slice(r0, r0 + step_rows)
        vol = torch.stack([desc[sl], desc[sl], rad_vol[sl], incl_vol[sl],
                           az_vol[sl]], -1).long()
        bins = torch.stack([step[sl], cos_bin[sl], step[sl], step[sl],
                            step[sl]], -1).long()
        w = torch.stack([central_w[sl], cos_w[sl], rad_w[sl], incl_w[sl],
                         az_w[sl]], -1)
        rows = torch.arange(r0, r0 + vol.shape[0], device=desc.device)
        ok = ((vol >= 0) & (vol < NR_SECTORS) & (bins >= 0) & (bins < n_bin)
              & (w != 0))
        flat = rows[:, None, None] * length + vol * n_bin + bins
        hist.index_add_(0, flat[ok], w[ok])
    return hist.reshape(r, length)


def _check(kp, kp_lab, frames, live, points, normals, lab, mask):
    b, k = live.shape if live.dim() == 2 else (None, None)
    n = points.shape[1] if points.dim() == 3 else None
    check("kp", kp, torch.float32, (b, k, 3))
    check("kp_lab", kp_lab, torch.float32, (b, k, 3))
    check("frames", frames, torch.float32, (b, k, 3, 3))
    check("live", live, torch.bool, (b, k))
    for name, x in (("points", points), ("normals", normals), ("lab", lab)):
        check(name, x, torch.float32, (b, n, 3))
    check("mask", mask, torch.bool, (b, n))


def cshot_hist_plain(kp, kp_lab, frames, live, points, normals, lab, mask,
                     radius) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K8: (hist [B, K, 1344] raw, count [B, K] i32) from the
    slot arrays of each chunk of clouds; rows that are not live keep a
    zero histogram and count."""
    # ops/shot.py imports this module for cshot_hist
    from ..shot import cloud_chunks, cshot_slot_arrays
    b, k, _ = kp.shape
    hist = torch.zeros((b, k, CSHOT_LEN), dtype=torch.float32,
                       device=kp.device)
    count = torch.zeros((b, k), dtype=torch.int32, device=kp.device)
    nrm_ok = mask & torch.isfinite(normals).all(-1)
    for b0, b1 in cloud_chunks(b, k, points.shape[1]):
        channels, c = cshot_slot_arrays(kp[b0:b1], kp_lab[b0:b1],
                                        frames[b0:b1], points[b0:b1],
                                        normals[b0:b1], lab[b0:b1],
                                        nrm_ok[b0:b1], radius)
        h = torch.cat([shot_hist_plain(*args) for args in channels], dim=1)
        hist[b0:b1] = h.reshape(b1 - b0, k, CSHOT_LEN)
        count[b0:b1] = c
    hist = torch.where(live[..., None], hist, torch.zeros_like(hist))
    count = torch.where(live, count, torch.zeros_like(count))
    return hist, count


def cshot_hist(kp: torch.Tensor,       # [B, K, 3] keypoints
               kp_lab: torch.Tensor,   # [B, K, 3] normalised Lab
               frames: torch.Tensor,   # [B, K, 3, 3] rows = axes
               live: torch.Tensor,     # [B, K] bool rows to describe
               points: torch.Tensor,   # [B, N, 3]
               normals: torch.Tensor,  # [B, N, 3]
               lab: torch.Tensor,      # [B, N, 3] normalised Lab
               mask: torch.Tensor,     # [B, N] bool
               radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: raw CSHOT histograms [B, K, 1344] (shape channel first) and
    in-radius counts [B, K] i32 of every live row of the dense keypoint
    grid, each against the points of its cloud."""
    _check(kp, kp_lab, frames, live, points, normals, lab, mask)
    if not uses_kernel(kp, kp_lab, frames, live, points, normals, lab, mask):
        return cshot_hist_plain(kp, kp_lab, frames, live, points, normals,
                                lab, mask, radius)
    b, k = live.shape
    hist = torch.empty((b, k, CSHOT_LEN), dtype=torch.float32,
                       device=kp.device)
    count = torch.empty((b, k), dtype=torch.int32, device=kp.device)
    if b and k:
        with torch.cuda.device(kp.device):
            err = build.lib().pcd_cshot_hist(
                kp.data_ptr(), kp_lab.data_ptr(), frames.data_ptr(),
                live.data_ptr(), points.data_ptr(), normals.data_ptr(),
                lab.data_ptr(), mask.data_ptr(), hist.data_ptr(),
                count.data_ptr(), b, k, points.shape[1], f32(radius),
                stream_of(kp))
        build.check(err, "shot_hist")
        build.count_launch("shot_hist")
    return hist, count
