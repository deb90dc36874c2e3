"""K8: the two-pass SHOT / CSHOT histogram from compact slot arrays.

Port of point_cloud_donkey_tpu/ops/pallas/shot_hist.py (`_hist_call`,
`shot_histogram_pallas`), whose function is ops/shot.py
`_shot_histogram_2pass`: eleven [R, M] slot arrays (volume and bin indices,
weights; masked lanes zero-weighted by the caller) -> [R, 32 * n_bin]
histograms, volume-major, for any bin count n_bin (11 for SHOT and the
shape channel of CSHOT, 31 for its colour channel).  An index outside
[0, 32) or [0, n_bin) adds nothing, as in the one-hot products.  Kernel in
csrc/shot_hist.cu; plain twin :func:`shot_hist_plain`: one fixed-order
``index_add_`` over each row's slots in (column, slot) order -- the order
in which the kernel adds them.
"""

from __future__ import annotations

import torch

from ...kernels import build
from . import check, stream_of, uses_kernel

NR_SECTORS = 32
_ROWS = 8                     # rows per CTA (csrc/shot_hist.cu)
_SMEM_MAX = 227 * 1024        # shared memory a CTA can use on Hopper
_SLOT_BUDGET = 1 << 24        # [rows, M, 5] slots per chunk of the twin


def _check(arrays, n_bin):
    r, m = arrays[0].shape if arrays[0].dim() == 2 else (None, None)
    names = ("desc", "step", "central_w", "cos_bin", "cos_w", "rad_vol",
             "rad_w", "incl_vol", "incl_w", "az_vol", "az_w")
    for name, a in zip(names, arrays):
        dtype = torch.float32 if name.endswith("_w") else torch.int32
        check(name, a, dtype, (r, m))
    if not 1 <= n_bin or _ROWS * NR_SECTORS * n_bin * 4 > _SMEM_MAX:
        raise ValueError(f"n_bin={n_bin}: a CTA's {_ROWS} histograms must "
                         f"fit in {_SMEM_MAX} bytes of shared memory")


def shot_hist_plain(desc, step, central_w, cos_bin, cos_w, rad_vol, rad_w,
                    incl_vol, incl_w, az_vol, az_w, n_bin: int
                    ) -> torch.Tensor:
    """Plain twin of K8: [R, 32 * n_bin] f32."""
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


def shot_hist(desc: torch.Tensor,       # [R, M] i32 volume of the point
              step: torch.Tensor,       # [R, M] i32 bin
              central_w: torch.Tensor,  # [R, M] f32
              cos_bin: torch.Tensor,    # [R, M] i32
              cos_w: torch.Tensor,      # [R, M] f32
              rad_vol: torch.Tensor,    # [R, M] i32
              rad_w: torch.Tensor,      # [R, M] f32
              incl_vol: torch.Tensor,   # [R, M] i32
              incl_w: torch.Tensor,     # [R, M] f32
              az_vol: torch.Tensor,     # [R, M] i32
              az_w: torch.Tensor,       # [R, M] f32
              n_bin: int) -> torch.Tensor:
    """K8: the raw two-pass histograms [R, 32 * n_bin] of the slot arrays."""
    arrays = (desc, step, central_w, cos_bin, cos_w, rad_vol, rad_w,
              incl_vol, incl_w, az_vol, az_w)
    _check(arrays, n_bin)
    if not uses_kernel(*arrays):
        return shot_hist_plain(*arrays, n_bin)
    r, m = desc.shape
    out = torch.empty((r, NR_SECTORS * n_bin), dtype=torch.float32,
                      device=desc.device)
    if r:
        with torch.cuda.device(desc.device):
            err = build.lib().pcd_shot_hist(
                *(a.data_ptr() for a in arrays), out.data_ptr(), r, m, n_bin,
                stream_of(desc))
        build.check(err, "shot_hist")
        build.count_launch("shot_hist")
    return out
