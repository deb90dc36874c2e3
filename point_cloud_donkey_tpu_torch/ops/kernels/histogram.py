"""K9: batched weighted histograms, H[r, b] = sum_c w[r, c] [idx[r, c] = b].

Port of point_cloud_donkey_tpu/ops/pallas/histogram.py (`_hist_kernel`,
`batched_histogram`), whose function is ops/shot.py
`_histogram_from_slots`, the accumulation of the SHORT_SHOT descriptor.  An
index outside [0, L) adds nothing.  Kernel in csrc/histogram.cu; plain twin
:func:`histogram_plain`: one fixed-order ``index_add_`` over each row's
entries in column order -- the order in which the kernel adds them.
"""

from __future__ import annotations

import torch

from ...kernels import build
from . import check, stream_of, uses_kernel

_ROWS = 8                     # rows per CTA (csrc/histogram.cu)
_SMEM_MAX = 227 * 1024        # shared memory a CTA can use on Hopper
_ELEM_BUDGET = 1 << 24        # [rows, C] entries per chunk of the twin


def _check(idx, w, length):
    r, c = idx.shape if idx.dim() == 2 else (None, None)
    check("idx", idx, torch.int32, (r, c))
    check("w", w, torch.float32, (r, c))
    if not 1 <= length or _ROWS * length * 4 > _SMEM_MAX:
        raise ValueError(f"length={length}: a CTA's {_ROWS} histograms must "
                         f"fit in {_SMEM_MAX} bytes of shared memory")


def histogram_plain(idx: torch.Tensor, w: torch.Tensor,
                    length: int) -> torch.Tensor:
    """Plain twin of K9: [R, length] f32."""
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


def histogram(idx: torch.Tensor,   # [R, C] i32 bin of each entry
              w: torch.Tensor,     # [R, C] f32 weight of each entry
              length: int) -> torch.Tensor:
    """K9: the weighted histograms [R, length] of the rows of (idx, w)."""
    _check(idx, w, length)
    if not uses_kernel(idx, w):
        return histogram_plain(idx, w, length)
    r, c = idx.shape
    out = torch.empty((r, length), dtype=torch.float32, device=idx.device)
    if r:
        with torch.cuda.device(idx.device):
            err = build.lib().pcd_histogram(idx.data_ptr(), w.data_ptr(),
                                            out.data_ptr(), r, c, length,
                                            stream_of(idx))
        build.check(err, "histogram")
        build.count_launch("histogram")
    return out
