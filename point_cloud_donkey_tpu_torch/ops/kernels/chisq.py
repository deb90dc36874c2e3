"""K4: exact chi-square k-nearest codewords (k <= 3), top-k fused; K4m:
the [Q, C] chi-square matrix.

Port of point_cloud_donkey_tpu/ops/pallas/chisq.py (`_chisq_call`,
`chi_square_distance_matrix_pallas`) together with the top-k that
`ops/neighbors.knn` applies to its result.  K4 (csrc/chisq.cu) never
writes the [Q, C] matrix; K4m is the same sweep with a second epilogue that
stores it, for the selections a register top-k cannot hold (k > 3: KNN
with K > 3, Threshold's 64 nearest), which `smallest_k` then takes outside
the kernel, as the JAX package takes `lax.top_k` outside its Pallas kernel.
K4m's distances are K4's bit for bit.  The plain twins build the matrix in
row chunks (and sort).  Distances: flann::ChiSquareDistance,
sum (a - b)^2 / (a + b) over dims with a + b > 0; masked codewords are
+inf; ties go to the lower index, as lax.top_k gives them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...kernels import build
from . import check, stream_of, uses_kernel

KMAX = 3
INF = float("inf")
_ELEM_BUDGET = 1 << 24  # [rows, C, D] elements per chunk of the twin


def chisq_matrix_plain(a: torch.Tensor, b: torch.Tensor,
                       b_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[Q, D] x [C, D] -> [Q, C] chi-square distances, in row chunks; +inf
    at the codewords that `b_mask` masks (K4m's twin)."""
    q, c = a.shape[0], b.shape[0]
    out = torch.empty((q, c), dtype=a.dtype, device=a.device)
    rows = max(1, _ELEM_BUDGET // max(c * a.shape[1], 1))
    for r0 in range(0, q, rows):
        ac = a[r0:r0 + rows, None, :]
        s = ac + b[None, :, :]
        diff = ac - b[None, :, :]
        pos = s > 0
        term = torch.where(pos, diff * diff / torch.where(pos, s, 1.0),
                           torch.zeros_like(s))
        out[r0:r0 + rows] = term.sum(-1)
    if b_mask is not None:
        out = torch.where(b_mask[None, :], out, torch.full_like(out, INF))
    return out


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries of each row, ascending, ties to the lower index
    (a stable sort; torch.topk does not promise that tie order)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def chisq_topk_plain(a, b, b_mask, k):
    return smallest_k(chisq_matrix_plain(a, b, b_mask), k)


def chisq_matrix(a: torch.Tensor,       # [Q, D] f32
                 b: torch.Tensor,       # [C, D] f32
                 b_mask: torch.Tensor,  # [C] bool
                 ) -> torch.Tensor:
    """K4m: the [Q, C] chi-square distances of every query to every
    codeword, +inf at masked codewords."""
    qn, dim = a.shape if a.dim() == 2 else (None, None)
    check("a", a, torch.float32, (qn, dim))
    check("b", b, torch.float32, (None, dim))
    check("b_mask", b_mask, torch.bool, (b.shape[0],))
    if dim == 0:
        raise ValueError("chisq_matrix needs D > 0")
    if not uses_kernel(a, b, b_mask):
        return chisq_matrix_plain(a, b, b_mask)
    out = torch.empty((qn, b.shape[0]), dtype=torch.float32, device=a.device)
    if qn and b.shape[0]:
        with torch.cuda.device(a.device):
            err = build.lib().pcd_chisq_matrix(
                a.data_ptr(), b.data_ptr(), b_mask.data_ptr(),
                out.data_ptr(), qn, b.shape[0], dim, stream_of(a))
        build.check(err, "chisq_matrix")
        build.count_launch("chisq_matrix")
    return out


def chisq_topk(a: torch.Tensor,       # [Q, D] f32
               b: torch.Tensor,       # [C, D] f32
               b_mask: torch.Tensor,  # [C] bool
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (distances [Q, k] ascending, indices [Q, k] int64) of each
    query's k nearest unmasked codewords under the chi-square distance."""
    qn, dim = a.shape if a.dim() == 2 else (None, None)
    check("a", a, torch.float32, (qn, dim))
    check("b", b, torch.float32, (None, dim))
    check("b_mask", b_mask, torch.bool, (b.shape[0],))
    if dim == 0 or not 1 <= k <= min(KMAX, b.shape[0]):
        raise ValueError(f"chisq_topk needs D > 0 and 1 <= k <= "
                         f"min({KMAX}, C); got D={dim}, k={k}, "
                         f"C={b.shape[0]}")
    if not uses_kernel(a, b, b_mask):
        return chisq_topk_plain(a, b, b_mask, k)
    dist = torch.empty((qn, k), dtype=torch.float32, device=a.device)
    idx = torch.empty((qn, k), dtype=torch.int32, device=a.device)
    if qn:
        with torch.cuda.device(a.device):
            err = build.lib().pcd_chisq_topk(
                a.data_ptr(), b.data_ptr(), b_mask.data_ptr(),
                dist.data_ptr(), idx.data_ptr(), qn, b.shape[0], dim, k,
                stream_of(a))
        build.check(err, "chisq_topk")
        build.count_launch("chisq_topk")
    return dist, idx.long()
