"""Descriptor-space neighbour search (port of the ``pairwise_sqdist``,
``chi_square_distance_matrix``, ``descriptor_distance`` and ``knn`` of
point_cloud_donkey_tpu/ops/neighbors.py).

``knn`` is exact for both metrics, as the JAX package is on CPU and GPU
backends: "l2" is squared L2 through the matmul identity in full fp32,
"chisq" is flann::ChiSquareDistance through K4 (ops/kernels/chisq.py).
Masked database entries are +inf; ties go to the lower index.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from .kernels.chisq import chisq_matrix_plain, chisq_topk, smallest_k

chi_square_distance_matrix = chisq_matrix_plain


@contextlib.contextmanager
def full_fp32():
    """Run matmuls and convolutions in full fp32 (no TF32) for the
    duration, as the reference's Precision.HIGHEST does; restores the
    previous settings on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def pairwise_sqdist(queries: torch.Tensor, points: torch.Tensor
                    ) -> torch.Tensor:
    """Squared euclidean distances [Q, N] via q^2 + p^2 - 2 q.p in full
    fp32, clamped at 0."""
    q2 = torch.sum(queries * queries, dim=1)[:, None]
    p2 = torch.sum(points * points, dim=1)[None, :]
    with full_fp32():
        cross = queries @ points.T
    return torch.clamp(q2 + p2 - 2.0 * cross, min=0.0)


def descriptor_distance(a: torch.Tensor, b: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """Distance between two equal-shaped descriptor batches [..., D]."""
    if metric == "l2":
        diff = a - b
        return torch.sum(diff * diff, dim=-1)
    if metric == "chisq":
        s = a + b
        diff = a - b
        return torch.sum(torch.where(s > 0, diff * diff
                                     / torch.where(s > 0, s, 1.0),
                                     torch.zeros_like(s)), dim=-1)
    raise ValueError(f"unknown metric {metric}")


def knn(queries: torch.Tensor,    # [Q, D]
        database: torch.Tensor,   # [C, D]
        db_mask: torch.Tensor,    # [C]
        k: int,
        metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k-NN: (distances [Q, k] ascending, indices [Q, k])."""
    if metric == "l2":
        d = pairwise_sqdist(queries, database)
        d = torch.where(db_mask[None, :], d, torch.full_like(d, float("inf")))
        return smallest_k(d, k)
    if metric == "chisq":
        return chisq_topk(queries.contiguous(), database.contiguous(),
                          db_mask.contiguous(), k)
    raise ValueError(f"unknown metric {metric}")
