"""Neighbourhood primitives (port of the ``pairwise_sqdist``,
``radius_covariance``, ``gather_radius_neighbors``,
``chi_square_distance_matrix``, ``descriptor_distance`` and ``knn`` of
point_cloud_donkey_tpu/ops/neighbors.py).

``gather_radius_neighbors`` gives each query its `capacity` nearest
in-radius neighbours in a fixed-size block, as ``jax.lax.top_k`` orders
them: ascending squared distance (the matmul identity), the lower index
first among equal distances -- one int64 key a pair, the distance's bits
above the index (``torch.topk`` on the floats orders ties arbitrarily,
which would move the capacity cut and FPFH's nearest slot).

``knn`` is exact for both metrics, as the JAX package is on CPU and GPU
backends: "l2" is squared L2 through the matmul identity in full fp32,
"chisq" is flann::ChiSquareDistance through K4 (ops/kernels/chisq.py) for
k <= 3 and, for larger k, K4m's [Q, C] matrix in row chunks with the k
smallest of each row taken by a stable sort.  Masked database entries are
+inf; ties go to the lower index.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import torch

from .kernels import masked_centroid
from .kernels.chisq import (KMAX, chisq_matrix, chisq_matrix_plain,
                            chisq_topk, smallest_k)

_PAIR_BUDGET = 1 << 25  # elements of a [B, chunk, N] temporary
_MATRIX_BYTES = 256 << 20  # a [rows, C] f32 block of K4m's matrix

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
    """Squared euclidean distances [..., Q, N] of queries [..., Q, 3] and
    points [..., N, 3] via q^2 + p^2 - 2 q.p in full fp32, clamped at 0."""
    q2 = torch.sum(queries * queries, dim=-1)[..., None]
    p2 = torch.sum(points * points, dim=-1)[..., None, :]
    with full_fp32():
        cross = queries @ points.transpose(-1, -2)
    return torch.clamp(q2 + p2 - 2.0 * cross, min=0.0)


def row_steps(g: int, nq: int, w: int):
    """Query ranges [r0, r1) of [g, r1 - r0, w] temporaries under
    _PAIR_BUDGET elements."""
    step = max(1, _PAIR_BUDGET // max(g * w, 1))
    return [(r0, min(nq, r0 + step)) for r0 in range(0, nq, step)]


class RadiusMoments(NamedTuple):
    """Weighted neighbourhood moments of a batch of queries."""
    count: torch.Tensor   # [..., Q] in-radius unmasked neighbours
    wsum: torch.Tensor    # [..., Q] sum of the weights
    mean: torch.Tensor    # [..., Q, 3] weighted neighbour mean
    cov: torch.Tensor     # [..., Q, 3, 3] weighted covariance about the centre


def radius_covariance(queries: torch.Tensor,   # [B, Q, 3]
                      points: torch.Tensor,    # [B, N, 3]
                      mask: torch.Tensor,      # [B, N]
                      radius: float,
                      weighting: str = "uniform",
                      center: str = "mean") -> RadiusMoments:
    """Radius-limited weighted covariance of each query's neighbours, per
    cloud, by the moment identity cov = S2 - c s1^T - s1 c^T + S0 c c^T
    about c = the weighted neighbour mean ("mean", PCL normals) or the
    query ("query", the SHOT LRF), with uniform or (r - d) ("shot")
    weights.  Points and queries are shifted to the cloud's masked centroid
    first; distances by the matmul identity and the moment products in full
    fp32 (the XLA path of the JAX package, whose precision is HIGHEST)."""
    if weighting not in ("uniform", "shot"):
        raise ValueError(f"unknown weighting {weighting}")
    if center not in ("mean", "query"):
        raise ValueError(f"unknown center {center}")
    shift = masked_centroid(points, mask)                          # [B, 3]
    points = points - shift[:, None, :]
    queries = queries - shift[:, None, :]
    b, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    p2 = torch.sum(points * points, dim=-1)[:, None, :]
    xx = (points[..., :, None] * points[..., None, :]).reshape(b, n, 9)
    count = torch.empty((b, nq), dtype=torch.int64, device=points.device)
    s0 = torch.empty((b, nq), dtype=points.dtype, device=points.device)
    s1 = torch.empty((b, nq, 3), dtype=points.dtype, device=points.device)
    s2 = torch.empty((b, nq, 9), dtype=points.dtype, device=points.device)
    step = max(1, _PAIR_BUDGET // max(b * n, 1))
    with full_fp32():
        for q0 in range(0, nq, step):
            qc = queries[:, q0:q0 + step]
            q2 = torch.sum(qc * qc, dim=-1)[..., None]
            d2 = torch.clamp(q2 + p2 - 2.0 * (qc @ points.transpose(1, 2)),
                             min=0.0)
            in_r = (d2 <= r2) & mask[:, None, :]
            if weighting == "uniform":
                w = in_r.to(points.dtype)
            else:
                w = torch.where(in_r, radius - torch.sqrt(d2),
                                torch.zeros_like(d2))
            count[:, q0:q0 + step] = in_r.sum(-1)
            s0[:, q0:q0 + step] = w.sum(-1)
            s1[:, q0:q0 + step] = w @ points
            s2[:, q0:q0 + step] = w @ xx
    s2 = s2.reshape(b, nq, 3, 3)
    s0_safe = torch.clamp(s0, min=1e-30)
    c = s1 / s0_safe[..., None] if center == "mean" else queries
    cov = (s2 - c[..., :, None] * s1[..., None, :]
           - s1[..., :, None] * c[..., None, :]
           + s0[..., None, None] * c[..., :, None] * c[..., None, :])
    cov = cov / s0_safe[..., None, None]
    mean = s1 / s0_safe[..., None] + shift[:, None, :]
    return RadiusMoments(count=count, wsum=s0, mean=mean, cov=cov)


class NeighborBlock(NamedTuple):
    """Fixed-capacity neighbour gather."""
    idx: torch.Tensor    # [..., Q, M] neighbour indices (0 where invalid)
    dist: torch.Tensor   # [..., Q, M] euclidean distances (inf where invalid)
    valid: torch.Tensor  # [..., Q, M] bool


def gather_radius_neighbors(queries: torch.Tensor,  # [Q, 3] / [B, Q, 3]
                            points: torch.Tensor,   # [N, 3] / [B, N, 3]
                            mask: torch.Tensor,     # [N] / [B, N]
                            radius: float, capacity: int,
                            exclude_zero_dist: bool = False
                            ) -> NeighborBlock:
    """Up to min(capacity, N) nearest in-radius unmasked neighbours of each
    query, ascending (PCL radiusSearch's order), the farthest dropped past
    the capacity: the pre-gate and the order on the matmul identity (full
    fp32), then the exact distances of the gathered block gated again,
    and with `exclude_zero_dist` pairs at squared distance <= 1e-15
    dropped (features_short_shot.cpp:127)."""
    single = points.dim() == 2
    if single:
        queries, points, mask = queries[None], points[None], mask[None]
    b, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    cap = min(capacity, n)
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    p2 = torch.sum(points * points, dim=-1)[:, None, :]
    idx = torch.empty((b, nq, cap), dtype=torch.int64, device=points.device)
    valid = torch.empty((b, nq, cap), dtype=torch.bool, device=points.device)
    # one int64 key a pair: the bits of d2 (>= 0, so ordered as the
    # floats) above the point's index, unique, so the order is JAX's
    col = torch.arange(n, device=points.device)
    inf_key = torch.tensor(float("inf")).view(torch.int32).item()
    step = max(1, _PAIR_BUDGET // max(b * n, 1))
    with full_fp32():
        for q0 in range(0, nq, step):
            qc = queries[:, q0:q0 + step]
            q2 = torch.sum(qc * qc, dim=-1)[..., None]
            d2 = torch.clamp(q2 + p2 - 2.0 * (qc @ points.transpose(1, 2)),
                             min=0.0)
            d2 = torch.where((d2 <= r2) & mask[:, None, :], d2,
                             torch.full_like(d2, float("inf")))
            key = (d2.view(torch.int32).to(torch.int64) << 32) | col
            del d2
            if 2 * cap < n:
                top = torch.topk(key, cap, dim=-1, largest=False,
                                 sorted=True).values
            else:
                top = torch.sort(key, dim=-1).values[..., :cap]
            del key
            idx[:, q0:q0 + step] = top & 0xFFFFFFFF
            valid[:, q0:q0 + step] = (top >> 32) != inf_key
            del top
    nb = gather_rows(points, idx)
    dx = nb[..., 0] - queries[..., None, 0]
    dy = nb[..., 1] - queries[..., None, 1]
    dz = nb[..., 2] - queries[..., None, 2]
    d2e = dx * dx + dy * dy + dz * dz
    valid = valid & (d2e <= r2)
    if exclude_zero_dist:
        valid = valid & (d2e > 1e-15)
    dist = torch.where(valid, torch.sqrt(d2e),
                       torch.full_like(d2e, float("inf")))
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    if single:
        return NeighborBlock(idx[0], dist[0], valid[0])
    return NeighborBlock(idx, dist, valid)


def gather_rows(x: torch.Tensor,    # [B, N, ...]
                idx: torch.Tensor   # [B, ...] indices into N
                ) -> torch.Tensor:
    """x[b, idx[b, ...]] of every cloud b: [B, *idx.shape[1:], ...]."""
    b = x.shape[0]
    xf = x.reshape(b, x.shape[1], -1)
    out = torch.gather(xf, 1, idx.reshape(b, -1, 1).expand(-1, -1,
                                                            xf.shape[2]))
    return out.reshape(tuple(idx.shape) + tuple(x.shape[2:]))


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
        a, b, m = (x.contiguous() for x in (queries, database, db_mask))
        if k <= KMAX:
            return chisq_topk(a, b, m, k)
        return _chisq_smallest_k(a, b, m, k)
    raise ValueError(f"unknown metric {metric}")


def _chisq_smallest_k(a, b, b_mask, k):
    """k > KMAX: K4m's matrix in row chunks of at most _MATRIX_BYTES, the
    k smallest of each row by `smallest_k`."""
    c = b.shape[0]
    if not 1 <= k <= c:
        raise ValueError(f"knn needs 1 <= k <= C; got k={k}, C={c}")
    rows = max(1, _MATRIX_BYTES // (4 * c))
    parts = [smallest_k(chisq_matrix(a[r0:r0 + rows], b, b_mask), k)
             for r0 in range(0, a.shape[0], rows)]
    if not parts:
        return (torch.empty((0, k), dtype=torch.float32, device=a.device),
                torch.empty((0, k), dtype=torch.int64, device=a.device))
    return (torch.cat([d for d, _ in parts]),
            torch.cat([i for _, i in parts]))
