"""FPFH-33 descriptor (port of point_cloud_donkey_tpu/ops/fpfh.py; Rusu et
al., PCL FPFHEstimation, wrapped by the reference at
features/features_fpfh.cpp), batched over clouds.

Per pair (p, q) the Darboux-frame features of pcl::computePairFeatures
(pfh_tools.cpp), with its source/target swap (the point whose normal makes
the smaller angle with the connecting line is the source):
  f1 = atan2(w . n_t, n_s . n_t) in [-pi, pi]
  f2 = v . n_t                   in [-1, 1]
  f3 = n_s . (t - s) / d         in [-1, 1]
SPFH(p) = three 11-bin histograms over p's neighbours in PCL's block order
(f1 | f2 | f3), each increment 100 / #neighbours; degenerate pairs add
nothing but count in the denominator.  FPFH(p) = SPFH(p) + (1/k) sum_q
SPFH(q) / d(p, q)^2, each block renormalised to sum 100.

The neighbourhoods are fixed-capacity gathers (ops/neighbors.
gather_radius_neighbors, zero distances excluded), the histograms one
``scatter_add_`` over the (bin, weight) slots: the JAX package accumulates
them in XLA (ops/shot.py `_histogram_from_slots`), outside Pallas.  Every
block sums to 100 or to 0, inside K4's input range (csrc/chisq.cu).  A bin
comes from truncating a float feature, so a pair on a bin edge can land in
the neighbouring bin where atan2 or acos differ by an ulp.
"""

from __future__ import annotations

import math

import torch

from .neighbors import gather_radius_neighbors, gather_rows
from .shot import ShotResult

FPFH_BINS = 11
FPFH_LEN = 3 * FPFH_BINS
# [clouds, queries, capacity] pairs of one chunk of the SPFH pass
_PAIR_BUDGET = 1 << 22


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def pair_features_pcl(p1, n1, p2, n2):
    """pcl::computePairFeatures with the source/target swap; inputs
    broadcastable [..., 3]: (f1, f2, f3, f4 = d, degenerate)."""
    dp = p2 - p1
    f4 = torch.sqrt(_dot(dp, dp))
    dpn = dp / torch.clamp(f4, min=1e-12)[..., None]
    a1 = _dot(n1, dpn)
    a2 = _dot(n2, dpn)
    swap = torch.arccos(torch.clamp(torch.abs(a1), 0, 1)) > \
        torch.arccos(torch.clamp(torch.abs(a2), 0, 1))
    sw = swap[..., None]
    n1c = torch.where(sw, n2, n1)
    n2c = torch.where(sw, n1, n2)
    dpc = torch.where(sw, -dpn, dpn)
    # on a swap the connecting line flips: f3 = -a2 (pcl pair_features)
    f3 = torch.where(swap, -a2, a1)
    v = _cross(dpc, n1c)
    v_n = torch.sqrt(_dot(v, v))
    v = v / torch.clamp(v_n, min=1e-12)[..., None]
    w = _cross(n1c, v)
    f2 = _dot(v, n2c)
    f1 = torch.atan2(_dot(w, n2c), _dot(n1c, n2c))
    return f1, f2, f3, f4, v_n < 1e-12


def _spfh_bins(f1, f2, f3) -> torch.Tensor:
    """PCL's block packing: f1 (atan2) | f2 | f3, 11 bins each."""
    i32 = torch.int32
    b1 = torch.clamp((FPFH_BINS * (f1 + math.pi) / (2.0 * math.pi)).to(i32),
                     0, FPFH_BINS - 1)
    b2 = torch.clamp((FPFH_BINS * (f2 + 1.0) / 2.0).to(i32), 0,
                     FPFH_BINS - 1)
    b3 = torch.clamp((FPFH_BINS * (f3 + 1.0) / 2.0).to(i32), 0,
                     FPFH_BINS - 1)
    return torch.stack([b1, b2 + FPFH_BINS, b3 + 2 * FPFH_BINS], -1)


def _spfh(q, qn, nbr, points, normals) -> torch.Tensor:
    """[B, Q, 33] SPFH of the queries q [B, Q, 3] (normals qn) over their
    gathered neighbours."""
    nq = gather_rows(points, nbr.idx)
    nn = gather_rows(normals, nbr.idx)
    f1, f2, f3, _, deg = pair_features_pcl(q[..., None, :], qn[..., None, :],
                                           nq, nn)
    idx = _spfh_bins(f1, f2, f3)                                # [B, Q, M, 3]
    contrib = (nbr.valid & ~deg)[..., None]
    count = torch.clamp(nbr.valid.sum(-1), min=1)
    incr = (100.0 / count.to(points.dtype))[..., None, None]
    w = torch.where(contrib, incr, torch.zeros_like(incr)).expand(idx.shape)
    idx = torch.where(contrib, idx, torch.zeros_like(idx))
    b, nqr = q.shape[:2]
    hist = torch.zeros((b, nqr, FPFH_LEN), dtype=points.dtype,
                       device=points.device)
    hist.scatter_add_(2, idx.reshape(b, nqr, -1).long(),
                      w.reshape(b, nqr, -1).contiguous())
    return hist


def spfh_all_points(points: torch.Tensor,   # [B, N, 3]
                    normals: torch.Tensor,  # [B, N, 3]
                    mask: torch.Tensor,     # [B, N]
                    radius: float, capacity: int = 128) -> torch.Tensor:
    """[B, N, 33] SPFH of every point, in chunks of query rows."""
    b, n = mask.shape
    cap = min(capacity, n)
    out = torch.empty((b, n, FPFH_LEN), dtype=points.dtype,
                      device=points.device)
    step = max(1, _PAIR_BUDGET // max(b * cap, 1))
    for q0 in range(0, n, step):
        q = points[:, q0:q0 + step]
        nbr = gather_radius_neighbors(q, points, mask, radius, capacity,
                                      exclude_zero_dist=True)
        out[:, q0:q0 + step] = _spfh(q, normals[:, q0:q0 + step], nbr,
                                     points, normals)
    return out


def fpfh_descriptor(keypoints: torch.Tensor,  # [K, 3] / [B, K, 3]
                    kp_mask: torch.Tensor,    # [K] / [B, K]
                    points: torch.Tensor,     # [N, 3] / [B, N, 3]
                    normals: torch.Tensor,    # [N, 3] / [B, N, 3]
                    mask: torch.Tensor,       # [N] / [B, N]
                    radius: float, capacity: int = 128,
                    min_neighbors: int = 5) -> ShotResult:
    """FPFH-33 of every keypoint (the JAX ``fpfh_descriptor``): the
    keypoint's own SPFH with the normal of its nearest valid neighbour
    (an argmin over the distances, not slot 0, which an excluded
    zero-distance pair may hold), plus its neighbours' SPFH weighted by
    1 / d^2; valid with at least `min_neighbors` neighbours."""
    single = points.dim() == 2
    if single:
        keypoints, kp_mask, points, normals, mask = (
            x[None] for x in (keypoints, kp_mask, points, normals, mask))
    spfh = spfh_all_points(points, normals, mask, radius, capacity)
    nbr = gather_radius_neighbors(keypoints, points, mask, radius, capacity,
                                  exclude_zero_dist=True)
    nearest_slot = torch.argmin(nbr.dist, dim=-1, keepdim=True)
    nearest = torch.gather(nbr.idx, -1, nearest_slot)[..., 0]
    kp_normals = gather_rows(normals, nearest)
    spfh_kp = _spfh(keypoints, kp_normals, nbr, points, normals)

    inf = torch.full_like(nbr.dist, float("inf"))
    d_safe = torch.where(nbr.valid, torch.clamp(nbr.dist, min=1e-6), inf)
    wgt = torch.where(nbr.valid, 1.0 / (d_safe * d_safe),
                      torch.zeros_like(d_safe))               # [B, K, M]
    nb_spfh = gather_rows(spfh, nbr.idx)                      # [B, K, M, 33]
    k_count = torch.clamp(nbr.valid.sum(-1), min=1).to(points.dtype)
    acc = spfh_kp + torch.einsum("bkm,bkml->bkl", wgt, nb_spfh) \
        / k_count[..., None]
    blocks = acc.reshape(acc.shape[:-1] + (3, FPFH_BINS))
    sums = torch.clamp(blocks.sum(-1, keepdim=True), min=1e-30)
    out = (100.0 * blocks / sums).reshape(acc.shape)
    valid = kp_mask & (nbr.valid.sum(-1) >= min_neighbors)
    if single:
        return ShotResult(out[0], valid[0])
    return ShotResult(out, valid)
