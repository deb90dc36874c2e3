"""Cloud preprocessing filters (port of point_cloud_donkey_tpu/ops/preprocess.py,
implicit_shape_model.cpp:739-821), one cloud at a time.

The filters update a validity mask over the cloud's points, except MLS,
which moves them; the voxel filter is ``ops/voxel_grid.voxel_grid`` with
the points' normals and colours as features (models/ism.preprocess_cloud).

  * Statistical outlier removal (PCL StatisticalOutlierRemoval): the mean
    distance of each point to its mean_k nearest neighbours; points whose
    mean exceeds global mean + stddev_mul * global stddev go.
  * Radius outlier removal: points with fewer than min_neighbors others
    within the radius go.
  * MLS smoothing, polynomial order 1: each point with at least 3 points in
    its radius is projected onto the PCA plane of that neighbourhood.
  * Z pass-through: points with z outside [0, cutoff] go.

Distances come from the matmul identity in full fp32
(``ops/neighbors.pairwise_sqdist``), as the JAX package computes them, in
row chunks so no [N, N] matrix is held.
"""

from __future__ import annotations

import torch

from .eigh3 import eigh3x3
from .kernels import f32
from .neighbors import pairwise_sqdist, radius_covariance

_ROWS_BUDGET = 1 << 24   # elements of a [rows, N] distance block


def _row_chunks(n: int):
    step = max(1, _ROWS_BUDGET // max(n, 1))
    return [(r0, min(n, r0 + step)) for r0 in range(0, n, step)]


def statistical_outlier_removal(points: torch.Tensor,  # [N, 3]
                                mask: torch.Tensor,    # [N]
                                mean_k: int, stddev_mul: float
                                ) -> torch.Tensor:
    """The filtered mask: each point's k = mean_k + 1 smallest squared
    distances to the unmasked points, the smallest (itself) dropped, their
    square roots averaged over the finite ones."""
    n = points.shape[0]
    k = min(mean_k + 1, n)
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    mean_d = torch.empty(n, dtype=points.dtype, device=points.device)
    for r0, r1 in _row_chunks(n):
        d2 = torch.where(mask[None, :], pairwise_sqdist(points[r0:r1], points),
                         inf)
        near = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        d = torch.sqrt(torch.clamp(near[:, 1:], min=0.0))
        finite = torch.isfinite(d)
        mean_d[r0:r1] = torch.where(finite, d, torch.zeros_like(d)).sum(1) \
            / torch.clamp(finite.sum(1), min=1).to(points.dtype)
    m = mask.to(points.dtype)
    cnt = torch.clamp(m.sum(), min=1.0)
    zero = torch.zeros_like(mean_d)
    g_mean = torch.where(mask, mean_d, zero).sum() / cnt
    g_var = torch.where(mask, (mean_d - g_mean) ** 2, zero).sum() / cnt
    thresh = g_mean + stddev_mul * torch.sqrt(g_var)
    return mask & (mean_d <= thresh)


def radius_outlier_removal(points: torch.Tensor, mask: torch.Tensor,
                           radius: float, min_neighbors: int
                           ) -> torch.Tensor:
    """The filtered mask: points with at least min_neighbors other unmasked
    points within the radius."""
    r2 = f32(radius * radius)
    count = torch.empty(points.shape[0], dtype=torch.int64,
                        device=points.device)
    for r0, r1 in _row_chunks(points.shape[0]):
        d2 = pairwise_sqdist(points[r0:r1], points)
        count[r0:r1] = ((d2 <= r2) & mask[None, :]).sum(1) - 1
    return mask & (count >= min_neighbors)


def mls_smooth(points: torch.Tensor, mask: torch.Tensor,
               radius: float) -> torch.Tensor:
    """Order-1 MLS: the points [N, 3] projected onto the plane of their
    radius neighbourhood's PCA (the smallest eigenvector of its uniform
    covariance about its mean); points with under 3 neighbours, and masked
    points, stay."""
    mom = radius_covariance(points[None], points[None], mask[None], radius,
                            weighting="uniform", center="mean")
    _, vecs = eigh3x3(mom.cov[0])
    normal = vecs[..., 0]
    delta = points - mom.mean[0]
    proj = points - torch.sum(delta * normal, dim=1, keepdim=True) * normal
    ok = mom.count[0] >= 3
    return torch.where((mask & ok)[:, None], proj, points)


def z_cutoff(points: torch.Tensor, mask: torch.Tensor,
             cutoff: float) -> torch.Tensor:
    """PassThrough on z in [0, cutoff] (implicit_shape_model.cpp:810-821)."""
    return mask & (points[:, 2] >= 0.0) & (points[:, 2] <= cutoff)
