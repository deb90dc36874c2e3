"""Normals for ConsistentNormalsMethod 2 (port of ``compute_normals_fast``,
``pca_normals_at`` and ``compute_normals`` of
point_cloud_donkey_tpu/ops/normals.py; methods 0, 1 and 3 are not
ported)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .eigh3 import eigh3x3
from .lrf import shot_lrf
from .neighbors import radius_covariance


class NormalsResult(NamedTuple):
    normals: torch.Tensor      # [..., N, 3]
    curvature: torch.Tensor    # [..., N]
    eigenvalues: torch.Tensor  # [..., N, 3] ascending
    valid: torch.Tensor        # [..., N] enough neighbours for the PCA


def compute_normals_fast(points: torch.Tensor,  # [N, 3] or [B, N, 3]
                         mask: torch.Tensor,    # [N] or [B, N]
                         radius: float,
                         lrf_version: int = 1) -> torch.Tensor:
    """Normal = inverted z axis of each point's own SHOT LRF (radius
    NormalRadius).  Points whose LRF is invalid (< 5 in-radius neighbours)
    get +z, not the PCA normal, as in the JAX serving path.  Only z is
    read, so the x sign vote is skipped (z_only)."""
    lrf = shot_lrf(points, mask, points, mask, radius, z_only=True,
                   lrf_version=lrf_version)
    z = -lrf.frames[..., 2, :]
    up = torch.zeros_like(z)
    up[..., 2] = 1.0
    return torch.where(lrf.valid[..., None], z, up)


def pca_normals_at(queries: torch.Tensor,   # [B, Q, 3]
                   q_mask: torch.Tensor,    # [B, Q]
                   points: torch.Tensor,    # [B, N, 3]
                   mask: torch.Tensor,      # [B, N]
                   radius: float,
                   min_neighbors: int = 3) -> NormalsResult:
    """PCA normals (PCL NormalEstimation): the smallest eigenvector of the
    uniform covariance of the in-radius neighbours about their mean;
    curvature = lambda_0 / (lambda_0 + lambda_1 + lambda_2)."""
    mom = radius_covariance(queries, points, mask, radius,
                            weighting="uniform", center="mean")
    vals, vecs = eigh3x3(mom.cov)
    total = vals.sum(-1)
    curvature = torch.where(total > 0,
                            vals[..., 0] / torch.clamp(total, min=1e-30),
                            torch.zeros_like(total))
    return NormalsResult(normals=vecs[..., :, 0], curvature=curvature,
                         eigenvalues=vals,
                         valid=q_mask & (mom.count >= min_neighbors))


def compute_normals(points: torch.Tensor,  # [B, N, 3]
                    mask: torch.Tensor,    # [B, N]
                    radius: float,
                    method: int = 2,
                    lrf_version: int = 1) -> NormalsResult:
    """ConsistentNormalsMethod 2 with its PCA fallback: the inverted z axis
    of each point's full SHOT LRF (both sign votes), the PCA normal where
    that LRF is invalid; curvature and eigenvalues from the PCA."""
    if method != 2:
        raise NotImplementedError(
            f"ConsistentNormalsMethod {method}: the port computes method 2 "
            "only")
    pca = pca_normals_at(points, mask, points, mask, radius)
    lrf = shot_lrf(points, mask, points, mask, radius,
                   lrf_version=lrf_version)
    normals = torch.where(lrf.valid[..., None], -lrf.frames[..., 2, :],
                          pca.normals)
    return pca._replace(normals=normals)
