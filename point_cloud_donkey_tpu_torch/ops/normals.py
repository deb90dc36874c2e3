"""Normals (port of ``compute_normals_fast``, ``pca_normals_at``,
``orient_towards_viewpoint``, ``orient_away_from_centroid``,
``compute_normals_at`` and ``compute_normals`` of
point_cloud_donkey_tpu/ops/normals.py), batched over B.

ConsistentNormalsMethod 0 orients the PCA normal towards the viewpoint
(the origin), 1 away from the cloud's masked centroid, 2 takes the inverted
z axis of each point's SHOT LRF (PCA where it is invalid); any other method
(3's EMST orientation is a host step of the training route) is the PCA
normal as it comes, as in the JAX serving step.  The PCA runs on the
moment identity in full fp32 (ops/neighbors.radius_covariance), as the JAX
package computes it in XLA."""

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


def orient_towards_viewpoint(points: torch.Tensor,   # [..., N, 3]
                             normals: torch.Tensor   # [..., N, 3]
                             ) -> torch.Tensor:
    """Flip each normal whose dot with (viewpoint - point) is negative; the
    viewpoint is the origin, as every caller of the JAX function has it."""
    flip = torch.sum(-points * normals, dim=-1) < 0
    return torch.where(flip[..., None], -normals, normals)


def orient_away_from_centroid(points: torch.Tensor,    # [B, N, 3]
                              normals: torch.Tensor,   # [B, N, 3]
                              centroid: torch.Tensor   # [B, 3]
                              ) -> torch.Tensor:
    """Flip each normal whose dot with (point - centroid) is negative."""
    flip = torch.sum((points - centroid[:, None, :]) * normals, dim=-1) < 0
    return torch.where(flip[..., None], -normals, normals)


def compute_normals_at(queries: torch.Tensor,  # [B, Q, 3]
                       q_mask: torch.Tensor,   # [B, Q]
                       points: torch.Tensor,   # [B, N, 3]
                       mask: torch.Tensor,     # [B, N]
                       radius: float,
                       method: int = 2,
                       lrf_version: int = 1) -> NormalsResult:
    """The normal pipeline of ConsistentNormalsMethod `method` at the query
    positions (module docstring); method 1's centroid is each cloud's
    masked centroid of `points`.  Curvature, eigenvalues and validity (>= 3
    in-radius neighbours) come from the PCA."""
    pca = pca_normals_at(queries, q_mask, points, mask, radius)
    if method == 0:
        normals = orient_towards_viewpoint(queries, pca.normals)
    elif method == 1:
        m = mask.to(points.dtype)
        centroid = (points * m[..., None]).sum(-2) \
            / torch.clamp(m.sum(-1), min=1.0)[..., None]
        normals = orient_away_from_centroid(queries, pca.normals, centroid)
    elif method == 2:
        lrf = shot_lrf(queries, q_mask, points, mask, radius,
                       lrf_version=lrf_version)
        normals = torch.where(lrf.valid[..., None], -lrf.frames[..., 2, :],
                              pca.normals)
    else:
        normals = pca.normals
    return pca._replace(normals=normals)


def compute_normals(points: torch.Tensor,  # [B, N, 3]
                    mask: torch.Tensor,    # [B, N]
                    radius: float,
                    method: int = 2,
                    lrf_version: int = 1) -> NormalsResult:
    """:func:`compute_normals_at` at every point of the clouds."""
    return compute_normals_at(points, mask, points, mask, radius, method,
                              lrf_version)
