"""Normals (port of ``compute_normals_fast``, ``pca_normals_at``,
``orient_towards_viewpoint``, ``orient_away_from_centroid``,
``compute_normals_at``, ``compute_normals`` and ``orient_emst`` of
point_cloud_donkey_tpu/ops/normals.py), batched over B.

ConsistentNormalsMethod 0 orients the PCA normal towards the viewpoint
(the origin), 1 away from the cloud's masked centroid, 2 takes the inverted
z axis of each point's SHOT LRF (PCA where it is invalid); any other method
(3's EMST orientation, :func:`orient_emst`, is a host step of the staged
training route) is the PCA normal as it comes, as in the JAX serving step.  The PCA runs on the
moment identity in full fp32 (ops/neighbors.radius_covariance), as the JAX
package computes it in XLA."""

from __future__ import annotations

from typing import NamedTuple

import heapq

import numpy as np
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


def orient_emst(points: np.ndarray, normals: np.ndarray,
                k: int = 10) -> np.ndarray:
    """ConsistentNormalsMethod 3 (the JAX ``orient_emst``): Hoppe-style
    orientation over a Euclidean MST of one cloud on the host -- Prim's
    tree over the kNN graph with edge weight 1 - |n_i . n_j|, grown from
    the highest point (oriented +z), each normal flipped to agree with its
    parent's.  Components the graph does not reach keep their normals."""
    pts = np.asarray(points)
    nrm = np.asarray(normals).copy()
    n = len(pts)
    if n == 0:
        return nrm
    if n <= 4096:
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        idxs = np.argpartition(d2, min(k + 1, n - 1), axis=1)[:, :k + 1]
    else:
        idxs = np.empty((n, k + 1), np.int64)
        for i0 in range(0, n, 1024):
            dd = ((pts[i0:i0 + 1024, None, :] - pts[None, :, :]) ** 2).sum(-1)
            idxs[i0:i0 + 1024] = np.argpartition(dd, k + 1, axis=1)[:, :k + 1]
    root = int(np.argmax(pts[:, 2]))
    if nrm[root, 2] < 0:
        nrm[root] = -nrm[root]
    visited = np.zeros(n, bool)
    visited[root] = True
    heap = []
    for j in idxs[root]:
        j = int(j)
        if j != root:
            heapq.heappush(heap, (1.0 - abs(float(nrm[root] @ nrm[j])),
                                  root, j))
    while heap:
        _, par, cur = heapq.heappop(heap)
        if visited[cur]:
            continue
        visited[cur] = True
        if nrm[par] @ nrm[cur] < 0:
            nrm[cur] = -nrm[cur]
        for j in idxs[cur]:
            j = int(j)
            if not visited[j]:
                heapq.heappush(heap, (1.0 - abs(float(nrm[cur] @ nrm[j])),
                                      cur, j))
    return nrm
