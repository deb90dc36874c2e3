"""Principal curvatures (port of point_cloud_donkey_tpu/ops/curvature.py:
PCL PrincipalCurvaturesEstimation, used by keypoint culling --
keypoints/keypoints_voxel_grid_culling.cpp:136-153), batched over clouds.

For each query with normal n: the normals of its in-radius neighbours are
projected into the tangent plane (M = I - n n^T; n as given -- PCL feeds
voxel-averaged, unnormalised normals here), demeaned, and their summed
outer products form a covariance; pc1 = its largest eigenvalue / count,
pc2 = the middle one / count.  The sums run through M without a [Q, N, 3]
tensor: sum_j w p p^T = M (sum_j w m m^T) M^T, as matrix products in full
fp32 (the JAX package's HIGHEST precision), in query chunks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .eigh3 import eigvals3x3
from .neighbors import full_fp32

_PAIR_BUDGET = 1 << 25  # elements of a [B, chunk, N] temporary


class CurvatureResult(NamedTuple):
    pc1: torch.Tensor    # [..., Q] largest eigenvalue / count
    pc2: torch.Tensor    # [..., Q] middle eigenvalue / count
    valid: torch.Tensor  # [..., Q] at least 2 neighbours


def principal_curvatures(queries: torch.Tensor,        # [(B,) Q, 3]
                         query_normals: torch.Tensor,  # [(B,) Q, 3]
                         points: torch.Tensor,         # [(B,) N, 3]
                         normals: torch.Tensor,        # [(B,) N, 3]
                         mask: torch.Tensor,           # [(B,) N]
                         radius: float) -> CurvatureResult:
    single = points.dim() == 2
    if single:
        queries, query_normals = queries[None], query_normals[None]
        points, normals, mask = points[None], normals[None], mask[None]
    b, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    r2 = float(np.float32(radius * radius))
    p2 = torch.sum(points * points, dim=-1)[:, None, :]
    mm = (normals[..., :, None] * normals[..., None, :]).reshape(b, n, 9)
    cnt = torch.empty((b, nq), dtype=points.dtype, device=points.device)
    s1 = torch.empty((b, nq, 3), dtype=points.dtype, device=points.device)
    s2 = torch.empty((b, nq, 9), dtype=points.dtype, device=points.device)
    step = max(1, _PAIR_BUDGET // max(b * n, 1))
    with full_fp32():
        for q0 in range(0, nq, step):
            qc = queries[:, q0:q0 + step]
            q2 = torch.sum(qc * qc, dim=-1)[..., None]
            d2 = torch.clamp(q2 + p2 - 2.0 * (qc @ points.transpose(1, 2)),
                             min=0.0)
            w = ((d2 <= r2) & mask[:, None, :]).to(points.dtype)
            cnt[:, q0:q0 + step] = w.sum(-1)
            s1[:, q0:q0 + step] = w @ normals
            s2[:, q0:q0 + step] = w @ mm
    s2 = s2.reshape(b, nq, 3, 3)
    cnt_safe = torch.clamp(cnt, min=1.0)
    nv = query_normals
    ndot_s1 = torch.sum(nv * s1, dim=-1)
    ps1 = s1 - ndot_s1[..., None] * nv                      # M s1
    s2n = torch.einsum("bqij,bqj->bqi", s2, nv)             # S2 n
    nts2n = torch.sum(nv * s2n, dim=-1)
    ms2m = (s2 - nv[..., :, None] * s2n[..., None, :]
            - s2n[..., :, None] * nv[..., None, :]
            + nts2n[..., None, None] * nv[..., :, None] * nv[..., None, :])
    mu = ps1 / cnt_safe[..., None]
    cov = ms2m - cnt_safe[..., None, None] * mu[..., :, None] \
        * mu[..., None, :]
    vals = eigvals3x3(cov) / cnt_safe[..., None]   # ascending, / count
    res = CurvatureResult(pc1=vals[..., 2], pc2=vals[..., 1], valid=cnt >= 2)
    if single:
        res = CurvatureResult(*(x[0] for x in res))
    return res
