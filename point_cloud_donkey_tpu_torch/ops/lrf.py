"""SHOT local reference frames (port of point_cloud_donkey_tpu/ops/lrf.py,
SHOT type).

Algorithm (Tombari et al. ECCV 2010; PCL SHOTLocalReferenceFrameEstimation):
(R - d)-weighted covariance about the query over in-radius neighbours,
closed-form EVD (ops/eigh3.py), x = largest and z = smallest eigenvector,
each sign set by the majority of neighbour offsets (a tie keeps the EVD's
sign), y = z x x.  Frames with fewer than 5 in-radius neighbours are
invalid.  The moments and sign votes run through K1 and K2
(ops/kernels/lrf_moments.py), on exact coordinate differences, or with
``lrf_version`` 2 through K10 and K11 (K2 when z_only), on the matmul
identity -- the JAX package's PCD_PALLAS_LRF_V; the entry points read that
variable once with :func:`lrf_version_from_env` and pass it down.

The ReferenceFrameType variants (:func:`shot_na_lrf`, :func:`flare_lrf`,
:func:`board_lrf`) are XLA in the JAX package on every backend and plain
torch here, in its float operations: distances by the matmul identity
(ops/neighbors.pairwise_sqdist), moments by the moment identity, in row
chunks of the [B, Q, N] pairs.  SHOTNA is SHOT's (R - d)-weighted moments
about the query and x vote, its z sign the majority of the neighbours'
normals.  FLARE and BOARD take z as the plane-fit normal (uniform weights
about the neighbour mean) turned towards the origin, and x towards one
neighbour: FLARE's highest along z within the tangent radius, BOARD's
whose normal deviates most from z (excluding d^2 <= 1e-12 on the
identity).  Their decisions -- a sign vote, an argmax, the viewpoint dot
-- are where two float32 implementations part (ROADMAP C).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .eigh3 import eigh3x3
from .kernels import masked_centroid
from .kernels.lrf_moments import shot_lrf_fused
from .neighbors import (full_fp32, gather_rows, pairwise_sqdist,
                        radius_covariance, row_steps)


class LRFResult(NamedTuple):
    frames: torch.Tensor  # [..., Q, 3, 3] rows = x_axis, y_axis, z_axis
    valid: torch.Tensor   # [..., Q] bool


def shot_lrf(queries: torch.Tensor,   # [Q, 3] or [B, Q, 3]
             q_mask: torch.Tensor,    # [Q] or [B, Q]
             points: torch.Tensor,    # [N, 3] or [B, N, 3]
             mask: torch.Tensor,      # [N] or [B, N]
             radius: float,
             min_neighbors: int = 5,
             z_only: bool = False,
             lrf_version: int = 1) -> LRFResult:
    """SHOT LRFs at the queries, one cloud or a batch of clouds.  z_only
    skips the x-axis sign vote (valid only when the caller reads just z);
    lrf_version >= 2 runs the v2 kernels (K10, K11)."""
    single = points.dim() == 2
    if single:
        queries, q_mask = queries[None], q_mask[None]
        points, mask = points[None], mask[None]
    frames, valid = shot_lrf_fused(queries.contiguous(), q_mask,
                                   points.contiguous(), mask.contiguous(),
                                   radius, min_neighbors, z_only,
                                   lrf_version)
    if single:
        frames, valid = frames[0], valid[0]
    return LRFResult(frames=frames, valid=valid)


def lrf_version_from_env() -> int:
    """The LRF kernel version PCD_PALLAS_LRF_V selects (1 unless set), read
    where an entry point starts, as the JAX package's `_kernel_version`
    reads it: the same command runs the same kernels in both packages."""
    return int(os.environ.get("PCD_PALLAS_LRF_V", "1"))


def _r2(radius: float) -> float:
    """radius * radius in float32, as the JAX package squares its traced
    float32 radius."""
    r = np.float32(radius)
    return float(r * r)


def _flip_by_votes(v, dots, gate, n_in):
    """v turned where fewer gated dots are >= 0 than < 0 (a tie keeps
    v)."""
    plus = ((dots >= 0) & gate).sum(-1)
    return torch.where((plus < n_in - plus)[..., None], -v, v)


def shot_na_lrf(queries: torch.Tensor,   # [B, Q, 3]
                q_mask: torch.Tensor,    # [B, Q]
                points: torch.Tensor,    # [B, N, 3]
                normals: torch.Tensor,   # [B, N, 3]
                mask: torch.Tensor,      # [B, N]
                radius: float,
                min_neighbors: int = 5) -> LRFResult:
    """SHOT 'no-ambiguity' LRFs (ReferenceFrameType SHOTNA): the SHOT LRF
    with z's sign the majority of the in-radius neighbours' normals
    (dot(n_j, z) >= 0) instead of their offsets."""
    shift = masked_centroid(points, mask)
    pts_s = points - shift[:, None, :]
    q_s = queries - shift[:, None, :]
    r32 = float(np.float32(radius))
    r2 = _r2(radius)
    b, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    xx = (pts_s[..., :, None] * pts_s[..., None, :]).reshape(b, n, 9)
    frames, valid = [], []
    with full_fp32():
        for q0, q1 in row_steps(b, nq, n):
            q, qm = q_s[:, q0:q1], q_mask[:, q0:q1]
            d2 = pairwise_sqdist(q, pts_s)
            in_r = (d2 <= r2) & mask[:, None, :]
            w = torch.where(in_r, r32 - torch.sqrt(d2), torch.zeros_like(d2))
            n_in = in_r.sum(-1)
            s0 = w.sum(-1)
            s1 = w @ pts_s
            s2 = (w @ xx).reshape(b, q1 - q0, 3, 3)
            c = torch.where(qm[..., None], q, torch.zeros_like(q))
            cov = (s2 - c[..., :, None] * s1[..., None, :]
                   - s1[..., :, None] * c[..., None, :]
                   + s0[..., None, None] * c[..., :, None] * c[..., None, :])
            cov = cov / torch.clamp(s0, min=1e-30)[..., None, None]
            _, vecs = eigh3x3(cov)
            v1, v3 = vecs[..., :, 2], vecs[..., :, 0]
            dots_x = v1 @ pts_s.transpose(1, 2) \
                - (q * v1).sum(-1)[..., None]
            x_axis = _flip_by_votes(v1, dots_x, in_r, n_in)
            dots_z = v3 @ normals.transpose(1, 2)
            z_axis = _flip_by_votes(v3, dots_z, in_r, n_in)
            y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
            frames.append(torch.stack([x_axis, y_axis, z_axis], dim=-2))
            valid.append(qm & (n_in >= min_neighbors) & (s0 > 0))
    return LRFResult(frames=torch.cat(frames, 1), valid=torch.cat(valid, 1))


def _plane_z(queries, points, mask, radius):
    """The plane-fit normal at each query (uniform weights about the
    neighbour mean), turned towards the viewpoint (the origin)."""
    mom = radius_covariance(queries, points, mask, radius,
                            weighting="uniform", center="mean")
    _, vecs = eigh3x3(mom.cov)
    z = vecs[..., :, 0]
    flip = (z * (0.0 - queries)).sum(-1) < 0
    return torch.where(flip[..., None], -z, z)


def _frame_towards(queries, points, z, best):
    """Frames [.., 3, 3] with z and x the tangent projection of the
    direction to the points `best` (+x where it vanishes)."""
    dir_vec = gather_rows(points, best) - queries
    x = dir_vec - (dir_vec * z).sum(-1, keepdim=True) * z
    nrm = torch.linalg.norm(x, dim=-1, keepdim=True)
    fallback = torch.zeros_like(x)
    fallback[..., 0] = 1.0
    x = torch.where(nrm > 1e-8, x / torch.clamp(nrm, min=1e-12), fallback)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def flare_lrf(queries: torch.Tensor,   # [B, Q, 3]
              q_mask: torch.Tensor,    # [B, Q]
              points: torch.Tensor,    # [B, N, 3]
              normals: torch.Tensor,   # [B, N, 3] (not read)
              mask: torch.Tensor,      # [B, N]
              radius: float,
              tangent_radius: float,
              min_neighbors: int = 5) -> LRFResult:
    """FLARE LRFs (Petrelli & Di Stefano; ReferenceFrameType FLARE): z the
    plane-fit normal towards the viewpoint, x the tangent projection of
    the direction to the neighbour within `tangent_radius` highest along
    z.  Valid with `min_neighbors` within `radius` and one within the
    tangent radius."""
    z = _plane_z(queries, points, mask, radius)
    r2, t2 = _r2(radius), _r2(tangent_radius)
    b, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    frames, valid = [], []
    with full_fp32():
        for q0, q1 in row_steps(b, nq, n):
            q, zc = queries[:, q0:q1], z[:, q0:q1]
            d2 = pairwise_sqdist(q, points)
            in_t = (d2 <= t2) & mask[:, None, :]
            h = zc @ points.transpose(1, 2) - (q * zc).sum(-1)[..., None]
            h = torch.where(in_t, h, torch.full_like(h, -torch.inf))
            frames.append(_frame_towards(q, points, zc, h.argmax(-1)))
            n_in = ((d2 <= r2) & mask[:, None, :]).sum(-1)
            valid.append(q_mask[:, q0:q1] & (n_in >= min_neighbors)
                         & in_t.any(-1))
    return LRFResult(frames=torch.cat(frames, 1), valid=torch.cat(valid, 1))


def board_lrf(queries: torch.Tensor,   # [B, Q, 3]
              q_mask: torch.Tensor,    # [B, Q]
              points: torch.Tensor,    # [B, N, 3]
              normals: torch.Tensor,   # [B, N, 3]
              mask: torch.Tensor,      # [B, N]
              radius: float,
              min_neighbors: int = 5) -> LRFResult:
    """BOARD LRFs (Petrelli & Di Stefano; ReferenceFrameType BOARD, the
    JAX package's simplified variant without hole compensation): z the
    plane-fit normal towards the viewpoint, x the tangent projection of
    the direction to the in-radius neighbour whose normal deviates most
    from z.  A neighbour at d^2 <= 1e-12 (the identity's) is no
    neighbour."""
    z = _plane_z(queries, points, mask, radius)
    r2 = _r2(radius)
    b, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    frames, valid = [], []
    with full_fp32():
        for q0, q1 in row_steps(b, nq, n):
            q, zc = queries[:, q0:q1], z[:, q0:q1]
            d2 = pairwise_sqdist(q, points)
            in_r = (d2 <= r2) & mask[:, None, :] & (d2 > 1e-12)
            cosdev = zc @ normals.transpose(1, 2)
            score = torch.where(in_r, -cosdev,
                                torch.full_like(cosdev, -torch.inf))
            frames.append(_frame_towards(q, points, zc, score.argmax(-1)))
            valid.append(q_mask[:, q0:q1]
                         & (in_r.sum(-1) >= min_neighbors))
    return LRFResult(frames=torch.cat(frames, 1), valid=torch.cat(valid, 1))
