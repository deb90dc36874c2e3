"""RoPS-135 (port of point_cloud_donkey_tpu/ops/rops.py; Guo et al.,
pcl::ROPSEstimation as wrapped at features/features_rops.cpp: 5 partition
bins, 3 rotations), batched over clouds: [B, K] keypoints over [B, K, M]
neighbour gathers.

As in the JAX package, the local surface is the in-radius neighbour block
(no triangulation) and the LRF the eigenvectors of the (r - d)-weighted
scatter about the keypoint (ops/eigh3.py), each axis pointed towards the
majority of the neighbours: a sign is a decision on a count of dot
products at 0, so a neighbour on an axis's plane can flip it.  Then 3
rotations about each axis, 3 plane projections each, a 5 x 5
distribution matrix over the projection's bounding box, and its central
moments mu11, mu21, mu12, mu22 and Shannon entropy; the moments take
either sign.
"""

from __future__ import annotations

import math

import torch

from .descriptors_misc import slot_histogram
from .eigh3 import eigh3x3
from .neighbors import NeighborBlock
from .shot import ShotResult

ROPS_BINS = 5
ROPS_ROTATIONS = 3
ROPS_LEN = 3 * ROPS_ROTATIONS * 3 * 5   # 135
# [rows, M, 27] elements of one chunk of keypoint rows
_ROPS_BUDGET = 1 << 24


def _axis_rotations(dtype, device) -> torch.Tensor:
    """[9, 3, 3]: for each local axis, rotations by k x 90 deg / 3,
    k = 1..3 (the JAX ``_axis_rotations``)."""
    mats = []
    step = math.pi / 2.0 / ROPS_ROTATIONS
    for axis in range(3):
        for k in range(1, ROPS_ROTATIONS + 1):
            c = float(torch.cos(torch.tensor(step * k, dtype=torch.float32)))
            s = float(torch.sin(torch.tensor(step * k, dtype=torch.float32)))
            if axis == 0:
                m = [[1, 0, 0], [0, c, -s], [0, s, c]]
            elif axis == 1:
                m = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            else:
                m = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            mats.append(m)
    return torch.tensor(mats, dtype=dtype, device=device)


def _distribution_stats(u, v, valid):
    """[..., 5] RoPS statistics of the projections u, v [..., M] of the
    valid points: the 5 x 5 distribution matrix over their bounding box,
    normalised to sum 1, its central moments and entropy."""
    dt = u.dtype
    big = torch.full_like(u, 1e9)
    u_min = torch.where(valid, u, big).amin(-1, keepdim=True)
    u_max = torch.where(valid, u, -big).amax(-1, keepdim=True)
    v_min = torch.where(valid, v, big).amin(-1, keepdim=True)
    v_max = torch.where(valid, v, -big).amax(-1, keepdim=True)
    du = torch.clamp(u_max - u_min, min=1e-12)
    dv = torch.clamp(v_max - v_min, min=1e-12)
    i32 = torch.int32
    bu = torch.clamp(((u - u_min) / du * ROPS_BINS).to(i32), 0,
                     ROPS_BINS - 1)
    bv = torch.clamp(((v - v_min) / dv * ROPS_BINS).to(i32), 0,
                     ROPS_BINS - 1)
    hist = slot_histogram(bu * ROPS_BINS + bv, valid.to(dt),
                          ROPS_BINS * ROPS_BINS, 2)
    hist = hist.reshape(hist.shape[:-1] + (ROPS_BINS, ROPS_BINS))
    total = torch.clamp(hist.sum((-1, -2), keepdim=True), min=1e-12)
    p = hist / total
    coords = (torch.arange(ROPS_BINS, dtype=dt, device=u.device) + 0.5) \
        / ROPS_BINS
    ci = coords[:, None]
    cj = coords[None, :]
    mi = (p * ci).sum((-1, -2), keepdim=True)
    mj = (p * cj).sum((-1, -2), keepdim=True)
    di, dj = ci - mi, cj - mj

    def mu(a, b):
        return (p * (di ** a) * (dj ** b)).sum((-1, -2))

    entropy = -torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
                           torch.zeros_like(p)).sum((-1, -2))
    return torch.stack([mu(1, 1), mu(2, 1), mu(1, 2), mu(2, 2), entropy], -1)


def _rops_rows(kp, q, dist, use, radius):
    """[R, 135] RoPS of keypoint rows kp [R, 3] over their neighbours q
    [R, M, 3] (distances dist, used where `use`)."""
    dt = q.dtype
    rel = torch.where(use[..., None], q - kp[:, None, :], torch.zeros_like(q))
    w = torch.where(use, torch.clamp(radius - dist, min=0.0),
                    torch.zeros_like(dist))
    wsum = torch.clamp(w.sum(-1), min=1e-12)
    cov = (w[..., None, None] * rel[..., :, None] * rel[..., None, :]
           ).sum(-3) / wsum[..., None, None]
    _, vecs = eigh3x3(cov)
    n_use = use.sum(-1).to(dt)

    def orient(v):
        dots = (rel * v[:, None, :]).sum(-1)
        plus = torch.where(use, (dots >= 0).to(dt),
                           torch.zeros_like(dots)).sum(-1)
        return torch.where((plus < n_use - plus)[:, None], -v, v)

    x_axis = orient(vecs[..., 2])
    z_axis = orient(vecs[..., 0])
    frame = torch.stack([x_axis, torch.linalg.cross(z_axis, x_axis), z_axis],
                        -2)                                      # [R, 3, 3]
    local = (frame[:, None, :, :] * rel[..., None, :]).sum(-1)   # [R, M, 3]
    rots = _axis_rotations(dt, q.device)                          # [9, 3, 3]
    rotated = (rots * local[..., None, None, :]).sum(-1)          # [R,M,9,3]
    rotated = rotated.transpose(1, 2)                             # [R,9,M,3]
    valid = use[:, None, :].expand(rotated.shape[:3])
    stats = [_distribution_stats(rotated[..., a], rotated[..., c], valid)
             for a, c in ((0, 1), (0, 2), (1, 2))]
    return torch.cat(stats, -1).reshape(len(kp), ROPS_LEN)


def rops_descriptor(keypoints: torch.Tensor,  # [B, K, 3]
                    kp_mask: torch.Tensor,    # [B, K]
                    points: torch.Tensor,     # [B, N, 3]
                    nbr: NeighborBlock,       # [B, K, M]
                    radius: float,
                    min_neighbors: int = 5) -> ShotResult:
    """RoPS-135 of every keypoint (the JAX ``rops_descriptor``), in chunks
    of keypoint rows."""
    b, k, m = nbr.idx.shape
    use = nbr.valid & torch.isfinite(nbr.dist)
    rows = b * k
    flat = (keypoints.reshape(rows, 3), nbr.idx.reshape(rows, m),
            nbr.dist.reshape(rows, m), use.reshape(rows, m))
    cloud = torch.arange(b, device=points.device).repeat_interleave(k)
    desc = torch.empty((rows, ROPS_LEN), dtype=points.dtype,
                       device=points.device)
    step = max(1, _ROPS_BUDGET // max(m * 27, 1))
    for r0 in range(0, rows, step):
        kp, idx, dist, u = (x[r0:r0 + step] for x in flat)
        q = points[cloud[r0:r0 + step, None], idx]
        desc[r0:r0 + step] = _rops_rows(kp, q, dist, u, radius)
    return ShotResult(desc.reshape(b, k, ROPS_LEN),
                      kp_mask & (use.sum(-1) >= min_neighbors))
