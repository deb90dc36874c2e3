"""3DSC / USC, RSD and RIFT (port of point_cloud_donkey_tpu/ops/
shape_context.py), batched over clouds: [B, K] keypoints over [B, K, M]
neighbour gathers.

3DSC and USC share one descriptor (12 azimuth x 11 elevation x 15
log-radial bins, 1980) in the SHOT LRF, each pair weighted by 1 / (the
neighbour's local density x the cube root of its bin's volume); the
density counts every point of the cloud within a fifth of the radius
(masked points too, as the JAX function counts them).  RIFT bins the
angle between each neighbour's intensity gradient and the radial
direction; the gradients (:func:`intensity_gradients`) solve a 3 x 3
least-squares system a point, its sums formed by the JAX function's
moment identity about the point (s2 - p s1^T - s1 p^T + s0 p p^T, not a
centred sum).  The whole-cloud passes ([N, N] in the JAX package) run over
chunks of query rows (ops/tiled.row_steps: each temporary under 128 MiB);
the distances come from the matmul identity in full fp32 (ops/tiled.
sqdist), as the JAX ``pairwise_sqdist``.
"""

from __future__ import annotations

import math

import torch

from .descriptors_misc import slot_histogram
from .kernels import f32
from .neighbors import NeighborBlock, full_fp32, gather_rows
from .shot import ShotResult
from .tiled import row_steps, sqdist

SC_AZ = 12
SC_EL = 11
SC_RAD = 15
SC_LEN = SC_AZ * SC_EL * SC_RAD  # 1980
def _local_density(points: torch.Tensor, radius: float) -> torch.Tensor:
    """[B, N] count of the points within `radius` of each point (all of
    them, masked or not, the point itself included)."""
    b, n, _ = points.shape
    r2 = f32(radius * radius)
    out = torch.empty((b, n), dtype=points.dtype, device=points.device)
    for r0, r1 in row_steps(b, n, n):
        d2 = sqdist(points[:, r0:r1], points)
        out[:, r0:r1] = (d2 <= r2).sum(-1).to(points.dtype)
    return out


def shape_context_descriptor(keypoints: torch.Tensor,    # [B, K, 3]
                             frames: torch.Tensor,       # [B, K, 3, 3]
                             frame_valid: torch.Tensor,  # [B, K]
                             points: torch.Tensor,       # [B, N, 3]
                             nbr: NeighborBlock,         # [B, K, M]
                             radius: float,
                             min_radius_factor: float = 0.1,
                             density_radius_factor: float = 0.2,
                             min_neighbors: int = 5) -> ShotResult:
    """3DSC / USC-1980 (the JAX ``shape_context_descriptor``): azimuth and
    elevation in the frame, log-radial bins from radius / 10."""
    dt = points.dtype
    use = nbr.valid & (nbr.dist > 1e-15) & torch.isfinite(nbr.dist)
    d = torch.where(use, nbr.dist, torch.full_like(nbr.dist, radius * 0.5))
    delta = gather_rows(points, nbr.idx) - keypoints[..., None, :]
    x_l = (delta * frames[..., None, 0, :]).sum(-1)
    y_l = (delta * frames[..., None, 1, :]).sum(-1)
    z_l = (delta * frames[..., None, 2, :]).sum(-1)
    rmin = min_radius_factor * radius
    use = use & (d >= rmin)
    az = (torch.atan2(y_l, x_l) + math.pi) / (2 * math.pi)
    el = torch.arccos(torch.clamp(z_l / d, -1.0, 1.0)) / math.pi
    ln_span = math.log(radius / rmin)
    rbin = torch.log(torch.clamp(d, min=rmin) / rmin) / ln_span
    i32 = torch.int32
    b_az = torch.clamp((az * SC_AZ).to(i32), 0, SC_AZ - 1)
    b_el = torch.clamp((el * SC_EL).to(i32), 0, SC_EL - 1)
    b_r = torch.clamp((rbin * SC_RAD).to(i32), 0, SC_RAD - 1)
    idx = (b_az * SC_EL + b_el) * SC_RAD + b_r

    rho = gather_rows(_local_density(points, density_radius_factor
                                     * radius)[..., None], nbr.idx)[..., 0]
    br = b_r.to(dt)
    be = b_el.to(dt)
    r_lo = rmin * torch.exp(br / SC_RAD * ln_span)
    r_hi = rmin * torch.exp((br + 1) / SC_RAD * ln_span)
    el_lo = be / SC_EL * math.pi
    el_hi = (be + 1) / SC_EL * math.pi
    vol = ((r_hi ** 3 - r_lo ** 3) / 3.0) \
        * (torch.cos(el_lo) - torch.cos(el_hi)) * (2 * math.pi / SC_AZ)
    w = 1.0 / torch.clamp(rho * torch.pow(torch.clamp(vol, min=1e-30),
                                          1.0 / 3.0), min=1e-30)
    w = torch.where(use, w, torch.zeros_like(w))
    idx = torch.where(use, idx, torch.zeros_like(idx))
    hist = slot_histogram(idx, w, SC_LEN, 2)
    valid = frame_valid & (use.sum(-1) >= min_neighbors)
    return ShotResult(hist, valid)


# -- RSD (features/features_rsd.cpp) ------------------------------------------

RSD_SUBDIV = 5
RSD_HIST_LEN = RSD_SUBDIV * RSD_SUBDIV
RSD_MAX_RADIUS_FACTOR = 1.5


def rsd_descriptor(keypoints: torch.Tensor,  # [B, K, 3]
                   kp_mask: torch.Tensor,    # [B, K]
                   points: torch.Tensor,     # [B, N, 3]
                   normals: torch.Tensor,    # [B, N, 3]
                   nbr: NeighborBlock,       # [B, K, M]
                   radius: float,
                   use_hist: bool = True,
                   min_neighbors: int = 5) -> ShotResult:
    """RSD (the JAX ``rsd_descriptor``): the joint (distance, angle) 5 x 5
    histogram with UseFullRSDHistogram, else (r_min, r_max) of the
    osculating radius d / (2 sin(angle / 2)); the keypoint's normal is its
    nearest neighbour's (slot 0)."""
    dt = points.dtype
    use = nbr.valid & (nbr.dist > 1e-15) & torch.isfinite(nbr.dist)
    d = torch.where(use, nbr.dist, torch.full_like(nbr.dist, radius * 0.5))
    nn = gather_rows(normals, nbr.idx)
    kp_n = nn[..., 0, :]
    cos_a = torch.clamp((nn * kp_n[..., None, :]).sum(-1), -1.0, 1.0)
    ang = torch.arccos(cos_a)
    if use_hist:
        i32 = torch.int32
        b_d = torch.clamp((d / radius * RSD_SUBDIV).to(i32), 0,
                          RSD_SUBDIV - 1)
        b_a = torch.clamp((ang / math.pi * RSD_SUBDIV).to(i32), 0,
                          RSD_SUBDIV - 1)
        idx = torch.where(use, b_d * RSD_SUBDIV + b_a, torch.zeros_like(b_d))
        w = use.to(dt)
        hist = slot_histogram(idx, w, RSD_HIST_LEN, 2)
        cnt = torch.clamp(w.sum(-1), min=1.0)
        desc = hist / cnt[..., None]
    else:
        r_est = d / torch.clamp(2.0 * torch.sin(ang / 2.0), min=1e-3)
        r_est = torch.clamp(r_est, 0.0, RSD_MAX_RADIUS_FACTOR * radius / 0.1)
        r_min = torch.where(use, r_est, torch.full_like(r_est, math.inf)
                            ).amin(-1)
        r_max = torch.where(use, r_est, torch.zeros_like(r_est)).amax(-1)
        r_min = torch.where(torch.isfinite(r_min), r_min,
                            torch.zeros_like(r_min))
        desc = torch.stack([r_min, r_max], -1)
    valid = kp_mask & (use.sum(-1) >= min_neighbors)
    return ShotResult(desc, valid)


# -- RIFT (features/features_rift.cpp) ----------------------------------------

RIFT_DIST_BINS = 4
RIFT_ANGLE_BINS = 8
RIFT_LEN = RIFT_DIST_BINS * RIFT_ANGLE_BINS  # 32


def intensity_gradients(points: torch.Tensor,     # [B, N, 3]
                        normals: torch.Tensor,    # [B, N, 3]
                        intensity: torch.Tensor,  # [B, N]
                        mask: torch.Tensor,       # [B, N]
                        radius: float) -> torch.Tensor:
    """[B, N, 3] least-squares intensity gradient of every point, projected
    onto its tangent plane (the JAX ``intensity_gradients``): A g = b with
    A = sum (p_j - p_i)(p_j - p_i)^T and b = sum (I_j - I_i)(p_j - p_i)
    over the in-radius unmasked points, A + 1e-8 I solved by LU."""
    b, n, _ = points.shape
    r2 = f32(radius * radius)
    xx = (points[..., :, None] * points[..., None, :]).reshape(b, n, 9)
    s0 = torch.empty((b, n), dtype=points.dtype, device=points.device)
    s1 = torch.empty((b, n, 3), dtype=points.dtype, device=points.device)
    s2 = torch.empty((b, n, 9), dtype=points.dtype, device=points.device)
    s_i = torch.empty((b, n), dtype=points.dtype, device=points.device)
    s_ix = torch.empty((b, n, 3), dtype=points.dtype, device=points.device)
    for r0, r1 in row_steps(b, n, n):
        d2 = sqdist(points[:, r0:r1], points)
        w = ((d2 <= r2) & mask[:, None, :]).to(points.dtype)
        del d2
        s0[:, r0:r1] = w.sum(-1)
        with full_fp32():
            s1[:, r0:r1] = w @ points
            s2[:, r0:r1] = w @ xx
            s_i[:, r0:r1] = (w @ intensity[..., None])[..., 0]
            s_ix[:, r0:r1] = (w * intensity[:, None, :]) @ points
    p = points
    s2 = s2.reshape(b, n, 3, 3)
    a = (s2 - p[..., :, None] * s1[..., None, :]
         - s1[..., :, None] * p[..., None, :]
         + s0[..., None, None] * p[..., :, None] * p[..., None, :])
    rhs = s_ix - p * s_i[..., None] - intensity[..., None] \
        * (s1 - s0[..., None] * p)
    a = a + 1e-8 * torch.eye(3, dtype=a.dtype, device=a.device)
    g = torch.linalg.solve(a, rhs[..., None])[..., 0]
    g = g - (g * normals).sum(-1, keepdim=True) * normals
    return torch.where(mask[..., None], g, torch.zeros_like(g))


def rift_descriptor(keypoints: torch.Tensor,  # [B, K, 3]
                    kp_mask: torch.Tensor,    # [B, K]
                    points: torch.Tensor,     # [B, N, 3]
                    gradients: torch.Tensor,  # [B, N, 3]
                    nbr: NeighborBlock,       # [B, K, M]
                    radius: float,
                    min_neighbors: int = 5) -> ShotResult:
    """RIFT-32 (the JAX ``rift_descriptor``): 4 distance rings x 8 bins of
    the angle between the neighbour's gradient and the radial direction,
    weighted by the gradient's magnitude, bilinear, normalised to sum 1."""
    dt = points.dtype
    use = nbr.valid & (nbr.dist > 1e-15) & torch.isfinite(nbr.dist)
    d = torch.where(use, nbr.dist, torch.full_like(nbr.dist, radius * 0.5))
    delta = gather_rows(points, nbr.idx) - keypoints[..., None, :]
    radial = delta / torch.clamp(d[..., None], min=1e-12)
    g = gather_rows(gradients, nbr.idx)
    gmag = torch.linalg.norm(g, dim=-1)
    gdir = g / torch.clamp(gmag[..., None], min=1e-12)
    theta = torch.arccos(torch.clamp((radial * gdir).sum(-1), -1.0, 1.0))
    db = d / radius * RIFT_DIST_BINS - 0.5
    ab = theta / math.pi * RIFT_ANGLE_BINS - 0.5
    i32 = torch.int32
    d0 = torch.clamp(torch.floor(db).to(i32), 0, RIFT_DIST_BINS - 2)
    a0 = torch.clamp(torch.floor(ab).to(i32), 0, RIFT_ANGLE_BINS - 2)
    fd = torch.clamp(db - d0, 0.0, 1.0)
    fa = torch.clamp(ab - a0, 0.0, 1.0)
    base = d0 * RIFT_ANGLE_BINS + a0
    idx = torch.stack([base, base + 1, base + RIFT_ANGLE_BINS,
                       base + RIFT_ANGLE_BINS + 1], -1)
    w = torch.stack([(1 - fd) * (1 - fa), (1 - fd) * fa, fd * (1 - fa),
                     fd * fa], -1) * gmag[..., None]
    w = w * use.to(dt)[..., None]
    idx = torch.where(use[..., None], idx, torch.zeros_like(idx))
    hist = slot_histogram(idx, w, RIFT_LEN, 2)
    total = torch.clamp(hist.sum(-1, keepdim=True), min=1e-30)
    valid = kp_mask & (use.sum(-1) >= min_neighbors)
    return ShotResult(hist / total, valid)
