"""SHOT-352 descriptor (port of point_cloud_donkey_tpu/ops/shot.py, SHOT
only): the plain PyTorch twin of K3 (ops/kernels/shot_fused.py).

Spec: Tombari et al. ECCV 2010 as implemented by PCL (SHOTEstimation::
interpolateSingleChannel).  32 spatial volumes (8 azimuth x 2 elevation x
2 radial) x 11 cosine slots; quadrilinear soft binning across cosine,
radial, elevation and azimuth; L2 normalisation.  Neighbours at distance
~0 are skipped; keypoints with < 5 in-radius neighbours are invalid.

Like K3, and unlike the JAX dense path (matmul identity), distances and
local coordinates come from exact coordinate differences; the five slots
of every in-radius pair enter an f32 histogram by scatter-add.  The
binning below performs the same float operations in the same order as
csrc/shot_fused.cu, so kernel and twin pick the same bins.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .kernels import f32

NR_BINS = 10            # cosine histogram bins (slot count per volume = 11)
NR_SECTORS = 32         # spatial volumes
NB = NR_BINS + 1
DESC_LEN = NR_SECTORS * NB  # 352

_RAD_45 = math.pi / 4.0
_RAD_90 = math.pi / 2.0
_RAD_135 = 3.0 * math.pi / 4.0
_RAD_PI_7_8 = math.pi * 7.0 / 8.0
_PAIR_BUDGET = 1 << 22  # [rows, N] elements per chunk


class ShotResult(NamedTuple):
    descriptors: torch.Tensor  # [..., K, 352]
    valid: torch.Tensor        # [..., K]


def shot_bin_slots(x_l, y_l, z_l, cos_desc, d, radius: float):
    """SHOT binning of in-radius pairs (1-D tensors) -> five (flat index
    into the 352-slot histogram, weight) slots, each [P]."""
    rad = f32(radius)
    r_half = f32(rad / 2.0)
    r34 = f32(f32(3.0 * rad) / 4.0)
    r14 = f32(rad / 4.0)
    one = torch.ones_like(d)

    bin_dist = (1.0 + cos_desc) * (NR_BINS / 2.0)
    step = torch.floor(bin_dist + 0.5)
    bd = bin_dist - step
    step = step.to(torch.int64)

    bit4 = ((y_l > 0) | ((y_l == 0.0) & (x_l < 0))).to(torch.int64)
    bit3_cond = (x_l > 0) | ((x_l == 0.0) & (y_l > 0))
    bit3 = torch.where(bit3_cond, 1 - bit4, bit4)
    desc = ((bit4 << 3) + (bit3 << 2)) << 1
    inner = ((x_l * y_l) > 0) | (x_l == 0.0)
    ax, ay = torch.abs(x_l), torch.abs(y_l)
    add4 = torch.where(inner, torch.where(ax >= ay, 0, 4),
                       torch.where(ax > ay, 4, 0))
    desc = desc + add4 + (z_l > 0).to(torch.int64)
    desc = desc + torch.where(d > r_half, 2, 0)

    central_w = 1.0 - torch.abs(bd)
    cos_bin = torch.where(bd > 0, (step + 1) % NR_BINS,
                          (step - 1 + NR_BINS) % NR_BINS)
    cos_w = torch.abs(bd)

    # radial interpolation (adjacent shell)
    rd_out = (d - r34) / r_half
    rd_in = (d - r14) / r_half
    outer = d > r_half
    rd = torch.where(outer, rd_out, rd_in)
    has_rad = torch.where(outer, d <= r34, d >= r14)
    central_w = central_w + torch.where(
        outer, torch.where(d > r34, 1.0 - rd_out, 1.0 + rd_out),
        torch.where(d < r14, 1.0 + rd_in, 1.0 - rd_in))
    rad_w = torch.where(has_rad, torch.abs(rd), 0.0 * one)
    rad_vol = desc + torch.where(outer, -2, 2)

    # inclination interpolation (adjacent elevation volume)
    incl = torch.arccos(torch.clamp(z_l / d, -1.0, 1.0))
    lower = (incl > _RAD_90) | ((incl == f32(_RAD_90)) & (z_l <= 0))
    id_low = (incl - _RAD_135) / _RAD_90
    id_up = (incl - _RAD_45) / _RAD_90
    central_w = central_w + torch.where(
        lower, torch.where(incl > _RAD_135, 1.0 - id_low, 1.0 + id_low),
        torch.where(incl < _RAD_45, 1.0 + id_up, 1.0 - id_up))
    has_incl = torch.where(lower, incl <= _RAD_135, incl >= _RAD_45)
    incl_w = torch.where(has_incl, torch.where(lower, torch.abs(id_low),
                                               torch.abs(id_up)), 0.0 * one)
    incl_vol = desc + torch.where(lower, 1, -1)

    # azimuth interpolation (adjacent sector, +-4 mod 32)
    has_az = (x_l != 0.0) | (y_l != 0.0)
    azimuth = torch.atan2(y_l, x_l)
    sel = (desc >> 2).to(d.dtype)
    az_dist = (azimuth - (-_RAD_PI_7_8 + _RAD_45 * sel)) / _RAD_45
    az_dist = torch.clamp(az_dist, -0.5, 0.5)
    central_w = central_w + torch.where(has_az, 1.0 - torch.abs(az_dist),
                                        0.0 * one)
    az_vol = torch.where(az_dist > 0, (desc + 4) % NR_SECTORS,
                         (desc - 4 + NR_SECTORS) % NR_SECTORS)
    az_w = torch.where(has_az, torch.abs(az_dist), 0.0 * one)

    return [
        (desc * NB + step, central_w),
        (desc * NB + cos_bin, cos_w),
        (torch.where(has_rad, rad_vol * NB + step, 0), rad_w),
        (torch.where(has_incl, incl_vol * NB + step, 0), incl_w),
        (torch.where(has_az, az_vol * NB + step, 0), az_w),
    ]


def shot_histogram_rows(kp: torch.Tensor,        # [R, 3]
                        frames: torch.Tensor,    # [R, 3, 3]
                        cloud: torch.Tensor,     # [R] int cloud of each row
                        points: torch.Tensor,    # [B, N, 3]
                        normals: torch.Tensor,   # [B, N, 3]
                        mask: torch.Tensor,      # [B, N]
                        radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw SHOT histograms of keypoint rows against their clouds' points:
    (hist [R, 352] f32, in-radius count [R] i32).  A pair is used when
    1e-15 < |p - q|^2 <= r^2, the point is unmasked and its normal finite."""
    r = f32(radius)
    r2 = f32(r * r)
    n_rows = kp.shape[0]
    n = points.shape[1]
    hist = torch.zeros((n_rows, DESC_LEN), dtype=points.dtype,
                       device=points.device)
    count = torch.zeros((n_rows,), dtype=torch.int32, device=points.device)
    nrm_ok = mask & torch.isfinite(normals).all(-1)               # [B, N]
    step = max(1, _PAIR_BUDGET // max(n, 1))
    for r0 in range(0, n_rows, step):
        cl = cloud[r0:r0 + step].long()
        kc, fc = kp[r0:r0 + step], frames[r0:r0 + step]
        pts = points[cl]                                          # [c, N, 3]
        dx = pts[..., 0] - kc[:, 0:1]
        dy = pts[..., 1] - kc[:, 1:2]
        dz = pts[..., 2] - kc[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        use = (d2 <= r2) & (d2 > 1e-15) & nrm_ok[cl]
        count[r0:r0 + step] = use.sum(-1, dtype=torch.int32)
        rows, cols = use.nonzero(as_tuple=True)
        dx, dy, dz, d2 = dx[rows, cols], dy[rows, cols], dz[rows, cols], \
            d2[rows, cols]
        f = fc[rows].reshape(-1, 9)
        nrm = normals[cl[rows], cols]
        x_l = dx * f[:, 0] + dy * f[:, 1] + dz * f[:, 2]
        y_l = dx * f[:, 3] + dy * f[:, 4] + dz * f[:, 5]
        z_l = dx * f[:, 6] + dy * f[:, 7] + dz * f[:, 8]
        cos_desc = torch.clamp(nrm[:, 0] * f[:, 6] + nrm[:, 1] * f[:, 7]
                               + nrm[:, 2] * f[:, 8], -1.0, 1.0)
        base = rows * DESC_LEN
        flat = hist[r0:r0 + step].view(-1)
        for idx, w in shot_bin_slots(x_l, y_l, z_l, cos_desc,
                                     torch.sqrt(d2), radius):
            flat.index_add_(0, base + idx, w)
    return hist, count


def normalize_descriptors(hist: torch.Tensor, count: torch.Tensor,
                          frame_valid: torch.Tensor,
                          min_neighbors: int = 5) -> ShotResult:
    """L2-normalise raw histograms and set validity: a valid frame, at
    least `min_neighbors` in-radius neighbours, a nonzero norm and finite
    values."""
    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    desc = hist / torch.clamp(norm, min=1e-30)
    valid = (frame_valid & (count >= min_neighbors) & (norm[..., 0] > 0)
             & torch.isfinite(desc).all(-1))
    return ShotResult(descriptors=desc, valid=valid)


def shot_descriptor_dense(keypoints: torch.Tensor,    # [K, 3] / [B, K, 3]
                          frames: torch.Tensor,       # [K, 3, 3] / [B, ...]
                          frame_valid: torch.Tensor,  # [K] / [B, K]
                          points: torch.Tensor,       # [N, 3] / [B, N, 3]
                          normals: torch.Tensor,      # [N, 3] / [B, N, 3]
                          mask: torch.Tensor,         # [N] / [B, N]
                          radius: float,
                          min_neighbors: int = 5) -> ShotResult:
    """SHOT-352 descriptors of every keypoint against its cloud."""
    single = points.dim() == 2
    if single:
        keypoints, frames, frame_valid = (keypoints[None], frames[None],
                                          frame_valid[None])
        points, normals, mask = points[None], normals[None], mask[None]
    b, k, _ = keypoints.shape
    cloud = torch.arange(b, device=points.device).repeat_interleave(k)
    hist, count = shot_histogram_rows(
        keypoints.reshape(b * k, 3), frames.reshape(b * k, 3, 3), cloud,
        points, normals, mask, radius)
    res = normalize_descriptors(hist.reshape(b, k, DESC_LEN),
                                count.reshape(b, k), frame_valid,
                                min_neighbors)
    if single:
        res = ShotResult(res.descriptors[0], res.valid[0])
    return res
