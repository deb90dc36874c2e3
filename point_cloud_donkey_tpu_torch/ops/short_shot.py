"""SHORT_SHOT descriptor: a spherical-grid point histogram in LRF
coordinates (port of the serving half of
point_cloud_donkey_tpu/ops/short_shot.py).

Spec: reference features/features_short_shot.cpp:77-366 (grid of r_bins x
e_bins x a_bins over (radius, polar angle theta, azimuth phi), per-axis
linear interpolation into one secondary bin, cyclic azimuth, optional
log-radius binning, L2 normalisation).  Bin layout: bin_r + bin_theta *
r_bins + bin_phi * r_bins * e_bins.  Neighbours at distance <= 1e-15 are
skipped.  No normals.  The serving step bins linearly in radius with no
min radius, as the JAX serving step does; the log-radius and min-radius
options of the JAX training descriptor are not ported.

The dense form takes the radius gate and the local coordinates from exact
coordinate differences (the JAX dense path gates on the matmul identity),
as the port's SHOT does.  K9 (ops/kernels/histogram.py) bins its
(keypoint, point) pairs; the four slots a pair of K9's plain twin are built
here.  Bins come from truncating float coordinates (raw.astype(int32)) and
from degrees(arccos) and arctan2, so a pair that sits on a bin edge can land
in the neighbouring bin when two float implementations differ by an ulp.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .kernels import f32
from .kernels.histogram import short_shot_hist
from .shot import _dense_batch

AUTO_BINS = {
    8: (1, 1, 8),
    16: (2, 2, 4),
    24: (2, 2, 6),
    32: (2, 2, 8),
    64: (2, 4, 8),
    96: (3, 4, 8),
    128: (4, 4, 8),
    192: (6, 4, 8),
    256: (8, 4, 8),
}
SLOTS = 4   # primary bin + one secondary bin along each of r, theta, phi


def resolve_bins(feature_dims: int, bin_type: str, r_bins: int, e_bins: int,
                 a_bins: int) -> Tuple[int, int, int, int]:
    """configureSphericalGrid semantics: 'auto' picks bins from dims (unknown
    dims fall back to 32 = 2x2x8); 'manual' recomputes dims from bins."""
    if bin_type == "auto":
        bins = AUTO_BINS.get(feature_dims)
        if bins is None:
            bins = AUTO_BINS[32]
            feature_dims = 32
        return (feature_dims, *bins)
    if bin_type == "manual":
        return (r_bins * e_bins * a_bins, r_bins, e_bins, a_bins)
    return (32, 2, 2, 8)


class ShortShotResult(NamedTuple):
    descriptors: torch.Tensor  # [..., K, D]
    valid: torch.Tensor        # [..., K]


def _interp(raw: torch.Tensor):
    """linear_interpolation (features_short_shot.cpp:246-260): (primary
    weight, secondary offset in {-1, +1})."""
    dec = raw - torch.floor(raw)
    w = torch.where(dec <= 0.5, dec + 0.5, (1.0 - dec) + 0.5)
    off = torch.where(dec <= 0.5, -1, 1).to(torch.int32)
    return w, off


def _correct_bin(b: torch.Tensor, total: int, cyclic: bool) -> torch.Tensor:
    if cyclic:
        return torch.where(b < 0, total - 1, torch.where(b >= total, 0, b))
    return torch.clamp(b, 0, total - 1)


def short_shot_descriptor_dense(
        keypoints: torch.Tensor,    # [K, 3] / [B, K, 3]
        frames: torch.Tensor,       # [K, 3, 3] / [B, K, 3, 3]
        frame_valid: torch.Tensor,  # [K] / [B, K]
        points: torch.Tensor,       # [N, 3] / [B, N, 3]
        mask: torch.Tensor,         # [N] / [B, N]
        radius: float,
        r_bins: int = 2,
        e_bins: int = 2,
        a_bins: int = 8) -> ShortShotResult:
    """SHORT_SHOT of every keypoint against its cloud (the JAX
    ``short_shot_descriptor_dense``): [..., K, r_bins * e_bins * a_bins].
    K9 bins the pairs of the rows with a valid frame (the others come out
    invalid)."""
    single, keypoints, points, mask, frames, frame_valid = _dense_batch(
        keypoints, points, mask, frames, frame_valid)
    hist = short_shot_hist(keypoints.contiguous(), frames.contiguous(),
                           frame_valid.contiguous(), points.contiguous(),
                           mask.contiguous(), radius, r_bins, e_bins, a_bins)
    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    desc = hist / torch.clamp(norm, min=1e-30)
    valid = (frame_valid & (norm[..., 0] > 0)
             & torch.isfinite(desc).all(-1))
    if single:
        return ShortShotResult(desc[0], valid[0])
    return ShortShotResult(desc, valid)


def short_shot_slot_arrays(kp, frames, points, mask, radius, r_bins=2,
                           e_bins=2, a_bins=8):
    """The slots of a chunk of clouds [c, K] x [c, N], the slot arrays of
    K9's plain twin: (bins [c * K, N * 4] i32, weights [c * K, N * 4] f32),
    each point's four slots side by side."""
    c, k, _ = kp.shape
    n = points.shape[1]
    dx = points[:, None, :, 0] - kp[:, :, None, 0]              # [c, K, N]
    dy = points[:, None, :, 1] - kp[:, :, None, 1]
    dz = points[:, None, :, 2] - kp[:, :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    r = f32(radius)
    use = (d2 <= f32(r * r)) & (d2 > 1e-15) & mask[:, None, :]
    del d2
    f = frames.reshape(c, k, 9)[..., None]
    x_l = dx * f[:, :, 0] + dy * f[:, :, 1] + dz * f[:, :, 2]
    y_l = dx * f[:, :, 3] + dy * f[:, :, 4] + dz * f[:, :, 5]
    z_l = dx * f[:, :, 6] + dy * f[:, :, 7] + dz * f[:, :, 8]
    del dx, dy, dz
    idx, w = _short_shot_slots(x_l, y_l, z_l, use, radius, r_bins, e_bins,
                               a_bins)
    return idx.reshape(c * k, n * SLOTS), w.reshape(c * k, n * SLOTS)


def _short_shot_slots(x_l, y_l, z_l, use, radius, r_bins, e_bins, a_bins):
    """The four (bin, weight) slots [..., M, 4] of each pair (the JAX
    ``_short_shot_core``); unused pairs and absent secondaries weigh 0."""
    r = torch.sqrt(x_l * x_l + y_l * y_l + z_l * z_l)
    r = torch.where(use, r, torch.full_like(r, f32(radius * 0.5)))
    theta = torch.rad2deg(torch.arccos(torch.clamp(
        z_l / torch.clamp(r, min=1e-30), -1.0, 1.0)))
    phi = torch.rad2deg(torch.atan2(y_l, x_l))

    raw_r = r_bins * r / radius
    raw_t = e_bins * theta / 180.0
    raw_p = a_bins * (phi + 180.0) / 360.0

    i32 = torch.int32
    bin_r = torch.clamp(raw_r.to(i32), 0, r_bins - 1)
    bin_t = torch.clamp(raw_t.to(i32), max=e_bins - 1)
    bin_p = torch.clamp(raw_p.to(i32), max=a_bins - 1)

    w_r, off_r = _interp(raw_r)
    w_t, off_t = _interp(raw_t)
    w_p, off_p = _interp(raw_p)

    bin_r2 = _correct_bin(bin_r + off_r, r_bins, False)
    bin_t2 = _correct_bin(bin_t + off_t, e_bins, False)
    bin_p2 = _correct_bin(bin_p + off_p, a_bins, True)
    r2_ok = (bin_r2 != bin_r) & (r_bins > 1)
    t2_ok = (bin_t2 != bin_t) & (e_bins > 1)
    p2_ok = (bin_p2 != bin_p) & (a_bins > 1)

    def lin(br, bt, bp):
        return br + bt * r_bins + bp * (r_bins * e_bins)

    zero = torch.zeros_like(w_r)
    idx = torch.stack([
        lin(bin_r, bin_t, bin_p),
        lin(bin_r, bin_t, bin_p2),
        lin(bin_r, bin_t2, bin_p),
        lin(bin_r2, bin_t, bin_p),
    ], dim=-1)
    w = torch.stack([
        w_r + w_t + w_p,
        torch.where(p2_ok, w_r + w_t + (1.0 - w_p), zero),
        torch.where(t2_ok, w_r + (1.0 - w_t) + w_p, zero),
        torch.where(r2_ok, (1.0 - w_r) + w_t + w_p, zero),
    ], dim=-1)
    w = torch.where(use[..., None], w, torch.zeros_like(w))
    idx = torch.where(w > 0, idx, torch.zeros_like(idx))
    return idx.to(i32), w
