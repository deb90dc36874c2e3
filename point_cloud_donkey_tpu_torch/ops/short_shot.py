"""SHORT_SHOT and SHORT_CSHOT descriptors: spherical-grid point (and
colour) histograms in LRF coordinates (port of
point_cloud_donkey_tpu/ops/short_shot.py).

Spec: reference features/features_short_shot.cpp:77-366 (grid of r_bins x
e_bins x a_bins over (radius, polar angle theta, azimuth phi), per-axis
linear interpolation into one secondary bin, cyclic azimuth, optional
log-radius binning, L2 normalisation).  Bin layout: bin_r + bin_theta *
r_bins + bin_phi * r_bins * e_bins.  Neighbours at distance <= 1e-15 are
skipped, and with a minimum radius so are those with r < min_radius
(features_short_shot.cpp:125-135).  With the log radius the radial
coordinate is (r_bins - 1) (ln r - ln min_radius) / ln(radius /
min_radius) + 1, the logarithms in double on the host (the JAX
`_short_shot_core`; without a minimum radius ln_rmin = 0 and ln_span = 1).
No normals.

SHORT_CSHOT (features_short_cshot.cpp, the JAX ``short_cshot_descriptor``)
adds a colour histogram of the normalised-CIELab distance to the
keypoint's colour nested in its own spherical grid, over a gathered
neighbour block (ops/neighbors.gather_radius_neighbors); the JAX package
computes it in XLA, so here it is plain torch with one ``scatter_add_``.

The dense form takes the radius gate and the local coordinates from exact
coordinate differences (the JAX dense path gates on the matmul identity),
as the port's SHOT does.  K9 (ops/kernels/histogram.py) bins its
(keypoint, point) pairs; the four slots a pair of K9's plain twin are built
here.  Bins come from truncating float coordinates (raw.astype(int32)) and
from degrees(arccos) and arctan2, so a pair that sits on a bin edge can land
in the neighbouring bin when two float implementations differ by an ulp.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .color import color_distance, rgb_to_cielab_normalized
from .kernels import f32
from .kernels.histogram import short_shot_hist
from .neighbors import NeighborBlock, gather_rows
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
COLOR_AUTO_BINS = {
    8: (1, 1, 8), 16: (2, 2, 4), 24: (2, 2, 6), 32: (2, 2, 8),
    64: (2, 4, 8), 96: (3, 4, 8), 128: (4, 4, 8),
}
# [rows, capacity] pairs of one chunk of SHORT_CSHOT's slots
_PAIR_BUDGET = 1 << 21


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


def resolve_color_bins(color_dims: int) -> Tuple[int, int, int, int]:
    """configureSphericalColorGrid (features_short_cshot.cpp:592-650):
    auto only; unsupported dims fall back to 32."""
    bins = COLOR_AUTO_BINS.get(color_dims)
    if bins is None:
        return (32, *COLOR_AUTO_BINS[32])
    return (color_dims, *bins)


def log_radius_params(radius: float, min_radius: float
                      ) -> Tuple[float, float]:
    """(ln_rmin, ln_span) of the log-radius coordinate, in double."""
    if min_radius > 0:
        return math.log(min_radius), math.log(radius / min_radius)
    return 0.0, 1.0


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
        a_bins: int = 8,
        min_radius: float = 0.0,
        log_radius: bool = False) -> ShortShotResult:
    """SHORT_SHOT of every keypoint against its cloud (the JAX
    ``short_shot_descriptor_dense``): [..., K, r_bins * e_bins * a_bins].
    K9 bins the pairs of the rows with a valid frame (the others come out
    invalid)."""
    single, keypoints, points, mask, frames, frame_valid = _dense_batch(
        keypoints, points, mask, frames, frame_valid)
    hist = short_shot_hist(keypoints.contiguous(), frames.contiguous(),
                           frame_valid.contiguous(), points.contiguous(),
                           mask.contiguous(), radius, r_bins, e_bins, a_bins,
                           min_radius, log_radius)
    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    desc = hist / torch.clamp(norm, min=1e-30)
    valid = (frame_valid & (norm[..., 0] > 0)
             & torch.isfinite(desc).all(-1))
    if single:
        return ShortShotResult(desc[0], valid[0])
    return ShortShotResult(desc, valid)


def short_shot_slot_arrays(kp, frames, points, mask, radius, r_bins=2,
                           e_bins=2, a_bins=8, min_radius=0.0,
                           log_radius=False):
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
    x_l, y_l, z_l = _local(dx, dy, dz, frames)
    del dx, dy, dz
    idx, w = _short_shot_slots(x_l, y_l, z_l, use, radius, r_bins, e_bins,
                               a_bins, min_radius, log_radius)
    return idx.reshape(c * k, n * SLOTS), w.reshape(c * k, n * SLOTS)


def _local(dx, dy, dz, frames):
    """Local-frame coordinates of offsets [..., K, M] under frames [..., K,
    3, 3] (rows = axes)."""
    f = frames.reshape(frames.shape[:-2] + (9,))[..., None]
    return (dx * f[..., 0, :] + dy * f[..., 1, :] + dz * f[..., 2, :],
            dx * f[..., 3, :] + dy * f[..., 4, :] + dz * f[..., 5, :],
            dx * f[..., 6, :] + dy * f[..., 7, :] + dz * f[..., 8, :])


def _spherical(x_l, y_l, z_l, use, radius, min_radius):
    """(use, r, theta, phi) of local coordinates: r sanitised where unused,
    theta and phi in degrees; the minimum radius gates `use`."""
    r = torch.sqrt(x_l * x_l + y_l * y_l + z_l * z_l)
    if min_radius > 0:
        use = use & (r >= f32(min_radius))
    r = torch.where(use, r, torch.full_like(r, f32(radius * 0.5)))
    theta = torch.rad2deg(torch.arccos(torch.clamp(
        z_l / torch.clamp(r, min=1e-30), -1.0, 1.0)))
    phi = torch.rad2deg(torch.atan2(y_l, x_l))
    return use, r, theta, phi


def _grid(r, theta, phi, radius, rb, eb, ab, min_radius, log_radius):
    """One spherical grid's primary bins, secondary bins, weights and
    secondary flags along (r, theta, phi), as the JAX `grid_slots`."""
    if log_radius:
        ln_rmin, ln_span = log_radius_params(radius, min_radius)
        raw_r = (rb - 1) * (torch.log(torch.clamp(r, min=1e-30)) - ln_rmin) \
            / ln_span + 1.0
    else:
        raw_r = rb * r / radius
    raw_t = eb * theta / 180.0
    raw_p = ab * (phi + 180.0) / 360.0
    i32 = torch.int32
    b_r = torch.clamp(raw_r.to(i32), 0, rb - 1)
    b_t = torch.clamp(raw_t.to(i32), max=eb - 1)
    b_p = torch.clamp(raw_p.to(i32), max=ab - 1)
    w_r, o_r = _interp(raw_r)
    w_t, o_t = _interp(raw_t)
    w_p, o_p = _interp(raw_p)
    b_r2 = _correct_bin(b_r + o_r, rb, False)
    b_t2 = _correct_bin(b_t + o_t, eb, False)
    b_p2 = _correct_bin(b_p + o_p, ab, True)
    ok = ((b_r2 != b_r) & (rb > 1), (b_t2 != b_t) & (eb > 1),
          (b_p2 != b_p) & (ab > 1))
    return (b_r, b_t, b_p), (b_r2, b_t2, b_p2), (w_r, w_t, w_p), ok


def _short_shot_slots(x_l, y_l, z_l, use, radius, r_bins, e_bins, a_bins,
                      min_radius=0.0, log_radius=False):
    """The four (bin, weight) slots [..., M, 4] of each pair (the JAX
    ``_short_shot_core``); unused pairs and absent secondaries weigh 0."""
    use, r, theta, phi = _spherical(x_l, y_l, z_l, use, radius, min_radius)
    (bin_r, bin_t, bin_p), (bin_r2, bin_t2, bin_p2), (w_r, w_t, w_p), \
        (r2_ok, t2_ok, p2_ok) = _grid(r, theta, phi, radius, r_bins, e_bins,
                                      a_bins, min_radius, log_radius)

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
    return idx.to(torch.int32), w


def short_cshot_descriptor(
        keypoints: torch.Tensor,    # [B, K, 3]
        kp_rgb: torch.Tensor,       # [B, K, 3] in [0, 1]
        frames: torch.Tensor,       # [B, K, 3, 3]
        frame_valid: torch.Tensor,  # [B, K]
        points: torch.Tensor,       # [B, N, 3]
        rgb: torch.Tensor,          # [B, N, 3] in [0, 1]
        nbr: NeighborBlock,         # [B, K, M]
        radius: float,
        r_bins: int = 2, e_bins: int = 2, a_bins: int = 8,
        r_cbins: int = 2, e_cbins: int = 2, a_cbins: int = 8,
        color_hist_size: int = 15,
        min_radius: float = 0.0,
        log_radius: bool = False) -> ShortShotResult:
    """SHORT_CSHOT of every keypoint over its gathered neighbours (the JAX
    ``short_cshot_descriptor``): the SHORT_SHOT shape grid, then the
    colour histogram in its own grid, all four axes interpolated (the
    colour secondary's increment (1 - w_c) + (1 - w_r) + w_t + w_p keeps
    the reference's quirk, features_short_cshot.cpp:424-426); one joint L2
    norm: [B, K, shape_dims + color_dims]."""
    shape_dims = r_bins * e_bins * a_bins
    total = shape_dims + r_cbins * e_cbins * a_cbins * color_hist_size
    b, k, m = nbr.idx.shape
    lab_kp = rgb_to_cielab_normalized(kp_rgb)
    lab_pts = rgb_to_cielab_normalized(rgb)
    hist = torch.zeros((b * k, total), dtype=points.dtype,
                       device=points.device)
    rows = max(1, _PAIR_BUDGET // max(m, 1))
    flat = (keypoints.reshape(b * k, 3), frames.reshape(b * k, 3, 3),
            lab_kp.reshape(b * k, 3), nbr.idx.reshape(b * k, m),
            nbr.dist.reshape(b * k, m), nbr.valid.reshape(b * k, m))
    cloud = torch.arange(b, device=points.device).repeat_interleave(k)
    for r0 in range(0, b * k, rows):
        kp, fr, lk, idx, dist, valid = (x[r0:r0 + rows] for x in flat)
        cl = cloud[r0:r0 + rows]
        npos = points[cl[:, None], idx]                        # [R, M, 3]
        use = valid & (dist > 1e-15) & torch.isfinite(dist)
        d = npos - kp[:, None, :]
        x_l, y_l, z_l = _local(d[..., 0], d[..., 1], d[..., 2], fr)
        use, r, theta, phi = _spherical(x_l, y_l, z_l, use, radius,
                                        min_radius)
        cdist = color_distance(lk[:, None, :], lab_pts[cl[:, None], idx])
        slot_i, slot_w = _short_cshot_slots(
            r, theta, phi, cdist, use, radius, (r_bins, e_bins, a_bins),
            (r_cbins, e_cbins, a_cbins), color_hist_size, shape_dims,
            min_radius, log_radius)
        hist[r0:r0 + rows].scatter_add_(
            1, slot_i.reshape(slot_i.shape[0], -1).long(),
            slot_w.reshape(slot_w.shape[0], -1))
    hist = hist.reshape(b, k, total)
    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    desc = hist / torch.clamp(norm, min=1e-30)
    valid = frame_valid & (norm[..., 0] > 0)
    return ShortShotResult(desc, valid)


def _short_cshot_slots(r, theta, phi, cdist, use, radius, shape_bins,
                       color_bins, color_hist_size, shape_dims, min_radius,
                       log_radius):
    """The nine (bin, weight) slots [R, M, 9] of SHORT_CSHOT's pairs: four
    of the shape grid, five of the colour grid."""
    usef = use.to(r.dtype)[..., None]

    def weights(parts):
        return torch.stack(parts, -1) * usef

    rb, eb, ab = shape_bins
    (br, bt, bp), (br2, bt2, bp2), (wr, wt, wp), (r2ok, t2ok, p2ok) = \
        _grid(r, theta, phi, radius, rb, eb, ab, min_radius, log_radius)
    zero = torch.zeros_like(wr)

    def lin_s(a, b_, c):
        return a + b_ * rb + c * (rb * eb)

    idx_s = torch.stack([lin_s(br, bt, bp), lin_s(br, bt, bp2),
                         lin_s(br, bt2, bp), lin_s(br2, bt, bp)], -1)
    w_s = weights([wr + wt + wp,
                   torch.where(p2ok, wr + wt + (1.0 - wp), zero),
                   torch.where(t2ok, wr + (1.0 - wt) + wp, zero),
                   torch.where(r2ok, (1.0 - wr) + wt + wp, zero)])

    crb, ceb, cab = color_bins
    (cbr, cbt, cbp), (cbr2, cbt2, cbp2), (cwr, cwt, cwp), \
        (cr2ok, ct2ok, cp2ok) = _grid(r, theta, phi, radius, crb, ceb, cab,
                                      min_radius, log_radius)
    raw_c = cdist * color_hist_size
    b_c = torch.clamp(raw_c.to(torch.int32), max=color_hist_size - 1)
    w_c, o_c = _interp(raw_c)
    b_c2 = _correct_bin(b_c + o_c, color_hist_size, False)
    c2ok = (b_c2 != b_c) & (color_hist_size > 1)

    def cidx(bc, a, b_, c):
        return shape_dims + bc + (a + b_ * crb + c * (crb * ceb)) \
            * color_hist_size

    idx_c = torch.stack([cidx(b_c, cbr, cbt, cbp), cidx(b_c, cbr, cbt, cbp2),
                         cidx(b_c, cbr, cbt2, cbp), cidx(b_c, cbr2, cbt, cbp),
                         cidx(b_c2, cbr, cbt, cbp)], -1)
    w_col = weights([
        w_c + cwr + cwt + cwp,
        torch.where(cp2ok, w_c + cwr + cwt + (1.0 - cwp), zero),
        torch.where(ct2ok, w_c + cwr + (1.0 - cwt) + cwp, zero),
        torch.where(cr2ok, w_c + (1.0 - cwr) + cwt + cwp, zero),
        # the reference's quirk: the colour secondary also flips w_r
        torch.where(c2ok, (1.0 - w_c) + (1.0 - cwr) + cwt + cwp, zero)])
    idx = torch.cat([idx_s, idx_c], -1)
    w = torch.cat([w_s, w_col], -1)
    return torch.where(w > 0, idx, torch.zeros_like(idx)), w
