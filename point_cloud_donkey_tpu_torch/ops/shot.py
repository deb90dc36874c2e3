"""SHOT-352 and CSHOT-1344 descriptors (port of
point_cloud_donkey_tpu/ops/shot.py): the plain PyTorch twin of K3 and K7
(ops/kernels/shot_fused.py), and the dense CSHOT of the CSHOT serving step,
which accumulates its slots with K8 (ops/kernels/shot_hist.py).

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

CSHOT (PCL SHOTColorEstimation) adds a colour channel: the normalised-Lab
distance between each point's colour and the keypoint's, binned into 31
slots per volume with the same spatial interpolation.  Its dense form
takes exact coordinate differences too (the JAX dense path uses the matmul
identity), for the same reasons as SHOT here: it gives the kernels' and
the twins' float values, and an exact-zero self pair stays excluded.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .color import color_distance, rgb_to_cielab_normalized
from .kernels import f32
from .kernels.shot_hist import shot_hist

NR_BINS = 10            # cosine histogram bins (slot count per volume = 11)
NR_SECTORS = 32         # spatial volumes
NB = NR_BINS + 1
DESC_LEN = NR_SECTORS * NB  # 352
NR_COLOR_BINS = 30      # colour histogram bins (slot count per volume = 31)
CSHOT_LEN = DESC_LEN + NR_SECTORS * (NR_COLOR_BINS + 1)  # 1344

_RAD_45 = math.pi / 4.0
_RAD_90 = math.pi / 2.0
_RAD_135 = 3.0 * math.pi / 4.0
_RAD_PI_7_8 = math.pi * 7.0 / 8.0
_PAIR_BUDGET = 1 << 22  # [rows, N] elements per chunk
# [keypoints, N] pairs per chunk of the dense CSHOT: the whole 128-cloud
# serving batch (128 x 192 x 2048 = 5e7 pairs) is one chunk, so K8 runs
# twice a step; each [chunk] f32 temporary is then 0.2 GB
DENSE_PAIR_BUDGET = 1 << 26


class ShotResult(NamedTuple):
    descriptors: torch.Tensor  # [..., K, 352]
    valid: torch.Tensor        # [..., K]


class _Spatial(NamedTuple):
    """The spatial half of SHOT's binning for in-radius pairs: the volume
    of each pair, and for each of the radial, inclination and azimuth
    interpolations its term of the central weight, its target volume, its
    flag and its weight."""
    desc: torch.Tensor
    rad: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    incl: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    az: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _spatial(x_l, y_l, z_l, d, radius: float) -> _Spatial:
    """Volume bit pattern (PCL) and the quadrilinear spatial interpolation
    of SHOT and CSHOT, the same float operations as csrc/shot_fused.cu."""
    rad = f32(radius)
    r_half = f32(rad / 2.0)
    r34 = f32(f32(3.0 * rad) / 4.0)
    r14 = f32(rad / 4.0)
    one = torch.ones_like(d)

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

    # radial interpolation (adjacent shell)
    rd_out = (d - r34) / r_half
    rd_in = (d - r14) / r_half
    outer = d > r_half
    rd = torch.where(outer, rd_out, rd_in)
    has_rad = torch.where(outer, d <= r34, d >= r14)
    rad_c = torch.where(
        outer, torch.where(d > r34, 1.0 - rd_out, 1.0 + rd_out),
        torch.where(d < r14, 1.0 + rd_in, 1.0 - rd_in))
    rad_w = torch.where(has_rad, torch.abs(rd), 0.0 * one)
    rad_vol = desc + torch.where(outer, -2, 2)

    # inclination interpolation (adjacent elevation volume)
    incl = torch.arccos(torch.clamp(z_l / d, -1.0, 1.0))
    lower = (incl > _RAD_90) | ((incl == f32(_RAD_90)) & (z_l <= 0))
    id_low = (incl - _RAD_135) / _RAD_90
    id_up = (incl - _RAD_45) / _RAD_90
    incl_c = torch.where(
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
    az_c = torch.where(has_az, 1.0 - torch.abs(az_dist), 0.0 * one)
    az_vol = torch.where(az_dist > 0, (desc + 4) % NR_SECTORS,
                         (desc - 4 + NR_SECTORS) % NR_SECTORS)
    az_w = torch.where(has_az, torch.abs(az_dist), 0.0 * one)
    return _Spatial(desc, (rad_c, rad_vol, has_rad, rad_w),
                    (incl_c, incl_vol, has_incl, incl_w),
                    (az_c, az_vol, has_az, az_w))


def _soft_bin(bin_value: torch.Tensor, nr_bins: int):
    """Nearest slot of a histogram coordinate and its neighbour (modulo
    nr_bins, like PCL): (step, bd, neighbour slot)."""
    step = torch.floor(bin_value + 0.5)
    bd = bin_value - step
    step = step.to(torch.int64)
    nbr = torch.where(bd > 0, (step + 1) % nr_bins,
                      (step - 1 + nr_bins) % nr_bins)
    return step, bd, nbr


def shot_bin_slots(x_l, y_l, z_l, cos_desc, d, radius: float):
    """SHOT binning of in-radius pairs (1-D tensors) -> five (flat index
    into the 352-slot histogram, weight) slots, each [P]."""
    step, bd, cos_bin = _soft_bin((1.0 + cos_desc) * (NR_BINS / 2.0),
                                  NR_BINS)
    sp = _spatial(x_l, y_l, z_l, d, radius)
    (rad_c, rad_vol, has_rad, rad_w), (incl_c, incl_vol, has_incl, incl_w), \
        (az_c, az_vol, has_az, az_w) = sp.rad, sp.incl, sp.az
    central_w = 1.0 - torch.abs(bd)
    central_w = central_w + rad_c
    central_w = central_w + incl_c
    central_w = central_w + az_c
    desc = sp.desc
    return [
        (desc * NB + step, central_w),
        (desc * NB + cos_bin, torch.abs(bd)),
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


def _dense_batch(keypoints, points, mask, *rest):
    """Add a batch axis to single-cloud inputs: (single, tensors...)."""
    single = points.dim() == 2
    if single:
        keypoints, points, mask = keypoints[None], points[None], mask[None]
        rest = tuple(None if x is None else x[None] for x in rest)
    return (single, keypoints, points, mask) + tuple(rest)


def cloud_chunks(b: int, k: int, n: int, budget: int = DENSE_PAIR_BUDGET):
    """Cloud ranges [b0, b1) of at most `budget` [keypoint, point] pairs
    (at least one cloud each)."""
    step = max(1, budget // max(k * n, 1))
    return [(b0, min(b, b0 + step)) for b0 in range(0, b, step)]


def cshot_descriptor_dense(keypoints: torch.Tensor,    # [K, 3] / [B, K, 3]
                           kp_rgb: torch.Tensor,       # [K, 3] / [B, K, 3]
                           frames: torch.Tensor,       # [K, 3, 3] / [B, ...]
                           frame_valid: torch.Tensor,  # [K] / [B, K]
                           points: torch.Tensor,       # [N, 3] / [B, N, 3]
                           normals: torch.Tensor,      # [N, 3] / [B, N, 3]
                           rgb: torch.Tensor,          # [N, 3] / [B, N, 3]
                           mask: torch.Tensor,         # [N] / [B, N]
                           radius: float,
                           min_neighbors: int = 5) -> ShotResult:
    """CSHOT-1344 of every keypoint against its cloud (the JAX
    ``cshot_descriptor_dense``; colours in [0, 1]): [..., K, 1344], shape
    channel first.  The slot arrays are built in plain torch over the
    [keypoint, point] grid, one chunk of clouds at a time, and K8
    accumulates each channel; both channels are normalised jointly."""
    (single, keypoints, points, mask, kp_rgb, frames, frame_valid, normals,
     rgb) = _dense_batch(keypoints, points, mask, kp_rgb, frames,
                         frame_valid, normals, rgb)
    b, k, _ = keypoints.shape
    n = points.shape[1]
    hist = torch.empty((b, k, CSHOT_LEN), dtype=points.dtype,
                       device=points.device)
    count = torch.empty((b, k), dtype=torch.int32, device=points.device)
    lab_kp = rgb_to_cielab_normalized(kp_rgb)                   # [B, K, 3]
    lab_pt = rgb_to_cielab_normalized(rgb)                      # [B, N, 3]
    nrm_ok = mask & torch.isfinite(normals).all(-1)             # [B, N]
    for b0, b1 in cloud_chunks(b, k, n):
        h, c = _cshot_chunk(keypoints[b0:b1], lab_kp[b0:b1], frames[b0:b1],
                            points[b0:b1], normals[b0:b1], lab_pt[b0:b1],
                            nrm_ok[b0:b1], radius)
        hist[b0:b1], count[b0:b1] = h, c
    res = normalize_descriptors(hist, count, frame_valid, min_neighbors)
    if single:
        res = ShotResult(res.descriptors[0], res.valid[0])
    return res


def _cshot_chunk(kp, lab_kp, frames, points, normals, lab_pt, nrm_ok,
                 radius):
    """Raw CSHOT histograms [c, K, 1344] and in-radius counts [c, K] of a
    chunk of clouds: K8 over each channel's slot arrays."""
    c, k, _ = kp.shape
    channels, count = cshot_slot_arrays(kp, lab_kp, frames, points, normals,
                                        lab_pt, nrm_ok, radius)
    hist = torch.cat([shot_hist(*args) for args in channels], dim=1)
    return hist.reshape(c, k, CSHOT_LEN), count


def cshot_slot_arrays(kp, lab_kp, frames, points, normals, lab_pt, nrm_ok,
                      radius):
    """The binning of the JAX ``_cshot_core_from_coords`` for a chunk of
    clouds [c, K] x [c, N]: (the arguments of K8 for the shape channel and
    for the colour channel -- eleven [c * K, N] slot arrays and n_bin --,
    in-radius counts [c, K] i32).  Unused pairs weigh zero."""
    c, k, _ = kp.shape
    r = f32(radius)
    dx = points[:, None, :, 0] - kp[:, :, None, 0]              # [c, K, N]
    dy = points[:, None, :, 1] - kp[:, :, None, 1]
    dz = points[:, None, :, 2] - kp[:, :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    use = (d2 <= f32(r * r)) & (d2 > 1e-15) & nrm_ok[:, None, :]
    f = frames.reshape(c, k, 9)[..., None]                      # [c, K, 9, 1]
    x_l = dx * f[:, :, 0] + dy * f[:, :, 1] + dz * f[:, :, 2]
    y_l = dx * f[:, :, 3] + dy * f[:, :, 4] + dz * f[:, :, 5]
    z_l = dx * f[:, :, 6] + dy * f[:, :, 7] + dz * f[:, :, 8]
    del dx, dy, dz
    nrm = normals[:, None, :, :]
    cos_desc = torch.clamp(nrm[..., 0] * f[:, :, 6] + nrm[..., 1] * f[:, :, 7]
                           + nrm[..., 2] * f[:, :, 8], -1.0, 1.0)
    cos_desc = torch.where(use, cos_desc, torch.zeros_like(cos_desc))
    cdist = color_distance(lab_kp[:, :, None, :], lab_pt[:, None, :, :])
    d = torch.where(use, torch.sqrt(d2), torch.full_like(d2, f32(r / 2.0)))
    del d2

    sp = _spatial(x_l, y_l, z_l, d, radius)
    del x_l, y_l, z_l, d
    (rad_c, rad_vol, has_rad, rad_w), (incl_c, incl_vol, has_incl, incl_w), \
        (az_c, az_vol, has_az, az_w) = sp.rad, sp.incl, sp.az
    zero = torch.zeros_like(cdist)

    def masked(w):
        return torch.where(use, w, zero).reshape(c * k, -1)

    def flat(x):
        return x.to(torch.int32).reshape(c * k, -1)

    rv, rw = flat(torch.where(has_rad, rad_vol, 0)), masked(rad_w)
    iv, iw = flat(torch.where(has_incl, incl_vol, 0)), masked(incl_w)
    av, aw = flat(az_vol), masked(az_w)
    desc = flat(sp.desc)
    channels = []
    for value, nr_bins in (((1.0 + cos_desc) * (NR_BINS / 2.0), NR_BINS),
                           (cdist * float(NR_COLOR_BINS), NR_COLOR_BINS)):
        step, bd, nbr = _soft_bin(value, nr_bins)
        w = 1.0 - torch.abs(bd)
        w = w + rad_c
        w = w + incl_c
        w = w + az_c
        channels.append((desc, flat(step), masked(w), flat(nbr),
                         masked(torch.abs(bd)), rv, rw, iv, iw, av, aw,
                         nr_bins + 1))
    return channels, use.sum(-1, dtype=torch.int32)
