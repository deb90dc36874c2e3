"""Whole-cloud descriptors ESF-640, VFH-308, GRSD-21 and GASD-512 / 984
(port of point_cloud_donkey_tpu/ops/global_descriptors.py), batched over
clouds [B, N].

ESF samples 3 x 20000 point indices from a counter-based PRNG.  To give a
model trained by the JAX package the same descriptors, the port draws the
same indices: :func:`threefry2x32`, :func:`prng_split` and
:func:`randint` reproduce ``jax.random.PRNGKey`` / ``split`` /
``randint`` bit for bit (threefry-2x32, 20 rounds, with
``jax_threefry_partitionable`` on, as in JAX 0.9), in numpy on the host.
The draws depend only on the count of valid points, so a cloud gives the
same descriptor at any padded length; ESF_LOCAL draws with each
keypoint's neighbour count (an array of spans).

GRSD's [N, N] passes run over chunks of query rows (ops/tiled.row_steps); its surface classes are decisions at fixed multiples of the
radius on d / (2 sin(angle / 2)), which rounding moves for near-parallel
normals.  GASD's axes point towards the sign of the cloud's skewness
along them.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .descriptors_misc import slot_histogram
from .eigh3 import eigh3x3
from .fpfh import pair_features_pcl
from .kernels import f32
from .neighbors import full_fp32
from .tiled import row_steps, sqdist

# -- JAX's threefry PRNG, in numpy --------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: np.uint32, k2: np.uint32, x1: np.ndarray,
                 x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 hash of the counters (x1, x2) under the key
    (k1, k2) (jax._src.prng ``_threefry2x32_lowering``)."""
    u32 = np.uint32
    ks = (u32(k1), u32(k2), u32(k1) ^ u32(k2) ^ u32(0x1BD11BDA))
    a = (x1.astype(u32) + ks[0]).astype(u32)
    b = (x2.astype(u32) + ks[1]).astype(u32)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = ((b << u32(r)) | (b >> u32(32 - r))) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + u32(i + 1)
    return a, b


def prng_key(seed: int) -> Tuple[np.uint32, np.uint32]:
    """``jax.random.PRNGKey(seed)``'s two words."""
    return np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)


def prng_split(key, num: int):
    """``jax.random.split(key, num)``: the hashes of the counters
    0..num-1."""
    a, b = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                        np.arange(num, dtype=np.uint32))
    return [(a[i], b[i]) for i in range(num)]


@functools.lru_cache(maxsize=16)
def _random_bits(k1: int, k2: int, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,))`` (32 bits): both hash words xor-ed."""
    a, b = threefry2x32(np.uint32(k1), np.uint32(k2), np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))
    return a ^ b


def randint(key, n: int, maxval, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, maxval)`` as int64 on `device`:
    [n], or [len(maxval), n] for an array of maxvals (one draw per span
    from the same bits, as under ``jax.vmap``).  The bits come from the
    host; the remainders follow JAX's uint32 arithmetic (wrapping products
    and sums) on the device."""
    k1, k2 = prng_split(key, 2)
    hi, lo = (torch.from_numpy(_random_bits(int(k[0]), int(k[1]), n)
                               .astype(np.int64)).to(device)
              for k in (k1, k2))
    mx = maxval.to(device=device, dtype=torch.int64) \
        if torch.is_tensor(maxval) else \
        torch.as_tensor(np.asarray(maxval), dtype=torch.int64, device=device)
    span = torch.where(mx <= 0, torch.ones_like(mx), mx)
    if span.dim():
        span = span[:, None]
    m32 = 0xFFFFFFFF
    mult = 65536 % span
    mult = ((mult * mult) & m32) % span
    off = ((((hi % span) * mult) & m32) + lo % span) & m32
    return off % span


# Giles' float32 erf_inv polynomials, XLA's (|w| < 5 and beyond)
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941],
                         np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682], np.float32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: the 32-bit draws of
    the shape's counters (:func:`_random_bits`), JAX's uniform on
    [nextafter(-1, 0), 1) from their 23 high bits, then XLA's erf_inv --
    Giles' polynomial, each multiply-add fused -- times sqrt(2).  Equal
    to JAX's to within 3 ulps: the log1p here is rounded from float64,
    XLA's is an approximation of its own."""
    n = int(np.prod(shape))
    bits = _random_bits(int(key[0]), int(key[1]), n)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    one = np.float32(1.0)
    u = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    x = np.maximum(lo, u * (one - lo) + lo).astype(np.float32)
    w = -np.log1p(-(x * x).astype(np.float64)).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).astype(np.float32)
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, cs, cl).astype(np.float64)
        p = (p.astype(np.float64) * w + c).astype(np.float32)
    out = np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)
    return (np.float32(math.sqrt(2.0)) * out).astype(np.float32).reshape(shape)


# -- ESF-640 (Wohlkinger & Vincze; features/features_esf.cpp) ----------------

ESF_BINS = 64
ESF_SAMPLES = 20000
ESF_GRID = 64
# [clouds, samples, 16] line samples of one ESF chunk
_ESF_BUDGET = 1 << 23


def esf_sample_indices(mask: torch.Tensor, seed: int = 0,
                       samples: int = ESF_SAMPLES) -> torch.Tensor:
    """[B, 3, samples] indices of ESF's point pairs / triples for the
    masks [B, N] (the JAX ``esf_sample_indices``): draws uniform over each
    row's valid count into its valid-first stable order."""
    count = torch.clamp(mask.sum(-1), min=1)
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    draws = torch.stack([randint(k, samples, count, mask.device)
                         for k in prng_split(prng_key(seed), 3)], 1)
    return torch.gather(order[:, None, :].expand(-1, 3, -1), 2, draws)


def _esf_line_class(p, q, occ):
    """(class 0 in / 1 out / 2 mixed, occupied fraction) of the segments
    p -> q [B, S, 3] over the grids occ [B, 64^3], 16 samples each."""
    dt = p.dtype
    t = (torch.arange(1, 17, dtype=dt, device=p.device) / 17)[:, None]
    s = p[..., None, :] * (1 - t) + q[..., None, :] * t      # [B, S, 16, 3]
    c = torch.clamp((s * (ESF_GRID - 1)).to(torch.int32), 0, ESF_GRID - 1)
    f = (c[..., 0] * ESF_GRID + c[..., 1]) * ESF_GRID + c[..., 2]
    hit = torch.gather(occ, 1, f.reshape(len(p), -1).long()
                       ).reshape(f.shape)
    frac = hit.to(dt).mean(-1)
    two = torch.full_like(frac, 2, dtype=torch.int64)
    cls = torch.where(frac > 0.9, 0, torch.where(frac < 0.1, 1, two))
    return cls, frac


def _esf_hist(vals, sel, lo, hi):
    b = torch.clamp(((vals - lo) / (hi - lo) * ESF_BINS).to(torch.int32), 0,
                    ESF_BINS - 1)
    return slot_histogram(b, sel.to(vals.dtype), ESF_BINS, 1)


def _esf_chunk(points, mask, ia, ib, ic):
    """[B, 640] ESF of the clouds [B, N] at the sample indices [B, S]."""
    dt = points.dtype
    b = points.shape[0]
    inf = torch.full_like(points, math.inf)
    mn = torch.where(mask[..., None], points, inf).amin(1)
    mx = torch.where(mask[..., None], points, -inf).amax(1)
    scale = torch.clamp((mx - mn).amax(-1), min=1e-12)
    unit = (points - mn[:, None, :]) / scale[:, None, None]
    cells = torch.clamp((unit * (ESF_GRID - 1)).to(torch.int32), 0,
                        ESF_GRID - 1)
    flat = (cells[..., 0] * ESF_GRID + cells[..., 1]) * ESF_GRID \
        + cells[..., 2]
    occ = torch.zeros((b, ESF_GRID ** 3), dtype=torch.bool,
                      device=points.device)
    rows, cols = mask.nonzero(as_tuple=True)
    occ[rows, flat[rows, cols].long()] = True

    def pick(i):
        return torch.gather(unit, 1, i[..., None].expand(-1, -1, 3))

    pa, pb, pc = pick(ia), pick(ib), pick(ic)
    d2 = torch.linalg.norm(pa - pb, dim=-1)
    cls_ab, frac_ab = _esf_line_class(pa, pb, occ)
    h = [_esf_hist(d2, cls_ab == c, 0.0, math.sqrt(3.0)) for c in range(3)]
    h_ratio = _esf_hist(frac_ab, cls_ab >= 0, 0.0, 1.0)
    v1, v2 = pa - pb, pc - pb
    cosang = (v1 * v2).sum(-1) / torch.clamp(
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1),
        min=1e-12)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    cls_ac, _ = _esf_line_class(pa, pc, occ)
    h += [_esf_hist(ang, cls_ac == c, 0.0, math.pi) for c in range(3)]
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(pb - pa, pc - pa),
                                   dim=-1)
    d3 = torch.sqrt(area)
    cls_bc, _ = _esf_line_class(pb, pc, occ)
    votes_in = (cls_ab == 0).long() + (cls_ac == 0) + (cls_bc == 0)
    votes_out = (cls_ab == 1).long() + (cls_ac == 1) + (cls_bc == 1)
    tri = torch.where(votes_in >= 2, 0, torch.where(votes_out >= 2, 1, 2))
    hi3 = float(np.sqrt(np.float32(0.5) * np.sqrt(np.float32(3.0))))
    h += [_esf_hist(d3, tri == c, 0.0, hi3) for c in range(3)]
    full = torch.cat(h + [h_ratio], -1)
    return full / torch.clamp(full.sum(-1, keepdim=True), min=1e-30)


def esf_descriptor(points: torch.Tensor,   # [B, N, 3]
                   mask: torch.Tensor,     # [B, N]
                   seed: int = 0,
                   indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, 640] ESF of each cloud (the JAX ``esf_descriptor``): 10 x 64
    bins -- D2 distances, A3 angles and D3 areas of sampled pairs /
    triples, each split by the line-tracing class (in / out / mixed) over a
    64^3 occupancy grid, and the in-fraction histogram -- normalised to
    sum 1.  `indices` [B, 3, S] replaces the sampled streams.  Clouds run
    in chunks of _ESF_BUDGET line samples."""
    b = points.shape[0]
    s = ESF_SAMPLES if indices is None else indices.shape[-1]
    out = torch.empty((b, 10 * ESF_BINS), dtype=points.dtype,
                      device=points.device)
    step = max(1, _ESF_BUDGET // (s * 16))
    for b0 in range(0, b, step):
        sl = slice(b0, b0 + step)
        idx = esf_sample_indices(mask[sl], seed) if indices is None \
            else indices[sl]
        out[sl] = _esf_chunk(points[sl], mask[sl], idx[:, 0], idx[:, 1],
                             idx[:, 2])
    return out


# -- VFH-308 (Rusu et al.; features/features_vfh.cpp) -------------------------

VFH_BINS = 45
VFH_VP_BINS = 128
VFH_LEN = 4 * VFH_BINS + VFH_VP_BINS  # 308


def vfh_descriptor(points: torch.Tensor,    # [B, N, 3]
                   normals: torch.Tensor,   # [B, N, 3]
                   mask: torch.Tensor,      # [B, N]
                   viewpoint: Sequence[float] = (0.0, 0.0, 0.0),
                   centroid: Optional[torch.Tensor] = None,    # [B, 3]
                   avg_normal: Optional[torch.Tensor] = None,  # [B, 3]
                   normalize_bins: bool = True) -> torch.Tensor:
    """[B, 308] VFH (the JAX ``vfh_descriptor``): pcl::computePairFeatures
    of every point against the (centroid, average normal) pair, 45 bins
    each of f1, f2, f3 and the distance over its maximum, then 128 bins of
    the cosine between the normal and the viewpoint direction; each
    percentage-normalised (100 / N) unless `normalize_bins` is off (CVFH's
    raw counts).  `centroid` / `avg_normal` replace the cloud's (CVFH's
    clusters)."""
    dt = points.dtype
    m = mask.to(dt)
    msum = torch.clamp(m.sum(-1), min=1.0)
    if centroid is None:
        centroid = (points * m[..., None]).sum(1) / msum[:, None]
    n_avg = (normals * m[..., None]).sum(1) if avg_normal is None \
        else avg_normal
    n_avg = n_avg / torch.clamp(torch.linalg.norm(n_avg, dim=-1,
                                                  keepdim=True), min=1e-12)
    f1, f2, f3, d, deg = pair_features_pcl(
        centroid[:, None, :].expand_as(points),
        n_avg[:, None, :].expand_as(points), points, normals)
    max_d = torch.where(mask, d, torch.zeros_like(d)).amax(-1, keepdim=True)
    dn = d / torch.clamp(max_d, min=1e-12)
    mc = m * (~deg).to(dt)
    fac = (100.0 / msum)[:, None] if normalize_bins else 1.0

    def hist(vals, lo, hi, weights, bins):
        bi = torch.clamp(((vals - lo) / (hi - lo) * bins).to(torch.int32), 0,
                         bins - 1)
        return fac * slot_histogram(bi, weights, bins, 1)

    vp = torch.tensor(viewpoint, dtype=dt, device=points.device)
    vdir = vp - points
    vdir = vdir / torch.clamp(torch.linalg.norm(vdir, dim=-1, keepdim=True),
                              min=1e-12)
    cos_vp = (normals * vdir).sum(-1)
    return torch.cat([hist(f1, -math.pi, math.pi, mc, VFH_BINS),
                      hist(f2, -1.0, 1.0, mc, VFH_BINS),
                      hist(f3, -1.0, 1.0, mc, VFH_BINS),
                      hist(dn, 0.0, 1.0, mc, VFH_BINS),
                      hist(cos_vp, -1.0, 1.0, m, VFH_VP_BINS)], -1)


# -- GRSD-21 (Marton et al.; features/features_grsd.cpp) ----------------------

GRSD_LEN = 21


def rsd_radii(points: torch.Tensor, normals: torch.Tensor,
              mask: torch.Tensor, radius: float):
    """Per-point RSD (r_min [B, N], r_max [B, N], has [B, N]) over the
    in-radius unmasked points at a nonzero distance (the JAX
    ``_rsd_radii``), in chunks of rows."""
    b, n, _ = points.shape
    r2 = f32(radius * radius)
    r_min = torch.empty((b, n), dtype=points.dtype, device=points.device)
    r_max = torch.empty_like(r_min)
    has = torch.empty((b, n), dtype=torch.bool, device=points.device)
    for r0, r1 in row_steps(b, n, n):
        d2 = sqdist(points[:, r0:r1], points)
        in_r = (d2 <= r2) & mask[:, None, :] & (d2 > 1e-12)
        d = torch.sqrt(torch.clamp(d2, min=0.0))
        del d2
        with full_fp32():
            cos_a = torch.clamp(normals[:, r0:r1] @ normals.transpose(1, 2),
                                -1.0, 1.0)
        ang = torch.arccos(cos_a)
        r_est = d / torch.clamp(2.0 * torch.sin(ang / 2.0), min=1e-3)
        r_est = torch.clamp(r_est, 0.0, 1e3)
        del d, ang, cos_a
        r_min[:, r0:r1] = torch.where(in_r, r_est,
                                      torch.full_like(r_est, math.inf)
                                      ).amin(-1)
        r_max[:, r0:r1] = torch.where(in_r, r_est,
                                      torch.zeros_like(r_est)).amax(-1)
        has[:, r0:r1] = in_r.any(-1)
    return torch.where(has, r_min, torch.zeros_like(r_min)), r_max, has


def surface_type(r_min, r_max, radius: float) -> torch.Tensor:
    """GRSD's class of each point: 0 plane, 1 cylinder, 2 noise / corner,
    3 sphere, 4 edge (the JAX ``_surface_type``)."""
    plane = r_min > 2.0 * radius
    sphere = (r_max < 2.0 * radius) & (r_min > 0.5 * radius)
    cylinder = (r_min < 2.0 * radius) & (r_max > 2.0 * radius) \
        & (r_min > 0.5 * radius)
    edge = r_min < 0.15 * radius
    two = torch.full(r_min.shape, 2, dtype=torch.int64,
                     device=r_min.device)
    return torch.where(plane, 0, torch.where(cylinder, 1, torch.where(
        sphere, 3, torch.where(edge, 4, two))))


def grsd_types(points, normals, mask, radius: float) -> torch.Tensor:
    """[B, N] surface classes, 5 (free space) where a point is masked or
    has no neighbour."""
    r_min, r_max, has = rsd_radii(points, normals, mask, radius)
    t = surface_type(r_min, r_max, radius)
    return torch.where(has & mask, t, torch.full_like(t, 5))


def grsd_descriptor(points: torch.Tensor,   # [B, N, 3]
                    normals: torch.Tensor,  # [B, N, 3]
                    mask: torch.Tensor,     # [B, N]
                    radius: float,
                    types: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, 21] GRSD (the JAX ``grsd_descriptor``): the upper triangle of
    the 6 x 6 surface-type transition counts between in-radius point
    pairs, normalised to sum 1; `types` [B, N] replaces the classes.  The
    counts are exact integers."""
    if types is None:
        types = grsd_types(points, normals, mask, radius)
    b, n, _ = points.shape
    r2 = f32(radius * radius)
    onehot = torch.nn.functional.one_hot(types, 6).to(torch.int64)
    counts = torch.zeros((b, 6, 6), dtype=torch.int64, device=points.device)
    for r0, r1 in row_steps(b, n, n):
        d2 = sqdist(points[:, r0:r1], points)
        adj = (d2 <= r2) & (d2 > 1e-12) & mask[:, None, :] \
            & mask[:, r0:r1, None]
        del d2
        # per row, its neighbours' classes; then the rows' own class
        per_row = torch.stack([(adj & (types[:, None, :] == c)).sum(-1)
                               for c in range(6)], -1)     # [B, R, 6]
        counts += (onehot[:, r0:r1, :, None] * per_row[:, :, None, :]
                   ).sum(1)
    lo = torch.arange(6, device=points.device)
    ii, jj = torch.meshgrid(lo, lo, indexing="ij")
    a, c = torch.minimum(ii, jj), torch.maximum(ii, jj)
    tri = (a * (11 - a)) // 2 + (c - a)
    h = torch.zeros((b, GRSD_LEN), dtype=torch.int64, device=points.device)
    h.scatter_add_(1, tri.reshape(1, 36).expand(b, 36), counts.reshape(b, 36))
    h = h.to(points.dtype)
    return h / torch.clamp(h.sum(-1, keepdim=True), min=1e-30)


# -- GASD (Lima & Teichrieb; features/features_gasd.cpp) ----------------------

def gasd_descriptor(points: torch.Tensor,   # [B, N, 3]
                    mask: torch.Tensor,     # [B, N]
                    rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, 512] shape-only, or with `rgb` [B, 984] (6^3 shape + 4^3 x 12
    hue bins), GASD of each cloud (the JAX ``gasd_descriptor``): the cloud
    in its PCA frame, the smallest and largest axes pointed towards their
    positive skewness, counts over the grid divided by N."""
    dt = points.dtype
    m = mask.to(dt)
    msum = torch.clamp(m.sum(-1), min=1.0)
    c = (points * m[..., None]).sum(1) / msum[:, None]
    centered = points - c[:, None, :]
    cov = (m[..., None, None] * centered[..., :, None]
           * centered[..., None, :]).sum(1) / msum[:, None, None]
    _, vecs = eigh3x3(cov)

    def flip(v):
        s = (m * ((centered * v[:, None, :]).sum(-1)) ** 3).sum(-1)
        return torch.where((s < 0)[:, None], -v, v)

    a0 = flip(vecs[..., 0])
    a2 = flip(vecs[..., 2])
    axes = torch.stack([a0, torch.linalg.cross(a2, a0), a2], 1)
    local = (centered[..., None, :] * axes[:, None, :, :]).sum(-1)
    half = torch.where(mask[..., None], local.abs(),
                       torch.zeros_like(local)).amax((1, 2))
    half = torch.clamp(half, min=1e-12)
    unit = torch.clamp((local / half[:, None, None] + 1.0) / 2.0, 0.0,
                       1.0 - 1e-6)

    def grid_hist(g):
        cells = (unit * g).to(torch.int32)
        flat = (cells[..., 0] * g + cells[..., 1]) * g + cells[..., 2]
        return slot_histogram(flat, m, g ** 3, 1) / msum[:, None]

    if rgb is None:
        return grid_hist(8)
    shape = grid_hist(6)
    r, g_, b_ = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(-1)
    diff = torch.clamp(mx - rgb.amin(-1), min=1e-12)
    hue = torch.where(mx == r, (g_ - b_) / diff,
                      torch.where(mx == g_, 2.0 + (b_ - r) / diff,
                                  4.0 + (r - g_) / diff))
    hue = torch.remainder(hue * 60.0, 360.0)
    hue_bin = torch.clamp((hue / 360.0 * 12).to(torch.int32), 0, 11)
    cells4 = (unit * 4).to(torch.int32)
    flat4 = ((cells4[..., 0] * 4 + cells4[..., 1]) * 4 + cells4[..., 2]) \
        * 12 + hue_bin
    color = slot_histogram(flat4, m, 4 ** 3 * 12, 1) / msum[:, None]
    return torch.cat([shape, color], -1)
