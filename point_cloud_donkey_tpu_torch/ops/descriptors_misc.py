"""BSHOT, SpinImage and PFH (port of point_cloud_donkey_tpu/ops/
descriptors_misc.py), batched over clouds: [B, K] keypoints over [B, K, M]
neighbour gathers (ops/neighbors.gather_radius_neighbors).

BSHOT binarises SHOT-352 (K7's output) in groups of 4; SHORT_SHOT_PCL is
K7 with zero normals (models/features.py), so neither has code here.
Every histogram is one ``scatter_add_`` over (bin, weight) slots
(:func:`slot_histogram`): the JAX package sums them in XLA, outside
Pallas.  A bin comes from truncating a float, so a pair on a bin edge can
land in the neighbouring bin where a trigonometric function differs by an
ulp; BSHOT's bits are decisions at 0.9 x a group's sum.
"""

from __future__ import annotations

import math

import torch

from .fpfh import pair_features_pcl
from .neighbors import NeighborBlock, gather_rows
from .shot import ShotResult

# [rows, M, M] pairs of one chunk of PFH
_PFH_BUDGET = 1 << 22


def slot_histogram(idx: torch.Tensor, w: torch.Tensor, length: int,
                   keep: int) -> torch.Tensor:
    """[*lead, length] histograms of the (bin, weight) slots idx, w: the
    first `keep` axes are kept (lead), the rest are a row's slots (the JAX
    ``_histogram_from_slots``); one scatter_add_."""
    lead = idx.shape[:keep]
    rows = math.prod(lead)
    hist = torch.zeros((rows, length), dtype=w.dtype, device=w.device)
    hist.scatter_add_(1, idx.reshape(rows, -1).long(),
                      w.reshape(rows, -1).contiguous())
    return hist.reshape(tuple(lead) + (length,))


# -- BSHOT (features/features_bshot.cpp) ------------------------------------

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _last_hit(sums, thr):
    """Index of the last subset whose sum exceeds thr, -1 where none."""
    hits = torch.stack(sums, -1) > thr[..., None]
    ids = torch.arange(hits.shape[-1], device=hits.device)
    return torch.where(hits, ids, torch.full_like(ids, -1)).amax(-1)


def bshot_binarize(shot: torch.Tensor) -> torch.Tensor:
    """SHOT [..., 352] binarised in groups of 4 (features_bshot.cpp:108-152):
    an all-zero group -> 0000; one value > 0.9 x the group's sum -> its bit;
    else the last pair whose sum exceeds it -> its two bits; else the last
    such triple; else 1111.  Subset sums add in index order."""
    lead, d = shot.shape[:-1], shot.shape[-1]
    g = shot.reshape(tuple(lead) + (d // 4, 4))
    s = ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]
    thr = 0.9 * s
    single = g > thr[..., None]
    case_b = single.sum(-1) == 1
    last_pair = _last_hit([g[..., a] + g[..., b] for a, b in _PAIRS], thr)
    case_c = (last_pair >= 0) & ~case_b
    last_tri = _last_hit([(g[..., a] + g[..., b]) + g[..., c]
                          for a, b, c in _TRIPLES], thr)
    case_d = (last_tri >= 0) & ~case_b & ~case_c
    case_e = (s != 0) & ~case_b & ~case_c & ~case_d
    pair_bits = torch.zeros((6, 4), dtype=shot.dtype, device=shot.device)
    for i, (a, b) in enumerate(_PAIRS):
        pair_bits[i, a] = pair_bits[i, b] = 1.0
    tri_bits = torch.ones((4, 4), dtype=shot.dtype, device=shot.device)
    for i, t in enumerate(_TRIPLES):
        tri_bits[i, ({0, 1, 2, 3} - set(t)).pop()] = 0.0
    out = torch.where(case_b[..., None] & single, 1.0, 0.0).to(shot.dtype)
    out = torch.where(case_c[..., None], pair_bits[last_pair.clamp(0, 5)],
                      out)
    out = torch.where(case_d[..., None], tri_bits[last_tri.clamp(0, 3)], out)
    out = torch.where(case_e[..., None], torch.ones_like(out), out)
    return out.reshape(shot.shape)


# -- spin images (features/features_spin_image.cpp, width 8 -> 153) ---------

SPIN_WIDTH = 8
SPIN_LEN = (SPIN_WIDTH + 1) * (2 * SPIN_WIDTH + 1)  # 153


def spin_image_descriptor(keypoints: torch.Tensor,   # [B, K, 3]
                          kp_normals: torch.Tensor,  # [B, K, 3] spin axes
                          kp_mask: torch.Tensor,     # [B, K]
                          points: torch.Tensor,      # [B, N, 3]
                          nbr: NeighborBlock,        # [B, K, M]
                          radius: float,
                          min_neighbors: int = 5) -> ShotResult:
    """Spin images (the JAX ``spin_image_descriptor``): beta = n . (q - p),
    alpha = sqrt(|q - p|^2 - beta^2), bilinear-binned into a (2W+1) x
    (W+1) image, normalised to sum 1."""
    use = nbr.valid & torch.isfinite(nbr.dist)
    delta = gather_rows(points, nbr.idx) - keypoints[..., None, :]
    beta = (delta * kp_normals[..., None, :]).sum(-1)
    d2 = (delta * delta).sum(-1)
    alpha = torch.sqrt(torch.clamp(d2 - beta * beta, min=0.0))
    a_bin = alpha / radius * SPIN_WIDTH
    b_bin = (beta / radius + 1.0) * SPIN_WIDTH
    use = use & (a_bin <= SPIN_WIDTH) & (b_bin >= 0) \
        & (b_bin <= 2 * SPIN_WIDTH)
    zero = torch.zeros_like(a_bin)
    a_bin = torch.where(use, a_bin, zero)
    b_bin = torch.where(use, b_bin, zero)
    a0 = torch.clamp(torch.floor(a_bin).to(torch.int32), 0, SPIN_WIDTH - 1)
    b0 = torch.clamp(torch.floor(b_bin).to(torch.int32), 0,
                     2 * SPIN_WIDTH - 1)
    fa = a_bin - a0
    fb = b_bin - b0
    stride = 2 * SPIN_WIDTH + 1
    base = a0 * stride + b0
    idx = torch.stack([base, base + 1, base + stride, base + stride + 1], -1)
    w = torch.stack([(1 - fa) * (1 - fb), (1 - fa) * fb, fa * (1 - fb),
                     fa * fb], -1) * use.to(points.dtype)[..., None]
    idx = torch.where(use[..., None], idx, torch.zeros_like(idx))
    hist = slot_histogram(idx, w, SPIN_LEN, 2)
    total = torch.clamp(hist.sum(-1, keepdim=True), min=1e-30)
    valid = kp_mask & (use.sum(-1) >= min_neighbors)
    return ShotResult(hist / total, valid)


# -- PFH-125 (features/features_pfh.cpp) -------------------------------------

PFH_BINS = 5
PFH_LEN = PFH_BINS ** 3  # 125


def pfh_descriptor(keypoints: torch.Tensor,  # [B, K, 3]
                   kp_mask: torch.Tensor,    # [B, K]
                   points: torch.Tensor,     # [B, N, 3]
                   normals: torch.Tensor,    # [B, N, 3]
                   nbr: NeighborBlock,       # [B, K, M]
                   min_neighbors: int = 5) -> ShotResult:
    """PFH-125 (the JAX ``pfh_descriptor``): the joint 5 x 5 x 5
    histogram of pcl::computePairFeatures over every unordered pair of a
    keypoint's gathered neighbours, increment 100 / C(k, 2) (degenerate
    pairs add nothing but count in the denominator), in chunks of
    keypoint rows."""
    b, k, m = nbr.idx.shape
    rows = b * k
    idx_f = nbr.idx.reshape(rows, m)
    valid_f = nbr.valid.reshape(rows, m)
    cloud = torch.arange(b, device=points.device).repeat_interleave(k)
    hist = torch.empty((rows, PFH_LEN), dtype=points.dtype,
                       device=points.device)
    upper = torch.triu(torch.ones((m, m), dtype=torch.bool,
                                  device=points.device), diagonal=1)
    step = max(1, _PFH_BUDGET // max(m * m, 1))
    i32 = torch.int32
    for r0 in range(0, rows, step):
        cl, idx = cloud[r0:r0 + step], idx_f[r0:r0 + step]
        v = valid_f[r0:r0 + step]
        p = points[cl[:, None], idx]
        n = normals[cl[:, None], idx]
        f1, f2, f3, f4, deg = pair_features_pcl(
            p[:, :, None, :], n[:, :, None, :], p[:, None, :, :],
            n[:, None, :, :])
        deg = deg | (f4 == 0.0)
        b1 = torch.clamp((PFH_BINS * (f1 + math.pi) / (2 * math.pi)).to(i32),
                         0, PFH_BINS - 1)
        b2 = torch.clamp((PFH_BINS * (f2 + 1.0) / 2.0).to(i32), 0,
                         PFH_BINS - 1)
        b3 = torch.clamp((PFH_BINS * (f3 + 1.0) / 2.0).to(i32), 0,
                         PFH_BINS - 1)
        bins = b1 + b2 * PFH_BINS + b3 * PFH_BINS * PFH_BINS
        k_nb = v.sum(-1)
        n_pairs = torch.clamp(k_nb * (k_nb - 1) // 2, min=1)
        contrib = v[:, :, None] & v[:, None, :] & upper & ~deg
        incr = (100.0 / n_pairs.to(points.dtype))[:, None, None]
        w = torch.where(contrib, incr, torch.zeros_like(f1))
        bins = torch.where(contrib, bins, torch.zeros_like(bins))
        hist[r0:r0 + step] = slot_histogram(bins.reshape(len(cl), -1),
                                            w.reshape(len(cl), -1), PFH_LEN, 1)
    valid = kp_mask & (nbr.valid.sum(-1) >= min_neighbors)
    return ShotResult(hist.reshape(b, k, PFH_LEN), valid)
