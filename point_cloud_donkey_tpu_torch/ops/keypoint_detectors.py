"""Harris3D / ISS3D / SIFT3D keypoint detectors (port of
point_cloud_donkey_tpu/ops/keypoint_detectors.py; the reference wraps
pcl::HarrisKeypoint3D, pcl::ISSKeypoint3D and pcl::SIFTKeypoint at
keypoints/keypoints_{harris3d,iss3d,sift3d}.cpp).

One cloud of up to ops.tiled.SCENE_TILE_THRESHOLD points: neighbourhoods
from the pairwise-distance identity, responses from batched 3x3 algebra,
non-max suppression a masked row max; a boolean keypoint mask comes back.
The JAX programs build whole [N, N] matrices (4.3 GB each at 32768 points,
four of them for ISS3D); here every pass runs over chunks of query rows
(ops/tiled.row_steps), each row's reductions independent of the others,
so no temporary exceeds 128 MiB.  The matmuls run in full fp32 (the JAX package computes them
outside Pallas, at float32 on the CPU): TF32 would move the decisions.

Decisions compare floats (Harris3D's r > threshold and r >= its
neighbourhood's max, ISS3D's eigenvalue ratios against 0.975, SIFT3D's
strict extremum test): where the deciding value lies at the rounding of
its threshold a decision can differ from the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .eigh3 import eigh3x3
from .kernels import f32
from .neighbors import full_fp32
from .tiled import row_steps


class KeypointMask(NamedTuple):
    is_keypoint: torch.Tensor   # [N] bool
    positions: torch.Tensor     # [N, 3] (refined where Harris3D refines)
    response: torch.Tensor      # [N]


def sqdist_rows(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[R, N] squared distances by q^2 + p^2 - 2 q.p in full fp32, clamped
    at 0 (ops/neighbors.pairwise_sqdist)."""
    q2 = torch.sum(q * q, dim=-1)[:, None]
    p2 = torch.sum(p * p, dim=-1)[None, :]
    with full_fp32():
        cross = q @ p.T
    return torch.clamp(q2 + p2 - 2.0 * cross, min=0.0)


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinants of [..., 3, 3] by the rule of Sarrus, term for term as
    jnp.linalg.det computes a 3x3."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def outer9(a: torch.Tensor) -> torch.Tensor:
    """[N, 9] rows a a^T of [N, 3]."""
    return (a[:, :, None] * a[:, None, :]).reshape(-1, 9)


def _in_radius_sums(points, mask, payload, radius):
    """(in-radius counts [N], in-radius payload sums [N, P]) of every
    point, its own row included; masked rows count nothing."""
    n = points.shape[0]
    r2 = f32(radius * radius)
    cnt = torch.empty(n, dtype=torch.int64, device=points.device)
    sums = torch.empty((n, payload.shape[1]), dtype=points.dtype,
                       device=points.device)
    for r0, r1 in row_steps(1, n, n):
        in_r = (sqdist_rows(points[r0:r1], points) <= r2) & mask[None, :] \
            & mask[r0:r1, None]
        cnt[r0:r1] = in_r.sum(1)
        with full_fp32():
            sums[r0:r1] = in_r.to(points.dtype) @ payload
    return cnt, sums


def neighbor_max(points, mask, values, radius, exclude_zero=False):
    """(in-radius counts [N], max of the in-radius neighbours' values [N])
    of every point (its own value included unless exclude_zero)."""
    n = points.shape[0]
    r2 = f32(radius * radius)
    cnt = torch.empty(n, dtype=torch.int64, device=points.device)
    vmax = torch.empty(n, dtype=values.dtype, device=points.device)
    for r0, r1 in row_steps(1, n, n):
        d2 = sqdist_rows(points[r0:r1], points)
        in_r = (d2 <= r2) & mask[None, :] & mask[r0:r1, None]
        if exclude_zero:
            in_r = in_r & (d2 > 0)
        cnt[r0:r1] = in_r.sum(1)
        vmax[r0:r1] = torch.where(in_r, values[None, :], torch.full_like(
            d2, float("-inf"))).amax(1)
    return cnt, vmax


def harris_response(C: torch.Tensor) -> torch.Tensor:
    """det(C) - 0.04 trace(C)^2 of the raw normal sums [N, 3, 3]."""
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    return det3(C) - 0.04 * tr * tr


def harris_refine(C, b, points, radius):
    """The corner positions: x = C^-1 b where |det C| > 1e-9 and x lies
    within the support radius of its point, else the point."""
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    ok = torch.abs(det3(C)) > 1e-9
    a_safe = torch.where(ok[:, None, None], C, eye)
    x = torch.linalg.solve(a_safe, b[..., None])[..., 0]
    near = torch.sum((x - points) ** 2, dim=1) <= f32(radius * radius)
    return torch.where((ok & near)[:, None], x, points)


def harris3d(points: torch.Tensor,   # [N, 3]
             normals: torch.Tensor,  # [N, 3]
             mask: torch.Tensor,     # [N]
             radius: float, threshold: float = 1e-4, nonmax: bool = True,
             refine: bool = True) -> KeypointMask:
    """HARRIS response of the RAW sum of in-radius normal outer products,
    r = det(C) - 0.04 trace(C)^2 (PCL's semantics); non-max suppression
    r >= the in-radius max (the point itself included); refinement solves
    (sum n n^T) x = sum n n^T p."""
    nn = outer9(normals)
    nntp = torch.einsum("jab,jb->ja", nn.reshape(-1, 3, 3), points)
    _, sums = _in_radius_sums(points, mask,
                              torch.cat([nn, nntp], 1), radius)
    C = sums[:, :9].reshape(-1, 3, 3)
    r = harris_response(C)
    keep = mask & (r > threshold)
    if nonmax:
        _, nmax = neighbor_max(points, mask, r, radius)
        keep = keep & (r >= nmax)
    pos = harris_refine(C, sums[:, 9:12], points, radius) if refine \
        else points
    return KeypointMask(keep, pos, r)


def iss_scatter(points: torch.Tensor, wsum: torch.Tensor, S1: torch.Tensor,
                S2: torch.Tensor) -> torch.Tensor:
    """The density-weighted scatter about each point from its moments:
    (S2 - S1 q^T - q S1^T + wsum q q^T) / wsum."""
    cross = S1[:, :, None] * points[:, None, :]
    outer_q = points[:, :, None] * points[:, None, :]
    S = S2 - cross - cross.transpose(1, 2) + wsum[:, None, None] * outer_q
    return S / wsum[:, None, None]


def iss_saliency(S: torch.Tensor, gamma21: float, gamma32: float):
    """(ok [N], e3 [N]) of the scatters: the eigenvalue ratios e2/e1 <
    gamma21 and e3/e2 < gamma32 (descending) and e3 > 0."""
    vals, _ = eigh3x3(S)                                  # ascending
    e1, e2, e3 = vals[:, 2], vals[:, 1], vals[:, 0]
    ok = (e2 / torch.clamp(e1, min=1e-12) < gamma21) \
        & (e3 / torch.clamp(e2, min=1e-12) < gamma32) & (e3 > 0)
    return ok, e3


def iss3d(points: torch.Tensor, mask: torch.Tensor,
          salient_radius: float = 0.1, nonmax_radius: float = 0.05,
          gamma21: float = 0.975, gamma32: float = 0.975,
          min_neighbors: int = 5) -> KeypointMask:
    """ISS saliency (keypoints_iss3d.cpp, PCL ISSKeypoint3D): the scatter
    about each point with weights w_j = 1 / |N(p_j)|, kept where
    e2/e1 < gamma21 and e3/e2 < gamma32; saliency e3, non-max suppression
    in the non-max radius with at least min_neighbors points there."""
    ones = torch.ones((points.shape[0], 1), dtype=points.dtype,
                      device=points.device)
    cnt, _ = _in_radius_sums(points, mask, ones, salient_radius)
    wj = 1.0 / torch.clamp(cnt.to(points.dtype), min=1.0)
    payload = torch.cat([wj[:, None], wj[:, None] * points,
                         wj[:, None] * outer9(points)], 1)
    _, sums = _in_radius_sums(points, mask, payload, salient_radius)
    wsum = torch.clamp(sums[:, 0], min=1e-12)
    S = iss_scatter(points, wsum, sums[:, 1:4],
                    sums[:, 4:13].reshape(-1, 3, 3))
    ok, e3 = iss_saliency(S, gamma21, gamma32)
    ok = ok & mask
    saliency = torch.where(ok, e3, torch.full_like(e3, float("-inf")))
    n_nm, nmax = neighbor_max(points, mask, saliency, nonmax_radius)
    keep = ok & (saliency >= nmax) & (n_nm >= min_neighbors)
    return KeypointMask(keep, points, e3)


def sift_sigmas(min_scale: float, octave: int, scales_per_octave: int):
    base = min_scale * (2.0 ** octave)
    return [base * (2.0 ** (s / scales_per_octave))
            for s in range(scales_per_octave + 1)]


def gaussian_smooth(points, mask, values, sigma):
    """Gaussian-weighted mean of the neighbours' values, truncated at 3
    sigma (the point itself included)."""
    n = points.shape[0]
    out = torch.empty(n, dtype=values.dtype, device=points.device)
    s2 = f32(sigma * sigma)
    cut = f32(9.0 * sigma * sigma)
    for r0, r1 in row_steps(1, n, n):
        d2 = sqdist_rows(points[r0:r1], points)
        K = torch.exp(-0.5 * d2 / s2)
        K = torch.where((d2 <= cut) & mask[None, :] & mask[r0:r1, None], K,
                        torch.zeros_like(K))
        ks = torch.clamp(K.sum(1), min=1e-12)
        with full_fp32():
            out[r0:r1] = (K @ values) / ks
    return out


def sift_extrema(points, mask, layers, radius):
    """(has a neighbour [N], min [N], max [N]) of the neighbours' values
    over every column of layers [N, L] within the radius, the point itself
    excluded -- by its index, and any other point at distance 0 (d2 > 0).
    The JAX program excludes the point by d2 > 0 alone, on the matmul
    identity, which can round a point's distance to itself above 0: the
    point then compares with its own value and is never an extremum."""
    n = points.shape[0]
    r2 = f32(radius * radius)
    any_nb = torch.empty(n, dtype=torch.bool, device=points.device)
    lo = torch.empty(n, dtype=layers.dtype, device=points.device)
    hi = torch.empty(n, dtype=layers.dtype, device=points.device)
    inf = float("inf")
    for r0, r1 in row_steps(layers.shape[1], n, n):
        d2 = sqdist_rows(points[r0:r1], points)
        rows = torch.arange(r0, r1, device=points.device)
        nb = (d2 <= r2) & mask[None, :] & mask[r0:r1, None] & (d2 > 0) \
            & (rows[:, None] != torch.arange(n, device=points.device))
        lv = layers[None, :, :]
        lo[r0:r1] = torch.where(nb[..., None], lv, torch.full_like(
            lv, inf)).amin((1, 2))
        hi[r0:r1] = torch.where(nb[..., None], lv, torch.full_like(
            lv, -inf)).amax((1, 2))
        any_nb[r0:r1] = nb.any(1)
    return any_nb, lo, hi


def sift_keep(dogs, li, any_nb, lo, hi, q_valid, min_contrast):
    """The extremum test of interior DoG layer li: strictly below (above)
    every neighbour's value on the three layers and its own on the two
    around it, with |DoG| >= min_contrast and a neighbour."""
    dog = dogs[li]
    is_min = (dog < lo) & (dog < dogs[li - 1]) & (dog < dogs[li + 1])
    is_max = (dog > hi) & (dog > dogs[li - 1]) & (dog > dogs[li + 1])
    return q_valid & (is_min | is_max) & (torch.abs(dog) >= min_contrast) \
        & any_nb


def sift3d(points: torch.Tensor, intensity: torch.Tensor,
           mask: torch.Tensor, min_scale: float, n_octaves: int = 4,
           scales_per_octave: int = 3, min_contrast: float = 0.0
           ) -> KeypointMask:
    """3D SIFT on a scalar field (pcl::SIFTKeypoint with setScales(radius,
    4, 3), setMinimumContrast(0); the reference feeds the curvature): per
    octave, Gaussian smoothing at geometrically spaced sigmas, differences
    of Gaussians, and the points that are spatial and scale extrema.  As in
    the JAX package every octave runs on the full cloud."""
    keep = torch.zeros_like(mask)
    best = torch.zeros_like(intensity)
    for o in range(n_octaves):
        sigmas = sift_sigmas(min_scale, o, scales_per_octave)
        smoothed = [gaussian_smooth(points, mask, intensity, s)
                    for s in sigmas]
        dogs = [smoothed[i + 1] - smoothed[i] for i in range(len(sigmas) - 1)]
        for li in range(1, len(dogs) - 1):
            any_nb, lo, hi = sift_extrema(
                points, mask, torch.stack(dogs[li - 1:li + 2], 1),
                sigmas[li])
            ext = sift_keep(dogs, li, any_nb, lo, hi, mask, min_contrast)
            keep = keep | ext
            mag = torch.abs(dogs[li])
            best = torch.where(ext & (mag > best), mag, best)
    return KeypointMask(keep, points, best)
