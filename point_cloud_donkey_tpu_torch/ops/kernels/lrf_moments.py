"""K1 radius moments and K2 sign votes of the SHOT LRF, their windowed
forms K5 and K6, their v2 forms K10 and K11, and the fused LRFs built on
them.

Port of point_cloud_donkey_tpu/ops/pallas/lrf_moments.py: `_moments_call`
-> :func:`moments`, `_sign_votes_call` -> :func:`sign_votes`,
`_moments_call_gathered` -> :func:`moments_windowed`,
`_sign_votes_call_gathered` -> :func:`sign_votes_windowed`,
`_moments_call_v2` -> :func:`moments_v2`, `_sign_votes_call_v2` ->
:func:`sign_votes_v2`, `_prep_lanes` -> :func:`prep_shift`,
`shot_lrf_pallas` -> :func:`shot_lrf_fused`, `shot_lrf_pallas_windowed` ->
:func:`shot_lrf_windowed`.  The kernels are in csrc/lrf_moments.cu.  The
plain twins below compute the same sums with the same float operations:
K1/K2/K5/K6 on exact coordinate differences, K10/K11 on the matmul
identity d2 = |q|^2 + |p|^2 - 2 q.p, K10's moments as bf16x3 products
(the twin sums them as matrix products, the kernel pair by pair in the
cell-binned sweep's order, so K10 is held to the moment contract, not to
equal bits).  All six are one cell-binned sweep in the kernel, with a
body, a gate and a point range each.

All tensors are batched over clouds: queries [B, Q, 3], points [B, N, 3],
mask [B, N] bool.  Unlike the TPU layout, nothing is parked at 1e9: the
point mask goes to the kernels explicitly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...kernels import build
from ..eigh3 import eigh3x3
from ..neighbors import full_fp32
from . import check, f32, stream_of, uses_kernel

MOMENT_ROWS = 10      # s0, s1 (x, y, z), s2 (xx, yy, zz, xy, xz, yz)
TQW = 256             # queries per window-plan tile (ops/binned.py)
_PAIR_BUDGET = 1 << 25  # elements per [B, chunk, N] temporary of the twins


def _chunk(b: int, n: int) -> int:
    return max(1, _PAIR_BUDGET // max(b * n, 1))


def _check_common(q, p, mask):
    b, n = p.shape[0], p.shape[1]
    check("queries", q, torch.float32, (b, None, 3))
    check("points", p, torch.float32, (b, n, 3))
    check("mask", mask, torch.bool, (b, n))


def moments_plain(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                  radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1: (mom [B, Q, 10] f32, count [B, Q] i32)."""
    b, nq, _ = q.shape
    r = f32(radius)
    r2 = f32(r * r)
    mom = torch.zeros((b, nq, MOMENT_ROWS), dtype=q.dtype, device=q.device)
    cnt = torch.zeros((b, nq), dtype=torch.int32, device=q.device)
    px, py, pz = (p[..., i][:, None, :] for i in range(3))
    m = mask[:, None, :]
    # the moments read masked points as 0, whatever they hold (NaN, inf)
    fx, fy, fz = (torch.where(m, x, torch.zeros_like(x)) for x in (px, py, pz))
    step = _chunk(b, p.shape[1])
    for q0 in range(0, nq, step):
        qc = q[:, q0:q0 + step]
        dx = qc[..., 0:1] - px
        dy = qc[..., 1:2] - py
        dz = qc[..., 2:3] - pz
        d2 = dx * dx + dy * dy + dz * dz
        in_r = (d2 <= r2) & m
        w = torch.where(in_r, r - torch.sqrt(d2), torch.zeros_like(d2))
        wx, wy, wz = w * fx, w * fy, w * fz
        rows = [w, wx, wy, wz, wx * fx, wy * fy, wz * fz,
                wx * fy, wx * fz, wy * fz]
        mom[:, q0:q0 + step] = torch.stack([x.sum(-1) for x in rows], -1)
        cnt[:, q0:q0 + step] = in_r.sum(-1, dtype=torch.int32)
    return mom, cnt


def moments(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
            radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: per query, the (r - d)-weighted moments over the in-radius
    points of its cloud, and the in-radius count.  q [B, Q, 3], p [B, N, 3]
    (centroid-shifted), mask [B, N] -> (mom [B, Q, 10], count [B, Q])."""
    _check_common(q, p, mask)
    if not uses_kernel(q, p, mask):
        return moments_plain(q, p, mask, radius)
    b, nq, _ = q.shape
    mom = torch.empty((b, nq, MOMENT_ROWS), dtype=torch.float32,
                      device=q.device)
    cnt = torch.empty((b, nq), dtype=torch.int32, device=q.device)
    if b and nq:
        with torch.cuda.device(q.device):
            err = build.lib().pcd_lrf_moments(
                q.data_ptr(), p.data_ptr(), mask.data_ptr(), mom.data_ptr(),
                cnt.data_ptr(), b, nq, p.shape[1], f32(radius), stream_of(q))
        build.check(err, "lrf_moments")
        build.count_launch("lrf_moments")
    return mom, cnt


def sign_votes_plain(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                     axes: torch.Tensor, radius: float,
                     z_only: bool = False) -> torch.Tensor:
    """Plain twin of K2: votes [B, Q, 2] i32."""
    b, nq, _ = q.shape
    r = f32(radius)
    r2 = f32(r * r)
    votes = torch.zeros((b, nq, 2), dtype=torch.int32, device=q.device)
    px, py, pz = (p[..., i][:, None, :] for i in range(3))
    m = mask[:, None, :]
    step = _chunk(b, p.shape[1])
    for q0 in range(0, nq, step):
        qc = q[:, q0:q0 + step]
        ac = axes[:, q0:q0 + step]
        dx = px - qc[..., 0:1]
        dy = py - qc[..., 1:2]
        dz = pz - qc[..., 2:3]
        in_r = ((dx * dx + dy * dy + dz * dz) <= r2) & m
        dot_z = dx * ac[..., 3:4] + dy * ac[..., 4:5] + dz * ac[..., 5:6]
        votes[:, q0:q0 + step, 1] = (in_r & (dot_z >= 0)).sum(
            -1, dtype=torch.int32)
        if not z_only:
            dot_x = dx * ac[..., 0:1] + dy * ac[..., 1:2] + dz * ac[..., 2:3]
            votes[:, q0:q0 + step, 0] = (in_r & (dot_x >= 0)).sum(
                -1, dtype=torch.int32)
    return votes


def sign_votes(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
               axes: torch.Tensor, radius: float,
               z_only: bool = False) -> torch.Tensor:
    """K2: per query, the in-radius counts with (p - q) . axis >= 0 for the
    x (axes[..., 0:3]) and z (axes[..., 3:6]) candidates -> [B, Q, 2]
    (x count is 0 when z_only)."""
    _check_common(q, p, mask)
    check("axes", axes, torch.float32, (q.shape[0], q.shape[1], 6))
    if not uses_kernel(q, p, mask, axes):
        return sign_votes_plain(q, p, mask, axes, radius, z_only)
    b, nq, _ = q.shape
    votes = torch.empty((b, nq, 2), dtype=torch.int32, device=q.device)
    if b and nq:
        with torch.cuda.device(q.device):
            err = build.lib().pcd_sign_votes(
                q.data_ptr(), p.data_ptr(), mask.data_ptr(), axes.data_ptr(),
                votes.data_ptr(), b, nq, p.shape[1], f32(radius),
                int(z_only), stream_of(q))
        build.check(err, "sign_votes")
        build.count_launch("sign_votes")
    return votes


WEIGHTINGS = ("shot", "uniform")


def _staged(p, mask):
    """The points as K10 / K11 stage them: (px, py, pz [B, 1, N], |p|^2
    [B, 1, N] with NaN for masked points, so their gates fail)."""
    px, py, pz = (p[..., i][:, None, :] for i in range(3))
    pp = px * px + py * py + pz * pz
    pp = torch.where(mask[:, None, :], pp, torch.full_like(pp, float("nan")))
    return px, py, pz, pp


def _identity_gate(qc, px, py, pz, pp, r2):
    """d2 = (|q|^2 + |p|^2) - 2 q.p and its radius gate [B, c, N], with
    K10 / K11's float operations."""
    qx, qy, qz = qc[..., 0:1], qc[..., 1:2], qc[..., 2:3]
    qq = qx * qx + qy * qy + qz * qz
    d2 = (qq + pp) - 2.0 * (qx * px + qy * py + qz * pz)
    return d2, d2 <= r2


def _bf16_split(x: torch.Tensor):
    """(hi, lo) = (bf16(x), bf16(x - hi)), as float32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def moments_v2_plain(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                     radius: float, weighting: str = "shot"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K10: (mom [B, Q, 10] f32, count [B, Q] i32) -- the
    identity gate, the weights, and the moments as W_hi F_hi + W_hi F_lo +
    W_lo F_hi over bf16 splits, products in fp32."""
    b, nq, _ = q.shape
    r = f32(radius)
    r2 = f32(r * r)
    mom = torch.zeros((b, nq, MOMENT_ROWS), dtype=q.dtype, device=q.device)
    cnt = torch.zeros((b, nq), dtype=torch.int32, device=q.device)
    px, py, pz, pp = _staged(p, mask)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    feats = torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                         x * y, x * z, y * z], -1)             # [B, N, 10]
    feats = torch.where(mask[..., None], feats, torch.zeros_like(feats))
    f_hi, f_lo = _bf16_split(feats)
    step = _chunk(b, p.shape[1])
    with full_fp32():
        for q0 in range(0, nq, step):
            d2, in_r = _identity_gate(q[:, q0:q0 + step], px, py, pz, pp, r2)
            if weighting == "shot":
                w = torch.where(in_r, r - torch.sqrt(torch.clamp(d2, min=0.0)),
                                torch.zeros_like(d2))
            else:
                w = in_r.to(q.dtype)
            w_hi, w_lo = _bf16_split(w)
            mom[:, q0:q0 + step] = (w_hi @ f_hi + w_hi @ f_lo) + w_lo @ f_hi
            cnt[:, q0:q0 + step] = in_r.sum(-1, dtype=torch.int32)
    return mom, cnt


def moments_v2(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
               radius: float, weighting: str = "shot"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: K1's moments and counts with the identity gate, each moment
    the bf16x3 product w_hi F_hi + w_hi F_lo + w_lo F_hi (K1's cell-binned
    sweep with the identity gate).  weighting "shot" (w = r - d) or
    "uniform" (w = 1).  q [B, Q, 3], p [B, N, 3] (centroid-shifted), mask [B, N] ->
    (mom [B, Q, 10], count [B, Q])."""
    _check_common(q, p, mask)
    if weighting not in WEIGHTINGS:
        raise ValueError(f"weighting must be one of {WEIGHTINGS}, "
                         f"got {weighting!r}")
    if not uses_kernel(q, p, mask):
        return moments_v2_plain(q, p, mask, radius, weighting)
    b, nq, _ = q.shape
    mom = torch.empty((b, nq, MOMENT_ROWS), dtype=torch.float32,
                      device=q.device)
    cnt = torch.empty((b, nq), dtype=torch.int32, device=q.device)
    if b and nq:
        with torch.cuda.device(q.device):
            err = build.lib().pcd_lrf_moments_v2(
                q.data_ptr(), p.data_ptr(), mask.data_ptr(), mom.data_ptr(),
                cnt.data_ptr(), b, nq, p.shape[1], f32(radius),
                int(weighting == "shot"), stream_of(q))
        build.check(err, "lrf_moments_v2")
        build.count_launch("lrf_moments_v2")
    return mom, cnt


def sign_votes_v2_plain(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                        axes: torch.Tensor, radius: float) -> torch.Tensor:
    """Plain twin of K11: votes [B, Q, 2] i32."""
    b, nq, _ = q.shape
    r = f32(radius)
    r2 = f32(r * r)
    votes = torch.zeros((b, nq, 2), dtype=torch.int32, device=q.device)
    px, py, pz, pp = _staged(p, mask)
    step = _chunk(b, p.shape[1])
    for q0 in range(0, nq, step):
        qc = q[:, q0:q0 + step]
        ac = axes[:, q0:q0 + step]
        _, in_r = _identity_gate(qc, px, py, pz, pp, r2)
        for col, a0 in ((0, 0), (1, 3)):
            ax, ay, az = ac[..., a0:a0 + 1], ac[..., a0 + 1:a0 + 2], \
                ac[..., a0 + 2:a0 + 3]
            aq = qc[..., 0:1] * ax + qc[..., 1:2] * ay + qc[..., 2:3] * az
            ap = px * ax + py * ay + pz * az
            votes[:, q0:q0 + step, col] = (in_r & (ap - aq >= 0)).sum(
                -1, dtype=torch.int32)
    return votes


def sign_votes_v2(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                  axes: torch.Tensor, radius: float) -> torch.Tensor:
    """K11: K2's votes (no z_only) with the identity gate: per query, the
    in-radius counts with a.p - a.q >= 0 for the x (axes[..., 0:3]) and z
    (axes[..., 3:6]) candidates -> [B, Q, 2] (K2's body on the cell-binned
    sweep under K10's gate; equal to the twin)."""
    _check_common(q, p, mask)
    check("axes", axes, torch.float32, (q.shape[0], q.shape[1], 6))
    if not uses_kernel(q, p, mask, axes):
        return sign_votes_v2_plain(q, p, mask, axes, radius)
    b, nq, _ = q.shape
    votes = torch.empty((b, nq, 2), dtype=torch.int32, device=q.device)
    if b and nq:
        with torch.cuda.device(q.device):
            err = build.lib().pcd_sign_votes_v2(
                q.data_ptr(), p.data_ptr(), mask.data_ptr(), axes.data_ptr(),
                votes.data_ptr(), b, nq, p.shape[1], f32(radius),
                stream_of(q))
        build.check(err, "sign_votes_v2")
        build.count_launch("sign_votes_v2")
    return votes


def _check_windowed(q, p, mask, starts, window):
    _check_common(q, p, mask)
    b, nq, n = q.shape[0], q.shape[1], p.shape[1]
    check("starts", starts, torch.int32, (b, -(-nq // TQW)))
    if not 1 <= window <= n:
        raise ValueError(f"window must be in [1, N={n}], got {window}")


def _windows(p, mask, starts, window):
    """Each plan tile's window of the sorted points: (pw [B, T, W, 3],
    mw [B, T, W]); entries past N are masked, as the kernel's sweep stops
    at N."""
    n = p.shape[1]
    idx = starts.long()[..., None] + torch.arange(window, device=p.device)
    inside = idx < n
    idx = idx.clamp(max=n - 1)
    b, t, w = idx.shape
    flat = idx.reshape(b, t * w)
    pw = torch.gather(p, 1, flat[..., None].expand(b, t * w, 3))
    mw = torch.gather(mask, 1, flat) & inside.reshape(b, t * w)
    return pw.reshape(b, t, w, 3), mw.reshape(b, t, w)


def moments_windowed_plain(q, p, mask, starts, window, radius):
    """Plain twin of K5: K1's twin per plan tile over its window."""
    b, nq, _ = q.shape
    pw, mw = _windows(p, mask, starts, window)
    mom = torch.zeros((b, nq, MOMENT_ROWS), dtype=q.dtype, device=q.device)
    cnt = torch.zeros((b, nq), dtype=torch.int32, device=q.device)
    for t in range(starts.shape[1]):
        sl = slice(t * TQW, (t + 1) * TQW)
        mom[:, sl], cnt[:, sl] = moments_plain(q[:, sl], pw[:, t], mw[:, t],
                                               radius)
    return mom, cnt


def moments_windowed(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                     starts: torch.Tensor, window: int, radius: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: K1 over principal-axis-sorted points, each tile of 256 queries
    sweeping only points [starts[b, t], starts[b, t] + window) of its
    cloud (K1's cell-binned sweep over the union of a CTA's windows; a
    point outside its query's window stays out even within the radius).
    starts [B, ceil(Q / 256)] int32 (ops/binned.window_starts)."""
    _check_windowed(q, p, mask, starts, window)
    if not uses_kernel(q, p, mask, starts):
        return moments_windowed_plain(q, p, mask, starts, window, radius)
    b, nq, _ = q.shape
    mom = torch.empty((b, nq, MOMENT_ROWS), dtype=torch.float32,
                      device=q.device)
    cnt = torch.empty((b, nq), dtype=torch.int32, device=q.device)
    if b and nq:
        with torch.cuda.device(q.device):
            err = build.lib().pcd_lrf_moments_windowed(
                q.data_ptr(), p.data_ptr(), mask.data_ptr(),
                starts.data_ptr(), mom.data_ptr(), cnt.data_ptr(), b, nq,
                p.shape[1], starts.shape[1], window, f32(radius),
                stream_of(q))
        build.check(err, "lrf_moments_windowed")
        build.count_launch("lrf_moments_windowed")
    return mom, cnt


def sign_votes_windowed_plain(q, p, mask, axes, starts, window, radius,
                              z_only=False):
    """Plain twin of K6: K2's twin per plan tile over its window."""
    b, nq, _ = q.shape
    pw, mw = _windows(p, mask, starts, window)
    votes = torch.zeros((b, nq, 2), dtype=torch.int32, device=q.device)
    for t in range(starts.shape[1]):
        sl = slice(t * TQW, (t + 1) * TQW)
        votes[:, sl] = sign_votes_plain(q[:, sl], pw[:, t], mw[:, t],
                                        axes[:, sl], radius, z_only)
    return votes


def sign_votes_windowed(q: torch.Tensor, p: torch.Tensor, mask: torch.Tensor,
                        axes: torch.Tensor, starts: torch.Tensor,
                        window: int, radius: float,
                        z_only: bool = False) -> torch.Tensor:
    """K6: K2 over the windows of :func:`moments_windowed` (K2's body on
    K5's binned sweep of the windows)."""
    _check_windowed(q, p, mask, starts, window)
    check("axes", axes, torch.float32, (q.shape[0], q.shape[1], 6))
    if not uses_kernel(q, p, mask, axes, starts):
        return sign_votes_windowed_plain(q, p, mask, axes, starts, window,
                                         radius, z_only)
    b, nq, _ = q.shape
    votes = torch.empty((b, nq, 2), dtype=torch.int32, device=q.device)
    if b and nq:
        with torch.cuda.device(q.device):
            err = build.lib().pcd_sign_votes_windowed(
                q.data_ptr(), p.data_ptr(), mask.data_ptr(),
                starts.data_ptr(), axes.data_ptr(), votes.data_ptr(), b, nq,
                p.shape[1], starts.shape[1], window, f32(radius),
                int(z_only), stream_of(q))
        build.check(err, "sign_votes_windowed")
        build.count_launch("sign_votes_windowed")
    return votes


def prep_shift(queries: torch.Tensor, points: torch.Tensor,
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift queries and points by each cloud's masked centroid (the
    conditioning step of `_prep_lanes`): (q_s [B, Q, 3], p_s [B, N, 3])."""
    m = mask.to(points.dtype)
    shift = (points * m[..., None]).sum(1) \
        / torch.clamp(m.sum(1), min=1.0)[:, None]
    return ((queries - shift[:, None, :]).contiguous(),
            (points - shift[:, None, :]).contiguous())


def cov_from_moments(mom: torch.Tensor, q_s: torch.Tensor,
                     q_mask: torch.Tensor):
    """(r - d)-weighted covariance about the (shifted) query from K1's
    moments: cov = s2 - c s1^T - s1 c^T + s0 c c^T over s0, with c = 0 for
    masked queries.  Returns (cov [B, Q, 3, 3], s0 [B, Q])."""
    s0 = mom[..., 0]
    s1 = mom[..., 1:4]
    xx, yy, zz, xy, xz, yz = (mom[..., i] for i in range(4, 10))
    s2 = torch.stack([torch.stack([xx, xy, xz], -1),
                      torch.stack([xy, yy, yz], -1),
                      torch.stack([xz, yz, zz], -1)], -2)
    c = torch.where(q_mask[..., None], q_s, torch.zeros_like(q_s))
    cov = (s2 - c[..., :, None] * s1[..., None, :]
           - s1[..., :, None] * c[..., None, :]
           + s0[..., None, None] * c[..., :, None] * c[..., None, :])
    return cov / torch.clamp(s0, min=1e-30)[..., None, None], s0


def _evd_axes(mom, q_s, q_mask, z_only):
    """Covariance from the moments -> closed-form EVD -> (v1 largest, v3
    smallest eigenvector, the [B, Q, 6] sign-vote axes, s0)."""
    cov, s0 = cov_from_moments(mom, q_s, q_mask)
    _, vecs = eigh3x3(cov)
    v1 = vecs[..., :, 2]   # largest eigenvalue -> x axis candidate
    v3 = vecs[..., :, 0]   # smallest -> z axis candidate
    x_cand = torch.zeros_like(v1) if z_only else v1
    return v1, v3, torch.cat([x_cand, v3], -1).contiguous(), s0


def _frames(v1, v3, votes, count, s0, q_mask, min_neighbors, z_only):
    """Sign rule and validity of every fused LRF: flip an axis when fewer
    in-radius offsets point along it than against it (a tie keeps the
    EVD's sign); y = z x x."""
    plus_z = votes[..., 1]
    z_axis = torch.where((plus_z < count - plus_z)[..., None], -v3, v3)
    if z_only:
        x_axis = v1
    else:
        plus_x = votes[..., 0]
        x_axis = torch.where((plus_x < count - plus_x)[..., None], -v1, v1)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    frames = torch.stack([x_axis, y_axis, z_axis], dim=-2)
    valid = q_mask & (count >= min_neighbors) & (s0 > 0)
    return frames, valid


def shot_lrf_fused(queries: torch.Tensor, q_mask: torch.Tensor,
                   points: torch.Tensor, mask: torch.Tensor, radius: float,
                   min_neighbors: int = 5, z_only: bool = False,
                   lrf_version: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SHOT LRF via K1 -> closed-form EVD -> K2.  Returns (frames
    [B, Q, 3, 3] rows = x, y, z axes, valid [B, Q]).  Sign rule: flip an
    axis when fewer in-radius offsets point along it than against it; a
    tie keeps the closed-form EVD's sign.  z_only skips the x vote (x/y
    rows then keep the EVD's sign; only for callers that read z).
    lrf_version >= 2 selects the v2 kernels as `_moments_dispatch` /
    `_sign_votes_dispatch` do: K10 for the moments, K11 for the votes
    unless z_only (then K2)."""
    v2 = lrf_version >= 2
    q_s, p_s = prep_shift(queries, points, mask)
    mom, count = (moments_v2 if v2 else moments)(q_s, p_s, mask, radius)
    v1, v3, axes, s0 = _evd_axes(mom, q_s, q_mask, z_only)
    if v2 and not z_only:
        votes = sign_votes_v2(q_s, p_s, mask, axes, radius)
    else:
        votes = sign_votes(q_s, p_s, mask, axes, radius, z_only)
    return _frames(v1, v3, votes, count, s0, q_mask, min_neighbors, z_only)


def shot_lrf_windowed(points: torch.Tensor,   # [B, N, 3] sorted by key
                      mask: torch.Tensor,     # [B, N]
                      starts: torch.Tensor,   # [B, ceil(N / 256)] int32
                      window: int, radius: float,
                      min_neighbors: int = 5, z_only: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-LRF of every point of a principal-axis-sorted batch via K5 ->
    closed-form EVD -> K6, each 256-point tile sweeping its planned window
    (`shot_lrf_pallas_windowed`).  Same shift, sign rule and validity as
    :func:`shot_lrf_fused`, to which it is equal when the plan is exact."""
    q_s, p_s = prep_shift(points, points, mask)
    mom, count = moments_windowed(q_s, p_s, mask, starts, window, radius)
    v1, v3, axes, s0 = _evd_axes(mom, q_s, mask, z_only)
    votes = sign_votes_windowed(q_s, p_s, mask, axes, starts, window, radius,
                                z_only)
    return _frames(v1, v3, votes, count, s0, mask, min_neighbors, z_only)
