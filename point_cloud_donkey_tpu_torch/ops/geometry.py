"""Quaternion helpers of the vote-casting tail (port of the
``matrix_to_quat`` / ``quat_multiply`` pair of
point_cloud_donkey_tpu/ops/geometry.py), batched over leading dims, the
numpy forms that codebook training runs on the host
(``matrix_to_quat_batch_np``, ``quat_multiply_np``, ``quat_to_matrix_np``),
``quat_rotate`` / ``quat_rotate_inv`` and the training boxes' MVBB
(``compute_mvbb``, batched: :func:`compute_mvbb_batch`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BoundingBox(NamedTuple):
    """An oriented box of a training model (numpy, float32)."""
    position: np.ndarray   # [3] centre
    size: np.ndarray       # [3] edge lengths
    quat: np.ndarray       # [4] (w, x, y, z) orientation


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, broadcast [..., 4]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def matrix_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions (w, x, y, z)
    [..., 4]: the Shepperd-case selection of the reference (largest of the
    four candidate diagonals, first one on ties), then normalised."""
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    qw = torch.stack([1.0 + t,
                      1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], dim=-1)
    case = torch.argmax(qw, dim=-1)
    s = torch.sqrt(torch.clamp(
        torch.gather(qw, -1, case[..., None])[..., 0], min=1e-12)) * 2.0
    cands = torch.stack([
        torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                     (m10 - m01) / s], dim=-1),
        torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                     (m02 + m20) / s], dim=-1),
        torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                     (m12 + m21) / s], dim=-1),
        torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                     0.25 * s], dim=-1),
    ], dim=-2)                                               # [..., 4, 4]
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-30)


def matrix_to_quat_batch_np(rot: np.ndarray) -> np.ndarray:
    """Rotation matrices [F, 3, 3] -> unit quaternions [F, 4] in float32
    numpy, with matrix_to_quat's case selection (the JAX package's
    host-side form, whose bits training records)."""
    m = np.asarray(rot, np.float32)
    t = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    qw = np.stack([
        1.0 + t,
        1.0 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
        1.0 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
        1.0 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2],
    ], axis=1).astype(np.float32)
    case = np.argmax(qw, axis=1)
    s = (np.sqrt(np.maximum(qw[np.arange(len(m)), case], np.float32(1e-12)))
         * np.float32(2.0))
    cands = np.empty((len(m), 4, 4), np.float32)
    cands[:, 0, 0] = 0.25 * s
    cands[:, 0, 1] = (m[:, 2, 1] - m[:, 1, 2]) / s
    cands[:, 0, 2] = (m[:, 0, 2] - m[:, 2, 0]) / s
    cands[:, 0, 3] = (m[:, 1, 0] - m[:, 0, 1]) / s
    cands[:, 1, 0] = (m[:, 2, 1] - m[:, 1, 2]) / s
    cands[:, 1, 1] = 0.25 * s
    cands[:, 1, 2] = (m[:, 0, 1] + m[:, 1, 0]) / s
    cands[:, 1, 3] = (m[:, 0, 2] + m[:, 2, 0]) / s
    cands[:, 2, 0] = (m[:, 0, 2] - m[:, 2, 0]) / s
    cands[:, 2, 1] = (m[:, 0, 1] + m[:, 1, 0]) / s
    cands[:, 2, 2] = 0.25 * s
    cands[:, 2, 3] = (m[:, 1, 2] + m[:, 2, 1]) / s
    cands[:, 3, 0] = (m[:, 1, 0] - m[:, 0, 1]) / s
    cands[:, 3, 1] = (m[:, 0, 2] + m[:, 2, 0]) / s
    cands[:, 3, 2] = (m[:, 1, 2] + m[:, 2, 1]) / s
    cands[:, 3, 3] = 0.25 * s
    q = cands[np.arange(len(m)), case]
    n = np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                   np.float32(1e-30)).astype(np.float32)
    return (q / n).astype(np.float32)


def quat_multiply_np(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product in numpy, broadcast [..., 4]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) [4] -> rotation matrix [3, 3] in
    float32 numpy (Utils::quat2Matrix, utils.cpp:396-434)."""
    q = np.asarray(q, np.float32)
    q = q / np.maximum(np.linalg.norm(q), np.float32(1e-30))
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by the quaternion q [..., 4] (q v q*,
    Utils::quatRotate, utils.cpp:568-574)."""
    w, qv = q[..., 0], q[..., 1:]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w[..., None] * t + torch.linalg.cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q* v q (Utils::quatRotateInv, utils.cpp:560-566)."""
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)
    return quat_rotate(conj, v)


MVBB_ANGLES = 32
# clouds a caller hands compute_mvbb_batch at once: its sweep holds
# [B, 3 * MVBB_ANGLES, N] coordinates
MVBB_CHUNK = 16


def _eigh_host(cov: np.ndarray) -> np.ndarray:
    """Eigenvectors (columns, ascending eigenvalues) of symmetric 3x3
    matrices [B, 3, 3], float32, through LAPACK's ssyevd on the host (the
    lower triangle of the symmetrised matrix): the routine and library
    (scipy's) that the JAX package's CPU ``jnp.linalg.eigh`` calls, so
    each eigenvector comes with JAX's sign.
    The sign fixes the box's quaternion; torch's own LAPACK build picks
    the other sign for ~15% of seeded matrices."""
    from scipy.linalg import lapack
    cov = np.asarray(cov, np.float32)
    sym = ((cov + np.swapaxes(cov, 1, 2)) / np.float32(2)).astype(np.float32)
    out = []
    for m in sym:
        _, vecs, info = lapack.ssyevd(m, compute_v=1, lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"ssyevd failed (info {info})")
        out.append(vecs)
    return np.stack(out).astype(np.float32)


def _candidate_rotations(base: np.ndarray, n_angles: int) -> np.ndarray:
    """[B, 3 * n_angles, 3, 3] candidate frames (rows = axes): for each
    principal axis k of `base` [B, 3, 3], the other two axes turned about it
    by n_angles angles in [0, pi/2), in the JAX ``compute_mvbb``'s order and
    float32 arithmetic."""
    angles = (np.arange(n_angles, dtype=np.float32)
              * np.float32(np.pi / 2 / n_angles)).astype(np.float32)
    cos, sin = np.cos(angles), np.sin(angles)
    out = []
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        ai, aj, ak = base[:, None, i], base[:, None, j], base[:, None, k]
        rows = [None, None, None]
        rows[k] = np.broadcast_to(ak, (base.shape[0], n_angles, 3))
        rows[i] = cos[None, :, None] * ai + sin[None, :, None] * aj
        rows[j] = -sin[None, :, None] * ai + cos[None, :, None] * aj
        out.append(np.stack(rows, axis=2))
    return np.concatenate(out, axis=1).astype(np.float32)


def _extents(points: torch.Tensor, mask: torch.Tensor, rot: torch.Tensor):
    """(min, max) [B, R, 3] of the masked points [B, N, 3] in each frame of
    rot [B, R, 3, 3], one axis at a time."""
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    m = mask[:, None, :]
    lo, hi = [], []
    for a in range(3):
        r = rot[:, :, a, :]                                    # [B, R, 3]
        c = (points[:, None, :, 0] * r[..., 0:1]
             + points[:, None, :, 1] * r[..., 1:2]
             + points[:, None, :, 2] * r[..., 2:3])            # [B, R, N]
        lo.append(torch.where(m, c, inf).amin(-1))
        hi.append(torch.where(m, c, -inf).amax(-1))
    return torch.stack(lo, -1), torch.stack(hi, -1)


def compute_mvbb_batch(points: torch.Tensor,   # [B, N, 3]
                       mask: torch.Tensor):    # [B, N]
    """Approximate minimum-volume boxes (the JAX ``compute_mvbb``, batched):
    the PCA frame of each cloud (eigenvectors from ``_eigh_host``), then
    3 x MVBB_ANGLES in-plane rotations about its axes, the smallest-volume
    candidate kept (the first of equal volumes) -- one masked min / max
    sweep over every candidate of every cloud on the device (callers pass
    at most MVBB_CHUNK clouds).  Returns (position [B, 3],
    the centre rotated back to the world by ``quat_rotate_inv``; size
    [B, 3]; quat [B, 4], rotating world -> box)."""
    m = mask.to(points.dtype)
    c = (points * m[..., None]).sum(1) \
        / torch.clamp(m.sum(1), min=1.0)[:, None]
    centered = points - c[:, None, :]
    cm = centered * m[..., None]
    cov = torch.einsum("bni,bnj->bij", cm, centered) \
        / torch.clamp(m.sum(1), min=1.0)[:, None, None]
    base = np.swapaxes(_eigh_host(cov.cpu().numpy()), 1, 2)
    cands = torch.from_numpy(_candidate_rotations(base, MVBB_ANGLES)).to(
        points.device)
    lo, hi = _extents(centered, mask, cands)
    ext = hi - lo
    vol = ext[..., 0] * ext[..., 1] * ext[..., 2]               # [B, R]
    best = cands[torch.arange(vol.shape[0], device=vol.device),
                 torch.argmin(vol, dim=1)]                      # [B, 3, 3]
    lo, hi = _extents(points, mask, best[:, None])
    size = (hi - lo)[:, 0]
    quat = matrix_to_quat(best)
    return quat_rotate_inv(quat, lo[:, 0] + size / 2.0), size, quat
