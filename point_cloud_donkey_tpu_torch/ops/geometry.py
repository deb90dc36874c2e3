"""Quaternion helpers of the vote-casting tail (port of the
``matrix_to_quat`` / ``quat_multiply`` pair of
point_cloud_donkey_tpu/ops/geometry.py), batched over leading dims, and the
numpy forms that codebook training runs on the host
(``matrix_to_quat_batch_np``, ``quat_multiply_np``, ``quat_to_matrix_np``).
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
