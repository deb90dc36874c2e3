"""Quaternion helpers of the vote-casting tail (port of the
``matrix_to_quat`` / ``quat_multiply`` pair of
point_cloud_donkey_tpu/ops/geometry.py), batched over leading dims."""

from __future__ import annotations

import torch


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
