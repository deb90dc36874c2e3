"""Closed-form batched symmetric 3x3 eigendecomposition.

Port of point_cloud_donkey_tpu/ops/eigh3.py with the same arithmetic: the
trigonometric eigenvalues and the row-cross eigenvectors (Eberly-style),
including the degenerate fallbacks.  The eigenvector signs this closed form
picks feed the LRF sign-vote tie rule (ops/lrf.py), so it is kept instead
of torch.linalg.eigh, whose signs differ.

Returns eigenvalues ascending and eigenvectors as matrix columns.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def eigvals3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric [..., 3, 3] matrices."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    # near-spherical matrices (p ~ 0): all eigenvalues equal q
    spherical = p < 1e-12
    p_safe = torch.where(spherical, torch.ones_like(p), p)

    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * p_safe * p_safe * p_safe), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e2 = q + 2.0 * p * torch.cos(phi)
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    e0 = torch.where(spherical, q, e0)
    e1 = torch.where(spherical, q, e1)
    e2 = torch.where(spherical, q, e2)
    return torch.stack([e0, e1, e2], dim=-1)


def _eigvec_for(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric [..., 3, 3] a for eigenvalue lam [...]: the
    largest-norm cross product of rows of (a - lam I)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None], c01,
        torch.where((n02 >= n12)[..., None], c02, c12))
    nrm = torch.linalg.norm(best, dim=-1, keepdim=True)
    # degenerate (repeated eigenvalue / zero matrix): fall back to e_x
    fallback = torch.zeros_like(best)
    fallback[..., 0] = 1.0
    return torch.where(nrm > 1e-20, best / torch.clamp(nrm, min=1e-30),
                       fallback)


def eigh3x3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 3x3 EVD.  a: [..., 3, 3] -> (eigvals asc [..., 3],
    eigvecs [..., 3, 3] with COLUMNS as eigenvectors)."""
    scale = torch.amax(torch.abs(a), dim=(-2, -1))
    s_safe = torch.clamp(scale, min=1e-30)
    an = a / s_safe[..., None, None]

    vals = eigvals3x3(an)
    v2 = _eigvec_for(an, vals[..., 2])  # largest
    v0 = _eigvec_for(an, vals[..., 0])  # smallest
    # orthogonalize v0 against v2 (robust under near-degeneracy)
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    n0 = torch.linalg.norm(v0, dim=-1, keepdim=True)
    # if v0 collapsed (triple/double degenerate), pick any vector orth. to v2
    ex = torch.zeros_like(v2)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v2)
    ey[..., 1] = 1.0
    alt = torch.linalg.cross(v2, ex)
    alt_n = torch.linalg.norm(alt, dim=-1, keepdim=True)
    alt2 = torch.linalg.cross(v2, ey)
    alt = torch.where(
        alt_n > 1e-6, alt / torch.clamp(alt_n, min=1e-30),
        alt2 / torch.clamp(torch.linalg.norm(alt2, dim=-1, keepdim=True),
                           min=1e-30))
    v0 = torch.where(n0 > 1e-6, v0 / torch.clamp(n0, min=1e-30), alt)
    v1 = torch.linalg.cross(v2, v0)

    vecs = torch.stack([v0, v1, v2], dim=-1)  # columns
    vals = vals * s_safe[..., None]
    return vals, vecs
