"""Serving normals for ConsistentNormalsMethod 2 (port of
``compute_normals_fast`` of point_cloud_donkey_tpu/ops/normals.py)."""

from __future__ import annotations

import torch

from .lrf import shot_lrf


def compute_normals_fast(points: torch.Tensor,  # [N, 3] or [B, N, 3]
                         mask: torch.Tensor,    # [N] or [B, N]
                         radius: float) -> torch.Tensor:
    """Normal = inverted z axis of each point's own SHOT LRF (radius
    NormalRadius).  Points whose LRF is invalid (< 5 in-radius neighbours)
    get +z, not the PCA normal, as in the JAX serving path.  Only z is
    read, so the x sign vote is skipped (z_only)."""
    lrf = shot_lrf(points, mask, points, mask, radius, z_only=True)
    z = -lrf.frames[..., 2, :]
    up = torch.zeros_like(z)
    up[..., 2] = 1.0
    return torch.where(lrf.valid[..., None], z, up)
