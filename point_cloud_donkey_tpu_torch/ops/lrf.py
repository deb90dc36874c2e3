"""SHOT local reference frames (port of point_cloud_donkey_tpu/ops/lrf.py,
SHOT type).

Algorithm (Tombari et al. ECCV 2010; PCL SHOTLocalReferenceFrameEstimation):
(R - d)-weighted covariance about the query over in-radius neighbours,
closed-form EVD (ops/eigh3.py), x = largest and z = smallest eigenvector,
each sign set by the majority of neighbour offsets (a tie keeps the EVD's
sign), y = z x x.  Frames with fewer than 5 in-radius neighbours are
invalid.  The moments and sign votes run through K1 and K2
(ops/kernels/lrf_moments.py), on exact coordinate differences, or with
``lrf_version`` 2 through K10 and K11 (K2 when z_only), on the matmul
identity -- the JAX package's PCD_PALLAS_LRF_V; the entry points read that
variable once with :func:`lrf_version_from_env` and pass it down.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .kernels.lrf_moments import shot_lrf_fused


class LRFResult(NamedTuple):
    frames: torch.Tensor  # [..., Q, 3, 3] rows = x_axis, y_axis, z_axis
    valid: torch.Tensor   # [..., Q] bool


def shot_lrf(queries: torch.Tensor,   # [Q, 3] or [B, Q, 3]
             q_mask: torch.Tensor,    # [Q] or [B, Q]
             points: torch.Tensor,    # [N, 3] or [B, N, 3]
             mask: torch.Tensor,      # [N] or [B, N]
             radius: float,
             min_neighbors: int = 5,
             z_only: bool = False,
             lrf_version: int = 1) -> LRFResult:
    """SHOT LRFs at the queries, one cloud or a batch of clouds.  z_only
    skips the x-axis sign vote (valid only when the caller reads just z);
    lrf_version >= 2 runs the v2 kernels (K10, K11)."""
    single = points.dim() == 2
    if single:
        queries, q_mask = queries[None], q_mask[None]
        points, mask = points[None], mask[None]
    frames, valid = shot_lrf_fused(queries.contiguous(), q_mask,
                                   points.contiguous(), mask.contiguous(),
                                   radius, min_neighbors, z_only,
                                   lrf_version)
    if single:
        frames, valid = frames[0], valid[0]
    return LRFResult(frames=frames, valid=valid)


def lrf_version_from_env() -> int:
    """The LRF kernel version PCD_PALLAS_LRF_V selects (1 unless set), read
    where an entry point starts, as the JAX package's `_kernel_version`
    reads it: the same command runs the same kernels in both packages."""
    return int(os.environ.get("PCD_PALLAS_LRF_V", "1"))
