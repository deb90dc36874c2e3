"""COSPAIR-378 (port of point_cloud_donkey_tpu/ops/cospair.py; Logoglu et
al., third_party/cospair as wrapped at features/features_cospair.cpp),
batched over clouds: [B, K] keypoints over [B, K, M] neighbour gathers.

7 concentric shells (r_l = l / 7 x R); per shell three 9-bin histograms of
pcl::computePairFeatures' angles between the keypoint and each shell
neighbour (ops/fpfh.pair_features_pcl) and three 9-bin histograms of the
neighbour's CIELab colour (ops/color.py, with COSPAIR's normalisation
constants); each shell divided by its pair count and scaled by its
index.
"""

from __future__ import annotations

import torch

from .color import rgb_to_cielab_normalized
from .descriptors_misc import slot_histogram
from .fpfh import pair_features_pcl
from .neighbors import NeighborBlock, gather_rows
from .shot import ShotResult

COSPAIR_LEVELS = 7
COSPAIR_BINS = 9
COSPAIR_RGB_BINS = 9
COSPAIR_LEVEL_LEN = 3 * COSPAIR_BINS + 3 * COSPAIR_RGB_BINS  # 54
COSPAIR_LEN = COSPAIR_LEVELS * COSPAIR_LEVEL_LEN             # 378


def cospair_descriptor(keypoints: torch.Tensor,   # [B, K, 3]
                       kp_normals: torch.Tensor,  # [B, K, 3]
                       kp_mask: torch.Tensor,     # [B, K]
                       points: torch.Tensor,      # [B, N, 3]
                       normals: torch.Tensor,     # [B, N, 3]
                       rgb: torch.Tensor,         # [B, N, 3] in [0, 1]
                       nbr: NeighborBlock,        # [B, K, M]
                       radius: float,
                       min_neighbors: int = 5) -> ShotResult:
    """COSPAIR of every keypoint (the JAX ``cospair_descriptor``, whose
    keypoint colour is unused with rgb_type 5)."""
    dt = points.dtype
    b, k, _ = keypoints.shape
    use = nbr.valid & torch.isfinite(nbr.dist) & (nbr.dist > 1e-15)
    d = torch.where(use, nbr.dist, torch.full_like(nbr.dist, radius * 2.0))
    q = gather_rows(points, nbr.idx)
    nq = gather_rows(normals, nbr.idx)
    f1, f2, f3, _, degen = pair_features_pcl(
        keypoints[..., None, :], kp_normals[..., None, :], q, nq)
    use = use & ~degen
    i32 = torch.int32
    deg1 = torch.rad2deg(f1) + 180.0
    deg2 = torch.rad2deg(torch.arccos(torch.clamp(f2, -1.0, 1.0)))
    deg3 = torch.rad2deg(torch.arccos(torch.clamp(f3, -1.0, 1.0)))
    nb = COSPAIR_BINS
    b1 = torch.clamp((deg1 / (360.0 / nb)).to(i32), 0, nb - 1)
    b2 = torch.clamp((deg2 / (180.0 / nb)).to(i32), 0, nb - 1)
    b3 = torch.clamp((deg3 / (180.0 / nb)).to(i32), 0, nb - 1)

    # the neighbour's CIELab, un-normalised then COSPAIR-normalised
    # (cospair.cpp:162-176)
    lab = gather_rows(rgb_to_cielab_normalized(rgb), nbr.idx)
    ln = lab[..., 0] * 100.0 / 100.0
    an = (lab[..., 1] * 120.0 + 86.185) / 184.439
    bn = (lab[..., 2] * 120.0 + 107.863) / 202.345
    nc = COSPAIR_RGB_BINS
    br = torch.clamp((ln * nc).to(i32), 0, nc - 1)
    bg = torch.clamp((an * nc).to(i32), 0, nc - 1)
    bb = torch.clamp((bn * nc).to(i32), 0, nc - 1)

    level = torch.clamp(torch.ceil(d / radius * COSPAIR_LEVELS).to(i32), 1,
                        COSPAIR_LEVELS) - 1
    base = level * COSPAIR_LEVEL_LEN
    idx = torch.stack([base + b1, base + nb + b2, base + 2 * nb + b3,
                       base + 3 * nb + br, base + 3 * nb + nc + bg,
                       base + 3 * nb + 2 * nc + bb], -1)
    w = use[..., None].to(dt).expand(idx.shape)
    idx = torch.where(use[..., None], idx, torch.zeros_like(idx))
    hist = slot_histogram(idx, w, COSPAIR_LEN, 2)

    # per shell: divided by its pair count, scaled by its index
    # (cospair.cpp:269-283)
    counts = slot_histogram(level, use.to(dt), COSPAIR_LEVELS, 2)  # [B, K, 7]
    ids = torch.arange(1, COSPAIR_LEVELS + 1, dtype=dt,
                       device=points.device)
    scale = torch.where(counts > 0, ids / torch.clamp(counts, min=1.0),
                        torch.zeros_like(counts))
    hist = (hist.reshape(b, k, COSPAIR_LEVELS, COSPAIR_LEVEL_LEN)
            * scale[..., None]).reshape(b, k, COSPAIR_LEN)
    valid = kp_mask & (use.sum(-1) >= min_neighbors)
    return ShotResult(hist, valid)
