"""Mean-shift maxima search in the 3D voting space (port of seeds, shift and
density of point_cloud_donkey_tpu/ops/mean_shift.py), batched over G
independent groups -- one per (cloud, class) in the detection step.

Reference semantics (voting/voting_mean_shift.cpp), as in the JAX module:
  * seeds: grid binning with cell size (2 * bandwidth) / sqrt(2); a bin key
    is floor(pos / size + 0.5), the seed sits at key * size and every
    occupied bin seeds; bins past `capacity` (in key order) are dropped;
  * shift: x <- sum_j g(u_j) w_j x_j / sum_j g(u_j) w_j over the votes
    within the bandwidth (u = d^2 / b^2, Gaussian g = 0.5 exp(-u / 2)) until
    a seed moves <= threshold or max_iter iterations; a seed whose window
    is empty dies;
  * density: sum_j exp(-u_j / 2) w_j over the votes within the bandwidth.
Distances use the matmul identity in full fp32, as the JAX module's
``pairwise_sqdist`` at HIGHEST precision.

The JAX ``while_loop`` tests ``any(active & alive)`` before every
iteration; in eager PyTorch each test is a host sync.  A seed that is
inactive or dead never changes again, so iterations past convergence are
no-ops and testing only every CHECK_EVERY iterations gives the same result.
The host-side voting that follows mean-shift in the reference
(``density_and_reweight``, ``average_neighbor_maxima``,
``suppress_neighbor_maxima``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .kernels import f32
from .neighbors import full_fp32

# Iterations between convergence tests.  A test costs one host sync, which
# drains the queue of ~15 small kernels per iteration; overshooting costs
# at most CHECK_EVERY - 1 no-op iterations.  8 bounds both: at most 13
# syncs for max_iter = 100, and at most 7 wasted iterations.
CHECK_EVERY = 8

_INT_MAX = 2 ** 31 - 1


def seeds_range(bandwidth: float) -> float:
    """Cube edge fitting into the bandwidth sphere, in float32."""
    return f32(f32(f32(bandwidth) * 2.0) / f32(math.sqrt(2.0)))


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[G, M, 3] x [G, V, 3] -> [G, M, V] squared distances via
    a^2 + b^2 - 2 a.b in full fp32, clamped at 0."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    with full_fp32():
        cross = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def create_seeds(votes: torch.Tensor,    # [G, V, 3]
                 weights: torch.Tensor,  # [G, V]
                 valid: torch.Tensor,    # [G, V]
                 bin_size: float,
                 capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid-binning seeds of every group: (positions [G, S, 3], weights
    [G, S] = the sum of the bin's vote weights, mask [G, S]), S = capacity,
    bins in lexicographic (z, y, x) key order as jnp.lexsort gives them."""
    g, v, _ = votes.shape
    bs = torch.tensor(f32(bin_size), dtype=votes.dtype, device=votes.device)
    key = torch.floor(votes / bs + 0.5)
    key = torch.where(valid[..., None], key,
                      torch.full_like(key, float(_INT_MAX))).to(torch.int64)

    # lexicographic order, primary z: stable sorts, least significant first
    order = torch.arange(v, device=votes.device).expand(g, v)
    for axis in (0, 1, 2):
        _, perm = torch.sort(torch.gather(key[..., axis], 1, order), dim=1,
                             stable=True)
        order = torch.gather(order, 1, perm)
    skey = torch.gather(key, 1, order[..., None].expand(g, v, 3))
    svalid = torch.gather(valid, 1, order)
    sweights = torch.gather(weights, 1, order)

    is_new = torch.ones((g, v), dtype=torch.bool, device=votes.device)
    is_new[:, 1:] = torch.any(skey[:, 1:] != skey[:, :-1], dim=2)
    is_new &= svalid
    seg = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    # invalid votes and bins past capacity go to the dump segment; the
    # segments are contiguous runs of the sorted votes
    seg = torch.where(svalid & (seg < capacity), seg,
                      torch.full_like(seg, capacity))
    lengths = torch.zeros((g, capacity + 1), dtype=torch.int64,
                          device=votes.device)
    lengths.scatter_add_(1, seg, torch.ones_like(seg))
    # a fixed-order sum over each run (no atomics: deterministic)
    wsum = torch.segment_reduce(
        torch.where(svalid, sweights, torch.zeros_like(sweights)), "sum",
        lengths=lengths, axis=1)[:, :capacity]
    count = lengths[:, :capacity]
    first = (torch.cumsum(lengths, 1) - lengths)[:, :capacity].clamp(
        max=max(v - 1, 0))
    seed_pos = torch.gather(skey, 1, first[..., None].expand(g, capacity, 3)
                            ).to(votes.dtype) * bs
    seed_mask = count >= 1
    seed_pos = torch.where(seed_mask[..., None], seed_pos,
                           torch.zeros_like(seed_pos))
    return seed_pos, torch.where(seed_mask, wsum, torch.zeros_like(wsum)), \
        seed_mask


def mean_shift(seeds: torch.Tensor,      # [G, S, 3]
               seed_mask: torch.Tensor,  # [G, S]
               votes: torch.Tensor,      # [G, V, 3]
               weights: torch.Tensor,    # [G, V]
               valid: torch.Tensor,      # [G, V]
               bandwidth: float,
               threshold: float = 1e-3,
               max_iter: int = 1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian mean-shift of every seed to convergence.  Returns (centres
    [G, S, 3], alive [G, S]); a seed dies when its window is ever empty."""
    b2 = f32(f32(bandwidth) * f32(bandwidth))
    pos, alive, active = seeds, seed_mask.clone(), seed_mask.clone()
    it = 0
    while it < max_iter:
        for _ in range(min(CHECK_EVERY, max_iter - it)):
            d2 = pairwise_sqdist(pos, votes)
            in_r = (d2 <= b2) & valid[:, None, :]
            g = torch.where(in_r, 0.5 * torch.exp(-0.5 * (d2 / b2))
                            * weights[:, None, :], torch.zeros_like(d2))
            denom = g.sum(-1)
            with full_fp32():
                num = torch.bmm(g, votes)
            ok = denom != 0
            has_nbr = in_r.any(-1)
            new = torch.where((ok & has_nbr)[..., None],
                              num / torch.where(ok, denom,
                                                torch.ones_like(denom))[..., None],
                              pos)
            alive = alive & (has_nbr | ~active)
            step = active & alive
            moved = torch.where(step, torch.linalg.norm(new - pos, dim=-1),
                                torch.zeros_like(denom))
            pos = torch.where(step[..., None], new, pos)
            active = active & (moved > threshold) & alive
            it += 1
        if not bool((active & alive).any()):
            break
    return pos, alive & seed_mask


def estimate_density(positions: torch.Tensor,  # [G, M, 3]
                     votes: torch.Tensor,      # [G, V, 3]
                     weights: torch.Tensor,    # [G, V]
                     valid: torch.Tensor,      # [G, V]
                     bandwidth: float) -> torch.Tensor:
    """Gaussian vote density [G, M] at each position."""
    b2 = f32(f32(bandwidth) * f32(bandwidth))
    d2 = pairwise_sqdist(positions, votes)
    in_r = (d2 <= b2) & valid[:, None, :]
    k = torch.exp(-0.5 * (d2 / b2))
    return torch.where(in_r, k * weights[:, None, :],
                       torch.zeros_like(d2)).sum(-1)
