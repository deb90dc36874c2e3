"""Mean-shift maxima search in the 3D voting space (port of
point_cloud_donkey_tpu/ops/mean_shift.py), batched over G independent
groups -- one per (cloud, class) of detection -- each with its own
bandwidth.

Reference semantics (voting/voting_mean_shift.cpp, maxima_handler.cpp), as
in the JAX module:
  * seeds: grid binning with cell size (2 * bandwidth) / sqrt(2); a bin key
    is floor(pos / size + 0.5), the seed sits at key * size and every
    occupied bin seeds; bins past `capacity` (in key order) are dropped;
  * shift: x <- sum_j g(u_j) w_j x_j / sum_j g(u_j) w_j over the votes
    within the bandwidth (u = d^2 / b^2; Gaussian g = 0.5 exp(-u / 2),
    Uniform g = -1) until a seed moves <= threshold or max_iter
    iterations; a seed whose window is empty dies;
  * density: sum_j k(u_j) w_j over the votes within the bandwidth
    (Gaussian k = exp(-u / 2), Uniform k = 1);
  * maxima post-processing: density-weighted averaging of neighbouring
    maxima, then greedy non-maximum suppression within the bandwidth;
  * the final densities reweight the votes sequentially: each maximum, in
    order, multiplies the weights of the votes in its window by the
    kernel, so a later maximum sees the updated weights.
Distances use the matmul identity in fp32, as the JAX module's
``pairwise_sqdist`` at HIGHEST precision.

With ``batch_invariant`` a group's results do not depend on the other
groups of its batch, so ImplicitShapeModel.detect() equals its row of
detect_batch(): every operation is elementwise, a sort, an exact integer
sum, a segment sum (one order a segment), or a sum over the contiguous
last dimension of >= 16 rows, which torch reduces in an order set by the
row's length alone (on the card: 32 x 16 threads a block, split across
blocks only past ~2^19 columns).  The dot products a.b and the mean's
numerator are then such row sums: cuBLAS picks a batched matmul's
algorithm (and its split of the reduction) by the batch count, so a
group's bits there follow its batch.  Without it (IsmDetector's step,
one batch shape) they are batched matmuls, ~1.5x faster on the H100
(PERF.md section 6).

Seeds, shift, density and the sequential reweighting run on the device
over [G, S, V] tensors.  The averaging and the suppression are greedy
scans in index and density order over at most `capacity` centres whose
every step depends on the last: they run on the host in numpy
(:func:`average_neighbor_maxima`, :func:`suppress_neighbor_maxima`) over
one read of the [G, S] centres and densities, where a step costs a few
microseconds instead of a launch and a sync.

The JAX ``while_loop`` tests ``any(active & alive)`` before every
iteration; in eager PyTorch each test is a host sync.  A seed that is
inactive or dead never changes again, so iterations past convergence are
no-ops and testing only every CHECK_EVERY iterations gives the same result.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from .kernels import f32
from .neighbors import full_fp32

# Iterations between convergence tests.  A test costs one host sync, which
# drains the queue of ~15 small kernels per iteration; overshooting costs
# at most CHECK_EVERY - 1 no-op iterations.  8 bounds both: at most 13
# syncs for max_iter = 100, and at most 7 wasted iterations.
CHECK_EVERY = 8

_INT_MAX = 2 ** 31 - 1


Bandwidth = Union[float, torch.Tensor]   # one value, or one a group [G]


def seeds_range(bandwidth: Bandwidth) -> Bandwidth:
    """Cube edge fitting into the bandwidth sphere, in float32."""
    if isinstance(bandwidth, torch.Tensor):
        return (bandwidth * 2.0) / f32(math.sqrt(2.0))
    return f32(f32(f32(bandwidth) * 2.0) / f32(math.sqrt(2.0)))


def _per_group(value: Bandwidth, ref: torch.Tensor) -> torch.Tensor:
    """`value` as a float32 [G, 1, 1] tensor on `ref`'s device (G =
    ref.shape[0])."""
    if not isinstance(value, torch.Tensor):
        value = torch.full((ref.shape[0],), f32(value))
    return value.to(device=ref.device, dtype=torch.float32).reshape(-1, 1, 1)


def _kernel(u: torch.Tensor, kernel: str) -> torch.Tensor:
    if kernel == "Gaussian":
        return torch.exp(-0.5 * u)
    return torch.ones_like(u)   # Uniform


def _kernel_derivative_neg_(u: torch.Tensor, kernel: str) -> torch.Tensor:
    """-kernelDerivative(u), in place: Gaussian 0.5 exp(-u / 2), Uniform -1
    (the sign cancels in the normalised mean,
    voting_mean_shift.cpp:409-417)."""
    if kernel == "Gaussian":
        return u.mul_(-0.5).exp_().mul_(0.5)
    return u.fill_(-1.0)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor,
                    batch_invariant: bool = False) -> torch.Tensor:
    """[G, M, 3] x [G, V, 3] -> [G, M, V] squared distances via
    (a^2 + b^2) - 2 a.b in full fp32, clamped at 0; a.b a batched matmul,
    or with batch_invariant summed x, y, z in that order, elementwise."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    if batch_invariant:
        cross = a[..., 0, None] * b[..., None, :, 0]
        for k in (1, 2):   # each product rounded, then added (no fused add)
            cross.add_(a[..., k, None] * b[..., None, :, k])
    else:
        with full_fp32():
            cross = torch.bmm(a, b.transpose(1, 2))
    d2 = (a2[..., :, None] + b2[..., None, :]).sub_(cross, alpha=2.0)
    return d2.clamp_(min=0.0)


def _weighted_sum(g: torch.Tensor, votes: torch.Tensor,
                  batch_invariant: bool) -> torch.Tensor:
    """sum_v g[..., v] votes[..., v, :]: [G, M, V] x [G, V, 3] -> [G, M, 3];
    a batched matmul, or with batch_invariant one row sum a coordinate."""
    if not batch_invariant:
        with full_fp32():
            return torch.bmm(g, votes)
    tmp = torch.empty_like(g)
    return torch.stack([torch.mul(g, votes[:, None, :, k], out=tmp).sum(-1)
                        for k in range(3)], -1)


def create_seeds(votes: torch.Tensor,    # [G, V, 3]
                 weights: torch.Tensor,  # [G, V]
                 valid: torch.Tensor,    # [G, V]
                 bin_size: Bandwidth,
                 capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid-binning seeds of every group: (positions [G, S, 3], weights
    [G, S] = the sum of the bin's vote weights, mask [G, S]), S = capacity,
    bins in lexicographic (z, y, x) key order as jnp.lexsort gives them."""
    g, v, _ = votes.shape
    bs = _per_group(bin_size, votes)
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
               bandwidth: Bandwidth,
               threshold: float = 1e-3,
               max_iter: int = 1000,
               kernel: str = "Gaussian",
               batch_invariant: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-shift of every seed to convergence.  Returns (centres [G, S, 3],
    alive [G, S]); a seed dies when its window is ever empty.
    batch_invariant: module docstring."""
    bw = _per_group(bandwidth, votes)
    b2 = bw * bw
    invalid = ~valid[:, None, :]
    pos, alive, active = seeds, seed_mask.clone(), seed_mask.clone()
    it = 0
    while it < max_iter:
        for _ in range(min(CHECK_EVERY, max_iter - it)):
            d2 = pairwise_sqdist(pos, votes, batch_invariant)
            out = (d2 <= b2).logical_not_().logical_or_(invalid)
            g = _kernel_derivative_neg_(d2.div_(b2), kernel)
            g.mul_(weights[:, None, :]).masked_fill_(out, 0.0)
            has_nbr = ~out.all(-1)
            denom = g.sum(-1)
            num = _weighted_sum(g, votes, batch_invariant)
            ok = denom != 0
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
                     bandwidth: Bandwidth,
                     kernel: str = "Gaussian",
                     batch_invariant: bool = False) -> torch.Tensor:
    """Vote density [G, M] at each position (batch_invariant: module
    docstring)."""
    bw = _per_group(bandwidth, votes)
    b2 = bw * bw
    d2 = pairwise_sqdist(positions, votes, batch_invariant)
    in_r = (d2 <= b2) & valid[:, None, :]
    k = _kernel(d2 / b2, kernel)
    return torch.where(in_r, k * weights[:, None, :],
                       torch.zeros_like(d2)).sum(-1)


def density_and_reweight(positions: torch.Tensor,  # [G, M, 3] in order
                         pos_mask: torch.Tensor,   # [G, M]
                         votes: torch.Tensor,      # [G, V, 3]
                         weights: torch.Tensor,    # [G, V]
                         valid: torch.Tensor,      # [G, V]
                         bandwidth: Bandwidth,
                         kernel: str = "Gaussian"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential estimateDensityAndReweightVotes over the maxima of every
    group (voting_mean_shift.cpp:158-176, 289-328): maximum m multiplies
    the weights of the votes in its window by the kernel, and its density
    is the sum of the updated weights there.  Returns (densities [G, M],
    final vote weights [G, V], membership [G, M, V]); one step of M on
    the device per maximum."""
    bw = _per_group(bandwidth, votes)[:, :, 0]       # [G, 1]
    b2 = bw * bw
    w = weights
    dens, members = [], []
    for m in range(positions.shape[1]):
        d2 = ((votes - positions[:, m, None, :]) ** 2).sum(-1)
        in_r = (d2 <= b2) & valid & pos_mask[:, m, None]
        w = torch.where(in_r, _kernel(d2 / b2, kernel) * w, w)
        dens.append(torch.where(in_r, w, torch.zeros_like(w)).sum(-1))
        members.append(in_r)
    g, v = weights.shape
    if not dens:
        return (weights.new_zeros((g, 0)), w,
                torch.zeros((g, 0, v), dtype=torch.bool, device=w.device))
    return torch.stack(dens, 1), w, torch.stack(members, 1)


def _close(centers: np.ndarray, radius: float) -> np.ndarray:
    """[S, S] centre pairs closer than `radius`: the square root of the
    matmul-identity squared distance in float32, as the JAX module."""
    c = centers.astype(np.float32)
    c2 = np.sum(c * c, axis=1, dtype=np.float32)
    d2 = np.maximum(c2[:, None] + c2[None, :]
                    - np.float32(2.0) * (c @ c.T), np.float32(0.0))
    return np.sqrt(d2) < np.float32(radius)


def average_neighbor_maxima(centers: np.ndarray,    # [S, 3]
                            mask: np.ndarray,       # [S]
                            densities: np.ndarray,  # [S]
                            radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy density-weighted averaging of neighbouring maxima
    (maxima_handler.cpp:94-157), on the host: in index order, each centre
    not yet absorbed absorbs the later unabsorbed centres within `radius`
    and becomes the density-weighted mean of its group.  Returns (centres
    [S, 3], owner mask [S]); the centres of non-owners are 0."""
    s = centers.shape[0]
    close = _close(centers, radius) & mask[None, :] & mask[:, None]
    owner = np.arange(s)
    later = np.arange(s)
    for k in np.nonzero(mask)[0]:
        free = owner == later
        if not free[k]:
            continue
        owner = np.where(close[k] & (later > k) & free, k, owner)
    is_owner = (owner == later) & mask
    dens = np.where(mask, densities, 0).astype(np.float32)
    wsum = np.zeros(s, np.float32)
    psum = np.zeros((s, 3), np.float32)
    np.add.at(wsum, owner[mask], dens[mask])
    np.add.at(psum, owner[mask],
              (centers * densities[:, None]).astype(np.float32)[mask])
    avg = psum / np.maximum(wsum, np.float32(1e-30))[:, None]
    return np.where(is_owner[:, None], avg, 0).astype(np.float32), is_owner


def suppress_neighbor_maxima(centers: np.ndarray,    # [S, 3]
                             mask: np.ndarray,       # [S]
                             densities: np.ndarray,  # [S]
                             radius: float) -> np.ndarray:
    """Greedy density-ordered non-maximum suppression within `radius`
    (maxima_handler.cpp:51-92), on the host: the densest remaining centre
    is kept and suppresses every centre within the radius (itself
    included).  Returns the keep mask [S]."""
    close = _close(centers, radius)
    work = np.where(mask, densities, -np.inf).astype(np.float32)
    keep = np.zeros(centers.shape[0], bool)
    while np.any(np.isfinite(work)):
        idx = int(np.argmax(work))
        keep[idx] = True
        work[close[idx]] = -np.inf
        work[idx] = -np.inf
    return keep & mask
