"""Scene-scale tiling: query chunks against windows of a sorted cloud
(port of point_cloud_donkey_tpu/ops/tiled.py, the stages of the scene
features, the scene filters and the scene culling).

A dense [Q, N] formulation does not fit a 1e5-1e6-point RGB-D scene
(implicit_shape_model.cpp:739-821), so:

  1. the cloud is sorted along its longest axis on the host, once;
  2. the (equally sorted) queries are cut into chunks of `chunk`;
  3. each chunk sees only the contiguous window of sorted points whose key
     can lie within the radius of the chunk's keys: the host plan
     (:func:`plan_tiles`, the JAX plan: a bucketed window, `min_window`,
     starts clamped into the cloud) gives each chunk its window start and
     one window length for all;
  4. the chunks' queries [C, chunk] and their window slabs [C, W]
     (:func:`chunk_queries`, :func:`window_slabs`) go through the batched
     dense functions of the port as a batch of C clouds -- the K1 / K2,
     K7, K8 and K9 kernels where those functions launch them -- in groups
     of chunks whose slabs stay under SLAB_BYTES a tensor.

Exactness: the window of each chunk covers every point within the radius
of its queries (a neighbour within the radius differs by at most the
radius along the sort axis), and :func:`plan_tiles` asserts it.  So tiled
results equal the dense ones up to the order of float sums.  The JAX
chunks (NORMALS_CHUNK, KEYPOINT_CHUNK) and the port's kernel tiles (256
queries, ``ops/kernels/lrf_moments.TQW``) differ; with exact plans on both
sides only the summation order differs: a slab shifts its points by the
slab's centroid before the moments, as the JAX slab does.

The constants below are read at call time (``tiled.SCENE_TILE_THRESHOLD``),
so one monkeypatch moves every route of the port.  The detector stages
(payload moments, neighbour max, Gaussian smoothing, SIFT extrema) serve
Harris3D / ISS3D / SIFT3D at scene scale (models/keypoints.py), the
gather the gathered-neighbour descriptors of a slab.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .curvature import CurvatureResult, principal_curvatures
from .color import color_distance
from .eigh3 import eigh3x3
from .kernels import masked_centroid
from .neighbors import (NeighborBlock, RadiusMoments, full_fp32,
                        gather_radius_neighbors, radius_covariance,
                        row_steps)
from .neighbors import pairwise_sqdist as sqdist
from .normals import NormalsResult, compute_normals_at

# clouds above this size take the tiled scene path (features, filters,
# culling)
SCENE_TILE_THRESHOLD = 32768

# queries per chunk: the normals (a cloud's own points) and the keypoints
NORMALS_CHUNK = 2048
KEYPOINT_CHUNK = 256

# the largest [chunks, window, ...] slab tensor a stage builds at once
SLAB_BYTES = 256 << 20


class TilePlan(NamedTuple):
    """Host-computed window plan for one (queries, points) pairing."""
    starts: np.ndarray   # [C] int64 window start per query chunk
    window: int          # window length (bucketed)
    chunk: int           # queries per chunk
    n_chunks: int


def sort_key_axis(xyz: np.ndarray) -> int:
    """The axis of the longest extent: windows along it are tightest."""
    if len(xyz) == 0:
        return 0
    ext = xyz.max(axis=0) - xyz.min(axis=0)
    return int(np.argmax(ext))


def plan_tiles(q_key: np.ndarray,    # [Q] queries' sort-axis keys, ascending
               q_valid: np.ndarray,  # [Q] bool (padding False)
               p_key: np.ndarray,    # [N] points' sort-axis keys, ascending
               radius: float, chunk: int,
               min_window: int = 1024) -> TilePlan:
    """Per-chunk window starts and one window length (the JAX plan): the
    widest candidate range over the chunks, at least `min_window`, rounded
    up to a power of two times `min_window` and capped at N; starts
    clamped so every window lies inside the cloud.  Raises if a window
    misses a candidate (it cannot, by construction)."""
    q = len(q_key)
    n = len(p_key)
    n_chunks = max(1, -(-q // chunk))
    pad = n_chunks * chunk - q
    if pad:
        q_key = np.concatenate([q_key, np.full(pad, np.inf, q_key.dtype)])
        q_valid = np.concatenate([q_valid, np.zeros(pad, bool)])
    keys = q_key.reshape(n_chunks, chunk)
    valid = q_valid.reshape(n_chunks, chunk)
    # chunk extents over valid queries only (empty chunks: 0..0)
    kmin = np.where(valid, keys, np.inf).min(axis=1)
    kmax = np.where(valid, keys, -np.inf).max(axis=1)
    kmin = np.where(np.isfinite(kmin), kmin, 0.0)
    kmax = np.where(np.isfinite(kmax), kmax, 0.0)
    lo = np.searchsorted(p_key, kmin - radius, side="left")
    hi = np.searchsorted(p_key, kmax + radius, side="right")
    need = int(np.max(hi - lo)) if n_chunks else 0
    window = max(min_window, need)
    w = min_window
    while w < window:
        w *= 2
    window = min(w, n)
    starts = np.clip(lo, 0, max(n - window, 0)).astype(np.int64)
    if not np.all((starts <= lo) & (starts + window >= hi)):
        raise AssertionError("tile plan is not exact")
    return TilePlan(starts=starts, window=window, chunk=chunk,
                    n_chunks=n_chunks)


def chunk_queries(x: torch.Tensor, plan: TilePlan, fill: float = 0.0
                  ) -> torch.Tensor:
    """Queries [Q, ...] padded with `fill` to n_chunks * chunk rows and
    cut into [n_chunks, chunk, ...]."""
    rows = plan.n_chunks * plan.chunk
    if x.shape[0] < rows:
        pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    return x[:rows].reshape((plan.n_chunks, plan.chunk) + tuple(x.shape[1:]))


def window_slabs(x: torch.Tensor, plan: TilePlan,
                 chunks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each chunk's window of the sorted points [N, ...] ->
    [n_chunks (or len(chunks)), window, ...]."""
    starts = torch.as_tensor(plan.starts, device=x.device)
    if chunks is not None:
        starts = starts[chunks]
    idx = starts[:, None] + torch.arange(plan.window, device=x.device)
    return x[idx]


def slab_groups(n_chunks: int, window: int, row_bytes: int = 12
                ) -> List[Tuple[int, int]]:
    """Chunk ranges [c0, c1) whose [c1 - c0, window] slab of `row_bytes`
    a point stays under SLAB_BYTES (at least one chunk each)."""
    step = max(1, SLAB_BYTES // max(window * row_bytes, 1))
    return [(c0, min(n_chunks, c0 + step))
            for c0 in range(0, n_chunks, step)]


def _live_chunks(q_valid: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Indices of the chunks with at least one valid query."""
    qv = chunk_queries(q_valid, plan, fill=False)
    return torch.nonzero(qv.any(1)).flatten()


def map_chunks(inner, q_arrays: Sequence[torch.Tensor],
               q_fills: Sequence[float], p_arrays: Sequence[torch.Tensor],
               plan: TilePlan, q_valid: Optional[torch.Tensor] = None,
               row_bytes: int = 12):
    """Run `inner(q_chunks, p_slabs)` -- the query arrays as [G, chunk,
    ...] and the point arrays as [G, window, ...] -- over groups of chunks
    (slab_groups), skipping chunks without a valid query when `q_valid` is
    given, and return its outputs (a tuple of [G, chunk, ...] tensors)
    re-assembled as [Q, ...] (zeros where a chunk was skipped)."""
    dev = p_arrays[0].device
    q_ch = [chunk_queries(a, plan, f) for a, f in zip(q_arrays, q_fills)]
    live = _live_chunks(q_valid, plan) if q_valid is not None else \
        torch.arange(plan.n_chunks, device=dev)
    outs = None
    for g0, g1 in slab_groups(len(live), plan.window, row_bytes):
        sel = live[g0:g1]
        res = inner([a[sel] for a in q_ch],
                    [window_slabs(a, plan, sel) for a in p_arrays])
        if outs is None:
            outs = [torch.zeros((plan.n_chunks,) + tuple(r.shape[1:]),
                               dtype=r.dtype, device=r.device) for r in res]
        for o, r in zip(outs, res):
            o[sel] = r
    if outs is None:   # no live chunk: run one empty group for the shapes
        res = inner([a[:0] for a in q_ch],
                    [window_slabs(a, plan, live[:0]) for a in p_arrays])
        outs = [torch.zeros((plan.n_chunks,) + tuple(r.shape[1:]),
                            dtype=r.dtype, device=r.device) for r in res]
    q = q_arrays[0].shape[0]
    return tuple(o.reshape((-1,) + tuple(o.shape[2:]))[:q] for o in outs)


def check_lrf_version(lrf_version: int) -> None:
    """The scene path takes lrf_version 1 (K1 / K2, exact differences):
    raise for 2, whose moment identity (K10 / K11) loses the covariance of
    a 5 mm neighbourhood up to 2 m from its slab's centroid (PERF.md: the
    Kinect frame's readings)."""
    if lrf_version >= 2:
        raise NotImplementedError(
            "lrf_version 2 (PCD_PALLAS_LRF_V=2) on a cloud above "
            f"SCENE_TILE_THRESHOLD ({SCENE_TILE_THRESHOLD}) points: the "
            "scene path runs the exact-difference LRF kernels (K1 / K2) "
            "only")


# ---------------------------------------------------------------------------
# normals and moments
# ---------------------------------------------------------------------------

def tiled_compute_normals(points: torch.Tensor,  # [N, 3] sorted, padded
                          mask: torch.Tensor,    # [N]
                          plan: TilePlan, radius: float, method: int,
                          lrf_version: int = 1) -> NormalsResult:
    """Normals of every point of a sorted padded cloud under
    ConsistentNormalsMethod `method` (0, 1, 2; others: the PCA normal as it
    comes), the queries the points themselves; method 1 orients away from
    the whole cloud's centroid.  Results in the sorted order."""
    centroid = masked_centroid(points[None], mask[None])      # [1, 3]

    def inner(qs, ps):
        q, qm = qs
        p, pm = ps
        res = compute_normals_at(q, qm, p, pm, radius, method, lrf_version,
                                 centroid=centroid.expand(q.shape[0], 3))
        return (res.normals, res.curvature, res.eigenvalues, res.valid)

    out = map_chunks(inner, (points, mask), (1e9, False), (points, mask),
                     plan, q_valid=mask)
    return NormalsResult(*out)


def tiled_radius_moments(queries: torch.Tensor,  # [Q, 3] sorted
                         points: torch.Tensor,   # [N, 3] sorted
                         mask: torch.Tensor,     # [N]
                         plan: TilePlan, radius: float,
                         weighting: str = "uniform",
                         center: str = "mean") -> RadiusMoments:
    """Windowed ops.neighbors.radius_covariance (queries and points sorted
    along one axis, the plan built for this pairing)."""
    def inner(qs, ps):
        (q,) = qs
        p, pm = ps
        return tuple(radius_covariance(q, p, pm, radius, weighting, center))

    return RadiusMoments(*map_chunks(inner, (queries,), (1e9,),
                                     (points, mask), plan))


# ---------------------------------------------------------------------------
# preprocessing filters (ops/preprocess.py at scene scale)
# ---------------------------------------------------------------------------

def tiled_statistical_outlier_removal(points: torch.Tensor,  # [N, 3]
                                      mask: torch.Tensor,    # [N]
                                      plan: TilePlan, mean_k: int,
                                      stddev_mul: float) -> torch.Tensor:
    """Two-phase SOR: each point's mean distance to its mean_k nearest
    neighbours within its chunk's window (the JAX approximation: kNN
    within a slab of at least 4096 points), then the global mean / std
    threshold (PCL StatisticalOutlierRemoval)."""
    mean_d = tiled_knn_mean_distances(points, mask, plan, mean_k)
    return mask & (mean_d <= sor_threshold(mean_d, mask, stddev_mul))


def tiled_knn_mean_distances(points: torch.Tensor, mask: torch.Tensor,
                             plan: TilePlan, mean_k: int) -> torch.Tensor:
    """[N] each point's mean distance to its mean_k nearest neighbours
    within its chunk's window: SOR's statistic."""
    k = min(mean_k + 1, plan.window)

    def inner(qs, ps):
        (q,) = qs
        p, pm = ps
        out = torch.empty(q.shape[:2], dtype=q.dtype, device=q.device)
        for r0, r1 in row_steps(q.shape[0], q.shape[1], p.shape[1]):
            d2 = sqdist(q[:, r0:r1], p)
            d2 = torch.where(pm[:, None, :], d2,
                             torch.full_like(d2, float("inf")))
            near = torch.topk(d2, k, dim=-1, largest=False,
                              sorted=True).values
            d = torch.sqrt(torch.clamp(near[..., 1:], min=0.0))
            finite = torch.isfinite(d)
            out[:, r0:r1] = torch.where(finite, d, torch.zeros_like(d)
                                        ).sum(-1) \
                / torch.clamp(finite.sum(-1), min=1).to(q.dtype)
        return (out,)

    return map_chunks(inner, (points,), (1e9,), (points, mask), plan)[0]


def sor_threshold(mean_d: torch.Tensor, mask: torch.Tensor,
                  stddev_mul: float) -> torch.Tensor:
    """SOR's global threshold over the unmasked points' statistics: their
    mean plus stddev_mul standard deviations."""
    m = mask.to(mean_d.dtype)
    cnt = torch.clamp(m.sum(), min=1.0)
    zero = torch.zeros_like(mean_d)
    g_mean = torch.where(mask, mean_d, zero).sum() / cnt
    g_var = torch.where(mask, (mean_d - g_mean) ** 2, zero).sum() / cnt
    return g_mean + stddev_mul * torch.sqrt(g_var)


def _in_radius_counts(q, p, pm, radius):
    r2 = float(np.float32(radius * radius))
    cnt = torch.empty(q.shape[:2], dtype=torch.int64, device=q.device)
    for r0, r1 in row_steps(q.shape[0], q.shape[1], p.shape[1]):
        d2 = sqdist(q[:, r0:r1], p)
        cnt[:, r0:r1] = ((d2 <= r2) & pm[:, None, :]).sum(-1)
    return cnt


def tiled_radius_outlier_removal(points: torch.Tensor, mask: torch.Tensor,
                                 plan: TilePlan, radius: float,
                                 min_neighbors: int) -> torch.Tensor:
    """The filtered mask: points with at least min_neighbors other unmasked
    points within the radius."""
    def inner(qs, ps):
        (q,) = qs
        p, pm = ps
        return (_in_radius_counts(q, p, pm, radius) - 1,)

    (count,) = map_chunks(inner, (points,), (1e9,), (points, mask), plan)
    return mask & (count >= min_neighbors)


def tiled_mls_smooth(points: torch.Tensor, mask: torch.Tensor,
                     plan: TilePlan, radius: float) -> torch.Tensor:
    """Order-1 MLS projection (ops/preprocess.mls_smooth), tiled."""
    mom = tiled_radius_moments(points, points, mask, plan, radius,
                               weighting="uniform", center="mean")
    _, vecs = eigh3x3(mom.cov)
    normal = vecs[..., 0]
    delta = points - mom.mean
    proj = points - torch.sum(delta * normal, dim=1, keepdim=True) * normal
    ok = mom.count >= 3
    return torch.where((mask & ok)[:, None], proj, points)


# ---------------------------------------------------------------------------
# keypoint culling (models/keypoints.py at scene scale)
# ---------------------------------------------------------------------------

def tiled_principal_curvatures(queries: torch.Tensor,        # [Q, 3]
                               query_normals: torch.Tensor,  # [Q, 3]
                               points: torch.Tensor,         # [N, 3]
                               normals: torch.Tensor,        # [N, 3]
                               mask: torch.Tensor,           # [N]
                               plan: TilePlan, radius: float
                               ) -> CurvatureResult:
    """Windowed ops.curvature.principal_curvatures."""
    def inner(qs, ps):
        q, qn = qs
        p, nr, pm = ps
        return tuple(principal_curvatures(q, qn, p, nr, pm, radius))

    return CurvatureResult(*map_chunks(
        inner, (queries, query_normals), (1e9, 0.0), (points, normals, mask),
        plan, row_bytes=24))


def tiled_kpq_aggregate(queries: torch.Tensor, points: torch.Tensor,
                        k1: torch.Tensor, k2: torch.Tensor,
                        mask: torch.Tensor, plan: TilePlan, radius: float):
    """Per-query KPQ support statistics over the points' principal
    curvatures: (count, sum K, max K, min K, max k1, min k2) -- the
    reference's computeKPQ accumulators (culling.cpp:441-471); the formula
    with its FLT_MIN clamps runs on the host over the keypoints."""
    r2 = float(np.float32(radius * radius))

    def inner(qs, ps):
        (q,) = qs
        p, w1, w2, pm = ps
        kk = w1 * w2
        g, nq = q.shape[:2]
        outs = [torch.empty((g, nq), dtype=dt, device=q.device)
                for dt in (torch.int64,) + (q.dtype,) * 5]
        inf = float("inf")
        for r0, r1 in row_steps(g, nq, p.shape[1]):
            in_r = (sqdist(q[:, r0:r1], p) <= r2) & pm[:, None, :]
            kkb, k1b, k2b = (x[:, None, :].expand(in_r.shape)
                             for x in (kk, w1, w2))
            vals = (in_r.sum(-1),
                    torch.where(in_r, kkb, torch.zeros_like(kkb)).sum(-1),
                    torch.where(in_r, kkb, torch.full_like(kkb, -inf)
                                ).amax(-1),
                    torch.where(in_r, kkb, torch.full_like(kkb, inf)
                                ).amin(-1),
                    torch.where(in_r, k1b, torch.full_like(k1b, -inf)
                                ).amax(-1),
                    torch.where(in_r, k2b, torch.full_like(k2b, inf)
                                ).amin(-1))
            for o, v in zip(outs, vals):
                o[:, r0:r1] = v
        return tuple(outs)

    return map_chunks(inner, (queries,), (1e9,), (points, k1, k2, mask),
                      plan, row_bytes=20)


def tiled_color_counts(queries: torch.Tensor, query_lab: torch.Tensor,
                       points: torch.Tensor, points_lab: torch.Tensor,
                       mask: torch.Tensor, plan: TilePlan, radius: float,
                       max_dist: float):
    """Per-query (in-radius count, count of in-radius points whose CIELab
    distance to the query's colour exceeds max_dist) for the colour
    culling score (culling.cpp:474-506)."""
    r2 = float(np.float32(radius * radius))

    def inner(qs, ps):
        q, ql = qs
        p, pl, pm = ps
        g, nq = q.shape[:2]
        in_cnt = torch.empty((g, nq), dtype=torch.int64, device=q.device)
        distant = torch.empty((g, nq), dtype=torch.int64, device=q.device)
        for r0, r1 in row_steps(g, nq, p.shape[1]):
            in_r = (sqdist(q[:, r0:r1], p) <= r2) & pm[:, None, :]
            dist = color_distance(ql[:, r0:r1, None, :], pl[:, None, :, :])
            in_cnt[:, r0:r1] = in_r.sum(-1)
            distant[:, r0:r1] = ((dist > max_dist) & in_r).sum(-1)
        return in_cnt, distant

    return map_chunks(inner, (queries, query_lab), (1e9, 0.0),
                      (points, points_lab, mask), plan, row_bytes=28)


# ---------------------------------------------------------------------------
# keypoint detectors and gathered neighbours (models/keypoints.py and the
# gathered descriptors at scene scale)
# ---------------------------------------------------------------------------

def tiled_gather_radius_neighbors(queries: torch.Tensor,  # [Q, 3] sorted
                                  points: torch.Tensor,   # [N, 3] sorted
                                  mask: torch.Tensor,     # [N]
                                  plan: TilePlan, radius: float,
                                  capacity: int,
                                  exclude_zero_dist: bool = False
                                  ) -> NeighborBlock:
    """Windowed ops.neighbors.gather_radius_neighbors, the capacity
    min(capacity, window) as in a slab; indices into the sorted cloud."""
    starts = torch.as_tensor(plan.starts, device=points.device)
    chunk_of = torch.arange(plan.n_chunks, device=points.device)

    def inner(qs, ps):
        q, ci = qs
        p, pm = ps
        nb = gather_radius_neighbors(q, p, pm, radius, capacity,
                                     exclude_zero_dist)
        # window-local indices back to the sorted cloud's
        base = starts[ci[:, 0]][:, None, None]
        return (torch.where(nb.valid, nb.idx + base, nb.idx), nb.dist,
                nb.valid)

    ci = chunk_of.repeat_interleave(plan.chunk)
    return NeighborBlock(*map_chunks(
        inner, (queries, ci), (1e9, 0), (points, mask), plan))


def tiled_payload_moments(queries: torch.Tensor, points: torch.Tensor,
                          payload: torch.Tensor,  # [N, P]
                          mask: torch.Tensor, plan: TilePlan, radius: float):
    """Per query (in-radius count [Q], sum of the in-radius points'
    payload rows [Q, P]): the accumulation behind the tiled Harris3D and
    ISS3D responses."""
    r2 = float(np.float32(radius * radius))

    def inner(qs, ps):
        (q,) = qs
        p, pl, pm = ps
        g, nq = q.shape[:2]
        cnt = torch.empty((g, nq), dtype=torch.int64, device=q.device)
        sums = torch.empty((g, nq, pl.shape[-1]), dtype=q.dtype,
                           device=q.device)
        for r0, r1 in row_steps(g, nq, p.shape[1]):
            in_r = (sqdist(q[:, r0:r1], p) <= r2) & pm[:, None, :]
            cnt[:, r0:r1] = in_r.sum(-1)
            with full_fp32():
                sums[:, r0:r1] = in_r.to(q.dtype) @ pl
        return cnt, sums

    return map_chunks(inner, (queries,), (1e9,), (points, payload, mask),
                      plan, row_bytes=13 + 4 * payload.shape[1])


def tiled_neighbor_max(queries: torch.Tensor, points: torch.Tensor,
                       values: torch.Tensor,  # [N]
                       mask: torch.Tensor, plan: TilePlan, radius: float,
                       exclude_zero_dist: bool = False):
    """Per query (in-radius count [Q], max in-radius value [Q]): the
    non-max suppression of the tiled detectors."""
    r2 = float(np.float32(radius * radius))

    def inner(qs, ps):
        (q,) = qs
        p, v, pm = ps
        g, nq = q.shape[:2]
        cnt = torch.empty((g, nq), dtype=torch.int64, device=q.device)
        vmax = torch.empty((g, nq), dtype=v.dtype, device=q.device)
        for r0, r1 in row_steps(g, nq, p.shape[1]):
            d2 = sqdist(q[:, r0:r1], p)
            in_r = (d2 <= r2) & pm[:, None, :]
            if exclude_zero_dist:
                in_r = in_r & (d2 > 0)
            cnt[:, r0:r1] = in_r.sum(-1)
            vb = v[:, None, :].expand(in_r.shape)
            vmax[:, r0:r1] = torch.where(in_r, vb, torch.full_like(
                vb, float("-inf"))).amax(-1)
        return cnt, vmax

    return map_chunks(inner, (queries,), (1e9,), (points, values, mask),
                      plan, row_bytes=17)


def tiled_gaussian_smooth(queries: torch.Tensor, points: torch.Tensor,
                          values: torch.Tensor,  # [N]
                          mask: torch.Tensor, plan: TilePlan,
                          sigma: float) -> torch.Tensor:
    """Gaussian-weighted mean of the neighbours' values truncated at 3
    sigma (SIFT3D's smoothing; the query's own value takes part when the
    queries are the points)."""
    s2 = float(np.float32(sigma * sigma))
    cut = float(np.float32(9.0 * sigma * sigma))

    def inner(qs, ps):
        (q,) = qs
        p, v, pm = ps
        g, nq = q.shape[:2]
        out = torch.empty((g, nq), dtype=v.dtype, device=q.device)
        for r0, r1 in row_steps(g, nq, p.shape[1]):
            d2 = sqdist(q[:, r0:r1], p)
            K = torch.exp(-0.5 * d2 / s2)
            K = torch.where((d2 <= cut) & pm[:, None, :], K,
                            torch.zeros_like(K))
            ks = torch.clamp(K.sum(-1), min=1e-12)
            with full_fp32():
                out[:, r0:r1] = (K @ v[..., None])[..., 0] / ks
        return (out,)

    return map_chunks(inner, (queries,), (1e9,), (points, values, mask),
                      plan, row_bytes=17)[0]


def tiled_sift_extrema(queries: torch.Tensor, points: torch.Tensor,
                       layers: torch.Tensor,  # [N, L]
                       mask: torch.Tensor, plan: TilePlan, radius: float):
    """Per query (has a neighbour, min, max) of the neighbours' values over
    every column of `layers` within the radius, the query itself excluded
    -- queries are the sorted points, query i point i, excluded by index
    (ops/keypoint_detectors.sift_extrema) -- and any point at distance 0:
    SIFT3D's scale-space extremum test."""
    r2 = float(np.float32(radius * radius))
    inf = float("inf")
    dev = points.device
    q_index = torch.arange(queries.shape[0], device=dev)
    p_index = torch.arange(points.shape[0], device=dev)

    def inner(qs, ps):
        q, qi = qs
        p, lv, pm, pi = ps
        g, nq = q.shape[:2]
        any_nb = torch.empty((g, nq), dtype=torch.bool, device=q.device)
        lo = torch.empty((g, nq), dtype=lv.dtype, device=q.device)
        hi = torch.empty((g, nq), dtype=lv.dtype, device=q.device)
        ell = lv.shape[-1]
        for r0, r1 in row_steps(g * ell, nq, p.shape[1]):
            d2 = sqdist(q[:, r0:r1], p)
            nb = (d2 <= r2) & pm[:, None, :] & (d2 > 0) \
                & (qi[:, r0:r1, None] != pi[:, None, :])
            lb = lv[:, None, :, :].expand(nb.shape + (ell,))
            lo[:, r0:r1] = torch.where(nb[..., None], lb, torch.full_like(
                lb, inf)).amin((-2, -1))
            hi[:, r0:r1] = torch.where(nb[..., None], lb, torch.full_like(
                lb, -inf)).amax((-2, -1))
            any_nb[:, r0:r1] = nb.any(-1)
        return any_nb, lo, hi

    return map_chunks(inner, (queries, q_index), (1e9, -1),
                      (points, layers, mask, p_index), plan,
                      row_bytes=21 + 4 * layers.shape[1])
