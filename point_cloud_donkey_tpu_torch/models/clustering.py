"""Descriptor clustering to codewords (port of
point_cloud_donkey_tpu/models/clustering.py, clustering/).

  * None: every feature is its own codeword (clustering_none.cpp:37-44).
  * KMeansCount (k = ClusterCount), KMeansFactor (k = ClusterFactor * n),
    KMeansThumbRule (k = round(sqrt(n / 2))): :func:`kmeans`, k-means++
    seeding then Lloyd iterations (at most 100) and the final assignment.
    Lloyd's [N, k] distance matrix is K4m (ops/kernels/chisq.chisq_matrix)
    under the chi-square metric and ``ops/neighbors.pairwise_sqdist`` under
    l2; each feature goes to its nearest centre, ties to the lower index;
    the centre sums are one fp32 one-hot matmul, so two runs give equal
    bits.
  * KMeansHartigan: k in [1, MaxK] maximising Hartigan's index
    ((W_k / W_{k+1} - 1) * (n - k - 1), clustering_kmeans_hartigan.cpp).
  * Agglomerative: average-linkage merging while the similarity
    1 / min distance >= Threshold, on the host (sequential, O(F^3)).

The seeding draws from ``torch.Generator`` seeded with `seed`; the JAX
package draws from ``jax.random`` with the same seed, and the two streams
differ.  KMeans codebooks from the two packages therefore differ by their
seeds alone: from the same ``init_centers`` (the JAX ``kmeans(...,
iterations=0)``) Lloyd's iterations give the JAX centres.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels.chisq import chisq_matrix
from ..ops.neighbors import full_fp32, pairwise_sqdist
from ..utils.config import ComponentConfig

LLOYD_MAX = 100


@dataclass
class ClusteringParams:
    type: str = "None"
    cluster_count: int = 10
    cluster_factor: float = 0.2
    max_k: int = 10
    iterations: int = 1000
    agglo_threshold: float = 1.2

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "ClusteringParams":
        return cls(
            type=cfg.type or "None",
            cluster_count=cfg.get("ClusterCount", 10),
            cluster_factor=cfg.get("ClusterFactor", 0.2),
            max_k=cfg.get("MaxK", 10),
            iterations=cfg.get("Iterations", 1000),
            agglo_threshold=cfg.get("Threshold", 1.2),
        )


def _dist_matrix(x: torch.Tensor, centers: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """[N, k] distances of the features to the centres."""
    if metric == "l2":
        return pairwise_sqdist(x, centers)
    return chisq_matrix(x, centers.contiguous(),
                        torch.ones(centers.shape[0], dtype=torch.bool,
                                   device=x.device))


def kmeans_seeds(x: torch.Tensor, k: int, metric: str,
                 seed: int = 0) -> torch.Tensor:
    """k-means++ seeds [k, D]: the first a uniform draw, each next one
    drawn with probability proportional to its distance to the nearest seed
    so far (the draws from a CPU ``torch.Generator`` seeded with `seed`)."""
    n = x.shape[0]
    gen = torch.Generator().manual_seed(seed)
    first = int(torch.randint(0, n, (1,), generator=gen))
    centers = x.new_zeros((k, x.shape[1]))
    centers[0] = x[first]
    dmin = _dist_matrix(x, centers[:1], metric)[:, 0]
    for i in range(1, k):
        probs = (dmin / torch.clamp(dmin.sum(), min=1e-30)).double().cpu()
        nxt = int(torch.multinomial(probs, 1, generator=gen)) \
            if float(probs.sum()) > 0 else int(torch.randint(
                0, n, (1,), generator=gen))
        centers[i] = x[nxt]
        dmin = torch.minimum(dmin, _dist_matrix(x, centers[i:i + 1],
                                                metric)[:, 0])
    return centers


def kmeans(descriptors: np.ndarray, k: int, metric: str,
           iterations: int = 100, seed: int = 0,
           device: torch.device = torch.device("cpu"),
           init_centers: Optional[np.ndarray] = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(centres [k, D], assignment [N]): :func:`kmeans_seeds` (or
    `init_centers`, which :func:`run_clustering` never passes), then
    min(iterations, 100) Lloyd iterations -- a centre that loses every
    feature stays where it is -- and the nearest-centre assignment."""
    n = descriptors.shape[0]
    k = min(k, n)
    x = torch.from_numpy(np.ascontiguousarray(descriptors, np.float32)).to(
        device)
    centers = kmeans_seeds(x, k, metric, seed) if init_centers is None \
        else torch.from_numpy(np.array(init_centers, np.float32)).to(device)
    with full_fp32():
        for _ in range(min(iterations, LLOYD_MAX)):
            assign = torch.argmin(_dist_matrix(x, centers, metric), dim=1)
            onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
            counts = onehot.sum(0)
            new = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
            centers = torch.where((counts > 0)[:, None], new, centers)
        assign = torch.argmin(_dist_matrix(x, centers, metric), dim=1)
    return centers.cpu().numpy(), assign.cpu().numpy()


def _dispersion(descriptors: np.ndarray, centers: np.ndarray,
                assign: np.ndarray, metric: str) -> float:
    d = descriptors - centers[assign]
    if metric == "l2":
        return float((d * d).sum())
    s = descriptors + centers[assign]
    return float(np.where(s > 0, d * d / np.where(s > 0, s, 1), 0).sum())


def kmeans_hartigan(descriptors: np.ndarray, max_k: int, metric: str,
                    iterations: int = 100,
                    device: torch.device = torch.device("cpu"),
                    init_centers: Optional[Sequence[np.ndarray]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """k-means for k = 1 .. max_k (from init_centers[k - 1] when given),
    keeping the k of the largest Hartigan index (the smallest k on ties,
    k = 1 when no index is positive)."""
    n = descriptors.shape[0]
    max_k = min(max_k, n)
    results, disps = [], []
    for k in range(1, max_k + 1):
        c, a = kmeans(descriptors, k, metric, iterations, device=device,
                      init_centers=None if init_centers is None
                      else init_centers[k - 1])
        results.append((c, a))
        disps.append(_dispersion(descriptors, c, a, metric))
    best_k, best_val = 1, 0.0
    for i in range(max_k - 1):
        denom = disps[i + 1] if disps[i + 1] > 0 else 1e-30
        idx = (disps[i] / denom - 1.0) * (n - (i + 1) - 1)
        if idx > best_val:
            best_val = idx
            best_k = i + 1
    return results[best_k - 1]


def agglomerative(descriptors: np.ndarray, metric: str,
                  threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Average-linkage agglomerative clustering on the host, merging the
    closest pair of cluster means while 1 / their distance >= threshold."""
    n = descriptors.shape[0]
    centers = [descriptors[i].copy() for i in range(n)]
    members: List[List[int]] = [[i] for i in range(n)]

    def dist(a, b):
        if metric == "l2":
            return float(((a - b) ** 2).sum())
        s = a + b
        diff = a - b
        return float(np.where(s > 0, diff * diff / np.where(s > 0, s, 1),
                              0).sum())

    while len(centers) > 1:
        best = (np.inf, -1, -1)
        for i in range(len(centers)):
            for j in range(len(centers)):
                if i == j:
                    continue
                dd = dist(centers[i], centers[j])
                if dd < best[0]:
                    best = (dd, i, j)
        min_dist, i, j = best
        if min_dist <= 0 or 1.0 / min_dist < threshold:
            break
        new_members = members[i] + members[j]
        new_center = descriptors[new_members].mean(axis=0)
        for idx in sorted((i, j), reverse=True):
            del centers[idx], members[idx]
        centers.append(new_center)
        members.append(new_members)

    assign = np.zeros(n, np.int32)
    for ci, mem in enumerate(members):
        for m in mem:
            assign[m] = ci
    return np.stack(centers).astype(np.float32), assign


def run_clustering(descriptors: np.ndarray, params: ClusteringParams,
                   metric: str, device: torch.device = torch.device("cpu")
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(cluster centres, per-feature centre index) under params.type; None
    returns the features themselves with the identity assignment."""
    n = descriptors.shape[0]
    t = params.type
    if t == "None" or n == 0:
        return descriptors.copy(), np.arange(n, dtype=np.int32)
    if t == "Agglomerative":
        return agglomerative(descriptors, metric, params.agglo_threshold)
    if t == "KMeansCount":
        k = params.cluster_count
    elif t == "KMeansFactor":
        k = max(1, int(params.cluster_factor * n))
    elif t == "KMeansThumbRule":
        k = max(1, int(round(math.sqrt(n / 2.0))))
    elif t == "KMeansHartigan":
        return kmeans_hartigan(descriptors, params.max_k, metric,
                               params.iterations, device)
    else:
        raise ValueError(f"unknown clustering type {t!r}")
    return kmeans(descriptors, k, metric, params.iterations, device=device)
