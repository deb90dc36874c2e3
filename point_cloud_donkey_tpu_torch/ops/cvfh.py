"""CVFH and OUR-CVFH (port of point_cloud_donkey_tpu/ops/cvfh.py; Aldoma
et al., pcl::CVFHEstimation / pcl::OURCVFHEstimation as wrapped at
features/features_cvfh.cpp and features_ourcvfh.cpp).

Per cloud: points above the curvature threshold dropped; smooth-region
growing on the host (a BFS in numpy: a neighbour joins within the distance
tolerance when its normal's cosine to the current point's is at least
cos(eps)), clusters of at least min_points kept; one raw-count VFH-308 per
cluster over the whole cloud against the cluster's (centroid, mean
normal) pair (ops/global_descriptors.vfh_descriptor, all clusters of a
cloud in one batch on the device); with OUR-CVFH, each cluster's SGURF
frame(s) replace the viewpoint block by the cloud's 8-octant x 13-bin
shape distribution in that frame.  Without a cluster, one VFH over the
filtered cloud (PCL's fallback).  The BFS's cosine and curvature tests are
decisions at thresholds, so a point at the rounding of either can join
another region than in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .descriptors_misc import slot_histogram
from .global_descriptors import VFH_BINS, vfh_descriptor

SHAPE_DIST_BINS = 13
SHAPE_DIST_OCTANTS = 8


def smooth_region_clusters(xyz: np.ndarray, normals: np.ndarray,
                           curvature: np.ndarray, dist_tol: float,
                           eps_angle: float, curv_threshold: float,
                           min_points: int
                           ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(clusters, low-curvature indices): the JAX
    ``smooth_region_clusters``, pcl::extractEuclideanClustersSmooth's BFS
    where a neighbour joins within dist_tol when its normal is within
    eps_angle of the current point's."""
    keep = np.where(curvature <= curv_threshold)[0]
    if len(keep) == 0:
        return [], keep
    pts = xyz[keep]
    nrm = normals[keep]
    n = len(keep)
    cos_eps = math.cos(eps_angle)
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1) \
        if n <= 4096 else None
    visited = np.zeros(n, bool)
    clusters: List[np.ndarray] = []
    tol2 = dist_tol * dist_tol
    for seed in range(n):
        if visited[seed]:
            continue
        queue = [seed]
        visited[seed] = True
        members = [seed]
        qi = 0
        while qi < len(queue):
            cur = queue[qi]
            qi += 1
            near = (d2[cur] if d2 is not None
                    else np.sum((pts - pts[cur]) ** 2, axis=1)) <= tol2
            cand = np.where(near & ~visited)[0]
            if len(cand) == 0:
                continue
            joins = cand[nrm[cand] @ nrm[cur] >= cos_eps]
            visited[joins] = True
            queue.extend(joins.tolist())
            members.extend(joins.tolist())
        if len(members) >= min_points:
            clusters.append(keep[np.asarray(members)])
    return clusters, keep


def sgurf_shape_distribution(points: torch.Tensor,    # [B, N, 3]
                             mask: torch.Tensor,      # [B, N]
                             centroid: torch.Tensor,  # [B, 3]
                             frame: torch.Tensor      # [B, 3, 3] rows = axes
                             ) -> torch.Tensor:
    """[B, 104] the cloud in the frame, 8 sign octants x 13 bins of |q| /
    max |q|, increments 100 / N (the JAX ``sgurf_shape_distribution``)."""
    dt = points.dtype
    m = mask.to(dt)
    q = ((points - centroid[:, None, :])[..., None, :]
         * frame[:, None, :, :]).sum(-1)
    d = torch.linalg.norm(q, dim=-1)
    d_max = torch.clamp(torch.where(mask, d, torch.zeros_like(d)).amax(
        -1, keepdim=True), min=1e-12)
    i32 = torch.int32
    octant = (q[..., 0] < 0).to(i32) + 2 * (q[..., 1] < 0).to(i32) \
        + 4 * (q[..., 2] < 0).to(i32)
    b = torch.clamp((d / d_max * SHAPE_DIST_BINS).to(i32), 0,
                    SHAPE_DIST_BINS - 1)
    hist = slot_histogram(octant * SHAPE_DIST_BINS + b, m,
                          SHAPE_DIST_BINS * SHAPE_DIST_OCTANTS, 1)
    return 100.0 * hist / torch.clamp(m.sum(-1, keepdim=True), min=1.0)


def sgurf_frames(xyz: np.ndarray, cluster: np.ndarray,
                 avg_normal: np.ndarray, centroid: np.ndarray,
                 axis_ratio: float) -> List[np.ndarray]:
    """A cluster's SGURF frames (the JAX ``_sgurf_frames``): x the dominant
    in-plane direction of the distance-weighted scatter, towards the
    heavier side; both signs when the sides are within axis_ratio."""
    z = avg_normal / max(np.linalg.norm(avg_normal), 1e-12)
    rel = xyz[cluster] - centroid
    d = np.linalg.norm(rel, axis=1)
    w = np.maximum(d.max() - d, 0.0) ** 2
    proj = rel - np.outer(rel @ z, z)
    scatter = (proj * w[:, None]).T @ proj
    _, vecs = np.linalg.eigh(scatter)
    x = vecs[:, -1]
    s = proj @ x
    s_plus = float(np.sum(w * np.maximum(s, 0.0)))
    s_minus = float(np.sum(w * np.maximum(-s, 0.0)))
    if s_minus > s_plus:
        x, s_plus, s_minus = -x, s_minus, s_plus
    frames = [np.stack([x, np.cross(z, x), z])]
    if s_plus > 0 and s_minus / s_plus > axis_ratio:
        x2 = -x
        frames.append(np.stack([x2, np.cross(z, x2), z]))
    return frames


def cvfh_descriptors(xyz: np.ndarray, normals: np.ndarray,
                     curvature: np.ndarray,
                     points_pad: torch.Tensor,   # [N, 3] the padded cloud
                     normals_pad: torch.Tensor,  # [N, 3]
                     mask_pad: torch.Tensor,     # [N]
                     dist_tol: float = 0.015,
                     eps_angle: float = math.radians(10.0),
                     curv_threshold: float = 1.0, min_points: int = 50,
                     with_sgurf: bool = False,
                     axis_ratio: float = 0.8) -> np.ndarray:
    """[M, 308] CVFH (OUR-CVFH with `with_sgurf`) rows of one cloud (the
    JAX ``cvfh_descriptors``)."""
    clusters, keep = smooth_region_clusters(
        xyz, normals, curvature, dist_tol, eps_angle, curv_threshold,
        min_points)
    if not clusters:
        clusters = [keep if len(keep) else np.arange(len(xyz))]
    dev = points_pad.device
    cents = np.stack([xyz[cl].mean(axis=0) for cl in clusters]
                     ).astype(np.float32)
    navg = np.stack([normals[cl].mean(axis=0) for cl in clusters]
                    ).astype(np.float32)
    g = len(clusters)

    def rep(x):
        return x[None].expand((g,) + tuple(x.shape))

    desc = vfh_descriptor(rep(points_pad), rep(normals_pad), rep(mask_pad),
                          centroid=torch.from_numpy(cents).to(dev),
                          avg_normal=torch.from_numpy(navg).to(dev),
                          normalize_bins=False).cpu().numpy()
    if not with_sgurf:
        return desc.astype(np.float32)
    rows, frames, owner = [], [], []
    for i, cl in enumerate(clusters):
        for fr in sgurf_frames(xyz, cl, navg[i], cents[i], axis_ratio):
            frames.append(fr.astype(np.float32))
            owner.append(i)
    f = len(frames)
    sd = sgurf_shape_distribution(
        points_pad[None].expand(f, -1, -1), mask_pad[None].expand(f, -1),
        torch.from_numpy(cents[owner]).to(dev),
        torch.from_numpy(np.stack(frames)).to(dev)).cpu().numpy()
    for j, i in enumerate(owner):
        d = desc[i].copy()
        # the viewpoint block becomes the shape distribution (104 of its
        # 128 slots; the rest stay zero)
        d[4 * VFH_BINS:] = 0.0
        d[4 * VFH_BINS:4 * VFH_BINS + sd.shape[1]] = sd[j]
        rows.append(d)
    return np.stack(rows).astype(np.float32)
