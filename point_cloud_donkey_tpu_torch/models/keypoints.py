"""Voxel-grid keypoints and VoxelGridCulling (port of
point_cloud_donkey_tpu/models/keypoints.py for the VoxelGrid and
VoxelGridCulling types).

Reference: keypoints/keypoints_voxel_grid.cpp (grid centroids) and
keypoints/keypoints_voxel_grid_culling.cpp (grid + keypoint-quality
culling):

  * geometry scores: "curvature" (the normal-estimation curvature at the
    keypoints with radius = leaf), "gaussian" (pc1 * pc2 principal
    curvatures at the keypoints, projected on the keypoint's voxel-averaged
    normal, as the JAX package does), "kpq" (Mian et al.'s keypoint quality
    over the points' principal curvatures, culling.cpp:437-470, with the
    reference's FLT_MIN inits);
  * colour score: the share of in-radius neighbours whose CIELab distance
    to the keypoint's colour exceeds MaxSimilarColorDistance
    (culling.cpp:474-506);
  * thresholds: CutOff (the sorted-score quantile at FilterCutoffRatio),
    Threshold (fixed), Auto (the histogram-step heuristic,
    culling.cpp:369-400), all initialised to FLT_MIN as the reference does;
  * combination: RequireOne / RequireBoth / RequireCombinedList with the
    reference's (x - min) / max normalisation (sic, culling.cpp:331-340);
  * RefineKeypointPosition: the midpoint between each accepted keypoint
    and the best-scoring voxel keypoint within 1.5 leaf, searched over all
    voxel keypoints (culling.cpp:509-607).

The scores are batched torch functions on the device (:func:`culling_scores`,
one call a chunk of clouds; :func:`tiled_culling_scores` for a scene, on the
windows of ops/tiled.py); the thresholds and the refinement run on the
host over each cloud's compact keypoints (:func:`apply_culling_host`), so
the batched and the per-cloud routes decide alike.  The keypoint
detectors (Harris3D, ISS3D, SIFT3D) are parsed only: training and
detection refuse them by name (ROADMAP A15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import tiled
from ..ops.color import color_distance, rgb_to_cielab_normalized
from ..ops.curvature import principal_curvatures
from ..ops.eigh3 import eigvals3x3
from ..ops.neighbors import radius_covariance
from ..ops.voxel_grid import voxel_grid
from ..utils.config import ComponentConfig

FLT_MIN = np.float32(np.finfo(np.float32).tiny)


@dataclass
class KeypointParams:
    type: str = "VoxelGrid"
    leaf_size: float = 0.1
    filter_method_geometry: str = "None"
    filter_type_geometry: str = "CutOff"
    filter_threshold_geometry: float = 0.005
    filter_method_color: str = "None"
    filter_type_color: str = "CutOff"
    filter_threshold_color: float = 0.02
    max_similar_color_distance: float = 0.01
    filter_cutoff_ratio: float = 0.5
    disable_filter_in_training: bool = True
    combine_filters: str = "RequireCombinedList"
    refine_position: bool = False
    # Harris3D (keypoints_harris3d.cpp:7-11), parsed only (ROADMAP A15)
    harris_threshold: float = 1e-4
    harris_nonmax: bool = True
    harris_refine: bool = True
    # ISS3D (keypoints_iss3d.cpp:7-13), parsed only
    iss_salient_radius: float = 0.1
    iss_nonmax_radius: float = 0.05
    iss_gamma21: float = 0.975
    iss_gamma32: float = 0.975
    iss_min_neighbors: int = 5
    # Harris3D / SIFT3D support radius (both call it "Radius")
    radius: float = 0.05

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "KeypointParams":
        return cls(
            type=cfg.type or "VoxelGrid",
            leaf_size=cfg.get("LeafSize", 0.1),
            filter_method_geometry=cfg.get("FilterMethodGeometry", "None"),
            filter_type_geometry=cfg.get("FilterTypeGeometry", "CutOff"),
            filter_threshold_geometry=cfg.get("FilterThresholdGeometry",
                                              0.005),
            filter_method_color=cfg.get("FilterMethodColor", "None"),
            filter_type_color=cfg.get("FilterTypeColor", "CutOff"),
            filter_threshold_color=cfg.get("FilterThresholdColor", 0.02),
            max_similar_color_distance=cfg.get("MaxSimilarColorDistance",
                                               0.01),
            filter_cutoff_ratio=cfg.get("FilterCutoffRatio", 0.5),
            disable_filter_in_training=cfg.get("DisableFilterInTraining",
                                               True),
            combine_filters=cfg.get("CombineFilters", "RequireCombinedList"),
            refine_position=cfg.get("RefineKeypointPosition", False),
            harris_threshold=cfg.get("Threshold", 1e-4),
            harris_nonmax=cfg.get("NonMaxSupression", True),
            harris_refine=cfg.get("Refine", True),
            iss_salient_radius=cfg.get("SalientRadius", 0.1),
            iss_nonmax_radius=cfg.get("NonMaxRadius", 0.05),
            iss_gamma21=cfg.get("Gamma21", 0.975),
            iss_gamma32=cfg.get("Gamma32", 0.975),
            iss_min_neighbors=cfg.get("MinNeighbors", 5),
            radius=cfg.get("Radius", 0.05),
        )


def culling_disabled(params: KeypointParams, is_training: bool) -> bool:
    """True when VoxelGridCulling behaves as a plain VoxelGrid
    (culling.cpp:76-87): plain type, culling disabled in training, or both
    filter methods None."""
    geo = params.filter_method_geometry.lower()
    col = params.filter_method_color.lower()
    return (params.type == "VoxelGrid"
            or (is_training and params.disable_filter_in_training)
            or (geo == "none" and col == "none"))


def culling_needs_normals(params: KeypointParams, is_training: bool) -> bool:
    """Gaussian and KPQ culling read the cloud's normals."""
    return (not culling_disabled(params, is_training)
            and params.filter_method_geometry.lower() in ("gaussian", "kpq"))


def check_culling_methods(params: KeypointParams) -> None:
    """Raise ValueError for a filter method the reference does not have
    (the JAX culling_scores raises the same)."""
    geo = params.filter_method_geometry.lower()
    col = params.filter_method_color.lower()
    if geo not in ("none", "curvature", "gaussian", "kpq"):
        raise ValueError(f"unsupported keypoint filter method {geo!r}")
    if col not in ("none", "colordistance"):
        raise ValueError(f"unsupported color filter method {col!r}")


def _in_radius_rows(kp, points, mask, r2):
    """Yield (q0, q1, in_r [B, q1 - q0, N]) over keypoint row chunks."""
    for q0, q1 in tiled.row_steps(kp.shape[0], kp.shape[1], points.shape[1]):
        yield q0, q1, (tiled.sqdist(kp[:, q0:q1], points) <= r2) \
            & mask[:, None, :]


def culling_scores(kp: torch.Tensor,          # [B, K, 3] (padding at 1e9)
                   kp_mask: torch.Tensor,     # [B, K]
                   kp_normals: torch.Tensor,  # [B, K, 3]
                   kp_rgb: torch.Tensor,      # [B, K, 3]
                   points: torch.Tensor,      # [B, N, 3]
                   mask: torch.Tensor,        # [B, N]
                   normals: torch.Tensor,     # [B, N, 3]
                   rgb: torch.Tensor,         # [B, N, 3]
                   geo: str, col: str, leaf: float, max_col_dist: float):
    """(geometry scores [B, K], colour scores [B, K]) of every keypoint of a
    chunk of clouds against its cloud (module docstring); padded rows
    score 0."""
    b, k = kp.shape[:2]
    dt = points.dtype
    geo_scores = torch.zeros((b, k), dtype=dt, device=points.device)
    color_scores = torch.zeros((b, k), dtype=dt, device=points.device)
    r2 = float(np.float32(leaf * leaf))
    if geo == "curvature":
        mom = radius_covariance(kp, points, mask, leaf, weighting="uniform",
                                center="mean")
        vals = eigvals3x3(mom.cov)
        total = vals.sum(-1)
        geo_scores = torch.where(total > 0, vals[..., 0]
                                 / torch.clamp(total, min=1e-30),
                                 torch.zeros_like(total))
    elif geo == "gaussian":
        res = principal_curvatures(kp, kp_normals, points, normals, mask,
                                   leaf)
        geo_scores = res.pc1 * res.pc2
    elif geo == "kpq":
        dense = principal_curvatures(points, normals, points, normals, mask,
                                     leaf)
        k1, k2 = dense.pc1, dense.pc2                       # [B, N]
        kk = k1 * k2
        inf = float("inf")
        for q0, q1, in_r in _in_radius_rows(kp, points, mask, r2):
            kkb, k1b, k2b = (x[:, None, :].expand(in_r.shape)
                             for x in (kk, k1, k2))
            num = in_r.sum(-1)
            kk_sum = torch.where(in_r, kkb, torch.zeros_like(kkb)).sum(-1)
            # the reference inits max_K / max_k1 with FLT_MIN (the smallest
            # POSITIVE float): an all-negative support clamps them to ~0
            kk_max = torch.clamp(torch.where(
                in_r, kkb, torch.full_like(kkb, -inf)).amax(-1),
                min=float(FLT_MIN))
            kk_min = torch.where(in_r, kkb, torch.full_like(kkb, inf)
                                 ).amin(-1)
            k1_max = torch.clamp(torch.where(
                in_r, k1b, torch.full_like(k1b, -inf)).amax(-1),
                min=float(FLT_MIN))
            k2_min = torch.where(in_r, k2b, torch.full_like(k2b, inf)
                                 ).amin(-1)
            kpq = (1000.0 * kk_sum + 100.0 * kk_max
                   + torch.abs(100.0 * kk_min) + 10.0 * k1_max
                   + torch.abs(10.0 * k2_min))
            geo_scores[:, q0:q1] = torch.where(num > 0, kpq,
                                               torch.zeros_like(kpq))
    elif geo != "none":
        raise ValueError(f"unsupported keypoint filter method {geo!r}")

    if col == "colordistance":
        lab_cloud = rgb_to_cielab_normalized(rgb)
        lab_kp = rgb_to_cielab_normalized(kp_rgb)
        for q0, q1, in_r in _in_radius_rows(kp, points, mask, r2):
            dist = color_distance(lab_kp[:, q0:q1, None, :],
                                  lab_cloud[:, None, :, :])
            distant = ((dist > max_col_dist) & in_r).sum(-1)
            cnt = torch.clamp(in_r.sum(-1), min=1)
            color_scores[:, q0:q1] = distant.to(dt) / cnt.to(dt)
    elif col != "none":
        raise ValueError(f"unsupported color filter method {col!r}")
    m = kp_mask.to(dt)
    return geo_scores * m, color_scores * m


def tiled_culling_scores(kp: np.ndarray, kp_normals: Optional[np.ndarray],
                         kp_rgb: Optional[np.ndarray], points: np.ndarray,
                         normals: Optional[np.ndarray],
                         rgb: Optional[np.ndarray], geo: str, col: str,
                         leaf: float, max_col_dist: float,
                         device: torch.device):
    """Scene-scale culling scores (the JAX ``_tiled_culling_scores``): the
    cloud and the keypoints sorted along the longest axis, the stages of
    ops/tiled.py on the windows.  Returns compact [K] (geometry, colour)
    scores in keypoint order, as numpy."""
    k = len(kp)
    geo_scores = np.zeros(k, np.float32)
    color_scores = np.zeros(k, np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    axis = tiled.sort_key_axis(points)
    p_order = np.argsort(points[:, axis], kind="stable")
    pts_s = np.ascontiguousarray(points[p_order], dtype=np.float32)
    p_mask = torch.ones(len(pts_s), dtype=torch.bool, device=device)
    k_order = np.argsort(kp[:, axis], kind="stable")
    inv = np.argsort(k_order, kind="stable")
    chunk = tiled.KEYPOINT_CHUNK
    k_bucket = max(1, -(-k // chunk)) * chunk
    kp_pad = np.full((k_bucket, 3), 1e9, np.float32)
    kp_pad[:k] = kp[k_order]
    kp_valid = np.zeros(k_bucket, bool)
    kp_valid[:k] = True
    plan_kp = tiled.plan_tiles(kp_pad[:, axis], kp_valid, pts_s[:, axis],
                               leaf, chunk)
    pts_d, kp_d = dev(pts_s), dev(kp_pad)

    if geo == "curvature":
        mom = tiled.tiled_radius_moments(kp_d, pts_d, p_mask, plan_kp, leaf,
                                         weighting="uniform", center="mean")
        vals = eigvals3x3(mom.cov)
        total = vals.sum(-1)
        curv = torch.where(total > 0, vals[:, 0]
                           / torch.clamp(total, min=1e-30),
                           torch.zeros_like(total))
        geo_scores = curv.cpu().numpy()[:k][inv]
    elif geo in ("gaussian", "kpq"):
        nrm_s = dev(normals[p_order])
        if geo == "gaussian":
            kn_pad = np.zeros((k_bucket, 3), np.float32)
            kn_pad[:k] = kp_normals[k_order]
            res = tiled.tiled_principal_curvatures(
                kp_d, dev(kn_pad), pts_d, nrm_s, p_mask, plan_kp, leaf)
            geo_scores = (res.pc1 * res.pc2).cpu().numpy()[:k][inv]
        else:
            # the points' own principal curvatures (queries = the cloud)
            n = len(pts_s)
            nq = max(1, -(-n // tiled.NORMALS_CHUNK)) * tiled.NORMALS_CHUNK
            q_key = np.full(nq, 1e9, np.float32)
            q_key[:n] = pts_s[:, axis]
            q_valid = np.zeros(nq, bool)
            q_valid[:n] = True
            plan_d = tiled.plan_tiles(q_key, q_valid, pts_s[:, axis], leaf,
                                      tiled.NORMALS_CHUNK)
            dense = tiled.tiled_principal_curvatures(
                pts_d, nrm_s, pts_d, nrm_s, p_mask, plan_d, leaf)
            cnt, kk_sum, kk_max, kk_min, k1_max, k2_min = (
                x.cpu().numpy() for x in tiled.tiled_kpq_aggregate(
                    kp_d, pts_d, dense.pc1, dense.pc2, p_mask, plan_kp,
                    leaf))
            cnt = cnt[:k][inv]
            kpq = (1000.0 * kk_sum + 100.0 * np.maximum(kk_max, FLT_MIN)
                   + np.abs(100.0 * kk_min)
                   + 10.0 * np.maximum(k1_max, FLT_MIN)
                   + np.abs(10.0 * k2_min))[:k][inv]
            geo_scores = np.where(cnt > 0, kpq, 0.0).astype(np.float32)
    elif geo != "none":
        raise ValueError(f"unsupported keypoint filter method {geo!r}")

    if col == "colordistance":
        lab_s = rgb_to_cielab_normalized(dev(rgb[p_order]))
        lab_kp = rgb_to_cielab_normalized(dev(kp_rgb[k_order]))
        kl_pad = torch.zeros((k_bucket, 3), dtype=torch.float32,
                             device=device)
        kl_pad[:k] = lab_kp
        in_cnt, distant = (x.cpu().numpy() for x in tiled.tiled_color_counts(
            kp_d, kl_pad, pts_d, lab_s, p_mask, plan_kp, leaf,
            max_col_dist))
        in_cnt = in_cnt[:k][inv]
        distant = distant[:k][inv]
        color_scores = (distant / np.maximum(in_cnt, 1)).astype(np.float32)
    elif col != "none":
        raise ValueError(f"unsupported color filter method {col!r}")
    return geo_scores, color_scores


def apply_culling_host(kp: np.ndarray, kp_rgb: Optional[np.ndarray],
                       geo_scores: np.ndarray, color_scores: np.ndarray,
                       params: KeypointParams, return_colors: bool = False):
    """Threshold, combine and refine stage of VoxelGridCulling over compact
    host arrays (culling.cpp:331-434, 509-...); shared by the per-cloud and
    the batched routes.  Returns the kept (refined) keypoints, with their
    colours when asked."""
    geo = params.filter_method_geometry.lower()
    col = params.filter_method_color.lower()

    # combined scores with the reference's normalisation (culling.cpp:331-340)
    gmin, gmax = float(geo_scores.min()), float(geo_scores.max())
    cmin, cmax = float(color_scores.min()), float(color_scores.max())
    combined = ((geo_scores - gmin) / gmax if gmax != 0
                else geo_scores * 0) + \
        ((color_scores - cmin) / cmax if cmax != 0 else color_scores * 0)

    # every threshold starts at FLT_MIN (the smallest POSITIVE float); the
    # combined one keeps it unless both types are CutOff, so under
    # RequireCombinedList a keypoint whose combined score is exactly 0 is
    # rejected
    t_geo = t_color = t_combined = FLT_MIN
    gtype = params.filter_type_geometry.lower()
    ctype = params.filter_type_color.lower()
    if geo != "none" and gtype not in ("cutoff", "threshold", "auto"):
        raise ValueError(f"unsupported keypoint filter type {gtype!r}")
    if col != "none" and ctype not in ("cutoff", "threshold"):
        raise ValueError(f"unsupported keypoint color filter type {ctype!r}")
    if geo == "kpq" and gtype == "auto":
        # culling.cpp:102-106
        raise ValueError("filter type Auto is not supported with KPQ")

    def quantile(scores):
        srt = np.sort(scores)
        return srt[min(int(params.filter_cutoff_ratio * len(srt)),
                       len(srt) - 1)]

    if geo != "none" and gtype == "auto":
        t_geo = _auto_threshold(np.sort(geo_scores))
    if geo != "none" and gtype == "cutoff":
        t_geo = quantile(geo_scores)
    if col != "none" and ctype == "cutoff":
        t_color = quantile(color_scores)
    if geo != "none" and col != "none" and gtype == "cutoff" \
            and ctype == "cutoff":
        t_combined = quantile(combined)
    if geo != "none" and gtype == "threshold":
        t_geo = params.filter_threshold_geometry
    if col != "none" and ctype == "threshold":
        t_color = params.filter_threshold_color

    geo_passed = geo_scores >= t_geo if geo != "none" \
        else np.ones(len(kp), bool)
    color_passed = color_scores >= t_color if col != "none" \
        else np.ones(len(kp), bool)
    combined_passed = combined >= t_combined

    if geo != "none" and col != "none":
        if params.combine_filters == "RequireOne":
            accept = geo_passed | color_passed
        elif params.combine_filters == "RequireBoth":
            accept = geo_passed & color_passed
        else:  # RequireCombinedList
            accept = combined_passed
    else:
        accept = geo_passed & color_passed

    result = kp[accept]
    result_rgb = kp_rgb[accept] if kp_rgb is not None else None
    if params.refine_position and len(result):
        result, result_rgb = _refine_positions(
            kp, kp_rgb, accept, geo_scores, color_scores, combined,
            geo_passed, color_passed, geo, col, params)
    result = result.astype(np.float32)
    return (result, result_rgb) if return_colors else result


def _auto_threshold(sorted_scores: np.ndarray) -> float:
    """Histogram-step heuristic (culling.cpp:369-400)."""
    hist_size = 100
    lo, hi = sorted_scores[0], sorted_scores[-1]
    step = (hi - lo) / hist_size
    if step <= 0:
        return -np.inf
    hist = np.zeros(hist_size, int)
    bins = np.clip(((sorted_scores - lo) / step).astype(int), 0,
                   hist_size - 1)
    np.add.at(hist, bins, 1)
    cutoff_index = 0
    for i in range(hist_size - 2):
        cutoff_index += hist[i]
        if (hist[i + 1] - hist[i]) * 2 < (hist[i + 2] - hist[i + 1]):
            cutoff_index += hist[i + 1]
            break
    cutoff_index = min(cutoff_index, len(sorted_scores) - 1)
    return float(sorted_scores[cutoff_index])


def _refine_positions(kp, kp_rgb, accept, geo_scores, color_scores, combined,
                      geo_passed, color_passed, geo, col,
                      params: KeypointParams):
    """Move each accepted keypoint to the midpoint between itself and the
    best-scoring keypoint within 1.5 leaf (culling.cpp:509-607): the search
    runs over all voxel keypoints, the best index is consolidated from the
    geometry / colour / combined lists by the passed flags, and the point
    averages position and colour.  One output per accepted keypoint, in
    input order."""
    d2 = ((kp[:, None] - kp[None]) ** 2).sum(-1)
    r = params.leaf_size * 1.5
    close = d2 <= r * r

    def best_of(scores, idxs, i):
        # radiusSearch returns neighbours sorted by distance; the reference
        # keeps the FIRST strict maximum in that order
        order = idxs[np.argsort(d2[i][idxs], kind="stable")]
        return order[np.argmax(scores[order])]

    out, out_rgb = [], []
    for i in np.nonzero(accept)[0]:
        idxs = np.nonzero(close[i])[0]
        best_geo = best_of(geo_scores, idxs, i) if geo != "none" else -1
        best_col = best_of(color_scores, idxs, i) if col != "none" else -1
        if geo == "none":
            best = best_col
        elif col == "none":
            best = best_geo
        else:
            best = best_of(combined, idxs, i)
            if geo_passed[i] and not color_passed[i]:
                best = best_geo
            if color_passed[i] and not geo_passed[i]:
                best = best_col
            if color_passed[i] and geo_passed[i] and best_geo == best_col:
                best = best_geo
        out.append(0.5 * (kp[best] + kp[i]))
        if kp_rgb is not None:
            out_rgb.append(0.5 * (kp_rgb[best] + kp_rgb[i]))
    pos = np.asarray(out, np.float32).reshape(-1, 3)
    rgb = np.asarray(out_rgb, np.float32).reshape(-1, 3) \
        if kp_rgb is not None else None
    return pos, rgb


def voxel_keypoints(points: np.ndarray, normals: Optional[np.ndarray],
                    rgb: Optional[np.ndarray], leaf: float,
                    device: torch.device):
    """(keypoints [K, 3], voxel-averaged normals [K, 3] or None, colours
    [K, 3] or None) of one cloud: the voxel grid of the JAX per-cloud
    keypoint program, which divides by the leaf."""
    feats = [a for a in (normals, rgb) if a is not None]
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(
        device)
    extra = torch.from_numpy(np.concatenate(feats, 1).astype(np.float32)
                             ).to(device) if feats else None
    res = voxel_grid(pts, torch.ones(len(points), dtype=torch.bool,
                                     device=device),
                     leaf, features=extra, exact_division=True)
    full = res.centroids[res.mask].cpu().numpy()
    kp = np.ascontiguousarray(full[:, :3])
    off = 3
    kp_normals = kp_rgb = None
    if normals is not None:
        kp_normals, off = full[:, 3:6], 6
    if rgb is not None:
        kp_rgb = full[:, off:off + 3]
    return kp, kp_normals, kp_rgb


def cloud_culling_scores(kp: np.ndarray, kp_normals: Optional[np.ndarray],
                         kp_rgb: Optional[np.ndarray], points: np.ndarray,
                         normals: Optional[np.ndarray],
                         rgb: Optional[np.ndarray], params: KeypointParams,
                         device: torch.device):
    """(geometry [K], colour [K]) culling scores of one cloud's voxel
    keypoints, as numpy: the tiled stages above tiled.SCENE_TILE_THRESHOLD
    points, the batched :func:`culling_scores` of one cloud below."""
    geo = params.filter_method_geometry.lower()
    col = params.filter_method_color.lower()
    leaf = float(params.leaf_size)
    dist = float(params.max_similar_color_distance)
    if len(points) > tiled.SCENE_TILE_THRESHOLD:
        return tiled_culling_scores(kp, kp_normals, kp_rgb, points, normals,
                                    rgb, geo, col, leaf, dist, device)

    def row(a, k=len(kp)):
        return torch.from_numpy(np.ascontiguousarray(
            np.zeros((k, 3), np.float32) if a is None else a,
            np.float32))[None].to(device)
    g, c = culling_scores(
        row(kp), torch.ones((1, len(kp)), dtype=torch.bool, device=device),
        row(kp_normals), row(kp_rgb), row(points, len(points)),
        torch.ones((1, len(points)), dtype=torch.bool, device=device),
        row(normals, len(points)), row(rgb, len(points)), geo, col, leaf,
        dist)
    return g[0].cpu().numpy(), c[0].cpu().numpy()


def detect_keypoints(points: np.ndarray,             # [N, 3]
                     normals: Optional[np.ndarray],  # [N, 3] or None
                     rgb: Optional[np.ndarray],      # [N, 3] or None
                     params: KeypointParams, device: torch.device,
                     is_training: bool = False):
    """(keypoints [K, 3], voxel-averaged colours [K, 3] or None) of one
    cloud: the voxel grid's centroids (the normals and colours averaged
    alongside), culled when VoxelGridCulling culls."""
    if params.type not in ("VoxelGrid", "VoxelGridCulling"):
        raise NotImplementedError(
            f"keypoint type {params.type!r} (VoxelGrid only; the keypoint "
            "detectors are ROADMAP A15)")
    kp, kp_normals, kp_rgb = voxel_keypoints(points, normals, rgb,
                                             params.leaf_size, device)
    if culling_disabled(params, is_training):
        return kp, kp_rgb
    geo = params.filter_method_geometry.lower()
    col = params.filter_method_color.lower()
    check_culling_methods(params)
    if geo in ("gaussian", "kpq") and normals is None:
        raise ValueError(f"{geo} keypoint culling needs normals")
    if col == "colordistance" and (rgb is None or kp_rgb is None):
        raise ValueError("color culling needs RGB data")
    geo_s, col_s = cloud_culling_scores(kp, kp_normals, kp_rgb, points,
                                        normals, rgb, params, device)
    if not len(kp):
        return kp, kp_rgb
    return apply_culling_host(kp, kp_rgb, geo_s, col_s, params,
                              return_colors=True)
