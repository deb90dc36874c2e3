#!/usr/bin/env python3
"""Peak device memory of the port's CSHOT and SHORT_SHOT classify steps,
and the bits of K1's and K2's outputs (the dense step's normals and
keypoint LRFs), of K10's and K11's (lrf_version 2: the training normals'
full LRF at Q = N and the keypoint LRFs), of K3's output, of K6's votes
(the windowed step's normals) and of K7's in-radius counts and
histograms at their main paths' shapes, for the port in a given checkout, on one NVIDIA GPU: what
PERF.md compares between two checkouts of the port in one call
(chip_smoke.py prints the same for its own checkout).

    python tests/port_fingerprint.py [ROOT]    # ROOT: a checkout (default:
                                               # the one holding this file)

Inputs are the bench batch of this checkout's tests/bench_data.py (128
clouds x 2048 points, seed 42) and ROOT's committed codebooks.  Prints one
JSON line.
"""

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def digest(*tensors):
    """sha256 (16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def lrf_bits(pts, mask, kp, kp_mask, cfg):
    """sha256 of K1's (moments, counts) and K2's votes at the dense
    classify step's two LRF passes: the z-only normals (Q = N) and the
    keypoint LRFs, K2 on the axes of K1's covariance.  Returns {name:
    digest}."""
    import torch

    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    out = {}
    for what, queries, q_mask, radius, z_only in (
            ("normals", pts, mask, cfg.normal_radius, True),
            ("keypoints", kp, kp_mask, cfg.ref_frame_radius, False)):
        q, p = klrf.prep_shift(queries, pts, mask)
        mom, cnt = klrf.moments(q, p, mask, radius)
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        out[f"K1_{what}_sha256"] = digest(mom, cnt)
        out[f"K2_{what}_sha256"] = digest(klrf.sign_votes(q, p, mask, axes,
                                                          radius, z_only))
    return out


def lrf_v2_bits(pts, mask, kp, kp_mask, cfg):
    """sha256 of K10's (moments, counts) and K11's votes at the v2 LRF
    passes that launch K11: the training normals' full LRF (Q = N) and the
    keypoint LRFs, K11 on the axes of K10's covariance.  Returns {name:
    digest}."""
    import torch

    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    out = {}
    for what, queries, q_mask, radius in (
            ("full_normals", pts, mask, cfg.normal_radius),
            ("keypoints", kp, kp_mask, cfg.ref_frame_radius)):
        q, p = klrf.prep_shift(queries, pts, mask)
        mom, cnt = klrf.moments_v2(q, p, mask, radius)
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        out[f"K10_{what}_sha256"] = digest(mom, cnt)
        out[f"K11_{what}_sha256"] = digest(klrf.sign_votes_v2(q, p, mask,
                                                              axes, radius))
    return out


def windowed_votes_bits(pts, mask, radius):
    """sha256 of K6's votes at the windowed step's normals: the batch
    sorted along each cloud's principal axis, the window calibrated on it,
    K6 (z only) on the axes of K5's covariance."""
    import torch

    from point_cloud_donkey_tpu_torch.ops import binned
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    window = binned.required_window(pts, mask, radius)
    srt = binned.sort_clouds_ex(pts, mask)
    plan = binned.window_starts(srt.keys, srt.mask, srt.keys, radius, window)
    q, p = klrf.prep_shift(srt.points, srt.points, srt.mask)
    mom, _ = klrf.moments_windowed(q, p, srt.mask, plan.starts, window,
                                   radius)
    cov, _ = klrf.cov_from_moments(mom, q, srt.mask)
    _, vecs = eigh3x3(cov)
    axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
    return digest(klrf.sign_votes_windowed(q, p, srt.mask, axes, plan.starts,
                                           window, radius, True))


def step_memory(model, pts, mask, extra):
    """(peak MiB, MiB above what was held before) of one step after a
    warm-up."""
    import torch
    with torch.no_grad():
        model(pts, mask, *extra)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        model(pts, mask, *extra)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return round(peak / 2**20, 1), round((peak - held) / 2**20, 1)


def main(root):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_fingerprint: needs an NVIDIA GPU")
    sys.path[:0] = [os.path.abspath(root), HERE]
    from bench_data import KEYPOINT_CAPACITY, bench_clouds, bench_colors
    from point_cloud_donkey_tpu_torch.models.codebook import (
        CodebookParams, load_codebook)
    from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                              PipelineConfig)
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as kshot
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

    dev = torch.device("cuda:0")
    data = os.path.join(os.path.abspath(root), "point_cloud_donkey_tpu_torch",
                        "data")
    _, _, clouds, _ = bench_clouds(128)
    pts = torch.from_numpy(clouds).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    rgb = torch.from_numpy(bench_colors(clouds)).to(dev)
    out = {"root": os.path.abspath(root),
           "card": torch.cuda.get_device_name(0)}
    models = {}
    for desc in ("CSHOT", "SHORT_SHOT", "SHOT"):
        path = os.path.join(data, ("bench" if desc == "SHOT" else
                                   desc.lower()) + "_codebook.ism")
        config = IsmConfig.load(path)
        cb = load_codebook(path).to(dev)
        models[desc] = IsmClassifier(
            cb, PipelineConfig.from_ism(config, cb.num_classes,
                                        keypoint_capacity=KEYPOINT_CAPACITY),
            CodebookParams.from_config(config.child("Codebook")))
    for desc in ("CSHOT", "SHORT_SHOT"):
        peak, above = step_memory(models[desc], pts, mask,
                                  (rgb,) if desc == "CSHOT" else ())
        out[f"{desc}_peak_mib"], out[f"{desc}_above_held_mib"] = peak, above

    cfg = models["SHOT"].cfg
    with torch.no_grad():
        # K3 at the dense step's shapes (chip_smoke.py phase 2)
        normals = compute_normals_fast(pts, mask, cfg.normal_radius)
        kres = voxel_grid(pts, mask, cfg.leaf_size,
                          capacity=cfg.keypoint_capacity)
        kp = torch.where(kres.mask[..., None], kres.centroids,
                         torch.full_like(kres.centroids, 1e9))
        out.update(lrf_bits(pts, mask, kp, kres.mask, cfg))
        out.update(lrf_v2_bits(pts, mask, kp, kres.mask, cfg))
        lrf = shot_lrf(kp, kres.mask, pts, mask, cfg.ref_frame_radius)
        gidx, alive, tile_cloud = kshot.compact_layout(kres.mask)
        kp_rows = torch.where(alive[:, None], kp.reshape(-1, 3)[gidx],
                              torch.full((1, 3), 1e9, device=dev))
        out["K3_sha256"] = digest(*kshot.shot_tiles(
            kp_rows, lrf.frames.reshape(-1, 3, 3)[gidx].contiguous(),
            tile_cloud, pts, normals, mask, cfg.radius))
        # K7 at the mean-shift step's shapes (the first 32 clouds)
        mp, mm = pts[:32].contiguous(), mask[:32].contiguous()
        mn = compute_normals_fast(mp, mm, cfg.normal_radius)
        mk = voxel_grid(mp, mm, cfg.leaf_size, capacity=cfg.keypoint_capacity)
        mkp = torch.where(mk.mask[..., None], mk.centroids,
                          torch.full_like(mk.centroids, 1e9)).contiguous()
        mlrf = shot_lrf(mkp, mk.mask, mp, mm, cfg.ref_frame_radius)
        hist, cnt = kshot.shot_dense(mkp, mlrf.frames.contiguous(),
                                     mlrf.valid.contiguous(), mp, mn, mm,
                                     cfg.radius)
        out["K7_counts_sha256"] = digest(cnt)
        out["K7_hist_sha256"] = digest(hist)
        out["K6_windowed_sha256"] = windowed_votes_bits(pts, mask,
                                                        cfg.normal_radius)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(HERE))
