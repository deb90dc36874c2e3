"""Time the two routes the scene path could take for its K1 / K2 calls on a
full 640 x 480 Kinect frame (tests/kinect_data.py), on an NVIDIA GPU, and
read lrf_version 2 against 1 on the same slabs:

  * K1 / K2 (`lrf_moments`, `sign_votes`) on the [chunks, window] slabs of
    ops/tiled.py, the route the port takes;
  * K5 / K6 (`lrf_moments_windowed`, `sign_votes_windowed`) over the whole
    sorted cloud, fed the plan's window starts (ops/binned.window_starts,
    the window sized to the widest candidate range so the plan is exact);
  * K10 / K11 (lrf_version 2's moment identity) against K1 / K2 on the
    slabs: the share of valid frames within 2e-3, the reading behind
    ops/tiled.check_lrf_version's refusal of lrf_version 2 on scenes.

    python tests/scene_timing.py [--out FILE]

At configs/rgbd_kinect.ism's normals (Q = N, NormalRadius 0.005) and
keypoint LRFs (Q = the voxel keypoints, leaf 0.02, ReferenceFrameRadius
0.05) of the first kinect_data.FRAME_SEEDS frame it prints and writes one
JSON row each: CUDA-event ms over 5 launches of each kernel, the in-radius
pairs, K1's bound (chip_smoke.bound) and the card's name and power limit.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(dev):
    """One row per (normals, keypoint LRFs) case (module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import kinect_data as kd
    from point_cloud_donkey_tpu_torch.models import keypoints as tkp
    from point_cloud_donkey_tpu_torch.models.features import (FeatureConfig,
                                                              pad_cloud)
    from point_cloud_donkey_tpu_torch.ops import binned, tiled
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

    with open(os.path.join(os.path.dirname(HERE), "configs",
                           "rgbd_kinect.ism")) as f:
        config = IsmConfig.from_json(json.load(f))
    fcfg = FeatureConfig.from_config(config.child("Features"))
    kpp = tkp.KeypointParams.from_config(config.child("Keypoints"))
    frame = kd.kinect_frame(kd.FRAME_SEEDS[0])
    axis = tiled.sort_key_axis(frame.xyz)
    xyz = frame.xyz[np.argsort(frame.xyz[:, axis], kind="stable")]
    pts_h, mask_h = pad_cloud(xyz)
    pts = torch.from_numpy(pts_h).to(dev)
    mask = torch.from_numpy(mask_h).to(dev)
    kp = torch.from_numpy(tkp.voxel_keypoints(xyz, None, None,
                                              kpp.leaf_size, dev)[0]).to(dev)
    kp = kp[torch.argsort(kp[:, axis], stable=True)]
    key = pts_h[:, axis]
    card = cs.gpu_name_and_power()
    rows = []
    for what, q, qm, r, chunk, minw in (
            ("normals", pts, mask, config.root.get("NormalRadius", 0.05),
             tiled.NORMALS_CHUNK, 1024),
            ("keypoint LRFs", kp, torch.ones(len(kp), dtype=torch.bool,
                                             device=dev),
             fcfg.ref_frame_radius, tiled.KEYPOINT_CHUNK, 4096)):
        qm_h = qm.cpu().numpy()
        plan = tiled.plan_tiles(np.where(qm_h, q[:, axis].cpu().numpy(),
                                         1e9), qm_h, key, r, chunk, minw)
        qs = tiled.chunk_queries(q, plan, 1e9)
        qms = tiled.chunk_queries(qm, plan, False)
        ps = tiled.window_slabs(pts, plan)
        pms = tiled.window_slabs(mask, plan)
        q_s, p_s = klrf.prep_shift(qs, ps, pms)
        k1 = cs.cuda_ms(lambda: klrf.moments(q_s, p_s, pms, r), 5)
        mom, cnt = klrf.moments(q_s, p_s, pms, r)
        pairs = int(cnt[qms].sum())
        axes = torch.zeros((*q_s.shape[:2], 6), device=dev)
        axes[..., 0] = 1.0
        axes[..., 5] = 1.0
        k2 = cs.cuda_ms(lambda: klrf.sign_votes(q_s, p_s, pms, axes, r), 5)
        # K5 / K6: the whole sorted cloud, one window for every tile
        q1, qm1 = q[None].contiguous(), qm[None].contiguous()
        qkey = q1[..., axis].contiguous()
        pkey = torch.where(mask, pts[:, axis], torch.full_like(
            pts[:, axis], binned.PARK))[None].contiguous()
        span = binned.window_starts(qkey, qm1, pkey, r, pts.shape[0]).span
        win = min(pts.shape[0], -(-int(span) // binned.ALIGN)
                  * binned.ALIGN + binned.ALIGN)
        wp = binned.window_starts(qkey, qm1, pkey, r, win)
        assert bool(wp.exact), f"{what}: the K5 plan is not exact"
        q5, p5 = klrf.prep_shift(q1, pts[None].contiguous(), mask[None])
        st = wp.starts.contiguous()
        k5 = cs.cuda_ms(lambda: klrf.moments_windowed(
            q5, p5, mask[None], st, win, r), 5)
        _, cnt5 = klrf.moments_windowed(q5, p5, mask[None], st, win, r)
        assert int(cnt5[qm1].sum()) == pairs, \
            f"{what}: K5's in-radius pairs {int(cnt5[qm1].sum())} vs K1's " \
            f"{pairs}"
        axes5 = torch.zeros((1, q5.shape[1], 6), device=dev)
        axes5[..., 0] = 1.0
        axes5[..., 5] = 1.0
        k6 = cs.cuda_ms(lambda: klrf.sign_votes_windowed(
            q5, p5, mask[None], axes5, st, win, r), 5)
        b1 = cs.bound(cs.nbytes(q_s, p_s, pms, mom, cnt),
                      pairs * (cs.GATE_OPS + cs.MOMENT_BODY_OPS))
        lrf1 = shot_lrf(qs, qms, ps, pms, r)
        lrf2 = shot_lrf(qs, qms, ps, pms, r, lrf_version=2)
        both = lrf1.valid & lrf2.valid
        agree = float(((lrf1.frames - lrf2.frames).abs().amax((-1, -2))
                       < 2e-3)[both].float().mean())
        row = {"what": what, "queries": int(qm.sum()),
               "points": int(mask.sum()), "radius": r, "pairs": pairs,
               "slabs": plan.n_chunks, "slab_window": plan.window,
               "k1_ms": k1, "k2_ms": k2, "k1_bound_ms": b1[0],
               "k1_bound_by": b1[1], "k5_window": win, "k5_ms": k5,
               "k6_ms": k6, "v2_frames_within_2e-3": agree,
               "v2_valid_equal": float((lrf1.valid == lrf2.valid)[qms]
                                       .float().mean()), "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scene_timing: torch.cuda.is_available() is False")
    with torch.no_grad():
        rows = measure(torch.device("cuda:0"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
