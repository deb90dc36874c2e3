"""Time the cell-binned sweep kernels (K1 `lrf_moments`, K2 `sign_votes`,
K5 / K6 their windowed forms) of one checkout of the port at the batch
sizes its paths launch them with, on an NVIDIA GPU.

    python tests/binned_timing.py ROOT [--out FILE] [--label NAME]

ROOT is the directory holding the `point_cloud_donkey_tpu_torch` package
to time (this repository, or an unpacked copy of another commit), so two
checkouts compare in one call to the card: run parent, change, change,
parent.  The data come from this directory's `bench_data`: the bench
clouds (2048 points; normals r 0.25 at Q = N, keypoint LRFs r 0.5 at the
bench's 192 keypoints, the windowed normals at the window calibrated on
the batch) at B = 1, 8, 16, 24, 128, and the default.ism scenes of
detection (8192 points, x0.3; normals r 0.05 at Q = N, keypoint LRFs r
0.3 at the voxel-grid keypoints, leaf 0.2) at B = 1, 8, 16.  For each
(shape, B) it prints and writes one JSON row: CUDA-event ms over 20
launches, the profiler's device ms, the bound (chip_smoke.bound: bytes
and in-radius operations of this input), K1's and K2's largest error
against their plain twins, and the sha256 of cloud 0's K1 moments at its
real queries, which is the same at every B when a cloud's sums do not
depend on its batch.
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_B = (1, 8, 16, 24, 128)
SCENE_B = (1, 8, 16)


def _sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _keypoints(pts, mask, leaf, voxel_grid, torch):
    """The voxel-grid keypoints at the detection's capacity rule: the
    largest voxel count of the batch rounded up to a multiple of 64."""
    import numpy as np
    counts = []
    for p, m in zip(pts.cpu().numpy(), mask.cpu().numpy()):
        counts.append(len(np.unique(np.floor(p[m] / leaf).astype(np.int64),
                                    axis=0)))
    cap = max(64, -(-max(counts) // 64) * 64)
    kres = voxel_grid(pts, mask, leaf, capacity=cap)
    kp = torch.where(kres.mask[..., None], kres.centroids,
                     torch.full_like(kres.centroids, 1e9)).contiguous()
    return kp, kres.mask


def measure(dev, label, bench_b=BENCH_B, scene_b=SCENE_B):
    """The rows of every (shape, B) on device `dev` (module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from bench_data import bench_clouds, detect_inputs
    from point_cloud_donkey_tpu_torch.ops import binned
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    rows = []

    def one(what, b, pts, mask, queries, q_mask, radius, z_only,
            plan=None):
        q, p = klrf.prep_shift(queries, pts, mask)
        if plan is None:
            def k1(plain=False):
                f = klrf.moments_plain if plain else klrf.moments
                return f(q, p, mask, radius)

            def k2(axes, plain=False):
                f = klrf.sign_votes_plain if plain else klrf.sign_votes
                return f(q, p, mask, axes, radius, z_only)
            extra = ()
        else:
            w, starts = plan

            def k1(plain=False):
                f = (klrf.moments_windowed_plain if plain
                     else klrf.moments_windowed)
                return f(q, p, mask, starts, w, radius)

            def k2(axes, plain=False):
                f = (klrf.sign_votes_windowed_plain if plain
                     else klrf.sign_votes_windowed)
                return f(q, p, mask, axes, starts, w, radius, z_only)
            extra = (starts,)
        mom, cnt = k1()
        pm, pc = k1(plain=True)
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        votes = k2(axes)
        pv = k2(axes, plain=True)
        inside = int(cnt.sum())
        k1_ms = cs.cuda_ms(k1, 20)
        k2_ms = cs.cuda_ms(lambda: k2(axes), 20)
        k1_dev = cs.device_ms(k1, "MomentsBody", 20)
        k2_dev = cs.device_ms(lambda: k2(axes), "VotesBody", 20)
        b1, by1 = cs.bound(cs.nbytes(q, p, mask, mom, cnt, *extra),
                           inside * (cs.GATE_OPS + cs.MOMENT_BODY_OPS))
        b2, by2 = cs.bound(cs.nbytes(q, p, mask, axes, votes, *extra),
                           inside * (cs.GATE_OPS + cs.VOTE_BODY_OPS
                                     * (1 if z_only else 2)))
        row = {"label": label, "what": what, "B": b, "Q": q.shape[1],
               "N": p.shape[1], "window": None if plan is None else plan[0],
               "k1_ms": k1_ms, "k1_device_ms": k1_dev, "k1_bound_ms": b1,
               "k1_bound_by": by1,
               "k1_err": float((mom - pm).abs().max()),
               "k1_count_err": int((cnt - pc).abs().max()),
               "k2_ms": k2_ms, "k2_device_ms": k2_dev, "k2_bound_ms": b2,
               "k2_bound_by": by2,
               "k2_err": int((votes - pv).abs().max()),
               "k1_cloud0_sha": _sha(mom[0][q_mask[0]], cnt[0][q_mask[0]]),
               "k2_cloud0_sha": _sha(votes[0][q_mask[0]])}
        rows.append(row)
        dm = ["n/a" if x is None else f"{x:.4f}" for x in (k1_dev, k2_dev)]
        print(f"{label:10s} {what:22s} B={b:3d} Q={q.shape[1]:5d}: "
              f"K1 {k1_ms:.4f} ms (device {dm[0]}, bound {b1:.5f}), "
              f"K2 {k2_ms:.4f} ms (device {dm[1]}, bound {b2:.5f}); "
              f"errors {row['k1_err']:.3g} / {row['k2_err']}; "
              f"cloud 0 K1 {row['k1_cloud0_sha']}", flush=True)

    def tensors(clouds):
        p = torch.from_numpy(np.ascontiguousarray(clouds, np.float32)).to(dev)
        return p, torch.ones(p.shape[:2], dtype=torch.bool, device=dev)

    with torch.no_grad():
        allp, allm = tensors(bench_clouds(max(bench_b))[2])
        for b in bench_b:
            pts, mask = allp[:b].contiguous(), allm[:b].contiguous()
            one("bench normals", b, pts, mask, pts, mask, 0.25, True)
            kres = voxel_grid(pts, mask, 0.35, capacity=192)
            kp = torch.where(kres.mask[..., None], kres.centroids,
                             torch.full_like(kres.centroids, 1e9))
            one("bench keypoint LRF", b, pts, mask, kp.contiguous(),
                kres.mask, 0.5, False)
            w = binned.required_window(pts, mask, 0.25)
            srt = binned.sort_clouds_ex(pts, mask)
            plan = binned.window_starts(srt.keys, srt.mask, srt.keys, 0.25,
                                        w)
            if w < pts.shape[1] and bool(plan.exact):
                one("bench windowed normals", b, srt.points, srt.mask,
                    srt.points, srt.mask, 0.25, True, (w, plan.starts))
        allp, allm = tensors(detect_inputs("default")[0])
        for b in scene_b:
            pts, mask = allp[:b].contiguous(), allm[:b].contiguous()
            one("scene normals", b, pts, mask, pts, mask, 0.05, True)
            kp, kmask = _keypoints(pts, mask, 0.2, voxel_grid, torch)
            one("scene keypoint LRF", b, pts, mask, kp, kmask, 0.3, False)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, HERE, os.path.dirname(HERE)]
    import torch

    import chip_smoke as cs
    import point_cloud_donkey_tpu_torch as pkg
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        pkg.__file__))) == root, f"imported {pkg.__file__}, not {root}"
    if not torch.cuda.is_available():
        raise SystemExit("binned_timing: torch.cuda.is_available() is False")
    label = args.label or os.path.basename(root.rstrip("/"))
    rows = measure(torch.device("cuda:0"), label)
    # the windowed sweep's grid covers the plan windows of a CTA's
    # queries, so its bits follow the tiling: only the full sweeps count
    same = {}
    for r in rows:
        if r["window"] is None:
            same.setdefault(r["what"], set()).add(r["k1_cloud0_sha"])
    summary = {"label": label, "card": cs.gpu_name_and_power(),
               "cloud0_k1_same_at_every_B": {k: len(v) == 1
                                             for k, v in same.items()}}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
