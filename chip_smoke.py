#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (point_cloud_donkey_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and agrees
with the JAX reference on the card.

    python3 chip_smoke.py        # from the repo root; needs a GPU and nvcc

Phases (each prints its results; any failure raises and exits nonzero):
  1. environment and the nvcc build of csrc/*.cu;
  2. each kernel against its plain PyTorch twin on the card, at the shapes
     the classification step gives it on the 128-cloud bench batch, timed;
  3. LRF frames and SHOT descriptors against tests/golden/descriptors.npz;
  4. the slice: IsmClassifier on the 128 x 2048 bench batch with the
     committed codebook -- per-stage ms, clouds/s, every kernel launched,
     decisions against the committed JAX-CPU reference;
  5. the serve entry point on 8 PCD files with --device cuda.
Before the last line it prints one JSON line with every kernel's launches,
error against its twin and times, then the card's name and power limit.
The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

BATCH = 128
ROUNDS = 8
HERE = os.path.dirname(os.path.abspath(__file__))

# kernel -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "lrf_moments": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
                    "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:94"),
    "sign_votes": ("point_cloud_donkey_tpu_torch/csrc/lrf_moments.cu",
                   "point_cloud_donkey_tpu/ops/pallas/lrf_moments.py:312"),
    "shot_fused": ("point_cloud_donkey_tpu_torch/csrc/shot_fused.cu",
                   "point_cloud_donkey_tpu/ops/pallas/shot_fused.py:395"),
    "chisq_topk": ("point_cloud_donkey_tpu_torch/csrc/chisq.cu",
                   "point_cloud_donkey_tpu/ops/pallas/chisq.py:48"),
}


def phase(name):
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn over reps calls after one warm-up, from CUDA
    events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's kernels need an NVIDIA GPU")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np

    from bench_data import KEYPOINT_CAPACITY, bench_clouds
    from point_cloud_donkey_tpu_torch import serve
    from point_cloud_donkey_tpu_torch.kernels import build
    from point_cloud_donkey_tpu_torch.models.codebook import (
        CodebookParams, load_codebook)
    from point_cloud_donkey_tpu_torch.models.pipeline import (
        STAGES, IsmClassifier, PipelineConfig)
    from point_cloud_donkey_tpu_torch.ops.eigh3 import eigh3x3
    from point_cloud_donkey_tpu_torch.ops.kernels import chisq as kchisq
    from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as klrf
    from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as kshot
    from point_cloud_donkey_tpu_torch.ops.lrf import shot_lrf
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals_fast
    from point_cloud_donkey_tpu_torch.ops.shot import normalize_descriptors
    from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    from point_cloud_donkey_tpu_torch.utils.io import save_pcd

    dev = torch.device("cuda:0")
    card = gpu_name_and_power()
    data = os.path.join(HERE, "point_cloud_donkey_tpu_torch", "data")
    model_path = os.path.join(data, "bench_codebook.ism")
    ref = np.load(os.path.join(data, "bench_reference.npz"))

    # -- 1. environment + build ------------------------------------------
    phase("1. environment and build")
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc_ver.splitlines()[-1]}")
    print(f"card: {card}; {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.lib()
    print(f"built {os.path.relpath(lib_path, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 2. kernels vs plain twins at the main path's shapes -------------
    phase(f"2. kernels vs plain twins on the card ({card})")
    _, _, clouds, labels = bench_clouds(BATCH)
    pts = torch.from_numpy(clouds).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    config = IsmConfig.load(model_path)
    codebook = load_codebook(model_path).to(dev)
    cfg = PipelineConfig.from_ism(config, codebook.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY)
    report = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
              for name in KERNELS}

    def record(name, err, ms, plain_ms, what):
        r = report[name]
        r["err"] = max(r["err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        print(f"{name:12s} {what:34s} max|kernel-plain| {float(err):.3e}  "
              f"kernel {ms:8.3f} ms  plain {plain_ms:9.3f} ms")

    def lrf_pair(queries, q_mask, radius, z_only, what):
        """K1 and K2 at one main-path call: moments rtol 2e-4 and counts
        +-1, sign votes +-1."""
        q, p = klrf.prep_shift(queries, pts, mask)
        mom, cnt = klrf.moments(q, p, mask, radius)
        pmom, pcnt = klrf.moments_plain(q, p, mask, radius)
        s0, ps0 = mom[..., 0], pmom[..., 0]
        rel = ((s0 - ps0).abs() / ps0.abs().clamp(min=1e-6)).max()
        assert rel <= 2e-4, f"K1 weight sums off by rtol {rel:.2e} ({what})"
        assert (cnt - pcnt).abs().max() <= 1, f"K1 counts ({what})"
        cov, _ = klrf.cov_from_moments(mom, q, q_mask)
        pcov, _ = klrf.cov_from_moments(pmom, q, q_mask)
        cerr = (cov - pcov).abs().max()
        assert cerr <= 5e-4, f"K1 covariance off by {cerr:.2e} ({what})"
        record("lrf_moments", (mom - pmom).abs().max(),
               cuda_ms(lambda: klrf.moments(q, p, mask, radius), 5),
               cuda_ms(lambda: klrf.moments_plain(q, p, mask, radius), 2),
               what)
        _, vecs = eigh3x3(cov)
        axes = torch.cat([vecs[..., :, 2], vecs[..., :, 0]], -1).contiguous()
        v = klrf.sign_votes(q, p, mask, axes, radius, z_only)
        pv = klrf.sign_votes_plain(q, p, mask, axes, radius, z_only)
        err = (v - pv).abs().max()
        assert err <= 1, f"K2 votes off by {err} ({what})"
        record("sign_votes", err,
               cuda_ms(lambda: klrf.sign_votes(q, p, mask, axes, radius,
                                               z_only), 5),
               cuda_ms(lambda: klrf.sign_votes_plain(q, p, mask, axes,
                                                     radius, z_only), 2),
               what)

    with torch.no_grad():
        lrf_pair(pts, mask, cfg.normal_radius, True,
                 f"normals B={BATCH} Q=N={pts.shape[1]}")
        normals = compute_normals_fast(pts, mask, cfg.normal_radius)
        kres = voxel_grid(pts, mask, cfg.leaf_size,
                          capacity=cfg.keypoint_capacity)
        kp = torch.where(kres.mask[..., None], kres.centroids,
                         torch.full_like(kres.centroids, 1e9))
        lrf_pair(kp, kres.mask, cfg.ref_frame_radius, False,
                 f"keypoint LRF B={BATCH} Q={kp.shape[1]}")
        lrf = shot_lrf(kp, kres.mask, pts, mask, cfg.ref_frame_radius)

        gidx, alive, tile_cloud = kshot.compact_layout(kres.mask)
        kp_rows = torch.where(alive[:, None], kp.reshape(-1, 3)[gidx],
                              torch.full((1, 3), 1e9, device=dev))
        fr_rows = lrf.frames.reshape(-1, 3, 3)[gidx].contiguous()
        fv_rows = lrf.valid.reshape(-1)[gidx] & alive
        shot_args = (kp_rows, fr_rows, tile_cloud, pts, normals, mask,
                     cfg.radius)
        hist, cnt = kshot.shot_tiles(*shot_args)
        phist, pcnt = kshot.shot_tiles_plain(*shot_args)
        assert torch.equal(cnt, pcnt), "K3 in-radius counts differ"
        got = normalize_descriptors(hist, cnt, fv_rows)
        want = normalize_descriptors(phist, pcnt, fv_rows)
        assert torch.equal(got.valid, want.valid), "K3 validity differs"
        both = got.valid & want.valid
        cos = (got.descriptors[both] * want.descriptors[both]).sum(-1)
        off = ((got.descriptors[both] - want.descriptors[both]).abs()
               > 1e-3).float().mean()
        assert cos.min() > 0.999 and off < 1e-4, (cos.min(), off)
        record("shot_fused", (hist - phist).abs().max(),
               cuda_ms(lambda: kshot.shot_tiles(*shot_args), 5),
               cuda_ms(lambda: kshot.shot_tiles_plain(*shot_args), 2),
               f"SHOT {tile_cloud.shape[0]} tiles x N={pts.shape[1]}")

        desc = got.descriptors[got.valid].contiguous()
        cw, cw_mask = codebook.codewords, codebook.cw_mask
        for k in (1, 3):
            d, i = kchisq.chisq_topk(desc, cw, cw_mask, k)
            pd, pi = kchisq.chisq_topk_plain(desc, cw, cw_mask, k)
            rel = ((d - pd).abs() / pd.abs().clamp(min=1e-6)).max()
            assert rel <= 1e-5, f"K4 distances off by rtol {rel:.2e}"
            differ = i != pi
            assert torch.allclose(d[differ], pd[differ], rtol=1e-5), \
                "K4 indices differ beyond ties"
            ms = cuda_ms(lambda: kchisq.chisq_topk(desc, cw, cw_mask, k), 5)
            pms = cuda_ms(lambda: kchisq.chisq_topk_plain(desc, cw, cw_mask,
                                                          k), 2)
            what = f"chisq Q={desc.shape[0]} C={cw.shape[0]} D=352 k={k}"
            if k == 1:    # the main path's k
                record("chisq_topk", (d - pd).abs().max(), ms, pms, what)
            else:
                print(f"{'chisq_topk':12s} {what:34s} max|kernel-plain| "
                      f"{float((d - pd).abs().max()):.3e}  kernel "
                      f"{ms:8.3f} ms  plain {pms:9.3f} ms")

    # -- 3. goldens ---------------------------------------------------------
    phase("3. goldens (tests/golden/descriptors.npz, atol 2e-3)")
    g = np.load(os.path.join(HERE, "tests", "golden", "descriptors.npz"))
    gp = torch.from_numpy(g["points"]).to(dev)
    gn = torch.from_numpy(g["normals"]).to(dev)
    gk = torch.from_numpy(g["keypoints"]).to(dev)
    ones_p = torch.ones(len(gp), dtype=torch.bool, device=dev)
    ones_k = torch.ones(len(gk), dtype=torch.bool, device=dev)
    with torch.no_grad():
        res = shot_lrf(gk, ones_k, gp, ones_p, 0.6)
        assert bool(res.valid.all())
        ferr = np.abs(res.frames.cpu().numpy() - g["frames"]).max()
        assert ferr <= 2e-3, f"golden frames off by {ferr}"
        rows = kshot.TK
        kp8 = torch.full((rows, 3), 1e9, device=dev)
        kp8[:len(gk)] = gk
        fr8 = torch.eye(3, device=dev).repeat(rows, 1, 1)
        fr8[:len(gk)] = torch.from_numpy(g["frames"].astype(np.float32)).to(dev)
        h, c = kshot.shot_tiles(kp8, fr8.contiguous(),
                                torch.zeros(1, dtype=torch.int32, device=dev),
                                gp[None], gn[None], ones_p[None], 0.6)
        gd = normalize_descriptors(h, c, torch.ones(rows, dtype=torch.bool,
                                                    device=dev))
        assert bool(gd.valid[:len(gk)].all())
        serr = np.abs(gd.descriptors[:len(gk)].cpu().numpy()
                      - g["shot"]).max()
        assert serr <= 2e-3, f"golden SHOT off by {serr}"
    print(f"frames max err {ferr:.2e}, SHOT (K3) max err {serr:.2e}")

    # -- 4. the slice ---------------------------------------------------------
    phase(f"4. slice: IsmClassifier, B={BATCH} x N={pts.shape[1]} ({card})")
    model = IsmClassifier(codebook, cfg,
                          CodebookParams.from_config(config.child("Codebook")))
    assert np.array_equal(clouds[:len(ref["points"])], ref["points"]), \
        "bench batch differs from the committed reference clouds"
    with torch.no_grad():
        model(pts, mask)                                  # warm-up
        torch.cuda.synchronize()
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        build.reset_launch_counts()
        events["start"].record()
        scores = model(pts, mask, on_stage=mark)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        prev, stage_ms = "start", {}
        for name in STAGES:
            stage_ms[name] = events[prev].elapsed_time(events[name])
            prev = name
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            scores = model(pts, mask)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print("stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f" (sum {sum(stage_ms.values()):.3f})")
    print(f"throughput: {BATCH * ROUNDS / dt:.1f} clouds/s over {ROUNDS} "
          f"rounds of {BATCH} clouds ({card})")
    print(f"launches in one step: {launches}")
    missing = [k for k in KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched by the main path: {missing}"
    s = scores.cpu().numpy()
    assert s.shape == (BATCH, cfg.num_classes) and np.isfinite(s).all()
    acc = float((s.argmax(1) == labels).mean())
    rs = ref["scores"]
    srt = np.sort(rs, axis=1)
    firm = srt[:, -1] - srt[:, -2] > 3.0
    sub = s[:len(rs)]
    agree = sub.argmax(1)[firm] == rs.argmax(1)[firm]
    rms = float(np.sqrt(((sub - rs) ** 2).mean()))
    scale = float(np.abs(rs).max())
    print(f"accuracy vs labels {acc:.4f} on {BATCH} clouds; vs JAX-CPU "
          f"reference: argmax agrees on {int(agree.sum())}/{int(firm.sum())} "
          f"firm clouds, score rms delta {rms:.3e} (scale {scale:.2f}, "
          f"{100 * rms / scale:.4f}%)")
    assert agree.all() and rms <= 0.05 * scale, "decisions differ from JAX"

    # -- 5. serve -------------------------------------------------------------
    phase("5. serve --device cuda on 8 PCD files")
    tmp = tempfile.mkdtemp(prefix="pcd_smoke_")
    try:
        shutil.copy(model_path, os.path.join(tmp, "model.ism"))
        shutil.copy(model_path + "d.npz", os.path.join(tmp, "model.ismd.npz"))
        lines = ["# test"]
        for i in range(8):
            path = os.path.join(tmp, f"c{i}.pcd")
            save_pcd(path, ref["points"][i])
            lines.append(f"{path} {ref['labels'][i]}")
        flist = os.path.join(tmp, "test.txt")
        with open(flist, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["-d", os.path.join(tmp, "model.ism"), "-f", flist,
                             "--device", "cuda", "--batch", "8"])
    finally:
        shutil.rmtree(tmp)
    text = out.getvalue()
    print(text.rstrip())
    preds = re.findall(r": predicted (\d+), ground truth (\d+) ", text)
    ref_acc = 100.0 * (rs[:8].argmax(1) == ref["labels"][:8]).mean()
    assert rc == 0 and len(preds) == 8, "serve did not report 8 predictions"
    assert f" Accuracy: {ref_acc:.0f} % " in text, \
        f"serve accuracy differs from the reference {ref_acc:.0f} %"

    # -- results ----------------------------------------------------------------
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name],
                "max_abs_err": report[name]["err"],
                "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]}
               for name, (src, tpu) in KERNELS.items()]
    print()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
