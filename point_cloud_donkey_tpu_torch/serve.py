"""Batched classification CLI of the port: classify a '# test' file list
with a trained model through IsmClassifier, or with --maxima through the
mean-shift detection step IsmDetector, printing each cloud's best maximum
of its predicted class (the PyTorch counterpart of
point_cloud_donkey_tpu/cli/serve.py without mesh or AOT).

    python -m point_cloud_donkey_tpu_torch.serve -d model.ism -f list.txt \\
        --device cuda [--maxima]

The model is the JAX package's save format: ``model.ism`` (JSON config)
beside ``model.ismd.npz`` (trained arrays).  A SHOT, CSHOT or SHORT_SHOT
model classifies; a CSHOT model reads each file's colours and refuses a
file without them.  --maxima serves SHOT and SHORT_SHOT models (CSHOT is
refused, as by the JAX CLI: its detection step passes no colours).  PCD_PALLAS_LRF_V=2
selects the v2 LRF kernels (K10, K11), as it does for the JAX package.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .models.codebook import CodebookParams, load_codebook
from .models.pipeline import IsmClassifier, IsmDetector, PipelineConfig
from .ops.lrf import lrf_version_from_env
from .utils.config import IsmConfig
from .utils.io import parse_file_list, read_cloud


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="serve", description="Batched classification (PyTorch/CUDA)")
    p.add_argument("-d", "--detect", required=True, help="trained .ism model")
    p.add_argument("-f", "--file", required=True, help="'# test' file list")
    p.add_argument("--batch", type=int, default=16, help="clouds per step")
    p.add_argument("--points", type=int, default=2048,
                   help="pad/subsample clouds to this many points")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--maxima", action="store_true",
                   help="run the mean-shift detection step and print each "
                        "cloud's best maximum position of its predicted "
                        "class")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    device = torch.device(args.device)

    config = IsmConfig.load(args.detect)
    codebook = load_codebook(args.detect).to(device)
    cfg = PipelineConfig.from_ism(config, codebook.num_classes,
                                  lrf_version=lrf_version_from_env())
    params = CodebookParams.from_config(config.child("Codebook"))
    if args.maxima and cfg.descriptor == "CSHOT":
        # the JAX CLI refuses CSHOT here: its detection step reads no colours
        print(f"--maxima does not support {cfg.descriptor} yet",
              file=sys.stderr)
        return 1
    model = (IsmDetector if args.maxima else IsmClassifier)(codebook, cfg,
                                                            params)

    fl = parse_file_list(args.file)
    labels = fl.instance_labels if fl.using_instances else fl.class_labels

    # load + pad/subsample all clouds to a fixed shape; pad rows carry
    # zero colours
    with_rgb = cfg.descriptor == "CSHOT"
    P = args.points
    clouds, masks, rgbs = [], [], []
    for fn in fl.filenames:
        pc = read_cloud(fn)
        keep = np.isfinite(pc.xyz).all(axis=1)
        xyz, rgb = pc.xyz[keep], None if pc.rgb is None else pc.rgb[keep]
        if with_rgb and rgb is None:
            print(f"{fn}: CSHOT needs RGB data", file=sys.stderr)
            return 1
        if len(xyz) > P:
            sel = np.random.default_rng(0).choice(len(xyz), P, replace=False)
            xyz = xyz[sel]
            rgb = None if rgb is None else rgb[sel]
        pad = np.full((P, 3), 1e9, np.float32)
        pad[:len(xyz)] = xyz
        clouds.append(pad)
        m = np.zeros(P, bool)
        m[:len(xyz)] = True
        masks.append(m)
        if with_rgb:
            rp = np.zeros((P, 3), np.float32)
            rp[:len(xyz)] = rgb
            rgbs.append(rp)
    n = len(clouds)
    clouds_t = torch.from_numpy(np.stack(clouds)).to(device)
    masks_t = torch.from_numpy(np.stack(masks)).to(device)
    rgbs_t = torch.from_numpy(np.stack(rgbs)).to(device) if with_rgb else None

    B = args.batch

    def call(i):
        """Per-class scores [b, C] (the densities with --maxima) and, with
        --maxima, the positions [b, C, 3]."""
        with torch.no_grad():
            if args.maxima:
                return model(clouds_t[i:i + B], masks_t[i:i + B])
            rgb_b = None if rgbs_t is None else rgbs_t[i:i + B]
            return model(clouds_t[i:i + B], masks_t[i:i + B], rgb_b), None

    # first result: kernel build (first run) + first batch, fetched
    call(0)[0].cpu()
    ttfr = time.perf_counter() - t_start
    print(f" Time to first result: {ttfr:.1f} s (eager)")

    preds, maxima = [], []
    t0 = time.perf_counter()
    for i in range(0, n, B):
        scores, pos = call(i)
        best = scores.argmax(dim=1)
        preds.extend(best.tolist())
        if args.maxima:
            maxima.extend(pos[torch.arange(len(best)), best].tolist())
    dt = time.perf_counter() - t0

    correct = sum(int(pr == gt) for pr, gt in zip(preds, labels))
    for k, (fn, pr, gt) in enumerate(zip(fl.filenames, preds, labels)):
        extra = ""
        if args.maxima:
            x, y, z = maxima[k]
            extra = f" maximum ({x:.3f} {y:.3f} {z:.3f})"
        print(f"{fn}: predicted {pr}, ground truth {gt} "
              f"{'OK' if pr == gt else 'WRONG'}{extra}")
    print(f"\n Accuracy: {100.0 * correct / max(n, 1):.0f} % ({correct}/{n})")
    print(f" Throughput: {n / dt:.1f} clouds/sec on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
