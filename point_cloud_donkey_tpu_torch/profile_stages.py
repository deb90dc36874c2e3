"""Per-stage profile of the classify step of the port (the port of
point_cloud_donkey_tpu/cli/profile_stages.py).

    python -m point_cloud_donkey_tpu_torch.profile_stages [--batch 32] \\
        [-n 2048] [--rounds 8] [--descriptor SHOT|CSHOT|SHORT_SHOT] \\
        [--device cuda]

Runs ``IsmClassifier`` (models/pipeline.py) on a synthetic batch --
ellipsoid shells of N points with 1 cm noise, drawn from a fixed seed, as
the JAX tool draws them -- against the package's committed codebook of
the descriptor (data/*_codebook.ism), and prints one JSON line:
  * the mean ms of each stage of pipeline.STAGES over `rounds` steps, from
    CUDA events recorded between the stages (on the CPU: the host clock),
    their sum, the step's ms by events around it and the clouds/s;
  * one step under ``torch.profiler`` (CUDA activity): the device time of
    its kernels and the device's busy share of the step (that time over
    the step's time by events), both readings of device time side by
    side, since the profiler has missed kernels of short steps before;
  * the keypoint occupancy of the batch;
  * the card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .models.codebook import CodebookParams, load_codebook
from .models.pipeline import STAGES, IsmClassifier, PipelineConfig
from .utils.config import IsmConfig

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CODEBOOKS = {"SHOT": "bench_codebook.ism", "CSHOT": "cshot_codebook.ism",
             "SHORT_SHOT": "short_shot_codebook.ism"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="profile_stages")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("-n", "--points", type=int, default=2048)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--descriptor", default="SHOT", choices=sorted(CODEBOOKS))
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu)")
    return p


def synthetic_batch(b: int, n: int, seed: int = 0):
    """(points [b, n, 3], colours [b, n, 3]): ellipsoid shells (axes 1.3,
    0.8, 0.5) with 1 cm gaussian noise, colours uniform in [0, 1]."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=2, keepdims=True)
    pts *= np.array([1.3, 0.8, 0.5], np.float32)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return pts, rng.uniform(size=(b, n, 3)).astype(np.float32)


def card_name_and_power() -> Optional[str]:
    """nvidia-smi's "name, power.limit" of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


class StageClock:
    """Marks of a step's stages: CUDA events on a card, the host clock on
    the CPU; ms() gives each stage's time and the step's."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: List = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        if self.cuda:
            out["step"] = self.marks[0][1].elapsed_time(self.marks[-1][1])
        else:
            out["step"] = (self.marks[-1][1] - self.marks[0][1]) * 1e3
        return out


def profile(model: IsmClassifier, pts: torch.Tensor, mask: torch.Tensor,
            rgb: Optional[torch.Tensor], rounds: int) -> dict:
    """The stage table, the profiled step and the clouds/s of `rounds`
    steps after a warm-up."""
    cuda = pts.device.type == "cuda"

    def step(clock: Optional[StageClock] = None):
        with torch.no_grad():
            if clock is not None:
                clock.mark("start")
            return model(pts, mask, rgb,
                         on_stage=clock.mark if clock else None)

    step()
    if cuda:
        torch.cuda.synchronize()
    sums = {name: 0.0 for name in STAGES + ("step",)}
    t0 = time.perf_counter()
    for _ in range(rounds):
        clock = StageClock(cuda)
        step(clock)
        for name, v in clock.ms().items():
            sums[name] += v
    wall = time.perf_counter() - t0
    res = {"stage_ms": {k: sums[k] / rounds for k in STAGES},
           "sum_stage_ms": sum(sums[k] for k in STAGES) / rounds,
           "step_ms_events": sums["step"] / rounds,
           "clouds_per_s": pts.shape[0] * rounds / wall}
    if cuda:
        from torch.profiler import ProfilerActivity, profile as tprofile
        clock = StageClock(True)
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            step(clock)
            torch.cuda.synchronize()
        step_ms = clock.ms()["step"]
        # self time: an op's device time already holds its kernels'
        dev_us = sum(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0)
                     for e in prof.key_averages())
        res["profiled_step_ms_events"] = step_ms
        res["device_ms_profiler"] = dev_us / 1e3
        res["device_busy_share"] = dev_us / 1e3 / step_ms if step_ms \
            else None
    else:
        res["device_ms_profiler"] = None
        res["device_busy_share"] = None
    return res


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    path = os.path.join(DATA, CODEBOOKS[args.descriptor])
    config = IsmConfig.load(path)
    codebook = load_codebook(path).to(device)
    cfg = PipelineConfig.from_ism(config, codebook.num_classes)
    model = IsmClassifier(codebook, cfg,
                          CodebookParams.from_config(config.child("Codebook")))
    pts_h, rgb_h = synthetic_batch(args.batch, args.points)
    pts = torch.from_numpy(pts_h).to(device)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=device)
    rgb = torch.from_numpy(rgb_h).to(device) if cfg.descriptor == "CSHOT" \
        else None
    res = {"descriptor": cfg.descriptor, "model": os.path.basename(path),
           "batch": args.batch, "points": args.points,
           "rounds": args.rounds, "device": str(device),
           "card": card_name_and_power() if device.type == "cuda" else None}
    res.update(profile(model, pts, mask, rgb, args.rounds))
    # keypoint occupancy: live keypoints over the step's capacity
    from .ops.voxel_grid import voxel_grid
    kp = voxel_grid(pts, mask, cfg.leaf_size, capacity=cfg.keypoint_capacity)
    res["keypoint_capacity"] = cfg.keypoint_capacity
    res["keypoint_occupancy"] = float(kp.mask.float().mean())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
