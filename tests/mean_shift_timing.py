"""Time the mean-shift of one checkout of the port on an NVIDIA GPU, and
check that a group's maxima do not depend on the other groups of its
batch.

    python tests/mean_shift_timing.py ROOT [--out FILE] [--label NAME]

ROOT holds the `point_cloud_donkey_tpu_torch` package to time (this
repository, or an unpacked copy of another commit), so two checkouts
compare in one call to the card.  Two workloads, each timed over 3 runs
after a warm-up (CUDA-synchronised host clock):
  * ops/mean_shift seeds + mean_shift + estimate_density on seeded
    clustered votes at the detection step's shapes (IsmDetector, B = 32
    clouds x 5 classes, 256 seeds): V = 192 votes a group (KNN K = 1) and
    V = 12288 (Threshold's 64 codewords a keypoint), 100 iterations at
    most, and group 0 alone against its row of the batch;
  * where the checkout has it, models/voting.class_mean_shift_batch on
    the committed JAX votes of chip_smoke's phase-10 detections (default
    and quickstart), and the same for its first cloud alone: the sha256
    of cloud 0's maxima alone and in the batch.
"""

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _timed(fn, runs=3):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3, out


def _votes(g, v, seed, dev):
    """Seeded votes of g groups: 1-4 clusters a group, 0.05 spread."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    pos = np.empty((g, v, 3), np.float32)
    for i in range(g):
        centres = rng.uniform(-1, 1, (int(rng.integers(1, 5)), 3))
        pos[i] = centres[rng.integers(len(centres), size=v)] \
            + rng.normal(0, 0.05, (v, 3))
    w = rng.uniform(0.1, 1.0, (g, v)).astype(np.float32)
    valid = rng.uniform(size=(g, v)) < 0.8
    return (torch.from_numpy(pos).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(valid).to(dev))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, HERE, os.path.dirname(HERE)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from point_cloud_donkey_tpu_torch.ops import mean_shift as ms
    if not torch.cuda.is_available():
        raise SystemExit("mean_shift_timing: torch.cuda.is_available() is "
                         "False")
    dev = torch.device("cuda:0")
    label = args.label or os.path.basename(root.rstrip("/"))
    rows = []
    bw = 0.1
    for v, cap in ((192, 256), (12288, 256)):
        pos, w, valid = _votes(160, v, 0, dev)

        def run(g=160):
            p_, w_, v_ = pos[:g], w[:g], valid[:g]
            seeds, _, smask = ms.create_seeds(p_, w_, v_, ms.seeds_range(bw),
                                              cap)
            c, alive = ms.mean_shift(seeds, smask, p_, w_, v_, bw, 1e-3, 100)
            return c, ms.estimate_density(c, p_, w_, v_, bw), alive
        t, (c, dens, _) = _timed(run)
        c1, dens1, _ = run(1)
        same = bool(torch.equal(c[:1], c1) and torch.equal(dens[:1], dens1))
        rows.append({"label": label, "what": f"mean_shift G=160 V={v}",
                     "ms": t, "group0_alone_equals_batch": same})
        print(f"{label:8s} mean_shift G=160 V={v} S={cap}: {t:.3f} ms; group "
              f"0 alone equals its batch row: {same}", flush=True)
    try:
        from point_cloud_donkey_tpu_torch.models import voting
        from point_cloud_donkey_tpu_torch.models.ism import (
            ImplicitShapeModel, _voting_params)
    except ImportError:
        voting = None
    if voting is not None and hasattr(voting, "class_mean_shift_batch"):
        from bench_data import unpack_votes
        data = os.path.join(root, "point_cloud_donkey_tpu_torch", "data")
        with np.load(os.path.join(os.path.dirname(HERE),
                                  "point_cloud_donkey_tpu_torch", "data",
                                  "detect_reference.npz")) as z:
            ref = dict(z)
        for name in ("default", "quickstart"):
            ism = ImplicitShapeModel.load(
                os.path.join(data, f"{name}_model.ism"), device=dev)
            vp = _voting_params(ism.config.child("Voting"))
            pre = f"{name}_vote_"
            votes = unpack_votes({k[len(pre):]: a for k, a in ref.items()
                                  if k.startswith(pre)})
            items, owner = [], []
            for i, vt in enumerate(votes):
                for c in sorted(set(vt["class_id"].tolist())):
                    sel = vt["class_id"] == c
                    items.append((vt["position"][sel].astype(np.float32),
                                  vt["weight"][sel].astype(np.float32),
                                  voting.get_search_dist(
                                      int(c), vp, ism.state.dims_map)))
                    owner.append(i)
            t, res = _timed(lambda: voting.class_mean_shift_batch(items, vp,
                                                                  dev))
            first = [j for j, o in enumerate(owner) if o == 0]
            alone = voting.class_mean_shift_batch([items[j] for j in first],
                                                  vp, dev)

            def sha(rs):
                h = hashlib.sha256()
                for p, d in rs:
                    h.update(p.tobytes())
                    h.update(d.tobytes())
                return h.hexdigest()[:16]
            same = sha([res[j] for j in first]) == sha(alone)
            rows.append({"label": label, "what": f"class_mean_shift_batch "
                         f"{name}", "groups": len(items), "ms": t,
                         "cloud0_alone_equals_batch": same})
            print(f"{label:8s} class_mean_shift_batch {name} ({len(items)} "
                  f"groups): {t:.3f} ms; cloud 0 alone equals its batch "
                  f"rows: {same}", flush=True)
    summary = {"label": label, "card": cs.gpu_name_and_power()}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
