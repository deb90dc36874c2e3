"""Read how far the port's detections lie from the JAX package's, over
the scenes of several seeds, with sound descriptors and with faulted
ones: the readings behind bench_data.FIRM_RTOL, FIRM_RTOL_HOUGH and
GLOBAL_RTOL_CARD.

    python tests/detect_limits.py [--device cuda|cpu] [--out FILE]

For chip_smoke.py's default.ism (CSHOT, SVM verification) and hough
(bench SHOT model, Hough3D + RANSAC + Merge) detections, on the scenes of
seed 7 (data/detect_reference.npz) and of each bench_data.LIMIT_SEEDS
seed (data/detect_limits_reference.npz), five ways:
  sound    -- the port as it is;
  bf16     -- every descriptor, local (before the activation) and global
              (each ROI's), rounded to bfloat16: a lower-precision one;
  noise2, noise10 -- every descriptor bin times (1 + p z), z standard
              normal (seeded), p = 2% and 10%: faulted ones, graded;
  roll     -- every descriptor's bins rolled by one: a broken one.
For each (way, seed, detection) it prints and writes one row: end to end,
the largest relative weight difference over the firm JAX maxima that a
maximum of the run matches (bench_data.firm_pairs) and how many find no
match; for default, the voting stage on the JAX votes (as phase 10 runs
it), the largest relative difference of the global (SVM) scores in rank
order and how many maxima lists differ in length.  Runs on the card
unless --device cpu.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WAYS = ("sound", "bf16", "noise2", "noise10", "roll")
NOISE = {"noise2": 0.02, "noise10": 0.1}


def _faults(way):
    """(local descriptor tensor -> tensor, global descriptor array ->
    array) of a way."""
    import numpy as np
    import torch
    if way == "sound":
        return (lambda d: d), (lambda d: d)
    if way == "bf16":
        def local(d):
            return d.to(torch.bfloat16).to(d.dtype)

        def glob(d):
            return local(torch.from_numpy(np.asarray(d))).numpy()
        return local, glob
    if way in NOISE:
        def local(d):
            gen = torch.Generator(device=d.device).manual_seed(0)
            z = torch.randn(d.shape, generator=gen, device=d.device,
                            dtype=d.dtype)
            return d * (1 + NOISE[way] * z)

        def glob(d):
            return local(torch.from_numpy(np.asarray(d))).numpy()
        return local, glob

    def local(d):
        return torch.roll(d, 1, dims=-1)

    def glob(d):
        return np.roll(np.asarray(d), 1, axis=-1)
    return local, glob


def readings(dev, ways=WAYS, seeds=None):
    """The rows (module docstring) on device `dev`."""
    import numpy as np

    from bench_data import (LIMIT_SEEDS, HOUGH_VOTING, detect_inputs,
                            firm_pairs, unpack_maxima, unpack_votes,
                            with_voting)
    from point_cloud_donkey_tpu_torch.models import ism as ism_mod
    from point_cloud_donkey_tpu_torch.models.codebook import CastVotes
    from point_cloud_donkey_tpu_torch.models.ism import (ImplicitShapeModel,
                                                         _voting_params)
    from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
    data = os.path.join(ROOT, "point_cloud_donkey_tpu_torch", "data")
    refs = {}
    with np.load(os.path.join(data, "detect_reference.npz")) as z:
        refs[7] = {k: v for k, v in z.items()}
    with np.load(os.path.join(data, "detect_limits_reference.npz")) as z:
        for seed in LIMIT_SEEDS:
            pre = f"s{seed}_"
            refs[seed] = {k[len(pre):]: v for k, v in z.items()
                          if k.startswith(pre)}
    seeds = seeds or (7,) + tuple(LIMIT_SEEDS)

    def model(name):
        if name == "hough":
            path = os.path.join(data, "bench_codebook.ism")
            ism = ImplicitShapeModel.load(path, device=dev)
            with open(path) as f:
                ism.config = IsmConfig.from_json(with_voting(json.load(f),
                                                             HOUGH_VOTING))
            return ism
        return ImplicitShapeModel.load(
            os.path.join(data, "default_model.ism"), device=dev)

    def part(ref, prefix):
        return {k[len(prefix):]: v for k, v in ref.items()
                if k.startswith(prefix)}

    rows = []
    real_cast = ism_mod.cast_votes
    real_global = ism_mod.extract_global_features
    try:
        for way in ways:
            local, glob = _faults(way)
            ism_mod.cast_votes = (lambda cb, desc, *a, _f=local, **k:
                                  real_cast(cb, _f(desc), *a, **k))
            ism_mod.extract_global_features = (
                lambda *a, _g=glob, **k: [fs._replace(descriptors=_g(
                    fs.descriptors)) for fs in real_global(*a, **k)])
            for name in ("default", "hough"):
                ism = model(name)
                bw = ism.config.child("Voting").get("Bandwidth", 0.1)
                for seed in seeds:
                    t0 = time.perf_counter()
                    clouds, rgbs = detect_inputs(name, seed)
                    want = unpack_maxima(part(refs[seed], f"{name}_max_"))
                    got = [m for m, _ in ism.detect_batch(
                        list(clouds), None,
                        None if rgbs is None else list(rgbs))]
                    rel, unmatched, firm = 0.0, 0, 0
                    for gs, ws in zip(got, want):
                        for _, w, g in firm_pairs(gs, ws, bw):
                            firm += 1
                            if g is None:
                                unmatched += 1
                                continue
                            ww = float(w["weight"])
                            rel = max(rel, abs(float(g.weight) - ww) / ww)
                    row = {"way": way, "seed": seed, "name": name,
                           "clouds": len(got), "firm": firm,
                           "firm_weight_rel_max": rel,
                           "firm_unmatched": unmatched}
                    if name == "default":
                        votes = [CastVotes(valid=np.ones(len(v["weight"]),
                                                         bool), **{
                            k: a.astype(np.int64 if k in ("class_id",
                                                          "instance_id")
                                        else np.float32)
                            for k, a in v.items()})
                            for v in unpack_votes(part(refs[seed],
                                                       f"{name}_vote_"))]
                        vp = _voting_params(ism.config.child("Voting"))
                        pre = ism._precompute_mean_shift_batch(votes, vp)
                        stage = [ism._finish_detect(
                            votes[i], clouds[i], None, rgbs[i], vp, None,
                            pre[i]) for i in range(len(votes))]
                        pairs = [(m.glob_class_weight,
                                  float(r["glob_class_weight"]))
                                 for g, w in zip(stage, want)
                                 if len(g) == len(w)
                                 for m, r in zip(g, w)
                                 if r["glob_class_weight"] > 0]
                        row["global_rel_max"] = max(
                            (abs(a - b) / b for a, b in pairs), default=0.0)
                        row["global_pairs"] = len(pairs)
                        row["stage_length_differs"] = sum(
                            len(g) != len(w) for g, w in zip(stage, want))
                    row["seconds"] = time.perf_counter() - t0
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    finally:
        ism_mod.cast_votes = real_cast
        ism_mod.extract_global_features = real_global
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, HERE]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("detect_limits: torch.cuda.is_available() is False")
    card = None
    if args.device == "cuda":
        import chip_smoke
        card = chip_smoke.gpu_name_and_power()
        print(card)
    rows = readings(torch.device(args.device))
    summary = {}
    for r in rows:
        s = summary.setdefault(f"{r['way']} {r['name']}", {
            "firm_weight_rel_max": 0.0, "firm_unmatched": 0})
        s["firm_weight_rel_max"] = max(s["firm_weight_rel_max"],
                                       r["firm_weight_rel_max"])
        s["firm_unmatched"] += r["firm_unmatched"]
        if "global_rel_max" in r:
            s["global_rel_max"] = max(s.get("global_rel_max", 0.0),
                                      r["global_rel_max"])
    print(json.dumps({"card": card, "summary": summary}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "summary": summary, "rows": rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
