"""Classification evaluation CLI of the port (point_cloud_donkey_tpu/cli/
eval_classification.py; reference src/eval_tool/eval_classification.cpp).

    python -m point_cloud_donkey_tpu_torch.eval_classification -t config.ism \\
        -f train_list.txt -o model [--device cuda]
    python -m point_cloud_donkey_tpu_torch.eval_classification -d model.ism \\
        -f test_list.txt -o outdir [--fast] [--device cuda]

`-t` trains on a `# train [inst]` list and writes ``model.ism`` +
``model.ismd.npz`` (the JAX package's format) with the list's label maps.
`-d` classifies a `# test [inst]` list (or `-p` clouds with `-g` ground
truth) and writes ``summary.txt`` in the JAX CLI's format
(eval_classification.cpp:311-558): per file the ground truth and the
classified class (and the global classifier's where it differs), the
label maps, the stage times and the accuracy lines.  The host flow reads
and preprocesses FILE_CHUNK files at a time and classifies each by the
first maximum of ``ImplicitShapeModel.detect_batch``; `--fast` takes the
batched classify step (models/pipeline.classify_scores_instances, the JAX
`_fast_classify`) where the model allows it -- single-object mode with
BandwidthVotes, SHOT / CSHOT / SHORT_SHOT on VoxelGrid keypoints, no
global features, files without normals -- and otherwise falls back to the
host flow.  Runs on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .models.codebook import Codebook, CodebookParams
from .models.detect_batch import host_voxel_count
from .models.features import bucket_size
from .models.ism import DETECT_STAGES, ImplicitShapeModel, preprocess_cloud
from .models.pipeline import PipelineConfig, classify_scores_instances
from .ops.lrf import lrf_version_from_env
from .utils.config import IsmConfig
from .utils.io import FileList, parse_file_list, read_cloud

# files read and classified at a time on the host flow: host memory holds
# O(chunk) clouds; module-level so tests can shrink it
FILE_CHUNK = 256


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval_classification",
        description="ISM classification evaluation (PyTorch/CUDA)")
    p.add_argument("-t", "--train", help="input config file (training)")
    p.add_argument("-d", "--detect", help="trained ism file (classification)")
    p.add_argument("-f", "--file", dest="inputfile",
                   help="file list with a '# train|test [inst]' header")
    p.add_argument("-o", "--output", help="output folder / model file")
    p.add_argument("-i", "--inplace", action="store_true",
                   help="overwrite the loaded ism file after training")
    p.add_argument("-m", "--models", nargs="*", help="train: model files")
    p.add_argument("-c", "--classes", nargs="*", type=int,
                   help="train: class ids of the -m models")
    p.add_argument("-p", "--pointclouds", nargs="*",
                   help="test: clouds (instead of -f)")
    p.add_argument("-g", "--groundtruth", nargs="*", type=int,
                   help="test: ground-truth class ids of the -p clouds")
    p.add_argument("--fast", action="store_true",
                   help="the batched classify step where the model allows "
                        "it (same argmax decisions as the host flow)")
    p.add_argument("--fast-batch", type=int, default=32,
                   help="clouds per step with --fast")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu)")
    return p


def resolve_labels(fl: FileList, instance_primary: bool):
    """(usage, training labels, instance labels) (eval_helpers.h:46-61,
    eval_classification.cpp:126-136)."""
    if not fl.using_instances:
        return "CLASS_ONLY", fl.class_labels, fl.class_labels
    if instance_primary:
        return "INSTANCE_PRIMARY", fl.instance_labels, fl.instance_labels
    return "CLASS_PRIMARY", fl.class_labels, fl.instance_labels


def run_training(args) -> int:
    ism_file = args.train or args.detect
    ism = ImplicitShapeModel(IsmConfig.load(ism_file), args.device,
                             lrf_version_from_env())
    fl = None
    if args.inputfile:
        fl = parse_file_list(args.inputfile)
        usage, class_ids, instance_ids = resolve_labels(
            fl, ism.root.get("InstanceLabelsPrimary", True))
        files = fl.filenames
    elif args.models and args.classes:
        files, class_ids, instance_ids = args.models, args.classes, \
            args.classes
    else:
        print("no training input given", file=sys.stderr)
        return 1
    for f, c, i in zip(files, class_ids, instance_ids):
        ism.add_training_model(f, c, i)
    ism.train()
    if fl is not None:
        ism.state.instance_to_class = dict(fl.instance_to_class)
        ism.label_maps = {
            "class": {str(v): k for k, v in fl.class_map.items()},
            "instance": {str(v): k for k, v in fl.instance_map.items()},
            "usage": usage,
        }
    if args.inplace:
        ism.save(ism_file)
    elif args.output:
        out = args.output
        ism.save(out if out.endswith(".ism") else out + ".ism")
    else:
        print("the trained ism is not saved", file=sys.stderr)
        return 1
    return 0


def fast_classify(ism: ImplicitShapeModel, filenames: List[str],
                  batch_size: int):
    """The batched classify step over the file list (the JAX
    `_fast_classify`): (results, times) with results[i] = (class id,
    global class id, instance id), or None where the model is not
    eligible."""
    fcfg = ism.config.child("Features")
    kp_cfg = ism.config.child("Keypoints")
    vcfg = ism.config.child("Voting")
    descriptor = fcfg.type or "SHOT"
    if not (descriptor in ("SHOT", "SHORT_SHOT", "CSHOT")
            and (kp_cfg.type or "VoxelGrid") == "VoxelGrid"
            and vcfg.get("SingleObjectMode", False)
            # the fused step reproduces only the fixed-bandwidth centroid
            # query (voting_mean_shift.cpp:124-156)
            and vcfg.get("SingleObjectMaxType", "Default")
            == "BandwidthVotes"
            and not vcfg.get("UseGlobalFeatures", False)):
        return None
    t_all = time.perf_counter()
    clouds, rgbs = [], []
    for fn in filenames:
        pc = preprocess_cloud(read_cloud(fn).remove_nan(), ism.root,
                              ism.device)
        if pc.has_normals():
            # the step computes normals: a file's own would diverge from
            # the host flow
            return None
        clouds.append(pc.xyz)
        rgbs.append(pc.rgb)
    times = {k: 0.0 for k in DETECT_STAGES}
    if not clouds:
        return [], times
    with_rgb = descriptor == "CSHOT"
    if with_rgb and any(r is None for r in rgbs):
        return None
    n_bucket = bucket_size(max(len(c) for c in clouds), minimum=256)
    leaf = kp_cfg.get("LeafSize", 0.1)
    kp_cap = bucket_size(max(max(host_voxel_count(c, leaf) for c in clouds),
                             1), minimum=64)
    state_cb = ism.state.codebook
    cb = Codebook.from_numpy(state_cb._asdict()).to(ism.device)
    n_cls = int(np.asarray(state_cb.class_sigma).shape[0])
    vote_inst = np.asarray(state_cb.vote_instance)
    n_inst = int(vote_inst.max()) + 1 if vote_inst.size else 1
    cfg = PipelineConfig.from_ism(ism.config, n_cls,
                                  keypoint_capacity=kp_cap,
                                  lrf_version=ism.lrf_version)
    params = CodebookParams.from_config(ism.config.child("Codebook"))
    results = []
    t0 = time.perf_counter()
    for i0 in range(0, len(clouds), batch_size):
        chunk = clouds[i0:i0 + batch_size]
        b = len(chunk)
        pts = np.full((b, n_bucket, 3), 1e9, np.float32)
        msk = np.zeros((b, n_bucket), bool)
        rgb = np.zeros((b, n_bucket, 3), np.float32)
        for j, c in enumerate(chunk):
            pts[j, :len(c)] = c
            msk[j, :len(c)] = True
            if with_rgb:
                rgb[j, :len(c)] = rgbs[i0 + j]
        dev = ism.device
        with torch.no_grad():
            cls_s, inst_s = classify_scores_instances(
                torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev),
                cb, cfg, params, n_inst,
                rgb=torch.from_numpy(rgb).to(dev) if with_rgb else None)
        packed = torch.cat([cls_s, inst_s], 1).cpu().numpy()
        for j in range(b):
            c_s, i_s = packed[j, :n_cls], packed[j, n_cls:]
            cid = int(c_s.argmax()) if c_s.max() > 0 else -1
            iid = int(i_s.argmax()) if i_s.max() > 0 else -1
            results.append((cid, cid, iid))
    t_exec = time.perf_counter() - t0
    # the step has no stage boundaries: its time under "voting", the
    # host's preparation under "features" (as the JAX CLI reports them)
    times["complete"] = time.perf_counter() - t_all
    times["voting"] = t_exec
    times["features"] = times["complete"] - t_exec
    return results, times


def _test_file_list(args) -> FileList:
    """The `-f` list, or one built from `-p` / `-g`
    (eval_classification.cpp:52-63)."""
    if args.inputfile:
        return parse_file_list(args.inputfile)
    if args.pointclouds and args.groundtruth:
        if len(args.pointclouds) != len(args.groundtruth):
            raise SystemExit("-p and -g must have the same length")
        ids = [int(g) for g in args.groundtruth]
        return FileList(mode="test", filenames=list(args.pointclouds),
                        class_labels=ids, instance_labels=list(ids),
                        using_instances=False,
                        class_map={str(c): c for c in ids},
                        instance_map={str(c): c for c in ids},
                        instance_to_class={c: c for c in ids})
    raise SystemExit("no test input given: use -f, or -p with -g")


def host_classify(ism: ImplicitShapeModel, filenames: List[str]):
    """(the maxima of each file, the stage times): files read and
    preprocessed FILE_CHUNK at a time, each chunk one detect_batch."""
    strip_color = ism.root.get("SetColorToZero", False)
    maxima: List[list] = []
    times: Dict[str, float] = {}
    for lo in range(0, len(filenames), FILE_CHUNK):
        clouds, nrms, rgbs = [], [], []
        for path in filenames[lo:lo + FILE_CHUNK]:
            print(f"Processing file: {path}")
            pc = preprocess_cloud(read_cloud(path).remove_nan(), ism.root,
                                  ism.device)
            clouds.append(pc.xyz)
            nrms.append(pc.normals if pc.has_normals() else None)
            rgbs.append(None if strip_color else pc.rgb)
        for m, times_i in ism.detect_batch(clouds, nrms, rgbs):
            maxima.append(m)
            # the times are cumulative over the chunks: keep the last
            times = dict(times_i)
    return maxima, times


def run_classification(args) -> int:
    ism_file = args.detect or args.train
    ism = ImplicitShapeModel.load(ism_file, args.device,
                                  lrf_version_from_env())
    fl = _test_file_list(args)
    usage, _, _ = resolve_labels(fl,
                                 ism.root.get("InstanceLabelsPrimary", True))
    # the ground truth is in label space: classified instance ids are
    # mapped to classes below (eval_classification.cpp:293-309, :421-425)
    inst2cls = ism.state.instance_to_class or fl.instance_to_class
    wall0 = time.perf_counter()
    fast = fast_classify(ism, fl.filenames, args.fast_batch) \
        if args.fast else None
    if args.fast and fast is None:
        print("--fast: the model is not eligible for the batched step "
              "(needs SingleObjectMode with BandwidthVotes, SHOT / CSHOT / "
              "SHORT_SHOT on VoxelGrid keypoints, no global features); "
              "the host flow classifies", file=sys.stderr)
    if fast is not None:
        results, times = fast
    else:
        maxima_list, times = host_classify(ism, fl.filenames)
        results = [(m[0].class_id, m[0].glob_class_id, m[0].instance_id)
                   if m else (-1, -1, -1) for m in maxima_list]
    lines, acc, n_ok = summary_lines(
        fl, usage, inst2cls, results, times, time.perf_counter() - wall0)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "summary.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    else:
        print("no output file specified, detected maxima will not be saved",
              file=sys.stderr)
    print(f" Accuracy: {acc * 100.0:g} % ({n_ok}/{len(fl.filenames)})")
    return 0


def summary_lines(fl: FileList, usage: str, inst2cls: Dict[int, int],
                  results, times: Dict[str, float], wall: float):
    """(summary.txt's lines in the JAX CLI's format, accuracy, correct
    count)."""
    lines: List[str] = []
    n = len(fl.filenames)
    ok = ok_inst = ok_glob = both = only_glob = 0
    per_class: Dict[int, List[int]] = {}
    for path, true_cls, true_inst, (cid, gid, iid) in zip(
            fl.filenames, fl.class_labels, fl.instance_labels, results):
        if usage == "INSTANCE_PRIMARY":
            iid = cid
            cid = inst2cls.get(cid, -1)
            gid = inst2cls.get(gid, -1)
        line = (f"file: {path}, ground truth class: {true_cls}, "
                f"classified class: {cid}")
        if cid != gid:
            line += f", global class: {gid}"
        lines.append(line)
        hit = int(true_cls == cid)
        ok += hit
        per_class.setdefault(true_cls, [0, 0])
        per_class[true_cls][0] += hit
        per_class[true_cls][1] += 1
        ok_inst += int(true_inst == iid)
        ok_glob += int(true_cls == gid)
        both += int(true_cls == cid and true_cls == gid)
        only_glob += int(true_cls != cid and true_cls == gid)

    lines += ["", ""]
    if usage in ("CLASS_ONLY", "CLASS_PRIMARY"):
        lines.append("class id to class name mapping:")
        for lbl, c in sorted(fl.class_map.items(), key=lambda kv: kv[1]):
            lines.append(f"{c}: {lbl}")
    if usage == "INSTANCE_PRIMARY":
        # the reference prints the class map under this header
        # (eval_classification.cpp:496-501)
        lines.append("instance id to instance name mapping (used as "
                     "primary labels, i.e. classes):")
        for lbl, c in sorted(fl.class_map.items(), key=lambda kv: kv[1]):
            lines.append(f"{c}: {lbl}")
        lines += ["", "instance id to class id mapping:"]
        for i, c in sorted(inst2cls.items()):
            lines.append(f"{i}: {c}")
    if usage == "CLASS_PRIMARY":
        lines += ["", "instance id to instance name mapping:"]
        for lbl, i in sorted(fl.instance_map.items(), key=lambda kv: kv[1]):
            lines.append(f"{i}: {lbl}")

    time_sum = sum(v for k, v in times.items() if k != "complete")
    lines += ["", "", "",
              f"complete time: {times.get('complete', 0.0):.6g} [s], "
              f"sum all steps: {time_sum:.6g} [s]", "times per step:"]
    for label, key in [("create flann index: ", "flann"),
                       ("compute normals:    ", "normals"),
                       ("compute keypoints:  ", "keypoints"),
                       ("compute features:   ", "features"),
                       ("cast votes:         ", "voting"),
                       ("find maxima:        ", "maxima")]:
        lines.append(f"{label}{times.get(key, 0.0):10.6g} [s]")

    def pct(k: int) -> float:
        return k / n * 100.0 if n else 0.0

    avg_pc = float(np.mean([c / t for c, t in per_class.values()])) \
        if per_class else 0.0
    acc = ok / n if n else 0.0
    lines += ["", "",
              f" Accuracy: {acc * 100.0:g} %, Average per Class Accuracy: "
              f"{avg_pc * 100.0:g} %", "",
              f" result: {ok} of {n} clouds classified correctly "
              f"({acc * 100.0:g} %)",
              f" result: {ok_inst} of {n} instances recognized correctly "
              f"({pct(ok_inst):g} %)",
              f" result: {ok_glob} of {n} clouds classified correctly with "
              f"global descriptors ({pct(ok_glob):g} %)", "",
              f" both correct: {both} ({pct(both):g} %)",
              f" only global correct: {only_glob} ({pct(only_glob):g} %)",
              "", "", f" Total processing time: {wall:.4f} seconds "]
    return lines, acc, ok


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    mode = ""
    if args.inputfile:
        with open(args.inputfile) as f:
            header = f.readline().split()
        if len(header) >= 2 and header[0] == "#":
            mode = header[1]
        if len(header) >= 3 and header[2] == "detection":
            print("ERROR: You are using a detection data set with the "
                  "classification eval_tool! Use 'eval_detection' instead.",
                  file=sys.stderr)
            return 1
    if (args.train and mode == "") or mode == "train":
        return run_training(args)
    if (args.detect and mode == "") or mode == "test":
        return run_classification(args)
    print("specify either -t (train) or -d (detect) with a matching file "
          "list", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
