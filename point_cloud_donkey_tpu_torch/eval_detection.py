"""Detection evaluation CLI of the port (point_cloud_donkey_tpu/cli/
eval_detection.py; reference src/eval_tool/eval_detection.cpp,
eval_helpers_detection.h and logging_to_files.h).

    python -m point_cloud_donkey_tpu_torch.eval_detection -t config.ism \\
        -f train_list.txt -o model [--device cuda]
    python -m point_cloud_donkey_tpu_torch.eval_detection -d model.ism \\
        -f test_list.txt -o outdir [--device cuda]

Training takes labelled whole clouds (`# train detection [inst]`) or
scenes with annotation files (`# train detection boxes`: each annotated
box is cropped out as a model) and writes ``model.ism`` +
``model.ismd.npz`` (the JAX package's format).  Detection takes
`(cloud, annotation)` pairs (`# test detection`), runs
``ImplicitShapeModel.load`` + ``detect_batch`` on chunks of clouds,
matches the detections to the ground truth per class within the
per-class distance thresholds (ImplicitShapeModel.get_detection_threshold)
and writes, in the JAX CLI's formats, one detection log per cloud and
``summary.txt``: per-class precision, recall, AP and f-score (and their
global-classifier variants when the model verifies with global features)
and the dataset's pooled AP.  Runs on the card unless --device says
otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .models.ism import ImplicitShapeModel, preprocess_cloud
from .models.metrics import (DetectionObject, compute_all_metrics,
                             parse_annotation_file, precision_recall_curve,
                             rearrange_objects)
from .ops.geometry import BoundingBox
from .ops.lrf import lrf_version_from_env
from .utils.config import IsmConfig
from .utils.io import read_cloud

# clouds read and detected at a time
CHUNK = 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval_detection",
        description="ISM detection evaluation (PyTorch/CUDA)")
    p.add_argument("-t", "--train", help="input config file (training)")
    p.add_argument("-d", "--detect", help="trained ism file (detection)")
    p.add_argument("-f", "--file", dest="inputfile", required=True)
    p.add_argument("-o", "--output", help="output folder / model file")
    p.add_argument("-i", "--inplace", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu)")
    return p


def write_log_per_cloud(cloud_file: str, ism_file: str, gt_file: str,
                        out_path: str, maxima,
                        used_names: Optional[set] = None) -> None:
    """The detection log of one cloud, one line per maximum
    (logging_to_files.h:43-88); with `used_names`, a name already used gets
    a numeric suffix instead of overwriting a log."""
    base = os.path.basename(cloud_file)
    if used_names is not None:
        candidate, i = base, 1
        while candidate in used_names:
            candidate = f"{base}.{i}"
            i += 1
        used_names.add(candidate)
        base = candidate
    with open(os.path.join(out_path, base + ".txt"), "w") as f:
        f.write(f"ISM3D detection log, filename: {ism_file}, point cloud: "
                f"{cloud_file}, ground truth file: {gt_file}\n")
        f.write("number, classID, weight, instanceID, instance weight, "
                "num-votes, position X Y Z, bounding box size X Y Z, "
                "bounding Box rotation quaternion w x y z\n")
        for i, m in enumerate(maxima):
            pos = np.asarray(m.position, float)
            siz = np.asarray(m.bb_size, float)
            q = np.asarray(m.bb_quat, float)
            f.write(f"{i}, {m.class_id}, {m.weight:g}, {m.instance_id}, "
                    f"{m.instance_weight:g}, {m.num_votes}, "
                    f"{pos[0]:g}, {pos[1]:g}, {pos[2]:g}, "
                    f"{siz[0]:g}, {siz[1]:g}, {siz[2]:g}, "
                    f"{q[0]:g}, {q[1]:g}, {q[2]:g}, {q[3]:g}\n")


def parse_detection_list(path: str):
    """(mode, flag, rows) of a detection list: '# train|test detection
    [inst|boxes]', then (cloud, annotation) pairs for boxes and testing,
    (cloud, class[, instance]) rows otherwise
    (eval_helpers_detection.h:500-700)."""
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.split()]
    header = lines[0]
    if header[0] != "#" or len(header) < 3 or header[2] != "detection":
        raise ValueError(
            f"{path}: expected '# train|test detection [inst|boxes]'")
    flag = header[3] if len(header) > 3 else ""
    rows = [t for t in lines[1:] if not t[0].startswith("#")]
    return header[1], flag, rows


def run_training(args) -> int:
    ism_file = args.train or args.detect
    ism = ImplicitShapeModel(IsmConfig.load(ism_file), args.device,
                             lrf_version_from_env())
    mode, flag, rows = parse_detection_list(args.inputfile)
    if mode != "train":
        print("input file is not a training list", file=sys.stderr)
        return 1
    class_map: Dict[str, int] = {}
    instance_map: Dict[str, int] = {}
    inst2cls: Dict[int, int] = {}

    def conv(label, mapping):
        if label not in mapping:
            mapping[label] = len(mapping)
        return mapping[label]

    if flag == "boxes":
        for cloud_file, annot_file in rows:
            class_ids, inst_ids, boxes = [], [], []
            for o in parse_annotation_file(annot_file, cloud_file):
                cid = conv(o.class_label, class_map)
                iid = conv(o.instance_label, class_map)
                class_ids.append(cid)
                inst_ids.append(iid)
                inst2cls.setdefault(iid, cid)
                boxes.append(BoundingBox(
                    position=o.position, size=o.bb_extent,
                    quat=o.bb_quat / max(np.linalg.norm(o.bb_quat), 1e-12)))
            ism.add_training_models_with_boxes(cloud_file, class_ids,
                                               inst_ids, boxes)
    else:
        use_inst = flag == "inst"
        instance_primary = ism.root.get("InstanceLabelsPrimary", True)
        for row in rows:
            cid = conv(row[1], class_map)
            if use_inst:
                iid = conv(row[2], instance_map)
                inst2cls.setdefault(iid, cid)
                ism.add_training_model(row[0], iid if instance_primary
                                       else cid, iid)
            else:
                ism.add_training_model(row[0], cid, cid)
                inst2cls.setdefault(cid, cid)

    ism.train()
    ism.state.instance_to_class = inst2cls
    ism.label_maps = {
        "class": {str(v): k for k, v in class_map.items()},
        "instance": {str(v): k
                     for k, v in (instance_map or class_map).items()},
        "usage": "detection",
    }
    out = ism_file if args.inplace else (args.output or "")
    if not out:
        print("the trained ism is not saved", file=sys.stderr)
        return 1
    if not out.endswith(".ism"):
        out += ".ism"
    ism.save(out)
    return 0


def run_detection(args) -> int:
    ism_file = args.detect or args.train
    ism = ImplicitShapeModel.load(ism_file, args.device,
                                  lrf_version_from_env())
    mode, _, rows = parse_detection_list(args.inputfile)
    if mode != "test":
        print("input file is not a test list", file=sys.stderr)
        return 1
    label_maps = ism.label_maps or {}
    cls_rmap = {int(k): v for k, v in label_maps.get("class", {}).items()}
    inst_rmap = {int(k): v for k, v in label_maps.get("instance",
                                                      {}).items()} or cls_rmap
    inst2cls = ism.state.instance_to_class

    gt_objects: List[DetectionObject] = []
    det_objects: List[DetectionObject] = []
    wall0 = time.perf_counter()
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    log_names: set = set()
    flat: List[Tuple[str, str, List, Dict[str, float]]] = []
    times: Dict[str, float] = {}
    for c0 in range(0, len(rows), CHUNK):
        chunk_rows = rows[c0:c0 + CHUNK]
        clouds, nrms, rgbs = [], [], []
        for cloud_file, _ in chunk_rows:
            print(f"Processing file: {cloud_file}")
            cloud = preprocess_cloud(read_cloud(cloud_file).remove_nan(),
                                     ism.root, ism.device)
            clouds.append(cloud.xyz)
            nrms.append(cloud.normals if cloud.has_normals() else None)
            rgbs.append(cloud.rgb)
        for (cloud_file, gt_file), (maxima, times_i) in zip(
                chunk_rows, ism.detect_batch(clouds, nrms, rgbs)):
            flat.append((cloud_file, gt_file, maxima, times_i))

    for cloud_file, gt_file, maxima, times in flat:
        if args.output:
            write_log_per_cloud(cloud_file, ism_file, gt_file, args.output,
                                maxima, used_names=log_names)
        gt_objects.extend(parse_annotation_file(gt_file, cloud_file))
        for m in maxima:
            # convertMaxToObj (eval_helpers_detection.h:415-438)
            cid, gid, iid = m.class_id, m.glob_class_id, m.instance_id
            if label_maps.get("usage") == "INSTANCE_PRIMARY":
                cls_name = cls_rmap.get(inst2cls.get(cid, cid), str(cid))
                inst_name = inst_rmap.get(cid, str(cid))
                glob_name = cls_rmap.get(inst2cls.get(gid, gid), str(gid))
            else:
                cls_name = cls_rmap.get(cid, str(cid))
                inst_name = inst_rmap.get(iid, str(iid))
                glob_name = cls_rmap.get(gid, str(gid))
            det_objects.append(DetectionObject(
                class_label=cls_name, instance_label=inst_name,
                global_class_label=glob_name,
                position=np.asarray(m.position), confidence=m.weight,
                filepath=gt_file, cloud_filepath=cloud_file,
                bb_extent=np.asarray(m.bb_size),
                bb_quat=np.asarray(m.bb_quat)))
    wall = time.perf_counter() - wall0

    lines = summary_lines(ism, gt_objects, det_objects, cls_rmap, times,
                          wall)
    if args.output:
        with open(os.path.join(args.output, "summary.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines[-7:]))
    return 0


def summary_lines(ism, gt_objects, det_objects, cls_rmap, times, wall
                  ) -> List[str]:
    """summary.txt (logging_to_files.h:91-165), in the JAX CLI's format."""
    gt_map = rearrange_objects(gt_objects)
    det_map = rearrange_objects(det_objects)
    report_global = ism.config.child("Voting").get("UseGlobalFeatures",
                                                   False)
    det_map_global = rearrange_objects(det_objects, use_global=True) \
        if report_global else {}
    class_name_to_id = {v: k for k, v in cls_rmap.items()}
    thresholds = ism.get_detection_threshold()

    lines = ["  class       num gt   tp    fp   precision  recall   AP      "
             "f-score"]
    tps_per_class, fps_per_class = {}, {}
    num_gt_total = cum_tp = cum_fp = 0
    per_class, g_per_class = {}, {}
    for label in sorted(gt_map.keys()):
        gt_list = gt_map[label]
        cid = class_name_to_id.get(label, 0)
        thresh = thresholds.get(
            cid, ism.root.get("DistanceThresholdDetection", 0.05))
        p_, r_, ap, tp, fp, tpl, fpl = compute_all_metrics(
            gt_list, det_map.get(label, []), thresh)
        tps_per_class[label], fps_per_class[label] = tpl, fpl
        per_class[label] = (p_, r_, ap)
        num_gt_total += len(gt_list)
        cum_tp += tp
        cum_fp += fp
        f1 = 2 * p_ * r_ / (p_ + r_) if (p_ + r_) else 0.0
        line = (f"{cid:>3} {label:<12} {len(gt_list):>4} {tp:>5} {fp:>5} "
                f"{p_:>9.4f} {r_:>8.4f} {ap:>7.4f} {f1:>8.4f}")
        if report_global:
            gp, gr, gap, gtp, gfp, _, _ = compute_all_metrics(
                gt_list, det_map_global.get(label, []), thresh)
            g_per_class[label] = (gp, gr, gap)
            gf1 = 2 * gp * gr / (gp + gr) if (gp + gr) else 0.0
            line += (f"   | global {gtp:>4} {gfp:>5} {gp:>9.4f} {gr:>8.4f} "
                     f"{gap:>7.4f} {gf1:>8.4f}")
        lines.append(line)

    _, _, overall_ap = precision_recall_curve(det_map, gt_map,
                                              tps_per_class, fps_per_class)
    vals = list(per_class.values()) or [(0, 0, 0)]
    m_prec = float(np.mean([v[0] for v in vals]))
    m_rec = float(np.mean([v[1] for v in vals]))
    m_ap = float(np.mean([v[2] for v in vals]))
    fscore = 2 * m_prec * m_rec / (m_prec + m_rec) if (m_prec + m_rec) \
        else 0.0
    lines.append("-" * 69)
    lines.append(f"Overall: {num_gt_total:>11} {cum_tp:>5} {cum_fp:>5}")
    if report_global:
        gvals = list(g_per_class.values()) or [(0, 0, 0)]
        gp = float(np.mean([v[0] for v in gvals]))
        gr = float(np.mean([v[1] for v in gvals]))
        gap = float(np.mean([v[2] for v in gvals]))
        gfs = 2 * gp * gr / (gp + gr) if (gp + gr) else 0.0
        lines += ["", "global detector metrics:",
                  f"global mAP:            {gap:7.4f} ({gap*100:.2f} %)",
                  f"global mean precision: {gp:7.4f} ({gp*100:.2f} %)",
                  f"global mean recall:    {gr:7.4f} ({gr*100:.2f} %)",
                  f"global f-score:        {gfs:7.4f} ({gfs*100:.2f} %)"]
    lines += ["", "main metrics:",
              f"       mAP:            {m_ap:7.4f} ({m_ap*100:.2f} %)",
              f"       mean precision: {m_prec:7.4f} ({m_prec*100:.2f} %)",
              f"       mean recall:    {m_rec:7.4f} ({m_rec*100:.2f} %)",
              f"       f-score:        {fscore:7.4f} ({fscore*100:.2f} %)",
              f"overall AP (pooled):   {overall_ap:7.4f}", ""]
    time_sum = sum(v for k, v in times.items() if k != "complete")
    lines.append(f"complete time: {times.get('complete', 0.0):.6g} [s], "
                 f"sum all steps: {time_sum:.6g} [s]")
    lines.append(f"total processing time: {wall:.4f} seconds ")
    return lines


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mode, _, _ = parse_detection_list(args.inputfile)
    return (run_training if mode == "train" else run_detection)(args)


if __name__ == "__main__":
    sys.exit(main())
