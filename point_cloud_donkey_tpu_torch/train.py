"""Training CLI of the port: train an Implicit Shape Model from a '# train'
file list on the card and save it (the training half of
point_cloud_donkey_tpu/cli/eval_classification.py).

    python -m point_cloud_donkey_tpu_torch.train -t config.ism \\
        -f train_list.txt -o model [--device cuda]

writes ``model.ism`` (the config) and ``model.ismd.npz`` (the codebook), the
JAX package's format: ``serve`` and the JAX package's
``ImplicitShapeModel.load`` read them.  ``-m a.pcd b.pcd -c 0 1`` names the
models without a list; ``-i`` overwrites the config given with -t.
PCD_PALLAS_LRF_V=2 selects the v2 LRF kernels (K10, K11), as it does for
the JAX package.  A config that the fused extraction route cannot train
is refused with the reason.
"""

from __future__ import annotations

import argparse
import sys
import time

from .models.ism import ImplicitShapeModel
from .ops.lrf import lrf_version_from_env
from .utils.config import IsmConfig
from .utils.io import parse_file_list


def resolve_labels(fl, instance_primary: bool):
    """Label usage of a file list (eval_helpers.h:46-61): (usage, the
    labels the models train on, their instance labels)."""
    if not fl.using_instances:
        return "CLASS_ONLY", fl.class_labels, fl.class_labels
    if instance_primary:
        return "INSTANCE_PRIMARY", fl.instance_labels, fl.instance_labels
    return "CLASS_PRIMARY", fl.class_labels, fl.instance_labels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="train", description="ISM training (PyTorch/CUDA)")
    p.add_argument("-t", "--train", required=True, help="input .ism config")
    p.add_argument("-f", "--file", dest="inputfile",
                   help="'# train [inst]' file list")
    p.add_argument("-o", "--output", help="output model (.ism appended)")
    p.add_argument("-i", "--inplace", action="store_true",
                   help="overwrite the -t config with the trained model")
    p.add_argument("-m", "--models", nargs="*", help="model files")
    p.add_argument("-c", "--classes", nargs="*", type=int,
                   help="class ids of the -m models")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    ism = ImplicitShapeModel(IsmConfig.load(args.train), args.device,
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
    if not (args.inplace or args.output):
        print("the trained ism is not saved: give -o or -i", file=sys.stderr)
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
    out = args.train if args.inplace else args.output
    if not out.endswith(".ism"):
        out += ".ism"
    ism.save(out)
    times = ism.processing_times
    print(f"trained {len(files)} models into {out}: "
          f"{ism.state.codebook.num_codewords} codewords, "
          f"{time.perf_counter() - t_start:.1f} s on {ism.device}")
    print("stage s: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
