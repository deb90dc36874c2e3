"""The port's classification evaluation CLI
(point_cloud_donkey_tpu_torch/eval_classification.py) against the JAX
package's (cli/eval_classification.py) on small file lists, and the stage
profiler (profile_stages.py) on the CPU.

Contract: summary.txt's per-file lines (ground truth, classified class,
global class where it differs) and label maps equal the JAX CLI's, line
for line; only the times differ.  The JAX CLI runs in a subprocess
(tests/jax_jobs.py) with dense SHOT-family descriptors, as the JAX
package computes them on an accelerator and the port does everywhere."""

import copy
import io
import json
import os
import contextlib

import numpy as np
import pytest

import shapes
from bench_data import BENCH_CONFIG
from jax_jobs import JaxPool
from zoo_data import summary_labels

from point_cloud_donkey_tpu_torch import eval_classification as ec
from point_cloud_donkey_tpu_torch import profile_stages
from point_cloud_donkey_tpu_torch.models.pipeline import STAGES
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

NAMES = ("box", "sphere")


def cli_config(keypoints=None, features="SHOT") -> dict:
    cfg = copy.deepcopy(BENCH_CONFIG)
    ch = cfg["ObjectConfig"]["Children"]
    ch["Features"]["Type"] = features
    if keypoints:
        ch["Keypoints"] = keypoints
    return cfg


CONFIGS = {
    "harris_fpfh": cli_config({"Type": "Harris3D", "Parameters": {
        "Radius": 0.2, "Threshold": -1e9}}, "FPFH"),
    "shot_instances": cli_config(),
}


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Train and test lists of 4 1024-point clouds each (2 classes; with
    instance labels for shot_instances): {name: (train, test, dir)}."""
    root = tmp_path_factory.mktemp("eval_lists")
    rng = np.random.default_rng(17)
    clouds = {}
    for split in ("train", "test"):
        for i in range(4):
            pts = shapes.make_instance(rng, i % 2, n=1024,
                                       rotate=split == "test",
                                       noise=0.005).astype(np.float32)
            path = str(root / f"{split}{i}.pcd")
            save_pcd(path, pts)
            clouds.setdefault(split, []).append(path)
    out = {}
    for name in CONFIGS:
        inst = name == "shot_instances"
        files = {}
        for split, paths in clouds.items():
            head = f"# {split}" + (" inst" if inst else "")
            lines = [head] + [
                f"{p} {NAMES[i % 2]}" + (f" {NAMES[i % 2]}{i // 2}"
                                         if inst else "")
                for i, p in enumerate(paths)]
            files[split] = str(root / f"{name}_{split}.txt")
            with open(files[split], "w") as f:
                f.write("\n".join(lines) + "\n")
        work = root / name
        work.mkdir()
        out[name] = (files["train"], files["test"], str(work))
    return out


@pytest.fixture(scope="module")
def jax_summaries(lists):
    pool = JaxPool(2)
    jobs = {name: pool.call("zoo_jobs:eval_cli", cfg=CONFIGS[name],
                            train_list=lists[name][0],
                            test_list=lists[name][1], workdir=lists[name][2])
            for name in CONFIGS}
    yield jobs
    pool.close()


def port_cli(cfg, train, test, work, *extra):
    """The port's CLI, -t then -d, on the CPU: summary.txt's lines."""
    path = os.path.join(work, "port_cfg.ism")
    with open(path, "w") as f:
        json.dump(cfg, f)
    model = os.path.join(work, "port_model")
    out = os.path.join(work, "port_out" + "_".join(extra))
    with contextlib.redirect_stdout(io.StringIO()):
        assert ec.main(["-t", path, "-f", train, "-o", model,
                        "--device", "cpu"]) == 0
        assert ec.main(["-d", model + ".ism", "-f", test, "-o", out,
                        "--device", "cpu", *extra]) == 0
    return os.path.join(out, "summary.txt")


def stable_lines(path_or_text):
    """summary.txt without its time lines."""
    text = path_or_text if "\n" in path_or_text else open(path_or_text).read()
    return [ln for ln in text.splitlines()
            if "time" not in ln and "[s]" not in ln]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_summary_matches_jax_cli(lists, jax_summaries, name):
    """-t / -d on the lists: the same summary.txt but for its times
    (Harris3D + FPFH; SHOT with instance labels, INSTANCE_PRIMARY)."""
    train, test, work = lists[name]
    got = port_cli(CONFIGS[name], train, test, work)
    want = str(jax_summaries[name].result()["summary"])
    assert stable_lines(got) == stable_lines(want)
    labels = summary_labels(got)
    assert len(labels) == 4 and (labels[:, 1] >= 0).all()


def test_fast_flow_matches_host_flow(lists):
    """--fast (the batched classify step) gives the host flow's labels on a
    model it serves; a detector model falls back to the host flow."""
    train, test, work = lists["shot_instances"]
    host = port_cli(CONFIGS["shot_instances"], train, test, work)
    fast = port_cli(CONFIGS["shot_instances"], train, test, work, "--fast")
    np.testing.assert_array_equal(summary_labels(fast), summary_labels(host))
    model = ec.ImplicitShapeModel.load(os.path.join(work, "port_model.ism"),
                                       "cpu")
    model.config.child("Keypoints").type = "Harris3D"
    assert ec.fast_classify(model, [], 4) is None


def test_detection_lists_are_refused(tmp_path, capsys):
    path = tmp_path / "list.txt"
    path.write_text("# test detection\n")
    assert ec.main(["-d", "model.ism", "-f", str(path), "--device",
                    "cpu"]) == 1
    assert "eval_detection" in capsys.readouterr().err


def test_profile_stages_prints_one_json_line(capsys):
    """profile_stages on the CPU (host clock): one JSON line with every
    stage of pipeline.STAGES, no device readings."""
    assert profile_stages.main(["--device", "cpu", "--batch", "2", "-n",
                                "256", "--rounds", "1",
                                "--descriptor", "SHORT_SHOT"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res["stage_ms"]) == set(STAGES)
    assert res["clouds_per_s"] > 0 and res["device_busy_share"] is None
    assert res["descriptor"] == "SHORT_SHOT" and res["card"] is None
