"""The port's slice end to end on the CPU: IsmClassifier against the JAX
``classify_scores_batch`` on bench-geometry clouds with the fixture
codebook, with dense and with sorted-axis windowed normals, the serve
entry point, and import hygiene."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_fixtures import CODEBOOK, REFERENCE, jax_scores, jax_window
from torch_parity import assert_decisions_match, n, t

from point_cloud_donkey_tpu_torch import serve
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          cast_votes,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (STAGES,
                                                          IsmClassifier,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops.binned import sort_clouds_ex
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_model(device="cpu", normals_window=0):
    config = IsmConfig.load(CODEBOOK)
    cb = load_codebook(CODEBOOK).to(device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192,
                                  normals_window=normals_window)
    return IsmClassifier(cb, cfg,
                         CodebookParams.from_config(config.child("Codebook")))


def test_bench_config_from_ism():
    cfg = bench_model().cfg
    assert (cfg.radius, cfg.ref_frame_radius, cfg.leaf_size,
            cfg.normal_radius, cfg.metric, cfg.bandwidth, cfg.num_classes) \
        == (0.6, 0.5, 0.35, 0.25, "chisq", 0.5, 5)


def test_slice_matches_jax_classify_scores_batch():
    """B=4 bench clouds at N=2048: port vs live JAX-CPU scores; every
    stage reports once, in order; no kernel is launched for CPU tensors."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:4]
    mask = np.ones(pts.shape[:2], bool)
    mask[3, 1800:] = False                  # a padded cloud too
    pts = pts.copy()
    pts[3, 1800:] = 1e9
    jax_s = jax_scores(CODEBOOK, pts, mask)
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        scores = bench_model()(t(pts), t(mask), on_stage=seen.append)
    assert tuple(seen) == STAGES
    assert scores.shape == (4, 5) and torch.isfinite(scores).all()
    assert_decisions_match(scores, jax_s)
    assert (n(scores).argmax(1) == ref["labels"][:4]).all()
    assert set(build.launch_counts().values()) == {0}


def _padded_batch():
    """4 reference clouds, the last with its tail padded (masked, 1e9)."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:4].copy()
    mask = np.ones(pts.shape[:2], bool)
    mask[3, 1800:] = False
    pts[3, 1800:] = 1e9
    return pts, mask, ref["labels"][:4]


def test_windowed_slice_matches_jax_classify_scores_batch():
    """normals_window calibrated by the JAX ``required_window`` on the
    batch: port vs live JAX-CPU scores with the same window, decisions as
    in the dense slice; the plan is exact, so nothing is recomputed."""
    pts, mask, labels = _padded_batch()
    window = jax_window(pts, mask)
    assert 0 < window < pts.shape[1]
    jax_s = jax_scores(CODEBOOK, pts, mask, window)
    model = bench_model(normals_window=window)
    seen = []
    with torch.no_grad():
        scores = model(t(pts), t(mask), on_stage=seen.append)
    assert tuple(seen) == STAGES
    assert model.dense_recomputes == 0
    assert_decisions_match(scores, jax_s)
    assert (n(scores).argmax(1) == labels).all()


def test_window_flag_trip_recomputes_dense_normals():
    """A window too narrow for the batch (128 points) trips the exactness
    flag: the step recomputes the normals densely and gives exactly the
    dense step's scores on the same (sorted) clouds."""
    pts, mask, _ = _padded_batch()
    tripped = bench_model(normals_window=128)
    srt = sort_clouds_ex(t(pts), t(mask))
    with torch.no_grad():
        scores = tripped(t(pts), t(mask))
        dense = bench_model()(srt.points, srt.mask)
    assert tripped.dense_recomputes == 1
    assert torch.equal(scores, dense)


def test_unported_configurations_raise():
    """What the port still refuses to serve: the descriptors it does not
    compute (FPFH, and SHORT_CSHOT, which the JAX serving step refuses
    too)."""
    cb = load_codebook(CODEBOOK)
    for bad in ("FPFH", "SHORT_CSHOT"):
        with pytest.raises(NotImplementedError, match=bad):
            IsmClassifier(cb, PipelineConfig(descriptor=bad))


def test_serve_main_reports_predictions(tmp_path, capsys):
    """serve.main on 4 PCDs of the reference clouds: one
    'predicted/ground truth' line per cloud and the Accuracy line, in
    the format of the JAX cli/serve.py."""
    ref = np.load(REFERENCE)
    lines = ["# test"]
    for i in range(4):
        path = tmp_path / f"c{i}.pcd"
        save_pcd(str(path), ref["points"][i])
        lines.append(f"{path} {ref['labels'][i]}")
    flist = tmp_path / "test.txt"
    flist.write_text("\n".join(lines) + "\n")
    rc = serve.main(["-d", CODEBOOK, "-f", str(flist), "--device", "cpu",
                     "--batch", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    preds = re.findall(r"^(.+): predicted (\d+), ground truth (\d+) (OK|WRONG)$",
                       out, re.M)
    assert len(preds) == 4
    expect = ref["scores"][:4].argmax(1)
    assert [int(p[1]) for p in preds] == expect.tolist()
    acc = 100.0 * (expect == ref["labels"][:4]).mean()
    assert f" Accuracy: {acc:.0f} % " in out
    assert "Throughput:" in out


def test_port_imports_neither_jax_nor_triton():
    """Every port module, and the numpy-only test helpers that
    chip_smoke.py reads, import nothing of jax, triton or the JAX
    package; the scene constants live in ops/tiled.py alone."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import bench_data, kinect_data, shapes, torch_fixtures\n"
        "import zoo2_check, zoo3_data\n"
        "import point_cloud_donkey_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 41, mods\n"
        "new = ['ops.color', 'ops.short_shot', 'ops.kernels.shot_hist', "
        "'ops.kernels.histogram', 'train', 'models.ism', "
        "'models.detect_batch', 'models.features', 'models.keypoints', "
        "'models.types', 'models.ranking', 'models.clustering', "
        "'utils.mesh', 'ops.hough', 'models.voting', 'models.classifier', "
        "'models.metrics', 'utils.boost_archive', 'utils.debug_utils', "
        "'eval_detection', 'ops.tiled', 'ops.curvature', 'ops.cgf', "
        "'ops.lrf', 'train_cgf_embedding', 'utils.shapes']\n"
        "assert all(pkg.__name__ + '.' + m in mods for m in new), mods\n"
        "from point_cloud_donkey_tpu_torch.ops import tiled\n"
        "owners = [m for m in mods if any(hasattr(sys.modules[m], c) for c "
        "in ('SCENE_TILE_THRESHOLD', 'NORMALS_CHUNK', 'KEYPOINT_CHUNK'))]\n"
        "assert owners == [tiled.__name__], owners\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', "
        "'point_cloud_donkey_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py runs where there is no JAX: none of its imports names
    jax or the JAX package."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert any(m.startswith("point_cloud_donkey_tpu_torch") for m in names)
    bad = [m for m in names if m.split(".")[0] in
           ("jax", "jaxlib", "point_cloud_donkey_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("script", ["binned_timing.py", "detect_limits.py",
                                    "mean_shift_timing.py"])
def test_card_scripts_import_nothing_of_jax(script):
    """The measurement scripts that run on the card beside chip_smoke.py
    import nothing of jax or of the JAX package, only the port."""
    with open(os.path.join(REPO, "tests", script)) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert any(m.startswith("point_cloud_donkey_tpu_torch") for m in names)
    bad = [m for m in names if m.split(".")[0] in
           ("jax", "jaxlib", "point_cloud_donkey_tpu")]
    assert not bad, bad


def test_chip_smoke_fails_without_a_gpu():
    """Where torch sees no GPU, chip_smoke.py exits nonzero and prints no
    result line."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch, runpy\n"
         "torch.cuda.is_available = lambda: False\n"
         "sys.argv = ['chip_smoke.py']\n"
         "runpy.run_path('chip_smoke.py', run_name='__main__')\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "is_available() is False" in res.stderr
