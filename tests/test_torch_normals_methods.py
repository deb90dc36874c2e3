"""ConsistentNormalsMethod 0, 1 and 3 and `.off` meshes in the port, against
the JAX package on the CPU:

  * ``ops/normals.compute_normals`` methods 0 (towards the viewpoint), 1
    (away from each cloud's masked centroid) and 3 (the PCA normal as it
    comes) against the JAX function on two clouds, one padded, where the
    PCA is valid in both;
  * IsmClassifier under methods 0, 1 and 3 (SHOT) and the CSHOT codebook
    under method 0 (configs/rgbd_kinect.ism's setting) against the
    committed JAX-CPU scores of data/config_reference.npz, and IsmDetector
    under method 1 against ``jax.vmap(detect_maxima_jit)``;
  * ``utils/mesh`` and ``read_cloud(".off")`` bit for bit against the JAX
    package's for the same seed; ``serve.main`` on two `.off` files.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapes
from bench_data import KEYPOINT_CAPACITY, bench_colors, write_box_off
from torch_fixtures import (CODEBOOK, CODEBOOKS, CONFIG_REFERENCE, CONFIGS,
                            REFERENCE, jax_detect)
from torch_parity import assert_decisions_match, n, t

from point_cloud_donkey_tpu.ops.normals import \
    compute_normals as j_compute_normals
from point_cloud_donkey_tpu.utils import io as jio
from point_cloud_donkey_tpu.utils import mesh as jmesh
from point_cloud_donkey_tpu_torch import serve
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                          IsmDetector,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops.normals import compute_normals
from point_cloud_donkey_tpu_torch.utils import io as tio
from point_cloud_donkey_tpu_torch.utils import mesh as tmesh
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

REF = np.load(REFERENCE)


@pytest.fixture(scope="module")
def clouds():
    """Two 700-point shapes, the second with a masked tail parked at 1e9."""
    rng = np.random.default_rng(31)
    pts = np.stack([shapes.make_instance(rng, c, n=700, rotate=True,
                                         noise=0.005) for c in (1, 3)]
                   ).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 600:] = False
    pts[1, 600:] = 1e9
    return pts, mask


@pytest.mark.parametrize("method", [0, 1, 3])
def test_compute_normals_matches_jax(clouds, method):
    """Method 0, 1 or 3 vs the JAX compute_normals: the PCA validity equal
    on the cloud's points, >= 97% of the valid normals within 2e-3 (a PCA
    eigenvector or an orientation test near 0 can settle either way),
    curvature atol 1e-4; methods 0 and 1 orient every valid normal."""
    pts, mask = clouds
    want = jax.vmap(lambda p, m: j_compute_normals(p, m, 0.25, method))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = compute_normals(t(pts), t(mask), 0.25, method)
    valid = n(got.valid)
    np.testing.assert_array_equal(valid[mask], np.asarray(want.valid)[mask])
    assert valid[mask].mean() > 0.9
    nrm = n(got.normals)
    err = np.abs(nrm - np.asarray(want.normals)).max(-1)[valid]
    assert (err < 2e-3).mean() >= 0.97, (err >= 2e-3).sum()
    np.testing.assert_allclose(n(got.curvature)[valid],
                               np.asarray(want.curvature)[valid], atol=1e-4)
    if method == 0:
        assert ((-pts * nrm).sum(-1)[valid] >= 0).all()
    if method == 3:
        pca = compute_normals(t(pts), t(mask), 0.25, 1)
        flip = (n(pca.normals) != nrm).any(-1)
        assert torch.equal(pca.valid, got.valid) and flip[valid].any()


def _served(name):
    """(codebook, PipelineConfig, CodebookParams) of config_reference.npz's
    configuration `name` on the CPU."""
    fields, method, desc = CONFIGS[name]
    config = IsmConfig.load(CODEBOOKS[desc])
    cb = load_codebook(CODEBOOKS[desc])
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=KEYPOINT_CAPACITY
                                  )._replace(normals_method=method)
    params = CodebookParams.from_config(config.child("Codebook"))
    for key, value in fields.items():
        setattr(params, key, value)
    return cb, cfg, params


@pytest.mark.parametrize("name", ["normals_m0", "normals_m1", "normals_m3",
                                  "cshot_m0"])
def test_classifier_matches_committed_jax_scores(name):
    """IsmClassifier under the normals method of `name` (CSHOT with the
    bench colours) on the first 4 reference clouds: the decision contract
    against the committed JAX-CPU scores.  The normals window is ignored
    for methods other than 2, as in the JAX step: the scores with a window
    equal those without."""
    cb, cfg, params = _served(name)
    pts = REF["points"][:4]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    rgb = (t(bench_colors(pts)),) if cfg.descriptor == "CSHOT" else ()
    with torch.no_grad():
        scores = IsmClassifier(cb, cfg, params)(t(pts), mask, *rgb)
        windowed = IsmClassifier(cb, cfg._replace(normals_window=1280),
                                 params)(t(pts), mask, *rgb)
    assert torch.equal(scores, windowed)
    assert_decisions_match(scores, np.load(CONFIG_REFERENCE)[
        "scores_" + name][:4])


def test_detector_under_method_1_matches_jax():
    """IsmDetector under method 1 vs jax.vmap(detect_maxima_jit) with the
    same normals on 2 bench clouds: argmax equal on the firm clouds,
    densities within rtol 1e-3."""
    pts = REF["points"][:2]
    mask = np.ones(pts.shape[:2], bool)
    jd, _ = jax_detect(CODEBOOK, pts, mask, normals_method=1)
    cb, cfg, params = _served("normals_m1")
    with torch.no_grad():
        td, _ = IsmDetector(cb, cfg, params)(t(pts), t(mask))
    td = n(td)
    top2 = np.sort(jd, 1)[:, -2:]
    firm = top2[:, 1] - top2[:, 0] > 3.0
    assert firm.any()
    np.testing.assert_array_equal(td.argmax(1)[firm], jd.argmax(1)[firm])
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)


# --- .off meshes ------------------------------------------------------------

_QUIRKY_OFF = """OFF8 7 0
# a unit cube, its faces as quads and one triangle pair
0 0 0
1 0 0
1 1 0
0 1 0
0 0 1
1 0 1
1 1 1
0 1 1
4 0 3 2 1
4 4 5 6 7
4 0 1 5 4
4 2 3 7 6
4 1 2 6 5
3 0 4 7
3 0 7 3
"""


def test_mesh_matches_the_jax_package(tmp_path):
    """load_off (the glued header, a comment, quads fan-triangulated),
    sample_surface and off_to_cloud give the JAX package's arrays bit for
    bit for the same seed."""
    quirky = tmp_path / "quirky.off"
    quirky.write_text(_QUIRKY_OFF)
    box = tmp_path / "box.off"
    write_box_off(str(box))
    for path in (str(quirky), str(box)):
        tv, tf = tmesh.load_off(path)
        jv, jf = jmesh.load_off(path)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        for seed in (0, 5):
            np.testing.assert_array_equal(
                tmesh.sample_surface(tv, tf, 500, seed),
                jmesh.sample_surface(jv, jf, 500, seed))
            np.testing.assert_array_equal(
                tmesh.off_to_cloud(path, 300, seed).xyz,
                jmesh.off_to_cloud(path, 300, seed).xyz)
    assert len(tmesh.load_off(str(quirky))[1]) == 12


def test_read_cloud_samples_off_meshes(tmp_path, monkeypatch):
    """read_cloud(".off") is the JAX load_cloud's cloud bit for bit, with
    the PCD_OFF_POINTS / PCD_OFF_SEED settings (2048 points, seed 0 by
    default), centred and scaled to the unit sphere."""
    path = str(tmp_path / "box.off")
    write_box_off(path)
    got = tio.read_cloud(path)
    np.testing.assert_array_equal(got.xyz, jio.load_cloud(path).xyz)
    assert got.xyz.shape == (2048, 3) and got.rgb is None
    assert abs(np.linalg.norm(got.xyz, axis=1).max() - 1.0) < 1e-6
    monkeypatch.setenv("PCD_OFF_POINTS", "777")
    monkeypatch.setenv("PCD_OFF_SEED", "3")
    got = tio.read_cloud(path)
    np.testing.assert_array_equal(got.xyz, jio.load_cloud(path).xyz)
    assert got.xyz.shape == (777, 3)


def test_serve_classifies_off_meshes(tmp_path, capsys):
    """serve.main on two `.off` meshes (boxes of two proportions): one
    prediction line per mesh and the accuracy line."""
    lines = ["# test"]
    for i, size in enumerate(((1.6, 1.0, 0.6), (1.0, 1.0, 1.0))):
        path = tmp_path / f"m{i}.off"
        write_box_off(str(path), size)
        lines.append(f"{path} 0")
    flist = tmp_path / "test.txt"
    flist.write_text("\n".join(lines) + "\n")
    assert serve.main(["-d", CODEBOOK, "-f", str(flist), "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    preds = re.findall(r"^(.+\.off): predicted (\d+), ground truth 0 "
                       r"(?:OK|WRONG)$", out, re.M)
    assert len(preds) == 2
    assert " Accuracy: " in out
