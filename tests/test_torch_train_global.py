"""The port's global features and SVM in training, and the shipped configs
trained as shipped, against the JAX package's training on the CPU.

  * SHOT_GLOBAL (also under normals method 3), CSHOT_GLOBAL (with the
    auto-trained SVM, as configs/default.ism sets it) and
    SHORT_SHOT_GLOBAL on 6 coloured models
    of 3 classes: the global descriptors at cosine > 0.999, their classes,
    instances and radii, the SVM's (C, gamma) and predictions, and the
    codebook contract of tests/test_torch_train.py;
  * configs/quickstart.ism (millimetres: the 2048-point models scaled by
    70, ~26 keypoints a cloud; at a scale of 100 too many points have
    fewer than 5 neighbours within its 10 mm NormalRadius, and their
    ill-posed normals differ between any two implementations) and
    configs/default.ism (metres: 1024 points scaled by 0.3, coloured)
    verbatim, through the port's train entry point: the codebook
    contract; the model saved by the port loads in the JAX package, whose
    SVMModel predicts the port's classes from the saved global descriptors;
  * serving a model that asks for the global-feature verification
    (default.ism's Voting.UseGlobalFeatures) is refused by name.

The JAX references run as tests/test_torch_train_staged.py runs them (the
fused route, dense descriptors on the staged route)."""

import copy
import json
import os

import numpy as np
import pytest

import shapes
from bench_data import bench_colors
from test_torch_train import CLASSES, N_MODELS, assert_codebooks_match
from test_torch_train_staged import jax_train, port_train, with_child, \
    with_params

from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel as JaxIsm
from point_cloud_donkey_tpu.utils.io import PointCloud as JaxCloud
from point_cloud_donkey_tpu.utils.io import save_pcd as jax_save_pcd
from point_cloud_donkey_tpu_torch import serve, train
from point_cloud_donkey_tpu_torch.models.pipeline import PipelineConfig
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model_files(tmp, scale=1.0, n_points=1024, seed=11):
    """6 rotated coloured shapes of 3 classes, scaled, as PCD files."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_MODELS):
        pts = shapes.make_instance(rng, i % CLASSES, n=n_points, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"g{i}.pcd")
        jax_save_pcd(path, JaxCloud(xyz=pts * np.float32(scale),
                                    rgb=bench_colors(pts)))
        out.append((path, i % CLASSES))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return model_files(tmp_path_factory.mktemp("global"))


def global_config(kind, **svm):
    cfg = with_child("GlobalFeatures", {
        "Type": kind, "Parameters": {"ReferenceFrameRadius": 1.0}})
    return with_params(cfg, **svm)


CONFIGS = {
    "shot_global": ("SHOT_GLOBAL", {"UseSvmTraining": True}),
    "cshot_global": ("CSHOT_GLOBAL", {"UseSvmTraining": True,
                                      "SvmAutoTrain": True}),
    "short_shot_global": ("SHORT_SHOT_GLOBAL", {
        "UseSvmTraining": True, "SvmOneVsAllTraining": True}),
    # method 3: EMST-oriented local normals, the global ones as they come
    "shot_global_normals_m3": ("SHOT_GLOBAL", {
        "ConsistentNormalsMethod": 3}),
}


def assert_globals_match(got, want):
    g, w = got.state, want.state
    assert g.global_descriptors.shape == w.global_descriptors.shape
    cos = (g.global_descriptors * w.global_descriptors).sum(1) / (
        np.linalg.norm(g.global_descriptors, axis=1)
        * np.linalg.norm(w.global_descriptors, axis=1))
    assert cos.min() > 0.999, cos.min()
    np.testing.assert_array_equal(g.global_classes, w.global_classes)
    np.testing.assert_array_equal(g.global_instances, w.global_instances)
    np.testing.assert_allclose(g.global_radii, w.global_radii, rtol=1e-6)
    if w.svm is None:
        assert g.svm is None
        return
    assert g.svm.mode == w.svm.mode
    assert [b.gamma for b in g.svm.binaries] == \
        [b.gamma for b in w.svm.binaries]
    for d_g, d_w in zip(g.global_descriptors, w.global_descriptors):
        assert g.svm.predict(d_g)[0] == w.svm.predict(d_w)[0]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_global_features_and_svm_match_jax(files, name):
    kind, svm = CONFIGS[name]
    cfg = global_config(kind, **svm)
    want = jax_train(files, cfg)
    got = port_train(files, cfg)
    assert got.state.global_descriptors.shape[0] == N_MODELS
    assert_globals_match(got, want)
    assert_codebooks_match(got.state.codebook, want.state.codebook)
    assert got.processing_times["train_global"] > 0


def shipped(name):
    with open(os.path.join(REPO, "configs", f"{name}.ism")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,scale", [("quickstart", 70.0),
                                        ("default", 0.3)])
def test_shipped_configs_train_as_shipped(tmp_path, name, scale):
    """train -t configs/<name>.ism -f list -o model --device cpu, the config
    unmodified, against the JAX package's training of the same files; the
    saved model loads in the JAX package."""
    items = model_files(tmp_path, scale, n_points=2048 if scale > 1 else
                        1024)
    lines = ["# train"] + [f"{p} {c}" for p, c in items]
    flist = tmp_path / "train.txt"
    flist.write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "model")
    assert train.main(["-t", os.path.join(REPO, "configs", f"{name}.ism"),
                       "-f", str(flist), "-o", out, "--device", "cpu"]) == 0
    want = jax_train(items, shipped(name))
    loaded = JaxIsm.load(out + ".ism")
    assert_codebooks_match(loaded.state.codebook, want.state.codebook)
    kp = loaded.state.codebook.cw_mask.sum() / N_MODELS
    assert 15 <= kp <= 120, kp
    if name == "default":
        assert_globals_match(loaded, want)
        got = port_train(items, shipped(name))
        np.testing.assert_array_equal(got.state.global_descriptors,
                                      loaded.state.global_descriptors)
        for d in loaded.state.global_descriptors:
            assert loaded.state.svm.predict(d)[0] == \
                got.state.svm.predict(d)[0]
    else:
        assert loaded.state.global_descriptors is None


def test_global_verification_is_refused(tmp_path):
    """A model whose Voting asks for UseGlobalFeatures: the port's serving
    config refuses it by name (its classifier is not ported), and so does
    serve."""
    cfg = IsmConfig.from_json(shipped("default"))
    with pytest.raises(NotImplementedError, match="UseGlobalFeatures"):
        PipelineConfig.from_ism(cfg, 3)
    plain = copy.deepcopy(shipped("default"))
    plain["ObjectConfig"]["Children"]["Voting"]["Parameters"][
        "UseGlobalFeatures"] = False
    assert PipelineConfig.from_ism(IsmConfig.from_json(plain),
                                   3).descriptor == "CSHOT"
    items = model_files(tmp_path, 0.3)
    ism = port_train(items, shipped("default"))
    model = str(tmp_path / "model.ism")
    ism.save(model)
    flist = tmp_path / "test.txt"
    flist.write_text("# test\n" + "\n".join(f"{p} {c}" for p, c in items))
    with pytest.raises(NotImplementedError, match="UseGlobalFeatures"):
        serve.main(["-d", model, "-f", str(flist), "--device", "cpu"])
