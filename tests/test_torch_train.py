"""The port's training (models/ism.py on the fused extraction route, the
codebook's training half, the train entry point) against the JAX package's
training on the CPU with PCD_TRAIN_FUSED=1 -- the route the JAX package
trains on accelerators -- on 6 models of 3 classes, drawn as
tests/test_train_fused.py draws them; a saved model loads in the JAX
package; what the port cannot train is refused.

The models have 1024 points, not test_train_fused.py's 512: at 512, 10
points of the 6 clouds have fewer than 3 points within NormalRadius, so
their normal is the smallest eigenvector of a covariance of rank 1 or 0 --
any vector of a plane -- and the JAX package's jitted route and the port
pick different ones (test_normals_differ_from_jax_only_where_undefined);
those normals enter the descriptors of every keypoint around them.  At
1024 points no point lacks a normal, and the port meets the codebook
contract below."""

import copy
import os

import numpy as np
import pytest
import torch

import shapes
from bench_data import BENCH_CONFIG
from torch_parity import n, t

from point_cloud_donkey_tpu.models import codebook as jcb
from point_cloud_donkey_tpu.models.ism import \
    ImplicitShapeModel as JaxIsm
from point_cloud_donkey_tpu.ops import geometry as jgeo
from point_cloud_donkey_tpu.utils.config import IsmConfig as JaxConfig
from point_cloud_donkey_tpu_torch import serve, train
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models import codebook as tcb
from point_cloud_donkey_tpu_torch.models.codebook import (Codebook,
                                                          CodebookParams)
from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import geometry as tgeo
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

N_MODELS = 6
N_POINTS = 1024
CLASSES = 3


def config(descriptor="SHOT"):
    """bench.py's training config (tests/test_train_fused.py's), with
    Features.Type `descriptor`."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    cfg["ObjectConfig"]["Children"]["Features"]["Type"] = descriptor
    return cfg


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """6 rotated shapes of 3 classes saved as PCD files: [(path, class)]."""
    tmp = tmp_path_factory.mktemp("train_models")
    rng = np.random.default_rng(11)
    files = []
    for i in range(N_MODELS):
        cid = i % CLASSES
        pts = shapes.make_instance(rng, cid, n=N_POINTS, rotate=True,
                                   noise=0.005)
        path = str(tmp / f"m{i}.pcd")
        save_pcd(path, pts)
        files.append((path, cid))
    return files


def jax_train(files, descriptor, cfg=None):
    """The JAX package's fused training route on the CPU (with the config
    `cfg`, by default config(descriptor))."""
    old = os.environ.get("PCD_TRAIN_FUSED")
    os.environ["PCD_TRAIN_FUSED"] = "1"
    try:
        ism = JaxIsm(JaxConfig.from_json(cfg or config(descriptor)))
        for path, cid in files:
            ism.add_training_model(path, cid, cid)
        ism.train()
    finally:
        if old is None:
            del os.environ["PCD_TRAIN_FUSED"]
        else:
            os.environ["PCD_TRAIN_FUSED"] = old
    return ism


def port_train(files, descriptor="SHOT", lrf_version=1, cfg=None):
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg or config(descriptor)),
                             "cpu", lrf_version)
    for path, cid in files:
        ism.add_training_model(path, cid, cid)
    ism.train()
    return ism


@pytest.fixture(scope="module")
def jax_shot(model_files):
    return jax_train(model_files, "SHOT")


@pytest.fixture(scope="module")
def fresh_views():
    """Three fresh rotated views, one per class (tests/test_train_fused.py's
    draw)."""
    rng = np.random.default_rng(77)
    return np.stack([shapes.make_instance(rng, cid, n=N_POINTS, rotate=True)
                     for cid in range(CLASSES)]).astype(np.float32)


def decisions(codebook, descriptor, views):
    """argmax of the port's classify step with `codebook` on `views`."""
    cfg = IsmConfig.from_json(config(descriptor))
    cb = Codebook.from_numpy(codebook._asdict())
    model = IsmClassifier(cb, PipelineConfig.from_ism(cfg, cb.num_classes),
                          CodebookParams.from_config(cfg.child("Codebook")))
    with torch.no_grad():
        scores = model(t(views), torch.ones(views.shape[:2], dtype=torch.bool))
    return n(scores).argmax(1)


def assert_codebooks_match(got, want):
    """The training contract: the same codeword count and vote structure
    (mask, class, instance), the codewords in the same order with >= 97%
    at cosine > 0.999 (a near-tied LRF sign moves a whole descriptor,
    tests/test_pallas_kernels.py's 97% frame share), class sigmas within
    rtol 5e-2."""
    assert got.codewords.shape == want.codewords.shape
    for name in ("cw_mask", "vote_mask", "vote_class", "vote_instance"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    a, b = got.codewords, np.asarray(want.codewords)
    cos = (a * b).sum(1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-30)
    assert (cos > 0.999).mean() >= 0.97, (cos <= 0.999).sum()
    np.testing.assert_allclose(got.class_sigma, np.asarray(want.class_sigma),
                               rtol=5e-2)


def test_inn_training_matches_jax(model_files):
    """Training under INN (the 1-NN of the refined queries, the
    single-vote clean-up) vs the JAX fused route: the codebook contract."""
    cfg = config()
    cfg["ObjectConfig"]["Children"]["Codebook"]["Children"][
        "ActivationStrategy"] = {"Type": "INN"}
    want = jax_train(model_files, "SHOT", cfg).state.codebook
    got = port_train(model_files, cfg=cfg).state.codebook
    assert_codebooks_match(got, want)
    assert (got.vote_mask.sum(1)[got.cw_mask] == 1).all()


@pytest.fixture(scope="module")
def model_features(model_files):
    """The JAX-CPU features of the six models (the bench pipeline's dense
    grid), compacted, with their AABBs: (JAX feature sets, port feature
    sets, classes, JAX boxes, port boxes, descriptors, positions)."""
    import jax
    import jax.numpy as jnp
    from torch_fixtures import jax_pipeline_config
    from point_cloud_donkey_tpu.models.pipeline_jit import \
        extract_features_jit
    from point_cloud_donkey_tpu.models.types import FeatureSet as JaxSet
    from point_cloud_donkey_tpu_torch.models.types import make_feature_set
    from point_cloud_donkey_tpu_torch.utils.io import read_cloud
    cfg = jax_pipeline_config()
    step = jax.jit(lambda p, m: extract_features_jit(p, m, cfg))
    jsets, tsets, jboxes, tboxes = [], [], [], []
    for path, _ in model_files:
        xyz = read_cloud(path).xyz
        kp, fr, d, v = (np.asarray(x) for x in step(
            jnp.asarray(xyz), jnp.ones(len(xyz), bool)))
        fs = make_feature_set(d[v], kp[v], fr[v], np.ones(int(v.sum()), bool))
        tsets.append(fs)
        jsets.append(JaxSet(*fs))
        mn, mx = xyz.min(0), xyz.max(0)
        box = ((mn + (mx - mn) / 2).astype(np.float32),
               (mx - mn).astype(np.float32),
               np.array([1.0, 0.0, 0.0, 0.0], np.float32))
        jboxes.append(jgeo.BoundingBox(*box))
        tboxes.append(tgeo.BoundingBox(*box))
    desc = np.concatenate([fs.descriptors for fs in tsets])
    pos = np.concatenate([fs.positions for fs in tsets])
    return (jsets, tsets, [c for _, c in model_files], jboxes, tboxes, desc,
            pos)


@pytest.mark.parametrize("activation", [
    {"activation_type": "INN"},
    {"activation_type": "Threshold", "threshold": 3.8},
    {"activation_type": "KNN", "knn_k": 5},
], ids=["INN", "Threshold", "KNN5"])
def test_train_codebook_matches_jax(model_features, activation):
    """train_codebook under INN, Threshold (the 64 nearest within the
    threshold, -1 beyond it; K4m's matrix) and KNN K=5 (K4m's matrix) vs
    the JAX train_codebook on the same features: the same vote structure,
    the arrays within f32 round-off (class sigmas rtol 1e-4, sums over
    other orders); Threshold and KNN K=5 give codewords several votes."""
    jsets, tsets, classes, jboxes, tboxes, desc, pos = model_features
    want = jcb.train_codebook(jsets, classes, classes, jboxes, desc, pos,
                              jcb.CodebookParams(flann_exact=True,
                                                 **activation), "chisq")
    got = tcb.train_codebook(tsets, classes, classes, tboxes, desc, pos,
                             tcb.CodebookParams(**activation), "chisq",
                             torch.from_numpy(desc))
    for name, w in want._asdict().items():
        g, w = getattr(got, name), np.asarray(w)
        assert g.shape == w.shape, name
        if g.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-4 if name == "class_sigma" else 1e-5,
                atol=1e-6, err_msg=name)
    votes = got.vote_mask.sum(1)[got.cw_mask]
    assert (votes == 1).all() if activation["activation_type"] == "INN" \
        else votes.max() > 1


# --- host halves of the codebook training -----------------------------------

def _groups(seed=4):
    """Votes of 7 codewords in groups of 1-4 (the un-cleaned KNN k > 1
    layout): vote, pos, frame, center, g_of_vote, group_size."""
    rng = np.random.default_rng(seed)
    group_size = np.array([1, 3, 2, 4, 1, 2, 3])
    nv = int(group_size.sum())
    q = rng.normal(size=(nv, 4)).astype(np.float32)
    frame = np.asarray(jgeo.quat_to_matrix(q[0]))[None].repeat(nv, 0)
    for i in range(nv):
        frame[i] = np.asarray(jgeo.quat_to_matrix(q[i]))
    return (rng.normal(size=(nv, 3)).astype(np.float32) * 0.3,
            rng.normal(size=(nv, 3)).astype(np.float32),
            frame.astype(np.float32),
            rng.normal(size=(nv, 3)).astype(np.float32),
            np.repeat(np.arange(len(group_size)), group_size), group_size)


@pytest.mark.parametrize("single", [False, True])
def test_center_weights_match_jax(single):
    """_center_weights_batched (median gaussians per codeword) vs JAX on
    seeded votes, in groups and one vote per codeword: rtol 1e-6."""
    args = _groups()
    if single:
        nv = len(args[0])
        args = args[:4] + (np.arange(nv), np.ones(nv, np.int64))
    np.testing.assert_allclose(tcb._center_weights_batched(*args),
                               jcb._center_weights_batched(*args), rtol=1e-6)


def test_statistical_class_weights_match_jax():
    """The 9-step statistical weights vs JAX on seeded (codeword, class)
    votes: rtol 1e-6."""
    rng = np.random.default_rng(8)
    cw = rng.integers(0, 40, 300)
    cls = rng.integers(0, 4, 300).astype(np.int32)
    np.testing.assert_allclose(
        tcb._statistical_class_weights_arrays(cw, cls),
        jcb._statistical_class_weights_arrays(cw, cls), rtol=1e-6)


def test_quaternion_helpers_match_jax():
    """The host quaternions of the vote recording give the JAX package's
    bits."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    rot = np.stack([np.asarray(jgeo.quat_to_matrix(x)) for x in q])
    np.testing.assert_array_equal(tgeo.matrix_to_quat_batch_np(rot),
                                  jgeo.matrix_to_quat_batch_np(rot))
    np.testing.assert_array_equal(tgeo.quat_multiply_np(q[:1], q),
                                  jgeo.quat_multiply_np(q[:1], q))
    np.testing.assert_allclose(tgeo.quat_to_matrix_np(q[3]), rot[3],
                               atol=1e-6)


# --- training against the JAX package ---------------------------------------

@pytest.mark.parametrize("n_points", [512, N_POINTS])
def test_normals_differ_from_jax_only_where_undefined(n_points):
    """The normals of the training models (drawn as model_files draws them)
    against the JAX fused route's jit(vmap(compute_normals)): |cos| > 0.999
    at the same sign on every point with at least 3 points within
    NormalRadius (itself included), which PCA needs for a plane.  At 512
    points some points have fewer, and only there may the two differ; at
    N_POINTS every point has its normal."""
    import jax

    from point_cloud_donkey_tpu.ops.normals import compute_normals as jcn
    from point_cloud_donkey_tpu_torch.ops.normals import compute_normals
    r = BENCH_CONFIG["ObjectConfig"]["Parameters"]["NormalRadius"]
    rng = np.random.default_rng(11)
    pts = np.stack([shapes.make_instance(rng, i % CLASSES, n=n_points,
                                         rotate=True, noise=0.005)
                    for i in range(N_MODELS)]).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, m: jcn(p, m, r, 2).normals))(pts, mask))
    with torch.no_grad():
        got = n(compute_normals(t(pts), t(mask), r, 2).normals)
    p64 = pts.astype(np.float64)
    neighbours = (((p64[:, :, None] - p64[:, None]) ** 2).sum(-1)
                  <= r * r).sum(-1)
    defined = neighbours >= 3
    cos = (got * want).sum(-1)
    assert (cos[defined] > 0.999).all(), (cos[defined] <= 0.999).sum()
    if n_points == 512:
        assert (~defined).sum() == 10
    else:
        assert defined.all()


@pytest.mark.parametrize("lrf_version", [1, 2])
def test_training_matches_jax(model_files, jax_shot, fresh_views,
                              lrf_version):
    """Port training (K1/K2, or K10/K11 with lrf_version 2) vs the JAX
    fused training: the codebook contract, the same per-class dimensions,
    and the same decisions on fresh views (each model served by the
    port's classify step), at least 2 of 3 right."""
    ism = port_train(model_files, lrf_version=lrf_version)
    assert_codebooks_match(ism.state.codebook, jax_shot.state.codebook)
    for cid, dims in jax_shot.state.dims_map.items():
        np.testing.assert_allclose(ism.state.dims_map[cid], dims, rtol=1e-6)
        np.testing.assert_allclose(ism.state.variance_map[cid],
                                   jax_shot.state.variance_map[cid],
                                   rtol=1e-4, atol=1e-7)
    got = decisions(ism.state.codebook, "SHOT", fresh_views)
    want = decisions(jax_shot.state.codebook, "SHOT", fresh_views)
    np.testing.assert_array_equal(got, want)
    assert (got == np.arange(CLASSES)).sum() >= 2
    assert set(ism.processing_times) >= {"train_load", "train_features",
                                         "train_activation",
                                         "train_complete"}


def test_short_shot_training_matches_jax(model_files, fresh_views):
    """SHORT_SHOT (the K9 descriptor, no normals) trained by the port and
    by the JAX fused route: the same codeword count and decisions."""
    want = jax_train(model_files, "SHORT_SHOT").state.codebook
    got = port_train(model_files, "SHORT_SHOT").state.codebook
    assert got.codewords.shape == want.codewords.shape
    assert got.num_codewords == int(want.cw_mask.sum())
    np.testing.assert_array_equal(decisions(got, "SHORT_SHOT", fresh_views),
                                  decisions(want, "SHORT_SHOT", fresh_views))


def test_saved_model_loads_in_jax(model_files, tmp_path):
    """save -> the JAX ImplicitShapeModel.load: identical arrays and
    maps, and the same config file as the JAX package writes."""
    ism = port_train(model_files)
    path = str(tmp_path / "port.ism")
    ism.save(path)
    loaded = JaxIsm.load(path)
    for name, want in ism.state.codebook._asdict().items():
        got = getattr(loaded.state.codebook, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for got, want in ((loaded.state.dims_map, ism.state.dims_map),
                      (loaded.state.variance_map, ism.state.variance_map)):
        assert sorted(got) == sorted(want)
        for cid in want:        # saved as float32
            np.testing.assert_allclose(got[cid], want[cid], rtol=1e-6)
    jpath = str(tmp_path / "jax.ism")
    JaxIsm(JaxConfig.from_json(config())).save(jpath)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()


def test_train_cli_then_serve(model_files, tmp_path, capsys):
    """train -f list -o model --device cpu, then serve the model: the
    codebook, the label maps and instance classes saved as the JAX CLI
    saves them; serve classifies the training files."""
    cfg_path = str(tmp_path / "config.ism")
    IsmConfig.from_json(config()).save(cfg_path)
    names = ("box", "sphere", "torus")
    lines = ["# train"] + [f"{p} {names[c]}" for p, c in model_files]
    flist = tmp_path / "train.txt"
    flist.write_text("\n".join(lines) + "\n")
    build.reset_launch_counts()
    assert train.main(["-t", cfg_path, "-f", str(flist), "-o",
                       str(tmp_path / "model"), "--device", "cpu"]) == 0
    assert set(build.launch_counts().values()) == {0}
    loaded = JaxIsm.load(str(tmp_path / "model.ism"))
    assert loaded.label_maps["usage"] == "CLASS_ONLY"
    assert loaded.label_maps["class"] == {"0": "box", "1": "sphere",
                                          "2": "torus"}
    assert loaded.state.instance_to_class == {0: 0, 1: 1, 2: 2}
    assert loaded.state.codebook.cw_mask.sum() > 0
    tlist = tmp_path / "test.txt"
    tlist.write_text("\n".join(["# test"] + lines[1:]) + "\n")
    capsys.readouterr()
    assert serve.main(["-d", str(tmp_path / "model.ism"), "-f", str(tlist),
                       "--device", "cpu", "--points", str(N_POINTS)]) == 0
    assert " Accuracy: 100 % (6/6)" in capsys.readouterr().out


def test_boxed_models_crop_to_their_box(model_files):
    """A model added with its box is cropped to it and votes for the box's
    centre: the box of a model's whole cloud (its AABB) trains the same
    codebook as the model added alone; a crop below 500 points is skipped,
    as the JAX package skips it."""
    from point_cloud_donkey_tpu_torch.ops.geometry import BoundingBox
    from point_cloud_donkey_tpu_torch.utils.io import read_cloud
    path, cid = model_files[0]
    xyz = read_cloud(path).xyz
    mn, mx = xyz.min(axis=0), xyz.max(axis=0)
    box = BoundingBox(position=(mn + (mx - mn) / 2.0).astype(np.float32),
                      size=(mx - mn).astype(np.float32),
                      quat=np.array([1.0, 0.0, 0.0, 0.0], np.float32))
    books = []
    for boxed in (False, True):
        ism = ImplicitShapeModel(IsmConfig.from_json(config()), "cpu")
        if boxed:
            ism.add_training_models_with_boxes(path, [cid], [cid], [box])
        else:
            ism.add_training_model(path, cid, cid)
        ism.train()
        books.append(ism.state.codebook)
    for name, want in books[0]._asdict().items():
        np.testing.assert_array_equal(getattr(books[1], name), want, name)
    tiny = box._replace(size=np.full(3, 0.05, np.float32))
    ism = ImplicitShapeModel(IsmConfig.from_json(config()), "cpu")
    ism.add_training_models_with_boxes(path, [cid, cid], [cid, cid],
                                       [tiny, box])
    ism.train()
    assert len(ism.boxes) == 1
    for name, want in books[0]._asdict().items():
        np.testing.assert_array_equal(getattr(ism.state.codebook, name),
                                      want, name)


def _set(cfg, path, value):
    node = cfg["ObjectConfig"]
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


@pytest.mark.parametrize("path,value,reason", [
    (("Children", "GlobalFeatures", "Type"), "ESF", "global features"),
    (("Children", "GlobalFeatures", "Type"), "CVFH", "CVFH"),
    (("Children", "Features", "Type"), "PFH", "PFH"),
    (("Children", "Features", "Parameters", "ReferenceFrameType"), "BOARD",
     "BOARD"),
    (("Parameters", "UseDeviceMesh"), True, "UseDeviceMesh"),
])
def test_unported_training_configs_raise(path, value, reason):
    """What the port cannot train is refused, with the reason, before any
    file is read."""
    cfg = config()
    _set(cfg, path, value)
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    ism.add_training_model("no_such_file.pcd", 0, 0)
    with pytest.raises(NotImplementedError, match=reason):
        ism.train()
