"""The port's training of the configurations the fused route alone does
not cover -- MVBB boxes, preprocessing, normals provided by the files and
ConsistentNormalsMethod 3 (the staged route), a ranker, k-means and the
feature cache -- against the JAX package's training on the CPU, on 6
models of 3 classes (tests/test_torch_train.py's draw, 1024 points).

The JAX references run its fused route (PCD_TRAIN_FUSED=1) where it can
and its staged route with the dense descriptors (PCD_DENSE_DESC=1) where
it cannot: the formulation the port computes.  Each training is held to
tests/test_torch_train.py's codebook contract (the same codewords and vote
structure, >= 97% of the codewords at cosine > 0.999, class sigmas within
rtol 5e-2) and the per-class dimensions."""

import os

import numpy as np
import pytest

import shapes
from test_torch_train import CLASSES, N_MODELS, N_POINTS, \
    assert_codebooks_match, config

from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel as JaxIsm
from point_cloud_donkey_tpu.utils.config import IsmConfig as JaxConfig
from point_cloud_donkey_tpu.utils.io import PointCloud as JaxCloud
from point_cloud_donkey_tpu.utils.io import save_pcd as jax_save_pcd
from point_cloud_donkey_tpu_torch.models import features as tfeat
from point_cloud_donkey_tpu_torch.models.ism import ImplicitShapeModel
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig


def jax_train(files, cfg):
    """The JAX package's training of `cfg` on the CPU: the fused route
    where it applies, dense descriptors on the staged route."""
    keys = ("PCD_TRAIN_FUSED", "PCD_DENSE_DESC")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        ism = JaxIsm(JaxConfig.from_json(cfg))
        for path, cid in files:
            ism.add_training_model(path, cid, cid)
        ism.train()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ism


def port_train(files, cfg):
    ism = ImplicitShapeModel(IsmConfig.from_json(cfg), "cpu")
    for path, cid in files:
        ism.add_training_model(path, cid, cid)
    ism.train()
    return ism


def with_params(cfg=None, **params):
    cfg = cfg or config()
    cfg["ObjectConfig"]["Parameters"].update(params)
    return cfg


def with_child(name, value, cfg=None):
    cfg = cfg or config()
    cfg["ObjectConfig"]["Children"][name] = value
    return cfg


def assert_trainings_match(got, want):
    assert_codebooks_match(got.state.codebook, want.state.codebook)
    for cid, dims in want.state.dims_map.items():
        np.testing.assert_allclose(got.state.dims_map[cid], dims, rtol=1e-4)


@pytest.fixture(scope="module")
def clouds():
    """The six models' points and, for the files that carry them, their
    normals: the JAX fused route's method-2 normals of each cloud."""
    import jax
    from point_cloud_donkey_tpu.ops.normals import compute_normals
    rng = np.random.default_rng(11)
    pts = [shapes.make_instance(rng, i % CLASSES, n=N_POINTS, rotate=True,
                                noise=0.005).astype(np.float32)
           for i in range(N_MODELS)]
    r = config()["ObjectConfig"]["Parameters"]["NormalRadius"]
    step = jax.jit(lambda p: compute_normals(p, np.ones(len(p), bool), r,
                                             2).normals)
    return pts, [np.asarray(step(p)) for p in pts]


@pytest.fixture(scope="module")
def files(clouds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("staged")
    out = []
    for i, p in enumerate(clouds[0]):
        path = str(tmp / f"m{i}.pcd")
        jax_save_pcd(path, JaxCloud(xyz=p))
        out.append((path, i % CLASSES))
    return out


@pytest.fixture(scope="module")
def normal_files(clouds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("normals")
    out = []
    for i, (p, nrm) in enumerate(zip(*clouds)):
        path = str(tmp / f"n{i}.pcd")
        jax_save_pcd(path, JaxCloud(xyz=p, normals=nrm))
        out.append((path, i % CLASSES))
    return out


CONFIGS = {
    "mvbb": lambda: with_params(BoundingBoxType="MVBB"),
    "sor_voxel_z": lambda: with_params(
        UseStatisticalOutlierRemoval=True, UseVoxelFiltering=True,
        VoxelLeafSize=0.02, CutoffDistanceZAxis=2.0),
    "mls": lambda: with_params(UseSmoothing=True, SmoothingRadius=0.1),
    "normals_m3": lambda: with_params(ConsistentNormalsMethod=3),
    "knn_activation": lambda: with_child("FeatureWeighting", {
        "Type": "KNNActivation", "Parameters": {
            "KSearch": 10, "Factor": 0.75, "ExtractFromList": "front",
            "ScoreIncrementType": 2, "UseFeaturePosition": True}}),
    "similarity": lambda: with_child("FeatureWeighting", {
        "Type": "Similarity", "Parameters": {
            "KSearch": 10, "Factor": 0.75, "ExtractFromList": "center"}}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_training_configs_match_jax(files, name):
    cfg = CONFIGS[name]()
    want = jax_train(files, cfg)
    got = port_train(files, cfg)
    assert_trainings_match(got, want)
    if name == "mvbb":
        cb, wcb = got.state.codebook, want.state.codebook
        m = cb.vote_mask
        np.testing.assert_allclose(
            np.sort(cb.bbox_size[m], axis=1),
            np.sort(np.asarray(wcb.bbox_size)[m], axis=1), rtol=1e-4)


def test_files_with_normals_train_on_the_staged_route(files, normal_files,
                                                      monkeypatch):
    """Files that carry normals train with those normals (JAX: its staged
    route), and give the codebook the fused route computes from the same
    normals."""
    cfg = config()
    want = jax_train(normal_files, cfg)
    calls = []
    real = tfeat.compute_cloud_normals
    monkeypatch.setattr("point_cloud_donkey_tpu_torch.models.detect_batch."
                        "compute_cloud_normals",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = port_train(normal_files, cfg)
    assert calls
    assert_trainings_match(got, want)
    assert_codebooks_match(got.state.codebook,
                           port_train(files, cfg).state.codebook)


def test_kmeans_training_clusters_the_features(files):
    """KMeansCount trains a codebook over the k-means centres (the port's
    own seeds: two trainings equal), activated against the centres."""
    cfg = with_child("Clustering", {"Type": "KMeansCount", "Parameters": {
        "ClusterCount": 40, "Iterations": 10}})
    cfg = with_child("Codebook", {"Children": {"ActivationStrategy": {
        "Type": "KNN", "Parameters": {"K": 2}}}}, cfg)
    a, b = port_train(files, cfg), port_train(files, cfg)
    for k, v in a.state.codebook._asdict().items():
        np.testing.assert_array_equal(v, getattr(b.state.codebook, k), k)
    cb = a.state.codebook
    assert cb.num_codewords == 40
    assert cb.vote_mask.sum() % 2 == 0 and cb.vote_mask.sum(1).max() > 2


KMEANS = {
    "count": {"Type": "KMeansCount", "Parameters": {"ClusterCount": 40}},
    "hartigan": {"Type": "KMeansHartigan", "Parameters": {"MaxK": 6}},
}


@pytest.mark.parametrize("name", sorted(KMEANS))
def test_kmeans_training_from_jax_seeds_matches_jax(files, name):
    """KMeansCount and KMeansHartigan, the port's k-means started from the
    features that JAX's k-means++ seeding picks in its training: the same
    codebook over the centres -- the codeword count (Hartigan's k), the
    vote structure of the activation at K=2, the centres at cosine > 0.999
    -- as JAX's training."""
    from bench_data import seeded_kmeans
    from torch_fixtures import recorded_kmeans_seeds
    cfg = with_child("Clustering", KMEANS[name])
    cfg = with_child("Codebook", {"Children": {"ActivationStrategy": {
        "Type": "KNN", "Parameters": {"K": 2}}}}, cfg)
    with recorded_kmeans_seeds() as seeds:
        want = jax_train(files, cfg)
    with seeded_kmeans(seeds):
        got = port_train(files, cfg)
    assert_trainings_match(got, want)
    count = got.state.codebook.num_codewords
    assert count == 40 if name == "count" else count > 1   # Hartigan's k


def test_feature_cache_reads_back_the_same_state(files, tmp_path,
                                                 monkeypatch):
    """CacheFeatures: the first training writes each file's features to
    CacheFeaturesFolder, the second reads them (no extraction) and trains
    the same state bit for bit, which is the uncached training's."""
    cfg = with_params(CacheFeatures=True,
                      CacheFeaturesFolder=str(tmp_path / "cache"))
    plain = port_train(files, config())
    first = port_train(files, cfg)
    assert len(os.listdir(tmp_path / "cache")) == N_MODELS
    monkeypatch.setattr("point_cloud_donkey_tpu_torch.models.ism."
                        "extract_local_features_batch",
                        lambda *a, **k: pytest.fail("extracted again"))
    second = port_train(files, cfg)
    for k, v in first.state.codebook._asdict().items():
        np.testing.assert_array_equal(v, getattr(second.state.codebook, k), k)
        np.testing.assert_array_equal(v, getattr(plain.state.codebook, k), k)


def test_feature_cache_is_keyed_on_the_loaded_cloud(files, tmp_path,
                                                    monkeypatch):
    """A change to what loading makes of a file -- here MLS's
    SmoothingRadius, which moves the points and keeps their count --
    extracts the features again instead of reading the cache; the same
    config reads it."""
    from point_cloud_donkey_tpu_torch.models import ism as tism
    real = tism.extract_local_features_batch
    extracted = []
    monkeypatch.setattr(tism, "extract_local_features_batch",
                        lambda xyzs, *a, **k: extracted.append(len(xyzs))
                        or real(xyzs, *a, **k))
    for radius in (0.1, 0.1, 0.15):
        port_train(files, with_params(
            CacheFeatures=True, CacheFeaturesFolder=str(tmp_path / "cache"),
            UseSmoothing=True, SmoothingRadius=radius))
    assert extracted == [N_MODELS, N_MODELS]
    assert len(os.listdir(tmp_path / "cache")) == 2 * N_MODELS
