"""The port's clustering (models/clustering.py) against the JAX package's on
the CPU, on the bench training features (the committed JAX-trained bench
codebook's codewords).

k-means starts from JAX's own seeds (its ``kmeans(..., iterations=0)``),
which ``run_clustering`` never passes: the two packages draw their
k-means++ seeds from different generators.  From the same seeds the
contract is: assignments equal except where a feature's two nearest
centres tie within rtol 1e-5, centres within rtol 1e-4.  Agglomerative
clustering (O(F^3) host Python in both packages) is held on ~50 features."""

import os

import numpy as np
import pytest
import torch

from bench_data import bench_clouds, feature_centre_distances

from point_cloud_donkey_tpu.models import clustering as jclu
from point_cloud_donkey_tpu_torch.models import clustering as tclu

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "point_cloud_donkey_tpu_torch", "data")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def features():
    with np.load(os.path.join(DATA, "bench_codebook.ismd.npz")) as z:
        desc, _, _ = feature_centre_distances(dict(z), bench_clouds(0)[0])
    return desc[::3].copy()      # 153 features of five classes


def distances(x, c, metric):
    if metric == "l2":
        return ((x[:, None] - c[None]) ** 2).sum(-1)
    s = x[:, None] + c[None]
    d = x[:, None] - c[None]
    return np.where(s > 0, d * d / np.where(s > 0, s, 1), 0).sum(-1)


def assert_kmeans_match(got, want, x, metric):
    (gc, ga), (wc, wa) = got, want
    assert gc.shape == wc.shape
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-6)
    for i in np.nonzero(ga != wa)[0]:
        d = distances(x[i:i + 1], wc, metric)[0]
        assert np.isclose(d[ga[i]], d[wa[i]], rtol=1e-5), i


@pytest.mark.parametrize("metric", ["chisq", "l2"])
@pytest.mark.parametrize("k", [1, 16])
def test_kmeans_from_jax_seeds_matches_jax(features, metric, k):
    seeds, _ = jclu.kmeans(features, k, metric, iterations=0)
    want = jclu.kmeans(features, k, metric, iterations=20)
    got = tclu.kmeans(features, k, metric, iterations=20, device=CPU,
                      init_centers=np.asarray(seeds))
    assert_kmeans_match(got, (np.asarray(want[0]), np.asarray(want[1])),
                        features, metric)


def test_kmeans_hartigan_from_jax_seeds_matches_jax(features):
    max_k = 4
    seeds = [np.asarray(jclu.kmeans(features, k, "chisq", iterations=0)[0])
             for k in range(1, max_k + 1)]
    want = jclu.run_clustering(features, jclu.ClusteringParams(
        type="KMeansHartigan", max_k=max_k, iterations=20), "chisq")
    got = tclu.kmeans_hartigan(features, max_k, "chisq", 20, CPU, seeds)
    assert_kmeans_match(got, want, features, "chisq")


@pytest.mark.parametrize("metric", ["chisq", "l2"])
def test_agglomerative_matches_jax(features, metric):
    x = features[:48]
    thresh = 1.0 if metric == "chisq" else 3.0
    want = jclu.agglomerative(x, metric, thresh)
    got = tclu.agglomerative(x, metric, thresh)
    assert 1 < len(got[0]) < len(x)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


@pytest.mark.parametrize("kind,count", [
    ("KMeansCount", 7), ("KMeansFactor", int(0.1 * 153)),
    ("KMeansThumbRule", int(round(np.sqrt(153 / 2.0)))), ("None", 153)])
def test_run_clustering_types(features, kind, count):
    """Each type's centre count; the seeds come from the port's generator
    (its own draws: two runs equal, every seed a feature)."""
    params = tclu.ClusteringParams(type=kind, cluster_count=7,
                                   cluster_factor=0.1, iterations=5)
    c, a = tclu.run_clustering(features, params, "chisq", CPU)
    c2, a2 = tclu.run_clustering(features, params, "chisq", CPU)
    assert c.shape == (count, features.shape[1]) and a.shape == (153,)
    np.testing.assert_array_equal(c, c2)
    np.testing.assert_array_equal(a, a2)
    seeds = tclu.kmeans_seeds(torch.from_numpy(features), 7, "chisq").numpy()
    assert all((features == s).all(1).any() for s in seeds)
    assert len({tuple(s) for s in seeds}) == 7
