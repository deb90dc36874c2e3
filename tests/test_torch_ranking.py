"""The port's feature ranking (models/ranking.py) against the JAX package's
``rank_features`` on the CPU, on the bench training features (the
committed JAX-trained bench codebook's codewords, 458 SHOT descriptors of
five classes), every scorer and its options.

The contract: keep masks equal except at the window's edge, where a
feature whose mask differs has a score within rtol 1e-5 of the score the
JAX ranking puts at the edge of its class's window.  The port's kNN is
exact chi-square through ops/neighbors.knn (K4's twin for k <= 3, K4m's
twin and a stable selection above); the JAX package's is exact on the
CPU."""

import os

import numpy as np
import pytest
import torch

from bench_data import bench_clouds, feature_centre_distances

from point_cloud_donkey_tpu.models import ranking as jrank
from point_cloud_donkey_tpu.utils.config import ComponentConfig as JaxComp
from point_cloud_donkey_tpu_torch.models import ranking as trank
from point_cloud_donkey_tpu_torch.utils.config import ComponentConfig

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "point_cloud_donkey_tpu_torch", "data")


@pytest.fixture(scope="module")
def features():
    with np.load(os.path.join(DATA, "bench_codebook.ismd.npz")) as z:
        return feature_centre_distances(dict(z), bench_clouds(0)[0])


def assert_keeps_match(got, want, desc, cls, cdist, cfg):
    """The contract above (module docstring)."""
    differ = np.nonzero(got != want)[0]
    if not len(differ):
        return
    params = jrank.RankingParams.from_config(JaxComp.from_json(cfg),
                                             flann_exact=True)
    scores = jrank._compute_scores(desc, cls, cdist, params)
    for fi in differ:
        sel = np.nonzero(cls == cls[fi])[0]
        order = np.sort(scores[sel])
        lo = int(np.ceil(len(sel) * params.resolved_offset()))
        hi = int(np.ceil(len(sel) * (params.factor
                                     + params.resolved_offset()))) - 1
        edges = order[[max(lo - 1, 0), lo, min(hi, len(order) - 1),
                       min(hi + 1, len(order) - 1)]]
        assert np.isclose(scores[fi], edges, rtol=1e-5).any(), \
            (fi, scores[fi], edges)


CASES = {
    "naive_bayes": {"Type": "NaiveBayes", "Parameters": {
        "KSearch": 10, "Factor": 0.75, "ExtractFromList": "front"}},
    "naive_bayes_dist": {"Type": "NaiveBayes", "Parameters": {
        "KSearch": 10, "DistanceThreshold": 0.6, "Factor": 0.5,
        "ExtractFromList": "center"}},
    "incremental": {"Type": "Incremental", "Parameters": {
        "KSearch": 10, "Factor": 0.75, "ExtractFromList": "front"}},
    "incremental_k2": {"Type": "Incremental", "Parameters": {
        "KSearch": 2, "Factor": 0.6, "ExtractFromList": "back"}},
    **{f"knn_activation_{inc}{'_pos' if pos else ''}": {
        "Type": "KNNActivation", "Parameters": {
            "KSearch": 10, "Factor": 0.75, "ExtractFromList": "front",
            "ScoreIncrementType": inc, "UseFeaturePosition": pos}}
       for inc in (0, 1, 2, 3) for pos in (False, True)},
    "strangeness": {"Type": "Strangeness", "Parameters": {
        "KSearch": 10, "Factor": 0.75, "ExtractFromList": "front"}},
    "strangeness_offset": {"Type": "Strangeness", "Parameters": {
        "KSearch": 3, "Factor": 0.5, "ExtractOffset": 0.2}},
    **{f"similarity_{ut}_{intra}": {"Type": "Similarity", "Parameters": {
        "KSearch": 10, "Factor": 0.75, "ExtractFromList": "front",
        "UpdateType": ut, "IntraPosition": intra}}
       for ut, intra in (("score", "center"), ("dist", "front"),
                         ("count", "back"))},
    "uniform": {"Type": "Uniform"},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rankers_match_jax(features, name):
    desc, cls, cdist = features
    cfg = CASES[name]
    want = jrank.rank_features(desc, cls, cdist, jrank.RankingParams.from_config(
        JaxComp.from_json(cfg), flann_exact=True))
    got = trank.rank_features(desc, cls, cdist,
                              trank.RankingParams.from_config(
                                  ComponentConfig.from_json(cfg)),
                              torch.device("cpu"))
    assert got.dtype == bool and got.shape == want.shape
    assert_keeps_match(got, want, desc, cls, cdist, cfg)
    if name != "uniform":
        assert 0 < got.sum() < len(got)


def test_ranking_offsets():
    p = trank.RankingParams(factor=0.6)
    assert [trank.RankingParams(factor=0.6, extract_list=e).resolved_offset()
            for e in ("front", "center", "back")] == \
        pytest.approx([0.0, 0.2, 0.4])
    assert p.resolved_offset() == 0.0
    assert trank.RankingParams(extract_offset=0.3).resolved_offset() == 0.3
