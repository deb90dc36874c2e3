"""The port's global classifier (models/classifier.py) against the JAX
package's on the CPU, on seeded global descriptors: the ROI segmentation,
KNN under l2 and chi-square (K4's twin), single- and multi-object, k 1
and 3, one and several descriptors a segment; the SVM path on a
JAX-trained SVM carried over by SVMModel.from_arrays (pairwise and
one-vs-all), with its KNN instance labels; and merge functions 1-7 on the
same maxima lists."""

import copy

import numpy as np
import pytest
import torch

from point_cloud_donkey_tpu.models import classifier as jc
from point_cloud_donkey_tpu.models import voting as jv
from point_cloud_donkey_tpu.models.svm import train_svm
from point_cloud_donkey_tpu_torch.models import classifier as tc
from point_cloud_donkey_tpu_torch.models import voting as tv
from point_cloud_donkey_tpu_torch.models.svm import SVMModel

@pytest.fixture(scope="module")
def training():
    """30 histogram-like global descriptors of 3 classes (2 instances
    each), 32 wide, their radii, and seeded queries near them."""
    rng = np.random.default_rng(31)
    centres = np.abs(rng.normal(1.0, 0.6, (3, 32)))
    cls = np.repeat(np.arange(3), 10)
    desc = np.abs(centres[cls] + rng.normal(0, 0.25, (30, 32)))
    inst = cls * 2 + (np.arange(30) % 2)
    queries = np.abs(centres[rng.integers(0, 3, 6)]
                     + rng.normal(0, 0.35, (6, 32)))
    return (desc.astype(np.float32), cls.astype(np.int32),
            inst.astype(np.int32), queries.astype(np.float32))


def _pair(mod, training, **kw):
    desc, cls, inst, _ = training
    radii = {0: 0.5, 1: 0.8, 2: 1.0}
    return mod.GlobalClassifier(descriptors=desc, classes=cls,
                                instances=inst, average_radii=radii, **kw)


def _maximum(mod, cid):
    return mod.VotingMaximum(class_id=cid, instance_id=2 * cid,
                             position=np.array([0.1, 0.2, 0.3], np.float32))


def _assert_glob_equal(got, want, rtol=1e-5):
    """The global hypotheses equal, their scores within rtol (l2 KNN: the
    matmul identity's fp32 distances differ in their last bits between
    the two matmuls)."""
    assert got.glob_class_id == want.glob_class_id
    assert got.glob_instance_id == want.glob_instance_id
    np.testing.assert_allclose(got.glob_class_weight, want.glob_class_weight,
                               rtol=rtol)
    np.testing.assert_allclose(got.glob_instance_weight,
                               want.glob_instance_weight, rtol=rtol)


@pytest.mark.parametrize("metric", ["l2", "chisq"])
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_knn_matches_jax(training, metric, single, k):
    queries = training[3]
    jg = _pair(jc, training, metric=metric, k=k, single_object_mode=single)
    tg = _pair(tc, training, metric=metric, k=k, single_object_mode=single,
               device=torch.device("cpu"))
    for q0, q1, cid in ((0, 1, 0), (1, 3, 1), (3, 6, 2), (2, 3, 0)):
        want, got = _maximum(jv, cid), _maximum(tv, cid)
        jg.classify(queries[q0:q1], want)
        tg.classify(queries[q0:q1], got)
        _assert_glob_equal(got, want)


@pytest.mark.parametrize("one_vs_all", [False, True])
@pytest.mark.parametrize("single", [False, True])
def test_svm_matches_jax(training, one_vs_all, single):
    """A JAX-trained SVM carried over by its arrays: the same labels and
    scores, instance labels from KNN; too few points gives the maximum's
    own class at weight 0."""
    desc, cls, _, queries = training
    svm = train_svm(desc, cls, one_vs_all=one_vs_all, auto_train=False,
                    param_c=7.41, param_gamma=2.96)
    ported = SVMModel.from_arrays(_Arrays(svm.to_arrays()))
    jg = _pair(jc, training, method="SVM", svm=svm,
               single_object_mode=single)
    tg = _pair(tc, training, method="SVM", svm=ported,
               single_object_mode=single, device=torch.device("cpu"))
    for q0, q1, cid in ((0, 1, 0), (1, 4, 1), (4, 6, 2)):
        want, got = _maximum(jv, cid), _maximum(tv, cid)
        jg.classify(queries[q0:q1], want)
        tg.classify(queries[q0:q1], got)
        _assert_glob_equal(got, want)
    want, got = _maximum(jv, 1), _maximum(tv, 1)
    jg.classify(queries[:1], want, False)
    tg.classify(queries[:1], got, False)
    _assert_glob_equal(got, want)
    assert got.glob_class_weight == 0.0


class _Arrays(dict):
    @property
    def files(self):
        return list(self)


def test_segment_roi_matches_jax(training):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    jg, tg = _pair(jc, training), _pair(tc, training)
    for cid in range(3):
        a = jg.segment_roi(pts, nrm, _maximum(jv, cid))
        b = tg.segment_roi(pts, nrm, _maximum(tv, cid))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _maxima_lists():
    """Maxima lists with global hypotheses that agree and disagree with
    the local ones, at and away from the ROI centroid."""
    rng = np.random.default_rng(8)
    out = []
    for trial in range(4):
        ms = []
        for i in range(5):
            m = dict(class_id=int(rng.integers(3)),
                     instance_id=int(rng.integers(6)),
                     position=rng.uniform(-1, 1, 3).astype(np.float32) *
                     (0.1 if i % 2 else 1.0),
                     weight=float(rng.uniform(0.05, 1.0)),
                     instance_weight=float(rng.uniform(0.05, 1.0)))
            g = dict(glob_class_id=m["class_id"] if rng.random() < 0.6
                     else int(rng.integers(3)),
                     glob_class_weight=float(rng.choice([0.0, 0.5, 0.9])),
                     glob_instance_id=m["instance_id"]
                     if rng.random() < 0.6 else int(rng.integers(6)),
                     glob_instance_weight=float(rng.uniform(0, 1)))
            ms.append((m, g))
        ms.sort(key=lambda x: -x[0]["weight"])
        out.append(ms)
    return out


@pytest.mark.parametrize("merge_function", [1, 2, 3, 4, 5, 6, 7])
def test_merge_functions_match_jax(merge_function):
    for ms in _maxima_lists():
        for centroid in (np.zeros(3, np.float32),
                         np.array([0.05, 0.0, 0.0], np.float32)):
            lists = []
            for mod in (jv, tv):
                maxima = []
                for m, g in ms:
                    mx = mod.VotingMaximum(**copy.deepcopy(m))
                    for k, v in g.items():
                        setattr(mx, k, v)
                    maxima.append(mx)
                params = mod.VotingParams(merge_function=merge_function,
                                          bandwidth=0.6)
                (jc if mod is jv else tc).merge_global_and_local(
                    maxima, params, centroid)
                lists.append(maxima)
            for a, b in zip(*lists):
                assert (a.class_id, a.instance_id) == (b.class_id,
                                                       b.instance_id)
                assert a.weight == b.weight
                assert a.instance_weight == b.instance_weight
