"""The port's SVM (models/svm.py, numpy on the host) against the JAX
package's on the CPU: on the same global descriptors both train the same
model -- the same (C, gamma) from the auto grid, support vectors and
coefficients -- and predict the same classes with the same scores; the
arrays round-trip through ``to_arrays`` / ``from_arrays``, and a model the
port saves loads in the JAX package's SVMModel, which predicts as the port
does."""

import os

import numpy as np
import pytest

from point_cloud_donkey_tpu.models import svm as jsvm
from point_cloud_donkey_tpu_torch.models import svm as tsvm

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "point_cloud_donkey_tpu_torch", "data")


@pytest.fixture(scope="module")
def descriptors():
    """The JAX-CPU CSHOT_GLOBAL descriptors of the 24 coloured training
    views (train_reference.npz), and their classes."""
    with np.load(os.path.join(DATA, "train_reference.npz")) as z:
        return z["glob_cshot_global"], z["glob_cls_cshot_global"]


def assert_models_equal(got, want):
    assert got.mode == want.mode and got.pairs == want.pairs
    np.testing.assert_array_equal(got.classes, want.classes)
    assert len(got.binaries) == len(want.binaries)
    for g, w in zip(got.binaries, want.binaries):
        assert g.gamma == w.gamma
        np.testing.assert_array_equal(g.sv, w.sv)
        np.testing.assert_allclose(g.coeffs, w.coeffs, rtol=1e-9, atol=1e-12)
        assert g.b == pytest.approx(w.b, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("one_vs_all,auto", [(False, True), (True, False),
                                             (False, False), (True, True)])
def test_svm_matches_jax(descriptors, one_vs_all, auto):
    x, y = descriptors
    k_fold = 3
    if one_vs_all and auto:       # the fine grid over every class: ~1400
        x, y, k_fold = x[:10], y[:10], 2    # (C, gamma) pairs a class
    got = tsvm.train_svm(x, y, one_vs_all=one_vs_all, auto_train=auto,
                         k_fold=k_fold)
    want = jsvm.train_svm(x, y, one_vs_all=one_vs_all, auto_train=auto,
                          k_fold=k_fold)
    assert_models_equal(got, want)
    for d in x:
        g, w = got.predict(d), want.predict(d)
        assert g[0] == w[0]
        np.testing.assert_allclose(g[2], w[2], rtol=1e-9)


def test_chi2_matrix_matches_jax(descriptors):
    from point_cloud_donkey_tpu.ops.neighbors import chi_square_distance_np
    x, _ = descriptors
    np.testing.assert_array_equal(tsvm.chi2_matrix(x, x[:7], 1 << 12),
                                  chi_square_distance_np(x, x[:7], 1 << 12))


def test_saved_svm_loads_in_jax(descriptors, tmp_path):
    x, y = descriptors
    model = tsvm.train_svm(x, y, one_vs_all=False, auto_train=False)
    path = str(tmp_path / "svm.npz")
    np.savez(path, **model.to_arrays())
    with np.load(path) as z:
        loaded = jsvm.SVMModel.from_arrays(z)
        again = tsvm.SVMModel.from_arrays(z)
    assert_models_equal(again, model)
    for d in x:
        assert loaded.predict(d)[0] == model.predict(d)[0]
