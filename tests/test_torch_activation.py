"""The port's codebook activations (models/codebook.py) and K4m, the
[Q, C] chi-square matrix (ops/kernels/chisq.chisq_matrix), against the JAX
package on the CPU:

  * K4m's plain twin against ``chi_square_distance_matrix_pallas`` in
    interpret mode (in a process of its own, torch_parity.pallas_interpret)
    at D = 352, 176 (partial SHOT), 1344 (CSHOT) and a ragged D, with
    masked codewords, and on queries with negative entries (INN's refined
    queries), where terms with a + b <= 0 count 0;
  * ``knn`` at k = 5 and 64 (K4m and the stable-sort selection) against the
    JAX ``knn``, and at k <= 3 equal to K4's fused top-k;
  * ``cast_votes`` under every activation (KNN K=5, KNNRule, INN,
    Threshold, an unknown name) and under partial SHOT (front, back; SHOT
    and CSHOT) against the JAX ``cast_votes`` on the committed codebooks,
    on the JAX features of two bench clouds: votes equal where the
    selection agrees, and the rows that disagree only at near-ties (two
    distances, or a distance and the threshold or a ratio and its limit,
    within K4's rtol 1e-5);
  * ``inn_refine_queries`` against the JAX function, round by round;
  * IsmClassifier under each activation configuration of
    data/config_reference.npz against its committed JAX-CPU scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_data import KEYPOINT_CAPACITY, bench_colors
from torch_fixtures import (CODEBOOKS, CONFIG_REFERENCE, CONFIGS, REFERENCE,
                            THRESHOLD, jax_pipeline_config)
from torch_parity import (assert_decisions_match, assert_topk_close, n,
                          pallas_interpret, t)

from point_cloud_donkey_tpu.models import codebook as jcb
from point_cloud_donkey_tpu.models.pipeline_jit import extract_features_jit
from point_cloud_donkey_tpu.ops.neighbors import \
    chi_square_distance_matrix as j_chisq
from point_cloud_donkey_tpu.ops.neighbors import knn as j_knn
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models import codebook as tcb
from point_cloud_donkey_tpu_torch.models.pipeline import (IsmClassifier,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops.kernels import chisq as tchisq
from point_cloud_donkey_tpu_torch.ops.neighbors import knn as t_knn
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

RTOL = 1e-5    # K4's distance contract

# --- K4m ---------------------------------------------------------------------

K4M_CASES = {"d352": 352, "d176": 176, "d1344": 1344, "ragged": 101,
             "negative": 352}


def k4m_case(name):
    """Sparse non-negative queries [60, D] and codewords [130, D] (60%
    zeros), ~10% of the codewords masked; "negative" gives a third of the
    queries' zeros small negative values, some exactly minus the
    codeword entry below them (a + b = 0), as INN's refinement does."""
    rng = np.random.default_rng(sorted(K4M_CASES).index(name) + 40)
    dim = K4M_CASES[name]
    a = rng.random((60, dim)).astype(np.float32)
    a[rng.random(a.shape) < 0.6] = 0.0
    b = rng.random((130, dim)).astype(np.float32)
    b[rng.random(b.shape) < 0.6] = 0.0
    mask = rng.random(130) > 0.1
    if name == "negative":
        neg = (a == 0) & (rng.random(a.shape) < 0.3)
        a[neg] = -0.01 * rng.random(int(neg.sum())).astype(np.float32)
        a[5, :40] = -b[7, :40]
    return a, b, mask


_K4M_CODE = """
import jax.numpy as jnp
from point_cloud_donkey_tpu.ops.pallas.chisq import \\
    chi_square_distance_matrix_pallas
out = {name: chi_square_distance_matrix_pallas(
    jnp.asarray(a[name + "__a"]), jnp.asarray(a[name + "__b"]))
    for name in %r}
""" % (sorted(K4M_CASES),)


@pytest.fixture(scope="module")
def pallas_k4m(tmp_path_factory):
    arrays = {}
    for name in K4M_CASES:
        arrays[name + "__a"], arrays[name + "__b"], _ = k4m_case(name)
    return pallas_interpret(_K4M_CODE, str(tmp_path_factory.mktemp("k4m")),
                            **arrays)


@pytest.mark.parametrize("name", sorted(K4M_CASES))
def test_chisq_matrix_twin_matches_pallas_interpret(name, pallas_k4m):
    """K4m's twin vs `_chisq_call` through
    chi_square_distance_matrix_pallas: distances within rtol 1e-5, +inf
    exactly at the masked codewords; on negative queries the pairs with
    a + b <= 0 (and a + b = 0 exactly) are there and count 0 in both."""
    a, b, mask = k4m_case(name)
    want = np.where(mask[None, :], pallas_k4m[name], np.inf)
    got = n(tchisq.chisq_matrix(t(a), t(b), t(mask)))
    assert got.shape == (60, 130)
    np.testing.assert_array_equal(np.isinf(got), ~mask[None, :].repeat(60, 0))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    if name == "negative":
        s = a[:, None, :] + b[None, :, :]
        assert (s < 0).any() and (s[5, 7, :40] == 0).all()
        # the terms with s <= 0 leave the sum as if they were absent
        keep = s > 0
        diff = a[:, None, :] - b[None, :, :]
        exact = np.where(keep, diff * diff / np.where(keep, s, 1), 0).sum(-1)
        np.testing.assert_allclose(got[:, mask], exact[:, mask], rtol=RTOL)


def test_chisq_matrix_checks_inputs():
    a, b = torch.rand(4, 8), torch.rand(6, 8)
    m = torch.ones(6, dtype=torch.bool)
    with pytest.raises(TypeError):
        tchisq.chisq_matrix(a.double(), b, m)
    with pytest.raises(ValueError):
        tchisq.chisq_matrix(a, torch.rand(6, 9), m)
    with pytest.raises(ValueError):
        tchisq.chisq_matrix(torch.rand(8, 4).T, b, m)
    build.reset_launch_counts()
    tchisq.chisq_matrix(a, b, m)
    assert build.launch_counts()["chisq_matrix"] == 0


@pytest.mark.parametrize("k", [5, 64])
def test_knn_above_three_matches_jax(k):
    """knn(k > 3): K4m's matrix and the stable-sort selection vs the JAX
    knn (XLA matrix + lax.top_k): distances rtol 1e-5, indices equal
    except at ties; a row chunk smaller than Q gives the same rows."""
    a, b, mask = k4m_case("d352")
    jd, ji = j_knn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), k,
                   "chisq")
    td, ti = t_knn(t(a), t(b), t(mask), k, "chisq")
    assert td.shape == (60, k) and ti.dtype == torch.int64
    assert_topk_close(td, ti, jd, ji, rtol=RTOL)


def test_knn_above_three_in_row_chunks(monkeypatch):
    from point_cloud_donkey_tpu_torch.ops import neighbors
    a, b, mask = k4m_case("d176")
    whole = t_knn(t(a), t(b), t(mask), 7, "chisq")
    monkeypatch.setattr(neighbors, "_MATRIX_BYTES", 4 * 130 * 16)
    chunked = t_knn(t(a), t(b), t(mask), 7, "chisq")
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_knn_up_to_three_is_the_fused_top_k(k, monkeypatch):
    """knn(k <= 3) takes K4's fused top-k, whose distances and indices are
    the first k of K4m's selection."""
    a, b, mask = k4m_case("ragged")
    from point_cloud_donkey_tpu_torch.ops import neighbors
    calls = []
    monkeypatch.setattr(neighbors, "chisq_matrix",
                        lambda *x: calls.append(1))
    d, i = t_knn(t(a), t(b), t(mask), k, "chisq")
    assert not calls
    monkeypatch.undo()
    d5, i5 = t_knn(t(a), t(b), t(mask), 5, "chisq")
    assert torch.equal(d, d5[:, :k]) and torch.equal(i, i5[:, :k])


# --- cast_votes ----------------------------------------------------------------

@pytest.fixture(scope="module")
def features():
    """The JAX-CPU features of the first two reference clouds for the SHOT
    and the CSHOT codebooks (bench colours): descriptor -> (descriptors
    [F, D], positions [F, 3], frames [F, 3, 3], valid [F]), and each
    codebook as (JAX TrainedCodebook, port Codebook)."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:2]
    mask = np.ones(pts.shape[:2], bool)
    out = {}
    for desc in ("SHOT", "CSHOT"):
        cfg = jax_pipeline_config(desc)
        rgb = jnp.asarray(bench_colors(pts)) if desc == "CSHOT" else None
        kp, fr, d, v = jax.jit(jax.vmap(
            lambda p, m, r: extract_features_jit(p, m, cfg, r),
            in_axes=(0, 0, None if rgb is None else 0)))(
                jnp.asarray(pts), jnp.asarray(mask), rgb)
        feats = tuple(np.asarray(x).reshape((-1,) + x.shape[2:])
                      for x in (d, kp, fr, v))
        with np.load(CODEBOOKS[desc] + "d.npz") as z:
            arrays = {k: z[k] for k in z.files}
        jax_cb = jcb.TrainedCodebook(**{k[3:]: jnp.asarray(v)
                                        for k, v in arrays.items()
                                        if k.startswith("cb_")})
        out[desc] = feats, (jax_cb, tcb.Codebook.from_numpy(arrays))
    return out


def _near_tie_rows(desc, cw, cw_mask, params):
    """Rows whose selection can turn on a near-tie within rtol 1e-5 (on
    the JAX distances of the descriptors actually matched): two of the
    nearest k + 1 distances, the threshold and a distance of the kept
    range, or a ratio test and its limit."""
    d = np.asarray(j_chisq(jnp.asarray(desc), jnp.asarray(cw)))
    d = np.sort(np.where(cw_mask[None, :], d, np.inf), axis=1)
    t_ = params.activation_type
    k = {"KNNRule": 3, "Threshold": params.threshold_capacity,
         "INN": 1}.get(t_, params.knn_k)
    top = d[:, :min(k + 1, d.shape[1])]
    near = (np.abs(np.diff(top, axis=1)) <= RTOL * top[:, 1:]).any(1)
    if t_ == "Threshold":
        near |= (np.abs(top - params.threshold)
                 <= RTOL * params.threshold).any(1)
    if t_ == "KNNRule" or params.use_distance_ratio:
        rt = params.distance_ratio_threshold
        for j in range(1, min(3, top.shape[1])):
            r = top[:, 0] / np.maximum(top[:, j], 1e-30)
            near |= np.abs(r - rt) <= 2 * RTOL * rt
    return near


def _votes_by_row(v, f):
    return {name: n(x).reshape((f, -1) + tuple(x.shape[1:]))
            for name, x in v._asdict().items()}


def _assert_votes_match(tv, jv, f, allowed):
    """Votes equal (classes, instances and validity exactly, positions,
    weights and boxes within rtol 1e-5) on every row but the `allowed`
    ones; returns the rows that differ."""
    tr, jr = _votes_by_row(tv, f), _votes_by_row(jv, f)
    assert tr["valid"].shape == jr["valid"].shape
    differ = np.zeros(f, bool)
    for name in ("valid", "class_id", "instance_id"):
        differ |= (tr[name] != jr[name]).reshape(f, -1).any(1)
    for name in ("position", "weight", "keypoint_training", "bbox_size",
                 "bbox_quat"):
        a, b = tr[name], jr[name]
        close = np.isclose(a, b, rtol=RTOL, atol=1e-5)
        differ |= ~close.reshape(f, -1).all(1)
    assert not (differ & ~allowed).any(), np.nonzero(differ & ~allowed)
    return differ


ACTIVATIONS = {
    "knn5": {"knn_k": 5, "use_matching_weight": True},
    "knn1_ratio": {"use_distance_ratio": True, "use_matching_weight": True},
    "knnrule": {"activation_type": "KNNRule"},
    "threshold": {"activation_type": "Threshold", "threshold": THRESHOLD,
                  "use_matching_weight": True},
    "unknown": {"activation_type": "Nearest"},
    "partial_front": {"use_partial_shot": True,
                      "partial_shot_type": "front"},
    "partial_back": {"use_partial_shot": True, "partial_shot_type": "back",
                     "knn_k": 2},
    "partial_unknown": {"use_partial_shot": True,
                        "partial_shot_type": "sideways"},
}


@pytest.mark.parametrize("name,desc", [
    *((name, "SHOT") for name in sorted(ACTIVATIONS)),
    ("partial_front", "CSHOT"), ("partial_back", "CSHOT")])
def test_cast_votes_matches_jax(features, name, desc):
    """cast_votes vs the JAX cast_votes under `name`, on the JAX features
    of two bench clouds (a third of the rows masked): votes equal but at
    near-ties; under Threshold a median of more than one codeword a
    feature lies within the threshold, and some features reach the cap
    of 64."""
    (d, pos, fr, valid), (jax_cb, t_cb) = features[desc]
    fmask = valid.copy()
    fmask[::3] = False
    fields = ACTIVATIONS[name]
    jp = jcb.CodebookParams(flann_exact=True, **fields)
    tp = tcb.CodebookParams(**fields)
    jv = jcb.cast_votes(jax_cb, jnp.asarray(d), jnp.asarray(pos),
                        jnp.asarray(fr), jnp.asarray(fmask), jp, "chisq")
    tv = tcb.cast_votes(t_cb, t(d), t(pos), t(fr), t(fmask), tp, "chisq")
    cw, cw_mask = np.asarray(jax_cb.codewords), np.asarray(jax_cb.cw_mask)
    matched = d
    smask = jcb.signature_mask(tp.partial_shot_type)
    if tp.use_partial_shot and not smask.all():
        cols = jcb.partial_shot_columns(smask, d.shape[1])
        np.testing.assert_array_equal(
            tcb.partial_shot_columns(tcb.signature_mask(
                tp.partial_shot_type), d.shape[1]), cols)
        assert len(cols) == d.shape[1] // 2
        matched, cw = d[:, cols], cw[:, cols]
    allowed = _near_tie_rows(matched, cw, cw_mask, tp)
    differ = _assert_votes_match(tv, jv, len(d), allowed)
    print(f"{name} {desc}: {int(differ.sum())} rows differ at near-ties "
          f"(of {int(allowed.sum())} near-tied, {len(d)} rows)")
    assert n(tv.valid).any()
    if name == "threshold":
        dist, _ = t_knn(t(d), t_cb.codewords, t_cb.cw_mask, 64, "chisq")
        within = (n(dist) < THRESHOLD).sum(1)[fmask]
        assert np.median(within) > 1 and (within == 64).any()


def test_partial_codewords_are_cached_per_type_and_width(features):
    _, (_, t_cb) = features["SHOT"]
    cols, cw = t_cb.partial("front", 352)
    assert cw.shape == (t_cb.codewords.shape[0], 176) and cw.is_contiguous()
    assert t_cb.partial("front", 352)[1] is cw
    assert torch.equal(cw, t_cb.codewords[:, cols])
    assert t_cb.partial("back", 352)[1] is not cw


def test_inn_refinement_matches_jax(features):
    """inn_refine_queries vs the JAX function: the 1-NN of every round
    agrees on >= 99% of the features (a near-tie in a round changes every
    later round of its feature, printed), and the refined queries of the
    features whose every round agreed are within 1e-6 of JAX's; the
    refined queries hold negative entries."""
    (d, _, _, valid), (jax_cb, t_cb) = features["SHOT"]
    d = d[valid]
    cw = np.asarray(jax_cb.codewords)
    cw_mask = np.asarray(jax_cb.cw_mask)
    jq, tq = jnp.asarray(d), t(d)
    agree = np.ones(len(d), bool)
    for r in range(5):
        _, ji = j_knn(jq, jnp.asarray(cw), jnp.asarray(cw_mask), 1, "chisq")
        _, ti = t_knn(tq, t(cw), t(cw_mask), 1, "chisq")
        same = np.asarray(ji)[:, 0] == n(ti)[:, 0]
        print(f"INN round {r + 1}: 1-NN agrees on {int(same.sum())}/"
              f"{len(d)}")
        agree &= same
        jq = jcb.inn_refine_queries(jq, jnp.asarray(cw),
                                    jnp.asarray(cw_mask), "chisq", 1, 0.01)
        tq = tcb.inn_refine_queries(tq, t(cw), t(cw_mask), "chisq", 1, 0.01)
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(n(tq)[agree], np.asarray(jq)[agree],
                               atol=1e-6)
    full = tcb.inn_refine_queries(t(d), t(cw), t(cw_mask), "chisq", 5, 0.01)
    assert torch.equal(full, tq)
    assert (n(full) < 0).any()


def test_cast_votes_under_inn_matches_jax(features):
    """INN: the 1-NN of the refined queries; votes equal on the features
    whose refinement chose the same neighbours in every round."""
    (d, pos, fr, valid), (jax_cb, t_cb) = features["SHOT"]
    jp = jcb.CodebookParams(activation_type="INN", flann_exact=True)
    tp = tcb.CodebookParams(activation_type="INN")
    jv = jcb.cast_votes(jax_cb, jnp.asarray(d), jnp.asarray(pos),
                        jnp.asarray(fr), jnp.asarray(valid), jp, "chisq")
    tv = tcb.cast_votes(t_cb, t(d), t(pos), t(fr), t(valid), tp, "chisq")
    jq = np.asarray(jcb.inn_refine_queries(
        jnp.asarray(d), jax_cb.codewords, jax_cb.cw_mask, "chisq", 5, 0.01))
    tq = n(tcb.inn_refine_queries(t(d), t_cb.codewords, t_cb.cw_mask,
                                  "chisq", 5, 0.01))
    same = np.abs(tq - jq).max(1) <= 1e-6
    allowed = ~same | _near_tie_rows(jq, np.asarray(jax_cb.codewords),
                                     np.asarray(jax_cb.cw_mask), tp)
    differ = _assert_votes_match(tv, jv, len(d), allowed)
    print(f"INN: {int(differ.sum())} rows differ, {int((~same).sum())} "
          f"refined differently")
    assert same.mean() >= 0.99


# --- the classify step under each activation ----------------------------------

@pytest.mark.parametrize("name", ["knn5", "knnrule", "inn", "threshold",
                                  "partial_front"])
def test_classifier_matches_committed_jax_scores(name):
    """IsmClassifier (the compacted SHOT step) under the configuration
    `name` of data/config_reference.npz on its first 4 clouds: the
    decision contract against the committed JAX-CPU scores."""
    fields, method, desc = CONFIGS[name]
    ref = np.load(REFERENCE)
    want = np.load(CONFIG_REFERENCE)["scores_" + name][:4]
    config = IsmConfig.load(CODEBOOKS[desc])
    cb = tcb.load_codebook(CODEBOOKS[desc])
    cfg = PipelineConfig.from_ism(
        config, cb.num_classes,
        keypoint_capacity=KEYPOINT_CAPACITY)._replace(normals_method=method)
    params = tcb.CodebookParams.from_config(config.child("Codebook"))
    for key, value in fields.items():
        setattr(params, key, value)
    pts = ref["points"][:4]
    with torch.no_grad():
        scores = IsmClassifier(cb, cfg, params)(
            t(pts), torch.ones(pts.shape[:2], dtype=torch.bool))
    assert scores.shape == (4, 5) and torch.isfinite(scores).all()
    assert_decisions_match(scores, want)
