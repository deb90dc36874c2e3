"""The port's windowed SHOT descriptor against the JAX package on the CPU:
K3w's plain twin (`shot_windowed`, each 8-keypoint tile of the dense grid
over a window of its principal-axis-sorted cloud) and
`shot_descriptor_fused_windowed` against the Pallas
`shot_descriptor_fused_windowed` in interpret mode at the K3w cases of
tests/redesign_cases.py, K3w's twin against K7's on an exact plan (K = 22
too), `required_window` with query points against JAX's, and the
windowed-descriptor IsmClassifier against the JAX
``classify_scores_batch(descriptor_window=W)`` with its interpret-mode
kernel (PCD_FUSED_DESC_INTERPRET=1), the flag trip included.  Both
interpret-mode references run in a process of their own
(torch_parity.pallas_interpret)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redesign_cases import (K3W_CASES, K3W_KEYS, K3W_PARK, K3W_RADIUS,
                            k3w_case)
from torch_fixtures import CODEBOOK, REFERENCE, jax_window
from torch_parity import (assert_decisions_match, assert_descriptors_close,
                          InterpretRun, n, t)

from point_cloud_donkey_tpu.ops import binned as jbinned
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (STAGES,
                                                          IsmClassifier,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import binned as tbinned
from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as tshot
from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

_K3W_CODE = """
import jax.numpy as jnp
import numpy as np
from point_cloud_donkey_tpu.ops.pallas import shot_fused as SF
counts = []
_call = SF._shot_fused_call_windowed


def _spy(*args, **kw):          # keep the in-radius counts the call returns
    hist, cnt = _call(*args, **kw)
    counts.append(np.asarray(cnt)[:, 0])
    return hist, cnt


SF._shot_fused_call_windowed = _spy
out = {}
for case in %r:
    g = lambda key: jnp.asarray(a[case + "__" + key])
    desc, valid, exact = SF.shot_descriptor_fused_windowed(
        *(g(key) for key in %r), %r, int(a[case + "__window"]),
        interpret=True)
    out[case + "__desc"] = np.asarray(desc)
    out[case + "__valid"] = np.asarray(valid)
    out[case + "__exact"] = np.asarray(exact)
    out[case + "__count"] = counts[-1]
""" % (K3W_CASES, K3W_KEYS, K3W_RADIUS)


@pytest.fixture(scope="module", autouse=True)
def interpret_runs(tmp_path_factory):
    """This module's two interpret-mode references, started at once in the
    background (torch_parity.InterpretRun): the K3w edge cases and the
    windowed classify step of test_windowed_descriptor_classifier_matches_
    jax (with the window the port calibrates on its clouds)."""
    arrays = {}
    for case in K3W_CASES:
        *inputs, window = k3w_case(case)
        arrays.update({f"{case}__{key}": x
                       for key, x in zip(K3W_KEYS, inputs)})
        arrays[f"{case}__window"] = np.int32(window)
    k3w = InterpretRun(_K3W_CODE, str(tmp_path_factory.mktemp("k3w")),
                       **arrays)
    pts, mask, _ = _bench_batch(2)
    window = _classify_window(pts, mask)
    classify = InterpretRun(
        _CLASSIFY_CODE, str(tmp_path_factory.mktemp("classify")),
        points=pts, mask=mask, windows=np.array([window, 128], np.int32))
    return {"k3w": k3w, "classify": classify}


@pytest.fixture(scope="module")
def pallas_k3w(interpret_runs):
    """`shot_descriptor_fused_windowed(..., interpret=True)` at every K3w
    case, and the in-radius counts of its `_shot_fused_call_windowed`."""
    return interpret_runs["k3w"].result()


def _plan(kp_keys, keys, window):
    return tbinned.window_starts(kp_keys, kp_keys < K3W_PARK, keys,
                                 K3W_RADIUS, window, tile_q=tshot.TK,
                                 align=128)


@pytest.mark.parametrize("case", K3W_CASES)
def test_shot_windowed_twin_matches_pallas_at_edge_cases(pallas_k3w, case):
    """K3w's twin (`shot_windowed`, and `shot_descriptor_fused_windowed`
    over it) vs the Pallas kernel in its windowed mode on the same sorted
    inputs and windows: in-radius counts equal on the live rows, rows that
    are not live zero, the descriptor contract (validity equal, cosine >
    0.999, fewer than 1e-4 of the entries off by more than 1e-3), and the
    plan's exactness flag equal.  Masked NaN / huge points inside the
    windows and NaN / inf normals add nothing; a window clamped at the
    cloud's end reads the cloud's last W points."""
    *arrays, window = k3w_case(case)
    kp, kk, fr, fv, pts, keys, nrm, mask = (t(x) for x in arrays)
    live = arrays[3]
    j = lambda key: pallas_k3w[f"{case}__{key}"]          # noqa: E731
    plan = _plan(kk, keys, window)
    hist, count = tshot.shot_windowed(kp, fr, fv,
                                      plan.starts.reshape(-1).contiguous(),
                                      pts, nrm, mask, window, K3W_RADIUS)
    hist, count = n(hist), n(count)
    jcount = j("count").reshape(live.shape)
    np.testing.assert_array_equal(count[live], jcount[live])
    assert not count[~live].any() and not hist[~live].any()
    assert count.max() > 5
    td, tv, exact = _twin_descriptors(case)
    assert bool(exact) == bool(j("exact"))
    # the contract's validity and cosine, row by row (its share of entries
    # off by more than 1e-3 is a statistic: the next test takes it over
    # every case's rows at once)
    assert_descriptors_close(td, tv, j("desc").reshape(-1, 352),
                             j("valid").reshape(-1), max_frac_off=1.0)
    if case in ("calibrated", "full_window"):
        assert bool(exact)
    if case.startswith("narrow"):
        assert not bool(exact)
    if case == "clamped_end":
        assert int(plan.starts.max()) == pts.shape[1] - window
    if case == "dead_tiles":
        assert not live[0, 8:16].any() and live[0, :8].all()


def _twin_descriptors(case):
    """`shot_descriptor_fused_windowed` on a K3w case: (descriptors
    [B*K, 352], valid [B*K], exact)."""
    *arrays, window = k3w_case(case)
    kp, kk, fr, fv, pts, keys, nrm, mask = (t(x) for x in arrays)
    d, v, exact = tshot.shot_descriptor_fused_windowed(
        kp, kk, fr, fv, pts, keys, nrm, mask, K3W_RADIUS, window)
    return d.reshape(-1, 352), v.reshape(-1), exact


def test_shot_windowed_twin_descriptors_match_pallas(pallas_k3w):
    """The descriptor contract over the rows of every K3w case together:
    validity equal, cosine > 0.999, and fewer than 1e-4 of the entries off
    by more than 1e-3 (a radius-boundary pair or a bin edge moves a slot's
    soft weights; the Pallas kernel's own arithmetic differs from the XLA
    SHOT by up to ~7e-4 an entry, so one narrow case's 13 valid rows alone
    are too few entries for the share)."""
    got, want = [], []
    for case in K3W_CASES:
        d, v, _ = _twin_descriptors(case)
        got.append((n(d), n(v)))
        want.append((pallas_k3w[f"{case}__desc"].reshape(-1, 352),
                     pallas_k3w[f"{case}__valid"].reshape(-1)))
    cat = lambda pairs, i: np.concatenate([p[i] for p in pairs])  # noqa
    assert_descriptors_close(cat(got, 0), cat(got, 1), cat(want, 0),
                             cat(want, 1))


@pytest.mark.parametrize("k", [32, 22])
def test_shot_windowed_equals_k7_on_an_exact_plan(k):
    """On an exact plan every in-radius point of a tile lies in its
    window, so K3w's twin gives K7's twin's counts and its histograms to
    the float summation order -- also at K = 22 (a last tile of 6 rows,
    the port's ragged grid; the JAX kernel takes only K a multiple of
    8)."""
    *arrays, window = k3w_case("calibrated", k=k)
    kp, kk, fr, fv, pts, keys, nrm, mask = (t(x) for x in arrays)
    plan = _plan(kk, keys, window)
    assert bool(plan.exact) and window < pts.shape[1]
    assert plan.starts.shape == (2, -(-k // 8))
    hist, count = tshot.shot_windowed(kp, fr, fv,
                                      plan.starts.reshape(-1).contiguous(),
                                      pts, nrm, mask, window, K3W_RADIUS)
    dh, dc = tshot.shot_dense(kp, fr, fv, pts, nrm, mask, K3W_RADIUS)
    assert torch.equal(count, dc) and int(count.max()) > 5
    torch.testing.assert_close(hist, dh, rtol=1e-5, atol=1e-6)
    if k % 8:
        with pytest.raises(ValueError):
            tshot.shot_descriptor_fused_windowed(
                kp, kk, fr, fv, pts, keys, nrm, mask, K3W_RADIUS, window)


def test_shot_windowed_checks_its_arguments():
    """The wrapper refuses starts of another dtype or count, and a window
    that is not in (0, N] or neither a multiple of 128 nor N."""
    *arrays, window = k3w_case("calibrated")
    kp, kk, fr, fv, pts, keys, nrm, mask = (t(x) for x in arrays)
    starts = _plan(kk, keys, window).starts.reshape(-1).contiguous()
    args = (kp, fr, fv, starts, pts, nrm, mask)
    with pytest.raises(TypeError):
        tshot.shot_windowed(*args[:3], starts.long(), *args[4:], window,
                            K3W_RADIUS)
    with pytest.raises(ValueError):
        tshot.shot_windowed(*args[:3], starts[:-1].contiguous(), *args[4:],
                            window, K3W_RADIUS)
    for bad in (0, 200, 1152):
        with pytest.raises(ValueError):
            tshot.shot_windowed(*args, bad, K3W_RADIUS)
    tshot.shot_windowed(*args, pts.shape[1], K3W_RADIUS)


def _bench_batch(b=4):
    """The first `b` reference clouds, the last with its tail padded
    (masked, 1e9)."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:b].copy()
    mask = np.ones(pts.shape[:2], bool)
    mask[b - 1, 1800:] = False
    pts[b - 1, 1800:] = 1e9
    return pts, mask, ref


def test_required_window_with_query_points_matches_jax():
    """required_window with the keypoints as queries (tile 8, align 128:
    the windowed descriptor's calibration) equals JAX's on bench clouds,
    one padded; so does the self-LRF form's (tile 256)."""
    pts, mask, _ = _bench_batch()
    kres = voxel_grid(t(pts), t(mask), 0.35, capacity=192)
    kp = kres.centroids[..., :3]
    got = tbinned.required_window(t(pts), t(mask), 0.6, tile_q=8,
                                  q_points=kp, q_mask=kres.mask)
    want = jbinned.required_window(jnp.asarray(pts), jnp.asarray(mask), 0.6,
                                   tile_q=8, align=128,
                                   q_points=jnp.asarray(n(kp)),
                                   q_mask=jnp.asarray(n(kres.mask)))
    assert got == int(want) and 0 < got <= pts.shape[1]
    assert tbinned.required_window(t(pts), t(mask), 0.25) == \
        jax_window(pts, mask)


_CLASSIFY_CODE = """
import os
import sys
sys.path.insert(0, %r)
import jax.numpy as jnp
import numpy as np
from torch_fixtures import _jax_codebook, jax_pipeline_config
from point_cloud_donkey_tpu.models.codebook import CodebookParams
from point_cloud_donkey_tpu.models.pipeline_jit import classify_scores_batch
os.environ["PCD_FUSED_DESC_INTERPRET"] = "1"
cb = _jax_codebook(%r)
out = {}
for w in a["windows"]:
    cfg = jax_pipeline_config()._replace(descriptor_window=int(w))
    scores, exact = classify_scores_batch(
        jnp.asarray(a["points"]), jnp.asarray(a["mask"]), cb, cfg,
        CodebookParams(knn_k=1))
    out[f"scores_{w}"] = np.asarray(scores)
    out[f"exact_{w}"] = np.asarray(exact)
""" % (os.path.dirname(os.path.abspath(__file__)), CODEBOOK)


def _model(**overrides):
    config = IsmConfig.load(CODEBOOK)
    cb = load_codebook(CODEBOOK)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192, **overrides)
    return IsmClassifier(cb, cfg,
                         CodebookParams.from_config(config.child("Codebook")))


def _classify_window(pts, mask):
    """The descriptor window the port calibrates on the clouds' voxel
    keypoints."""
    kres = voxel_grid(t(pts), t(mask), 0.35, capacity=192)
    return tbinned.required_window(t(pts), t(mask), 0.6, tile_q=8,
                                   q_points=kres.centroids[..., :3],
                                   q_mask=kres.mask)


def test_windowed_descriptor_classifier_matches_jax(interpret_runs):
    """IsmClassifier with descriptor_window vs the JAX
    ``classify_scores_batch(fused_descriptor=True, descriptor_window=W)``
    with its interpret-mode kernel, on two bench clouds (one padded) at
    the window calibrated on them: every stage reports once, no kernel
    is launched for CPU tensors, the plan is exact on both sides and the
    decisions agree.  At W = 128 both plans trip: JAX returns its
    inexact scores and flag, the port recomputes the descriptor by K7
    over the whole sorted cloud (dense_recomputes 1) and gives the scores
    of the exact window to rtol 1e-5 (K7 and K3w sum in other batches)."""
    pts, mask, ref = _bench_batch(2)
    window = _classify_window(pts, mask)
    jax_out = interpret_runs["classify"].result()
    assert bool(jax_out[f"exact_{window}"]) and not bool(jax_out["exact_128"])
    model = _model(descriptor_window=window)
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(t(pts), t(mask), on_stage=seen.append)
    assert tuple(seen) == STAGES
    assert set(build.launch_counts().values()) == {0}
    assert model.dense_recomputes == 0
    assert_decisions_match(scores, jax_out[f"scores_{window}"])
    assert (n(scores).argmax(1) == ref["labels"][:2]).all()

    tripped = _model(descriptor_window=128)
    with torch.no_grad():
        tscores = tripped(t(pts), t(mask))
    assert tripped.dense_recomputes == 1
    np.testing.assert_allclose(n(tscores), n(scores), rtol=1e-5, atol=1e-5)
    assert_decisions_match(tscores, jax_out[f"scores_{window}"])


def test_windowed_descriptor_with_a_normals_window():
    """descriptor_window with normals_window: one sort serves both
    windows, neither plan trips, and the scores match the committed
    JAX-CPU scores of the normals window; at a normals window of 128 the
    normals plan trips, and the normals and the descriptor are recomputed
    densely inside the call."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:2]
    mask = np.ones(pts.shape[:2], bool)
    nw = int(ref["normals_window"])
    model = _model(descriptor_window=pts.shape[1], normals_window=nw)
    with torch.no_grad():
        scores = model(t(pts), t(mask))
    assert model.dense_recomputes == 0
    assert_decisions_match(scores, ref["scores_windowed"][:2])
    tripped = _model(descriptor_window=pts.shape[1], normals_window=128)
    with torch.no_grad():
        tscores = tripped(t(pts), t(mask))
    assert tripped.dense_recomputes == 1
    assert_decisions_match(tscores, ref["scores"][:2])
