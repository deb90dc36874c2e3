"""The port's batched entry points and the serving paths that share
``extract_features`` against the JAX package on the CPU: CSHOT with a
normals window against ``classify_scores_batch``, SHORT_SHOT detection
against ``jax.vmap(detect_maxima_jit)``, and ``classify_scores``,
``classify_intermediates``, ``classify_scores_instances`` and
``classify_scores_mean_shift`` against ``jax.vmap`` of their JAX
counterparts, on bench clouds (one padded) with the committed codebooks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_data import bench_colors
from torch_fixtures import (CODEBOOKS, DESCRIPTOR_REFERENCE, REFERENCE,
                            _jax_codebook, jax_detect, jax_pipeline_config,
                            jax_scores, jax_window)
from torch_parity import assert_decisions_match, n, t

from point_cloud_donkey_tpu.models import pipeline_jit as jpipe
from point_cloud_donkey_tpu.models.codebook import \
    CodebookParams as JCodebookParams
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models import pipeline as tpipe
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (DETECT_STAGES,
                                                          STAGES,
                                                          IsmClassifier,
                                                          IsmDetector,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig


def _model(descriptor, **overrides):
    """(codebook, PipelineConfig, CodebookParams) of a committed model."""
    path = CODEBOOKS[descriptor]
    config = IsmConfig.load(path)
    cb = load_codebook(path)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192, **overrides)
    assert cfg.descriptor == descriptor
    return cb, cfg, CodebookParams.from_config(config.child("Codebook"))


@pytest.fixture(scope="module")
def batch():
    """4 reference clouds, the last with its tail padded (masked, 1e9),
    their bench colours and labels."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:4].copy()
    mask = np.ones(pts.shape[:2], bool)
    mask[3, 1800:] = False
    pts[3, 1800:] = 1e9
    rgb = bench_colors(pts)
    rgb[~mask] = 0.0
    return pts, mask, rgb, ref["labels"][:4]


def test_cshot_with_a_normals_window_matches_jax(batch):
    """IsmClassifier CSHOT with the normals window calibrated on the batch
    vs the JAX classify_scores_batch with the same window (sorted clouds,
    colours co-sorted, windowed normals): every stage reports once, the
    plan is exact (no dense recompute), no kernel is launched for CPU
    tensors, decisions agree; the committed reference's windowed CSHOT
    scores hold on the unpadded clouds."""
    pts, mask, rgb, labels = batch
    window = jax_window(pts, mask)
    assert 0 < window < pts.shape[1]
    want = jax_scores(CODEBOOKS["CSHOT"], pts, mask, window, "CSHOT", rgb)
    cb, cfg, params = _model("CSHOT", normals_window=window)
    model = IsmClassifier(cb, cfg, params)
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(t(pts), t(mask), t(rgb), on_stage=seen.append)
    assert tuple(seen) == STAGES
    assert set(build.launch_counts().values()) == {0}
    assert model.dense_recomputes == 0
    assert_decisions_match(scores, want)
    assert (n(scores).argmax(1) == labels).all()

    dref = np.load(DESCRIPTOR_REFERENCE)
    ref = np.load(REFERENCE)
    m3 = np.ones((3, pts.shape[1]), bool)
    cb, cfg, params = _model("CSHOT",
                             normals_window=int(ref["normals_window"]))
    with torch.no_grad():
        s3 = IsmClassifier(cb, cfg, params)(
            t(ref["points"][:3]), t(m3), t(bench_colors(ref["points"][:3])))
    assert_decisions_match(s3, dref["scores_cshot_windowed"][:3])


def test_short_shot_detector_matches_jax_detect_maxima(batch, monkeypatch):
    """IsmDetector SHORT_SHOT vs jax.vmap(detect_maxima_jit) with the
    SHORT_SHOT codebook on 4 bench clouds, one padded, under the bounds of
    the SHOT detection test (tests/test_torch_detect.py): argmax equal on
    every cloud, densities within rtol 1e-3, the best class's maximum
    within 2e-3.  The normal stage is empty (SHORT_SHOT reads none); every
    stage reports once, in order; no kernel is launched for CPU
    tensors."""
    pts, mask, _, labels = batch
    jd, jp = jax_detect(CODEBOOKS["SHORT_SHOT"], pts, mask, "SHORT_SHOT")

    def no_normals(*a, **k):
        raise AssertionError("SHORT_SHOT reads no normals")

    monkeypatch.setattr(tpipe, "compute_normals_fast", no_normals)
    cb, cfg, params = _model("SHORT_SHOT")
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        td, tp = IsmDetector(cb, cfg, params)(t(pts), t(mask),
                                              on_stage=seen.append)
    assert tuple(seen) == DETECT_STAGES
    assert set(build.launch_counts().values()) == {0}
    td, tp = n(td), n(tp)
    np.testing.assert_array_equal(td.argmax(1), jd.argmax(1))
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)
    best = jd.argmax(1)
    np.testing.assert_allclose(tp[np.arange(4), best],
                               jp[np.arange(4), best], atol=2e-3)
    dref = np.load(DESCRIPTOR_REFERENCE)
    np.testing.assert_allclose(
        td[:3], dref["detect_densities_short_shot"][:3], rtol=1e-3,
        atol=1e-3)


def _jax_entry(name, descriptor, pts, mask, rgb=None, **kw):
    """jax.jit(jax.vmap) of a JAX per-cloud entry point with the bench
    config and the committed codebook of `descriptor` (jitted, as the
    committed references are: the op-by-op run rounds differently)."""
    cb = _jax_codebook(CODEBOOKS[descriptor])
    cfg = jax_pipeline_config(descriptor)
    params = JCodebookParams(knn_k=1)
    fn = getattr(jpipe, name)
    if rgb is None:
        step = jax.jit(jax.vmap(lambda p, m: fn(p, m, cb, cfg, params,
                                                **kw)))
        return step(jnp.asarray(pts), jnp.asarray(mask))
    step = jax.jit(jax.vmap(lambda p, m, r: fn(p, m, cb, cfg, params, rgb=r,
                                               **kw)))
    return step(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rgb))


@pytest.mark.parametrize("descriptor", ["SHOT", "CSHOT", "SHORT_SHOT"])
def test_classify_scores_matches_jax(batch, descriptor):
    """classify_scores (the dense [B, K] grid through extract_features)
    vs jax.vmap(classify_scores) for each descriptor: the slice's decision
    contract; no kernel is launched for CPU tensors."""
    pts, mask, rgb, labels = batch
    rgb = rgb if descriptor == "CSHOT" else None
    want = np.asarray(_jax_entry("classify_scores", descriptor, pts, mask,
                                 rgb))
    cb, cfg, params = _model(descriptor)
    build.reset_launch_counts()
    with torch.no_grad():
        got = tpipe.classify_scores(t(pts), t(mask), cb, cfg, params,
                                    None if rgb is None else t(rgb))
    assert set(build.launch_counts().values()) == {0}
    assert got.shape == (4, cfg.num_classes)
    assert_decisions_match(got, want)


def test_classify_intermediates_and_instances_match_jax(batch):
    """classify_intermediates vs jax.vmap(classify_intermediates) (SHOT):
    keypoints equal, the LRF contract's share on the descriptors (validity
    equal, >= 97% of the rows at cosine > 0.999), vote classes equal, >=
    99% of the in-bandwidth votes shared and their positions within 2e-3,
    and the decision contract on the scores; its scores equal
    classify_scores bit for bit.  classify_scores_instances vs its JAX
    counterpart: the decision contract on both sums; its class scores
    equal classify_scores bit for bit, and per cloud its instance scores
    sum to its class scores (every vote's instance is counted)."""
    pts, mask, _, _ = batch
    cb, cfg, params = _model("SHOT")
    num_instances = int(cb.vote_instance.max()) + 1
    with torch.no_grad():
        inter = tpipe.classify_intermediates(t(pts), t(mask), cb, cfg,
                                             params)
        scores = tpipe.classify_scores(t(pts), t(mask), cb, cfg, params)
        cls, inst = tpipe.classify_scores_instances(
            t(pts), t(mask), cb, cfg, params, num_instances)
    assert torch.equal(inter.scores, scores)
    assert torch.equal(cls, scores)
    np.testing.assert_allclose(n(inst).sum(1), n(cls).sum(1), rtol=1e-5)

    want = _jax_entry("classify_intermediates", "SHOT", pts, mask)
    np.testing.assert_array_equal(n(inter.keypoints), want.keypoints)
    # end to end the frames differ within the LRF contract (a near-tied
    # sign vote may flip, PLATFORM_DIVERGENCE.md): validity equal, and
    # >= 97% of the valid rows at descriptor cosine > 0.999
    tv, jv = n(inter.desc_valid), np.asarray(want.desc_valid)
    np.testing.assert_array_equal(tv, jv)
    cos = (n(inter.descriptors)[tv] * np.asarray(want.descriptors)[tv]) \
        .sum(-1)
    assert (cos > 0.999).mean() >= 0.97, (cos <= 0.999).sum()
    assert inter.vote_weight.shape == want.vote_weight.shape
    np.testing.assert_array_equal(n(inter.vote_class), want.vote_class)
    both = n(inter.vote_valid) & np.asarray(want.vote_valid)
    assert both.sum() >= 0.99 * np.asarray(want.vote_valid).sum()
    np.testing.assert_allclose(n(inter.vote_position)[both],
                               np.asarray(want.vote_position)[both],
                               atol=2e-3)
    assert_decisions_match(inter.scores, want.scores)

    jcls, jinst = _jax_entry("classify_scores_instances", "SHOT", pts, mask,
                             num_instances=num_instances)
    assert_decisions_match(cls, jcls)
    assert_decisions_match(inst, jinst)


@pytest.mark.parametrize("descriptor", ["SHOT", "SHORT_SHOT"])
def test_classify_scores_mean_shift_is_the_detectors_densities(batch,
                                                               descriptor):
    """classify_scores_mean_shift equals IsmDetector's densities bit for
    bit, and matches jax.vmap(classify_scores_mean_shift) under the
    detection bounds (argmax equal, rtol 1e-3); CSHOT is refused, as the
    JAX step reads no colours."""
    pts, mask, _, _ = batch
    cb, cfg, params = _model(descriptor)
    with torch.no_grad():
        dens = tpipe.classify_scores_mean_shift(t(pts), t(mask), cb, cfg,
                                                params)
        det, _ = IsmDetector(cb, cfg, params)(t(pts), t(mask))
    assert torch.equal(dens, det)
    want = np.asarray(_jax_entry("classify_scores_mean_shift", descriptor,
                                 pts, mask))
    np.testing.assert_array_equal(n(dens).argmax(1), want.argmax(1))
    np.testing.assert_allclose(n(dens), want, rtol=1e-3, atol=1e-3)
    ccb, ccfg, cparams = _model("CSHOT")
    with pytest.raises(NotImplementedError, match="CSHOT"):
        tpipe.classify_scores_mean_shift(t(pts), t(mask), ccb, ccfg, cparams)


def test_detector_shares_the_dense_grid_front_half(batch):
    """IsmDetector (SHOT) reads its descriptor from extract_features: the
    same keypoints, descriptors and validity as the grid that
    classify_intermediates reports, bit for bit."""
    pts, mask, _, _ = batch
    cb, cfg, params = _model("SHOT")
    with torch.no_grad():
        f = tpipe.extract_features(t(pts), t(mask), cfg)
        inter = tpipe.classify_intermediates(t(pts), t(mask), cb, cfg,
                                             params)
    assert torch.equal(f.keypoints, inter.keypoints)
    assert torch.equal(f.descriptors, inter.descriptors)
    assert torch.equal(f.valid, inter.desc_valid)
    assert torch.equal(f.kp_mask, f.keypoints[..., 0] < 1e9)
    assert f.descriptors.shape == (4, 192, 352)
