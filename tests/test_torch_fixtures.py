"""The port's committed fixtures (point_cloud_donkey_tpu_torch/data/) are
what the JAX package produces today: regenerate them with
tests/torch_fixtures.py and compare.  The machine with the GPU has no JAX,
so a stale fixture would hold the port against a reference that no longer
exists."""

import json

import numpy as np

import pytest

from bench_data import bench_clouds, bench_colors
from torch_fixtures import (CODEBOOK, CODEBOOKS, CONFIG_REFERENCE, CONFIGS,
                            DESCRIPTOR_REFERENCE, N_DETECT, N_REF, REFERENCE,
                            THRESHOLD, build_codebook,
                            build_descriptor_reference, build_reference,
                            config_scores, threshold_detection)


def test_fixtures_match_the_jax_package(tmp_path):
    cb = str(tmp_path / "bench_codebook.ism")
    build_codebook(cb)
    with open(cb) as f, open(CODEBOOK) as g:
        assert json.load(f) == json.load(g)
    with np.load(cb + "d.npz") as fresh, np.load(CODEBOOK + "d.npz") as old:
        assert sorted(fresh.files) == sorted(old.files)
        for k in fresh.files:
            np.testing.assert_allclose(fresh[k], old[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        assert old["cb_codewords"].shape == (458, 352)

    ref = str(tmp_path / "bench_reference.npz")
    build_reference(cb, ref)
    with np.load(ref) as fresh, np.load(REFERENCE) as old:
        np.testing.assert_array_equal(fresh["points"], old["points"])
        np.testing.assert_array_equal(fresh["labels"], old["labels"])
        # float round-off between two CPU runs of the same programs
        for k in ("scores", "scores_windowed", "detect_densities",
                  "detect_positions"):
            np.testing.assert_allclose(fresh[k], old[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert int(fresh["normals_window"]) == int(old["normals_window"])
        assert 0 < int(old["normals_window"]) < 2048
        assert old["points"].shape == (N_REF, 2048, 3)
        assert old["detect_positions"].shape == (N_DETECT, 5, 3)


def _same_codebook(fresh_path, old_path, width):
    with open(fresh_path) as f, open(old_path) as g:
        assert json.load(f) == json.load(g)
    with np.load(fresh_path + "d.npz") as fresh, \
            np.load(old_path + "d.npz") as old:
        assert sorted(fresh.files) == sorted(old.files)
        for k in fresh.files:
            np.testing.assert_allclose(fresh[k], old[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        assert old["cb_codewords"].shape[1] == width


@pytest.mark.parametrize("descriptor,width", [("CSHOT", 1344),
                                              ("SHORT_SHOT", 32)])
def test_descriptor_codebooks_match_the_jax_package(tmp_path, descriptor,
                                                    width):
    cb = str(tmp_path / "codebook.ism")
    build_codebook(cb, descriptor)
    _same_codebook(cb, CODEBOOKS[descriptor], width)


def test_descriptor_reference_matches_the_jax_package(tmp_path):
    """The committed CSHOT / SHORT_SHOT scores (CSHOT also with the
    committed normals window) and SHORT_SHOT detections come from today's
    JAX package with the committed codebooks; the committed colours are
    bench_colors of bench_reference.npz's clouds."""
    ref = str(tmp_path / "descriptor_reference.npz")
    build_descriptor_reference(CODEBOOKS, ref)
    with np.load(ref) as fresh, np.load(DESCRIPTOR_REFERENCE) as old, \
            np.load(REFERENCE) as base:
        np.testing.assert_array_equal(fresh["rgb8"], old["rgb8"])
        assert old["rgb8"].shape == (N_REF, 2048, 3)
        np.testing.assert_array_equal(
            old["rgb8"].astype(np.float32) / np.float32(255),
            bench_colors(base["points"]))
        np.testing.assert_array_equal(base["points"],
                                      bench_clouds(N_REF)[2])
        for k in ("scores_cshot", "scores_short_shot",
                  "scores_cshot_windowed", "detect_densities_short_shot",
                  "detect_positions_short_shot"):
            np.testing.assert_allclose(fresh[k], old[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        for k in ("scores_cshot", "scores_short_shot",
                  "scores_cshot_windowed"):
            assert old[k].shape == (N_REF, 5)
        assert old["detect_densities_short_shot"].shape == (N_DETECT, 5)
        assert old["detect_positions_short_shot"].shape == (N_DETECT, 5, 3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_reference_matches_the_jax_package(name):
    """The committed scores of each configuration of CONFIGS (activation
    strategies, partial SHOT, normals methods) come from today's JAX
    package with the committed codebooks; the committed Threshold is the
    generator's."""
    with np.load(CONFIG_REFERENCE) as old:
        assert sorted(old.files) == sorted(
            ["threshold", "detect_densities_threshold",
             "detect_positions_threshold"]
            + ["scores_" + k for k in CONFIGS])
        assert float(old["threshold"]) == np.float32(THRESHOLD)
        assert old["scores_" + name].shape == (N_REF, 5)
        np.testing.assert_allclose(config_scores(name), old["scores_" + name],
                                   rtol=1e-5, atol=1e-5)


def test_threshold_detection_reference_matches_the_jax_package():
    dens, pos = threshold_detection()
    with np.load(CONFIG_REFERENCE) as old:
        assert old["detect_densities_threshold"].shape == (N_DETECT, 5)
        assert old["detect_positions_threshold"].shape == (N_DETECT, 5, 3)
        np.testing.assert_allclose(dens, old["detect_densities_threshold"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pos, old["detect_positions_threshold"],
                                   rtol=1e-5, atol=1e-5)


def test_train_reference_matches_the_jax_package():
    """The committed training reference holds what each training
    configuration changes; its quick parts -- the MVBBs, the SOR + z
    cut-off keep masks, the MLS positions and the k-means seeds -- are
    today's JAX package's (the rest takes minutes: torch_fixtures.py)."""
    import jax.numpy as jnp
    from bench_data import GLOBALS, RANKERS, TRAIN_CONFIGS
    from point_cloud_donkey_tpu.models.clustering import kmeans
    from point_cloud_donkey_tpu.models.features import pad_cloud
    from point_cloud_donkey_tpu.models.ism import _mvbb_host_batch
    from point_cloud_donkey_tpu.ops import preprocess as pp
    from torch_fixtures import CODEBOOK, KMEANS_TRAININGS, TRAIN_REFERENCE
    from bench_data import feature_centre_distances

    train = bench_clouds(0)[0]
    with np.load(TRAIN_REFERENCE) as old:
        for name in RANKERS:
            assert old["rank_" + name].shape == (458,)
        for name in GLOBALS:
            assert old["glob_" + name].shape[0] == 24
        assert {"count_" + k for k in TRAIN_CONFIGS if k != "cache"} \
            <= set(old.files)
        for name in KMEANS_TRAININGS:
            ks = old["train_seed_ks_" + name]
            assert old["train_seeds_" + name].shape == (ks.sum(),)
            assert old[f"cb_{name}_cw_mask"].sum() == old["count_" + name]
        boxes = _mvbb_host_batch(list(train))
        for key in ("position", "size", "quat"):
            np.testing.assert_allclose(
                np.stack([getattr(b, key) for b in boxes]),
                old["mvbb_" + key], rtol=1e-6, atol=1e-6, err_msg=key)
        sor = TRAIN_CONFIGS["sor"]
        for r, pts in enumerate(train):
            p, m = (jnp.asarray(x) for x in pad_cloud(pts))
            k = pp.z_cutoff(p, pp.statistical_outlier_removal(
                p, m, sor["Parameters.OutlierRemovalMeanK"],
                sor["Parameters.OutlierRemovalStddevMul"]),
                sor["Parameters.CutoffDistanceZAxis"])
            np.testing.assert_array_equal(np.asarray(k)[:len(pts)],
                                          old["sor_keep"][r])
            np.testing.assert_allclose(
                np.asarray(pp.mls_smooth(p, m, TRAIN_CONFIGS["mls"][
                    "Parameters.SmoothingRadius"]))[:len(pts)],
                old["mls_xyz"][r], atol=1e-6)
        with np.load(CODEBOOK + "d.npz") as z:
            desc, _, _ = feature_centre_distances(dict(z), train)
        np.testing.assert_array_equal(
            kmeans(desc, 256, "chisq", iterations=0)[0], old["kmeans_seeds"])
        np.testing.assert_array_equal(
            kmeans(desc, 3, "chisq", iterations=0)[0],
            old["hartigan_seeds"][3:6])
