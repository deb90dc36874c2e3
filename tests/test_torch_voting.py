"""The port's voting stage against the JAX package on the CPU, on seeded
votes (numpy; no descriptors):

  * ops/mean_shift.py's seeds, shift and density under both kernels with a
    bandwidth per group, the sequential density reweighting, the greedy
    averaging and the suppression, within atol 1e-5;
  * models/voting.find_maxima, then the filter, normalisation and
    selection, under each configuration of CASES (the suppressions and
    kernels, each single-object max type, Hough3D with and without
    interpolation, RANSAC, the three filters with AverageRotation, a
    negative MinThreshold, BestK, per-class search distances): the
    contracts of tests/bench_data.maxima_mismatches;
  * class_mean_shift_batch over groups of several vote buckets and
    bandwidths, the Hough accumulator against JAX's dict oracle
    ``_class_hough``, and merge_maxima."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_data import maxima_mismatches
from torch_parity import n, t

from point_cloud_donkey_tpu.models import voting as jv
from point_cloud_donkey_tpu.ops import mean_shift as jms
from point_cloud_donkey_tpu_torch.models import voting as tv
from point_cloud_donkey_tpu_torch.models.codebook import CastVotes
from point_cloud_donkey_tpu_torch.ops import mean_shift as tms

CPU = torch.device("cpu")
BWS = np.array([0.4, 0.5, 0.55, 0.6, 0.45, 0.5], np.float32)


@pytest.fixture(scope="module")
def groups():
    """Six groups of 150 votes in three blobs each, weights, validity (one
    group without a valid vote) and a bandwidth each."""
    rng = np.random.default_rng(23)
    g, v = 6, 150
    centres = rng.uniform(-1.0, 1.0, size=(g, 3, 3))
    pos = centres[np.arange(g)[:, None], rng.integers(0, 3, size=(g, v))] \
        + rng.normal(scale=0.15, size=(g, v, 3))
    w = rng.uniform(0.2, 1.0, size=(g, v))
    valid = rng.random((g, v)) > 0.2
    valid[-1] = False
    pos = np.where(valid[..., None], pos, 1e9)
    return pos.astype(np.float32), w.astype(np.float32), valid


@pytest.mark.parametrize("kernel", ["Gaussian", "Uniform"])
def test_mean_shift_ops_match_jax(groups, kernel):
    """Seeds, converged centres, survivors, densities and the sequential
    reweighting with a bandwidth per group; then, per group, the averaging
    and the suppression on the JAX centres (host numpy in the port)."""
    pos, w, valid = groups

    def one(p, ww, vv, bw):
        seeds, sw, sm = jms.create_seeds(p, ww, vv, jms.seeds_range(bw), 64)
        c, alive = jms.mean_shift(seeds, sm, p, ww, vv, bw, 1e-3, 200,
                                  kernel)
        d = jms.estimate_density(c, p, ww, vv, bw, kernel)
        rd, rw, rm = jms.density_and_reweight(c, alive, p, ww, vv, bw,
                                              kernel)
        return seeds, sw, sm, c, alive, d, rd, rw, rm

    want = [np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(valid),
        jnp.asarray(BWS))]
    bw = t(BWS)
    seeds, sw, sm = tms.create_seeds(t(pos), t(w), t(valid),
                                     tms.seeds_range(bw), 64)
    c, alive = tms.mean_shift(seeds, sm, t(pos), t(w), t(valid), bw, 1e-3,
                              200, kernel)
    d = tms.estimate_density(c, t(pos), t(w), t(valid), bw, kernel)
    rd, rw, rm = tms.density_and_reweight(c, alive, t(pos), t(w), t(valid),
                                          bw, kernel)
    got = [n(x) for x in (seeds, sw, sm, c, alive, d, rd, rw, rm)]
    for name, a, b in zip(("seeds", "seed weights", "seed mask", "centres",
                           "alive", "density", "reweighted densities",
                           "final weights", "membership"), got, want):
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    c_j, alive_j, d_j = want[3], want[4], want[5]
    for gi in range(len(BWS)):
        bwj = jnp.float32(BWS[gi])
        avg_w, own_w = jms.average_neighbor_maxima(
            jnp.asarray(c_j[gi]), jnp.asarray(alive_j[gi]),
            jnp.asarray(d_j[gi]), bwj)
        avg, own = tms.average_neighbor_maxima(c_j[gi], alive_j[gi], d_j[gi],
                                               float(BWS[gi]))
        np.testing.assert_array_equal(own, np.asarray(own_w))
        np.testing.assert_allclose(avg, np.asarray(avg_w), atol=1e-5)
        keep_w = jms.suppress_neighbor_maxima(
            jnp.asarray(c_j[gi]), jnp.asarray(alive_j[gi]),
            jnp.asarray(d_j[gi]), bwj)
        np.testing.assert_array_equal(
            tms.suppress_neighbor_maxima(c_j[gi], alive_j[gi], d_j[gi],
                                         float(BWS[gi])), np.asarray(keep_w))


@pytest.mark.parametrize("kernel", ["Gaussian", "Uniform"])
def test_batch_invariant_mean_shift_matches_jax(groups, kernel):
    """The batch-invariant mean-shift (row sums, no batched matmul; what
    detect_batch runs) gives the JAX module's centres, survivors and
    densities within atol 1e-5, and each group alone gives its row of the
    batch bit for bit."""
    pos, w, valid = groups

    def one(p, ww, vv, bw):
        seeds, _, sm = jms.create_seeds(p, ww, vv, jms.seeds_range(bw), 64)
        c, alive = jms.mean_shift(seeds, sm, p, ww, vv, bw, 1e-3, 200,
                                  kernel)
        return c, alive, jms.estimate_density(c, p, ww, vv, bw, kernel)

    want = [np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(valid),
        jnp.asarray(BWS))]

    def run(sl):
        p, ww, vv, bw = t(pos[sl]), t(w[sl]), t(valid[sl]), t(BWS[sl])
        seeds, _, sm = tms.create_seeds(p, ww, vv, tms.seeds_range(bw), 64)
        c, alive = tms.mean_shift(seeds, sm, p, ww, vv, bw, 1e-3, 200,
                                  kernel, batch_invariant=True)
        return [n(x) for x in (c, alive, tms.estimate_density(
            c, p, ww, vv, bw, kernel, batch_invariant=True))]

    got = run(slice(None))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=1e-5)
    for gi in range(len(BWS)):
        for a, b in zip(run(slice(gi, gi + 1)), got):
            np.testing.assert_array_equal(a[0], b[gi])


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return q, np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def seeded_votes(seed: int = 5, classes: int = 3):
    """Cast votes of a seeded scene: per class two objects, each a blob of
    votes at its centre whose scene keypoints are a rigid motion of their
    codewords' training keypoints (so RANSAC keeps them), box sizes and
    rotations near the object's, plus scattered votes; and the scene's
    points (the votes' keypoints)."""
    rng = np.random.default_rng(seed)
    cols = {f: [] for f in CastVotes._fields if f != "valid"}
    for c in range(classes):
        for o in range(2):
            k = int(rng.integers(40, 90))
            centre = rng.uniform(-3, 3, 3)
            q0, rot = _rotation(rng)
            train_kp = rng.uniform(-0.6, 0.6, (k, 3))
            cols["keypoint_training"].append(train_kp)
            cols["keypoint"].append(train_kp @ rot.T + centre
                                    + rng.normal(scale=0.01, size=(k, 3)))
            cols["position"].append(centre
                                    + rng.normal(scale=0.12, size=(k, 3)))
            q = q0 + rng.normal(scale=0.02, size=(k, 4))
            cols["bbox_quat"].append(q / np.linalg.norm(q, axis=1,
                                                        keepdims=True))
            cols["bbox_size"].append(np.array([1.0, 0.7, 0.4])
                                     * rng.uniform(0.9, 1.1, (k, 3)))
            cols["weight"].append(rng.uniform(0.2, 1.0, k))
            cols["class_id"].append(np.full(k, c))
            cols["instance_id"].append(np.full(k, 2 * c + o))
        k = 25
        cols["position"].append(rng.uniform(-4, 4, (k, 3)))
        cols["keypoint"].append(rng.uniform(-4, 4, (k, 3)))
        cols["keypoint_training"].append(rng.uniform(-1, 1, (k, 3)))
        q = rng.normal(size=(k, 4))
        cols["bbox_quat"].append(q / np.linalg.norm(q, axis=1,
                                                    keepdims=True))
        cols["bbox_size"].append(rng.uniform(0.3, 1.5, (k, 3)))
        cols["weight"].append(rng.uniform(0.2, 1.0, k))
        cols["class_id"].append(np.full(k, c))
        cols["instance_id"].append(rng.integers(0, 2 * classes, k))
    arrays = {f: np.concatenate(v) for f, v in cols.items()}
    arrays = {f: v.astype(np.int64 if f in ("class_id", "instance_id")
                          else np.float32) for f, v in arrays.items()}
    votes = CastVotes(valid=np.ones(len(arrays["weight"]), bool), **arrays)
    return votes, arrays["keypoint"]


DIMS = {0: (1.1, 0.7), 1: (0.9, 0.6), 2: (1.3, 0.8)}
BASE = dict(bandwidth=0.5, max_iter=300)
CASES = {
    "average_gaussian": {},
    "suppress_uniform": dict(maxima_suppression="None", kernel="Uniform"),
    "single_none": dict(single_object_mode=True,
                        single_object_max_type="None"),
    "single_default": dict(single_object_mode=True),
    "single_bandwidth": dict(single_object_mode=True, bandwidth=3.0,
                             single_object_max_type="BandwidthVotes"),
    "single_model_radius": dict(single_object_mode=True,
                                single_object_max_type="ModelRadiusVotes"),
    "single_voting_space": dict(single_object_mode=True,
                                single_object_max_type="VotingSpaceVotes"),
    "hough_interpolated": dict(voting_type="Hough3D", rel_threshold=0.3),
    "hough_nearest": dict(voting_type="Hough3D", use_interpolation=False,
                          rel_threshold=0.3),
    "ransac": dict(use_ransac=True, ransac_inlier_threshold=0.05,
                   min_votes_threshold=3),
    "hough_ransac": dict(voting_type="Hough3D", rel_threshold=0.3,
                         use_ransac=True, ransac_inlier_threshold=0.05),
    "filter_simple": dict(max_filter_type="Simple", bandwidth=2.5),
    "filter_merge_rotation": dict(max_filter_type="Merge", bandwidth=2.5,
                                  average_rotation=True),
    "rotation_radius_type": dict(average_rotation=True,
                                 radius_type="ObjectRadius",
                                 radius_factor=0.5),
    "negative_min_threshold": dict(min_threshold=-0.5),
    "best_k": dict(best_k=3, min_votes_threshold=2),
}


def _select(mod, maxima, params):
    """The detection tail without global features (_finish_detect)."""
    if not params.single_object_mode:
        maxima = mod.filter_maxima(maxima, params, DIMS)
    maxima = sorted(maxima, key=lambda m: -m.weight)
    mod.normalize_weights(maxima)
    return mod.select_maxima(maxima, params)


@pytest.fixture(scope="module")
def scene():
    return seeded_votes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_find_maxima_matches_jax(scene, case):
    votes, points = scene
    kw = {**BASE, **CASES[case]}
    mask = np.ones(len(points), bool)
    want = _select(jv, jv.find_maxima(votes, points, mask,
                                      jv.VotingParams(**kw), DIMS),
                   jv.VotingParams(**kw))
    got = _select(tv, tv.find_maxima(votes, points, mask,
                                     tv.VotingParams(**kw), DIMS, CPU),
                  tv.VotingParams(**kw))
    assert len(want) > 0
    assert not maxima_mismatches(got, want), maxima_mismatches(got, want)
    for g, w in zip(got, want):
        assert g.num_votes == w.num_votes
    if case == "best_k":
        assert len(got) == 3


def test_device_reweighting_matches_jax(scene, monkeypatch):
    """Above _REWEIGHT_HOST_LIMIT kernel evaluations the sequential
    reweighting runs on the device (ops/mean_shift.density_and_reweight):
    the same maxima as the JAX package's host reweighting."""
    votes, points = scene
    kw = dict(BASE, average_rotation=True)
    mask = np.ones(len(points), bool)
    want = _select(jv, jv.find_maxima(votes, points, mask,
                                      jv.VotingParams(**kw), DIMS),
                   jv.VotingParams(**kw))
    monkeypatch.setattr(tv, "_REWEIGHT_HOST_LIMIT", 0)
    got = _select(tv, tv.find_maxima(votes, points, mask,
                                     tv.VotingParams(**kw), DIMS, CPU),
                  tv.VotingParams(**kw))
    assert not maxima_mismatches(got, want), maxima_mismatches(got, want)


def test_class_mean_shift_batch_matches_jax():
    """Groups of two vote buckets (64 and 256), bandwidths of their own,
    one pass of the port against the JAX package's batched programs."""
    rng = np.random.default_rng(3)
    items = []
    for i, v in enumerate((40, 200, 64, 130, 17)):
        centres = rng.uniform(-2, 2, (3, 3))
        p = centres[rng.integers(0, 3, v)] + rng.normal(scale=0.2,
                                                        size=(v, 3))
        items.append((p.astype(np.float32),
                      rng.uniform(0.2, 1, v).astype(np.float32),
                      float(BWS[i])))
    params = dict(max_iter=300)
    want = jv.class_mean_shift_batch(items, jv.VotingParams(**params))
    got = tv.class_mean_shift_batch(items, tv.VotingParams(**params), CPU)
    for (g, _), w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)


@pytest.mark.parametrize("interpolate", [True, False])
def test_hough_matches_jax_oracle(scene, interpolate):
    """The port's device accumulation and host NMS against the JAX
    package's dict-based oracle: maxima, bin values and voter sets."""
    votes, _ = scene
    sel = votes.class_id == 1
    params = tv.VotingParams(voting_type="Hough3D", rel_threshold=0.2,
                             use_interpolation=interpolate)
    jparams = jv.VotingParams(**dataclasses.asdict(params))
    pos, w = votes.position[sel], votes.weight[sel]
    m_pos, m_val, members = tv._class_hough_device(pos, w, 0.5, params, CPU)
    o_pos, o_val, o_members = jv._class_hough(pos, w, 0.5, jparams)
    assert len(m_pos) == len(o_pos) > 1
    np.testing.assert_allclose(m_pos, o_pos, atol=1e-5)
    np.testing.assert_allclose(m_val, o_val, rtol=1e-5)
    for a, b in zip(members, o_members):
        np.testing.assert_array_equal(a, b)


def test_merge_maxima_matches_jax(scene):
    """merge_maxima of three maxima of two classes: the fused position,
    box and rotation, the instance and the merged global hypothesis."""
    votes, points = scene
    kw = dict(BASE, average_rotation=True)
    mask = np.ones(len(points), bool)
    want_in = jv.find_maxima(votes, points, mask, jv.VotingParams(**kw),
                             DIMS)[:3]
    got_in = tv.find_maxima(votes, points, mask, tv.VotingParams(**kw), DIMS,
                            CPU)[:3]
    want = jv.merge_maxima(want_in)
    got = tv.merge_maxima(got_in)
    assert not maxima_mismatches([got], [want])
    assert got.glob_instance_id == want.glob_instance_id
