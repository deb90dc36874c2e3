"""CGF (ops/cgf.py, models/features.local_descriptors) and its embedding
trainer (train_cgf_embedding.py) against the JAX package's on the CPU:

  * the raw rows equal to the golden `cgf_raw` at atol 2e-4, as
    tests/test_golden_descriptors.py holds the JAX package;
  * the descriptor stage on two padded clouds (the JAX `_descriptor_fn`):
    validity equal, CGF's SHOT LRFs at 0.75 x Radius under the frame
    contract, the raw rows on JAX's frames each equal or moved only by
    pairs in their rounding band (tests/zoo2_check.cgf_rows_near), >= 97%
    of the embedded rows at cosine > 0.999;
  * the embedding: the shipped copy's layers equal JAX's, the MLP within
    rtol 1e-5, random_projection's weights within 4 ulps of
    jax.random.normal's (ops/global_descriptors.normal);
  * training and detect_batch through ImplicitShapeModel on the bench
    config with CGF under Euclidean distances (signed rows: ROADMAP C):
    the training contract of test_torch_train.py, the firm detections on
    the training models (fresh views vote nothing, ROADMAP C);
  * the scene route (ops.tiled's threshold and chunks patched to 512 / 64
    in both packages): the same keypoints, >= 97% of the rows at cosine >
    0.999;
  * the trainer from JAX's pairs and initial weights: the loss within rtol
    1e-4 at each of 20 steps, each final layer at cosine > 0.9999; the
    port's pairs and initial weights against JAX's; the CLI's .npz.
The JAX references of the training and the trainer run in subprocesses
(tests/jax_jobs.py), queued when the module starts."""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import shapes
import zoo2_check as zc
from bench_data import BENCH_CONFIG
from jax_jobs import JaxPool
from test_torch_train import assert_codebooks_match
from test_torch_zoo2 import assert_detections_match, port_train
from test_torch_zoo2_global import scene_scale  # noqa: F401 (fixture)
from torch_parity import assert_frames_close, n, t

import jax
import jax.numpy as jnp
from point_cloud_donkey_tpu.models import features as jfeat
from point_cloud_donkey_tpu.ops import cgf as jcgf
from point_cloud_donkey_tpu.ops.neighbors import \
    gather_radius_neighbors as jgather
from point_cloud_donkey_tpu.ops.normals import compute_normals as jnormals
from point_cloud_donkey_tpu.utils.config import ComponentConfig as JaxComp
from point_cloud_donkey_tpu_torch import train_cgf_embedding as tce
from point_cloud_donkey_tpu_torch.models import features as tfeat
from point_cloud_donkey_tpu_torch.models.detect_batch import \
    extract_local_features_batch
from point_cloud_donkey_tpu_torch.models.keypoints import KeypointParams
from point_cloud_donkey_tpu_torch.ops import cgf as tcgf
from point_cloud_donkey_tpu_torch.ops.neighbors import \
    gather_radius_neighbors
from point_cloud_donkey_tpu_torch.utils.config import ComponentConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

N_POINTS = 1024
RADIUS = 0.6
# the trainer's run: the JAX tool's pairs at these sizes, 20 steps
PAIRS, PAIR_POINTS, STEPS, BATCH = 256, 1024, 20, 128


def cgf_config() -> dict:
    """The bench config with CGF under Euclidean distances."""
    cfg = copy.deepcopy(BENCH_CONFIG)
    cfg["ObjectConfig"]["Children"]["Features"]["Type"] = "CGF"
    cfg["ObjectConfig"]["Parameters"]["DistanceType"] = "Euclidean"
    return cfg


def cosines(a, b):
    return (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """4 training models of 2 classes, as PCD files: [(path, class)]."""
    tmp = tmp_path_factory.mktemp("cgf")
    rng = np.random.default_rng(37)
    out = []
    for i in range(4):
        pts = shapes.make_instance(rng, i % 2, n=N_POINTS, rotate=True,
                                   noise=0.005).astype(np.float32)
        path = str(tmp / f"c{i}.pcd")
        save_pcd(path, pts)
        out.append((path, i % 2))
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_refs(models):
    """The JAX training of cgf_config() with its detection of the models
    and the JAX trainer's run, queued at once."""
    pool = JaxPool(2)
    jobs = {"detect": pool.call("zoo_jobs:train_detect", cfg=cgf_config(),
                                files=[list(f) for f in models],
                                detect_files=[p for p, _ in models]),
            "trainer": pool.call("zoo3_fixtures:embedding_run",
                                 n_pairs=PAIRS, n_points=PAIR_POINTS,
                                 steps=STEPS, batch=BATCH)}
    yield jobs
    pool.close()


def test_cgf_raw_matches_golden():
    """As tests/test_golden_descriptors.test_cgf_raw_matches_golden holds
    the JAX package: the golden frames, normals and a full gather."""
    from test_golden_descriptors import N_KP, RADIUS as G_RADIUS
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "golden", "descriptors.npz")) as z:
        golden = dict(z)
    pts, nrm, kp = golden["points"], golden["normals"], golden["keypoints"]
    kp_nrm = nrm[::67][:N_KP]
    frames = golden["frames"].astype(np.float32)
    ones = torch.ones((1, len(pts)), dtype=torch.bool)
    nbr = gather_radius_neighbors(t(kp)[None], t(pts)[None], ones, G_RADIUS,
                                  len(pts))
    out = tcgf.cgf_raw_histogram(t(kp)[None], t(kp_nrm)[None],
                                 t(frames)[None],
                                 torch.ones((1, len(kp)), dtype=torch.bool),
                                 t(pts)[None], nbr, G_RADIUS)
    np.testing.assert_allclose(n(out[0]), golden["cgf_raw"], atol=2e-4)


@pytest.fixture(scope="module")
def clouds():
    """Two shapes of 1024 points padded to 1280 (the second's last 124
    points masked too), their JAX method-2 normals, keypoints every 16th
    point (the last 8 of each masked)."""
    rng = np.random.default_rng(41)
    pts = np.full((2, 1280, 3), 1e9, np.float32)
    mask = np.zeros((2, 1280), bool)
    for b, c in enumerate((2, 4)):
        pts[b, :N_POINTS] = shapes.make_instance(rng, c, n=N_POINTS,
                                                 noise=0.005)
        mask[b, :N_POINTS - 124 * b] = True
    normals = jax.jit(lambda p, m: jnormals(p, m, 0.25, 2).normals)
    nrm = np.stack([np.asarray(normals(jnp.asarray(p), jnp.asarray(m)))
                    for p, m in zip(pts, mask)])
    nrm = np.where(mask[..., None], nrm, 0.0).astype(np.float32)
    kp = pts[:, :N_POINTS:16].copy()
    kpm = np.ones(kp.shape[:2], bool)
    kpm[:, -8:] = False
    kp[~kpm] = 1e9
    return pts, mask, nrm, kp, kpm


def test_cgf_descriptor_stage_matches_jax(clouds):
    """The CGF branch of local_descriptors against the JAX
    `_descriptor_fn` (module docstring)."""
    pts, mask, nrm, kp, kpm = clouds
    fcfg = tfeat.FeatureConfig(type="CGF", radius=RADIUS)
    desc, valid, frames = tfeat.local_descriptors(
        fcfg, t(kp), t(kpm), None, t(pts), t(nrm), None, t(mask), RADIUS)
    run = jax.jit(jfeat._descriptor_fn(pts.shape[1], jfeat.FeatureConfig(
        type="CGF", radius=RADIUS)))
    tlrf = tfeat.shot_lrf(t(kp), t(kpm), t(pts), t(mask),
                          float(np.float32(0.75) * np.float32(RADIUS)))
    rows, near, share = [], [], []
    for b in range(len(pts)):
        w = [np.asarray(x) for x in run(
            jnp.asarray(kp[b]), jnp.asarray(kpm[b]), jnp.asarray(pts[b]),
            jnp.asarray(mask[b]), jnp.asarray(nrm[b]),
            jnp.zeros_like(jnp.asarray(pts[b])),
            jnp.zeros_like(jnp.asarray(kp[b])), jnp.float32(RADIUS),
            jnp.float32(0.5))]
        wd, wv, wf, wfv = w
        np.testing.assert_array_equal(n(valid[b]), wv & np.isfinite(wd).all(1))
        assert_frames_close(frames[b], tlrf.valid[b], wf, wfv)
        ok = wv & n(valid[b])
        share.append(cosines(n(desc[b])[ok], wd[ok]) > 0.999)
        # the raw rows on JAX's frames and normals
        jn = jgather(jnp.asarray(kp[b]), jnp.asarray(pts[b]),
                     jnp.asarray(mask[b]), RADIUS, pts.shape[1])
        kpn = nrm[b][np.asarray(jn.idx[:, 0])]
        jraw = np.asarray(jcgf.cgf_raw_histogram(
            jnp.asarray(kp[b]), jnp.asarray(kpn), jnp.asarray(wf),
            jnp.asarray(wfv), jnp.asarray(pts[b]), jn, RADIUS))
        tn = gather_radius_neighbors(t(kp[b:b + 1]), t(pts[b:b + 1]),
                                     t(mask[b:b + 1]), RADIUS, pts.shape[1])
        traw = n(tcgf.cgf_raw_histogram(
            t(kp[b:b + 1]), t(kpn[None]), t(wf[None]), t(wfv[None]),
            t(pts[b:b + 1]), tn, RADIUS)[0])
        count = n((tn.valid & (tn.dist > 1e-15)).sum(-1)[0])
        live = kpm[b]
        rows.append(np.abs(traw - jraw).max(1)[live] > 1e-6)
        near.append(zc.cgf_rows_near(traw, jraw, count, kp[b], wf, kpn, wfv,
                                     pts[b][mask[b]], RADIUS)[live])
    share = np.concatenate(share)
    print(f"CGF: {len(share)} embedded rows, {share.mean():.4f} at cosine > "
          "0.999")
    assert share.mean() >= 0.97
    zc.report("CGF raw rows on JAX's frames", np.concatenate(rows),
              np.concatenate(near))


def test_cgf_embedding_matches_jax():
    """The shipped copy's layers equal JAX's; the MLP on raw rows within
    rtol 1e-5; random_projection within 4 ulps of JAX's draw."""
    mine = tcgf.CgfEmbedding.from_npz(tcgf.default_checkpoint_path())
    want = jcgf.CgfEmbedding.from_npz(jcgf.default_checkpoint_path())
    assert len(mine.weights) == len(want.weights) == 3
    for (w, b), (jw, jb) in zip(mine.weights, want.weights):
        np.testing.assert_array_equal(n(w), np.asarray(jw))
        np.testing.assert_array_equal(n(b), np.asarray(jb))
    rng = np.random.default_rng(3)
    raw = rng.random((64, tcgf.CGF_RAW_LEN)).astype(np.float32)
    raw *= rng.random(raw.shape) < 0.05
    raw /= np.maximum(raw.sum(1, keepdims=True), 1e-6)
    np.testing.assert_allclose(n(mine(t(raw))), np.asarray(want(
        jnp.asarray(raw))), rtol=1e-5, atol=1e-6)
    for dims, seed in ((32, 0), (16, 5)):
        got = tcgf.CgfEmbedding.random_projection(dims, seed)
        ref = jcgf.CgfEmbedding.random_projection(dims, seed)
        np.testing.assert_array_max_ulp(n(got.weights[0][0]),
                                        np.asarray(ref.weights[0][0]), 4)
        np.testing.assert_array_equal(n(got.weights[0][1]),
                                      np.asarray(ref.weights[0][1]))


def test_cgf_trains_and_detects_as_jax(models, jax_refs):
    """Training: the codebook contract; detect_batch of the models: the
    firm detections of JAX's.  The shipped embedding's rows lie ~1e-3
    apart and the class sigma (a variance) ~1e-7, so the vote gate |d| <=
    2 sigma (codeword_distribution.cpp:131-135) passes a model's own
    features only, in both packages: fresh views detect nothing."""
    ism = port_train(models, cgf_config())
    want = jax_refs["detect"].result()
    assert ism.state.codebook.codewords.shape[1] == 32
    assert_codebooks_match(ism.state.codebook, SimpleNamespace(**{
        k[3:]: v for k, v in want.items() if k.startswith("cb_")}))
    got = assert_detections_match(ism, [p for p, _ in models], want)
    assert all(got)
    print(f"CGF: {len(ism.state.codebook.codewords)} codewords, maxima "
          f"{[len(g) for g in got]}")


def test_cgf_scene_route_matches_jax(scene_scale):  # noqa: F811
    """CGF on the scene route: the same keypoints, >= 97% of the rows at
    cosine > 0.999."""
    rng = np.random.default_rng(9)
    xyz = shapes.make_instance(rng, 0, n=2000, noise=0.005).astype(
        np.float32)
    kp_cfg = {"Type": "VoxelGrid", "Parameters": {"LeafSize": 0.3}}
    want = jfeat.extract_local_features(
        xyz, None, jfeat.FeatureConfig(type="CGF", radius=RADIUS),
        JaxComp.from_json(kp_cfg), 0.25, 2)
    got = extract_local_features_batch(
        [xyz], [None], [None], tfeat.FeatureConfig(type="CGF", radius=RADIUS),
        KeypointParams.from_config(ComponentConfig.from_json(kp_cfg)), 0.25,
        2, torch.device("cpu"), is_training=False)[0]
    np.testing.assert_array_equal(got.positions, want.positions)
    cos = cosines(got.descriptors, want.descriptors)
    print(f"CGF scene route: {len(cos)} rows, {(cos > 0.999).mean():.4f} at "
          "cosine > 0.999")
    assert len(cos) >= 20 and (cos > 0.999).mean() >= 0.97


def test_embedding_trainer_matches_jax(jax_refs):
    """From JAX's pairs and initial weights: each step's loss within rtol
    1e-4, each final layer at cosine > 0.9999.  The port's own pairs (its
    normals, LRFs, gathers and raw rows) at cosine > 0.999 of JAX's on >=
    97% of the rows, its initial weights within 4 ulps of JAX's."""
    ref = jax_refs["trainer"].result()
    a, p = ref["a"], ref["p"]
    init = [(ref[f"init_w{i}"], ref[f"init_b{i}"]) for i in range(3)]
    losses = []
    got = tce.train(a, p, (512, 64, 32), STEPS, BATCH, 1e-3, 0,
                    device="cpu", init=init, losses=losses)
    print("losses rel", np.abs(np.array(losses) / ref["losses"] - 1).max())
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    for i, (w, b) in enumerate(got):
        for x, y in ((w, ref[f"w{i}"]), (b, ref[f"b{i}"])):
            assert cosines(x.ravel(), y.ravel()) > 0.9999
    for (w, _), (jw, _) in zip(tce.initial_layers(a.shape[1],
                                                  (512, 64, 32), 0), init):
        np.testing.assert_array_max_ulp(w, jw, 4)
    ta, tp = tce.generate_pairs(PAIRS, PAIR_POINTS, 0.6, 0, device="cpu")
    assert ta.shape == a.shape and tp.shape == p.shape
    share = np.concatenate([cosines(ta, a), cosines(tp, p)]) > 0.999
    print(f"pairs: {share.mean():.4f} of the rows at cosine > 0.999")
    assert share.mean() >= 0.97


def test_trainer_cli_writes_the_jax_layout(tmp_path):
    """The CLI on the CPU writes w0, b0, ... that the JAX package's
    CgfEmbedding loads, 2244 -> 64 -> 32."""
    out = str(tmp_path / "emb.npz")
    assert tce.main(["--out", out, "--pairs", "32", "--points", "512",
                     "--dims", "64", "32", "--steps", "2", "--batch", "16",
                     "--device", "cpu"]) == 0
    emb = jcgf.CgfEmbedding.from_npz(out)
    assert [np.asarray(w).shape for w, _ in emb.weights] == \
        [(2244, 64), (64, 32)]
