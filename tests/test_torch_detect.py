"""The port's mean-shift detection path against the JAX package on the CPU:
ops/mean_shift.py on seeded votes, K7's plain twin (dense-grid SHOT)
against the Pallas ``shot_descriptor_fused`` in interpret mode (in a
process of its own: torch_parity.pallas_interpret), the
IsmDetector slice against ``jax.vmap(detect_maxima_jit)``, and
``serve --maxima``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapes
from torch_fixtures import CODEBOOK, REFERENCE, jax_detect
from torch_parity import assert_descriptors_close, n, pallas_interpret, t

from point_cloud_donkey_tpu.ops import mean_shift as jms
from point_cloud_donkey_tpu.ops.lrf import shot_lrf as j_shot_lrf
from point_cloud_donkey_tpu.ops.normals import \
    compute_normals_fast as j_normals
from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid as j_voxel
from point_cloud_donkey_tpu_torch import serve
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (DETECT_STAGES,
                                                          IsmDetector,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import mean_shift as tms
from point_cloud_donkey_tpu_torch.ops.kernels import shot_fused as tshot
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig
from point_cloud_donkey_tpu_torch.utils.io import save_pcd

BW = 0.5   # the bench's voting bandwidth


@pytest.fixture(scope="module")
def votes():
    """Six groups of 150 seeded votes in three blobs each, with weights,
    a validity mask and one group with no valid vote."""
    rng = np.random.default_rng(17)
    g, v = 6, 150
    centres = rng.uniform(-1.0, 1.0, size=(g, 3, 3))
    pos = centres[:, rng.integers(0, 3, size=v)] \
        + rng.normal(scale=0.15, size=(g, v, 3))
    w = rng.uniform(0.2, 1.0, size=(g, v))
    valid = rng.random((g, v)) > 0.2
    valid[-1] = False
    pos = np.where(valid[..., None], pos, 1e9)
    return (pos.astype(np.float32), w.astype(np.float32), valid)


def _jax_groups(pos, w, valid, max_iter):
    bw = jnp.float32(BW)

    def one(p, ww, vv):
        seeds, sw, sm = jms.create_seeds(p, ww, vv, jms.seeds_range(bw), 64)
        c, alive = jms.mean_shift(seeds, sm, p, ww, vv, bw,
                                  max_iter=max_iter)
        d = jms.estimate_density(c, p, ww, vv, bw)
        return seeds, sw, sm, c, alive, d

    return [np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(valid))]


def _torch_groups(pos, w, valid, max_iter):
    p, ww, vv = t(pos), t(w), t(valid)
    seeds, sw, sm = tms.create_seeds(p, ww, vv, tms.seeds_range(BW), 64)
    c, alive = tms.mean_shift(seeds, sm, p, ww, vv, BW, max_iter=max_iter)
    d = tms.estimate_density(c, p, ww, vv, BW)
    return [n(x) for x in (seeds, sw, sm, c, alive, d)]


def test_mean_shift_matches_jax(votes):
    """Seeds (positions, weights, mask), converged centres, survivors and
    densities equal the JAX module's within atol 1e-5."""
    js, jw, jm, jc, ja, jd = _jax_groups(*votes, 100)
    ts, tw, tm, tc, ta, td = _torch_groups(*votes, 100)
    np.testing.assert_array_equal(tm, jm)
    assert jm.any(1)[:-1].all() and not jm[-1].any()
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_allclose(tw, jw, atol=1e-5)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc[ta], jc[ja], atol=1e-5)
    np.testing.assert_allclose(td[ta], jd[ja], atol=1e-5)


def test_sparse_convergence_tests_change_nothing(votes, monkeypatch):
    """Testing convergence every CHECK_EVERY iterations gives bit-equal
    results to testing after every one (later iterations are no-ops)."""
    every = _torch_groups(*votes, 37)
    monkeypatch.setattr(tms, "CHECK_EVERY", 1)
    once = _torch_groups(*votes, 37)
    for a, b in zip(every, once):
        np.testing.assert_array_equal(a, b)


def test_seed_capacity_drops_the_last_bins():
    """Bins past the capacity (in lexicographic key order) are dropped, as
    in the JAX module."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-3, 3, size=(1, 400, 3)).astype(np.float32)
    w = np.ones((1, 400), np.float32)
    valid = np.ones((1, 400), bool)
    js, jw, jm = (np.asarray(x) for x in jms.create_seeds(
        jnp.asarray(pos[0]), jnp.asarray(w[0]), jnp.asarray(valid[0]),
        jms.seeds_range(jnp.float32(BW)), 32))
    ts, tw, tm = (n(x) for x in tms.create_seeds(
        t(pos), t(w), t(valid), tms.seeds_range(BW), 32))
    assert tm.all() and jm.all()
    np.testing.assert_allclose(ts[0], js, atol=1e-6)
    np.testing.assert_allclose(tw[0], jw, atol=1e-6)


@pytest.fixture(scope="module")
def grid():
    """Two bench-geometry clouds of 1024 points with normals, voxel
    keypoints (capacity 30, not a multiple of 8) and keypoint LRFs from
    the JAX path."""
    rng = np.random.default_rng(6)
    pts = np.stack([shapes.make_instance(rng, i % 5, n=1024, rotate=True)
                    for i in range(2)]).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)

    def per_cloud(p, m):
        nrm = j_normals(p, m, 0.25)
        kres = j_voxel(p, m, 0.35, capacity=30)
        kp = jnp.where(kres.mask[:, None], kres.centroids[:, :3], 1e9)
        lrf = j_shot_lrf(kp, kres.mask, p, m, 0.5)
        return nrm, kp, lrf.frames, lrf.valid

    out = jax.vmap(per_cloud)(jnp.asarray(pts), jnp.asarray(mask))
    return (pts, mask) + tuple(np.asarray(x) for x in out)


_K7_CODE = """
import jax.numpy as jnp
from point_cloud_donkey_tpu.ops.pallas.shot_fused import shot_descriptor_fused
out = {}
out["d"], out["v"] = shot_descriptor_fused(
    *(jnp.asarray(a[k]) for k in ("kp", "fr", "fv", "pts", "nrm", "mask")),
    0.6, interpret=True)
"""


def test_shot_dense_matches_pallas_interpret(grid, tmp_path):
    """K7's twin through shot_descriptor_fused vs the Pallas dense-grid
    kernel: the descriptor contract (validity equal, cosine > 0.999,
    < 1e-4 of entries off by > 1e-3)."""
    pts, mask, nrm, kp, fr, fv = grid
    fv = fv.copy()
    fv[:, ::7] = False      # rows whose frame is invalid are not described
    ref = pallas_interpret(_K7_CODE, str(tmp_path), kp=kp, fr=fr, fv=fv,
                           pts=pts, nrm=nrm, mask=mask)
    jd, jv = ref["d"], ref["v"]
    td, tv = tshot.shot_descriptor_fused(t(kp), t(fr), t(fv), t(pts),
                                         t(nrm), t(mask), 0.6)
    assert td.shape == (2, 30, 352)
    assert_descriptors_close(td.reshape(-1, 352), tv.reshape(-1),
                             np.asarray(jd).reshape(-1, 352),
                             np.asarray(jv).reshape(-1))


def test_shot_dense_skips_dead_rows_and_checks_k(grid):
    """Rows that are not live get a zero histogram and count; any K is
    taken (the grid's K = 30 is not a multiple of 8) and gives the rows
    of a smaller K (counts equal, histograms within the float summation
    order), and a live mask that does not match K is refused."""
    pts, mask, nrm, kp, fr, fv = grid
    live = np.zeros((2, 24), bool)
    live[0, :5] = True
    h, c = tshot.shot_dense(t(kp[:, :24]), t(fr[:, :24]), t(live), t(pts),
                            t(nrm), t(mask), 0.6)
    assert (n(c)[~live] == 0).all() and (n(h)[~live] == 0).all()
    assert (n(c)[live] > 0).all()
    h30, c30 = tshot.shot_dense(t(kp), t(fr), t(fv), t(pts), t(nrm),
                                t(mask), 0.6)
    assert h30.shape == (2, 30, 352) and n(c30)[fv].min() > 0
    h24, c24 = tshot.shot_dense(t(kp[:, :24]), t(fr[:, :24]), t(fv[:, :24]),
                                t(pts), t(nrm), t(mask), 0.6)
    assert torch.equal(c30[:, :24], c24)
    torch.testing.assert_close(h30[:, :24], h24, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tshot.shot_dense(t(kp), t(fr), t(fv[:, :24]), t(pts), t(nrm),
                         t(mask), 0.6)


def _detector(device="cpu"):
    config = IsmConfig.load(CODEBOOK)
    cb = load_codebook(CODEBOOK).to(device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192)
    return IsmDetector(cb, cfg,
                       CodebookParams.from_config(config.child("Codebook")))


def test_detector_matches_jax_detect_maxima():
    """IsmDetector vs jax.vmap(detect_maxima_jit) on 4 bench clouds, one
    padded: argmax equal on every cloud (all are firm), densities within
    rtol 1e-3, and the best class's maximum within 2e-3 -- twice the
    mean-shift stopping threshold, since both stop within 1e-3 of the
    fixed point.  Every stage reports once, in order; no kernel is
    launched for CPU tensors."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:4].copy()
    mask = np.ones(pts.shape[:2], bool)
    mask[3, 1800:] = False
    pts[3, 1800:] = 1e9
    jd, jp = jax_detect(CODEBOOK, pts, mask)
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        td, tp = _detector()(t(pts), t(mask), on_stage=seen.append)
    assert tuple(seen) == DETECT_STAGES
    assert set(build.launch_counts().values()) == {0}
    td, tp = n(td), n(tp)
    top2 = np.sort(jd, 1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 3.0).all()
    np.testing.assert_array_equal(td.argmax(1), jd.argmax(1))
    assert (td.argmax(1) == ref["labels"][:4]).all()
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)
    best = jd.argmax(1)
    np.testing.assert_allclose(tp[np.arange(4), best],
                               jp[np.arange(4), best], atol=2e-3)


def test_serve_maxima_prints_one_maximum_per_cloud(tmp_path, capsys):
    """serve --maxima on 4 PCDs: each line carries the predicted class's
    maximum, in the JAX cli/serve.py format, and the predictions are the
    committed JAX detection reference's."""
    ref = np.load(REFERENCE)
    lines = ["# test"]
    for i in range(4):
        path = tmp_path / f"c{i}.pcd"
        save_pcd(str(path), ref["points"][i])
        lines.append(f"{path} {ref['labels'][i]}")
    flist = tmp_path / "test.txt"
    flist.write_text("\n".join(lines) + "\n")
    rc = serve.main(["-d", CODEBOOK, "-f", str(flist), "--device", "cpu",
                     "--batch", "4", "--maxima"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^.+: predicted (\d+), ground truth (\d+) (?:OK|WRONG)"
                      r" maximum \((\S+) (\S+) (\S+)\)$", out, re.M)
    assert len(rows) == 4
    want = ref["detect_densities"][:4].argmax(1)
    assert [int(r[0]) for r in rows] == want.tolist()
    got = np.array([[float(x) for x in r[2:]] for r in rows])
    best = ref["detect_positions"][np.arange(4), want]
    np.testing.assert_allclose(got, best, atol=2e-3)
    assert " Accuracy: 100 % " in out
