"""The port's SHORT_SHOT serving path against the JAX package on the CPU:
K9's plain twin against ``_histogram_from_slots`` and the Pallas
``batched_histogram`` (interpret mode), the bin helpers, the dense
SHORT_SHOT descriptor, the SHORT_SHOT classify slice against the committed
JAX-CPU scores (no normal stage), and serve."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fixtures import CODEBOOKS, DESCRIPTOR_REFERENCE, REFERENCE
from torch_parity import (assert_decisions_match, assert_descriptors_close,
                          n, pallas_interpret, t)

from point_cloud_donkey_tpu.ops import short_shot as jss
from point_cloud_donkey_tpu.ops.lrf import shot_lrf as j_shot_lrf
from point_cloud_donkey_tpu.ops.shot import _histogram_from_slots
from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid as j_voxel
from point_cloud_donkey_tpu_torch import serve
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models import pipeline as tpipe
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (STAGES,
                                                          IsmClassifier,
                                                          IsmDetector,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import short_shot as tss
from point_cloud_donkey_tpu_torch.ops.kernels import histogram as tk9
from point_cloud_donkey_tpu_torch.utils import io as tio
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig


def _slots(r=37, m=700, length=32):
    """[R, M, 4] slots as the descriptor makes them: zero weights (a
    quarter of the entries) point at bin 0."""
    rng = np.random.default_rng(12)
    idx = rng.integers(0, length, (r, m, 4)).astype(np.int32)
    w = (rng.random((r, m, 4)) * 3).astype(np.float32)
    w[rng.random(w.shape) < 0.25] = 0.0
    idx[w == 0] = 0
    return idx, w


def test_histogram_twin_matches_histogram_from_slots():
    """K9's twin vs the XLA chunked-bin reduction (f32 on the CPU): f32
    summation order only, rtol 1e-5."""
    idx, w = _slots()
    want = np.asarray(_histogram_from_slots(jnp.asarray(idx), jnp.asarray(w),
                                            32))
    got = tk9.histogram_plain(t(idx.reshape(37, -1)), t(w.reshape(37, -1)),
                              32)
    assert got.shape == (37, 32)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def pallas_histogram(tmp_path_factory):
    """batched_histogram in interpret mode at both widths (one process of
    its own: torch_parity.pallas_interpret)."""
    arrays = {}
    for length in (32, 77):
        idx, w = _slots(length=length)
        arrays[f"i{length}"] = idx.reshape(37, -1)
        arrays[f"w{length}"] = w.reshape(37, -1)
    return pallas_interpret(
        "from point_cloud_donkey_tpu.ops.pallas.histogram import "
        "batched_histogram\n"
        "out = {f'h{n}': batched_histogram(a[f'i{n}'], a[f'w{n}'], n) "
        "for n in (32, 77)}",
        str(tmp_path_factory.mktemp("pallas_histogram")), **arrays)


@pytest.mark.parametrize("length", [32, 77])
def test_histogram_twin_matches_pallas_interpret(length, pallas_histogram):
    """K9's twin vs the Pallas kernel it replaces, interpret mode, at the
    SHORT_SHOT width and at a width that is no power of two: f32 summation
    order only, rtol 1e-5."""
    idx, w = _slots(length=length)
    got = tk9.histogram_plain(t(idx.reshape(37, -1)), t(w.reshape(37, -1)),
                              length)
    np.testing.assert_allclose(n(got), pallas_histogram[f"h{length}"],
                               rtol=1e-5, atol=1e-4)


def test_histogram_ignores_out_of_range_indices():
    """An index outside [0, L) adds nothing, as in the masked reduction."""
    idx, w = _slots()
    idx, w = t(idx.reshape(37, -1)), t(w.reshape(37, -1))
    bad = idx.clone()
    bad[:, :3] = 32
    bad[0, 5] = -1
    fix = w.clone()
    fix[:, :3] = 0.0
    fix[0, 5] = 0.0
    np.testing.assert_array_equal(n(tk9.histogram_plain(bad, w, 32)),
                                  n(tk9.histogram_plain(idx, fix, 32)))


@pytest.mark.parametrize("dims,kind,bins", [
    (32, "auto", (2, 2, 8)), (64, "auto", (1, 1, 1)), (50, "auto", (1, 1, 1)),
    (0, "manual", (3, 2, 5)), (0, "other", (1, 1, 1))])
def test_resolve_bins_matches_jax(dims, kind, bins):
    assert tss.resolve_bins(dims, kind, *bins) == jss.resolve_bins(dims, kind,
                                                                   *bins)


def test_interp_and_correct_bin_match_jax():
    """Bit-equal on bin edges (dec == 0.5, integers) and random values."""
    raw = np.concatenate([np.arange(-2, 9, 0.25), np.random.default_rng(3)
                          .uniform(-1, 9, 5000)]).astype(np.float32)
    tw, to = tss._interp(t(raw))
    jw, jo = jss._interp(jnp.asarray(raw))
    np.testing.assert_array_equal(n(tw), np.asarray(jw))
    np.testing.assert_array_equal(n(to), np.asarray(jo))
    b = np.arange(-3, 12, dtype=np.int32)
    for cyclic in (False, True):
        np.testing.assert_array_equal(
            n(tss._correct_bin(t(b), 8, cyclic)),
            np.asarray(jss._correct_bin(jnp.asarray(b), 8, cyclic)))


@pytest.fixture(scope="module")
def keypoint_cloud():
    """Bench cloud 2 with a padded tail, and the JAX path's voxel keypoints
    and keypoint LRFs."""
    ref = np.load(REFERENCE)
    pts = ref["points"][2].copy()
    mask = np.ones(len(pts), bool)
    mask[1900:] = False
    pts[1900:] = 1e9

    @jax.jit
    def front(p, m):
        kres = j_voxel(p, m, 0.35, capacity=192)
        kp = jnp.where(kres.mask[:, None], kres.centroids[:, :3], 1e9)
        lrf = j_shot_lrf(kp, kres.mask, p, m, 0.5)
        return kp, lrf.frames, lrf.valid

    return (pts, mask) + tuple(np.asarray(x) for x in front(pts, mask))


def test_short_shot_dense_matches_jax(keypoint_cloud):
    """Descriptor contract vs the JAX dense SHORT_SHOT (matmul-identity
    radius gate; the port takes exact differences, and its truncated bins
    and degrees(arccos) / arctan2 edges may move a boundary pair into the
    neighbouring bin): validity equal, cosine > 0.999 per valid keypoint,
    < 1e-4 of entries off by > 1e-3."""
    pts, mask, kp, fr, fv = keypoint_cloud
    want = jax.jit(lambda *a: jss.short_shot_descriptor_dense(*a, 0.6))(
        kp, fr, fv, pts, mask)
    got = tss.short_shot_descriptor_dense(t(kp), t(fr), t(fv), t(pts),
                                          t(mask), 0.6)
    assert got.descriptors.shape == (192, 32)
    assert n(got.valid).sum() > 50
    assert_descriptors_close(got.descriptors, got.valid, want.descriptors,
                             want.valid)


def short_shot_model(device="cpu"):
    path = CODEBOOKS["SHORT_SHOT"]
    config = IsmConfig.load(path)
    cb = load_codebook(path).to(device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192)
    return IsmClassifier(cb, cfg,
                         CodebookParams.from_config(config.child("Codebook")))


def test_short_shot_slice_matches_committed_jax_scores(monkeypatch):
    """IsmClassifier on the first 4 bench clouds vs the committed JAX-CPU
    classify_scores_batch scores (decision rule: argmax on margins > 3, rms
    <= 5% of the scale; reading: rms ~7e-6 of a 40 scale); every stage
    reports in order, the normal stage computes nothing, and no kernel
    launches on the CPU."""
    ref = np.load(REFERENCE)
    dref = np.load(DESCRIPTOR_REFERENCE)
    pts = ref["points"][:4]

    def no_normals(*a, **k):
        raise AssertionError("SHORT_SHOT reads no normals")

    monkeypatch.setattr(tpipe, "compute_normals_fast", no_normals)
    model = short_shot_model()
    assert model.codebook.codewords.shape[1] == 32
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(t(pts), t(np.ones(pts.shape[:2], bool)),
                       on_stage=seen.append)
    assert tuple(seen) == STAGES
    assert set(build.launch_counts().values()) == {0}
    assert_decisions_match(scores, dref["scores_short_shot"][:4])
    np.testing.assert_array_equal(n(scores).argmax(1),
                                  dref["scores_short_shot"][:4].argmax(1))


def test_unported_short_shot_and_cshot_paths_raise():
    """Detection serves SHOT only (SHORT_SHOT / CSHOT detection: ROADMAP
    A); CSHOT with a normals window is not ported."""
    model = short_shot_model()
    for desc in ("SHORT_SHOT", "CSHOT"):
        with pytest.raises(NotImplementedError):
            IsmDetector(model.codebook, model.cfg._replace(descriptor=desc))
    with pytest.raises(NotImplementedError):
        IsmClassifier(model.codebook, model.cfg._replace(
            descriptor="CSHOT", normals_window=1280))


def test_serve_classifies_with_the_short_shot_model(tmp_path, capsys):
    """serve.main with the SHORT_SHOT model on 3 PCDs (no colours, no
    normals): the committed reference's predictions; --maxima is refused."""
    ref = np.load(REFERENCE)
    dref = np.load(DESCRIPTOR_REFERENCE)
    lines = ["# test"]
    for i in range(3):
        path = tmp_path / f"c{i}.pcd"
        tio.save_pcd(str(path), ref["points"][i], binary=True)
        lines.append(f"{path} {ref['labels'][i]}")
    flist = tmp_path / "test.txt"
    flist.write_text("\n".join(lines) + "\n")
    rc = serve.main(["-d", CODEBOOKS["SHORT_SHOT"], "-f", str(flist),
                     "--device", "cpu", "--batch", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    preds = re.findall(r": predicted (\d+), ground truth (\d+) ", out)
    expect = dref["scores_short_shot"][:3].argmax(1)
    assert [int(p[0]) for p in preds] == expect.tolist()
    assert serve.main(["-d", CODEBOOKS["SHORT_SHOT"], "-f", str(flist),
                       "--device", "cpu", "--maxima"]) == 1
    assert "--maxima does not support SHORT_SHOT yet" in \
        capsys.readouterr().err
