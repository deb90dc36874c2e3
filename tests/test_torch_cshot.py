"""The port's CSHOT serving path against the JAX package on the CPU:
colour conversion (LUT-edge values included), the voxel grid with colour
features, K8's plain twin against ``_shot_histogram_2pass`` and the Pallas
``shot_histogram_pallas`` (interpret mode), the dense CSHOT descriptor, the
CSHOT classify slice against the committed JAX-CPU scores, serve on
coloured PCD files, and colours through the port's and the JAX readers."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_data import bench_colors
from torch_fixtures import CODEBOOKS, DESCRIPTOR_REFERENCE, REFERENCE
from torch_parity import (assert_decisions_match, assert_descriptors_close,
                          n, pallas_interpret, t)

from point_cloud_donkey_tpu.ops import color as jcolor
from point_cloud_donkey_tpu.ops.lrf import shot_lrf as j_shot_lrf
from point_cloud_donkey_tpu.ops.normals import \
    compute_normals_fast as j_normals
from point_cloud_donkey_tpu.ops.shot import (_shot_histogram_2pass,
                                             cshot_descriptor_dense)
from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid as j_voxel
from point_cloud_donkey_tpu.utils import io as jio
from point_cloud_donkey_tpu_torch import serve
from point_cloud_donkey_tpu_torch.kernels import build
from point_cloud_donkey_tpu_torch.models.codebook import (CodebookParams,
                                                          load_codebook)
from point_cloud_donkey_tpu_torch.models.pipeline import (STAGES,
                                                          IsmClassifier,
                                                          PipelineConfig)
from point_cloud_donkey_tpu_torch.ops import color as tcolor
from point_cloud_donkey_tpu_torch.ops.kernels import shot_hist as tk8
from point_cloud_donkey_tpu_torch.ops.shot import CSHOT_LEN
from point_cloud_donkey_tpu_torch.ops.shot import \
    cshot_descriptor_dense as t_cshot
from point_cloud_donkey_tpu_torch.ops.voxel_grid import voxel_grid as t_voxel
from point_cloud_donkey_tpu_torch.utils import io as tio
from point_cloud_donkey_tpu_torch.utils.config import IsmConfig

jlab = jax.jit(jcolor.rgb_to_cielab_normalized)


def _lut_edge_colours(rng, count=200_000, tol=2e-3):
    """Colours whose XYZ value t sits within `tol` of a LUT index edge
    (t * 4000 near an integer), from random floats and random bytes."""
    rgb = np.concatenate([
        rng.random((count, 3)),
        rng.integers(0, 256, (count, 3)) / 255.0]).astype(np.float32)
    c = rgb.astype(np.float64)
    f = np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = f @ m.T / np.array([0.95047, 1.0, 1.08883])
    frac = xyz * 4000.0 - np.round(xyz * 4000.0)
    near = (np.abs(frac) < tol).any(-1) & (xyz * 4000.0 < 3999).all(-1)
    return rgb[near]


def test_lab_matches_jax_at_lut_edges():
    """On colours whose t * 4000 lies within 2e-3 of a LUT edge, no LUT
    index moves: normalised Lab within 1e-6 of the compiled JAX function
    (a one-index move is >= ~1e-4; reading: max |delta| 3e-7, from the LUT
    entries where pow differs by one ulp)."""
    edges = _lut_edge_colours(np.random.default_rng(0))
    assert len(edges) > 500
    got = n(tcolor.rgb_to_cielab_normalized(t(edges)))
    want = np.asarray(jlab(jnp.asarray(edges)))
    assert np.abs(got - want).max() <= 1e-6


def test_lab_powers_match_jax_on_bytes_and_lut_entries():
    """The sRGB power equals the compiled JAX one on all 256 byte values;
    the LUT power f^0.3333 differs by one ulp on at most 2 of the 4000
    LUT entries (ops/color.py)."""
    byte = (np.arange(256, dtype=np.float32) / np.float32(255)).astype(
        np.float32)
    base = np.asarray(jax.jit(lambda c: (c + 0.055) / 1.055)(byte))
    np.testing.assert_array_equal(base, n(
        (t(byte) + 0.055) * tcolor._recip(1.055)))
    np.testing.assert_array_equal(
        n(tcolor._pow(t(base), 2.4)),
        np.asarray(jax.jit(lambda c: c ** 2.4)(base)))
    lut = (np.arange(4000, dtype=np.float32) * np.float32(
        tcolor._LUT_STEP)).astype(np.float32)
    got = n(tcolor._pow(t(lut), 0.3333))
    want = np.asarray(jax.jit(lambda c: c ** 0.3333)(lut))
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).sum() <= 2


def test_lab_matches_jax_on_random_colours():
    rng = np.random.default_rng(1)
    rgb = np.concatenate([rng.random((20000, 3)),
                          rng.integers(0, 256, (20000, 3)) / 255.0,
                          [[0, 0, 0], [1, 1, 1], [0.04045, 0.5, 1.0]]])
    rgb = rgb.astype(np.float32)
    got = n(tcolor.rgb_to_cielab_normalized(t(rgb)))
    np.testing.assert_allclose(got, np.asarray(jlab(jnp.asarray(rgb))),
                               rtol=0, atol=1e-6)


def test_color_distance_matches_jax():
    """Bit-equal: the same float operations as the compiled JAX function."""
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    got = n(tcolor.color_distance(t(a), t(b)))
    want = np.asarray(jax.jit(jcolor.color_distance)(jnp.asarray(a),
                                                     jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def test_voxel_grid_with_colour_features_matches_jax():
    """Per-voxel means of [xyz, rgb] in the same voxel order, f32 round-off
    (both sum each voxel in sorted order); a padded cloud too."""
    ref = np.load(REFERENCE)
    pts = ref["points"][:2].copy()
    rgb = bench_colors(pts)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 1500:] = False
    pts[1, 1500:] = 1e9
    tres = t_voxel(t(pts), t(mask), 0.35, capacity=192, features=t(rgb))
    for i in range(2):
        jres = j_voxel(jnp.asarray(pts[i]), jnp.asarray(mask[i]), 0.35,
                       features=jnp.asarray(rgb[i]), capacity=192)
        np.testing.assert_array_equal(n(tres.mask[i]), np.asarray(jres.mask))
        np.testing.assert_allclose(n(tres.centroids[i]),
                                   np.asarray(jres.centroids),
                                   rtol=1e-6, atol=1e-6)
    assert tres.centroids.shape == (2, 192, 6)


def _slot_arrays(n_bin):
    """The shapes of tests/test_pallas_kernels.py: K=37 rows, M=700."""
    rng = np.random.default_rng(11)
    k, m = 37, 700
    ints = [rng.integers(0, hi, (k, m)).astype(np.int32)
            for hi in (32, n_bin, n_bin, 32, 32, 32)]
    ws = [(rng.random((k, m)) * 2).astype(np.float32) for _ in range(5)]
    d, s, cb, rv, iv, av = ints
    cw, cosw, rw, iw, aw = ws
    return [d, s, cw, cb, cosw, rv, rw, iv, iw, av, aw]


@pytest.mark.parametrize("n_bin", [11, 31])
def test_shot_hist_twin_matches_2pass(n_bin):
    """K8's twin vs the XLA two-pass accumulation (f32 on the CPU): f32
    summation order only, rtol 1e-5 (sums of ~700 weights up to 2)."""
    args = _slot_arrays(n_bin)
    want = np.asarray(_shot_histogram_2pass(*map(jnp.asarray, args),
                                            n_bin=n_bin))
    got = tk8.shot_hist(*map(t, args), n_bin)
    assert got.shape == (37, 32 * n_bin)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def pallas_shot_hist(tmp_path_factory):
    """shot_histogram_pallas in interpret mode on the slot arrays of both
    bin counts (one process of its own: torch_parity.pallas_interpret)."""
    arrays = {f"s{nb}_{i}": x for nb in (11, 31)
              for i, x in enumerate(_slot_arrays(nb))}
    return pallas_interpret(
        "from point_cloud_donkey_tpu.ops.pallas.shot_hist import "
        "shot_histogram_pallas\n"
        "out = {f's{nb}': shot_histogram_pallas("
        "*[a[f's{nb}_{i}'] for i in range(11)], nb) for nb in (11, 31)}",
        str(tmp_path_factory.mktemp("pallas_shot_hist")), **arrays)


@pytest.mark.parametrize("n_bin", [11, 31])
def test_shot_hist_twin_matches_pallas_interpret(n_bin, pallas_shot_hist):
    """K8's twin vs the Pallas kernel it replaces, interpret mode: the
    tolerance of the JAX package's own Pallas-vs-XLA test (atol 1e-3)."""
    got = tk8.shot_hist(*map(t, _slot_arrays(n_bin)), n_bin)
    np.testing.assert_allclose(n(got), pallas_shot_hist[f"s{n_bin}"],
                               atol=1e-3)


def test_shot_hist_ignores_out_of_range_indices():
    """As in the one-hot products, an index outside [0, 32) x [0, n_bin)
    adds nothing, and zero weights add nothing."""
    args = [t(a) for a in _slot_arrays(11)]
    want = tk8.shot_hist(*args, 11)
    bad = [a.clone() for a in args]
    bad[0][:, :5] = 32      # desc out of range: pass A of those columns
    bad[2][:, :5] = 0.0
    bad[4][:, :5] = 0.0     # ... and their weights zero: same histogram
    bad[5][0, 10] = -1      # a negative radial volume drops one slot
    got = tk8.shot_hist(*bad, 11)
    fix = [a.clone() for a in args]
    fix[2][:, :5] = 0.0
    fix[4][:, :5] = 0.0
    fix[6][0, 10] = 0.0
    np.testing.assert_allclose(n(got), n(tk8.shot_hist(*fix, 11)), atol=0)
    assert not torch.equal(got, want)


@pytest.fixture(scope="module")
def coloured_cloud():
    """Bench cloud 0 with its colours, and the JAX path's normals, voxel
    keypoints (with mean colours) and keypoint LRFs."""
    ref = np.load(REFERENCE)
    pts = ref["points"][0]
    rgb = bench_colors(pts)
    mask = np.ones(len(pts), bool)

    @jax.jit
    def front(p, m, c):
        kres = j_voxel(p, m, 0.35, features=c, capacity=192)
        kp = jnp.where(kres.mask[:, None], kres.centroids[:, :3], 1e9)
        lrf = j_shot_lrf(kp, kres.mask, p, m, 0.5)
        return (j_normals(p, m, 0.25), kp, kres.centroids[:, 3:6],
                lrf.frames, lrf.valid)

    return (pts, rgb, mask) + tuple(np.asarray(x)
                                    for x in front(pts, mask, rgb))


def test_cshot_dense_matches_jax(coloured_cloud):
    """Descriptor contract vs the JAX dense CSHOT (matmul-identity
    distances and local coordinates; the port takes exact differences):
    validity equal, cosine > 0.999 per valid keypoint, < 1e-4 of entries
    off by > 1e-3."""
    pts, rgb, mask, nrm, kp, kp_rgb, fr, fv = coloured_cloud
    want = jax.jit(lambda *a: cshot_descriptor_dense(*a, 0.6))(
        kp, kp_rgb, fr, fv, pts, nrm, rgb, mask)
    got = t_cshot(t(kp), t(kp_rgb), t(fr), t(fv), t(pts), t(nrm), t(rgb),
                  t(mask), 0.6)
    assert got.descriptors.shape == (192, CSHOT_LEN)
    assert n(got.valid).sum() > 50
    assert_descriptors_close(got.descriptors, got.valid, want.descriptors,
                             want.valid)


def cshot_model(device="cpu"):
    path = CODEBOOKS["CSHOT"]
    config = IsmConfig.load(path)
    cb = load_codebook(path).to(device)
    cfg = PipelineConfig.from_ism(config, cb.num_classes,
                                  keypoint_capacity=192)
    return IsmClassifier(cb, cfg,
                         CodebookParams.from_config(config.child("Codebook")))


def test_cshot_slice_matches_committed_jax_scores():
    """IsmClassifier on the first 4 bench clouds with their colours vs the
    committed JAX-CPU classify_scores_batch scores (decision rule: argmax
    on margins > 3, rms <= 5% of the scale; reading: rms ~5e-6 of a 133
    scale); every stage reports, in order; no kernel launches on the CPU."""
    ref = np.load(REFERENCE)
    dref = np.load(DESCRIPTOR_REFERENCE)
    pts = ref["points"][:4]
    rgb = dref["rgb8"][:4].astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(rgb, bench_colors(pts))
    model = cshot_model()
    assert model.cfg.descriptor == "CSHOT"
    assert model.codebook.codewords.shape[1] == CSHOT_LEN
    seen = []
    build.reset_launch_counts()
    with torch.no_grad():
        scores = model(t(pts), t(np.ones(pts.shape[:2], bool)), t(rgb),
                       on_stage=seen.append)
    assert tuple(seen) == STAGES
    assert set(build.launch_counts().values()) == {0}
    assert_decisions_match(scores, dref["scores_cshot"][:4])
    assert (n(scores).argmax(1) == ref["labels"][:4]).all()


def test_cshot_without_colours_raises():
    ref = np.load(REFERENCE)
    pts = t(ref["points"][:1])
    with pytest.raises(ValueError, match="RGB"):
        cshot_model()(pts, torch.ones(pts.shape[:2], dtype=torch.bool))


def _write_list(tmp_path, clouds, labels, colours=True):
    lines = ["# test"]
    for i, (cloud, label) in enumerate(zip(clouds, labels)):
        path = tmp_path / f"c{i}.pcd"
        tio.save_pcd(str(path), cloud, rgb=bench_colors(cloud) if colours
                     else None)
        lines.append(f"{path} {label}")
    flist = tmp_path / "test.txt"
    flist.write_text("\n".join(lines) + "\n")
    return str(flist)


def test_serve_classifies_coloured_pcds(tmp_path, capsys):
    """serve.main with the CSHOT model on a coloured PCD, padded to 2100
    points whose pad rows carry zero colours: the committed reference's
    prediction; a file without colours and --maxima are refused with the
    JAX CLI's messages.  (tests/test_torch_slice.py covers batching.)"""
    ref = np.load(REFERENCE)
    dref = np.load(DESCRIPTOR_REFERENCE)
    clouds = [ref["points"][3]]
    flist = _write_list(tmp_path, clouds, ref["labels"][3:4])
    rc = serve.main(["-d", CODEBOOKS["CSHOT"], "-f", flist, "--device",
                     "cpu", "--points", "2100"])
    assert rc == 0
    out = capsys.readouterr().out
    preds = re.findall(r": predicted (\d+), ground truth (\d+) ", out)
    expect = dref["scores_cshot"][3:4].argmax(1)
    assert [int(p[0]) for p in preds] == expect.tolist()

    plain = _write_list(tmp_path, clouds[:1], ref["labels"][:1],
                        colours=False)
    assert serve.main(["-d", CODEBOOKS["CSHOT"], "-f", plain, "--device",
                       "cpu"]) == 1
    assert "CSHOT needs RGB data" in capsys.readouterr().err
    assert serve.main(["-d", CODEBOOKS["CSHOT"], "-f", flist, "--device",
                       "cpu", "--maxima"]) == 1
    assert "--maxima does not support CSHOT yet" in capsys.readouterr().err


def _write_rgb_file(path, kind, xyz, rgb8):
    """A cloud file with colours in one of the encodings the readers
    take."""
    n_pts = len(xyz)
    if kind in ("jax_ascii", "jax_binary"):
        jio.save_pcd(path, jio.PointCloud(xyz=xyz, rgb=rgb8 / np.float32(255)),
                     binary=kind == "jax_binary")
    elif kind in ("port_ascii", "port_binary"):
        tio.save_pcd(path, xyz, binary=kind == "port_binary",
                     rgb=rgb8 / np.float32(255))
    elif kind == "pcd_rgba_u8":
        rec = np.zeros(n_pts, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("rgba", "<u4")])
        rec["x"], rec["y"], rec["z"] = xyz.T
        rec["rgba"] = ((0xFF << 24) | (rgb8[:, 0] << 16).astype(np.uint32)
                       | (rgb8[:, 1] << 8) | rgb8[:, 2])
        head = ("VERSION 0.7\nFIELDS x y z rgba\nSIZE 4 4 4 4\nTYPE F F F U\n"
                f"COUNT 1 1 1 1\nWIDTH {n_pts}\nHEIGHT 1\nPOINTS {n_pts}\n"
                "DATA binary\n")
        with open(path, "wb") as f:
            f.write(head.encode() + rec.tobytes())
    elif kind == "pcd_r_g_b":
        head = ("VERSION 0.7\nFIELDS x y z r g b\nSIZE 4 4 4 1 1 1\n"
                "TYPE F F F U U U\nCOUNT 1 1 1 1 1 1\n"
                f"WIDTH {n_pts}\nHEIGHT 1\nPOINTS {n_pts}\nDATA ascii\n")
        rows = [" ".join([repr(float(v)) for v in p] + [str(int(c)) for c in q])
                for p, q in zip(xyz, rgb8)]
        with open(path, "w") as f:
            f.write(head + "\n".join(rows) + "\n")
    else:
        fmt = {"ply_ascii": "ascii", "ply_binary": "binary_little_endian"}[
            kind]
        head = (f"ply\nformat {fmt} 1.0\nelement vertex {n_pts}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        with open(path, "wb") as f:
            f.write(head.encode())
            if fmt == "ascii":
                f.write("".join(
                    " ".join([repr(float(v)) for v in p]
                             + [str(int(c)) for c in q]) + "\n"
                    for p, q in zip(xyz, rgb8)).encode())
            else:
                rec = np.zeros(n_pts, [("x", "<f4"), ("y", "<f4"),
                                       ("z", "<f4"), ("r", "u1"), ("g", "u1"),
                                       ("b", "u1")])
                rec["x"], rec["y"], rec["z"] = xyz.T
                rec["r"], rec["g"], rec["b"] = rgb8.T
                f.write(rec.tobytes())


@pytest.mark.parametrize("kind", ["jax_ascii", "jax_binary", "port_ascii",
                                  "port_binary", "pcd_rgba_u8", "pcd_r_g_b",
                                  "ply_ascii", "ply_binary"])
def test_rgb_round_trip_matches_jax_readers(tmp_path, kind):
    """The port's read_cloud gives the written bytes / 255, and the JAX
    load_cloud's colours (and xyz) bit for bit in every encoding but an
    unsigned packed rgba field, whose bits the JAX reader loses by casting
    the field to float first (ROADMAP C)."""
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(97, 3)).astype(np.float32)
    rgb8 = rng.integers(0, 256, (97, 3)).astype(np.uint32)
    path = str(tmp_path / ("c.ply" if kind.startswith("ply") else "c.pcd"))
    _write_rgb_file(path, kind, xyz, rgb8)
    got = tio.read_cloud(path)
    want = jio.load_cloud(path)
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.rgb,
                                  rgb8.astype(np.float32) / np.float32(255))
    if kind == "pcd_rgba_u8":
        assert not np.array_equal(want.rgb, got.rgb)
    else:
        np.testing.assert_array_equal(got.rgb, want.rgb)
    assert got.rgb.dtype == np.float32
    np.testing.assert_array_equal(tio.load_cloud(path), xyz)


def test_cloud_without_colours_reads_none(tmp_path):
    path = str(tmp_path / "c.pcd")
    tio.save_pcd(path, np.zeros((4, 3), np.float32))
    assert tio.read_cloud(path).rgb is None


@pytest.mark.parametrize("binary", [False, True])
def test_bench_colours_survive_a_pcd_round_trip(tmp_path, binary):
    """bench_colors quantises to what a PCD holds: writing and reading
    (the port's writer and reader, and the JAX package's) leaves them
    unchanged, so the JAX training (from PCD files), the in-memory batch
    and the serve files see the same colours."""
    ref = np.load(REFERENCE)
    pts = ref["points"][1]
    rgb = bench_colors(pts)
    assert rgb.dtype == np.float32 and len(np.unique(rgb)) > 100
    path = str(tmp_path / "c.pcd")
    tio.save_pcd(path, pts, binary=binary, rgb=rgb)
    np.testing.assert_array_equal(tio.read_cloud(path).rgb, rgb)
    jio.save_pcd(path, jio.PointCloud(xyz=pts, rgb=rgb), binary=binary)
    np.testing.assert_array_equal(jio.load_cloud(path).rgb, rgb)
    np.testing.assert_array_equal(tio.read_cloud(path).rgb, rgb)
