"""The rest of the descriptor zoo, op by op, against the JAX package on the
CPU: BSHOT, SHORT_SHOT_PCL, SpinImage, PFH (ops/descriptors_misc.py),
3DSC / USC, RSD, RIFT (ops/shape_context.py), RoPS (ops/rops.py), COSPAIR
(ops/cospair.py), ESF, ESF_LOCAL, VFH, GRSD, GASD
(ops/global_descriptors.py), CVFH / OURCVFH (ops/cvfh.py) and NARF
(ops/narf.py).

Contracts:
  * ESF's sample indices equal jax.random's bit for bit: threefry-2x32,
    split and randint over several seeds and counts (1, 3, 1000, 2048, one
    not a power of two, one above 2^16), and with an array of counts
    (ESF_LOCAL's, as under jax.vmap); the golden fixture's `esf_idx`;
  * each op against the golden rows (tests/golden/descriptors.npz) and
    against its JAX function on the same inputs at the JAX golden test's
    own tolerance (tests/test_golden_descriptors.py): spin image atol
    2e-4, PFH 0.15, COSPAIR 2e-3, shape context rtol 2e-3 / atol 1e-4,
    RSD 1e-5, RIFT 2e-4, RoPS 5e-3, SHORT_SHOT_PCL 2e-3, GASD 6e-3, NARF
    2e-4, ESF 1e-3, VFH 1e-3, GRSD 1e-3;
  * ESF gives the same descriptor at any padded length;
  * the threshold decisions (BSHOT's bits, RoPS's and GASD's signs, NARF's
    roll, GRSD's classes, RSD's bins, CVFH's regions) differ only within
    their rounding bands (tests/zoo2_check.py), their counts printed.
"""

import os

import numpy as np
import pytest
import torch

import kinect_data
import zoo2_check as zc
from test_torch_zoo import _cloud
from torch_parity import n, t

import jax
import jax.numpy as jnp
from point_cloud_donkey_tpu.models import features as jfeat
from point_cloud_donkey_tpu.ops import cospair as jcos
from point_cloud_donkey_tpu.ops import cvfh as jcvfh
from point_cloud_donkey_tpu.ops import descriptors_misc as jdm
from point_cloud_donkey_tpu.ops import global_descriptors as jgd
from point_cloud_donkey_tpu.ops import narf as jnarf
from point_cloud_donkey_tpu.ops import rops as jrops
from point_cloud_donkey_tpu.ops import shape_context as jsc
from point_cloud_donkey_tpu.ops.lrf import shot_lrf as jlrf
from point_cloud_donkey_tpu.ops.neighbors import \
    gather_radius_neighbors as jgather
from point_cloud_donkey_tpu.ops.shot import shot_descriptor_dense as jshot
from point_cloud_donkey_tpu_torch.models import features as tfeat
from point_cloud_donkey_tpu_torch.ops import cospair as tcos
from point_cloud_donkey_tpu_torch.ops import cvfh as tcvfh
from point_cloud_donkey_tpu_torch.ops import descriptors_misc as tdm
from point_cloud_donkey_tpu_torch.ops import global_descriptors as tgd
from point_cloud_donkey_tpu_torch.ops import narf as tnarf
from point_cloud_donkey_tpu_torch.ops import rops as trops
from point_cloud_donkey_tpu_torch.ops import shape_context as tsc
from point_cloud_donkey_tpu_torch.ops.kernels.shot_fused import \
    shot_descriptor_fused
from point_cloud_donkey_tpu_torch.ops.neighbors import (
    gather_radius_neighbors, gather_rows)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "descriptors.npz")
RADIUS = 0.6          # the golden fixture's
NARF_SUPPORT = 0.5
NARF_FOCAL = 100.0
R = 0.3               # the batch's radius


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _one(x):
    return t(np.ascontiguousarray(x))[None]


# -- ESF's PRNG ----------------------------------------------------------------

COUNTS = (1, 3, 1000, 2048, 777, 65537)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789])
def test_prng_matches_jax(seed):
    """PRNGKey / split / randint bit for bit, one count at a time and as
    an array of counts under jax.vmap."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    mine = tgd.prng_split(tgd.prng_key(seed), 3)
    assert [tuple(np.asarray(k)) for k in keys] == \
        [(int(a), int(b)) for a, b in mine]
    for count in COUNTS:
        want = np.asarray(jax.random.randint(keys[1], (20000,), 0, count))
        np.testing.assert_array_equal(
            n(tgd.randint(mine[1], 20000, count)), want)
    counts = np.array(COUNTS)
    want = np.asarray(jax.vmap(lambda c: jax.random.randint(
        keys[2], (300,), 0, c))(jnp.asarray(counts)))
    np.testing.assert_array_equal(n(tgd.randint(mine[2], 300, counts)),
                                  want)


def test_esf_indices_match_jax_and_golden(golden):
    """The golden `esf_idx`; masks with masked rows in the middle and at
    the end; ESF_LOCAL's rows of another count each (jax.vmap)."""
    got = tgd.esf_sample_indices(torch.ones((1, 400), dtype=torch.bool),
                                 samples=2000)
    np.testing.assert_array_equal(n(got[0]), golden["esf_idx"])
    rng = np.random.default_rng(3)
    masks = np.stack([rng.random(700) < p for p in (0.002, 0.5, 0.9, 1.0)])
    masks[0, :3] = True
    want = np.asarray(jax.vmap(lambda m: jnp.stack(
        jgd.esf_sample_indices(700, m, 0)))(jnp.asarray(masks)))
    np.testing.assert_array_equal(n(tgd.esf_sample_indices(t(masks))), want)


def test_esf_padding_invariant(golden):
    pts = golden["points"]
    base = tgd.esf_descriptor(_one(pts), torch.ones((1, 400),
                                                    dtype=torch.bool))
    pad = np.concatenate([pts, np.full((57, 3), 1e6, np.float32)])
    padded = tgd.esf_descriptor(_one(pad), _one(np.arange(457) < 400))
    assert torch.equal(base, padded)


# -- the golden rows -------------------------------------------------------------

def _golden_nbr(g):
    kp, pts = g["keypoints"], g["points"]
    return gather_radius_neighbors(_one(kp), _one(pts),
                                   torch.ones((1, len(pts)), dtype=bool),
                                   RADIUS, len(pts))


def _golden_case(name, g):
    """(port value, golden key, tolerance kwargs) of one golden case."""
    pts, nrm, rgb, kp = g["points"], g["normals"], g["rgb"], g["keypoints"]
    fr = g["frames"].astype(np.float32)
    kpo = torch.ones((1, len(kp)), dtype=bool)
    ones = torch.ones((1, len(pts)), dtype=bool)
    axes = nrm[::67][:len(kp)]
    nbr = _golden_nbr(g)
    if name == "bshot":
        return (tdm.bshot_binarize(t(g["shot"].astype(np.float32))),
                "bshot", {"atol": 0})
    if name == "shot_pcl":
        res = shot_descriptor_fused(_one(kp), _one(fr), kpo, _one(pts),
                                    torch.zeros((1, len(pts), 3)), ones,
                                    RADIUS)
        return res[0][0], "shot_pcl", {"atol": 2e-3}
    if name == "spin_image":
        return (tdm.spin_image_descriptor(_one(kp), _one(axes), kpo,
                                          _one(pts), nbr, RADIUS)[0][0],
                name, {"atol": 2e-4})
    if name == "pfh":
        return (tdm.pfh_descriptor(_one(kp), kpo, _one(pts), _one(nrm),
                                   nbr)[0][0], name, {"atol": 0.15})
    if name == "cospair":
        return (tcos.cospair_descriptor(_one(kp), _one(axes), kpo, _one(pts),
                                        _one(nrm), _one(rgb), nbr,
                                        RADIUS)[0][0],
                name, {"atol": 2e-3})
    if name == "shape_context":
        return (tsc.shape_context_descriptor(_one(kp), _one(fr), kpo,
                                             _one(pts), nbr, RADIUS)[0][0],
                name, {"rtol": 2e-3, "atol": 1e-4})
    if name == "rsd":
        return (tsc.rsd_descriptor(_one(kp), kpo, _one(pts), _one(nrm), nbr,
                                   RADIUS)[0][0], name, {"atol": 1e-5})
    if name == "rift":
        return (tsc.rift_descriptor(_one(kp), kpo, _one(pts),
                                    _one(g["gradients"]), nbr,
                                    RADIUS)[0][0], name, {"atol": 2e-4})
    if name == "rops":
        return (trops.rops_descriptor(_one(kp), kpo, _one(pts), nbr,
                                      RADIUS)[0][0], name, {"atol": 5e-3})
    if name == "gasd":
        return tgd.gasd_descriptor(_one(pts), ones)[0], name, {"atol": 6e-3}
    if name == "gasd_color":
        return (tgd.gasd_descriptor(_one(pts), ones, _one(rgb))[0], name,
                {"atol": 6e-3})
    if name == "narf":
        kpn = tnarf.NarfKeypoints(uv=t(g["narf_vu"]), xyz=t(g["narf_xyz"]),
                                  score=torch.ones(4),
                                  valid=torch.ones(4, dtype=bool))
        return (tnarf.narf_descriptor(t(g["narf_img"]), kpn, NARF_SUPPORT,
                                      focal=NARF_FOCAL)[0], name,
                {"atol": 2e-4})
    if name == "esf":
        return (tgd.esf_descriptor(_one(pts), ones, indices=torch.from_numpy(
            g["esf_idx"].astype(np.int64))[None])[0], name, {"atol": 1e-3})
    if name == "vfh":
        return tgd.vfh_descriptor(_one(pts), _one(nrm), ones)[0], name, \
            {"atol": 1e-3}
    assert name == "grsd"
    return (tgd.grsd_descriptor(_one(pts), _one(nrm), ones, RADIUS,
                                types=_one(g["grsd_types"]))[0], name,
            {"atol": 1e-3})


GOLDEN_CASES = ("bshot", "shot_pcl", "spin_image", "pfh", "cospair",
                "shape_context", "rsd", "rift", "rops", "gasd", "gasd_color",
                "narf", "esf", "vfh", "grsd")


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_op_matches_golden(golden, name):
    got, key, tol = _golden_case(name, golden)
    np.testing.assert_allclose(n(got), golden[key], **tol)


# -- against the JAX functions on a batch ------------------------------------

@pytest.fixture(scope="module")
def batch():
    """Three clouds in one batch (masked tails, duplicated points), 40
    keypoints each (some on points, some off, the last 3 masked), the
    normals of each cloud, colours, and the JAX gathers of each cloud."""
    clouds = [_cloud(s) for s in range(3)]
    p = np.stack([c[0] for c in clouds])
    m = np.stack([c[1] for c in clouds])
    nrm = np.stack([c[2] for c in clouds])
    rgb = np.stack([np.clip(0.5 + 0.4 * np.sin(3.0 * c[0]), 0, 1)
                    for c in clouds]).astype(np.float32)
    rgb = np.round(rgb * 255) / np.float32(255)
    kp = np.concatenate([p[:, :30], p[:, 100:110] + 0.01], 1)
    kpm = np.ones(kp.shape[:2], bool)
    kpm[:, -3:] = False
    nbr = gather_radius_neighbors(t(kp), t(p), t(m), R, 500)
    jn = [jgather(jnp.asarray(kp[i]), jnp.asarray(p[i]), jnp.asarray(m[i]),
                  R, 500) for i in range(3)]
    return dict(p=p, m=m, nrm=nrm, rgb=rgb, kp=kp, kpm=kpm, nbr=nbr, jn=jn)


def _jax_rows(b, fn):
    """[3, K, ...] JAX results of fn(i, jax gather of cloud i)."""
    outs = [fn(i, b["jn"][i]) for i in range(3)]
    return (np.stack([np.asarray(o.descriptors) for o in outs]),
            np.stack([np.asarray(o.valid) for o in outs]))


def _compare(got, want, **tol):
    d, v = n(got[0]), n(got[1])
    wd, wv = want
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_allclose(d[v], wd[v], **tol)


def test_spin_image_pfh_cospair_match_jax(batch):
    b = batch
    p, kp, kpm, nbr = b["p"], b["kp"], b["kpm"], b["nbr"]
    axes = n(gather_rows(t(b["nrm"]), nbr.idx[..., 0]))
    _compare(tdm.spin_image_descriptor(t(kp), t(axes), t(kpm), t(p), nbr, R),
             _jax_rows(b, lambda i, jn: jdm.spin_image_descriptor(
                 jnp.asarray(kp[i]), jnp.asarray(axes[i]),
                 jnp.asarray(kpm[i]), jnp.asarray(p[i]), jn, R)), atol=2e-4)
    small = gather_radius_neighbors(t(kp), t(p), t(b["m"]), R, 64)
    jsmall = [jgather(jnp.asarray(kp[i]), jnp.asarray(p[i]),
                      jnp.asarray(b["m"][i]), R, 64) for i in range(3)]
    outs = [jdm.pfh_descriptor(jnp.asarray(kp[i]), jnp.asarray(kpm[i]),
                               jnp.asarray(p[i]), jnp.asarray(b["nrm"][i]),
                               jsmall[i]) for i in range(3)]
    _compare(tdm.pfh_descriptor(t(kp), t(kpm), t(p), t(b["nrm"]), small),
             (np.stack([np.asarray(o.descriptors) for o in outs]),
              np.stack([np.asarray(o.valid) for o in outs])), atol=0.15)
    _compare(tcos.cospair_descriptor(t(kp), t(axes), t(kpm), t(p),
                                     t(b["nrm"]), t(b["rgb"]), nbr, R),
             _jax_rows(b, lambda i, jn: jcos.cospair_descriptor(
                 jnp.asarray(kp[i]), jnp.asarray(axes[i]),
                 jnp.zeros((len(kp[i]), 3)), jnp.asarray(kpm[i]),
                 jnp.asarray(p[i]), jnp.asarray(b["nrm"][i]),
                 jnp.asarray(b["rgb"][i]), jn, R)), atol=2e-3)


def test_shape_context_rsd_rift_match_jax(batch):
    """3DSC in the JAX LRF, RSD in both modes (its bins: the decision
    contract), RIFT over gradients computed by each side."""
    b = batch
    p, m, kp, kpm, nbr = b["p"], b["m"], b["kp"], b["kpm"], b["nbr"]
    lrfs = [jlrf(jnp.asarray(kp[i]), jnp.asarray(kpm[i]), jnp.asarray(p[i]),
                 jnp.asarray(m[i]), 0.25) for i in range(3)]
    fr = np.stack([np.asarray(x.frames) for x in lrfs])
    fv = np.stack([np.asarray(x.valid) for x in lrfs])
    _compare(tsc.shape_context_descriptor(t(kp), t(fr), t(fv), t(p), nbr, R),
             _jax_rows(b, lambda i, jn: jsc.shape_context_descriptor(
                 jnp.asarray(kp[i]), jnp.asarray(fr[i]), jnp.asarray(fv[i]),
                 jnp.asarray(p[i]), jn, R)), rtol=2e-3, atol=1e-4)
    for use_hist in (True, False):
        got = tsc.rsd_descriptor(t(kp), t(kpm), t(p), t(b["nrm"]), nbr, R,
                                 use_hist)
        want = _jax_rows(b, lambda i, jn: jsc.rsd_descriptor(
            jnp.asarray(kp[i]), jnp.asarray(kpm[i]), jnp.asarray(p[i]),
            jnp.asarray(b["nrm"][i]), jn, R, use_hist=use_hist))
        np.testing.assert_array_equal(n(got.valid), want[1])
        nn = n(gather_rows(t(b["nrm"]), nbr.idx)).astype(np.float64)
        ang = np.arccos(np.clip((nn * nn[..., :1, :]).sum(-1), -1, 1))
        use = n(nbr.valid) & (n(nbr.dist) > 1e-15)
        v = want[1]
        if use_hist:
            # the deciding values: every pair's distance and angle bins
            diff = ~np.isclose(n(got.descriptors), want[0], atol=1e-5,
                               rtol=0).all(-1) & v
            near = zc.bin_edge_near(n(nbr.dist) / R * 5, use) \
                | zc.bin_edge_near(ang / np.pi * 5, use)
            zc.report("RSD histogram rows", diff, near)
            continue
        rel = np.abs(n(got.descriptors) - want[0]) \
            / np.maximum(np.abs(want[0]), 1e-30)
        band = np.stack([zc.rsd_radius_band(n(nbr.dist[i]), ang[i],
                                            use[i], R) for i in range(3)])
        print(f"RSD (r_min, r_max): {int((rel[v] > 1e-5).sum())} of "
              f"{rel[v].size} beyond rtol 1e-5, each within its band")
        assert (rel[v] <= band[v]).all(), (rel[v] / band[v]).max()
    grads = tsc.intensity_gradients(t(p), t(b["nrm"]), t(b["rgb"].mean(-1)),
                                    t(m), R)
    jgr = np.stack([np.asarray(jsc.intensity_gradients(
        jnp.asarray(p[i]), jnp.asarray(b["nrm"][i]),
        jnp.asarray(b["rgb"][i].mean(-1)), jnp.asarray(m[i]), R))
        for i in range(3)])
    off = np.abs(n(grads) - jgr).max(-1)
    band = np.stack([zc.gradient_band(p[i], m[i], jgr[i], R)
                     for i in range(3)])
    print(f"RIFT gradients: {int((off > 1e-4 * np.abs(jgr).max()).sum())} "
          f"of {int(m.sum())} beyond 1e-4 of the largest, each within its "
          "band")
    assert (off <= band).all(), (off / band).max()
    got = tsc.rift_descriptor(t(kp), t(kpm), t(p), t(jgr), nbr, R)
    want = _jax_rows(b, lambda i, jn: jsc.rift_descriptor(
        jnp.asarray(kp[i]), jnp.asarray(kpm[i]), jnp.asarray(p[i]),
        jnp.asarray(jgr[i]), jn, R))
    np.testing.assert_array_equal(n(got.valid), want[1])
    diff = ~np.isclose(n(got.descriptors), want[0], atol=2e-4).all(-1) \
        & want[1]
    delta = (n(gather_rows(t(p), nbr.idx)) - kp[:, :, None, :]).astype(
        np.float64)
    g = n(gather_rows(t(jgr), nbr.idx)).astype(np.float64)
    cos = (delta * g).sum(-1) / np.maximum(
        np.linalg.norm(delta, axis=-1) * np.linalg.norm(g, axis=-1), 1e-30)
    zc.report("RIFT rows", diff, zc.arccos_near(cos, n(nbr.valid)))


def test_rops_and_bshot_match_jax(batch):
    """RoPS (its axis signs: the decision contract) and BSHOT: K7's plain
    twin against the JAX dense SHOT in the JAX LRF, each binarised (its
    bits: the decision contract)."""
    b = batch
    p, m, kp, kpm, nbr = b["p"], b["m"], b["kp"], b["kpm"], b["nbr"]
    got = trops.rops_descriptor(t(kp), t(kpm), t(p), nbr, R)
    want = _jax_rows(b, lambda i, jn: jrops.rops_descriptor(
        jnp.asarray(kp[i]), jnp.asarray(kpm[i]), jnp.asarray(p[i]), jn, R))
    np.testing.assert_array_equal(n(got.valid), want[1])
    diff = ~np.isclose(n(got.descriptors), want[0], atol=5e-3).all(-1) \
        & want[1]
    rel = n(gather_rows(t(p), nbr.idx)) - kp[:, :, None, :]
    near = np.stack([zc.rops_near(rel[i], n(nbr.valid[i]), n(nbr.dist[i]),
                                  R) for i in range(3)])
    zc.report("RoPS frames", diff, near)
    lrfs = [jlrf(jnp.asarray(kp[i]), jnp.asarray(kpm[i]), jnp.asarray(p[i]),
                 jnp.asarray(m[i]), 0.25) for i in range(3)]
    fr = np.stack([np.asarray(x.frames) for x in lrfs])
    fv = np.stack([np.asarray(x.valid) for x in lrfs])
    shot, valid = shot_descriptor_fused(t(kp), t(fr), t(fv), t(p),
                                        t(b["nrm"]), t(m), R)
    jres = [jshot(jnp.asarray(kp[i]), jnp.asarray(fr[i]), jnp.asarray(fv[i]),
                  jnp.asarray(p[i]), jnp.asarray(b["nrm"][i]),
                  jnp.asarray(m[i]), R) for i in range(3)]
    jsh = np.stack([np.asarray(r.descriptors) for r in jres])
    jv = np.stack([np.asarray(r.valid) for r in jres])
    np.testing.assert_array_equal(n(valid), jv)
    bits = n(tdm.bshot_binarize(shot))
    jbits = np.asarray(jdm.bshot_binarize(jnp.asarray(jsh.reshape(-1, 352))))
    differ = zc.bits_differ(bits[jv], jbits.reshape(bits.shape)[jv])
    zc.report("BSHOT groups", differ, zc.bshot_near(n(shot)[jv], jsh[jv]))
    assert set(np.unique(bits)) <= {0.0, 1.0}


def test_esf_local_matches_jax(batch):
    """ESF over each keypoint's gathered neighbourhood (ESF_LOCAL) against
    the JAX descriptor stage, and ESF of whole clouds."""
    b = batch
    p, m, kp, kpm = b["p"][:1], b["m"][:1], b["kp"][:1, :6], b["kpm"][:1, :6]
    fcfg = tfeat.FeatureConfig(type="ESF_LOCAL", radius=R)
    desc, valid, _ = tfeat.local_descriptors(
        fcfg, t(kp), t(kpm), None, t(p), t(b["nrm"][:1]), None, t(m), R)
    run = jfeat._descriptor_fn(p.shape[1], jfeat.FeatureConfig(
        type="ESF_LOCAL", radius=R))
    wd, wv, _, _ = run(jnp.asarray(kp[0]), jnp.asarray(kpm[0]),
                       jnp.asarray(p[0]), jnp.asarray(m[0]),
                       jnp.asarray(b["nrm"][0]), jnp.zeros((p.shape[1], 3)),
                       jnp.zeros((6, 3)), R, R)
    np.testing.assert_array_equal(n(valid[0]), np.asarray(wv))
    np.testing.assert_allclose(n(desc[0]), np.asarray(wd), atol=1e-3)
    got = tgd.esf_descriptor(t(b["p"]), t(b["m"]))
    for i in range(3):
        np.testing.assert_allclose(n(got[i]), np.asarray(jgd.esf_descriptor(
            jnp.asarray(b["p"][i]), jnp.asarray(b["m"][i]))), atol=1e-3)


def test_vfh_grsd_gasd_match_jax(batch):
    """VFH; GRSD (its surface classes: the decision contract); GASD with
    and without colour (its axis signs: the decision contract)."""
    b = batch
    p, m, nrm, rgb = b["p"], b["m"], b["nrm"], b["rgb"]
    vfh = tgd.vfh_descriptor(t(p), t(nrm), t(m))
    types = n(tgd.grsd_types(t(p), t(nrm), t(m), R))
    r_min, r_max, _ = (n(x) for x in tgd.rsd_radii(t(p), t(nrm), t(m), R))
    for i in range(3):
        args = (jnp.asarray(p[i]), jnp.asarray(nrm[i]), jnp.asarray(m[i]))
        np.testing.assert_allclose(n(vfh[i]), np.asarray(
            jgd.vfh_descriptor(*args)), atol=1e-3)
        jr_min, jr_max, has = jgd._rsd_radii(*args, R)
        jt = np.asarray(jnp.where(has & args[2], jgd._surface_type(
            jr_min, jr_max, R), 5))
        zc.report(f"GRSD classes, cloud {i}", types[i] != jt,
                  zc.grsd_near(r_min[i], r_max[i], R))
        want = np.asarray(jgd.grsd_descriptor(*args, R, types=jnp.asarray(
            types[i])))
        np.testing.assert_allclose(n(tgd.grsd_descriptor(
            t(p[i:i + 1]), t(nrm[i:i + 1]), t(m[i:i + 1]), R,
            types=t(types[i:i + 1])))[0], want, atol=1e-5)
    for color in (None, rgb):
        got = n(tgd.gasd_descriptor(t(p), t(m), None if color is None
                                    else t(color)))
        for i in range(3):
            want = np.asarray(jgd.gasd_descriptor(
                jnp.asarray(p[i]), jnp.asarray(m[i]),
                None if color is None else jnp.asarray(color[i])))
            differ = not np.allclose(got[i], want, atol=6e-3)
            zc.report(f"GASD frame, cloud {i}", np.array([differ]),
                      np.array([zc.gasd_near(p[i][m[i]])]))


@pytest.mark.parametrize("sgurf", [False, True])
def test_cvfh_matches_jax(batch, sgurf):
    """CVFH / OUR-CVFH of each cloud on the same normals and curvature:
    the same regions (their decisions in band counted), the rows within
    1e-3."""
    b = batch
    for i in range(3):
        live = b["m"][i]
        xyz, nrm = b["p"][i][live], b["nrm"][i][live]
        curv = np.abs(np.sin(7.0 * xyz[:, 0])).astype(np.float32) * 0.05
        kw = dict(dist_tol=0.12, min_points=40, with_sgurf=sgurf)
        want = jcvfh.cvfh_descriptors(
            xyz, nrm, curv, jnp.asarray(b["p"][i]), jnp.asarray(b["nrm"][i]),
            jnp.asarray(live), **kw)
        got = tcvfh.cvfh_descriptors(xyz, nrm, curv, t(b["p"][i]),
                                     t(b["nrm"][i]), t(live), **kw)
        near = zc.cvfh_near(xyz, nrm, curv, 0.12, np.radians(10.0), 1.0)
        print(f"cloud {i}: {len(got)} CVFH rows (JAX {len(want)}), "
              f"{near} region decisions in their band")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_narf_matches_jax(golden):
    """NARF keypoints and descriptors on the golden range image and on a
    rendered camera view (160 x 120): the same keypoints, the descriptors
    within 2e-4 but where the roll lies in its band."""
    view = kinect_data.object_view(3, 0.8, 0.7, seed=5)
    img, _ = tnarf.build_range_image(view.xyz, 160, 120, 131.25)
    jimg, _ = jnarf.build_range_image(view.xyz, 160, 120, 131.25)
    np.testing.assert_array_equal(img, jimg)
    for im, support, focal in ((golden["narf_img"], NARF_SUPPORT,
                                NARF_FOCAL), (img, 0.05, 131.25)):
        kp = tnarf.narf_keypoints(t(im), support, focal=focal)
        jkp = jnarf.narf_keypoints(jnp.asarray(im), support, focal=focal)
        np.testing.assert_array_equal(n(kp.valid), np.asarray(jkp.valid))
        v = n(kp.valid)
        assert v.sum() >= 4
        np.testing.assert_array_equal(n(kp.uv)[v], np.asarray(jkp.uv)[v])
        desc, dv = tnarf.narf_descriptor(t(im), kp, support, focal=focal)
        jd, jv = jnarf.narf_descriptor(jnp.asarray(im), jkp, support,
                                       focal=focal)
        np.testing.assert_array_equal(n(dv), np.asarray(jv))
        d, w = n(desc)[v], np.asarray(jd)[v]
        differ = ~np.isclose(d, w, atol=2e-4).all(-1)
        zc.report("NARF rolls", differ, zc.narf_near(w))
        np.testing.assert_allclose(np.sort(d, -1), np.sort(w, -1),
                                   atol=2e-4)
