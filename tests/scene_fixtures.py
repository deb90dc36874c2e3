"""Generator of the port's scene-scale fixtures (imports jax):

  point_cloud_donkey_tpu_torch/data/kinect_model.ism (+ .ismd.npz):
      configs/rgbd_kinect.ism as shipped, trained by the JAX package on
      the CPU (its fused route, dense descriptors) on the coloured views
      of tests/kinect_data.training_views -- three views of each object
      and one view of the box on the table above the scene threshold,
      which the JAX package trains on its scene route;
  point_cloud_donkey_tpu_torch/data/scene_reference.npz:
      what chip_smoke.py's phase 11 holds the card to, from the JAX
      package on the CPU with dense descriptors (PCD_DENSE_DESC=1):
        * ``frame_hash``: kinect_data.frame_hash of each FRAME_SEEDS frame;
        * 11a, each frame ``a_<seed>_*``: the detection's maxima with the
          kinect model (``max_*``, bench_data.pack_maxima), the scene
          features' keypoints (``kp``), the descriptors and frames of every
          DESC_STRIDE-th feature (``desc``, ``frames``), and the same of a
          control run whose normals take NORMALS_CHUNK / 2 queries a chunk
          (``ctl_max_*``, ``ctl_desc``, ``ctl_frames``): the JAX package
          against itself under an equally exact tiling, the spread phase
          11 reads its limits from;
        * 11b ``b_*``: configs/default.ism's model with
          kinect_data.FILTER_PARAMS on the coloured filter scenes: the
          preprocessed sizes (``size``) and coordinate sums (``xyz_sum``),
          and the detection's maxima (``max_*``);
        * 11c ``c_*``: KINECT_CULLING on the first frame sorted along its
          longest axis, with the JAX scene normals (``normals``): the
          voxel keypoints (``voxel``), their culling scores (``geo``,
          ``col``) and the culled keypoints (``kp``, refined); and for each BENCH_CULLING
          configuration ``c_<name>_*`` the batched extraction's feature
          positions of the first CULL_CLOUDS bench clouds (``pos``,
          ``count``) and each cloud's voxel keypoints' geometry scores
          (``geo``, ``geo_count``);
        * 11e ``e_ctl_cos``: the cosine of each codeword of a control
          training (each view's points reversed and moved by an ulp) with
          the committed model's: the JAX package against itself;
        * 11f ``f_*``: the bench SHOT model with Hough3D, RANSAC and Merge
          on the first filter scene at unit scale (``max_*``).

    JAX_PLATFORMS=cpu python tests/scene_fixtures.py [model] [reference]
    (~35 min; ``frames``, ``filters``, ``culling``, ``hough`` or
    ``control`` in place of ``reference`` recompute those parts alone
    into the committed file)
"""

import json
import os
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import kinect_data as kd  # noqa: E402
from bench_data import (HOUGH_VOTING, bench_clouds, bench_scenes,  # noqa
                        pack_maxima, with_voting)
from torch_fixtures import (CODEBOOK, DATA_DIR, DETECT_MODELS,  # noqa: E402
                            dense_descriptors, shipped_config)

KINECT_MODEL = os.path.join(DATA_DIR, "kinect_model.ism")
SCENE_REFERENCE = os.path.join(DATA_DIR, "scene_reference.npz")
DESC_STRIDE = 100


def write_views(tmp: str):
    """The training views as coloured PCD files: [(path, class)]."""
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
    files = []
    for i, (view, cid) in enumerate(kd.training_views()):
        path = os.path.join(tmp, f"view{i}.pcd")
        save_pcd(path, PointCloud(xyz=view.xyz, rgb=view.rgb))
        files.append((path, cid))
    return files


def build_kinect_model(path: str) -> None:
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    with tempfile.TemporaryDirectory() as tmp, dense_descriptors():
        ism = ImplicitShapeModel(IsmConfig.from_json(
            shipped_config("rgbd_kinect")))
        for f, cid in write_views(tmp):
            ism.add_training_model(f, cid, cid)
        ism.train()
        ism.save(path)
    print(f"kinect model: {ism.state.codebook.codewords.shape[0]} codewords")


def _jax_model(path: str, config: dict = None):
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    ism = ImplicitShapeModel.load(path)
    if config is not None:
        ism.config = IsmConfig.from_json(config)
    return ism


def _model_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def frame_features(frame, config: dict):
    """The JAX scene features of a frame under `config` (dense
    descriptors)."""
    from point_cloud_donkey_tpu.models import features as jf
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    cfg = IsmConfig.from_json(config)
    with dense_descriptors():
        return jf.extract_local_features(
            frame.xyz, None,
            jf.FeatureConfig.from_config(cfg.child("Features")),
            cfg.child("Keypoints"), cfg.root.get("NormalRadius", 0.05),
            cfg.root.get("ConsistentNormalsMethod", 2), frame.rgb)


def _detect(ism, clouds, rgbs=None):
    with dense_descriptors():
        return [ism.detect(c, None, None if rgbs is None else rgbs[i])[0]
                for i, c in enumerate(clouds)]


def _put(out, prefix, maxima):
    for k, v in pack_maxima(maxima).items():
        out[f"{prefix}max_{k}"] = v


def reference_frames(out: dict) -> None:
    """11a: the frames' detections, features and the control run."""
    from point_cloud_donkey_tpu.ops import tiled as jt
    frames = [kd.kinect_frame(s) for s in kd.FRAME_SEEDS]
    out["frame_hash"] = np.array([kd.frame_hash(f) for f in frames])
    config = _model_config(KINECT_MODEL)
    chunk = jt.NORMALS_CHUNK
    for s, f in zip(kd.FRAME_SEEDS, frames):
        for pre, nchunk in ((f"a_{s}_", chunk), (f"a_{s}_ctl_", chunk // 2)):
            jt.NORMALS_CHUNK = nchunk
            try:
                fs = frame_features(f, config)
                _put(out, pre, _detect(_jax_model(KINECT_MODEL), [f.xyz],
                                       [f.rgb]))
            finally:
                jt.NORMALS_CHUNK = chunk
            if not pre.endswith("ctl_"):
                out[pre + "kp"] = fs.positions.astype(np.float32)
            out[pre + "desc"] = fs.descriptors[::DESC_STRIDE]
            out[pre + "frames"] = fs.frames[::DESC_STRIDE]
            print(f"frame {s} ({pre}): {len(f.xyz)} points, "
                  f"{len(fs.positions)} features, "
                  f"{len(out[pre + 'max_weight'])} maxima", flush=True)


def reference_filters(out: dict) -> None:
    """11b: default.ism with the filters on the filter scenes."""
    from point_cloud_donkey_tpu.models.ism import preprocess_cloud
    from point_cloud_donkey_tpu.utils.io import PointCloud
    clouds, rgbs, _ = bench_scenes(kd.FILTER_SCENES, scale=kd.FILTER_SCALE,
                                   n=kd.FILTER_POINTS, seed=kd.FILTER_SEED)
    config = kd.with_params(_model_config(DETECT_MODELS["default"]),
                            kd.FILTER_PARAMS)
    ism = _jax_model(DETECT_MODELS["default"], config)
    pre = [preprocess_cloud(PointCloud(xyz=c, rgb=r), ism.config.root)
           for c, r in zip(clouds, rgbs)]
    out["b_size"] = np.array([len(p.xyz) for p in pre])
    out["b_xyz_sum"] = np.array([p.xyz.astype(np.float64).sum(0)
                                 for p in pre])
    with dense_descriptors():
        res = ism.detect_batch([p.xyz for p in pre], None,
                               [p.rgb for p in pre])
    _put(out, "b_", [m for m, _ in res])
    print(f"filters: sizes {out['b_size']} of {clouds.shape[1]}, "
          f"{len(out['b_max_weight'])} maxima", flush=True)


def _jax_voxel_keypoints(xyz, nrm, rgb, leaf):
    """(keypoints, voxel-averaged normals, colours) of the JAX per-cloud
    voxel program, as its detect_keypoints computes them."""
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models import keypoints as jk
    from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid
    kp, kp_rgb = jk.detect_keypoints(xyz, nrm, rgb, jk.KeypointParams(
        leaf_size=leaf), return_colors=True)
    vg = voxel_grid(jnp.asarray(xyz), jnp.ones(len(xyz), bool), leaf,
                    features=jnp.asarray(np.concatenate([nrm, rgb], 1)))
    kn = np.asarray(vg.centroids)[np.asarray(vg.mask)][:, 3:6]
    return kp, kn, kp_rgb


def reference_culling(out: dict) -> None:
    """11c: the frame's tiled culling on JAX's normals, and the batched
    culling of the bench clouds."""
    from point_cloud_donkey_tpu.models import features as jf
    from point_cloud_donkey_tpu.models import keypoints as jk
    from point_cloud_donkey_tpu.models.detect_batch import \
        extract_local_features_batch
    from point_cloud_donkey_tpu.ops import tiled as jt
    from point_cloud_donkey_tpu.ops.voxel_grid import voxel_grid
    from point_cloud_donkey_tpu.utils.config import ComponentConfig
    import jax.numpy as jnp
    f = kd.kinect_frame(kd.FRAME_SEEDS[0])
    axis = jt.sort_key_axis(f.xyz)
    order = np.argsort(f.xyz[:, axis], kind="stable")
    xyz, rgb = f.xyz[order], f.rgb[order]
    cfg = shipped_config("rgbd_kinect")["ObjectConfig"]["Parameters"]
    nrm = jf.compute_cloud_normals(xyz, None, cfg["NormalRadius"],
                                   cfg["ConsistentNormalsMethod"])
    params = jk.KeypointParams.from_config(
        ComponentConfig.from_json(kd.KINECT_CULLING))
    kp_all, kn, kp_rgb = _jax_voxel_keypoints(xyz, nrm, rgb,
                                              params.leaf_size)
    geo, col = jk._tiled_culling_scores(
        kp_all, kn, kp_rgb, xyz, nrm, rgb, "kpq", "colordistance",
        params.leaf_size, params.max_similar_color_distance)
    kp = jk.detect_keypoints(xyz, nrm, rgb, params)
    out.update(c_normals=nrm.astype(np.float32), c_geo=geo, c_col=col,
               c_voxel=kp_all.astype(np.float32),
               c_kp=kp.astype(np.float32))
    print(f"frame culling: {len(kp)} of {len(kp_all)} keypoints kept",
          flush=True)
    _, _, clouds, _ = bench_clouds(kd.CULL_CLOUDS)
    base = _model_config(CODEBOOK)
    for name, node in kd.BENCH_CULLING.items():
        config = kd.with_child(base, "Keypoints", node)
        ism = _jax_model(CODEBOOK, config)
        root = ism.config.root
        kcfg = ism.config.child("Keypoints")
        with dense_descriptors():
            fss = extract_local_features_batch(
                list(clouds), [None] * len(clouds), [None] * len(clouds),
                jf.FeatureConfig.from_config(ism.config.child("Features")),
                kcfg, root.get("NormalRadius", 0.05),
                root.get("ConsistentNormalsMethod", 2))
        out[f"c_{name}_pos"] = np.concatenate([fs.positions for fs in fss])
        out[f"c_{name}_count"] = np.array([len(fs.positions) for fs in fss])
        kp_params = jk.KeypointParams.from_config(kcfg)
        geos = []
        for c in clouds:
            n_c = jf.compute_cloud_normals(c, None, root.get("NormalRadius",
                                                             0.05),
                                           root.get("ConsistentNormalsMethod",
                                                    2))
            vk = voxel_grid(jnp.asarray(c), jnp.ones(len(c), bool),
                            kp_params.leaf_size,
                            features=jnp.asarray(n_c))
            full = np.asarray(vk.centroids)[np.asarray(vk.mask)]
            m = len(full)
            g, _ = jk._culling_program(
                len(c), m, kp_params.filter_method_geometry.lower(), "none",
                float(kp_params.leaf_size), 0.01)(
                    jnp.asarray(full[:, :3]), jnp.ones(m, bool),
                    jnp.asarray(full[:, 3:6]), jnp.zeros((m, 3)),
                    jnp.asarray(c), jnp.ones(len(c), bool), jnp.asarray(n_c),
                    jnp.zeros((len(c), 3)))
            geos.append(np.asarray(g))
        out[f"c_{name}_geo"] = np.concatenate(geos)
        out[f"c_{name}_geo_count"] = np.array([len(g) for g in geos])
        print(f"bench culling {name}: {out[f'c_{name}_count'].sum()} "
              f"features of {out[f'c_{name}_geo_count'].sum()} voxel "
              f"keypoints", flush=True)


def reference_hough(out: dict) -> None:
    """11f's Hough3D scene."""
    clouds, _, _ = bench_scenes(1, scale=1.0, n=kd.FILTER_POINTS,
                                seed=kd.FILTER_SEED)
    ism = _jax_model(CODEBOOK, with_voting(_model_config(CODEBOOK),
                                           HOUGH_VOTING))
    _put(out, "f_", _detect(ism, [clouds[0]]))
    print(f"hough scene: {len(out['f_max_weight'])} maxima", flush=True)


def ulp_moved(xyz: np.ndarray, leaf: float, seed: int = 0) -> np.ndarray:
    """xyz with each float32 coordinate moved by one ulp up or down at
    random -- every input at the rounding any other float implementation
    makes -- but for the points that the move would carry into another
    voxel of `leaf`, which stay, so the voxel keypoints are the same set."""
    rng = np.random.default_rng(seed)
    xyz = np.asarray(xyz, np.float32)
    moved = np.nextafter(xyz, np.where(rng.random(xyz.shape) < 0.5, -np.inf,
                                       np.inf).astype(np.float32))
    lf = np.float32(leaf)
    cross = (np.floor(moved / lf) != np.floor(xyz / lf)).any(1)
    moved[cross] = xyz[cross]
    return moved


def reference_training_control(out: dict) -> None:
    """11e's control: the JAX package's training of the kinect model on the
    same views with each view's points in reverse order and each
    coordinate moved by one ulp (:func:`ulp_moved`): the cosine of each of
    its codewords with the committed model's (``e_ctl_cos``)."""
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
    config = shipped_config("rgbd_kinect")
    leaf = config["ObjectConfig"]["Children"]["Keypoints"]["Parameters"][
        "LeafSize"]
    with tempfile.TemporaryDirectory() as tmp, dense_descriptors():
        ism = ImplicitShapeModel(IsmConfig.from_json(config))
        for i, (view, cid) in enumerate(kd.training_views()):
            path = os.path.join(tmp, f"view{i}.pcd")
            xyz = ulp_moved(view.xyz, leaf, seed=i)
            save_pcd(path, PointCloud(xyz=xyz[::-1], rgb=view.rgb[::-1]))
            ism.add_training_model(path, cid, cid)
        ism.train()
    a = np.asarray(ism.state.codebook.codewords)
    with np.load(KINECT_MODEL + "d.npz") as z:
        b = z["cb_codewords"]
    assert a.shape == b.shape, (a.shape, b.shape)
    out["e_ctl_cos"] = ((a * b).sum(1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1),
        1e-30)).astype(np.float32)
    print(f"training control: cosine > 0.999 on "
          f"{100 * (out['e_ctl_cos'] > 0.999).mean():.1f}% of the "
          f"codewords", flush=True)


def reference_culling_control(out: dict) -> None:
    """11c's control: the frame's tiled culling (as reference_culling)
    with every coordinate moved by one ulp (:func:`ulp_moved`), on the
    same normals: its voxel keypoints' scores (``c_ctl_geo``,
    ``c_ctl_col``) and its culled keypoints (``c_ctl_kp``) -- the JAX
    package against itself at the rounding of another implementation."""
    from point_cloud_donkey_tpu.models import keypoints as jk
    from point_cloud_donkey_tpu.ops import tiled as jt
    from point_cloud_donkey_tpu.utils.config import ComponentConfig
    f = kd.kinect_frame(kd.FRAME_SEEDS[0])
    axis = jt.sort_key_axis(f.xyz)
    order = np.argsort(f.xyz[:, axis], kind="stable")
    rgb = f.rgb[order]
    params = jk.KeypointParams.from_config(
        ComponentConfig.from_json(kd.KINECT_CULLING))
    xyz = ulp_moved(f.xyz[order], params.leaf_size)
    nrm = out["c_normals"]
    kp, kn, kr = _jax_voxel_keypoints(xyz, nrm, rgb, params.leaf_size)
    geo, col = jk._tiled_culling_scores(
        kp, kn, kr, xyz, nrm, rgb, "kpq", "colordistance",
        params.leaf_size, params.max_similar_color_distance)
    assert len(kp) == len(out["c_voxel"])
    out.update(c_ctl_geo=geo, c_ctl_col=col, c_ctl_kp=jk.apply_culling_host(
        kp, kr, geo, col, params).astype(np.float32))
    print(f"culling control: {len(out['c_ctl_kp'])} kept", flush=True)


def reference_filter_masks(out: dict) -> None:
    """11b's per-point decisions: each filter scene sorted along its
    longest axis as configs/default.ism's preprocessing with
    kinect_data.FILTER_PARAMS sorts it, the JAX masks after the tiled SOR
    (``b_<i>_sor``) and after ROR (``b_<i>_ror``), packed bits, and the
    kept points after MLS (``b_<i>_xyz``): the steps of the JAX
    preprocess_cloud's scene branch, whose sizes and sums they reproduce
    (``b_size``, ``b_xyz_sum``)."""
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.features import pad_cloud
    from point_cloud_donkey_tpu.ops import tiled as tl
    clouds, _, _ = bench_scenes(kd.FILTER_SCENES, scale=kd.FILTER_SCALE,
                                n=kd.FILTER_POINTS, seed=kd.FILTER_SEED)
    root = kd.with_params(_model_config(DETECT_MODELS["default"]),
                          kd.FILTER_PARAMS)["ObjectConfig"]["Parameters"]
    for i, xyz in enumerate(clouds):
        axis = tl.sort_key_axis(xyz)
        xyz = xyz[np.argsort(xyz[:, axis], kind="stable")]
        pts, mask = pad_cloud(xyz)
        key = pts[:, axis]
        n = len(xyz)
        plan = tl.plan_tiles(key, mask, key, 0.0, tl.NORMALS_CHUNK,
                             min_window=4096)
        sor = tl.tiled_statistical_outlier_removal(
            jnp.asarray(pts), jnp.asarray(mask), plan,
            root.get("OutlierRemovalMeanK", 20),
            root.get("OutlierRemovalStddevMul", 2.0))
        r = root.get("OutlierRemovalRadius", 0.005)
        ror = tl.tiled_radius_outlier_removal(
            jnp.asarray(pts), sor, tl.plan_tiles(key, mask, key, r,
                                                 tl.NORMALS_CHUNK), r,
            root.get("OutlierRemovalMinNeighbors", 10))
        r = root.get("SmoothingRadius", 0.01)
        mls = tl.tiled_mls_smooth(jnp.asarray(pts), ror, tl.plan_tiles(
            key, mask, key, r, tl.NORMALS_CHUNK), r)
        keep = np.asarray(ror)[:n]
        kept = np.asarray(mls)[:n][keep].astype(np.float32)
        assert len(kept) == out["b_size"][i] and np.allclose(
            kept.astype(np.float64).sum(0), out["b_xyz_sum"][i])
        out[f"b_{i}_sor"] = np.packbits(np.asarray(sor)[:n])
        out[f"b_{i}_ror"] = np.packbits(keep)
        out[f"b_{i}_xyz"] = kept
        print(f"filter scene {i}: SOR kept {int(np.asarray(sor)[:n].sum())}"
              f", ROR {len(kept)} of {n}", flush=True)


PARTS = {"frames": reference_frames, "filters": reference_filters,
         "filter_masks": reference_filter_masks,
         "culling": reference_culling,
         "culling_control": reference_culling_control,
         "hough": reference_hough, "control": reference_training_control}


def build_scene_reference(path: str, parts=tuple(PARTS)) -> None:
    """Write scene_reference.npz; with `parts` a subset of PARTS, recompute
    those parts into the committed file and keep the rest."""
    out = {}
    if set(parts) != set(PARTS):
        with np.load(path) as z:
            out = dict(z)
    for name in parts:
        PARTS[name](out)
    np.savez_compressed(path, **out)


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    what = sys.argv[1:] or ["model", "reference"]
    if "model" in what:
        build_kinect_model(KINECT_MODEL)
        print(f"wrote {KINECT_MODEL}")
    parts = tuple(PARTS) if "reference" in what else \
        tuple(p for p in what if p in PARTS)
    if parts:
        build_scene_reference(SCENE_REFERENCE, parts)
        print(f"wrote {SCENE_REFERENCE}")


if __name__ == "__main__":
    main()
