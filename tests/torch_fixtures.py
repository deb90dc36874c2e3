"""Generator of the port's committed fixtures (imports jax).

  point_cloud_donkey_tpu_torch/data/bench_codebook.ism (+ .ismd.npz):
      the bench codebook -- bench.py's config and five training clouds,
      trained by the JAX package on CPU;
  point_cloud_donkey_tpu_torch/data/bench_reference.npz:
      the first N_REF clouds of the bench batch, their labels, and the
      JAX-CPU ``classify_scores_batch`` scores with that codebook: dense
      normals (``scores``) and the sorted-axis normals window that
      ``ops/binned.required_window`` calibrates on these clouds
      (``normals_window``, ``scores_windowed``); and the JAX-CPU
      ``jax.vmap(detect_maxima_jit)`` densities and positions of the first
      N_DETECT clouds (``detect_densities``, ``detect_positions``);
  point_cloud_donkey_tpu_torch/data/cshot_codebook.ism (+ .ismd.npz) and
  point_cloud_donkey_tpu_torch/data/short_shot_codebook.ism (+ .ismd.npz):
      the same training with ``Features.Type`` CSHOT (the training clouds
      painted by ``bench_data.bench_colors``, read back from PCD files)
      and SHORT_SHOT;
  point_cloud_donkey_tpu_torch/data/descriptor_reference.npz:
      the colours of the first N_REF bench clouds (``rgb8``, 8-bit) and the
      JAX-CPU ``classify_scores_batch`` scores of those clouds with each of
      the two codebooks (``scores_cshot`` with those colours, also with
      the normals window of bench_reference.npz as
      ``scores_cshot_windowed``; ``scores_short_shot``), and the JAX-CPU
      ``jax.vmap(detect_maxima_jit)`` densities and positions of the first
      N_DETECT clouds with the SHORT_SHOT codebook
      (``detect_densities_short_shot``, ``detect_positions_short_shot``).
      The clouds are bench_reference.npz's;
  point_cloud_donkey_tpu_torch/data/config_reference.npz:
      the JAX-CPU ``classify_scores_batch`` scores of the same clouds under
      each configuration of CONFIGS (``scores_<name>``: the activation
      strategies KNN K=5, KNNRule, INN and Threshold, partial SHOT, the
      normals methods 0, 1 and 3, and the CSHOT codebook under method 0),
      the Threshold value (``threshold``), and the JAX-CPU
      ``jax.vmap(detect_maxima_jit)`` densities and positions of the first
      N_DETECT clouds under Threshold (``detect_densities_threshold``,
      ``detect_positions_threshold``);
  point_cloud_donkey_tpu_torch/data/train_reference.npz:
      what each training configuration of bench_data.TRAIN_CONFIGS changes,
      from the JAX package on the CPU (build_train_reference): the MVBBs of
      the five bench training clouds, the SOR + z cut-off keep masks and
      MLS positions of those clouds, each ranker's keep mask and the
      KMeansCount / KMeansHartigan seeds and centres over the committed
      bench codebook's features, the global descriptors of each *_GLOBAL
      training on the coloured bench_data.training_views (CSHOT_GLOBAL's
      with its auto-trained SVM's arrays and predictions), the codeword
      count of each configuration's training (the fused route, dense
      descriptors), the scores of the normals-method-3 codebook, and of
      the KMeansCount and KMeansHartigan trainings the features that JAX's
      k-means++ seeding picked (``train_seeds_<name>``, the indices of the
      seeds of each k of ``train_seed_ks_<name>`` in turn) and the
      codebook (``cb_<name>_<field>``).

The machine with the GPU has no JAX, so these files carry the reference
across.  tests/test_torch_fixtures.py regenerates them and checks they
match the committed ones.  Rewrite them with:

    JAX_PLATFORMS=cpu python tests/torch_fixtures.py

(``... torch_fixtures.py train`` rewrites train_reference.npz alone.)
"""

import contextlib
import copy
import os
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

from bench_data import (BENCH_CONFIG, KEYPOINT_CAPACITY,  # noqa: E402
                        NUM_CLASSES, bench_clouds, bench_colors)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "point_cloud_donkey_tpu_torch", "data")
CODEBOOK = os.path.join(DATA_DIR, "bench_codebook.ism")
REFERENCE = os.path.join(DATA_DIR, "bench_reference.npz")
# the codebook of each descriptor the port serves
CODEBOOKS = {
    "SHOT": CODEBOOK,
    "CSHOT": os.path.join(DATA_DIR, "cshot_codebook.ism"),
    "SHORT_SHOT": os.path.join(DATA_DIR, "short_shot_codebook.ism"),
}
DESCRIPTOR_REFERENCE = os.path.join(DATA_DIR, "descriptor_reference.npz")
CONFIG_REFERENCE = os.path.join(DATA_DIR, "config_reference.npz")
TRAIN_REFERENCE = os.path.join(DATA_DIR, "train_reference.npz")
N_REF = 16
N_DETECT = 32   # bench.py's MS_BATCH
# Threshold activation's distance: with the bench codebook the JAX run
# keeps a median of 17 codewords a feature and caps ~5% of the features
# at the 64 of TpuThresholdCapacity (build_config_reference prints both)
THRESHOLD = 3.8
# config_reference.npz's configurations: name -> (CodebookParams fields,
# ConsistentNormalsMethod, descriptor); every other field is the bench's
CONFIGS = {
    "knn5": ({"knn_k": 5, "use_matching_weight": True}, 2, "SHOT"),
    "knnrule": ({"activation_type": "KNNRule"}, 2, "SHOT"),
    "inn": ({"activation_type": "INN"}, 2, "SHOT"),
    "threshold": ({"activation_type": "Threshold", "threshold": THRESHOLD},
                  2, "SHOT"),
    "partial_front": ({"use_partial_shot": True,
                       "partial_shot_type": "front"}, 2, "SHOT"),
    "normals_m0": ({}, 0, "SHOT"),
    "normals_m1": ({}, 1, "SHOT"),
    "normals_m3": ({}, 3, "SHOT"),
    "cshot_m0": ({}, 0, "CSHOT"),
}


def descriptor_config(descriptor: str) -> dict:
    """bench.py's .ism config with Features.Type set to `descriptor`."""
    config = copy.deepcopy(BENCH_CONFIG)
    config["ObjectConfig"]["Children"]["Features"]["Type"] = descriptor
    return config


def jax_pipeline_config(descriptor: str = "SHOT"):
    """bench.py's JitPipelineConfig (bench.py:219-228), with `descriptor`."""
    from point_cloud_donkey_tpu.models.pipeline_jit import JitPipelineConfig
    return JitPipelineConfig(
        descriptor=descriptor, radius=0.6, ref_frame_radius=0.5, leaf_size=0.35,
        normal_radius=0.25, normals_method=2, metric="chisq", knn_k=1,
        keypoint_capacity=KEYPOINT_CAPACITY, neighbor_capacity=896,
        bandwidth=0.5, num_classes=NUM_CLASSES, fused_descriptor=True)


def build_codebook(path: str, descriptor: str = "SHOT") -> None:
    """Train the bench model with the JAX package and save it at `path`
    (+ `path`d.npz); a CSHOT model trains on the bench colours."""
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd

    ism = ImplicitShapeModel(IsmConfig.from_json(
        descriptor_config(descriptor)))
    train, labels, _, _ = bench_clouds(0)
    with tempfile.TemporaryDirectory() as tmp:
        for cid, pts in zip(labels, train):
            p = os.path.join(tmp, f"t{cid}.pcd")
            rgb = bench_colors(pts) if descriptor == "CSHOT" else None
            save_pcd(p, PointCloud(xyz=pts, rgb=rgb))
            ism.add_training_model(p, int(cid), int(cid))
        ism.train()
    ism.save(path)


def _jax_codebook(codebook_path: str):
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.codebook import TrainedCodebook
    with np.load(codebook_path + "d.npz") as z:
        return TrainedCodebook(**{k[3:]: jnp.asarray(z[k]) for k in z.files
                                  if k.startswith("cb_")})


def jax_scores(codebook_path: str, points: np.ndarray,
               mask: np.ndarray, normals_window: int = 0,
               descriptor: str = "SHOT", rgb: np.ndarray = None,
               params: dict = None, normals_method: int = 2) -> np.ndarray:
    """JAX-CPU classify_scores_batch scores [B, C] with the bench config
    (and a sorted-axis normals window when given; its exactness flag must
    hold), for `descriptor` (CSHOT reads `rgb` [B, N, 3]), with the
    CodebookParams fields `params` (default: KNN K=1) and the normals
    method."""
    import jax
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.codebook import CodebookParams
    from point_cloud_donkey_tpu.models.pipeline_jit import \
        classify_scores_batch

    cb = _jax_codebook(codebook_path)
    cfg = jax_pipeline_config(descriptor)._replace(
        normals_window=normals_window, normals_method=normals_method)
    params = CodebookParams(**{"knn_k": 1, **(params or {})})
    step = jax.jit(lambda p, m, r: classify_scores_batch(p, m, cb, cfg,
                                                         params, r))
    scores, exact = step(jnp.asarray(points), jnp.asarray(mask),
                         None if rgb is None else jnp.asarray(rgb))
    assert bool(exact), "the normals window does not cover these clouds"
    return np.asarray(scores)


def jax_window(points: np.ndarray, mask: np.ndarray) -> int:
    """bench.py's normals-window calibration (tile 256, align 128)."""
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.ops import binned
    return int(binned.required_window(jnp.asarray(points), jnp.asarray(mask),
                                      jax_pipeline_config().normal_radius,
                                      tile_q=256, align=128))


def jax_detect(codebook_path: str, points: np.ndarray, mask: np.ndarray,
               descriptor: str = "SHOT", params: dict = None,
               normals_method: int = 2):
    """JAX-CPU jax.vmap(detect_maxima_jit) with the bench config,
    `descriptor`, the CodebookParams fields `params` (default: KNN K=1) and
    the normals method: (densities [B, C], positions [B, C, 3])."""
    import jax
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.codebook import CodebookParams
    from point_cloud_donkey_tpu.models.pipeline_jit import detect_maxima_jit

    cb = _jax_codebook(codebook_path)
    cfg = jax_pipeline_config(descriptor)._replace(
        normals_method=normals_method)
    params = CodebookParams(**{"knn_k": 1, **(params or {})})
    step = jax.jit(jax.vmap(lambda p, m: detect_maxima_jit(p, m, cb, cfg,
                                                           params)))
    dens, pos = step(jnp.asarray(points), jnp.asarray(mask))
    return np.asarray(dens), np.asarray(pos)


def build_reference(codebook_path: str, path: str) -> None:
    _, _, clouds, labels = bench_clouds(max(N_REF, N_DETECT))
    mask = np.ones(clouds.shape[:2], bool)
    ref, ref_mask = clouds[:N_REF], mask[:N_REF]
    scores = jax_scores(codebook_path, ref, ref_mask)
    window = jax_window(ref, ref_mask)
    scores_w = jax_scores(codebook_path, ref, ref_mask, window)
    dens, pos = jax_detect(codebook_path, clouds[:N_DETECT],
                           mask[:N_DETECT])
    np.savez_compressed(path, points=ref,
                        labels=labels[:N_REF].astype(np.int32),
                        scores=scores.astype(np.float32),
                        normals_window=np.int32(window),
                        scores_windowed=scores_w.astype(np.float32),
                        detect_densities=dens.astype(np.float32),
                        detect_positions=pos.astype(np.float32))


def build_descriptor_reference(codebooks: dict, path: str) -> None:
    """The first N_REF bench clouds' colours and their JAX-CPU scores with
    the CSHOT and SHORT_SHOT codebooks (`codebooks`: descriptor -> path),
    CSHOT also with the calibrated normals window, and the SHORT_SHOT
    detection of the first N_DETECT clouds."""
    _, _, clouds, _ = bench_clouds(max(N_REF, N_DETECT))
    mask = np.ones(clouds.shape[:2], bool)
    ref, ref_mask = clouds[:N_REF], mask[:N_REF]
    rgb = bench_colors(ref)
    cshot = jax_scores(codebooks["CSHOT"], ref, ref_mask, descriptor="CSHOT",
                       rgb=rgb)
    cshot_w = jax_scores(codebooks["CSHOT"], ref, ref_mask,
                         jax_window(ref, ref_mask), descriptor="CSHOT",
                         rgb=rgb)
    short = jax_scores(codebooks["SHORT_SHOT"], ref, ref_mask,
                       descriptor="SHORT_SHOT")
    dens, pos = jax_detect(codebooks["SHORT_SHOT"], clouds[:N_DETECT],
                           mask[:N_DETECT], "SHORT_SHOT")
    np.savez_compressed(path, rgb8=np.round(rgb * 255).astype(np.uint8),
                        scores_cshot=cshot.astype(np.float32),
                        scores_short_shot=short.astype(np.float32),
                        scores_cshot_windowed=cshot_w.astype(np.float32),
                        detect_densities_short_shot=dens.astype(np.float32),
                        detect_positions_short_shot=pos.astype(np.float32))


def threshold_activity(codebook_path: str, points: np.ndarray,
                       mask: np.ndarray) -> tuple:
    """(median codewords kept a feature, share of the features capped at
    TpuThresholdCapacity, share of the top-64 kept) under THRESHOLD, on
    the JAX-CPU features of the clouds and the JAX chi-square matrix."""
    import jax
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.pipeline_jit import \
        extract_features_jit
    from point_cloud_donkey_tpu.ops.neighbors import \
        chi_square_distance_matrix
    cb = _jax_codebook(codebook_path)
    cfg = jax_pipeline_config()
    _, _, desc, valid = jax.jit(jax.vmap(
        lambda p, m: extract_features_jit(p, m, cfg)))(jnp.asarray(points),
                                                        jnp.asarray(mask))
    desc = np.asarray(desc)[np.asarray(valid)]
    d = np.asarray(chi_square_distance_matrix(jnp.asarray(desc),
                                              cb.codewords))
    within = (d < THRESHOLD).sum(1)
    kept = np.minimum(within, 64)
    return (float(np.median(kept)), float((within >= 64).mean()),
            float(kept.sum() / (64 * len(kept))))


def config_scores(name: str) -> np.ndarray:
    """The JAX-CPU scores of the first N_REF bench clouds under CONFIGS[name]
    (CSHOT with bench_colors)."""
    params, method, descriptor = CONFIGS[name]
    _, _, clouds, _ = bench_clouds(N_REF)
    mask = np.ones(clouds.shape[:2], bool)
    return jax_scores(
        CODEBOOKS[descriptor], clouds, mask, descriptor=descriptor,
        rgb=bench_colors(clouds) if descriptor == "CSHOT" else None,
        params=params, normals_method=method).astype(np.float32)


def threshold_detection():
    """The JAX-CPU detection of the first N_DETECT bench clouds under
    Threshold: (densities, positions)."""
    _, _, clouds, _ = bench_clouds(max(N_REF, N_DETECT))
    dens, pos = jax_detect(CODEBOOK, clouds[:N_DETECT],
                           np.ones((N_DETECT, clouds.shape[1]), bool),
                           params=CONFIGS["threshold"][0])
    return dens.astype(np.float32), pos.astype(np.float32)


def build_config_reference(path: str) -> None:
    """config_reference.npz: config_scores of every configuration, the
    Threshold value and threshold_detection."""
    out = {"threshold": np.float32(THRESHOLD)}
    for name in CONFIGS:
        out["scores_" + name] = config_scores(name)
    (out["detect_densities_threshold"],
     out["detect_positions_threshold"]) = threshold_detection()
    np.savez_compressed(path, **out)


def jax_train_config(name: str, files, rgb_files=None):
    """The JAX package's training of bench_data.train_config(name) on the
    files [(path, class)], on its fused route with dense descriptors (the
    formulation the port computes)."""
    from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
    from point_cloud_donkey_tpu.utils.config import IsmConfig
    from bench_data import train_config
    old = {k: os.environ.get(k) for k in ("PCD_TRAIN_FUSED", "PCD_DENSE_DESC")}
    os.environ.update(PCD_TRAIN_FUSED="1", PCD_DENSE_DESC="1")
    try:
        ism = ImplicitShapeModel(IsmConfig.from_json(train_config(name)))
        for path, cid in (rgb_files or files):
            ism.add_training_model(path, cid, cid)
        ism.train()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ism


@contextlib.contextmanager
def recorded_kmeans_seeds():
    """While open, the JAX package's clustering.kmeans records in the dict
    it yields, for each k it runs, the indices of the features that its
    k-means++ seeding picks (the rows of ``kmeans(..., iterations=0)``):
    bench_data.seeded_kmeans starts the port's k-means from the same
    features."""
    from point_cloud_donkey_tpu.models import clustering
    real = clustering.kmeans
    seeds = {}

    def kmeans(descriptors, k, metric, iterations=100, seed=0):
        x = np.asarray(descriptors)
        rows = real(x, k, metric, iterations=0, seed=seed)[0]
        seeds[len(rows)] = np.array(
            [np.flatnonzero((x == r).all(1))[0] for r in rows], np.int32)
        return real(descriptors, k, metric, iterations, seed)

    clustering.kmeans = kmeans
    try:
        yield seeds
    finally:
        clustering.kmeans = real


KMEANS_TRAININGS = ("kmeans_count", "kmeans_hartigan")
# the codebook fields train_reference.npz holds of each k-means training
KMEANS_FIELDS = ("codewords", "cw_mask", "vote_mask", "vote_class",
                 "vote_instance", "class_sigma")


def build_train_reference(path: str) -> None:
    """train_reference.npz (module docstring)."""
    import jax.numpy as jnp
    from point_cloud_donkey_tpu.models.clustering import (ClusteringParams,
                                                          kmeans,
                                                          run_clustering)
    from point_cloud_donkey_tpu.models.features import pad_cloud
    from point_cloud_donkey_tpu.models.ism import _mvbb_host_batch
    from point_cloud_donkey_tpu.models.ranking import (RankingParams,
                                                       rank_features)
    from point_cloud_donkey_tpu.ops import preprocess as pp
    from point_cloud_donkey_tpu.utils.config import ComponentConfig
    from point_cloud_donkey_tpu.utils.io import PointCloud, save_pcd
    from bench_data import (GLOBALS, RANKERS, TRAIN_CONFIGS,
                            feature_centre_distances, train_config,
                            training_views)
    out = {}
    train, labels, _, _ = bench_clouds(0)
    boxes = _mvbb_host_batch(list(train))
    for key in ("position", "size", "quat"):
        out["mvbb_" + key] = np.stack([getattr(b, key) for b in boxes])
    sor = TRAIN_CONFIGS["sor"]
    mls = TRAIN_CONFIGS["mls"]
    keeps, moved = [], []
    for pts in train:
        p, m = pad_cloud(pts)
        p, m = jnp.asarray(p), jnp.asarray(m)
        k = pp.statistical_outlier_removal(
            p, m, sor["Parameters.OutlierRemovalMeanK"],
            sor["Parameters.OutlierRemovalStddevMul"])
        keeps.append(np.asarray(pp.z_cutoff(
            p, k, sor["Parameters.CutoffDistanceZAxis"]))[:len(pts)])
        moved.append(np.asarray(pp.mls_smooth(
            p, m, mls["Parameters.SmoothingRadius"]))[:len(pts)])
    out["sor_keep"] = np.stack(keeps)
    out["mls_xyz"] = np.stack(moved).astype(np.float32)

    with np.load(CODEBOOK + "d.npz") as z:
        desc, cls, cdist = feature_centre_distances(dict(z), train)
    for name in RANKERS:
        cfg = train_config(name)["ObjectConfig"]["Children"][
            "FeatureWeighting"]
        params = RankingParams.from_config(ComponentConfig.from_json(cfg),
                                           flann_exact=True)
        out["rank_" + name] = rank_features(desc, cls, cdist, params)
    count = ClusteringParams.from_config(ComponentConfig.from_json(
        TRAIN_CONFIGS["kmeans_count"]["Children.Clustering"])).cluster_count
    out["kmeans_seeds"] = kmeans(desc, count, "chisq", iterations=0)[0]
    out["kmeans_centers"], out["kmeans_assign"] = kmeans(desc, count,
                                                         "chisq")
    max_k = TRAIN_CONFIGS["kmeans_hartigan"]["Children.Clustering"][
        "Parameters"]["MaxK"]
    out["hartigan_seeds"] = np.concatenate(
        [kmeans(desc, k, "chisq", iterations=0)[0]
         for k in range(1, max_k + 1)])
    out["hartigan_centers"], out["hartigan_assign"] = run_clustering(
        desc, ClusteringParams(type="KMeansHartigan", max_k=max_k), "chisq")
    views, view_labels = training_views()
    with tempfile.TemporaryDirectory() as tmp:
        files, view_files = [], []
        for cid, pts in zip(labels, train):
            p = os.path.join(tmp, f"t{cid}.pcd")
            save_pcd(p, PointCloud(xyz=pts))
            files.append((p, int(cid)))
        for i, (pts, cid) in enumerate(zip(views, view_labels)):
            p = os.path.join(tmp, f"v{i}.pcd")
            save_pcd(p, PointCloud(xyz=pts, rgb=bench_colors(pts)))
            view_files.append((p, int(cid)))
        for name in TRAIN_CONFIGS:
            if name == "cache":
                continue
            with recorded_kmeans_seeds() as seeds:
                ism = jax_train_config(name, view_files if name in GLOBALS
                                       else files)
            if name in KMEANS_TRAININGS:
                out["train_seed_ks_" + name] = np.array(sorted(seeds),
                                                         np.int32)
                out["train_seeds_" + name] = np.concatenate(
                    [seeds[k] for k in sorted(seeds)])
                cb = ism.state.codebook
                for field in KMEANS_FIELDS:
                    out[f"cb_{name}_{field}"] = np.asarray(getattr(cb, field))
            out["count_" + name] = np.int32(
                np.asarray(ism.state.codebook.cw_mask).sum())
            if name in GLOBALS:
                out["glob_" + name] = ism.state.global_descriptors
                out["glob_cls_" + name] = ism.state.global_classes
            if ism.state.svm is not None:
                svm = ism.state.svm
                out["svm_pred"] = np.array(
                    [svm.predict(d)[0] for d in ism.state.global_descriptors],
                    np.int32)
                out.update({"ref_" + k: v for k, v in svm.to_arrays().items()})
            if name == "normals_m3":
                cb = os.path.join(tmp, "m3.ism")
                ism.save(cb)
                _, _, clouds, _ = bench_clouds(N_REF)
                out["scores_normals_m3"] = jax_scores(
                    cb, clouds, np.ones(clouds.shape[:2], bool),
                    normals_method=3).astype(np.float32)
    np.savez_compressed(path, **out)


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DATA_DIR, exist_ok=True)
    if sys.argv[1:] == ["train"]:
        build_train_reference(TRAIN_REFERENCE)
        print(f"wrote {TRAIN_REFERENCE}")
        return
    for descriptor, path in CODEBOOKS.items():
        build_codebook(path, descriptor)
    build_reference(CODEBOOK, REFERENCE)
    build_descriptor_reference(CODEBOOKS, DESCRIPTOR_REFERENCE)
    build_config_reference(CONFIG_REFERENCE)
    build_train_reference(TRAIN_REFERENCE)
    _, _, clouds, _ = bench_clouds(N_REF)
    median, capped, share = threshold_activity(
        CODEBOOK, clouds, np.ones(clouds.shape[:2], bool))
    print(f"Threshold {THRESHOLD}: a median of {median:.0f} codewords kept "
          f"a feature, {100 * capped:.1f}% of the features capped at 64, "
          f"{100 * share:.1f}% of the 64 nearest kept")
    print(f"wrote {', '.join(CODEBOOKS.values())} (+ d.npz), {REFERENCE}, "
          f"{DESCRIPTOR_REFERENCE}, {CONFIG_REFERENCE} and {TRAIN_REFERENCE}")


if __name__ == "__main__":
    main()
