"""The bench workload's data, numpy only: the .ism config that bench.py
trains (bench.py:176-198) and its clouds drawn in bench.py's order from
seed 42 -- five training clouds, one per class, then the rotated test
batch -- and the colours that the CSHOT configuration paints on them.
Shared by the port's fixture generator (tests/torch_fixtures.py),
its tests and chip_smoke.py, which must not import jax."""

import contextlib

import numpy as np

import shapes

N_POINTS = 2048
NUM_CLASSES = 5
SEED = 42
KEYPOINT_CAPACITY = 192   # bench.py's calibrated keypoint capacity

BENCH_CONFIG = {
    "ObjectConfig": {
        "Children": {
            "Clustering": {"Type": "None"},
            "Codebook": {"Children": {"ActivationStrategy": {
                "Parameters": {"K": 1}, "Type": "KNN"}}},
            "FeatureWeighting": {"Type": "Uniform"},
            "Features": {"Parameters": {
                "Radius": 0.6, "ReferenceFrameRadius": 0.5,
                "ReferenceFrameType": "SHOT"}, "Type": "SHOT"},
            "GlobalFeatures": {"Type": "Dummy"},
            "Keypoints": {"Parameters": {"LeafSize": 0.35},
                          "Type": "VoxelGrid"},
            "Voting": {"Parameters": {
                "Bandwidth": 0.5, "SingleObjectMode": True,
                "SingleObjectMaxType": "BandwidthVotes"},
                "Type": "MeanShift"},
        },
        "Parameters": {"DistanceType": "ChiSquared", "NormalRadius": 0.25,
                       "ConsistentNormalsMethod": 2,
                       "BoundingBoxType": "AABB"},
    }
}


def bench_clouds(batch: int, n: int = N_POINTS, seed: int = SEED):
    """(train_clouds [5, n, 3], train_labels [5], clouds [batch, n, 3],
    labels [batch]) in bench.py's draw order; cloud i has class i % 5."""
    rng = np.random.default_rng(seed)
    train = np.stack([shapes.make_instance(rng, c, n=n, rotate=False,
                                           noise=0.005)
                      for c in range(NUM_CLASSES)])
    clouds = np.asarray([shapes.make_instance(rng, i % NUM_CLASSES, n=n,
                                              rotate=True)
                         for i in range(batch)],
                        np.float32).reshape(batch, n, 3)
    return (train, np.arange(NUM_CLASSES), clouds,
            np.arange(batch) % NUM_CLASSES)


def bench_colors(clouds: np.ndarray) -> np.ndarray:
    """Deterministic RGB in [0, 1] for clouds [..., N, 3]: a fixed colour
    map of each point's distance from its cloud's centroid, so a rotated
    test cloud is painted like the unrotated training cloud of its class.
    Quantised to what a PCD file holds (8 bits a channel, k / 255 in f32),
    so a save_pcd / load_cloud round trip returns the same values."""
    clouds = np.asarray(clouds, np.float64)
    d = np.linalg.norm(clouds - clouds.mean(axis=-2, keepdims=True), axis=-1)
    phase = 2.0 * np.pi * d / 1.2
    rgb = np.stack([0.5 + 0.5 * np.cos(phase),
                    0.5 + 0.5 * np.cos(phase + 2.0),
                    np.clip(d / 1.5, 0.0, 1.0)], axis=-1)
    rgb8 = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint32)
    return rgb8.astype(np.float32) / np.float32(255.0)


def write_box_off(path: str, size=(1.6, 1.0, 0.6), n: int = 4) -> None:
    """Write a box of edge lengths `size`, centred at the origin, as an OFF
    mesh: each face tessellated into n x n quads of two triangles (the
    bench's box class is a box of such proportions)."""
    verts, faces = [], []
    grid = np.linspace(-0.5, 0.5, n + 1)
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (-0.5, 0.5):
            base = len(verts)
            for gu in grid:
                for gv in grid:
                    p = np.zeros(3)
                    p[axis], p[u], p[v] = side, gu, gv
                    verts.append(p * np.asarray(size))
            for i in range(n):
                for j in range(n):
                    a = base + i * (n + 1) + j
                    faces += [(a, a + 1, a + n + 2), (a, a + n + 2, a + n + 1)]
    with open(path, "w") as f:
        f.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
        f.writelines(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)


# Phase 9b's training configurations: each changes the bench training
# config (BENCH_CONFIG) in the fields named, as "Children.X" / "Parameters.X"
# paths under ObjectConfig.  The filter values are chosen for the bench
# geometry (unit-scale shapes of 2048 points): each filter removes or moves
# several percent of the points.  The rankers take configs/rgbd_kinect.ism's
# KSearch, Factor and ExtractFromList; the global descriptors' LRF radius
# reaches the points of a hollow shape from its centroid.
_RANKING = {"KSearch": 10, "Factor": 0.75, "ExtractFromList": "front"}
TRAIN_CONFIGS = {
    "mvbb": {"Parameters.BoundingBoxType": "MVBB"},
    "sor": {"Parameters.UseStatisticalOutlierRemoval": True,
            "Parameters.OutlierRemovalMeanK": 20,
            "Parameters.OutlierRemovalStddevMul": 1.0,
            "Parameters.UseVoxelFiltering": True,
            "Parameters.VoxelLeafSize": 0.03,
            "Parameters.CutoffDistanceZAxis": 0.8},
    "mls": {"Parameters.UseSmoothing": True,
            "Parameters.SmoothingRadius": 0.1},
    "normals_m3": {"Parameters.ConsistentNormalsMethod": 3},
    **{name: {"Children.FeatureWeighting": {"Type": kind,
                                            "Parameters": dict(_RANKING)}}
       for name, kind in (("naive_bayes", "NaiveBayes"),
                          ("incremental", "Incremental"),
                          ("knn_activation", "KNNActivation"),
                          ("strangeness", "Strangeness"),
                          ("similarity", "Similarity"))},
    "kmeans_count": {"Children.Clustering": {
        "Type": "KMeansCount", "Parameters": {"ClusterCount": 256}}},
    "kmeans_hartigan": {"Children.Clustering": {
        "Type": "KMeansHartigan", "Parameters": {"MaxK": 10}}},
    "cshot_global": {"Children.GlobalFeatures": {
        "Type": "CSHOT_GLOBAL", "Parameters": {"ReferenceFrameRadius": 1.0}},
        "Parameters.UseSvmTraining": True,
        "Parameters.SvmAutoTrain": True},
    "shot_global": {"Children.GlobalFeatures": {
        "Type": "SHOT_GLOBAL", "Parameters": {"ReferenceFrameRadius": 1.0}}},
    "short_shot_global": {"Children.GlobalFeatures": {
        "Type": "SHORT_SHOT_GLOBAL",
        "Parameters": {"ReferenceFrameRadius": 1.0}}},
    "cache": {"Parameters.CacheFeatures": True},
}
RANKERS = ("naive_bayes", "incremental", "knn_activation", "strangeness",
           "similarity")
GLOBALS = ("cshot_global", "shot_global", "short_shot_global")
SVM_VIEWS = 24


def train_config(name: str, base: dict = None) -> dict:
    """`base` (BENCH_CONFIG by default) changed as TRAIN_CONFIGS[name]
    says."""
    import copy
    cfg = copy.deepcopy(BENCH_CONFIG if base is None else base)
    for path, value in TRAIN_CONFIGS[name].items():
        node = cfg["ObjectConfig"]
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = copy.deepcopy(value)
    return cfg


def training_views(count: int = SVM_VIEWS, n: int = N_POINTS,
                   seed: int = 42):
    """(clouds [count, n, 3], labels [count]): rotated noisy views drawn as
    bench.py:380-416 draws its training clouds, cloud i of class i % 5."""
    rng = np.random.default_rng(seed)
    labels = np.arange(count) % NUM_CLASSES
    clouds = np.stack([shapes.make_instance(rng, int(c), n=n, rotate=True,
                                            noise=0.005) for c in labels])
    return clouds.astype(np.float32), labels


def feature_centre_distances(codebook: dict, train_clouds: np.ndarray
                             ) -> tuple:
    """(descriptors [F, D], classes [F], keypoint-to-centroid distances
    [F]) of the bench training features as the committed JAX-trained
    codebook holds them (Clustering None: the codewords are the features,
    in class-major order, each at its keypoint; one training cloud a
    class)."""
    m = codebook["cb_cw_mask"]
    cls = codebook["cb_vote_class"][m, 0]
    centroids = train_clouds.mean(axis=1)
    cdist = np.linalg.norm(codebook["cb_cw_position"][m] - centroids[cls],
                           axis=1).astype(np.float32)
    return codebook["cb_codewords"][m], cls.astype(np.int32), cdist


@contextlib.contextmanager
def seeded_kmeans(seeds: dict):
    """While open, the port's k-means of k centres starts from the
    features at seeds[k] (the JAX package's k-means++ picks, as
    tests/torch_fixtures.recorded_kmeans_seeds records them) instead of
    its own k-means++ draws."""
    import torch
    from point_cloud_donkey_tpu_torch.models import clustering
    real = clustering.kmeans_seeds

    def kmeans_seeds(x, k, metric, seed=0):
        idx = torch.from_numpy(np.asarray(seeds[k], np.int64))
        return x[idx.to(x.device)]

    clustering.kmeans_seeds = kmeans_seeds
    try:
        yield
    finally:
        clustering.kmeans_seeds = real


def split_seeds(flat: np.ndarray, ks: np.ndarray) -> dict:
    """{k: indices} from train_reference.npz's train_seeds_<name> (each
    k's indices in turn) and train_seed_ks_<name> (the k's)."""
    return dict(zip((int(k) for k in ks),
                    np.split(flat, np.cumsum(ks)[:-1])))
