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


# Phase 10's scenes: SCENE_OBJECTS bench objects a scene, each composed as
# the JAX cli/scene_composer.py composes an object (centred on its
# centroid, turned by Euler angles, moved to its place), on a row
# SCENE_SPACING apart at unit scale.
SCENE_OBJECTS = 4
SCENE_SPACING = 3.0


def _euler_to_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """scene_composer.euler_to_matrix: Rz @ Ry @ Rx."""
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rot_z @ rot_y @ rot_x


def _matrix_to_quat(rot: np.ndarray) -> np.ndarray:
    """scene_composer.matrix_to_quat: (w, x, y, z)."""
    w = np.sqrt(max(1.0 + rot[0, 0] + rot[1, 1] + rot[2, 2], 0.0)) / 2.0
    if w <= 1e-8:
        return np.array([w, 1.0, 0.0, 0.0])
    return np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w),
                     (rot[0, 2] - rot[2, 0]) / (4 * w),
                     (rot[1, 0] - rot[0, 1]) / (4 * w)])


def bench_scenes(count: int, scale: float = 1.0, n: int = N_POINTS,
                 seed: int = 7):
    """`count` scenes of SCENE_OBJECTS bench objects (n points each):
    (clouds [count, SCENE_OBJECTS * n, 3] float32, colours [count,
    SCENE_OBJECTS * n, 3] (bench_colors of each object), objects),
    objects[s] a list of (class, position [3], size [3], quat [4]) -- the
    annotation of scene_composer's 12-token lines, the box the extent of
    the turned object.  Each object is a noisy unrotated bench shape of a
    random class, turned about z by a random angle and placed on the row;
    the scene is then scaled by `scale`."""
    rng = np.random.default_rng(seed)
    clouds, colours, objects = [], [], []
    for _ in range(count):
        parts, rgbs, objs = [], [], []
        for j in range(SCENE_OBJECTS):
            cid = int(rng.integers(NUM_CLASSES))
            xyz = shapes.make_instance(rng, cid, n=n, rotate=False,
                                       noise=0.005).astype(np.float64)
            xyz -= xyz.mean(axis=0)
            rgbs.append(bench_colors(xyz))
            rot = _euler_to_matrix(0.0, 0.0, float(rng.uniform(0, 2 * np.pi)))
            pos = np.array([SCENE_SPACING * (j - (SCENE_OBJECTS - 1) / 2),
                            float(rng.uniform(-0.3, 0.3)), 0.0])
            xyz = (xyz @ rot.T + pos) * scale
            parts.append(xyz)
            objs.append((cid, (pos * scale).astype(np.float32),
                         (xyz.max(axis=0) - xyz.min(axis=0)).astype(
                             np.float32),
                         _matrix_to_quat(rot).astype(np.float32)))
        clouds.append(np.concatenate(parts))
        colours.append(np.concatenate(rgbs))
        objects.append(objs)
    return (np.asarray(clouds, np.float32), np.asarray(colours, np.float32),
            objects)


# Phase 10's detections (chip_smoke.py), whose JAX-CPU maxima
# tests/torch_fixtures.py writes to data/detect_reference.npz:
#   default:    configs/default.ism as shipped, the model trained by the JAX
#               package on DEFAULT_VIEWS coloured training views scaled by
#               0.3, on DETECT_SCENES coloured scenes scaled by 0.3;
#   quickstart: configs/quickstart.ism as shipped, the model trained on the
#               five bench training clouds scaled by 70 (millimetres), on
#               the first QUICKSTART_CLOUDS bench clouds scaled by 70;
#   hough:      the bench SHOT model (data/bench_codebook.ism) with its
#               Voting as HOUGH_VOTING says -- multi-object Hough3D with
#               interpolation, RANSAC vote filtering, the Merge filter --
#               on the same scenes at unit scale.
DETECT_SCENES = 16
DEFAULT_VIEWS = 10
QUICKSTART_CLOUDS = 32
DETECT_SCALES = {"default": 0.3, "quickstart": 70.0, "hough": 1.0}
HOUGH_VOTING = {
    "Type": "Hough3D",
    "Parameters": {"Bandwidth": 0.5, "SingleObjectMode": False,
                   "MaxFilterType": "Merge", "UseInterpolation": True,
                   "RelThreshold": 0.5, "RansacVoteFiltering": True,
                   "RansacInlierThreshold": 0.25, "MinVotesThreshold": 3},
}
# the packed columns of a maximum in detect_reference.npz
MAXIMUM_FIELDS = ("class_id", "instance_id", "position", "weight",
                  "instance_weight", "bb_size", "bb_quat", "num_votes",
                  "glob_class_id", "glob_class_weight", "glob_instance_id",
                  "glob_instance_weight")
# the packed columns of a cast vote
VOTE_FIELDS = ("position", "weight", "class_id", "instance_id", "keypoint",
               "keypoint_training", "bbox_size", "bbox_quat")


# scene seeds beside bench_scenes' 7 at which tests/detect_limits.py reads
# how far the card's detections lie from the JAX package's (the readings
# behind FIRM_RTOL and GLOBAL_RTOL_CARD; their JAX maxima and votes are
# data/detect_limits_reference.npz)
LIMIT_SEEDS = (11, 12, 13)


def detect_inputs(name: str, seed: int = 7):
    """(clouds, colours or None) of phase 10's detection `name` (the
    scenes of the default and hough detections drawn from `seed`)."""
    scale = np.float32(DETECT_SCALES[name])
    if name == "quickstart":
        _, _, clouds, _ = bench_clouds(QUICKSTART_CLOUDS)
        return clouds * scale, None
    clouds, rgb, _ = bench_scenes(DETECT_SCENES, scale=float(scale),
                                  seed=seed)
    return clouds, (rgb if name == "default" else None)


def pack_maxima(maxima_lists) -> dict:
    """{"count": [S], "<field>": the fields of every maximum, cloud after
    cloud} of per-cloud maxima lists."""
    flat = [m for ms in maxima_lists for m in ms]
    out = {"count": np.array([len(m) for m in maxima_lists], np.int32)}
    for f in MAXIMUM_FIELDS:
        out[f] = np.array([np.asarray(getattr(m, f), np.float64)
                           for m in flat])
    return out


def unpack_maxima(arrays: dict) -> list:
    """pack_maxima's inverse: per cloud, a list of {field: value}."""
    out, off = [], 0
    for c in arrays["count"]:
        out.append([{f: arrays[f][i] for f in MAXIMUM_FIELDS}
                    for i in range(off, off + int(c))])
        off += int(c)
    return out


def pack_votes(votes_list) -> dict:
    """{"count": [S], "<field>": the valid votes of every cloud} of cast
    votes with numpy fields (a `valid` field, where present, selects)."""
    out = {"count": [], **{f: [] for f in VOTE_FIELDS}}
    for v in votes_list:
        valid = np.asarray(getattr(v, "valid", None)
                           if getattr(v, "valid", None) is not None
                           else np.ones(len(v.weight), bool))
        out["count"].append(int(valid.sum()))
        for f in VOTE_FIELDS:
            out[f].append(np.asarray(getattr(v, f))[valid])
    return {k: (np.array(v, np.int32) if k == "count"
                else np.concatenate(v)) for k, v in out.items()}


def unpack_votes(arrays: dict) -> list:
    """pack_votes' inverse: per cloud, {field: array} of its votes."""
    out, off = [], 0
    for c in arrays["count"]:
        out.append({f: arrays[f][off:off + int(c)] for f in VOTE_FIELDS})
        off += int(c)
    return out


def with_voting(config: dict, voting: dict) -> dict:
    """`config` with its Voting child's type and parameters updated by
    `voting` ({"Type": ..., "Parameters": {...}})."""
    import copy
    cfg = copy.deepcopy(config)
    node = cfg["ObjectConfig"]["Children"].setdefault("Voting", {})
    if "Type" in voting:
        node["Type"] = voting["Type"]
    node.setdefault("Parameters", {}).update(voting.get("Parameters", {}))
    return cfg


# The contracts of a maximum against its reference (phase 10, and the
# port's detection tests): positions within POS_TOL x the scene's scale,
# normalised weights within WEIGHT_RTOL, box sizes within SIZE_RTOL,
# quaternions up to sign within QUAT_TOL, the global class equal and its
# (SVM) score within GLOBAL_RTOL.
POS_TOL = 1e-2
WEIGHT_RTOL = 2e-3
SIZE_RTOL = 1e-3
QUAT_TOL = 1e-3
GLOBAL_RTOL = 1e-4
# On the card a ROI's global descriptor is K8's (with K1 / K2's LRF and
# normals), which differs from the JAX-CPU dense CSHOT within the
# descriptor contract; the SVM's chi-square kernel turns that into score
# differences of a few 1e-4.  tests/detect_limits.py read, over the scenes
# of seeds 7, 11, 12, 13 (PERF.md section 6): at most 3.90e-4 with sound
# descriptors, 6.2e-4 to 1.06e-3 a seed with 2% noise on them; phase 10
# holds the global scores it verifies with card descriptors to this.
GLOBAL_RTOL_CARD = 5e-4


def _field(m, name):
    return m[name] if isinstance(m, dict) else getattr(m, name)


def maxima_mismatches(got, want, scale: float = 1.0,
                      global_rtol: float = GLOBAL_RTOL) -> list:
    """What breaks the contracts between one cloud's maxima `got` and
    `want`, both ranked by weight (an empty list when nothing does).
    Maxima whose weights agree within WEIGHT_RTOL have no rank between
    them: within such a run each maximum of `want` is matched to the
    unmatched maximum of `got` with its class and instance nearest to it.
    Each maximum is a VotingMaximum or a dict of unpack_maxima."""
    if len(got) != len(want):
        return [f"{len(got)} maxima, want {len(want)}"]
    out = []
    i = 0
    while i < len(want):
        w0 = float(_field(want[i], "weight"))
        j = i + 1
        while j < len(want) and abs(float(_field(want[j], "weight")) - w0) \
                <= WEIGHT_RTOL * abs(w0):
            j += 1
        free = list(range(i, j))
        for k in range(i, j):
            w = want[k]
            key = (int(_field(w, "class_id")), int(_field(w, "instance_id")))
            cands = [g for g in free
                     if (int(_field(got[g], "class_id")),
                         int(_field(got[g], "instance_id"))) == key]
            if not cands:
                out.append(f"rank {k}: no maximum of class/instance {key}")
                continue
            pos = np.asarray(_field(w, "position"), np.float64)
            g = min(cands, key=lambda c: np.abs(np.asarray(
                _field(got[c], "position"), np.float64) - pos).max())
            free.remove(g)
            out += [f"rank {k}: {msg}" for msg in
                    _maximum_mismatches(got[g], w, scale, global_rtol)]
        i = j
    return out


def _maximum_mismatches(g, w, scale: float, global_rtol: float) -> list:
    out = []

    def arr(m, f):
        return np.asarray(_field(m, f), np.float64)

    dp = np.abs(arr(g, "position") - arr(w, "position")).max()
    if dp > POS_TOL * scale:
        out.append(f"position off by {dp:.3g}")
    for f in ("weight", "instance_weight"):
        a, b = float(_field(g, f)), float(_field(w, f))
        if abs(a - b) > WEIGHT_RTOL * abs(b):
            out.append(f"{f} {a:.6g}, want {b:.6g}")
    if not np.allclose(arr(g, "bb_size"), arr(w, "bb_size"),
                       rtol=SIZE_RTOL, atol=1e-6 * scale):
        out.append(f"box {arr(g, 'bb_size')}, want {arr(w, 'bb_size')}")
    qg, qw = arr(g, "bb_quat"), arr(w, "bb_quat")
    if min(np.abs(qg - qw).max(), np.abs(qg + qw).max()) > QUAT_TOL:
        out.append(f"quaternion {qg}, want {qw}")
    if int(_field(g, "glob_class_id")) != int(_field(w, "glob_class_id")):
        out.append(f"global class {int(_field(g, 'glob_class_id'))}, want "
                   f"{int(_field(w, 'glob_class_id'))}")
    a, b = float(_field(g, "glob_class_weight")), \
        float(_field(w, "glob_class_weight"))
    if abs(a - b) > global_rtol * abs(b) + 1e-12:
        out.append(f"global score {a:.8g}, want {b:.8g}")
    return out


# End to end, the port's features differ from the JAX package's within the
# training contract (tests/test_torch_train.assert_codebooks_match: a
# near-tied LRF sign moves a whole descriptor), which can move a vote
# from one maximum to another.  The detection contract end to end: every
# firm maximum of the reference (normalised weight >= FIRM_WEIGHT) has a
# maximum of its class within half the bandwidth whose weight is within
# FIRM_RTOL (mean-shift) or FIRM_RTOL_HOUGH (Hough3D, whose weights are a
# bin's few votes); the single-object decision, the class of the best
# maximum, is equal where the reference's best two classes are FIRM_MARGIN
# apart.  tests/detect_limits.py read, over the scenes of seeds 7, 11, 12,
# 13 (PERF.md section 6), the largest relative weight difference: sound
# descriptors 0.0224 (default.ism, mean-shift) and 0.248 (Hough3D: a bin
# of ~4 votes losing one); 2% noise on the descriptors 0.609 and 0.366,
# and firm maxima lost at 10%.
FIRM_WEIGHT = 0.1
FIRM_RTOL = 0.1
FIRM_RTOL_HOUGH = 0.3
FIRM_MARGIN = 0.1


def firm_rtol(voting_type: str) -> float:
    """The detection contract's weight tolerance for a Voting type."""
    return FIRM_RTOL_HOUGH if voting_type == "Hough3D" else FIRM_RTOL


def firm_pairs(got, want, bandwidth: float) -> list:
    """(rank, reference maximum, the nearest maximum of `got` of its class
    within half the bandwidth, or None) of each firm reference maximum."""
    out = []
    for k, w in enumerate(want):
        if float(_field(w, "weight")) < FIRM_WEIGHT:
            continue
        pos = np.asarray(_field(w, "position"), np.float64)
        cid = int(_field(w, "class_id"))
        near = [(np.linalg.norm(np.asarray(_field(g, "position"))
                                - pos), i) for i, g in enumerate(got)
                if int(_field(g, "class_id")) == cid]
        near = [(d, i) for d, i in near if d <= bandwidth / 2]
        out.append((k, w, got[min(near)[1]] if near else None))
    return out


def firm_mismatches(got, want, bandwidth: float,
                    rtol: float = FIRM_RTOL) -> list:
    """What breaks the end-to-end detection contract (weights within
    `rtol`) between one cloud's maxima `got` and its reference `want`
    (empty when nothing does)."""
    out = []
    for k, w, g in firm_pairs(got, want, bandwidth):
        ww = float(_field(w, "weight"))
        if g is None:
            out.append(f"rank {k}: no maximum of class "
                       f"{int(_field(w, 'class_id'))} near "
                       f"{np.asarray(_field(w, 'position'))}")
        elif abs(float(_field(g, "weight")) - ww) > rtol * ww:
            out.append(f"rank {k}: weight {float(_field(g, 'weight')):.4g}, "
                       f"want {ww:.4g}")
    return out


def firm_decision(want) -> bool:
    """Whether a cloud's best class is firm in its reference maxima: its
    best maximum outweighs the best of any other class by FIRM_MARGIN."""
    if not want:
        return False
    top = int(_field(want[0], "class_id"))
    other = [float(_field(m, "weight")) for m in want
             if int(_field(m, "class_id")) != top]
    return float(_field(want[0], "weight")) - max(other, default=0.0) \
        > FIRM_MARGIN
