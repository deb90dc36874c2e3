"""The Implicit Shape Model orchestrator: training, detection and model
files (port of point_cloud_donkey_tpu/models/ism.py).

train() (implicit_shape_model.cpp:252-500), in MODEL_CHUNK-file slices:
  1. load each file (NaN rows dropped), preprocess it
     (:func:`preprocess_cloud`), crop it to its box if it was added with
     one (crops under 500 points are skipped), its radius, and its box:
     the one it was added with, the AABB, or the MVBB
     (ops/geometry.compute_mvbb_batch, one batch per slice);
  2. local features (models/detect_batch.py: the fused route, or its
     staged normals for files with normals and ConsistentNormalsMethod
     3), read from or written to the feature cache under CacheFeatures;
  3. global features (models/features.extract_global_features);
then, over every model: feature ranking (models/ranking.py), clustering
(models/clustering.py), the codebook activation (models/codebook.py) on
the device -- over the descriptors the extraction left there when the
codewords are the kept features, else over the uploaded centres --
per-class mean radius and box median, and the SVM on the global
descriptors (models/svm.py).  Stage wall times go to
``processing_times`` under the JAX package's ``train_*`` keys.

What neither route trains raises NotImplementedError with the reason and
the queue that ports it, before any cloud is read (the descriptors, LRFs
and whole-cloud global descriptors still to port, several devices).  A cloud
above ops.tiled.SCENE_TILE_THRESHOLD points takes the scene routes of the
filters and the features (ops/tiled.py), decided per cloud.

detect_batch() (implicit_shape_model.cpp:583-712), for a list of clouds:
  1. local features on the batched extraction's route
     (models/detect_batch.extract_local_features_batch: the clouds up to
     the threshold in chunks, each scene on its scene route, culled
     where VoxelGridCulling culls), the descriptors left on the device;
     then, per extraction chunk, one cast_votes over
     the chunk's features (the codebook's activation and votes) and one
     read of the votes;
  2. the mean-shift maxima of every (cloud, class) group at once
     (models/voting.class_mean_shift_batch);
  3. per cloud (:meth:`ImplicitShapeModel._finish_detect`): the maxima
     (models/voting.find_maxima), the global verification (the ROIs'
     global descriptors through models/features.extract_global_features,
     then models/classifier.py), the cross-class filter, the merge of the
     global and local hypotheses, normalisation and selection.
detect() is detect_batch() of one cloud; detect_file() reads and
preprocesses a file first.  Stage wall times accumulate in
``processing_times`` under the JAX package's keys (features: the whole
extraction, normals and keypoints included, as on the JAX fused route;
flann: the codebook's upload; voting: the vote casting; maxima: the rest).
What the port does not detect raises NotImplementedError naming its queue
(:func:`detect_unsupported`).

load() reads the JAX package's pairing (`<model>.ism` + `<model>.ismd.npz`)
and the reference's (`ObjectData` naming a boost `.ismd`,
utils/boost_archive.py); save_reference() writes the latter.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import preprocess as pp
from ..ops import tiled
from ..ops.geometry import (MVBB_CHUNK, BoundingBox, compute_mvbb_batch,
                            quat_to_matrix_np)
from ..ops.voxel_grid import voxel_grid
from ..ops.neighbors import full_fp32
from ..utils.config import ComponentConfig, IsmConfig
from ..utils.io import PointCloud, read_cloud
from .classifier import GlobalClassifier, merge_global_and_local
from .clustering import ClusteringParams, run_clustering
from .codebook import (Codebook, CastVotes, CodebookParams, TrainedCodebook,
                       cast_votes, train_codebook)
from .detect_batch import (FusedChunk, extract_local_features_batch,
                           extraction_unsupported)
from .features import (GLOBAL_DESCRIPTORS, FeatureConfig, bucket_groups,
                       extract_global_features, pad_cloud, padded_chunk)
from .keypoints import KeypointParams
from .ranking import RankingParams, rank_features
from .svm import SVMModel, train_svm
from .types import FeatureSet
from .voting import (VotingMaximum, VotingParams, class_mean_shift_batch,
                     filter_maxima, find_maxima, get_search_dist,
                     normalize_weights, select_maxima)

# train() loads and extracts MODEL_CHUNK files at a time, so host memory
# holds O(chunk) clouds
MODEL_CHUNK = 128
TRAIN_STAGES = ("train_load", "train_features", "train_global",
                "train_ranking", "train_clustering", "train_activation",
                "train_rest")
# a crop of a box-annotated scene below this many points is skipped
# (implicit_shape_model.cpp:314-318)
MIN_CROP_POINTS = 500
# the processing_times keys of detection (implicit_shape_model.cpp:636-709)
DETECT_STAGES = ("complete", "features", "keypoints", "normals", "flann",
                 "voting", "maxima")


def _voting_params(cfg: ComponentConfig) -> VotingParams:
    """VotingParams of a config's ``Voting`` child."""
    return VotingParams(
        min_threshold=cfg.get("MinThreshold", 0.0),
        min_votes_threshold=cfg.get("MinVotesThreshold", 1),
        best_k=cfg.get("BestK", -1),
        average_rotation=cfg.get("AverageRotation", False),
        radius_type=cfg.get("BinOrBandwidthType", "Config"),
        radius_factor=cfg.get("BinOrBandwidthFactor", 1.0),
        max_filter_type=cfg.get("MaxFilterType", "None"),
        single_object_max_type=cfg.get("SingleObjectMaxType", "Default"),
        single_object_mode=cfg.get("SingleObjectMode", False),
        voting_type=cfg.type or "MeanShift",
        use_interpolation=cfg.get("UseInterpolation", True),
        min_coord=tuple(cfg.params.get("MinCoord", [-5.0, -5.0, -5.0])),
        rel_threshold=cfg.get("RelThreshold", 0.8),
        bandwidth=cfg.get("Bandwidth", 0.2),
        threshold=cfg.get("Threshold", 1e-3),
        max_iter=cfg.get("MaxIter", 1000),
        kernel=cfg.get("Kernel", "Gaussian"),
        maxima_suppression=cfg.get("MaximaSuppression", "Average"),
        use_global_features=cfg.get("UseGlobalFeatures", False),
        global_feature_method=cfg.get("GlobalFeaturesStrategy", "KNN"),
        k_global_features=cfg.get("GlobalFeaturesK", 1),
        merge_function=cfg.get("GlobalFeatureInfluenceType", 3),
        min_svm_score=cfg.get("GlobalParamMinSvmScore", 0.70),
        rate_limit=cfg.get("GlobalParamRateLimit", 0.60),
        weight_factor=cfg.get("GlobalParamWeightFactor", 1.5),
        global_min_points=cfg.get("GlobalFeatureMinPoints", 500),
        use_ransac=cfg.get("RansacVoteFiltering", False),
        ransac_inlier_threshold=cfg.get("RansacInlierThreshold", 0.1),
        ransac_inlier_threshold_type=cfg.get("RansacInlierThresholdType",
                                             "Fixed"))


def detect_unsupported(fcfg: FeatureConfig, gcfg: FeatureConfig,
                       vparams: VotingParams) -> Optional[str]:
    """Why the port cannot detect with this configuration, with the queue
    that ports it, or None."""
    why = extraction_unsupported(fcfg)
    if why is None and vparams.use_global_features \
            and gcfg.type not in GLOBAL_DESCRIPTORS:
        why = f"global features {gcfg.type!r} (the port computes " \
              f"{', '.join(GLOBAL_DESCRIPTORS)}; the whole-cloud globals " \
              "are ROADMAP A15.4)"
    return why


def _mesh_requested(root: ComponentConfig) -> bool:
    mesh = root.get("UseDeviceMesh", "Auto")
    return mesh is True or str(mesh).lower() == "true"


def preprocess_cloud(cloud: PointCloud, root: ComponentConfig,
                     device: torch.device) -> PointCloud:
    """The preprocessing chain (implicit_shape_model.cpp:739-821) on the
    device: statistical, then radius outlier removal, MLS smoothing and the
    z cut-off (ops/preprocess.py), then the voxel filter -- the voxel
    means of the kept points with their normals and colours
    (ops/voxel_grid).  A cloud above tiled.SCENE_TILE_THRESHOLD points with
    an outlier filter or MLS is sorted along its longest axis once (its
    normals and colours alongside) and filtered on the windows of
    ops/tiled.py, as the JAX package does: SOR's kNN within a window of at
    least 4096 points (the JAX approximation), ROR and MLS at their
    radii."""
    use_sor = root.get("UseStatisticalOutlierRemoval", False)
    use_ror = root.get("UseRadiusOutlierRemoval", False)
    use_mls = root.get("UseSmoothing", False)
    use_voxel = root.get("UseVoxelFiltering", False)
    z_cut = root.get("CutoffDistanceZAxis", 0.0)
    if not (use_sor or use_ror or use_mls or use_voxel or z_cut > 0):
        return cloud
    n_real = len(cloud.xyz)
    if n_real > tiled.SCENE_TILE_THRESHOLD and (use_sor or use_ror
                                                or use_mls):
        axis = tiled.sort_key_axis(cloud.xyz)
        order = np.argsort(cloud.xyz[:, axis], kind="stable")
        cloud = PointCloud(
            xyz=cloud.xyz[order],
            normals=None if cloud.normals is None else cloud.normals[order],
            rgb=None if cloud.rgb is None else cloud.rgb[order])
        pts_h, mask_h = pad_cloud(cloud.xyz)
        key = pts_h[:, axis]
        pts = torch.from_numpy(pts_h).to(device)
        mask = torch.from_numpy(mask_h).to(device)
        with full_fp32():
            if use_sor:
                plan = tiled.plan_tiles(key, mask_h, key, 0.0,
                                        tiled.NORMALS_CHUNK, min_window=4096)
                mask = tiled.tiled_statistical_outlier_removal(
                    pts, mask, plan, root.get("OutlierRemovalMeanK", 20),
                    root.get("OutlierRemovalStddevMul", 2.0))
            if use_ror:
                r = root.get("OutlierRemovalRadius", 0.005)
                plan = tiled.plan_tiles(key, mask_h, key, r,
                                        tiled.NORMALS_CHUNK)
                mask = tiled.tiled_radius_outlier_removal(
                    pts, mask, plan, r,
                    root.get("OutlierRemovalMinNeighbors", 10))
            if use_mls:
                r = root.get("SmoothingRadius", 0.01)
                plan = tiled.plan_tiles(key, mask_h, key, r,
                                        tiled.NORMALS_CHUNK)
                pts = tiled.tiled_mls_smooth(pts, mask, plan, r)
        pts, mask = pts[:n_real], mask[:n_real]
    else:
        pts = torch.from_numpy(np.ascontiguousarray(cloud.xyz, np.float32)
                               ).to(device)
        mask = torch.ones(n_real, dtype=torch.bool, device=device)
        if use_sor:
            mask = pp.statistical_outlier_removal(
                pts, mask, root.get("OutlierRemovalMeanK", 20),
                root.get("OutlierRemovalStddevMul", 2.0))
        if use_ror:
            mask = pp.radius_outlier_removal(
                pts, mask, root.get("OutlierRemovalRadius", 0.005),
                root.get("OutlierRemovalMinNeighbors", 10))
        if use_mls:
            pts = pp.mls_smooth(pts, mask, root.get("SmoothingRadius", 0.01))
    if z_cut > 0:
        mask = pp.z_cutoff(pts, mask, z_cut)
    keep = mask.cpu().numpy()
    out = PointCloud(
        xyz=pts.cpu().numpy()[keep],
        normals=None if cloud.normals is None else cloud.normals[keep],
        rgb=None if cloud.rgb is None else cloud.rgb[keep])
    if not use_voxel:
        return out
    feats = [a for a in (out.normals, out.rgb) if a is not None]
    extra = torch.from_numpy(np.concatenate(feats, 1).astype(np.float32)
                             ).to(device) if feats else None
    res = voxel_grid(torch.from_numpy(out.xyz).to(device),
                     torch.ones(len(out.xyz), dtype=torch.bool,
                                device=device),
                     root.get("VoxelLeafSize", 0.0015), features=extra,
                     exact_division=True)
    got = res.centroids[res.mask].cpu().numpy().astype(np.float32)
    off = 3
    nrm = rgb = None
    if out.normals is not None:
        nrm, off = got[:, 3:6], 6
    if out.rgb is not None:
        rgb = got[:, off:off + 3]
    return PointCloud(xyz=got[:, :3], normals=nrm, rgb=rgb)


@dataclass
class TrainedState:
    codebook: TrainedCodebook
    dims_map: Dict[int, Tuple[float, float]]      # class -> (radius, median)
    variance_map: Dict[int, Tuple[float, float]]
    instance_to_class: Dict[int, int] = field(default_factory=dict)
    # the training models' global features, for the verification classifier
    global_descriptors: Optional[np.ndarray] = None  # [G, Dg]
    global_classes: Optional[np.ndarray] = None      # [G]
    global_instances: Optional[np.ndarray] = None    # [G]
    global_radii: Optional[np.ndarray] = None        # [G]
    svm: Optional[SVMModel] = None


class ImplicitShapeModel:
    """Construct with a config, add training models, train(), save().
    Descriptors are computed on `device` (the card unless the caller asks
    for the CPU); `lrf_version` selects the LRF kernels (ops/lrf.py)."""

    def __init__(self, config: IsmConfig, device="cuda",
                 lrf_version: int = 1):
        self.config = config
        self.device = torch.device(device)
        self.lrf_version = lrf_version
        self.state: Optional[TrainedState] = None
        self.label_maps: Optional[dict] = None
        self._training: List[Tuple[str, int, int,
                                   Optional[BoundingBox]]] = []
        self.processing_times: Dict[str, float] = {}
        # the box of every trained model, in the order they were added
        self.boxes: List[BoundingBox] = []
        self._codebook: Optional[Codebook] = None
        self._gc_cache: Optional[GlobalClassifier] = None
        self._voting_dump_idx = 0

    @property
    def root(self):
        return self.config.root

    @property
    def metric(self) -> str:
        dist = self.root.get("DistanceType", "Euclidean")
        return "chisq" if dist == "ChiSquared" else "l2"

    def connect(self, callback) -> None:
        """Stage observers go with the live views of viz/, which the port
        does not have."""
        raise NotImplementedError(
            "observers (connect): the live stage signals go with viz/ "
            "(ROADMAP A13)")

    def get_detection_threshold(self) -> Dict[int, float]:
        """Per-class distance thresholds of detection evaluation
        (implicit_shape_model.h:215-248): Fixed keeps the configured value,
        ObjectRadius / BoundingBoxMedian scale it by the class's trained
        dimensions."""
        base = self.root.get("DistanceThresholdDetection", 0.05)
        ttype = self.root.get("DistanceThresholdType", "Fixed")
        out = {}
        for cid, (radius, median) in self.state.dims_map.items():
            v = base
            if ttype == "ObjectRadius":
                v *= radius
            elif ttype == "BoundingBoxMedian":
                v *= median
            out[cid] = v
        return out

    def add_training_model(self, filename: str, class_id: int,
                           instance_id: int) -> None:
        self._training.append((filename, class_id, instance_id, None))

    def add_training_models_with_boxes(self, filename: str, class_ids,
                                       instance_ids, boxes) -> None:
        """One scene file contributes one model per annotated box, cropped
        to it (implicit_shape_model.cpp:194-210, :300-320)."""
        for cid, iid, box in zip(class_ids, instance_ids, boxes):
            self._training.append((filename, int(cid), int(iid), box))

    def _check_trainable(self, fcfg: FeatureConfig,
                         gcfg: FeatureConfig) -> None:
        """Raise NotImplementedError, with the reason and its queue, for
        what the port does not train."""
        reasons = []
        why = extraction_unsupported(fcfg)
        if why:
            reasons.append(why)
        if gcfg.type not in GLOBAL_DESCRIPTORS:
            reasons.append(f"global features {gcfg.type!r} (the port "
                           f"computes {', '.join(GLOBAL_DESCRIPTORS)}; the "
                           "whole-cloud globals are ROADMAP A15.4)")
        elif gcfg.type != "Dummy":
            why = extraction_unsupported(
                dataclasses.replace(gcfg, type=gcfg.local_type))
            if why:
                reasons.append(f"global features {gcfg.type!r}: {why}")
        if _mesh_requested(self.root):
            reasons.append("UseDeviceMesh true (training on several "
                           "devices is ROADMAP A16)")
        if reasons:
            raise NotImplementedError(
                "the port does not train this config: " + "; ".join(reasons))

    def _load(self, filename: str, gt_box: Optional[BoundingBox]
              ) -> Optional[PointCloud]:
        """The preprocessed cloud of a training model, cropped to its box;
        None for a crop under MIN_CROP_POINTS points (skipped)."""
        cloud = preprocess_cloud(read_cloud(filename).remove_nan(),
                                 self.root, self.device)
        if gt_box is not None:
            cloud = _crop_box(cloud, gt_box)
            if len(cloud.xyz) < MIN_CROP_POINTS:
                return None
        return cloud

    def _cache_path(self, xyz: np.ndarray, nrm: Optional[np.ndarray],
                    rgb: Optional[np.ndarray], fcfg: FeatureConfig,
                    kp_params: KeypointParams) -> str:
        """The cache file of one cloud's features: keyed on the cloud as
        loaded (after preprocessing and the crop: its points, and the
        normals and colours that extraction reads) and on what extraction
        does with it."""
        folder = self.root.get("CacheFeaturesFolder", "ism_feature_cache")
        os.makedirs(folder, exist_ok=True)
        key = hashlib.sha1(repr((
            fcfg, kp_params, self.root.get("NormalRadius", 0.05),
            self.root.get("ConsistentNormalsMethod", 2), self.lrf_version,
            self.device.type)).encode())
        for a in (xyz, nrm, rgb):
            key.update(b"-" if a is None else np.ascontiguousarray(
                a, np.float32).tobytes() + b"|")
        return os.path.join(folder, key.hexdigest()[:20] + ".npz")

    def _local_features(self, xyzs, nrms, rgbs, fcfg, kp_params,
                        chunk_cache: List[FusedChunk]) -> List[FeatureSet]:
        """The local features of one slice of clouds
        (models/detect_batch.extract_local_features_batch).  With
        CacheFeatures each file's features are read from, or written to, an
        npz of CacheFeaturesFolder keyed on the loaded cloud and the port's
        feature, keypoint and normals config, the LRF kernels and the
        device type (``_cache_path``) -- the port's own cache, which the
        JAX package does not read (training feature caching,
        implicit_shape_model.cpp:1360-1644)."""
        use_cache = self.root.get("CacheFeatures", False)
        out: List[Optional[FeatureSet]] = [None] * len(xyzs)
        paths = [self._cache_path(x, n, c, fcfg, kp_params)
                 if use_cache else None for x, n, c in zip(xyzs, nrms, rgbs)]
        todo = []
        for i, path in enumerate(paths):
            if path is not None and os.path.exists(path):
                with np.load(path) as z:
                    out[i] = FeatureSet(*(z[k] for k in FeatureSet._fields))
            else:
                todo.append(i)
        if todo:
            sub_cache: List[FusedChunk] = []
            got = extract_local_features_batch(
                [xyzs[i] for i in todo], [nrms[i] for i in todo],
                [rgbs[i] for i in todo], fcfg, kp_params,
                self.root.get("NormalRadius", 0.05),
                self.root.get("ConsistentNormalsMethod", 2), self.device,
                self.lrf_version, sub_cache)
            chunk_cache.extend(e._replace(chunk=[todo[j] for j in e.chunk])
                               for e in sub_cache)
            for i, fs in zip(todo, got):
                out[i] = fs
                if paths[i] is not None:
                    np.savez_compressed(paths[i], **fs._asdict())
        return out  # type: ignore[return-value]

    def train(self) -> None:
        tt = {k: 0.0 for k in TRAIN_STAGES}
        t_all = time.perf_counter()
        fcfg = FeatureConfig.from_config(self.config.child("Features"))
        gcfg = FeatureConfig.from_config(self.config.child("GlobalFeatures"))
        kp_params = KeypointParams.from_config(self.config.child("Keypoints"))
        normal_radius = self.root.get("NormalRadius", 0.05)
        cn_method = self.root.get("ConsistentNormalsMethod", 2)
        bb_type = self.root.get("BoundingBoxType", "MVBB")
        cb_params = CodebookParams.from_config(self.config.child("Codebook"))
        self._check_trainable(fcfg, gcfg)
        set_color_to_zero = self.root.get("SetColorToZero", False)

        features_per_model: List[FeatureSet] = []
        class_per_model: List[int] = []
        instance_per_model: List[int] = []
        boxes_per_model: List[BoundingBox] = []
        radii_per_model: List[float] = []
        global_feats: List[Tuple[FeatureSet, int, int]] = []
        dev_cache: List[FusedChunk] = []

        for base in range(0, len(self._training), MODEL_CHUNK):
            # pass 1: load, preprocess, crop; radii and boxes
            t0 = time.perf_counter()
            xyzs, nrms, rgbs, cls, inst, boxes = ([] for _ in range(6))
            for filename, class_id, instance_id, gt_box in \
                    self._training[base:base + MODEL_CHUNK]:
                cloud = self._load(filename, gt_box)
                if cloud is None:
                    continue
                xyz = cloud.xyz
                if gt_box is not None:
                    box = gt_box
                elif bb_type == "MVBB":
                    box = None   # one batch for the slice, below
                else:
                    mn, mx = xyz.min(axis=0), xyz.max(axis=0)
                    box = BoundingBox(
                        position=(mn + (mx - mn) / 2.0).astype(np.float32),
                        size=(mx - mn).astype(np.float32),
                        quat=np.array([1.0, 0.0, 0.0, 0.0], np.float32))
                centroid = xyz.mean(axis=0)
                radii_per_model.append(
                    float(np.linalg.norm(xyz - centroid, axis=1).max()))
                xyzs.append(xyz)
                nrms.append(cloud.normals if cloud.has_normals() else None)
                rgbs.append(None if set_color_to_zero else cloud.rgb)
                cls.append(class_id)
                inst.append(instance_id)
                boxes.append(box)
            for i, box in zip(*self._mvbb(xyzs, boxes)):
                boxes[i] = box
            class_per_model.extend(cls)
            instance_per_model.extend(inst)
            boxes_per_model.extend(boxes)
            tt["train_load"] += time.perf_counter() - t0

            # pass 2: local features; cache rows become model indices
            t0 = time.perf_counter()
            gbase = len(features_per_model)
            chunk_cache: List[FusedChunk] = []
            features_per_model.extend(self._local_features(
                xyzs, nrms, rgbs, fcfg, kp_params, chunk_cache))
            dev_cache.extend(e._replace(chunk=[gbase + j for j in e.chunk])
                             for e in chunk_cache)
            tt["train_features"] += time.perf_counter() - t0

            # pass 3: global features
            t0 = time.perf_counter()
            for gfs, c, i in zip(extract_global_features(
                    xyzs, nrms, rgbs, gcfg, normal_radius, cn_method,
                    self.device, self.lrf_version), cls, inst):
                global_feats.append((gfs, c, i))
            tt["train_global"] += time.perf_counter() - t0

        # feature ranking, in the class-major model order
        t0 = time.perf_counter()
        order = sorted(range(len(features_per_model)),
                       key=lambda i: class_per_model[i])
        all_desc = np.concatenate(
            [features_per_model[i].descriptors for i in order], axis=0)
        all_cls = np.concatenate(
            [np.full(features_per_model[i].descriptors.shape[0],
                     class_per_model[i], np.int32) for i in order])
        all_cdist = np.concatenate(
            [features_per_model[i].center_dist for i in order])
        keep = rank_features(all_desc, all_cls, all_cdist,
                             RankingParams.from_config(
                                 self.config.child("FeatureWeighting")),
                             self.device)
        ranked_models: List[FeatureSet] = []
        off = 0
        for i in order:
            fs = features_per_model[i]
            n = fs.descriptors.shape[0]
            ranked_models.append(FeatureSet(*(np.asarray(a)[keep[off:off + n]]
                                              for a in fs)))
            off += n
        tt["train_ranking"] = time.perf_counter() - t0

        # clustering -> codewords; the i-th codeword's position is the i-th
        # kept feature's (implicit_shape_model.cpp:465-475)
        t0 = time.perf_counter()
        all_desc_r = np.concatenate([f.descriptors for f in ranked_models], 0)
        all_pos_r = np.concatenate([f.positions for f in ranked_models], 0)
        clu_params = ClusteringParams.from_config(
            self.config.child("Clustering"))
        centers, _ = run_clustering(all_desc_r, clu_params, self.metric,
                                    self.device)
        cw_pos = all_pos_r[:len(centers)]
        tt["train_clustering"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        rows = _device_rows(dev_cache, order, keep,
                            [features_per_model[i].descriptors.shape[0]
                             for i in order])
        if rows is None:
            rows = torch.from_numpy(np.ascontiguousarray(
                all_desc_r, np.float32)).to(self.device)
        codeword_rows = None
        if clu_params.type != "None":
            codeword_rows = torch.from_numpy(np.ascontiguousarray(
                centers, np.float32)).to(self.device)
        codebook = train_codebook(
            ranked_models, [class_per_model[i] for i in order],
            [instance_per_model[i] for i in order],
            [boxes_per_model[i] for i in order], centers, cw_pos, cb_params,
            self.metric, rows, codeword_rows)
        tt["train_activation"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        # forwardBoxesAndRadii (voting.cpp:497-551): per-class mean object
        # radius and mean median box edge, and their variances
        dims_map: Dict[int, Tuple[float, float]] = {}
        var_map: Dict[int, Tuple[float, float]] = {}
        for cid in sorted(set(class_per_model)):
            idxs = [i for i, c in enumerate(class_per_model) if c == cid]
            meds = np.array([float(np.median(np.asarray(
                boxes_per_model[i].size))) for i in idxs])
            rads = np.array([radii_per_model[i] for i in idxs])
            dims_map[cid] = (float(rads.mean()), float(meds.mean()))
            var_map[cid] = (float((rads ** 2).mean() - rads.mean() ** 2),
                            float((meds ** 2).mean() - meds.mean() ** 2))
        g_desc, g_cls, g_inst, g_rad = [], [], [], []
        for gfs, cid, iid in global_feats:
            if gfs.descriptors.shape[0]:
                g_desc.append(gfs.descriptors)
                g_cls.extend([cid] * gfs.descriptors.shape[0])
                g_inst.extend([iid] * gfs.descriptors.shape[0])
                g_rad.extend(gfs.global_radius.tolist())
        self.state = TrainedState(
            codebook=codebook, dims_map=dims_map, variance_map=var_map,
            global_descriptors=np.concatenate(g_desc, 0) if g_desc else None,
            global_classes=np.array(g_cls, np.int32) if g_desc else None,
            global_instances=np.array(g_inst, np.int32) if g_desc else None,
            global_radii=np.array(g_rad, np.float32) if g_desc else None)
        # the SVM on the global features (implicit_shape_model.cpp:424-428)
        if self.root.get("UseSvmTraining", False) and g_desc:
            self.state.svm = train_svm(
                self.state.global_descriptors, self.state.global_classes,
                one_vs_all=self.root.get("SvmOneVsAllTraining", False),
                auto_train=self.root.get("SvmAutoTrain", False),
                param_c=self.root.get("SvmParamC", 7.41),
                param_gamma=self.root.get("SvmParamGamma", 2.96),
                k_fold=self.root.get("SvmParamKfold", 10))
        self.boxes = boxes_per_model
        tt["train_rest"] = time.perf_counter() - t0
        tt["train_complete"] = time.perf_counter() - t_all
        self.processing_times.update(tt)

    def _mvbb(self, xyzs: List[np.ndarray],
              boxes: List[Optional[BoundingBox]]):
        """(indices, MVBBs) of the clouds whose box is None: one
        compute_mvbb_batch per chunk of a bucket size, MVBB_CHUNK clouds at
        most."""
        idx = [i for i, b in enumerate(boxes) if b is None]
        clouds = [xyzs[i] for i in idx]
        out: List[Optional[BoundingBox]] = [None] * len(idx)
        for n, chunk in bucket_groups(clouds, MVBB_CHUNK):
            pts, mask, _ = padded_chunk(clouds, chunk, n)
            pos, size, quat = (x.cpu().numpy() for x in compute_mvbb_batch(
                torch.from_numpy(pts).to(self.device),
                torch.from_numpy(mask).to(self.device)))
            for r, j in enumerate(chunk):
                out[j] = BoundingBox(position=pos[r], size=size[r],
                                     quat=quat[r])
        return idx, out

    def save(self, path: str) -> None:
        """Write `<path>` (the .ism JSON config) and `<path>d.npz` (the
        trained arrays) in the JAX package's format: its
        ``ImplicitShapeModel.load`` (global features and SVM included) and
        the port's ``load_codebook`` read them."""
        self.config.save(path)
        if self.state is None:
            return
        st = self.state
        keys = sorted(st.dims_map)
        arrays = {f"cb_{k}": v for k, v in st.codebook._asdict().items()}
        arrays["dims_keys"] = np.array(keys, np.int32)
        arrays["dims_vals"] = np.array([st.dims_map[k] for k in keys],
                                       np.float32)
        arrays["var_vals"] = np.array(
            [st.variance_map[k] for k in sorted(st.variance_map)], np.float32)
        if st.instance_to_class:
            arrays["inst2cls"] = np.array(sorted(st.instance_to_class.items()),
                                          np.int32)
        if self.label_maps:
            arrays["label_maps"] = np.array(json.dumps(self.label_maps))
        if st.global_descriptors is not None:
            arrays["glob_desc"] = st.global_descriptors
            arrays["glob_cls"] = st.global_classes
            arrays["glob_inst"] = st.global_instances
            arrays["glob_rad"] = st.global_radii
        if st.svm is not None:
            arrays.update(st.svm.to_arrays())
        np.savez_compressed(path + "d.npz", **arrays)

    def save_reference(self, path: str) -> None:
        """Write the reference implementation's pairing: the `.ism` JSON
        with an ObjectData key and the boost binary `.ismd` it names
        (utils/json_object.cpp:50-95; utils/boost_archive.py)."""
        from ..utils.boost_archive import state_to_ref_data, write_ismd
        data_name = os.path.basename(path) + "d"
        with open(path, "w") as f:
            json.dump({"ObjectConfig": self.config.root.to_json(),
                       "ObjectData": data_name}, f, indent=3, sort_keys=True)
        write_ismd(os.path.join(os.path.dirname(path) or ".", data_name),
                   state_to_ref_data(self.state, self.label_maps))

    @classmethod
    def load(cls, path: str, device="cuda",
             lrf_version: int = 1) -> "ImplicitShapeModel":
        """A trained model: `<path>` (the .ism JSON) with `<path>d.npz` (the
        JAX package's and the port's save) or, without it, the boost
        `.ismd` that the JSON's ObjectData names (default `<path>d`, the
        reference's pairing, json_object.cpp:50-64)."""
        ism = cls(IsmConfig.load(path), device, lrf_version)
        data_path = path + "d.npz"
        if not os.path.exists(data_path):
            try:
                with open(path) as f:
                    cand = json.load(f).get("ObjectData")
            except (OSError, ValueError):
                cand = None
            candidates = [os.path.join(os.path.dirname(path), cand)] \
                if cand else []
            candidates.append(path + "d")
            for p in candidates:
                if os.path.exists(p):
                    from ..utils.boost_archive import (read_ismd,
                                                       ref_data_to_state)
                    ism.state, ism.label_maps = ref_data_to_state(
                        read_ismd(p))
                    return ism
            raise FileNotFoundError(f"no trained data for {path}")
        with np.load(data_path, allow_pickle=False) as z:
            cb = TrainedCodebook(**{k[3:]: z[k] for k in z.files
                                    if k.startswith("cb_")})
            keys, vals, var = z["dims_keys"], z["dims_vals"], z["var_vals"]
            state = TrainedState(
                codebook=cb,
                dims_map={int(k): (float(v[0]), float(v[1]))
                          for k, v in zip(keys, vals)},
                variance_map={int(k): (float(v[0]), float(v[1]))
                              for k, v in zip(keys, var)})
            if "inst2cls" in z.files:
                state.instance_to_class = {int(a): int(b)
                                           for a, b in z["inst2cls"]}
            if "label_maps" in z.files:
                ism.label_maps = json.loads(str(z["label_maps"]))
            if "glob_desc" in z.files:
                state.global_descriptors = z["glob_desc"]
                state.global_classes = z["glob_cls"]
                state.global_instances = z["glob_inst"]
                state.global_radii = z["glob_rad"]
            state.svm = SVMModel.from_arrays(z)
        ism.state = state
        return ism

    # -- detection -----------------------------------------------------------
    def detect_file(self, filename: str
                    ) -> Tuple[List[VotingMaximum], Dict[str, float]]:
        """Read a cloud file (NaN rows dropped), preprocess it and detect."""
        cloud = preprocess_cloud(read_cloud(filename).remove_nan(),
                                 self.root, self.device)
        return self.detect(cloud.xyz,
                           cloud.normals if cloud.has_normals() else None,
                           cloud.rgb)

    def detect(self, xyz: np.ndarray, normals: Optional[np.ndarray] = None,
               rgb: Optional[np.ndarray] = None
               ) -> Tuple[List[VotingMaximum], Dict[str, float]]:
        """The maxima of one cloud and the stage times so far:
        detect_batch of that cloud."""
        return self.detect_batch([xyz], [normals], [rgb])[0]

    def _device_codebook(self) -> Codebook:
        """The codebook on the device, uploaded once (the analogue of the
        reference's lazy FLANN index, timed as "flann")."""
        if self._codebook is None:
            t0 = time.perf_counter()
            self._codebook = Codebook.from_numpy(
                self.state.codebook._asdict()).to(self.device)
            self.processing_times["flann"] = self.processing_times.get(
                "flann", 0.0) + time.perf_counter() - t0
        return self._codebook

    def _check_detectable(self, fcfg, gcfg, vparams) -> None:
        why = detect_unsupported(fcfg, gcfg, vparams)
        if why:
            raise NotImplementedError("the port does not detect with this "
                                      "config: " + why)

    def detect_batch(self, clouds, normals_list=None, rgb_list=None
                     ) -> List[Tuple[List[VotingMaximum], Dict[str, float]]]:
        """The maxima of each cloud (module docstring), each with a copy of
        the stage times after the batch."""
        assert self.state is not None, "not trained or loaded"
        n = len(clouds)
        clouds = [np.asarray(c, np.float32) for c in clouds]
        normals_list = list(normals_list) if normals_list else [None] * n
        rgb_list = list(rgb_list) if rgb_list else [None] * n
        if self.root.get("SetColorToZero", False):
            rgb_list = [None] * n
        fcfg = FeatureConfig.from_config(self.config.child("Features"))
        gcfg = FeatureConfig.from_config(self.config.child("GlobalFeatures"))
        kp_params = KeypointParams.from_config(self.config.child("Keypoints"))
        vparams = _voting_params(self.config.child("Voting"))
        cb_params = CodebookParams.from_config(self.config.child("Codebook"))
        self._check_detectable(fcfg, gcfg, vparams)
        normal_radius = self.root.get("NormalRadius", 0.05)
        cn_method = self.root.get("ConsistentNormalsMethod", 2)
        times = self.processing_times
        for k in DETECT_STAGES:
            times.setdefault(k, 0.0)

        t0 = time.perf_counter()
        cb = self._device_codebook()
        t_feat = time.perf_counter()
        chunks: List[FusedChunk] = []
        fss = extract_local_features_batch(
            clouds, normals_list, rgb_list, fcfg, kp_params, normal_radius,
            cn_method, self.device, self.lrf_version, chunks,
            is_training=False)
        times["features"] += time.perf_counter() - t_feat

        t_vote = time.perf_counter()
        votes_list = self._cast_votes_batch(cb, fss, chunks, cb_params)
        times["voting"] += time.perf_counter() - t_vote

        t_max = time.perf_counter()
        # single-object mode verifies the whole cloud once
        # (voting.cpp:240-261)
        gfs_list: List[Optional[FeatureSet]] = [None] * n
        if vparams.use_global_features and vparams.single_object_mode:
            gfs_list = extract_global_features(
                clouds, normals_list, rgb_list, gcfg, normal_radius,
                cn_method, self.device, self.lrf_version)
        ms_pre = self._precompute_mean_shift_batch(votes_list, vparams)
        maxima_list = [self._finish_detect(votes_list[i], clouds[i],
                                           normals_list[i], rgb_list[i],
                                           vparams, gfs_list[i], ms_pre[i])
                       for i in range(n)]
        times["maxima"] += time.perf_counter() - t_max
        times["complete"] += time.perf_counter() - t0
        return [(m, dict(times)) for m in maxima_list]

    def _cast_votes_batch(self, cb: Codebook, fss: List[FeatureSet],
                          chunks: List[FusedChunk],
                          cb_params: CodebookParams) -> List[CastVotes]:
        """The cast votes of each cloud, as numpy: per extraction chunk,
        the kept descriptors (still on the device) with their keypoints
        and frames go through one cast_votes, and the valid votes come
        back in one read."""
        out: List[Optional[CastVotes]] = [None] * len(fss)
        empty = CastVotes(
            position=np.zeros((0, 3), np.float32),
            weight=np.zeros(0, np.float32), class_id=np.zeros(0, np.int64),
            instance_id=np.zeros(0, np.int64),
            keypoint=np.zeros((0, 3), np.float32),
            keypoint_training=np.zeros((0, 3), np.float32),
            bbox_size=np.zeros((0, 3), np.float32),
            bbox_quat=np.zeros((0, 4), np.float32), valid=np.zeros(0, bool))
        for e in chunks:
            keep = torch.from_numpy(e.keep).to(e.desc.device)
            desc = e.desc[keep]
            counts = [fss[ci].descriptors.shape[0] for ci in e.chunk]
            if not sum(counts):
                for ci in e.chunk:
                    out[ci] = empty
                continue
            pos = np.concatenate([fss[ci].positions for ci in e.chunk])
            frames = np.concatenate([fss[ci].frames for ci in e.chunk])
            with full_fp32():
                v = cast_votes(
                    cb, desc, torch.from_numpy(np.ascontiguousarray(
                        pos, np.float32)).to(self.device),
                    torch.from_numpy(np.ascontiguousarray(
                        frames, np.float32)).to(self.device),
                    torch.ones(desc.shape[0], dtype=torch.bool,
                               device=self.device), cb_params, self.metric)
            per_feature = v.position.shape[0] // max(desc.shape[0], 1)
            ids = torch.repeat_interleave(
                torch.arange(len(counts), device=self.device),
                torch.tensor(counts, device=self.device) * per_feature)
            keep_v = v.valid
            host = {f: getattr(v, f)[keep_v].cpu().numpy()
                    for f in CastVotes._fields if f != "valid"}
            owner = ids[keep_v].cpu().numpy()
            for r, ci in enumerate(e.chunk):
                sel = owner == r
                out[ci] = CastVotes(**{f: a[sel] for f, a in host.items()},
                                    valid=np.ones(int(sel.sum()), bool))
        return out  # type: ignore[return-value]

    def _precompute_mean_shift_batch(self, votes_list, vparams: VotingParams
                                     ) -> List[Optional[Dict[int, np.ndarray]]]:
        """The per-class mean-shift maxima of every cloud in one batch
        (class_mean_shift_batch over every (cloud, class) vote group); a
        list of None when the config's maxima search is not a per-class
        mean-shift."""
        n = len(votes_list)
        if vparams.voting_type != "MeanShift" or (
                vparams.single_object_mode
                and vparams.single_object_max_type not in ("None",
                                                           "Default")):
            return [None] * n
        items, owners = [], []
        for i, votes in enumerate(votes_list):
            for class_id in sorted(set(votes.class_id.tolist())):
                sel = votes.class_id == class_id
                items.append((votes.position[sel], votes.weight[sel],
                              get_search_dist(class_id, vparams,
                                              self.state.dims_map)))
                owners.append((i, class_id))
        out: List[Optional[Dict[int, np.ndarray]]] = [{} for _ in range(n)]
        for (i, cid), (m_pos, _) in zip(
                owners, class_mean_shift_batch(items, vparams, self.device)):
            out[i][cid] = m_pos
        return out

    def _finish_detect(self, votes: CastVotes, xyz: np.ndarray,
                       normals: Optional[np.ndarray],
                       rgb: Optional[np.ndarray], vparams: VotingParams,
                       precomputed_gfs: Optional[FeatureSet] = None,
                       ms_pre: Optional[Dict[int, np.ndarray]] = None
                       ) -> List[VotingMaximum]:
        """The maxima, the global verification (voting.cpp:218-295), the
        filter, the merge of global and local hypotheses, normalisation
        and selection of one cloud's cast votes."""
        if self.root.get("EnableVotingAnalysis", False):
            from ..utils.debug_utils import write_voting_space
            out = self.root.get("VotingAnalysisOutputPath",
                                "voting_analysis")
            self._voting_dump_idx += 1
            write_voting_space(
                os.path.join(out, f"votes_{self._voting_dump_idx:04d}.npz"),
                votes.position, votes.weight, votes.class_id)
        maxima = find_maxima(votes, xyz, np.ones(len(xyz), bool), vparams,
                             self.state.dims_map, self.device,
                             ms_precomputed=ms_pre)

        roi_centroid = np.zeros(3, np.float32)
        if vparams.use_global_features:
            gc = self._global_classifier(vparams)
            gcfg = FeatureConfig.from_config(
                self.config.child("GlobalFeatures"))
            if not vparams.single_object_mode:
                # per-maximum ROIs, their global descriptors in one batch
                segs, seg_rgbs, oks = [], [], []
                for m in maxima:
                    seg = gc.segment_roi(xyz, normals, m)
                    segs.append(seg)
                    oks.append(len(seg[0]) > vparams.global_min_points)
                    seg_rgbs.append(
                        rgb[np.linalg.norm(xyz - m.position[None, :], axis=1)
                            <= gc.average_radii.get(m.class_id, 0.0)]
                        if (rgb is not None and oks[-1]) else None)
                idxs = [i for i, ok in enumerate(oks) if ok]
                rois = dict(zip(idxs, extract_global_features(
                    [segs[i][0] for i in idxs], [segs[i][1] for i in idxs],
                    [seg_rgbs[i] for i in idxs], gcfg,
                    self.root.get("NormalRadius", 0.05),
                    self.root.get("ConsistentNormalsMethod", 2),
                    self.device, self.lrf_version))) if idxs else {}
                for i, m in enumerate(maxima):
                    if oks[i]:
                        gc.classify(rois[i].descriptors, m, True)
                        roi_centroid = segs[i][0].mean(axis=0).astype(
                            np.float32)
                    else:
                        gc.classify(np.zeros((0, 1), np.float32), m, False)
            else:
                gfs = precomputed_gfs
                probe = VotingMaximum()
                if gfs.descriptors.shape[0]:
                    gc.classify(gfs.descriptors, probe, True)
                for m in maxima:
                    m.glob_class_id = probe.glob_class_id
                    m.glob_class_weight = probe.glob_class_weight
                    m.glob_instance_id = probe.glob_instance_id
                    m.glob_instance_weight = probe.glob_instance_weight
                if not maxima and gfs.descriptors.shape[0]:
                    box = self._mvbb([xyz], [None])[1][0]
                    maxima.append(VotingMaximum(
                        class_id=probe.glob_class_id,
                        instance_id=probe.glob_instance_id,
                        position=xyz.mean(axis=0).astype(np.float32),
                        weight=probe.glob_class_weight,
                        instance_weight=probe.glob_instance_weight,
                        bb_size=np.asarray(box.size),
                        bb_quat=np.asarray(box.quat),
                        glob_class_id=probe.glob_class_id,
                        glob_class_weight=probe.glob_class_weight,
                        glob_instance_id=probe.glob_instance_id,
                        glob_instance_weight=probe.glob_instance_weight))

        if not vparams.single_object_mode:
            maxima = filter_maxima(maxima, vparams, self.state.dims_map)
        maxima = sorted(maxima, key=lambda m: -m.weight)
        if vparams.use_global_features and maxima:
            # merge function 5 takes the unnormalised weights
            # (voting.cpp:275-281)
            if vparams.merge_function != 5:
                normalize_weights(maxima)
            merge_global_and_local(maxima, vparams, roi_centroid)
            maxima = sorted(maxima, key=lambda m: -m.weight)
            maxima = [m for m in maxima if m.weight != 0]
        normalize_weights(maxima)
        return select_maxima(maxima, vparams)

    def _global_classifier(self, vparams: VotingParams) -> GlobalClassifier:
        """The verification classifier, built once: the ROI radius of a
        class is the mean globalDescriptorRadius of its training global
        features (global_classifier.cpp:55-67), else its median box edge."""
        if self._gc_cache is None:
            st = self.state
            if st.global_radii is not None and len(st.global_radii):
                gcls = np.asarray(st.global_classes)
                grad = np.asarray(st.global_radii)
                radii = {int(c): float(grad[gcls == c].mean())
                         for c in np.unique(gcls)}
            else:
                radii = {cid: dims[1] for cid, dims in st.dims_map.items()}
            method = vparams.global_feature_method
            if method == "SVM" and st.svm is None:
                method = "KNN"
            self._gc_cache = GlobalClassifier(
                descriptors=st.global_descriptors, classes=st.global_classes,
                instances=st.global_instances, average_radii=radii,
                metric=self.metric, method=method,
                k=vparams.k_global_features,
                single_object_mode=vparams.single_object_mode, svm=st.svm,
                device=self.device)
        return self._gc_cache


def _crop_box(cloud: PointCloud, box: BoundingBox) -> PointCloud:
    """The points inside an oriented box (CropBox semantics)."""
    rot = quat_to_matrix_np(box.quat)
    local = (cloud.xyz - np.asarray(box.position)[None, :]) @ rot
    half = np.asarray(box.size) / 2.0
    sel = np.all(np.abs(local) <= half[None, :] + 1e-6, axis=1)
    return PointCloud(xyz=cloud.xyz[sel],
                      rgb=None if cloud.rgb is None else cloud.rgb[sel],
                      normals=None if cloud.normals is None
                      else cloud.normals[sel])


def _device_rows(cache: List[FusedChunk], model_order: List[int],
                 keep: np.ndarray, sizes: List[int]
                 ) -> Optional[torch.Tensor]:
    """The descriptors the extraction left on the device (the JAX
    ``build_device_activation``): each model's extracted rows that the
    ranking kept (`keep` over the models' features in `model_order`, whose
    counts are `sizes`), in that class-major order; None when a model's
    rows are not on the device (read from the feature cache)."""
    by_cloud = {}
    for e_id, e in enumerate(cache):
        for r, ci in enumerate(e.chunk):
            by_cloud[ci] = (e_id, r)
    if any(ci not in by_cloud for ci in model_order):
        return None
    parts = []
    off = 0
    for ci, n in zip(model_order, sizes):
        e_id, r = by_cloud[ci]
        e = cache[e_id]
        rows = np.nonzero(e.keep[r])[0][keep[off:off + n]]
        off += n
        parts.append(e.desc[r].index_select(
            0, torch.from_numpy(rows).to(e.desc.device)))
    return torch.cat(parts)
