"""Training and saving of an Implicit Shape Model (port of the training
half of point_cloud_donkey_tpu/models/ism.py: ``preprocess_cloud``,
``add_training_model``, ``train``, ``save``).

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
the queue that ports it, before any cloud is read (keypoint culling in
training, other descriptors and global descriptors, several devices) or
when the cloud that needs it is read (scene-scale filters).
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
from ..ops.geometry import (MVBB_CHUNK, BoundingBox, compute_mvbb_batch,
                            quat_to_matrix_np)
from ..ops.voxel_grid import voxel_grid
from ..utils.config import ComponentConfig, IsmConfig
from ..utils.io import PointCloud, read_cloud
from .clustering import ClusteringParams, run_clustering
from .codebook import CodebookParams, TrainedCodebook, train_codebook
from .detect_batch import (FusedChunk, extract_local_features_batch,
                           train_unsupported)
from .features import (GLOBAL_DESCRIPTORS, FeatureConfig, bucket_groups,
                       extract_global_features, padded_chunk)
from .keypoints import KeypointParams
from .ranking import RankingParams, rank_features
from .svm import SVMModel, train_svm
from .types import FeatureSet

# train() loads and extracts MODEL_CHUNK files at a time, so host memory
# holds O(chunk) clouds
MODEL_CHUNK = 128
TRAIN_STAGES = ("train_load", "train_features", "train_global",
                "train_ranking", "train_clustering", "train_activation",
                "train_rest")
# a crop of a box-annotated scene below this many points is skipped
# (implicit_shape_model.cpp:314-318)
MIN_CROP_POINTS = 500
# above this many points the JAX package runs the outlier filters and MLS
# on its scene-scale tiles (JAX ops/tiled.py:37)
SCENE_TILE_THRESHOLD = 32768


def _mesh_requested(root: ComponentConfig) -> bool:
    mesh = root.get("UseDeviceMesh", "Auto")
    return mesh is True or str(mesh).lower() == "true"


def preprocess_cloud(cloud: PointCloud, root: ComponentConfig,
                     device: torch.device) -> PointCloud:
    """The preprocessing chain (implicit_shape_model.cpp:739-821) on the
    device: statistical, then radius outlier removal, MLS smoothing and the
    z cut-off (ops/preprocess.py), then the voxel filter -- the voxel
    means of the kept points with their normals and colours
    (ops/voxel_grid).  Clouds above SCENE_TILE_THRESHOLD points with an
    outlier filter or MLS are refused: the JAX package tiles them."""
    use_sor = root.get("UseStatisticalOutlierRemoval", False)
    use_ror = root.get("UseRadiusOutlierRemoval", False)
    use_mls = root.get("UseSmoothing", False)
    use_voxel = root.get("UseVoxelFiltering", False)
    z_cut = root.get("CutoffDistanceZAxis", 0.0)
    if not (use_sor or use_ror or use_mls or use_voxel or z_cut > 0):
        return cloud
    if len(cloud.xyz) > SCENE_TILE_THRESHOLD and (use_sor or use_ror
                                                  or use_mls):
        raise NotImplementedError(
            f"outlier removal or MLS on a cloud of {len(cloud.xyz)} points "
            f"(> {SCENE_TILE_THRESHOLD}): the scene-scale tiled filters "
            "are ROADMAP A14")
    pts = torch.from_numpy(np.ascontiguousarray(cloud.xyz, np.float32)).to(
        device)
    mask = torch.ones(len(cloud.xyz), dtype=torch.bool, device=device)
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
                     root.get("VoxelLeafSize", 0.0015), features=extra)
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

    @property
    def root(self):
        return self.config.root

    @property
    def metric(self) -> str:
        dist = self.root.get("DistanceType", "Euclidean")
        return "chisq" if dist == "ChiSquared" else "l2"

    def add_training_model(self, filename: str, class_id: int,
                           instance_id: int) -> None:
        self._training.append((filename, class_id, instance_id, None))

    def add_training_models_with_boxes(self, filename: str, class_ids,
                                       instance_ids, boxes) -> None:
        """One scene file contributes one model per annotated box, cropped
        to it (implicit_shape_model.cpp:194-210, :300-320)."""
        for cid, iid, box in zip(class_ids, instance_ids, boxes):
            self._training.append((filename, int(cid), int(iid), box))

    def _check_trainable(self, fcfg: FeatureConfig, gcfg: FeatureConfig,
                         kp_params: KeypointParams) -> None:
        """Raise NotImplementedError, with the reason and its queue, for
        what the port does not train."""
        reasons = []
        why = train_unsupported(fcfg, kp_params)
        if why:
            reasons.append(why)
        if gcfg.type not in GLOBAL_DESCRIPTORS:
            reasons.append(f"global features {gcfg.type!r} (the port "
                           f"computes {', '.join(GLOBAL_DESCRIPTORS)}; the "
                           "whole-cloud globals are ROADMAP A15)")
        elif gcfg.type != "Dummy":
            why = train_unsupported(
                dataclasses.replace(gcfg, type=gcfg.local_type),
                KeypointParams())
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
        self._check_trainable(fcfg, gcfg, kp_params)
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
