"""Training and saving of an Implicit Shape Model (port of the training
half of point_cloud_donkey_tpu/models/ism.py: ``add_training_model``,
``train`` on the fused extraction route, ``save``).

train() (implicit_shape_model.cpp:252-500): load each model file (NaN
rows dropped) -> its box (AABB, or the box it was added with) and radius ->
local features through the fused extraction (models/detect_batch.py) ->
Uniform ranking (keeps all) -> Clustering None (one codeword per feature)
-> codebook activation on the device-resident descriptors
(models/codebook.py) -> per-class mean radius and box median.  Stage wall
times go to ``processing_times`` under the JAX package's ``train_*`` keys.

The configuration is checked up front: what the fused route cannot train
(preprocessing, MVBB boxes, global features and the SVM, other ranking
or clustering types, feature caching, several devices) raises
NotImplementedError with the reason before any cloud is read.  Because
only Clustering None and Uniform ranking are ported, the codewords are
always the features themselves and the activation always runs on the
descriptors that the extraction left on the device (the JAX package
decides that after the feature pass, models/ism.py:716).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.geometry import BoundingBox, quat_to_matrix_np
from ..utils.config import IsmConfig
from ..utils.io import PointCloud, read_cloud
from .clustering import run_clustering
from .codebook import CodebookParams, TrainedCodebook, train_codebook
from .detect_batch import (FusedChunk, extract_features_fused_train,
                           train_fused_ineligible)
from .features import FeatureConfig
from .keypoints import KeypointParams
from .ranking import rank_features
from .types import FeatureSet

# train() loads and extracts MODEL_CHUNK files at a time, so host memory
# holds O(chunk) clouds
MODEL_CHUNK = 128
TRAIN_STAGES = ("train_load", "train_features", "train_global",
                "train_ranking", "train_clustering", "train_activation",
                "train_rest")
# a crop of a box-annotated scene below this many points is skipped by the
# JAX package (implicit_shape_model.cpp:314-318)
MIN_CROP_POINTS = 500
_PREPROCESSING = ("UseStatisticalOutlierRemoval", "UseRadiusOutlierRemoval",
                  "UseSmoothing", "UseVoxelFiltering")


@dataclass
class TrainedState:
    codebook: TrainedCodebook
    dims_map: Dict[int, Tuple[float, float]]      # class -> (radius, median)
    variance_map: Dict[int, Tuple[float, float]]
    instance_to_class: Dict[int, int] = field(default_factory=dict)


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

    def _check_trainable(self, fcfg: FeatureConfig) -> None:
        """Raise NotImplementedError, with the reason, for what the port
        does not train."""
        root = self.root
        asked = [k for k in _PREPROCESSING if root.get(k, False)]
        if root.get("CutoffDistanceZAxis", 0.0) > 0:
            asked.append("CutoffDistanceZAxis")
        reasons = [f"preprocessing ({', '.join(asked)})"] if asked else []
        if root.get("BoundingBoxType", "MVBB") != "AABB" and any(
                box is None for *_, box in self._training):
            reasons.append(f"BoundingBoxType "
                           f"{root.get('BoundingBoxType', 'MVBB')!r} "
                           "(AABB only)")
        gtype = self.config.child("GlobalFeatures").type or "Dummy"
        if gtype != "Dummy":
            reasons.append(f"global features ({gtype!r})")
        if root.get("UseSvmTraining", False):
            reasons.append("the global-feature SVM (UseSvmTraining)")
        if root.get("CacheFeatures", False):
            reasons.append("CacheFeatures")
        mesh = root.get("UseDeviceMesh", "Auto")
        if mesh is True or str(mesh).lower() == "true":
            reasons.append("UseDeviceMesh (training on several devices)")
        ranking = self.config.child("FeatureWeighting").type or "Uniform"
        if ranking != "Uniform":
            reasons.append(f"FeatureWeighting {ranking!r} (Uniform only)")
        clustering = self.config.child("Clustering").type or "None"
        if clustering != "None":
            reasons.append(f"Clustering {clustering!r} (None only)")
        why = train_fused_ineligible(
            fcfg, KeypointParams.from_config(self.config.child("Keypoints")),
            [], self.root.get("ConsistentNormalsMethod", 2))
        if why:
            reasons.append(why)
        if reasons:
            raise NotImplementedError(
                "the port trains on the fused extraction route only; this "
                f"config asks for: {'; '.join(reasons)}")

    def _load(self, filename: str, gt_box: Optional[BoundingBox]
              ) -> Tuple[PointCloud, BoundingBox]:
        cloud = read_cloud(filename).remove_nan()
        if gt_box is not None:
            cloud = _crop_box(cloud, gt_box)
            if len(cloud.xyz) < MIN_CROP_POINTS:
                raise NotImplementedError(
                    f"{filename}: the box crop holds {len(cloud.xyz)} points "
                    f"(< {MIN_CROP_POINTS}); skipping such crops is not "
                    "ported")
            return cloud, gt_box
        mn, mx = cloud.xyz.min(axis=0), cloud.xyz.max(axis=0)
        return cloud, BoundingBox(
            position=(mn + (mx - mn) / 2.0).astype(np.float32),
            size=(mx - mn).astype(np.float32),
            quat=np.array([1.0, 0.0, 0.0, 0.0], np.float32))

    def train(self) -> None:
        tt = {k: 0.0 for k in TRAIN_STAGES}
        t_all = time.perf_counter()
        fcfg = FeatureConfig.from_config(self.config.child("Features"))
        kp_params = KeypointParams.from_config(self.config.child("Keypoints"))
        normal_radius = self.root.get("NormalRadius", 0.05)
        cn_method = self.root.get("ConsistentNormalsMethod", 2)
        cb_params = CodebookParams.from_config(self.config.child("Codebook"))
        self._check_trainable(fcfg)
        set_color_to_zero = self.root.get("SetColorToZero", False)

        features_per_model: List[FeatureSet] = []
        class_per_model: List[int] = []
        instance_per_model: List[int] = []
        boxes_per_model: List[BoundingBox] = []
        radii_per_model: List[float] = []
        dev_cache: List[FusedChunk] = []

        for base in range(0, len(self._training), MODEL_CHUNK):
            t0 = time.perf_counter()
            xyzs, rgbs, normals = [], [], []
            for filename, class_id, instance_id, gt_box in \
                    self._training[base:base + MODEL_CHUNK]:
                cloud, box = self._load(filename, gt_box)
                xyz = cloud.xyz
                centroid = xyz.mean(axis=0)
                xyzs.append(xyz)
                rgbs.append(None if set_color_to_zero else cloud.rgb)
                normals.append(cloud.normals if cloud.has_normals()
                               else None)
                class_per_model.append(class_id)
                instance_per_model.append(instance_id)
                boxes_per_model.append(box)
                radii_per_model.append(
                    float(np.linalg.norm(xyz - centroid, axis=1).max()))
            why = train_fused_ineligible(fcfg, kp_params, normals, cn_method)
            if why:
                raise NotImplementedError(
                    f"the port trains on the fused extraction route only: "
                    f"{why}")
            tt["train_load"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            gbase = len(features_per_model)
            chunk_cache: List[FusedChunk] = []
            features_per_model.extend(extract_features_fused_train(
                xyzs, rgbs, fcfg, kp_params, normal_radius, cn_method,
                len(xyzs), self.device, self.lrf_version, chunk_cache))
            # cache rows index the slice's clouds: make them model indices
            dev_cache.extend(e._replace(chunk=[gbase + j for j in e.chunk])
                             for e in chunk_cache)
            tt["train_features"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        order = sorted(range(len(features_per_model)),
                       key=lambda i: class_per_model[i])
        all_desc = np.concatenate(
            [features_per_model[i].descriptors for i in order], axis=0)
        keep = rank_features(all_desc, self.config.child(
            "FeatureWeighting").type or "Uniform")
        ranked_models: List[FeatureSet] = []
        off = 0
        for i in order:
            fs = features_per_model[i]
            n = fs.descriptors.shape[0]
            ranked_models.append(FeatureSet(*(np.asarray(a)[keep[off:off + n]]
                                              for a in fs)))
            off += n
        tt["train_ranking"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        all_desc_r = np.concatenate([f.descriptors for f in ranked_models], 0)
        all_pos_r = np.concatenate([f.positions for f in ranked_models], 0)
        centers, _ = run_clustering(all_desc_r, self.config.child(
            "Clustering").type or "None")
        cw_pos = all_pos_r[:len(centers)]
        tt["train_clustering"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        codebook = train_codebook(
            ranked_models, [class_per_model[i] for i in order],
            [instance_per_model[i] for i in order],
            [boxes_per_model[i] for i in order], centers, cw_pos, cb_params,
            self.metric, _device_rows(dev_cache, order))
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
        self.state = TrainedState(codebook=codebook, dims_map=dims_map,
                                  variance_map=var_map)
        tt["train_rest"] = time.perf_counter() - t0
        tt["train_complete"] = time.perf_counter() - t_all
        self.processing_times.update(tt)

    def save(self, path: str) -> None:
        """Write `<path>` (the .ism JSON config) and `<path>d.npz` (the
        trained arrays) in the JAX package's format: its
        ``ImplicitShapeModel.load`` and the port's ``load_codebook`` read
        them."""
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


def _device_rows(cache: List[FusedChunk], model_order: List[int]
                 ) -> torch.Tensor:
    """The descriptors the extraction left on the device (the JAX
    ``build_device_activation``): the kept rows gathered in the class-major
    model order that train() concatenates them in."""
    by_cloud = {}
    for e_id, e in enumerate(cache):
        for r, ci in enumerate(e.chunk):
            by_cloud[ci] = (e_id, r)
    parts = []
    for ci in model_order:
        e_id, r = by_cloud[ci]
        e = cache[e_id]
        rows = torch.from_numpy(np.nonzero(e.keep[r])[0]).to(e.desc.device)
        parts.append(e.desc[r].index_select(0, rows))
    return torch.cat(parts)
