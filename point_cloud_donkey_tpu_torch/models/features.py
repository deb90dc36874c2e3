"""Descriptor configuration, cloud padding, the training extraction's
chunk helpers and normals, and the global features (port of
``FeatureConfig``, ``bucket_size``, ``pad_cloud``,
``compute_cloud_normals`` and ``extract_global_features`` of
point_cloud_donkey_tpu/models/features.py, for every descriptor of the
JAX package).

:func:`compute_cloud_normals` gives the normals of the JAX staged route
(normals provided by the cloud files, ConsistentNormalsMethod 3's EMST
orientation on the host) to the training extraction
(models/detect_batch.py).

A global descriptor (:func:`extract_global_features`) is the local
descriptor at the cloud's centroid with the cloud's radius, so every point
of the cloud is a neighbour; its LRF is taken at the centroid with
ReferenceFrameRadius, and a colour descriptor's keypoint colour is the
cloud's mean colour.  The descriptor kernels take one radius a launch, so
each cloud is one launch of K7, K8 or K9 (with its K1 / K2 LRF).

The descriptors outside the SHOT family read fixed-capacity neighbour
gathers (ops/neighbors.gather_radius_neighbors) of min(TpuNeighborCapacity,
N) neighbours, N the padded cloud (a global descriptor: all of them), FPFH
at most 128 and PFH at most 64 (the JAX `_descriptor_fn`).  NARF (its own
keypoints on a range image) and GASD as a local feature (one whole-cloud
row) run one cloud at a time (:func:`narf_features`,
:func:`gasd_local_features`).  The whole-cloud globals -- ESF, VFH, GRSD,
GASD (one row a cloud) and CVFH / OURCVFH (one a smooth region) -- run a
chunk of clouds at a time, with the normals of the JAX batch route
(ConsistentNormalsMethod 3 oriented by EMST; CVFH reads the curvature of
its normal stage and a cloud's own normals where it has them).

Scene scale (above ``ops.tiled.SCENE_TILE_THRESHOLD`` points, read at call
time): :func:`scene_normals` and :func:`extract_local_features_scene` (the
JAX ``_compute_normals_scene`` and ``_extract_local_features_scene``) sort
the cloud once along its longest axis and run every [Q, N] stage on the
windows of ops/tiled.py: the normals in NORMALS_CHUNK queries, the voxel
grid (and its culling, models/keypoints.py) on the sorted cloud, so the
keypoints' float sums are the JAX package's, then the keypoints sorted
along the same axis in KEYPOINT_CHUNK chunks, planned at max(Radius,
ReferenceFrameRadius) with a window of at least 4096 points -- twice that
radius for FPFH and RIFT, whose neighbours' own neighbourhoods take
part: each group of chunks is one batch of K1 / K2 (the LRFs) and K7 / K8
/ K9 (the descriptor) over the chunks' window slabs.  A scene's global descriptor
takes its normals from the same tiled route; its one centroid keypoint
stays dense.
"""

from __future__ import annotations

from dataclasses import dataclass
import functools
import math
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import tiled
from ..ops.cospair import cospair_descriptor
from ..ops.descriptors_misc import (bshot_binarize, pfh_descriptor,
                                    spin_image_descriptor)
from ..ops.fpfh import fpfh_descriptor
from ..ops.cvfh import cvfh_descriptors
from ..ops.global_descriptors import (esf_descriptor, gasd_descriptor,
                                      grsd_descriptor, vfh_descriptor)
from ..ops.narf import build_range_image, narf_descriptor, narf_keypoints
from ..ops.cgf import CgfEmbedding, cgf_descriptor, default_checkpoint_path
from ..ops.lrf import board_lrf, flare_lrf, shot_lrf, shot_na_lrf
from ..ops.neighbors import full_fp32, gather_radius_neighbors, gather_rows
from ..ops.rops import rops_descriptor
from ..ops.shape_context import (intensity_gradients, rift_descriptor,
                                 rsd_descriptor, shape_context_descriptor)
from ..ops.normals import compute_normals, orient_emst
from ..ops.kernels.shot_fused import shot_descriptor_fused
from ..ops.shot import cshot_descriptor_dense
from ..ops.short_shot import (resolve_bins, resolve_color_bins,
                               short_cshot_descriptor,
                               short_shot_descriptor_dense)
from ..utils.config import ComponentConfig
from .types import FeatureSet, make_feature_set

# the local descriptors (NARF and GASD: one cloud at a time,
# :func:`narf_features`, :func:`gasd_local_features`)
DESCRIPTORS = ("SHOT", "CSHOT", "SHORT_SHOT", "SHORT_CSHOT", "FPFH",
               "BSHOT", "SHORT_SHOT_PCL", "SpinImage", "PFH", "3DSC", "USC",
               "RSD", "RIFT", "RoPS", "COSPAIR", "ESF_LOCAL", "CGF", "NARF",
               "GASD")
PER_CLOUD_DESCRIPTORS = ("NARF", "GASD")
# whole-cloud descriptors (one row a cloud; CVFH / OURCVFH one a region)
WHOLE_CLOUD_GLOBALS = ("ESF", "VFH", "GRSD", "GASD")
GLOBAL_DESCRIPTORS = ("Dummy", "SHOT_GLOBAL", "CSHOT_GLOBAL",
                      "SHORT_SHOT_GLOBAL", "SHORT_CSHOT_GLOBAL",
                      "USC_GLOBAL", "CVFH", "OURCVFH") + WHOLE_CLOUD_GLOBALS
# the types that read no normals (the JAX FeatureConfig.needs_normals)
NO_NORMALS = ("SHORT_SHOT", "SHORT_CSHOT", "SHORT_SHOT_PCL",
              "SHORT_SHOT_GLOBAL", "SHORT_CSHOT_GLOBAL", "ESF", "ESF_LOCAL",
              "GASD", "RoPS", "NARF", "Dummy")
DIMS = {"SHORT_SHOT_PCL": 352, "BSHOT": 352, "FPFH": 33, "SpinImage": 153,
        "PFH": 125, "ESF": 640, "ESF_LOCAL": 640, "VFH": 308, "CVFH": 308,
        "OURCVFH": 308, "GRSD": 21, "3DSC": 1980, "USC": 1980,
        "USC_GLOBAL": 1980, "RIFT": 32, "COSPAIR": 378, "RoPS": 135,
        "NARF": 36, "Dummy": 1}
# FPFH's neighbourhoods gather at most this many points, PFH's this many
FPFH_CAPACITY = 128
PFH_CAPACITY = 64


def bucket_size(n: int, minimum: int = 256) -> int:
    """The next power of two at or above n (at least `minimum`); above 64k,
    the next multiple of 32768."""
    b = minimum
    while b < n and b < 65536:
        b *= 2
    if n <= b:
        return b
    return -(-n // 32768) * 32768


@dataclass(frozen=True)
class FeatureConfig:
    """The ``Features`` component of an .ism config (the fields of the JAX
    FeatureConfig that the port's descriptors read)."""
    type: str = "SHOT"
    radius: float = 0.1
    ref_frame_radius: float = 0.2
    ref_frame_type: str = "SHOT"
    # SHORT_SHOT (features_short_shot.cpp:23-31)
    short_shot_dims: int = 32
    short_shot_bin_type: str = "auto"
    short_shot_r_bins: int = 2
    short_shot_e_bins: int = 2
    short_shot_a_bins: int = 8
    short_shot_log_radius: bool = False
    short_shot_min_radius: float = 0.0
    use_min_radius: bool = False
    # SHORT_CSHOT (features_short_cshot.cpp:23-34)
    short_color_shot_dims: int = 32
    short_color_hist_size: int = 15
    # CGF (features_cgf.cpp:24-52): the embedding's .npz (the shipped one
    # where empty) and its output width
    cgf_checkpoint: str = ""
    cgf_output_dims: int = 32
    gasd_with_color: bool = True  # GasdWithColor (features_gasd.cpp)
    # CVFH / OURCVFH clustering (features_cvfh.cpp:47-53, PCL defaults)
    cvfh_cluster_tolerance: float = 0.015
    cvfh_eps_angle_deg: float = 10.0
    cvfh_curv_threshold: float = 1.0
    cvfh_min_points: int = 50
    ourcvfh_axis_ratio: float = 0.8
    rsd_use_hist: bool = True     # UseFullRSDHistogram (features_rsd.cpp)
    # NARF's range image (features_narf.cpp:44-53 hardcodes a Kinect's)
    narf_image_width: int = 640
    narf_image_height: int = 480
    narf_focal: float = 525.0
    # the gathers' capacity (TpuNeighborCapacity, not in the reference)
    neighbor_capacity: int = 2048

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "FeatureConfig":
        return cls(
            type=cfg.type or "SHOT",
            radius=cfg.get("Radius", 0.1),
            ref_frame_radius=cfg.get("ReferenceFrameRadius", 0.2),
            ref_frame_type=cfg.get("ReferenceFrameType", "SHOT"),
            short_shot_dims=cfg.get("ShortShotDims", 32),
            short_shot_bin_type=cfg.get("ShortShotBinType", "auto"),
            short_shot_r_bins=cfg.get("ShortShotRBins", 2),
            short_shot_e_bins=cfg.get("ShortShotEBins", 2),
            short_shot_a_bins=cfg.get("ShortShotABins", 8),
            short_shot_log_radius=cfg.get("ShortShotLogRadius", False),
            short_shot_min_radius=cfg.get("ShortShotMinRadius", 0.0),
            use_min_radius=cfg.get("UseMinRadius", False),
            short_color_shot_dims=cfg.get("ShortColorShotDims", 32),
            short_color_hist_size=cfg.get("ShortColorShotHistSize", 15),
            cgf_checkpoint=cfg.get("CgfCheckpointPath", ""),
            cgf_output_dims=cfg.get("CgfOutputDims", 32),
            gasd_with_color=cfg.get("GasdWithColor", True),
            cvfh_cluster_tolerance=cfg.get("CvfhClusterTolerance", 0.015),
            cvfh_eps_angle_deg=cfg.get("CvfhEpsAngle", 10.0),
            cvfh_curv_threshold=cfg.get("CvfhCurvatureThreshold", 1.0),
            cvfh_min_points=cfg.get("CvfhMinPoints", 50),
            ourcvfh_axis_ratio=cfg.get("OurcvfhAxisRatio", 0.8),
            rsd_use_hist=cfg.get("UseFullRSDHistogram", True),
            narf_image_width=cfg.get("NarfImageWidth", 640),
            narf_image_height=cfg.get("NarfImageHeight", 480),
            narf_focal=cfg.get("NarfFocalLength", 525.0),
            neighbor_capacity=cfg.get("TpuNeighborCapacity", 2048),
        )

    @property
    def local_type(self) -> str:
        """The local descriptor of a *_GLOBAL type (the type itself
        otherwise)."""
        return self.type[:-len("_GLOBAL")] if self.type.endswith("_GLOBAL") \
            else self.type

    def needs_normals(self) -> bool:
        return self.type not in NO_NORMALS

    def needs_rgb(self) -> bool:
        return self.local_type in ("CSHOT", "SHORT_CSHOT", "RIFT", "COSPAIR")

    def min_radius(self) -> float:
        """SHORT_*'s minimum radius: Radius * ShortShotMinRadius with
        UseMinRadius, else a tenth of Radius with the log radius, else 0
        (the JAX `_descriptor_fn`; a *_GLOBAL type scales the configured
        Radius, not the cloud's)."""
        if not self.local_type.startswith("SHORT_"):
            return 0.0
        if self.use_min_radius:
            return self.radius * self.short_shot_min_radius
        if self.short_shot_log_radius:
            return self.radius * 0.1
        return 0.0

    def color_bins(self) -> Tuple[int, int, int, int]:
        """(dims, r_bins, e_bins, a_bins) of SHORT_CSHOT's colour grid."""
        return resolve_color_bins(self.short_color_shot_dims)

    def short_shot_bins(self) -> Tuple[int, int, int, int]:
        """(dims, r_bins, e_bins, a_bins) of the SHORT_SHOT grid."""
        return resolve_bins(self.short_shot_dims, self.short_shot_bin_type,
                            self.short_shot_r_bins, self.short_shot_e_bins,
                            self.short_shot_a_bins)

    def descriptor_dim(self) -> int:
        if self.local_type == "SHOT":
            return 352
        if self.local_type == "CSHOT":
            return 1344
        if self.local_type == "SHORT_SHOT":
            return self.short_shot_bins()[0]
        if self.local_type == "SHORT_CSHOT":
            return self.short_shot_bins()[0] \
                + self.color_bins()[0] * self.short_color_hist_size
        if self.type == "GASD":
            return 984 if self.gasd_with_color else 512
        if self.type == "RSD":
            return 25 if self.rsd_use_hist else 2
        if self.type == "CGF":
            return self.cgf_output_dims
        if self.type in DIMS:
            return DIMS[self.type]
        raise ValueError(f"unsupported descriptor type {self.type!r}")


def pad_cloud(xyz: np.ndarray, bucket: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """A cloud padded to its bucket: (points [b, 3] with the padding parked
    at 1e9, mask [b])."""
    n = len(xyz)
    b = bucket or bucket_size(n)
    pts = np.zeros((b, 3), np.float32)
    pts[:n] = xyz
    pts[n:] = 1e9
    mask = np.zeros(b, bool)
    mask[:n] = True
    return pts, mask


def chunk_width(n_clouds: int) -> int:
    """Clouds of one extraction chunk: the JAX chunk width rule, 8 to 32."""
    return min(32, max(8, -(-n_clouds // 8) * 8))


def bucket_groups(clouds: Sequence[np.ndarray], width: int
                  ) -> List[Tuple[int, List[int]]]:
    """(bucket size, cloud indices) of each chunk: clouds grouped by bucket
    size, in order, each group cut into chunks of at most `width`."""
    groups = {}
    for i, xyz in enumerate(clouds):
        groups.setdefault(bucket_size(len(xyz)), []).append(i)
    return [(n, idxs[i:i + width]) for n, idxs in groups.items()
            for i in range(0, len(idxs), width)]


def padded_chunk(clouds: Sequence[np.ndarray], chunk: Sequence[int], n: int,
                 per_point: Optional[Sequence[Optional[np.ndarray]]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(points [b, n, 3] with the padding at 1e9, mask [b, n], the
    clouds' `per_point` arrays [b, n, 3] zero-padded, or None)."""
    pts = np.zeros((len(chunk), n, 3), np.float32)
    mask = np.zeros((len(chunk), n), bool)
    extra = None if per_point is None else \
        np.zeros((len(chunk), n, 3), np.float32)
    for r, ci in enumerate(chunk):
        pts[r], mask[r] = pad_cloud(clouds[ci], bucket=n)
        if extra is not None:
            extra[r, :len(clouds[ci])] = per_point[ci]
    return pts, mask, extra


def compute_cloud_normals(clouds: Sequence[np.ndarray],
                          normals_list: Sequence[Optional[np.ndarray]],
                          chunk: Sequence[int], pts: torch.Tensor,
                          mask: torch.Tensor, normal_radius: float,
                          method: int, lrf_version: int = 1,
                          emst: bool = True) -> torch.Tensor:
    """The normals [b, n, 3] of a padded chunk of clouds (the JAX
    ``compute_cloud_normals`` / ``_batch_normals``): a cloud's provided
    normals as given (the reference's normal check,
    implicit_shape_model.cpp:374-384), the others from
    ``ops/normals.compute_normals`` under `method` -- with `emst`, method 3
    as method 0's PCA normals oriented by :func:`orient_emst` on the host
    (the local features); without, the PCA normal as it comes (the JAX
    global features' normal stage).  Padding rows are zero."""
    provided = [normals_list[ci] is not None
                and len(normals_list[ci]) == len(clouds[ci]) for ci in chunk]
    orient = emst and method == 3
    comp = None
    if not all(provided):
        comp = compute_normals(pts, mask, normal_radius,
                               0 if orient else method,
                               lrf_version).normals.cpu().numpy()
    out = np.zeros(tuple(pts.shape), np.float32)
    for r, ci in enumerate(chunk):
        m = len(clouds[ci])
        if provided[r]:
            out[r, :m] = normals_list[ci]
        elif orient:
            out[r, :m] = orient_emst(clouds[ci], comp[r, :m])
        else:
            out[r, :m] = comp[r, :m]
    return torch.from_numpy(out).to(pts.device)


def reference_frames(fcfg: FeatureConfig, kp, kpm, pts, nrm, mask,
                     lrf_version: int = 1):
    """The LRFs [B, K] at ReferenceFrameRadius of ReferenceFrameType (the
    JAX `_descriptor_fn`): SHOTNA, FLARE (its tangent radius a fifth of
    the frame radius) and BOARD in plain torch (ops/lrf.py), SHOT -- and
    any other name -- through K1 / K2."""
    rf, r = fcfg.ref_frame_type, fcfg.ref_frame_radius
    if rf == "SHOTNA":
        return shot_na_lrf(kp, kpm, pts, nrm, mask, r)
    if rf == "FLARE":
        return flare_lrf(kp, kpm, pts, nrm, mask, r,
                         float(np.float32(r) / np.float32(5.0)))
    if rf == "BOARD":
        return board_lrf(kp, kpm, pts, nrm, mask, r)
    return shot_lrf(kp, kpm, pts, mask, r, lrf_version=lrf_version)


@functools.lru_cache(maxsize=8)
def cgf_embedding(checkpoint: str, out_dims: int,
                  device: str) -> CgfEmbedding:
    """CGF's embedding on `device` (the JAX `_descriptor_fn`): the
    CgfCheckpointPath .npz, which must exist, else the shipped one, else
    -- with a warning -- the seeded random projection to `out_dims`."""
    if checkpoint:
        return CgfEmbedding.from_npz(checkpoint, device)
    shipped = default_checkpoint_path()
    if os.path.exists(shipped):
        return CgfEmbedding.from_npz(shipped, device)
    warnings.warn("CGF: no checkpoint (CgfCheckpointPath empty and the "
                  "shipped cgf_embedding.npz is missing) -- falling back to "
                  "a seeded random projection; descriptors are NOT "
                  "comparable to trained CGF. Train one with python -m "
                  "point_cloud_donkey_tpu_torch.train_cgf_embedding")
    return CgfEmbedding.random_projection(out_dims, device=device)


def local_descriptors(fcfg: FeatureConfig, kp, kpm, kp_rgb, pts, nrm, rgb,
                      mask, radius: float, lrf_version: int = 1,
                      capacity: Optional[int] = None):
    """(descriptors [B, K, D], valid [B, K], frames [B, K, 3, 3]) of the
    keypoint rows `kp` [B, K, 3] (live where `kpm`) against their clouds
    [B, N]: the LRFs of ReferenceFrameType (:func:`reference_frames`),
    then the descriptor of `fcfg`'s local type at `radius`: SHOT, BSHOT
    (SHOT binarised) and SHORT_SHOT_PCL (SHOT with zero normals) through
    K7, CSHOT through K8, SHORT_SHOT through K9, the others over gathers
    of min(`capacity`, N) neighbours, `capacity` TpuNeighborCapacity
    unless given (FPFH at most 128, PFH at most 64; the JAX
    `_descriptor_fn`).  CGF takes its own SHOT LRF at 0.75 x `radius`
    (K1 / K2, features_cgf.cpp:52), whatever ReferenceFrameType says, and
    returns those frames.  A keypoint's normal (SpinImage's axis,
    COSPAIR's, CGF's frame flip) is its nearest neighbour's; RIFT's
    intensity the mean of the RGB channels.  valid also requires a finite
    descriptor; only the SHOT family, the shape contexts and the *_GLOBAL
    forms require a valid frame, as in the JAX package."""
    base = fcfg.local_type
    if base == "CGF":
        lrf = shot_lrf(kp, kpm, pts, mask,
                       float(np.float32(0.75) * np.float32(radius)),
                       lrf_version=lrf_version)
    else:
        lrf = reference_frames(fcfg, kp, kpm, pts, nrm, mask, lrf_version)
    cap = min(fcfg.neighbor_capacity if capacity is None else capacity,
              pts.shape[1])
    if base in ("SHOT", "BSHOT", "SHORT_SHOT_PCL"):
        desc, valid = shot_descriptor_fused(
            kp, lrf.frames, lrf.valid, pts,
            torch.zeros_like(nrm) if base == "SHORT_SHOT_PCL" else nrm, mask,
            radius)
        if base == "BSHOT":
            desc = bshot_binarize(desc)
    elif base == "CSHOT":
        desc, valid = cshot_descriptor_dense(kp, kp_rgb, lrf.frames,
                                             lrf.valid, pts, nrm, rgb, mask,
                                             radius)
    elif base == "SHORT_SHOT":
        _, rb, eb, ab = fcfg.short_shot_bins()
        desc, valid = short_shot_descriptor_dense(
            kp, lrf.frames, lrf.valid, pts, mask, radius, rb, eb, ab,
            fcfg.min_radius(), fcfg.short_shot_log_radius)
    elif base == "FPFH":
        desc, valid = fpfh_descriptor(kp, kpm, pts, nrm, mask, radius,
                                      capacity=min(cap, FPFH_CAPACITY))
    elif base == "PFH":
        nbr = gather_radius_neighbors(kp, pts, mask, radius,
                                      min(cap, PFH_CAPACITY))
        desc, valid = pfh_descriptor(kp, kpm, pts, nrm, nbr)
    else:
        nbr = gather_radius_neighbors(kp, pts, mask, radius, cap)
        desc, valid = _gathered_descriptor(fcfg, base, kp, kpm, kp_rgb, lrf,
                                           pts, nrm, rgb, mask, nbr, radius)
    return desc, valid & torch.isfinite(desc).all(-1), lrf.frames


def _gathered_descriptor(fcfg, base, kp, kpm, kp_rgb, lrf, pts, nrm, rgb,
                         mask, nbr, radius):
    """The descriptors of :func:`local_descriptors` over one gather."""
    if base == "SHORT_CSHOT":
        _, rb, eb, ab = fcfg.short_shot_bins()
        _, crb, ceb, cab = fcfg.color_bins()
        return short_cshot_descriptor(
            kp, kp_rgb, lrf.frames, lrf.valid, pts, rgb, nbr, radius, rb, eb,
            ab, crb, ceb, cab, fcfg.short_color_hist_size, fcfg.min_radius(),
            fcfg.short_shot_log_radius)
    if base in ("3DSC", "USC"):
        return shape_context_descriptor(kp, lrf.frames, lrf.valid, pts, nbr,
                                        radius)
    if base == "RSD":
        return rsd_descriptor(kp, kpm, pts, nrm, nbr, radius,
                              use_hist=fcfg.rsd_use_hist)
    if base == "RoPS":
        return rops_descriptor(kp, kpm, pts, nbr, radius)
    if base == "RIFT":
        grads = intensity_gradients(pts, nrm, rgb.mean(-1), mask, radius)
        return rift_descriptor(kp, kpm, pts, grads, nbr, radius)
    if base == "ESF_LOCAL":
        # ESF over each keypoint's neighbourhood
        # (features_esf_local.cpp:36-83)
        b, k, m = nbr.idx.shape
        sub = gather_rows(pts, nbr.idx).reshape(b * k, m, 3)
        desc = esf_descriptor(sub, nbr.valid.reshape(b * k, m))
        return desc.reshape(b, k, -1), kpm & (nbr.valid.sum(-1) >= 3)
    kp_nrm = gather_rows(nrm, nbr.idx[..., 0])
    if base == "SpinImage":
        return spin_image_descriptor(kp, kp_nrm, kpm, pts, nbr, radius)
    if base == "COSPAIR":
        return cospair_descriptor(kp, kp_nrm, kpm, pts, nrm, rgb, nbr,
                                  radius)
    if base == "CGF":
        return cgf_descriptor(kp, kp_nrm, lrf.frames, lrf.valid, pts, nbr,
                              radius, cgf_embedding(
                                  fcfg.cgf_checkpoint, fcfg.cgf_output_dims,
                                  str(pts.device)))
    raise ValueError(f"unsupported descriptor type {fcfg.type!r}")


def scene_normals(xyz: np.ndarray, normals_in: Optional[np.ndarray],
                  normal_radius: float, method: int, device: torch.device,
                  lrf_version: int = 1, emst: bool = True) -> np.ndarray:
    """A scene's normals [N, 3] (the JAX ``compute_cloud_normals`` above
    the threshold): provided ones as given, else sorted along the longest
    axis, the tiled normals of ConsistentNormalsMethod `method` (with
    `emst`, method 3 as method 0's PCA normals oriented by
    :func:`orient_emst` on the host), un-permuted."""
    if normals_in is not None and len(normals_in) == len(xyz):
        return np.asarray(normals_in, np.float32)
    tiled.check_lrf_version(lrf_version)
    n_real = len(xyz)
    axis = tiled.sort_key_axis(xyz)
    order = np.argsort(xyz[:, axis], kind="stable")
    xyz_s = xyz[order]
    pts, mask = pad_cloud(xyz_s)   # the padding at 1e9 keeps the order
    key = pts[:, axis]
    plan = tiled.plan_tiles(key, mask, key, normal_radius,
                            tiled.NORMALS_CHUNK)
    orient = emst and method == 3
    with full_fp32():
        res = tiled.tiled_compute_normals(
            torch.from_numpy(pts).to(device),
            torch.from_numpy(mask).to(device), plan, normal_radius,
            0 if orient else method, lrf_version)
    nrm_s = res.normals.cpu().numpy()[:n_real]
    if orient:
        nrm_s = orient_emst(xyz_s, nrm_s).astype(np.float32)
    out = np.empty_like(nrm_s)
    out[order] = nrm_s
    return out


def extract_local_features_scene(
        xyz: np.ndarray, normals: Optional[np.ndarray],
        rgb: Optional[np.ndarray], fcfg: FeatureConfig, kp_params,
        normal_radius: float, consistent_normals_method: int,
        device: torch.device, lrf_version: int = 1,
        is_training: bool = False,
        times: Optional[Dict[str, float]] = None):
    """One scene's local features (module docstring): (the compact feature
    set, the descriptors of every keypoint row [1, K, D] on the device with
    zeros where not kept, keep [1, K] on the host).  `times` accumulates
    the normals and keypoints stages' wall times."""
    from .keypoints import culling_needs_normals, detect_keypoints
    tiled.check_lrf_version(lrf_version)
    axis = tiled.sort_key_axis(xyz)
    order = np.argsort(xyz[:, axis], kind="stable")
    xyz_s = np.ascontiguousarray(xyz[order], np.float32)
    normals_s = None if normals is None else np.asarray(normals)[order]
    rgb_s = None if rgb is None else np.asarray(rgb, np.float32)[order]
    if fcfg.needs_rgb() and rgb_s is None:
        raise ValueError(f"{fcfg.type} needs RGB data but the cloud has none")

    cloud_normals = None
    if fcfg.needs_normals() or culling_needs_normals(kp_params,
                                                     is_training):
        t0 = time.perf_counter()
        cloud_normals = scene_normals(xyz_s, normals_s, normal_radius,
                                      consistent_normals_method, device,
                                      lrf_version)
        if times is not None:
            times["normals"] = times.get("normals", 0.0) \
                + time.perf_counter() - t0

    t0 = time.perf_counter()
    with full_fp32():
        kp, kp_rgb = detect_keypoints(xyz_s, cloud_normals, rgb_s, kp_params,
                                      device, is_training)
    if times is not None:
        times["keypoints"] = times.get("keypoints", 0.0) \
            + time.perf_counter() - t0

    # the keypoints sorted along the same axis: chunks get tight windows
    kp_order = np.argsort(kp[:, axis], kind="stable")
    kp = kp[kp_order]
    if kp_rgb is not None:
        kp_rgb = kp_rgb[kp_order]
    pts, mask = pad_cloud(xyz_s)
    n = pts.shape[0]
    chunk = tiled.KEYPOINT_CHUNK
    n_chunks = max(1, -(-len(kp) // chunk))
    k_bucket = n_chunks * chunk
    kp_pad = np.full((k_bucket, 3), 1e9, np.float32)
    kp_pad[:len(kp)] = kp
    kp_mask = np.zeros(k_bucket, bool)
    kp_mask[:len(kp)] = True
    margin = 2.0 if fcfg.type in ("FPFH", "RIFT") else 1.0
    plan = tiled.plan_tiles(kp_pad[:, axis], kp_mask, pts[:, axis],
                            margin * max(fcfg.radius, fcfg.ref_frame_radius),
                            chunk, min_window=4096)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    nrm = np.zeros((n, 3), np.float32)
    if fcfg.needs_normals() and cloud_normals is not None:
        nrm[:len(xyz_s)] = cloud_normals
    rgb_p = np.zeros((n, 3), np.float32)
    kp_rgb_p = np.zeros((k_bucket, 3), np.float32)
    if fcfg.needs_rgb():
        rgb_p[:len(xyz_s)] = rgb_s
        if kp_rgb is not None:
            kp_rgb_p[:len(kp)] = kp_rgb
    pts_d, mask_d, nrm_d, rgb_d = dev(pts), dev(mask), dev(nrm), dev(rgb_p)
    kp_d, kpm_d, kprgb_d = dev(kp_pad), dev(kp_mask), dev(kp_rgb_p)
    d = fcfg.descriptor_dim()

    def inner(qs, ps):
        q, qm, qr = qs
        p, pm, pn, pr = ps
        desc, valid, frames = local_descriptors(
            fcfg, q, qm, qr if fcfg.needs_rgb() else None, p, pn,
            pr if fcfg.needs_rgb() else None, pm, fcfg.radius, lrf_version)
        return desc, valid & qm, frames

    with full_fp32():
        desc, keep, frames = tiled.map_chunks(
            inner, (kp_d, kpm_d, kprgb_d), (1e9, False, 0.0),
            (pts_d, mask_d, nrm_d, rgb_d), plan, q_valid=kpm_d,
            row_bytes=40)
        desc = torch.where(keep[:, None], desc, torch.zeros_like(desc))
    packed = torch.cat([desc, frames.reshape(-1, 9),
                        keep[:, None].to(desc.dtype)], 1).cpu().numpy()
    keep_h = packed[:, d + 9] > 0
    centroid = xyz.mean(axis=0)
    center_dist = np.linalg.norm(kp_pad - centroid, axis=1)
    fs = make_feature_set(packed[:, :d], kp_pad,
                          packed[:, d:d + 9].reshape(-1, 3, 3), keep_h,
                          center_dist).compact()
    return fs, desc[None], keep_h[None]


def narf_features(xyz: np.ndarray, fcfg: FeatureConfig,
                  device: torch.device) -> FeatureSet:
    """A cloud's NARF features (the JAX ``_narf_features``): its own
    keypoints on the range image of NarfImageWidth x NarfImageHeight at
    NarfFocalLength, support Radius, identity frames, compact."""
    img, _ = build_range_image(xyz, fcfg.narf_image_width,
                               fcfg.narf_image_height, fcfg.narf_focal)
    img_d = torch.from_numpy(img).to(device)
    kp = narf_keypoints(img_d, float(fcfg.radius), focal=fcfg.narf_focal)
    desc, valid = narf_descriptor(img_d, kp, float(fcfg.radius),
                                  focal=fcfg.narf_focal)
    k = desc.shape[0]
    return make_feature_set(desc.cpu().numpy(), kp.xyz.cpu().numpy(),
                            np.tile(np.eye(3, dtype=np.float32), (k, 1, 1)),
                            valid.cpu().numpy()).compact()


def gasd_local_features(xyz: np.ndarray, rgb: Optional[np.ndarray],
                        fcfg: FeatureConfig, kp_params,
                        device: torch.device, lrf_version: int = 1,
                        is_training: bool = False) -> FeatureSet:
    """GASD as the local descriptor (the JAX ``_gasd_local_features``):
    one whole-cloud GASD row at the first keypoint with a valid SHOT LRF
    (the first keypoint when none has one), with that LRF
    (features_gasd.cpp:34-100, features.cpp:98-115)."""
    from .keypoints import detect_keypoints
    if fcfg.gasd_with_color and rgb is None:
        raise ValueError("GASD with color needs RGB data "
                         "(set GasdWithColor false)")
    with full_fp32():
        kp, _ = detect_keypoints(xyz, None, rgb, kp_params, device,
                                 is_training)
    pts, mask = pad_cloud(xyz)
    kb = bucket_size(max(len(kp), 1), minimum=64)
    kp_pad = np.full((kb, 3), 1e9, np.float32)
    kp_pad[:len(kp)] = kp
    kp_mask = np.arange(kb) < len(kp)
    pts_d = torch.from_numpy(pts).to(device)[None]
    mask_d = torch.from_numpy(mask).to(device)[None]
    with full_fp32():
        lrf = shot_lrf(torch.from_numpy(kp_pad).to(device)[None],
                       torch.from_numpy(kp_mask).to(device)[None], pts_d,
                       mask_d, fcfg.ref_frame_radius, lrf_version=lrf_version)
        rgb_d = None
        if fcfg.gasd_with_color:
            rgb_p = np.zeros((len(pts), 3), np.float32)
            rgb_p[:len(xyz)] = rgb
            rgb_d = torch.from_numpy(rgb_p).to(device)[None]
        desc = gasd_descriptor(pts_d, mask_d, rgb_d).cpu().numpy()
    ok = lrf.valid[0].cpu().numpy() & kp_mask
    first = int(np.argmax(ok)) if ok.any() else 0
    cd = np.linalg.norm(kp_pad[first] - xyz.mean(axis=0), keepdims=True)
    return make_feature_set(desc, kp_pad[first][None],
                            lrf.frames[0, first][None].cpu().numpy(),
                            np.isfinite(desc).all(1),
                            cd.astype(np.float32)).compact()


def _global_set(desc: np.ndarray, xyz: np.ndarray) -> FeatureSet:
    """A whole-cloud feature set (not compacted, as the JAX package's):
    the rows at the centroid with identity frames, valid where finite,
    ``global_radius`` the cloud radius."""
    g = desc.shape[0]
    centroid = xyz.mean(axis=0).astype(np.float32)
    radius = float(np.linalg.norm(xyz - centroid, axis=1).max())
    return make_feature_set(
        desc, np.tile(centroid, (g, 1)),
        np.tile(np.eye(3, dtype=np.float32), (g, 1, 1)),
        np.isfinite(desc).all(1), np.zeros(g, np.float32),
        np.full(g, radius, np.float32))


def _whole_cloud_chunk(clouds, normals_list, rgb_list, chunk, n, gcfg,
                       normal_radius, cn_method, device, lrf_version):
    """[b, D] ESF / VFH / GRSD / GASD of a chunk of clouds padded to n (the
    JAX ``_whole_cloud_fn`` batched): normals as the JAX
    ``_batch_normals`` gives them (method 3 oriented by EMST), GRSD at the
    configured Radius."""
    color = gcfg.type == "GASD" and gcfg.gasd_with_color
    pts_b, mask_b, rgb_b = padded_chunk(clouds, chunk, n,
                                        rgb_list if color else None)
    pts = torch.from_numpy(pts_b).to(device)
    mask = torch.from_numpy(mask_b).to(device)
    with full_fp32():
        if gcfg.type == "ESF":
            return esf_descriptor(pts, mask)
        if gcfg.type == "GASD":
            return gasd_descriptor(
                pts, mask,
                None if rgb_b is None else torch.from_numpy(rgb_b).to(device))
        if n > tiled.SCENE_TILE_THRESHOLD:
            nrm_b = np.zeros(pts_b.shape, np.float32)
            for r, ci in enumerate(chunk):
                nrm_b[r, :len(clouds[ci])] = scene_normals(
                    clouds[ci], normals_list[ci], normal_radius, cn_method,
                    device, lrf_version)
            nrm = torch.from_numpy(nrm_b).to(device)
        else:
            nrm = compute_cloud_normals(clouds, normals_list, chunk, pts,
                                        mask, normal_radius, cn_method,
                                        lrf_version)
        if gcfg.type == "VFH":
            return vfh_descriptor(pts, nrm, mask)
        return grsd_descriptor(pts, nrm, mask, float(gcfg.radius))


def _cvfh_chunk(clouds, normals_list, chunk, n, gcfg, normal_radius,
                cn_method, device, lrf_version):
    """The CVFH / OURCVFH rows of each cloud of a chunk (the JAX
    ``_cvfh_global``): the curvature always from the normal stage of the
    method, the normals a cloud's own where it has them."""
    pts_b, mask_b, _ = padded_chunk(clouds, chunk, n)
    pts = torch.from_numpy(pts_b).to(device)
    mask = torch.from_numpy(mask_b).to(device)
    with full_fp32():
        nres = compute_normals(pts, mask, normal_radius, cn_method,
                               lrf_version)
    out = []
    for r, ci in enumerate(chunk):
        m = len(clouds[ci])
        nrm_pad = nres.normals[r]
        nl = normals_list[ci]
        if nl is not None and len(nl) == m:
            nrm = np.asarray(nl, np.float32)
            pad = np.zeros((n, 3), np.float32)
            pad[:m] = nrm
            nrm_pad = torch.from_numpy(pad).to(device)
        else:
            nrm = nrm_pad[:m].cpu().numpy()
        with full_fp32():
            out.append(cvfh_descriptors(
                clouds[ci], nrm, nres.curvature[r, :m].cpu().numpy(),
                pts[r], nrm_pad, mask[r],
                dist_tol=gcfg.cvfh_cluster_tolerance,
                eps_angle=math.radians(gcfg.cvfh_eps_angle_deg),
                curv_threshold=gcfg.cvfh_curv_threshold,
                min_points=gcfg.cvfh_min_points,
                with_sgurf=gcfg.type == "OURCVFH",
                axis_ratio=gcfg.ourcvfh_axis_ratio))
    return out


def extract_global_features(
        clouds: Sequence[np.ndarray],
        normals_list: Sequence[Optional[np.ndarray]],
        rgb_list: Sequence[Optional[np.ndarray]],
        gcfg: FeatureConfig, normal_radius: float,
        consistent_normals_method: int, device: torch.device,
        lrf_version: int = 1) -> List[FeatureSet]:
    """Each cloud's global feature set (the JAX ``extract_global_features``
    for Dummy and the *_GLOBAL descriptors): Dummy gives none; otherwise one
    row, the descriptor at the centroid (module docstring) with
    ``global_radius`` the cloud radius, dropped when invalid.  The normals
    are a cloud's provided ones or ``compute_normals`` under the method,
    batched per chunk (a scene's: :func:`scene_normals`, without EMST, as
    the JAX global normals stage); the descriptor is one launch per
    cloud."""
    if gcfg.type == "Dummy":
        return [make_feature_set(np.zeros((0, 1), np.float32),
                                 np.zeros((0, 3), np.float32),
                                 np.zeros((0, 3, 3), np.float32),
                                 np.zeros(0, bool)) for _ in clouds]
    if gcfg.type not in GLOBAL_DESCRIPTORS:
        raise ValueError(f"unsupported global feature type {gcfg.type!r}")
    if gcfg.needs_rgb() and any(r is None for r in rgb_list):
        raise ValueError(f"{gcfg.type} needs RGB data but a cloud has none")
    if gcfg.type == "GASD" and gcfg.gasd_with_color \
            and any(r is None for r in rgb_list):
        raise ValueError("GASD with color needs RGB data "
                         "(set GasdWithColor false)")
    out: List[Optional[FeatureSet]] = [None] * len(clouds)
    groups = bucket_groups(clouds, chunk_width(len(clouds)))
    if gcfg.type in WHOLE_CLOUD_GLOBALS + ("CVFH", "OURCVFH"):
        for n, chunk in groups:
            if gcfg.type in WHOLE_CLOUD_GLOBALS:
                desc = _whole_cloud_chunk(
                    clouds, normals_list, rgb_list, chunk, n, gcfg,
                    normal_radius, consistent_normals_method, device,
                    lrf_version).cpu().numpy()
                rows = [desc[r:r + 1] for r in range(len(chunk))]
            else:
                rows = _cvfh_chunk(clouds, normals_list, chunk, n, gcfg,
                                   normal_radius, consistent_normals_method,
                                   device, lrf_version)
            for ci, d in zip(chunk, rows):
                out[ci] = _global_set(d, np.asarray(clouds[ci]))
        return out  # type: ignore[return-value]
    for n, chunk in groups:
        pts_b, mask_b, rgb_b = padded_chunk(
            clouds, chunk, n, rgb_list if gcfg.needs_rgb() else None)
        pts = torch.from_numpy(pts_b).to(device)
        mask = torch.from_numpy(mask_b).to(device)
        with full_fp32():
            if not gcfg.needs_normals():
                nrm = torch.zeros_like(pts)
            elif n > tiled.SCENE_TILE_THRESHOLD:
                nrm_b = np.zeros(pts_b.shape, np.float32)
                for r, ci in enumerate(chunk):
                    nrm_b[r, :len(clouds[ci])] = scene_normals(
                        clouds[ci], normals_list[ci], normal_radius,
                        consistent_normals_method, device, lrf_version,
                        emst=False)
                nrm = torch.from_numpy(nrm_b).to(device)
            else:
                nrm = compute_cloud_normals(
                    clouds, normals_list, chunk, pts, mask, normal_radius,
                    consistent_normals_method, lrf_version, emst=False)
            rgb = None if rgb_b is None else torch.from_numpy(rgb_b).to(device)
            for r, ci in enumerate(chunk):
                xyz = clouds[ci]
                centroid = xyz.mean(axis=0).astype(np.float32)
                radius = float(np.linalg.norm(xyz - centroid, axis=1).max())
                kp = torch.from_numpy(centroid[None, None]).to(device)
                kp_rgb = None
                if rgb is not None:
                    kp_rgb = torch.from_numpy(np.asarray(
                        rgb_list[ci].mean(axis=0), np.float32)[None, None]
                    ).to(device)
                desc, valid, frame = local_descriptors(
                    gcfg, kp, torch.ones((1, 1), dtype=torch.bool,
                                         device=device), kp_rgb,
                    pts[r:r + 1], nrm[r:r + 1],
                    None if rgb is None else rgb[r:r + 1], mask[r:r + 1],
                    radius, lrf_version, capacity=n)
                out[ci] = make_feature_set(
                    desc[0].cpu().numpy(), centroid[None],
                    frame[0].cpu().numpy(), valid[0].cpu().numpy(),
                    np.zeros(1, np.float32),
                    np.full(1, radius, np.float32)).compact()
    return out  # type: ignore[return-value]
