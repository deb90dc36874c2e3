"""Voxel-grid keypoint parameters (port of ``KeypointParams`` and
``culling_disabled`` of point_cloud_donkey_tpu/models/keypoints.py, for the
VoxelGrid and VoxelGridCulling types).  Ported: the parameters and the
test of whether VoxelGridCulling culls; training and detection run
VoxelGridCulling where it culls nothing.  Not ported: the culling itself
(ROADMAP A13) and the keypoint detectors (ROADMAP A15); training and
detection refuse them by name."""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.config import ComponentConfig


@dataclass
class KeypointParams:
    type: str = "VoxelGrid"
    leaf_size: float = 0.1
    filter_method_geometry: str = "None"
    filter_method_color: str = "None"
    disable_filter_in_training: bool = True

    @classmethod
    def from_config(cls, cfg: ComponentConfig) -> "KeypointParams":
        return cls(
            type=cfg.type or "VoxelGrid",
            leaf_size=cfg.get("LeafSize", 0.1),
            filter_method_geometry=cfg.get("FilterMethodGeometry", "None"),
            filter_method_color=cfg.get("FilterMethodColor", "None"),
            disable_filter_in_training=cfg.get("DisableFilterInTraining",
                                               True),
        )


def culling_disabled(params: KeypointParams, is_training: bool) -> bool:
    """True when VoxelGridCulling behaves as a plain VoxelGrid
    (culling.cpp:76-87): plain type, culling disabled in training, or both
    filter methods None."""
    geo = params.filter_method_geometry.lower()
    col = params.filter_method_color.lower()
    return (params.type == "VoxelGrid"
            or (is_training and params.disable_filter_in_training)
            or (geo == "none" and col == "none"))
