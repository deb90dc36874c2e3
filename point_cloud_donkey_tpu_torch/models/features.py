"""Descriptor configuration and cloud padding of the training extraction
(port of ``FeatureConfig``, ``bucket_size`` and ``pad_cloud`` of
point_cloud_donkey_tpu/models/features.py, for the descriptors the port
computes: SHOT, CSHOT and SHORT_SHOT)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..ops.short_shot import resolve_bins
from ..utils.config import ComponentConfig

DESCRIPTORS = ("SHOT", "CSHOT", "SHORT_SHOT")


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
    """The ``Features`` component of an .ism config (the SHOT, CSHOT and
    SHORT_SHOT fields of the JAX FeatureConfig)."""
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
        )

    def needs_normals(self) -> bool:
        return self.type != "SHORT_SHOT"

    def needs_rgb(self) -> bool:
        return self.type == "CSHOT"

    def short_shot_bins(self) -> Tuple[int, int, int, int]:
        """(dims, r_bins, e_bins, a_bins) of the SHORT_SHOT grid."""
        return resolve_bins(self.short_shot_dims, self.short_shot_bin_type,
                            self.short_shot_r_bins, self.short_shot_e_bins,
                            self.short_shot_a_bins)

    def descriptor_dim(self) -> int:
        if self.type == "SHOT":
            return 352
        if self.type == "CSHOT":
            return 1344
        if self.type == "SHORT_SHOT":
            return self.short_shot_bins()[0]
        raise NotImplementedError(
            f"descriptor {self.type!r}: the port computes "
            f"{', '.join(DESCRIPTORS)}")


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
