"""Feature sets, host side (port of point_cloud_donkey_tpu/models/types.py).

The reference's ISMFeature (utils/ism_feature.h:21-44) is a PCL point with
xyz, a 9-float LRF, a descriptor, centerDist and globalDescriptorRadius.
Here a cloud's features are a struct of numpy arrays with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FeatureSet(NamedTuple):
    """The local features of one cloud."""
    descriptors: np.ndarray    # [F, D]
    positions: np.ndarray      # [F, 3] keypoint positions
    frames: np.ndarray         # [F, 3, 3] LRFs (rows = axes)
    mask: np.ndarray           # [F] validity
    center_dist: np.ndarray    # [F] distance of keypoint to cloud centroid
    global_radius: np.ndarray  # [F] globalDescriptorRadius

    @property
    def dim(self) -> int:
        return int(self.descriptors.shape[-1])

    def compact(self) -> "FeatureSet":
        """Drop the rows whose mask is False."""
        m = np.asarray(self.mask)
        return FeatureSet(*(np.asarray(a)[m] for a in self))


def make_feature_set(descriptors, positions, frames, mask,
                     center_dist=None, global_radius=None) -> FeatureSet:
    f = np.asarray(mask).shape[0]
    if center_dist is None:
        center_dist = np.zeros(f, np.float32)
    if global_radius is None:
        global_radius = np.zeros(f, np.float32)
    return FeatureSet(np.asarray(descriptors), np.asarray(positions),
                      np.asarray(frames), np.asarray(mask),
                      np.asarray(center_dist), np.asarray(global_radius))
