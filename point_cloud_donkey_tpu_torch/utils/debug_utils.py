"""Offline-analysis dumps (the port's copy of ``write_voting_space`` of
point_cloud_donkey_tpu/utils/debug_utils.py; reference
utils/debug_utils.{h,cpp})."""

from __future__ import annotations

import os

import numpy as np


def write_voting_space(path: str, votes_xyz: np.ndarray,
                       weights: np.ndarray, class_ids: np.ndarray) -> None:
    """Dump the cast votes for voting-space visualisation (the reference GUI
    renders them live; here they go to an npz: votes, weights, classes)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, votes=np.asarray(votes_xyz),
                        weights=np.asarray(weights),
                        classes=np.asarray(class_ids))
