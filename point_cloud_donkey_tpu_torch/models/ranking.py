"""Feature ranking (port of ``RankingParams.type`` and ``rank_features`` of
point_cloud_donkey_tpu/models/ranking.py for the Uniform ranking, which
keeps every feature; the scored rankers are not ported)."""

from __future__ import annotations

import numpy as np


def rank_features(descriptors: np.ndarray, ranking_type: str) -> np.ndarray:
    """Keep mask [F] of the training features under `ranking_type` (the
    ``FeatureWeighting`` Type)."""
    if ranking_type != "Uniform":
        raise NotImplementedError(
            f"FeatureWeighting {ranking_type!r}: the port ranks Uniform only")
    return np.ones(descriptors.shape[0], bool)
