"""Codeword clustering (port of ``run_clustering`` of
point_cloud_donkey_tpu/models/clustering.py for Type None: one codeword per
feature, clustering_none.cpp:37-44; KMeans* and Agglomerative are not
ported)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def run_clustering(descriptors: np.ndarray, clustering_type: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(cluster centres, per-feature centre index) under `clustering_type`
    (the ``Clustering`` Type)."""
    if clustering_type != "None":
        raise NotImplementedError(
            f"Clustering {clustering_type!r}: the port clusters with None "
            "only")
    return descriptors.copy(), np.arange(descriptors.shape[0],
                                         dtype=np.int32)
