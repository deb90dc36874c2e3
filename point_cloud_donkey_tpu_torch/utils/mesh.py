"""OFF mesh ingestion for ModelNet-style datasets (a copy of
point_cloud_donkey_tpu/utils/mesh.py, numpy only, so one seed gives the
same points bit for bit in both packages).

The reference consumes point clouds only; its published ModelNet10/40
numbers assume the meshes were sampled to clouds beforehand.  This module
samples them on the fly: an OFF reader tolerant of the ModelNet header
quirk, an area-weighted surface sampler, and a PointCloud bridge, which
``utils/io.read_cloud`` calls for `.off` paths.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .io import PointCloud


def load_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an OFF mesh: returns (vertices [V, 3] f32, faces [F, 3] i32).

    Tolerates the ModelNet quirk where the counts are glued to the header
    ("OFF490 518 0" on one line), comment lines, and polygon faces (>3
    vertices), which are fan-triangulated.
    """
    with open(path, "r") as f:
        tokens: list = []
        header = None
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if header is None:
                if not line.upper().startswith("OFF"):
                    raise ValueError(f"{path}: not an OFF file ({line[:20]!r})")
                header = line
                rest = line[3:].strip()        # ModelNet glued-counts quirk
                if rest:
                    tokens.extend(rest.split())
                continue
            tokens.extend(line.split())
    if header is None or len(tokens) < 3:
        raise ValueError(f"{path}: truncated OFF header")
    nv, nf = int(tokens[0]), int(tokens[1])
    pos = 3                                    # skip the edge count
    verts = np.asarray(tokens[pos:pos + 3 * nv], np.float64
                       ).reshape(nv, 3).astype(np.float32)
    pos += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[pos])
        idx = [int(t) for t in tokens[pos + 1:pos + 1 + k]]
        pos += 1 + k
        for j in range(1, k - 1):              # fan triangulation
            faces.append((idx[0], idx[j], idx[j + 1]))
    return verts, np.asarray(faces, np.int32).reshape(-1, 3)


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n_points: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface sampling: faces drawn proportionally to
    their area, points placed with the sqrt barycentric trick (uniform over
    each triangle).  Returns [n_points, 3] float32."""
    v0 = vertices[faces[:, 0]].astype(np.float64)
    v1 = vertices[faces[:, 1]].astype(np.float64)
    v2 = vertices[faces[:, 2]].astype(np.float64)
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    rng = np.random.default_rng(seed)
    fi = rng.choice(len(faces), size=n_points, p=areas / total)
    r1 = np.sqrt(rng.random(n_points))
    r2 = rng.random(n_points)
    pts = ((1.0 - r1)[:, None] * v0[fi]
           + (r1 * (1.0 - r2))[:, None] * v1[fi]
           + (r1 * r2)[:, None] * v2[fi])
    return pts.astype(np.float32)


def off_to_cloud(path: str, n_points: int = 2048, seed: int = 0,
                 unit_sphere: bool = True) -> PointCloud:
    """OFF mesh -> sampled PointCloud.  With unit_sphere the cloud is
    centered and scaled to the unit sphere — ModelNet meshes come in
    arbitrary units, while the reference's mn10/mn40 parameter presets
    (normal radius 0.05, feature radius 0.4; pcl_ism.cpp:30-32 and
    hough3d.cpp dataset blocks) assume unit-scaled objects."""
    verts, faces = load_off(path)
    pts = sample_surface(verts, faces, n_points, seed)
    if unit_sphere:
        pts = pts - pts.mean(axis=0, keepdims=True)
        r = np.linalg.norm(pts, axis=1).max()
        if r > 0:
            pts = pts / r
    return PointCloud(xyz=pts.astype(np.float32))
