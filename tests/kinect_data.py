"""Synthetic Kinect v1 frames and object views (numpy only: chip_smoke.py
reads this module on the card, where there is no JAX).

A frame is what a 640 x 480 Kinect v1 returns from a table top: an
organised depth image of a pinhole camera (fx = fy = 525, cx = 319.5,
cy = 239.5) ray-cast against a table plane and four coloured objects
standing on it, depth noise growing with the square of the depth, the
pixels without a return (no surface, beyond MAX_DEPTH, random dropouts)
dropped; the cloud is the back-projection of the valid pixels in the
camera frame (x right, y down, z forward), in row-major pixel order, with
8-bit colours in [0, 1].  Object views render one object alone from the
same camera at a given distance and yaw, as a training set would hold.

    python tests/kinect_data.py      # prints each frame's size and hash
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Tuple

import numpy as np

WIDTH, HEIGHT = 640, 480
FX = FY = 525.0
CX, CY = 319.5, 239.5
MAX_DEPTH = 3.0     # metres: farther returns are dropped
MIN_DEPTH = 0.5
DROPOUT = 0.01      # share of valid pixels dropped at random
CAMERA_HEIGHT = 0.9  # above the table, metres
PITCH = np.deg2rad(48.0)   # the camera looks down by this angle
TABLE_FAR = 2.2     # the table ends this far ahead of the camera (floor
#                     below: farther than MAX_DEPTH)
FLOOR = -0.75       # the floor's height below the table top

# the objects: class -> (kind, dimensions, colour function id)
#   box: half extents (x, y = height / 2, z); cylinder: (radius, height);
#   sphere: (radius,); ellipsoid: semi-axes (x, y, z)
OBJECTS = {
    0: ("box", (0.10, 0.075, 0.06)),
    1: ("cylinder", (0.05, 0.14)),
    2: ("sphere", (0.08,)),
    3: ("ellipsoid", (0.12, 0.06, 0.08)),
}
CLASS_NAMES = {0: "box", 1: "can", 2: "ball", 3: "egg"}


class Frame(NamedTuple):
    xyz: np.ndarray     # [N, 3] float32, camera frame
    rgb: np.ndarray     # [N, 3] float32 in [0, 1] (k / 255)
    objects: List[Tuple[int, np.ndarray]]  # (class, centre in the camera
    #                                        frame [3] float32)


def _camera(pitch: float, height: float):
    """(centre [3], right, down, forward) of the camera in the world frame
    (x right, y up, z ahead; the table top is y = 0)."""
    c = np.array([0.0, height, 0.0])
    right = np.array([1.0, 0.0, 0.0])
    fwd = np.array([0.0, -np.sin(pitch), np.cos(pitch)])
    down = np.array([0.0, -np.cos(pitch), -np.sin(pitch)])
    return c, right, down, fwd


def _rays(right, down, fwd):
    """World directions [H * W, 3] of the pixels (z component 1 in the
    camera frame), row-major."""
    v, u = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    a = ((u - CX) / FX).reshape(-1, 1)
    b = ((v - CY) / FY).reshape(-1, 1)
    return a * right + b * down + fwd


def _hit_plane(c, d, y0, z_max=np.inf):
    """Ray parameter of the plane y = y0 (inf where missed or past
    z_max)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (y0 - c[1]) / d[:, 1]
    z = c[2] + t * d[:, 2]
    return np.where((t > 0) & (z <= z_max), t, np.inf)


def _quadric(a, b, cc):
    """The smaller positive root of a t^2 + b t + c (inf where none)."""
    disc = b * b - 4 * a * cc
    with np.errstate(invalid="ignore", divide="ignore"):
        sq = np.sqrt(np.where(disc >= 0, disc, np.nan))
        t0 = (-b - sq) / (2 * a)
        t1 = (-b + sq) / (2 * a)
    t = np.where(t0 > 1e-9, t0, np.where(t1 > 1e-9, t1, np.inf))
    return np.where(np.isfinite(t), t, np.inf)


def _hit_object(c, d, kind, dims, pos, yaw):
    """Ray parameter of one object standing on the table at `pos` (x, z),
    turned by `yaw` about the vertical."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    if kind == "box":
        centre = np.array([pos[0], dims[1], pos[1]])
    elif kind == "cylinder":
        centre = np.array([pos[0], 0.0, pos[1]])
    elif kind == "sphere":
        centre = np.array([pos[0], dims[0], pos[1]])
    else:
        centre = np.array([pos[0], dims[1], pos[1]])
    o = (c - centre) @ rot          # into the object's frame
    dl = d @ rot
    if kind == "box":
        h = np.asarray(dims)
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-h - o) / dl
            t2 = (h - o) / dl
        tn = np.nanmax(np.minimum(t1, t2), axis=1)
        tf = np.nanmin(np.maximum(t1, t2), axis=1)
        return np.where((tn <= tf) & (tn > 1e-9), tn, np.inf)
    if kind == "cylinder":
        r, height = dims
        a = dl[:, 0] ** 2 + dl[:, 2] ** 2
        b = 2 * (o[0] * dl[:, 0] + o[2] * dl[:, 2])
        t = _quadric(a, b, o[0] ** 2 + o[2] ** 2 - r * r)
        y = o[1] + t * dl[:, 1]
        t = np.where((y >= 0) & (y <= height), t, np.inf)
        cap = _hit_plane(o, dl, height)
        xz = (o[0] + cap * dl[:, 0]) ** 2 + (o[2] + cap * dl[:, 2]) ** 2
        return np.minimum(t, np.where(xz <= r * r, cap, np.inf))
    axes = np.asarray(dims * 3 if kind == "sphere" else dims, np.float64)
    os_, ds = o / axes, dl / axes
    return _quadric((ds * ds).sum(1), 2 * (ds * os_).sum(1),
                    (os_ * os_).sum() - 1.0)


def _colours(kind_id, p_local, rng_phase):
    """8-bit colours [M, 3] of points of one surface, in its own frame."""
    x, y, z = p_local[:, 0], p_local[:, 1], p_local[:, 2]
    if kind_id == "table":
        w = 0.5 + 0.5 * np.sin(37.0 * x + 3.0 * np.sin(11.0 * z) + rng_phase)
        rgb = np.stack([0.55 + 0.15 * w, 0.38 + 0.10 * w, 0.22 + 0.05 * w],
                       1)
    elif kind_id == "floor":
        rgb = np.tile([0.35, 0.35, 0.38], (len(x), 1))
    elif kind_id == "box":
        top = (y > 0.14).astype(np.float64)
        rgb = np.stack([0.85 - 0.3 * top, 0.15 + 0.1 * top,
                        0.12 + 0.5 * (np.abs(x) > 0.06)], 1)
    elif kind_id == "cylinder":
        band = (np.floor(y / 0.03) % 2)
        rgb = np.stack([0.1 + 0.7 * band, 0.25 + 0.2 * band,
                        0.85 - 0.5 * band], 1)
    elif kind_id == "sphere":
        ang = np.arctan2(z, x)
        rgb = np.stack([0.95 * np.ones_like(x), 0.55 + 0.35 * np.sin(3 * ang),
                        0.1 * np.ones_like(x)], 1)
    else:
        g = np.clip(0.5 + 4.0 * y, 0.0, 1.0)
        rgb = np.stack([0.15 + 0.3 * g, 0.6 + 0.3 * g, 0.2 + 0.1 * g], 1)
    rgb8 = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint32)
    return rgb8.astype(np.float32) / np.float32(255.0)


def _render(rng, placements, table: bool, pitch=PITCH,
            height=CAMERA_HEIGHT) -> Frame:
    """Ray-cast the table (when `table`) and the placed objects [(class,
    (x, z), yaw)]; back-project the valid pixels."""
    c, right, down, fwd = _camera(pitch, height)
    d = _rays(right, down, fwd)
    hits = []
    if table:
        hits.append(("table", _hit_plane(c, d, 0.0, TABLE_FAR), None))
        hits.append(("floor", _hit_plane(c, d, FLOOR), None))
    for cid, pos, yaw in placements:
        kind, dims = OBJECTS[cid]
        hits.append((kind, _hit_object(c, d, kind, dims, pos, yaw),
                     (cid, pos, yaw)))
    ts = np.stack([h[1] for h in hits], 1)
    which = np.argmin(ts, 1)
    t = ts[np.arange(len(ts)), which]
    # the camera-frame depth is t (the rays' forward component is 1)
    z = t + rng.normal(size=t.shape) * 1.4e-3 * np.where(np.isfinite(t),
                                                         t, 0.0) ** 2
    valid = np.isfinite(t) & (z >= MIN_DEPTH) & (z <= MAX_DEPTH) \
        & (rng.random(t.shape) >= DROPOUT)
    idx = np.nonzero(valid)[0]
    u = (idx % WIDTH).astype(np.float64)
    v = (idx // WIDTH).astype(np.float64)
    zz = z[idx]
    xyz = np.stack([(u - CX) / FX * zz, (v - CY) / FY * zz, zz], 1)
    world = c + t[idx, None] * d[idx]
    rgb = np.zeros((len(idx), 3), np.float32)
    phase = float(rng.uniform(0, 2 * np.pi))
    for k, (kind, _, place) in enumerate(hits):
        sel = which[idx] == k
        if not sel.any():
            continue
        p = world[sel]
        if place is not None:
            _, pos, yaw = place
            cy, sy = np.cos(yaw), np.sin(yaw)
            rot = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0],
                            [-sy, 0.0, cy]])
            p = (p - np.array([pos[0], 0.0, pos[1]])) @ rot
        rgb[sel] = _colours(kind, p, phase)
    objects = []
    for cid, pos, _ in placements:
        kind, dims = OBJECTS[cid]
        mid = dims[0] if kind == "sphere" else (
            dims[1] / 2 if kind == "cylinder" else dims[1])
        centre_w = np.array([pos[0], mid, pos[1]]) - c
        objects.append((cid, np.array([centre_w @ right, centre_w @ down,
                                       centre_w @ fwd], np.float32)))
    return Frame(xyz.astype(np.float32), rgb, objects)


def kinect_frame(seed: int) -> Frame:
    """One 640 x 480 table-top frame: the four objects, each placed at
    random on the table 0.9-1.6 m ahead of the camera and turned at
    random."""
    rng = np.random.default_rng(seed)
    xs = rng.permutation(np.array([-0.45, -0.15, 0.15, 0.45]))
    placements = [(cid, (float(xs[cid] + rng.uniform(-0.05, 0.05)),
                         float(rng.uniform(0.9, 1.6))),
                   float(rng.uniform(0, 2 * np.pi))) for cid in OBJECTS]
    return _render(rng, placements, table=True)


def object_view(cid: int, distance: float, yaw: float, seed: int,
                crop: float = 0.0) -> Frame:
    """One object `distance` metres ahead of the camera along the ground,
    turned by `yaw`: a training view -- the object alone, or with `crop`
    the table top around it too, cut to the ball of that radius about the
    object's centre."""
    rng = np.random.default_rng(seed)
    f = _render(rng, [(cid, (0.0, distance), yaw)], table=crop > 0)
    if crop > 0:
        keep = np.linalg.norm(f.xyz - f.objects[0][1], axis=1) <= crop
        f = Frame(f.xyz[keep], f.rgb[keep], f.objects)
    return f


# the frames phase 11 detects and the views the committed kinect model
# (data/kinect_model.ism) is trained on: three views a class 1.1 m ahead,
# and one view of the box with the table top around it whose cloud
# exceeds the scene threshold (32768 points)
FRAME_SEEDS = (21, 22)
VIEW_DISTANCE = 1.1
VIEW_YAWS = (0.0, 2.1, 4.2)
CLOSE_VIEW = (0, 0.6, 0.6, 0.3)   # (class, distance, yaw, crop radius)


def training_views() -> List[Tuple[Frame, int]]:
    """(view, class) of the kinect model's training set, in order."""
    out = []
    for cid in OBJECTS:
        for j, yaw in enumerate(VIEW_YAWS):
            out.append((object_view(cid, VIEW_DISTANCE, yaw,
                                    seed=100 + 10 * cid + j), cid))
    cid, dist, yaw, crop = CLOSE_VIEW
    out.append((object_view(cid, dist, yaw, seed=199, crop=crop), cid))
    return out


# phase 11b: configs/default.ism with both outlier filters and MLS on,
# on FILTER_SCENES coloured bench scenes (tests/bench_data.bench_scenes)
# of four FILTER_POINTS-point objects, x FILTER_SCALE: a point spacing of
# ~2.9 mm (median nearest neighbour), so the radii below keep the clouds
# dense; every other parameter as shipped
FILTER_SEED = 31
FILTER_SCENES = 2
FILTER_POINTS = 25000
FILTER_SCALE = 0.3
FILTER_PARAMS = {"UseStatisticalOutlierRemoval": True,
                 "UseRadiusOutlierRemoval": True,
                 "OutlierRemovalRadius": 0.02,    # shipped 0.005
                 "UseSmoothing": True,
                 "SmoothingRadius": 0.015}        # shipped 0.01
# phase 11c: keypoint culling -- on a frame, configs/rgbd_kinect.ism with
# VoxelGridCulling (KPQ + ColorDistance, CutOff 0.5, RequireCombinedList,
# refined positions); on CULL_CLOUDS bench clouds, the bench SHOT model
# with Curvature + Auto and with Gaussian + Threshold (the batched route)
KINECT_CULLING = {"Type": "VoxelGridCulling",
                  "Parameters": {"LeafSize": 0.02,
                                 "FilterMethodGeometry": "KPQ",
                                 "FilterTypeGeometry": "CutOff",
                                 "FilterMethodColor": "ColorDistance",
                                 "FilterTypeColor": "CutOff",
                                 "FilterCutoffRatio": 0.5,
                                 "CombineFilters": "RequireCombinedList",
                                 "RefineKeypointPosition": True}}
CULL_CLOUDS = 16
BENCH_CULLING = {
    "curvature_auto": {"Type": "VoxelGridCulling", "Parameters": {
        "LeafSize": 0.35, "FilterMethodGeometry": "Curvature",
        "FilterTypeGeometry": "Auto"}},
    "gaussian_threshold": {"Type": "VoxelGridCulling", "Parameters": {
        "LeafSize": 0.35, "FilterMethodGeometry": "Gaussian",
        "FilterTypeGeometry": "Threshold",
        "FilterThresholdGeometry": 0.006}},   # about the median score
}


def with_child(config: dict, name: str, node: dict) -> dict:
    """A copy of an .ism config with ObjectConfig.Children[name] = node."""
    import copy
    out = copy.deepcopy(config)
    out["ObjectConfig"]["Children"][name] = copy.deepcopy(node)
    return out


def with_params(config: dict, params: dict) -> dict:
    """A copy of an .ism config with ObjectConfig.Parameters updated."""
    import copy
    out = copy.deepcopy(config)
    out["ObjectConfig"]["Parameters"].update(params)
    return out


def stable_mismatches(got, want, control, bandwidth: float,
                      rtol: float) -> Tuple[list, int]:
    """The detection contract where the reference is not stable against
    itself: each firm reference maximum (tests/bench_data.firm_pairs) that
    the control run (the JAX package under another exact tiling) also
    finds must be found in `got`, its weight within max(rtol, twice the
    control's relative deviation on that maximum).  Returns (what breaks
    it, the number of firm maxima the control itself misses)."""
    from bench_data import _field, firm_pairs
    ctl = {k: g for k, _, g in firm_pairs(control, want, bandwidth)}
    out, unstable = [], 0
    for k, w, g in firm_pairs(got, want, bandwidth):
        ww = float(_field(w, "weight"))
        if ctl.get(k) is None:
            unstable += 1
            continue
        tol = max(rtol, 2 * abs(float(_field(ctl[k], "weight")) - ww) / ww)
        if g is None:
            out.append(f"rank {k}: no maximum of class "
                       f"{int(_field(w, 'class_id'))}")
        elif abs(float(_field(g, "weight")) - ww) > tol * ww:
            out.append(f"rank {k}: weight {float(_field(g, 'weight')):.4g}, "
                       f"want {ww:.4g} (tolerance {tol:.3g})")
    return out, unstable


def frame_hash(frame: Frame) -> str:
    """sha1 (16 hex digits) of a frame's points and colours."""
    h = hashlib.sha1(np.ascontiguousarray(frame.xyz).tobytes())
    h.update(np.ascontiguousarray(frame.rgb).tobytes())
    return h.hexdigest()[:16]


if __name__ == "__main__":
    for s in FRAME_SEEDS:
        f = kinect_frame(s)
        print(s, len(f.xyz), frame_hash(f), f.xyz.min(0), f.xyz.max(0))
    for v, cid in training_views():
        print("view", cid, len(v.xyz), frame_hash(v))
