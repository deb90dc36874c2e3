"""Edge-case inputs for K1 (radius moments), K2 (LRF sign votes), K3
(tile-compacted SHOT-352), K4 (chi-square top-k), K5 / K6 (the windowed
moments and sign votes), K7 (SHOT-352 on the dense keypoint grid), K8
(CSHOT-1344) and K9 (SHORT_SHOT), made with numpy from a seed: the cases a cell-binned radius
sweep, compacted in-radius pairs binned into warp-owned histograms (or
registers) and a register-tiled chi-square kernel make risky.
tests/test_torch_redesign.py holds the plain twins against the JAX package
on them (CPU); tests/test_torch_cuda.py holds the CUDA kernels against the
twins on them (card).  numpy only: both files import this module."""

import numpy as np

import shapes

K1_RADIUS = 0.25
K1_CASES = ("padded_queries", "masked_nan_huge", "wide_extent", "ragged_n",
            "no_valid_queries")
K4_DIMS = (32, 35, 352, 1344)


def _centre(p, m):
    """Shift by the masked centroid, as the wrappers' prep_shift does."""
    shift = p[m].mean(0) if m.any() else np.zeros(3, np.float32)
    return (p - shift).astype(np.float32)


def k1_case(name, n_points=None):
    """(queries [B, Q, 3], q_mask [B, Q], points [B, N, 3], mask [B, N])
    float32 / bool, centroid-shifted.  Masked points may hold anything;
    invalid queries sit at 1e9 (the keypoint grid's pad)."""
    rng = np.random.default_rng(K1_CASES.index(name) + 40)
    b = 2
    n = n_points or (1037 if name == "ragged_n" else 700)
    pts = np.stack([shapes.make_instance(rng, i % 5, n=n, rotate=True)
                    for i in range(b)]).astype(np.float32)
    mask = np.ones((b, n), bool)
    if name == "wide_extent":
        # five clusters ~40 units apart at r = 0.25: ~160 cells an axis,
        # far more than the grid may hold, so its cap trips (farther apart,
        # the moment identity itself loses the covariance to cancellation)
        cl = rng.integers(0, 5, size=(b, n))
        centres = rng.uniform(-20, 20, size=(b, 5, 3)).astype(np.float32)
        pts = pts * 0.3 + np.take_along_axis(centres, cl[..., None], 1)
    if name in ("masked_nan_huge", "ragged_n"):
        mask = rng.random((b, n)) > 0.15
    if name == "masked_nan_huge":
        bad = np.array([np.nan, 1e30, -1e30, np.inf, -np.inf], np.float32)
        holes = ~mask
        pts[holes] = bad[rng.integers(0, len(bad), size=(holes.sum(), 3))]
    pts = np.stack([_centre(pts[i], mask[i]) for i in range(b)])
    if name == "ragged_n":
        qry, q_mask = pts.copy(), mask.copy()
    else:
        qry = pts[:, ::9].copy()
        q_mask = np.ones(qry.shape[:2], bool)
        if name == "padded_queries":
            q_mask[:, -7:] = False
            q_mask[0, 3] = False
        if name == "no_valid_queries":
            q_mask[:] = False
    if name == "masked_nan_huge":
        q_mask &= mask[:, ::9]
    qry = np.where(q_mask[..., None], qry, np.float32(1e9)).astype(np.float32)
    return qry, q_mask, pts, mask


K5_CASES = ("clamped_end", "inexact", "query_tail", "masked_nan_huge",
            "full_window", "narrow_window", "overlapping")
K5_TILE = 256   # queries per window-plan tile (TQW)


def _principal_sort(pts, mask, rng):
    """Sort each cloud along its principal axis (the unmasked points'
    PCA); a masked point takes the key of a random unmasked one, so the
    masked points spread through the windows.  Returns (points, mask,
    keys [B, N] ascending)."""
    out = ([], [], [])
    for p, m in zip(pts, mask):
        c = p[m] - p[m].mean(0)
        key = c @ np.linalg.svd(c, full_matrices=False)[2][0]
        full = np.empty(len(p), np.float32)
        full[m] = key
        full[~m] = rng.choice(key, size=(~m).sum())
        order = np.argsort(full, kind="stable")
        for lst, x in zip(out, (p, m, full)):
            lst.append(x[order])
    return tuple(np.stack(x) for x in out)


def _plan_starts(keys, mask, window, radius=K1_RADIUS):
    """Per-tile window starts centred on the candidate range of each plan
    tile's unmasked queries along the sorted keys ([B, T] int32, clamped
    to [0, N - W]): the window planner's rule without its 128-point
    alignment."""
    b, n = keys.shape
    t = -(-n // K5_TILE)
    starts = np.zeros((b, t), np.int32)
    for i in range(b):
        for k in range(t):
            tile = slice(k * K5_TILE, (k + 1) * K5_TILE)
            valid = keys[i, tile][mask[i, tile]]
            lo = np.searchsorted(keys[i], valid.min() - radius)
            hi = np.searchsorted(keys[i], valid.max() + radius, side="right")
            starts[i, k] = min(max((lo + hi - window) // 2, 0),
                               max(n - window, 0))
    return starts


def k5_case(name, n_points=None, window=None):
    """(points [B, N, 3], mask [B, N], starts [B, T] int32, window W) of
    K5, the windowed moments, whose queries are the points themselves (the
    windowed self-LRF; q_mask = mask), centroid-shifted and sorted along
    each cloud's principal axis, T = ceil(N / 256) plan tiles, W = 512
    unless named: a window running past the cloud's end and one starting
    past it (both clamped to N), an inexact plan (each tile sweeps only its
    own 256 points, so points within r of a query lie outside its window),
    a query tail (N = 700), masked points holding NaN and +-1e30 / +-inf
    inside the windows, W = N, W = 128, and neighbouring windows that
    share all but 64 points.  n_points and window resize a case."""
    rng = np.random.default_rng(K5_CASES.index(name) + 60)
    b = 2
    n = n_points or (700 if name == "query_tail" else 768)
    pts = np.stack([shapes.make_instance(rng, (i + 2) % 5, n=n, rotate=True)
                    for i in range(b)]).astype(np.float32)
    mask = np.ones((b, n), bool)
    if name == "masked_nan_huge":
        mask = rng.random((b, n)) > 0.15
    pts = np.stack([_centre(pts[i], mask[i]) for i in range(b)])
    if name == "masked_nan_huge":
        bad = np.array([np.nan, 1e30, -1e30, np.inf, -np.inf], np.float32)
        holes = ~mask
        pts[holes] = bad[rng.integers(0, len(bad), size=(holes.sum(), 3))]
    pts, mask, keys = _principal_sort(pts, mask, rng)
    t = -(-n // K5_TILE)
    window = window or {"full_window": n, "narrow_window": 128,
                        "inexact": K5_TILE, "overlapping": 640}.get(name, 512)
    if name == "inexact":
        starts = np.tile(np.arange(t, dtype=np.int32) * K5_TILE, (b, 1))
    elif name == "narrow_window":
        starts = np.tile(np.arange(t, dtype=np.int32) * K5_TILE + 64, (b, 1))
    elif name == "overlapping":
        starts = np.tile(np.clip(np.arange(t) * K5_TILE - 192, 0, n - window)
                         .astype(np.int32), (b, 1))
    else:
        starts = _plan_starts(keys, mask, window)
    if name == "clamped_end":
        starts[0, -1] = n - 200        # [n - 200, n - 200 + W) runs past n
        starts[1, -1] = n + 5          # past the end: an empty window
    return pts, mask, starts.astype(np.int32), window


def k5_windows_exact(pts, mask, starts, window, radius=K1_RADIUS):
    """Whether every in-radius (unmasked query, unmasked point) pair of the
    K5 case lies in the query's tile window: then K5 equals K1 over the
    whole cloud."""
    n = pts.shape[1]
    idx = np.arange(n)
    for p, m, s in zip(pts, mask, starts):
        with np.errstate(invalid="ignore", over="ignore"):
            d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        near = (d2 <= np.float32(radius) ** 2) & m[:, None] & m[None, :]
        lo = np.clip(s[idx // K5_TILE], 0, n)[:, None]
        if (near & ((idx[None, :] < lo) | (idx[None, :] >= lo + window))
                ).any():
            return False
    return True


def k6_case(name):
    """(points, mask, starts, window, axes [B, N, 6]) of K6, the windowed
    sign votes: k5_case's inputs with x and z axis candidates for every
    query (the points), unit vectors made from a seed."""
    pts, mask, starts, window = k5_case(name)
    rng = np.random.default_rng(K5_CASES.index(name) + 80)
    axes = np.concatenate([_unit(rng, mask.shape), _unit(rng, mask.shape)],
                          -1)
    return pts, mask, starts, window, axes


def k4_case(dim, q=70, c=150, seed=8, signed=False):
    """(a [Q, D], b [C, D], b_mask [C]) float32 / bool: sparse non-negative
    histograms (60% zeros), C not a multiple of any tile, masked
    codewords, an all-zero descriptor and codeword (every s = 0 between
    them), and a duplicated codeword (the tie goes to the lower index).
    signed adds negative values (terms with a + b <= 0 count 0) and
    values of 1e-25 and 1e19 to some rows."""
    rng = np.random.default_rng(seed + dim)
    a = rng.random((q, dim)).astype(np.float32)
    a[rng.random(a.shape) < 0.6] = 0.0
    b = rng.random((c, dim)).astype(np.float32)
    b[rng.random(b.shape) < 0.6] = 0.0
    a[5] = 0.0
    b[11] = 0.0
    b[7] = b[3]
    a[9] = b[3]          # its two nearest are the tied pair, distance 0
    b_mask = rng.random(c) > 0.1
    b_mask[[3, 7, 11]] = True
    if signed:
        a[40:50] *= np.where(rng.random((10, dim)) < 0.3, -1.0, 1.0)
        a[60, :3] = 1e-25
        b[100, :2] = 1e19
        b[120:130] *= np.where(rng.random((10, dim)) < 0.3, -1.0, 1.0)
    return a, b, b_mask.astype(bool)


K2_CASES = K1_CASES + ("on_radius_and_orthogonal", "beyond_one_chunk")


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _on_radius_and_orthogonal(rng):
    """Queries at coordinates on a 1/64 grid with points at exactly r from
    them along each axis (d^2 = r^2 in float, which the gate counts) and
    points whose offset is orthogonal to the query's axis candidate
    ((p - q) . axis = 0 in float, which counts as +)."""
    b, n, r = 2, 600, np.float32(K1_RADIUS)
    pts = np.stack([_centre(shapes.make_instance(rng, i % 5, n=n,
                                                 rotate=True),
                            np.ones(n, bool)) for i in range(b)])
    special = np.round(pts[:, ::50] * 64) / 64                  # [B, 12, 3]
    eye = np.eye(3, dtype=np.float32)
    on_r = np.concatenate([eye * r, -eye * r])                  # 6 offsets
    # offsets orthogonal to z (x, y only) and to x (y, z only)
    ortho = np.array([[0.125, -0.0625, 0], [-0.1875, 0.09375, 0],
                      [0, 0.15625, -0.0625], [0, -0.03125, 0.125]],
                     np.float32)
    offs = np.concatenate([on_r, ortho])
    extra = (special[:, :, None, :] + offs[None, None]).reshape(b, -1, 3)
    pts = np.concatenate([pts, extra.astype(np.float32)], 1)
    d = extra.reshape(b, -1, len(offs), 3) - special[:, :, None, :]
    d2 = (d * d).sum(-1, dtype=np.float32)
    assert (d2[..., :6] == r * r).all() and (d[..., 6:, :] == offs[6:]).all()
    qry = np.concatenate([special, pts[:, 1::7]], 1).astype(np.float32)
    axes = np.concatenate([_unit(rng, qry.shape[:2]),
                           _unit(rng, qry.shape[:2])], -1)
    # the special queries' candidates: x = (1, 0, 0), z = (0, 0, 1)
    axes[:, :special.shape[1]] = [1, 0, 0, 0, 0, 1]
    return qry, np.ones(qry.shape[:2], bool), pts, np.ones(pts.shape[:2],
                                                           bool), axes


def k2_case(name):
    """(queries [B, Q, 3], q_mask [B, Q], points [B, N, 3], mask [B, N],
    axes [B, Q, 6]) float32 / bool: K1's edge cases with axis candidates
    made from a seed (x, z unit vectors), exact on-radius and orthogonal
    offsets, and N = 2500 (the binned sweep's chunked binning)."""
    rng = np.random.default_rng(K2_CASES.index(name) + 50)
    if name == "on_radius_and_orthogonal":
        return _on_radius_and_orthogonal(rng)
    if name == "beyond_one_chunk":
        q, q_mask, p, mask = k1_case("ragged_n", n_points=2500)
    else:
        q, q_mask, p, mask = k1_case(name)
    axes = np.concatenate([_unit(rng, q.shape[:2]), _unit(rng, q.shape[:2])],
                          -1)
    return q, q_mask, p, mask, axes


K3_RADIUS = 0.6
K3_CASES = ("coincident", "nan_normals", "on_axis", "in_plane",
            "shell_edges", "cos_pm1", "masked_garbage", "dead_uneven_empty")
K3_KEYS = ("keypoints", "frames", "frame_valid", "kp_mask", "points",
           "normals", "mask")
# frames with entries 0 and +-1 (rows = axes): local coordinates are exact
_EXACT_FRAMES = np.array([np.eye(3), [[0, 1, 0], [0, 0, 1], [1, 0, 0]],
                          [[-1, 0, 0], [0, -1, 0], [0, 0, 1]]], np.float32)


def _rotations(rng, n):
    """n random rotations [n, 3, 3] float32 (rows = axes)."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return np.swapaxes(q, 1, 2).astype(np.float32)


def _shell_offsets():
    """Local offsets at d = r/4, r/2 and 3r/4 exactly, as the kernels
    compute the shell edges from r in float."""
    r = np.float32(K3_RADIUS)
    r14, r_half = r / np.float32(4), r / np.float32(2)
    r34 = np.float32(3) * r / np.float32(4)
    return np.array([[r14, 0, 0], [0, -r_half, 0], [0, 0, r34],
                     [-r34, 0, 0], [0, r14, 0], [0, 0, -r_half]], np.float32)


def _exact_geometry(name, rng, kp, frames, pts, nrm, per_cloud=6):
    """Put the first keypoints of each cloud on a 1/64 grid with frames of
    0 / +-1 entries, and points around them (in place of the cloud's last
    points) whose local coordinates are exactly: (0, 0, z) for on_axis (no
    azimuth), (x, y, 0) for in_plane (inclination 90 degrees), a distance
    of r/4, r/2 or 3r/4 for shell_edges; for cos_pm1, normals +-z_axis
    (cos_desc = +-1)."""
    local = {
        "on_axis": [[0, 0, 0.1875], [0, 0, -0.25], [0, 0, 0.375],
                    [0, 0, -0.4375]],
        "in_plane": [[0.25, 0.125, 0], [-0.1875, 0.3125, 0], [0.0625, -0.5, 0],
                     [-0.375, -0.25, 0]],
        "cos_pm1": [[0.125, -0.0625, 0.25], [-0.25, 0.1875, -0.125],
                    [0.0625, 0.3125, 0.1875], [-0.125, -0.25, -0.0625]],
    }
    offs = _shell_offsets() if name == "shell_edges" else \
        np.array(local[name], np.float32)
    b = kp.shape[0]
    m = len(offs)
    for i in range(b):
        for s in range(per_cloud):
            fr = _EXACT_FRAMES[s % len(_EXACT_FRAMES)]
            frames[i, s] = fr
            if name == "shell_edges":   # near 0: q + offset stays exact
                kp[i, s] = rng.integers(-2, 3, size=3) / np.float32(64)
            else:
                kp[i, s] = np.round(kp[i, s] * 64) / 64
            rows = slice(pts.shape[1] - (s + 1) * m, pts.shape[1] - s * m)
            pts[i, rows] = kp[i, s] + offs @ fr     # local offsets -> world
            if name == "cos_pm1":
                nrm[i, rows] = fr[2] * np.where(np.arange(m) % 2, -1, 1
                                                )[:, None]
            d = pts[i, rows] - kp[i, s]
            loc = np.stack([(d * fr[a]).sum(-1, dtype=np.float32)
                            for a in range(3)], -1)
            assert (loc == offs).all(), name
            if name == "shell_edges":
                dist = np.sqrt((d * d).sum(-1, dtype=np.float32))
                assert (dist == np.abs(offs).max(-1)).all()


def k3_case(name, n=512, k=32):
    """(keypoints [B, K, 3], frames [B, K, 3, 3] (rows = axes), frame_valid
    [B, K], kp_mask [B, K] (valid rows first), points [B, N, 3], normals
    [B, N, 3], mask [B, N]) float32 / bool, B = 2, for SHOT at K3_RADIUS:
    keypoints coincident with points (d^2 = 0 is left out), NaN and +-inf
    normals, the exact local geometries of _exact_geometry, masked points
    holding NaN and +-1e30, and an uneven cloud beside an empty one (a
    last tile with dead rows)."""
    rng = np.random.default_rng(K3_CASES.index(name) + 60)
    b = 2
    pts = np.stack([shapes.make_instance(rng, i + 1, n=n, rotate=True)
                    for i in range(b)]).astype(np.float32)
    nrm = _unit(rng, (b, n))
    mask = np.ones((b, n), bool)
    counts = (17, 0) if name == "dead_uneven_empty" else (21, 27)
    # rows past a cloud's keypoints hold the pipelines' 1e9 pad and an
    # invalid frame, as the voxel grid and the LRF leave them
    kp = np.full((b, k, 3), 1e9, np.float32)
    kp_mask = np.zeros((b, k), bool)
    frames = _rotations(rng, b * k).reshape(b, k, 3, 3)
    for i, c in enumerate(counts):
        idx = rng.choice(n, c, replace=False)
        jitter = 0.0 if name == "coincident" else \
            rng.normal(scale=0.02, size=(c, 3))
        kp[i, :c] = pts[i, idx] + jitter
        kp_mask[i, :c] = True
    frame_valid = (rng.random((b, k)) > 0.1) & kp_mask
    if name == "nan_normals":
        bad = np.argwhere(rng.random((b, n)) < 0.1)
        nrm[bad[:, 0], bad[:, 1], rng.integers(0, 3, len(bad))] = \
            rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                       len(bad))
    if name == "masked_garbage":
        mask = rng.random((b, n)) > 0.15
        bad = np.array([np.nan, 1e30, -1e30], np.float32)
        holes = ~mask
        pts[holes] = bad[rng.integers(0, len(bad), size=(holes.sum(), 3))]
        nrm[holes] = np.nan
    if name in ("on_axis", "in_plane", "shell_edges", "cos_pm1"):
        _exact_geometry(name, rng, kp, frames, pts, nrm)
    return kp, frames, frame_valid, kp_mask, pts, nrm, mask


# --- K8 / K9: the dense [B, K] keypoint grid of CSHOT and SHORT_SHOT --------

# a dyadic radius: r^2, r/4, r/2 and 3r/4 are exact in float32, so pairs
# at exactly those distances are built to the bit
K8_RADIUS = K9_RADIUS = 0.5
_DENSE_CASES = ("dead_rows", "masked_garbage", "self_pairs", "on_radius",
                "invalid_frames", "empty_cloud", "ragged_n")
K8_CASES = _DENSE_CASES + ("bad_normals", "colour_edges", "colour_past_one")
K9_CASES = _DENSE_CASES + ("theta_90", "phi_180", "r_half", "bins_2x4x8")
K8_KEYS = ("keypoints", "kp_col", "frames", "frame_valid", "points",
           "normals", "col", "mask")
K9_KEYS = ("keypoints", "frames", "frame_valid", "points", "mask")
K7_RADIUS = K8_RADIUS
K7_CASES = _DENSE_CASES + ("bad_normals", "dead_tile_beside_live",
                           "k_not_multiple_of_8", "beyond_one_chunk")
K7_KEYS = ("keypoints", "frames", "frame_valid", "points", "normals",
           "mask")
# the colours of K8's colour_past_one case are normalised Lab, fed past the
# RGB conversion (no real colour is more than a distance of 1 apart)
K8_LAB_CASES = ("colour_past_one",)
# 8-bit colour pairs whose CSHOT colour distance d has d * 30 an integer
# in float32 (the soft bin's bd = 0 edge): (keypoint colour, point colours)
EDGE_COLOURS = ((56, 220, 107), ((238, 103, 215), (252, 198, 17)))


def k9_bins(name):
    """(r_bins, e_bins, a_bins) of a K9 case."""
    return (2, 4, 8) if name == "bins_2x4x8" else (2, 2, 8)


def _place_exact(kp, frames, pts, offs, per_cloud=4):
    """Put the first `per_cloud` keypoints of each cloud on a 1/64 grid
    with frames of 0 / +-1 entries, and points at the local offsets `offs`
    around each (in place of the cloud's last points): local coordinates
    and squared distances are exact in float32 on both sides of the
    comparison (exact differences and the matmul identity)."""
    m = len(offs)
    for i in range(kp.shape[0]):
        for s in range(per_cloud):
            fr = _EXACT_FRAMES[s % len(_EXACT_FRAMES)]
            frames[i, s] = fr
            kp[i, s] = np.round(kp[i, s] * 64) / 64
            rows = slice(pts.shape[1] - (s + 1) * m, pts.shape[1] - s * m)
            pts[i, rows] = kp[i, s] + offs @ fr
            d = pts[i, rows] - kp[i, s]
            loc = np.stack([(d * fr[a]).sum(-1, dtype=np.float32)
                            for a in range(3)], -1)
            assert (loc == offs).all()


def _dense_case(name, seed, n=512, k=32):
    """The inputs shared by K8 and K9 cases: (keypoints [B, K, 3], frames
    [B, K, 3, 3], frame_valid [B, K], points [B, N, 3], mask [B, N], rng),
    B = 2, at K8_RADIUS.  Rows past a cloud's keypoint count hold the
    pipelines' 1e9 pad and an invalid frame, and with 21 and 13 keypoints
    the last tile of 8 rows of each cloud is all dead."""
    rng = np.random.default_rng(seed)
    b = 2
    if name == "ragged_n":
        n = 2500
    pts = np.stack([shapes.make_instance(rng, i + 1, n=n, rotate=True)
                    for i in range(b)]).astype(np.float32)
    mask = np.ones((b, n), bool)
    counts = (21, 13)
    kp = np.full((b, k, 3), 1e9, np.float32)
    kp_mask = np.zeros((b, k), bool)
    frames = _rotations(rng, b * k).reshape(b, k, 3, 3)
    for i, c in enumerate(counts):
        idx = rng.choice(n, c, replace=False)
        kp[i, :c] = pts[i, idx] + rng.normal(scale=0.02, size=(c, 3))
        kp_mask[i, :c] = True
    frame_valid = kp_mask.copy()
    if name == "invalid_frames":
        # live rows whose frame is invalid: NaN, zero and a plain rotation
        frame_valid[:, 1:4] = False
        frames[:, 1] = np.nan
        frames[:, 2] = 0.0
    if name == "masked_garbage":
        mask = rng.random((b, n)) > 0.15
        bad = np.array([np.nan, 1e30, -1e30], np.float32)
        holes = ~mask
        pts[holes] = bad[rng.integers(0, len(bad), size=(holes.sum(), 3))]
    if name == "empty_cloud":
        mask[1] = False
    # local offsets of the exact rows: none on an azimuth sector edge (a
    # multiple of 45 degrees) but those the case is about
    local = {
        # a point on the keypoint (d^2 = 0 exactly: not used)
        "self_pairs": [[0, 0, 0], [0.125, -0.0625, 0.25],
                       [-0.25, 0.1875, -0.125], [0.0625, 0.3125, 0.1875]],
        # exactly r, and the shell edges r/4, r/2, 3r/4
        "on_radius": [[0.5, 0, 0], [0, -0.5, 0], [0, 0, 0.5], [-0.5, 0, 0],
                      [0.125, 0, 0], [0, 0.25, 0], [0, 0, -0.375]],
        # z_l = 0: theta = 90 degrees, the e-bin edge
        "theta_90": [[0.25, 0.125, 0], [-0.1875, 0.3125, 0],
                     [0.0625, -0.375, 0], [-0.25, -0.0625, 0]],
        # y_l = +0, x_l < 0: phi = 180 degrees
        "phi_180": [[-0.25, 0, 0.125], [-0.375, 0, -0.0625],
                    [-0.1875, 0, 0], [-0.4375, 0, 0.1875]],
        # |local| = r / 2: the r-bin edge
        "r_half": [[0.25, 0, 0], [0, -0.25, 0], [0, 0, 0.25], [0, 0, -0.25]],
    }
    if name in local:
        _place_exact(kp, frames, pts, np.array(local[name], np.float32))
    return kp, frames, frame_valid, pts, mask, rng


def k8_case(name):
    """(keypoints, kp_col, frames, frame_valid, points, normals, col,
    mask) -- K8_KEYS -- for CSHOT at K8_RADIUS: _dense_case's inputs with
    unit normals and 8-bit colours / 255 (normalised Lab for
    K8_LAB_CASES).  bad_normals: NaN and +-inf normal components;
    colour_edges: keypoints of EDGE_COLOURS[0] among points of that colour
    (distance 0) and of EDGE_COLOURS[1] (d * 30 = 10 and 5);
    colour_past_one: Lab values past the converter's range, so that some
    distances exceed 1 and the clamp holds them at 1."""
    kp, frames, fv, pts, mask, rng = _dense_case(name,
                                                 K8_CASES.index(name) + 70)
    b, n = mask.shape
    nrm = _unit(rng, (b, n))
    col8 = rng.integers(0, 256, (b, n, 3))
    kp8 = rng.integers(0, 256, kp.shape)
    if name == "bad_normals":
        bad = np.argwhere(rng.random((b, n)) < 0.1)
        nrm[bad[:, 0], bad[:, 1], rng.integers(0, 3, len(bad))] = \
            rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                       len(bad))
    if name == "masked_garbage":
        nrm[~mask] = np.nan
    if name == "colour_edges":
        kp8[:, :8] = EDGE_COLOURS[0]
        pick = rng.integers(0, 4, (b, n))
        for j, c in enumerate((EDGE_COLOURS[0],) + EDGE_COLOURS[1]):
            col8[pick == j] = c
    kp_col = (kp8 / np.float32(255)).astype(np.float32)
    col = (col8 / np.float32(255)).astype(np.float32)
    if name in K8_LAB_CASES:
        # L in [0, 1.5], a and b in [-1, 1]: keypoints at (0, 1, 1), a
        # third of the points at (1.5, -1, -1), distance (1.5 + 2) / 3
        kp_col = rng.uniform([0, -1, -1], [1.5, 1, 1], kp.shape)
        col = rng.uniform([0, -1, -1], [1.5, 1, 1], (b, n, 3))
        kp_col[:, :8] = (0, 1, 1)
        col[rng.random((b, n)) < 1 / 3] = (1.5, -1, -1)
        kp_col, col = kp_col.astype(np.float32), col.astype(np.float32)
    return kp, kp_col, frames, fv, pts, nrm, col, mask


def k9_case(name):
    """(keypoints, frames, frame_valid, points, mask) -- K9_KEYS -- for
    SHORT_SHOT at K9_RADIUS with the bins of k9_bins(name)."""
    kp, frames, fv, pts, mask, _ = _dense_case(name,
                                               K9_CASES.index(name) + 90)
    return kp, frames, fv, pts, mask


def k7_case(name):
    """(keypoints, frames, frame_valid, points, normals, mask) -- K7_KEYS
    -- for SHOT-352 on the dense [B, K] grid at K7_RADIUS, the live rows
    being frame_valid: _dense_case's inputs with unit normals.
    bad_normals: NaN and +-inf normal components; dead_tile_beside_live:
    the real keypoints of rows 8-15 of cloud 0 are not live, between two
    live tiles; k_not_multiple_of_8: K = 22 (a last tile of 6 rows, five
    of them live in cloud 0);
    beyond_one_chunk: N = 1100 (a second staging chunk of 76 points), a
    tenth of the points masked and some normals NaN."""
    k = 22 if name == "k_not_multiple_of_8" else 32
    n = 1100 if name == "beyond_one_chunk" else 512
    kp, frames, fv, pts, mask, rng = _dense_case(
        name, K7_CASES.index(name) + 110, n=n, k=k)
    b, n = mask.shape
    nrm = _unit(rng, (b, n))
    if name in ("bad_normals", "beyond_one_chunk"):
        bad = np.argwhere(rng.random((b, n)) < 0.1)
        nrm[bad[:, 0], bad[:, 1], rng.integers(0, 3, len(bad))] = \
            rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                       len(bad))
    if name == "beyond_one_chunk":
        mask = rng.random((b, n)) > 0.1
    if name == "masked_garbage":
        nrm[~mask] = np.nan
    if name == "dead_tile_beside_live":
        fv[0, 8:16] = False
    return kp, frames, fv, pts, nrm, mask
