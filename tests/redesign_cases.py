"""Edge-case inputs for K1 (radius moments) and K4 (chi-square top-k), made
with numpy from a seed: the cases a cell-binned radius sweep and a
register-tiled chi-square kernel make risky.  tests/test_torch_redesign.py
holds the plain twins against the JAX package on them (CPU);
tests/test_torch_cuda.py holds the CUDA kernels against the twins on them
(card).  numpy only: both files import this module."""

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
