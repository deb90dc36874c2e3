"""The descriptor zoo's threshold decisions between the port and the JAX
package, shared by tests/test_torch_zoo2_ops.py (on the CPU) and
chip_smoke.py's phase 13 (on the card).  numpy only.

Several descriptors decide by comparing floats, so a value that differs
in its last bits between two correct implementations can flip the
decision.  The contract, decision by decision: the two sides decide alike
unless the deciding value lies within a stated rounding band of its
threshold --

  * BSHOT: a group's bits (the entries, pair and triple sums against 0.9 x
    the group's sum, the sum against 0 -- a group empty on one side only,
    where a pair at the rounding of the radius enters one side's SHOT):
    within 4 x the largest difference of the group's SHOT entries between
    the two sides, plus RTOL of the sum;
  * RoPS: an axis's sign (the count of neighbours on its positive side
    against the rest): within the count of neighbours whose dot product
    with the axis lies within EPS_DOT x |p - q| of 0; or the axis itself
    where two eigenvalues of the scatter lie within EIG_RTOL of each other;
  * GASD: an axis's sign (the skewness sum against 0): within SKEW_RTOL of
    the sum of the terms' magnitudes; or the eigenvalue gap as RoPS;
  * NARF: the roll (the argmax of |beam|): the two largest within
    ROLL_ATOL;
  * GRSD: a point's surface class (r_min, r_max against 0.15, 0.5 and 2
    radii): within GRSD_RTOL of one of them -- d / (2 sin(angle / 2))
    amplifies the rounding of a near-parallel normal pair's cosine by
    1 / (angle sin angle);
  * RSD's histogram: a pair's bin value within BIN_ATOL of an integer (a
    bin edge); RSD's (r_min, r_max): each within 1e-5 plus 8 eps / (a sin
    a) relative, a the angle of the pair that attains it (the arccos of a
    near-1 cosine amplifies its rounding by 1 / sin a, the radius
    d / (2 sin(a / 2)) that by 1 / a);
  * RIFT's intensity gradients (a 3 x 3 solve a point, its matrix from
    the moments of raw coordinates, which cancel): each within 1e-4 of
    the largest plus 32 eps cond(A) (1 + |p|^2 / r^2) |g|, cond(A) the
    condition number of the point's neighbour scatter;
  * RIFT's angle bins: a row whose pairs include one with |cos| within
    ACOS_ATOL of 1 (arccos amplifies the cosine's rounding by 1 / sin);
  * CVFH's region growing: a pair within the distance tolerance whose
    normals' cosine lies within COS_ATOL of cos(eps), or a curvature
    within COS_ATOL of the threshold;
  * the LRF variants (ops/lrf.py), a frame off by more than 2e-3: SHOTNA
    a sign vote (x on the offsets, z on the normals) at |plus - minus| <=
    VOTE_BAND (one neighbour's dot at the rounding of 0 moves it by 2);
    FLARE and BOARD the viewpoint dot z.(0 - q) within VIEW_RTOL |q| of 0,
    or the argmax's runner-up within ARGMAX_RTOL of the best height
    (FLARE) or cosine (BOARD), its candidates taken with the gate's
    rounding band (a point within GATE_RTOL of the radius, BOARD's d^2 <=
    1e-12 trap within IDENTITY_BAND); any of them where two eigenvalues
    of the frame's covariance lie within EIG_RTOL;
  * CGF's raw rows: a pair's log-radius, polar or azimuth bin value within
    CGF_EDGE_ATOL of a bin edge moves one count between bins, and a point
    within GATE_RTOL of the radius changes the row's count;
  * SHOT under FLARE or BOARD (a row off by more than cosine 0.999): the
    neighbour the x axis points at lies on the azimuth sector boundary
    y_l = 0 by construction, and PCL's binning gives its radial, elevation
    and cosine interpolation whole to one side, so rounding decides which:
    the row agrees once that neighbour is moved SECTOR_MOVE x the radius
    to either side of the boundary (sector_moved_near).

Each function returns, per decision, whether it lies in its band; the
tests and phase 13 count the decisions that differ, and fail on one that
differs outside its band.
"""

import numpy as np

RTOL = 1e-5
EPS_DOT = 1e-5
EIG_RTOL = 1e-4
SKEW_RTOL = 1e-4
ROLL_ATOL = 1e-5
GRSD_RTOL = 2e-3
BIN_ATOL = 1e-4
COS_ATOL = 1e-5
ACOS_ATOL = 1e-5
VOTE_BAND = 2
VIEW_RTOL = 1e-5
ARGMAX_RTOL = 1e-5
GATE_RTOL = 1e-5
IDENTITY_BAND = 1e-9
CGF_EDGE_ATOL = 1e-4
SECTOR_MOVE = 1e-4

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def bshot_near(shot_a: np.ndarray, shot_b: np.ndarray) -> np.ndarray:
    """[..., 88] True where a group's binarisation lies in its band."""
    g_a = np.asarray(shot_a, np.float64).reshape(shot_a.shape[:-1] + (-1, 4))
    g_b = np.asarray(shot_b, np.float64).reshape(g_a.shape)
    s = g_b.sum(-1)
    live = (s != 0) | (g_a.sum(-1) != 0)
    spread = np.abs(g_a - g_b).max(-1)
    band = 4.0 * spread + RTOL * np.abs(s)
    vals = [g_b[..., i] for i in range(4)] \
        + [g_b[..., a] + g_b[..., b] for a, b in _PAIRS] \
        + [g_b[..., a] + g_b[..., b] + g_b[..., c] for a, b, c in _TRIPLES]
    margin = np.min(np.abs(np.stack(vals, -1) - 0.9 * s[..., None]), -1)
    return live & ((margin <= band) | (np.abs(s) <= band))


def bits_differ(bits_a: np.ndarray, bits_b: np.ndarray) -> np.ndarray:
    """[..., 88] True where a group's four bits differ."""
    a = np.asarray(bits_a).reshape(bits_a.shape[:-1] + (-1, 4))
    b = np.asarray(bits_b).reshape(a.shape)
    return (a != b).any(-1)


def _eig_close(cov: np.ndarray) -> np.ndarray:
    vals = np.linalg.eigvalsh(cov)
    scale = np.maximum(np.abs(vals).max(-1), 1e-30)
    gaps = np.diff(vals, axis=-1) / scale[..., None]
    return (gaps <= EIG_RTOL).any(-1)


def rops_near(rel: np.ndarray, use: np.ndarray, dist: np.ndarray,
              radius: float) -> np.ndarray:
    """[K] True where a keypoint's RoPS frame lies in its band: rel [K, M,
    3] its neighbours' offsets, used where `use`."""
    rel = np.where(use[..., None], np.asarray(rel, np.float64), 0.0)
    w = np.where(use, np.maximum(radius - dist, 0.0), 0.0)
    cov = np.einsum("km,kma,kmb->kab", w, rel, rel) \
        / np.maximum(w.sum(1), 1e-12)[:, None, None]
    near = _eig_close(cov)
    _, vecs = np.linalg.eigh(cov)
    length = np.linalg.norm(rel, axis=-1)
    for axis in (0, 2):
        dots = np.einsum("kma,ka->km", rel, vecs[:, :, axis])
        plus = (use & (dots >= 0)).sum(1)
        minus = use.sum(1) - plus
        tied = (use & (np.abs(dots) <= EPS_DOT * length)).sum(1)
        near |= np.abs(plus - minus) <= 2 * tied
    return near


def gasd_near(points: np.ndarray) -> bool:
    """True where a cloud's GASD frame lies in its band (points [N, 3],
    the live ones)."""
    p = np.asarray(points, np.float64)
    c = p - p.mean(0)
    cov = c.T @ c / len(p)
    if _eig_close(cov[None])[0]:
        return True
    _, vecs = np.linalg.eigh(cov)
    for axis in (0, 2):
        t = (c @ vecs[:, axis]) ** 3
        if abs(t.sum()) <= SKEW_RTOL * np.abs(t).sum():
            return True
    return False


def narf_near(desc: np.ndarray) -> np.ndarray:
    """[K] True where the two largest |beam| of a row (before the roll; the
    roll keeps the multiset) lie within ROLL_ATOL."""
    top = np.sort(np.abs(np.asarray(desc, np.float64)), -1)[:, -2:]
    return top[:, 1] - top[:, 0] <= ROLL_ATOL


def grsd_near(r_min: np.ndarray, r_max: np.ndarray,
              radius: float) -> np.ndarray:
    """[N] True where a point's surface class lies in its band."""
    near = np.zeros(np.shape(r_min), bool)
    for v in (np.asarray(r_min, np.float64), np.asarray(r_max, np.float64)):
        for t in (0.15, 0.5, 2.0):
            near |= np.abs(v - t * radius) <= GRSD_RTOL * t * radius
    return near


def bin_edge_near(values: np.ndarray, use: np.ndarray) -> np.ndarray:
    """[K] True where a used pair's bin value ([K, M], bins of width 1)
    lies within BIN_ATOL of a bin edge."""
    v = np.where(use, np.asarray(values, np.float64), 0.5)
    return (use & (np.abs(v - np.round(v)) <= BIN_ATOL)).any(-1)


def rsd_radius_band(dist: np.ndarray, ang: np.ndarray, use: np.ndarray,
                    radius: float) -> np.ndarray:
    """[K, 2] relative bands of RSD's (r_min, r_max) (dist, ang [K, M] of
    the pairs, used where `use`)."""
    a = np.asarray(ang, np.float64)
    r = np.asarray(dist, np.float64) / np.maximum(2.0 * np.sin(a / 2.0),
                                                  1e-3)
    r = np.clip(r, 0.0, 15.0 * radius)
    amp = 8 * 6e-8 / np.maximum(a * np.sin(a), 1e-30)
    lo = np.where(use, r, np.inf).argmin(-1)
    hi = np.where(use, r, -np.inf).argmax(-1)
    pick = np.stack([np.take_along_axis(amp, lo[:, None], -1)[:, 0],
                     np.take_along_axis(amp, hi[:, None], -1)[:, 0]], -1)
    return 1e-5 + pick


def gradient_band(points: np.ndarray, mask: np.ndarray, grads: np.ndarray,
                  radius: float) -> np.ndarray:
    """[N] absolute bands of the intensity gradients `grads` [N, 3]."""
    p = np.asarray(points, np.float64)
    live = np.flatnonzero(mask)
    scale = np.abs(grads).max()
    band = np.full(len(p), 1e-4 * scale)
    for i in live:
        q = p[live] - p[i]
        q = q[(q * q).sum(1) <= radius * radius]
        cond = np.linalg.cond(q.T @ q + 1e-8 * np.eye(3))
        band[i] += 32 * 6e-8 * cond * (1 + (p[i] ** 2).sum() / radius ** 2) \
            * np.abs(grads[i]).max()
    return band


def arccos_near(cos: np.ndarray, use: np.ndarray) -> np.ndarray:
    """[K] True where a used pair's cosine ([K, M]) lies within ACOS_ATOL
    of +-1."""
    c = np.abs(np.asarray(cos, np.float64))
    return (use & (1.0 - c <= ACOS_ATOL)).any(-1)


def cvfh_near(points: np.ndarray, normals: np.ndarray,
              curvature: np.ndarray, dist_tol: float, eps_angle: float,
              curv_threshold: float) -> int:
    """The count of CVFH's region-growing decisions in their band: pairs
    within dist_tol whose cosine lies within COS_ATOL of cos(eps), and
    curvatures within COS_ATOL of the threshold."""
    p = np.asarray(points, np.float64)
    n = np.asarray(normals, np.float64)
    count = int((np.abs(np.asarray(curvature, np.float64) - curv_threshold)
                 <= COS_ATOL).sum())
    ce = np.cos(eps_angle)
    for r0 in range(0, len(p), 1024):
        d2 = ((p[r0:r0 + 1024, None] - p[None]) ** 2).sum(-1)
        cos = n[r0:r0 + 1024] @ n.T
        count += int(((d2 <= dist_tol * dist_tol)
                      & (np.abs(cos - ce) <= COS_ATOL)).sum())
    return count


def _votes_near(dots: np.ndarray, gate: np.ndarray) -> np.ndarray:
    plus = (gate & (dots >= 0)).sum(-1)
    return np.abs(2 * plus - gate.sum(-1)) <= VOTE_BAND


def _top2_near(score: np.ndarray, strict: np.ndarray, loose: np.ndarray,
               scale: np.ndarray) -> np.ndarray:
    """[K] True where the argmax of `score` over the `strict` candidates
    may differ from that over any set between `strict` and `loose`, or its
    runner-up lies within ARGMAX_RTOL x `scale` of the best."""
    s = np.where(strict, score, -np.inf)
    top = np.sort(s, -1)[:, -2:]
    near = top[:, 1] - top[:, 0] <= ARGMAX_RTOL * scale
    best_loose = np.where(loose, score, -np.inf).max(-1)
    return near | (best_loose > top[:, 1])


def lrf_variant_near(kind: str, kp: np.ndarray, points: np.ndarray,
                     normals: np.ndarray, frames: np.ndarray, radius: float,
                     tangent_radius: float = 0.0) -> np.ndarray:
    """[K] True where the frame `frames` [K, 3, 3] (rows x, y, z) of the
    ReferenceFrameType `kind` at the keypoints kp [K, 3] on the live
    points [N, 3] (normals [N, 3]) lies in its rounding band (module
    docstring)."""
    p = np.asarray(points, np.float64)
    q = np.asarray(kp, np.float64)
    f = np.asarray(frames, np.float64)
    nrm = np.asarray(normals, np.float64)
    rel = p[None] - q[:, None]
    d2 = (rel * rel).sum(-1)
    in_r = d2 <= radius * radius
    loose_r = d2 <= radius * radius * (1 + GATE_RTOL) ** 2
    if kind == "SHOTNA":
        w = np.where(in_r, radius - np.sqrt(d2), 0.0)
        cov = np.einsum("km,kma,kmb->kab", w, rel, rel) \
            / np.maximum(w.sum(1), 1e-30)[:, None, None]
        near = _eig_close(cov)
        near |= _votes_near(np.einsum("kma,ka->km", rel, f[:, 0]), in_r)
        near |= _votes_near(np.einsum("ma,ka->km", nrm, f[:, 2]), in_r)
        return near
    cnt = in_r.sum(1)
    mean = (in_r.astype(np.float64) @ p) / np.maximum(cnt, 1)[:, None]
    c = np.where(in_r[..., None], p[None] - mean[:, None], 0.0)
    cov = np.einsum("kma,kmb->kab", c, c) / np.maximum(cnt, 1)[:, None,
                                                               None]
    z = f[:, 2]
    near = _eig_close(cov)
    near |= np.abs((z * q).sum(-1)) <= VIEW_RTOL * np.linalg.norm(q, axis=-1)
    if kind == "FLARE":
        t2 = tangent_radius * tangent_radius
        h = np.einsum("kma,ka->km", rel, z)
        scale = np.abs(h).max(-1) + np.linalg.norm(q, axis=-1)
        near |= _top2_near(h, d2 <= t2, d2 <= t2 * (1 + GATE_RTOL) ** 2,
                           scale)
    else:
        cosdev = np.einsum("ma,ka->km", nrm, z)
        strict = in_r & (d2 > 1e-12)
        loose = loose_r & (d2 > 1e-12 - IDENTITY_BAND)
        near |= _top2_near(-cosdev, strict & (d2 > IDENTITY_BAND), loose,
                           np.ones(len(q)))
    return near


def cgf_rows_near(rows_a: np.ndarray, rows_b: np.ndarray, count: np.ndarray,
                  kp: np.ndarray, frames: np.ndarray, kp_normals: np.ndarray,
                  frame_valid: np.ndarray, points: np.ndarray,
                  radius: float) -> np.ndarray:
    """[K] True where CGF raw rows a and b [K, 2244] agree within 1e-6 or
    differ by what their rounding bands allow (module docstring): at most
    2 / count of moved mass a pair at a bin edge, or any change with a
    point within GATE_RTOL of the radius.  `count` [K] is a's neighbour
    count; the frames are the rows' frame (flipped and replaced by the
    identity as the rows did); `points` the live points."""
    p = np.asarray(points, np.float64)
    q = np.asarray(kp, np.float64)
    f = np.asarray(frames, np.float64)
    eye = np.broadcast_to(np.eye(3), f.shape)
    f = np.where(np.asarray(frame_valid)[:, None, None], f, eye)
    flip = ((f[:, 2] * np.asarray(kp_normals, np.float64)).sum(-1) < 0) \
        & np.asarray(frame_valid)
    f = np.where(flip[:, None, None], -f, f)
    rel = p[None] - q[:, None]
    d = np.sqrt((rel * rel).sum(-1))
    use = (d <= radius) & (d > 1e-15)
    loc = np.einsum("kma,kba->kmb", rel, f)
    r = np.maximum(d, 1e-30)
    rmin = 0.05 * radius
    v_r = 16 * (np.log(r) - np.log(rmin)) / np.log(radius / rmin) + 1.0
    v_t = 11 * np.degrees(np.arccos(np.clip(loc[..., 2] / r, -1, 1))) / 180
    v_p = 12 * (np.degrees(np.arctan2(loc[..., 1], loc[..., 0])) + 180) / 360
    edge = np.zeros(d.shape, bool)
    for v in (v_r, v_t, v_p):
        edge |= np.abs(v - np.round(v)) <= CGF_EDGE_ATOL
    n_edge = (use & edge).sum(-1)
    gate = (np.abs(d - radius) <= GATE_RTOL * radius).any(-1)
    moved = np.abs(np.asarray(rows_a, np.float64)
                   - np.asarray(rows_b, np.float64)).sum(-1) \
        * np.asarray(count, np.float64)
    same = np.abs(np.asarray(rows_a) - np.asarray(rows_b)).max(-1) <= 1e-6
    return same | gate | (moved <= 2 * n_edge + 1e-3)


def x_neighbour(kind: str, q: np.ndarray, frame: np.ndarray,
                points: np.ndarray, normals: np.ndarray, radius: float,
                tangent_radius: float) -> int:
    """The index of the point FLARE's / BOARD's x axis of the frame
    [3, 3] at q points at (ops/lrf.py), in float64."""
    p = np.asarray(points, np.float64)
    rel = p - np.asarray(q, np.float64)
    d2 = (rel * rel).sum(1)
    z = np.asarray(frame, np.float64)[2]
    if kind == "FLARE":
        cand, score = d2 <= tangent_radius ** 2, rel @ z
    else:
        cand = (d2 <= radius ** 2) & (d2 > 1e-12)
        score = -(np.asarray(normals, np.float64) @ z)
    return int(np.argmax(np.where(cand, score, -np.inf)))


def sector_moved_near(kind: str, got: np.ndarray, want: np.ndarray,
                      q: np.ndarray, frame: np.ndarray, points: np.ndarray,
                      normals: np.ndarray, frame_radius: float,
                      radius: float, shot) -> bool:
    """True where the SHOT rows got and want agree at cosine > 0.999, or
    agree so once FLARE's / BOARD's x neighbour is moved across y_l = 0
    (module docstring): `shot(points)` recomputes the got side's row at q
    in `frame` on the moved points."""
    def cos(a, b):
        return float((a * b).sum() / max(np.linalg.norm(a)
                                         * np.linalg.norm(b), 1e-30))

    if cos(got, want) > 0.999:
        return True
    j = x_neighbour(kind, q, frame, points, normals, frame_radius,
                    frame_radius / 5.0)
    for side in (1.0, -1.0):
        moved = np.array(points, np.float32)
        moved[j] += np.float32(side * SECTOR_MOVE * radius) \
            * np.asarray(frame, np.float32)[1]
        if cos(shot(moved), want) > 0.999:
            return True
    return False


def report(what: str, differ: np.ndarray, near: np.ndarray) -> int:
    """Print the decisions that differ and those in their band; assert
    every difference is in its band; returns the count that differ."""
    differ = np.asarray(differ, bool)
    near = np.broadcast_to(np.asarray(near, bool), differ.shape)
    bad = differ & ~near
    print(f"{what}: {int(differ.sum())} of {differ.size} decisions differ, "
          f"{int(near.sum())} lie in their rounding band")
    assert not bad.any(), f"{what}: {int(bad.sum())} decisions differ " \
        f"outside their band, e.g. {np.argwhere(bad)[:5].tolist()}"
    return int(differ.sum())
