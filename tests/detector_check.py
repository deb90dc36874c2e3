"""The keypoint detectors' contract between the port and the JAX package,
shared by tests/test_torch_detectors.py (on the CPU) and chip_smoke.py's
phase 12 (on the card).

Every detector decides by comparing floats, so a value that differs in its
last bits can move a keypoint.  The contract, point by point: a point is
a keypoint of both or of neither, unless the port's value that decides it
lies at the rounding of what it is compared with --

  * Harris3D: the response r = det C - 0.04 tr(C)^2 within RTOL of the
    threshold or of the largest response within its radius (r >= that
    max keeps it), relative to the terms that cancel in it, |det C| + 0.04
    tr(C)^2 (the larger of the point's and its neighbours'): on a smooth
    surface r is a small difference of large raw sums, which two
    summation orders (or normals an ulp apart) move by ~1e-5 of them.
    Where the two sides' normals differ (at a scene's NormalRadius a
    normal rests on few points: up to ~1e-3 rad apart), the comparison may
    also move by the responses' difference under the two normal sets
    (`harris_spread`: the point's and the largest within its radius); or
    a pair of the point at the rounding of the radius, which can move the
    point's sums and its neighbourhood's max;
  * ISS3D: e2/e1 within RTOL of Gamma21, e3/e2 within RTOL of Gamma32, e3
    within RTOL of 0 (of e2), the saliency within RTOL of its non-max
    radius's max -- each widened by the scatter's rounding: the scatter
    comes from moments of raw coordinates (S2 / w - S1 q^T - ...), whose
    cancellation leaves an absolute error of ~16 eps |p|^2 in each
    eigenvalue, ~1e-3 of a 5 cm neighbourhood's at a scene's metres --
    or a pair of the point at the rounding of the non-max or the salient
    radius (`band_pairs`), which moves a count;
  * SIFT3D: a DoG within `spread` (or RTOL) of a value it is strictly
    compared with.  The intensity is the PCA curvature at the support
    radius, whose moment identity cancels (cov = S2/S0 - c c^T over a
    neighbourhood far smaller than the cloud): two sums in another order
    differ by up to ~5e-5 where the curvature is ~1e-2 (the JAX package's
    tiled and dense SIFT3D disagree on such points too, its
    `_tiled_sift3d`).  Smoothing averages, so each DoG moves by at most
    twice the largest intensity difference, and a comparison of two DoGs
    by at most four times it: `spread` is that bound, measured on the two
    intensities, or 0 where both sides read the same intensity.

Features: a keypoint both keep has a feature on both sides or on neither
but where its refined positions differ (a moved keypoint's neighbourhood
can gain or lose a point at the radius: FPFH needs 5 neighbours), and
>= 97% of the feature pairs lie at cosine > 0.999 (the training contract).

A refined Harris3D position kept by both lies within POS_RTOL x radius
plus the forward error of its 3x3 solve, 8 eps cond(C) |x| (float32 eps;
C's and b's sums in another order move them by a few eps, and a flat
neighbourhood's normal sums are ill-conditioned), plus the distance
between the port's solutions on the two normal sets, of JAX's, unless
the port's refinement gate (|det C| > 1e-9, the solution within the
radius) is within that of its threshold there, or a pair of the point at
the rounding of the radius moves its sums.
"""

import numpy as np
import torch

from point_cloud_donkey_tpu_torch.ops import keypoint_detectors as kd
from point_cloud_donkey_tpu_torch.ops.neighbors import full_fp32

RTOL = 1e-4
BAND = 1e-5
POS_RTOL = 1e-4


def _near(a, b, rtol=RTOL, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= np.maximum(rtol * np.maximum(np.abs(a),
                                                          np.abs(b)), atol)


def band_pairs(points: np.ndarray, radius: float) -> np.ndarray:
    """bool [N]: the point has another at the rounding of the radius: a
    squared distance within BAND r^2 plus the matmul identity's rounding,
    16 eps |p|^2 (q^2 + p^2 - 2 q.p on raw coordinates: at a scene's
    metres from the origin it moves d^2 by ~1e-3 of a 5 cm radius's r^2),
    of r^2."""
    from scipy.spatial import cKDTree
    p64 = np.asarray(points, np.float64)
    r2 = radius * radius
    tol = BAND * r2 + 16 * float(np.finfo(np.float32).eps) \
        * (p64 * p64).sum(1)
    tree = cKDTree(p64)
    outer = tree.query_ball_point(p64, np.sqrt(r2 + tol),
                                  return_length=True)
    inner = tree.query_ball_point(p64, np.sqrt(np.maximum(r2 - tol, 0.0)),
                                  return_length=True)
    return outer != inner


def harris_terms(points, normals, radius, threshold, device="cpu"):
    """The port's Harris3D values of every point of one cloud: response,
    in-radius max, the cancelling terms' size and its in-radius max, |det
    C| and the refined point's squared distance."""
    p = torch.tensor(np.asarray(points, np.float32), device=device)
    nrm = torch.tensor(np.asarray(normals, np.float32), device=device)
    mask = torch.ones(len(points), dtype=torch.bool, device=device)
    with full_fp32():
        nn = kd.outer9(nrm)
        nntp = torch.einsum("jab,jb->ja", nn.reshape(-1, 3, 3), p)
        _, sums = kd._in_radius_sums(p, mask, torch.cat([nn, nntp], 1),
                                     radius)
        C = sums[:, :9].reshape(-1, 3, 3)
        r = kd.harris_response(C)
        _, nmax = kd.neighbor_max(p, mask, r, radius)
        det = torch.abs(kd.det3(C))
        tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
        scale = det + 0.04 * tr * tr
        _, smax = kd.neighbor_max(p, mask, scale, radius)
        eye = torch.eye(3, dtype=p.dtype, device=p.device)
        a = torch.where((det > 1e-9)[:, None, None], C, eye)
        x = torch.linalg.solve(a, sums[:, 9:12, None])[..., 0]
        d2 = torch.sum((x - p) ** 2, dim=1)
    out = {k: v.cpu().numpy() for k, v in
           dict(r=r, nmax=nmax, scale=scale, smax=smax, det=det, d2=d2,
                x=x).items()}
    out["cond"] = np.linalg.cond(C.cpu().numpy().astype(np.float64))
    out["band"] = band_pairs(points, radius)
    return out


def harris_spread(points, normals, want_normals, radius, device="cpu"):
    """How far the port's normals and JAX's can move Harris3D's values,
    both computed by the port: {"r": [N] the response comparison's bound,
    |r(normals) - r(want_normals)| at the point plus its largest value
    within the radius; "x": [N] the refined positions' distance}."""
    a = harris_terms(points, normals, radius, 0.0, device)
    b = harris_terms(points, want_normals, radius, 0.0, device)
    d = np.abs(a["r"].astype(np.float64) - b["r"])
    p = torch.tensor(np.asarray(points, np.float32), device=device)
    mask = torch.ones(len(points), dtype=torch.bool, device=device)
    with full_fp32():
        _, dmax = kd.neighbor_max(p, mask, torch.tensor(
            d, dtype=torch.float32, device=device), radius)
    return {"r": d + dmax.cpu().numpy(),
            "x": np.linalg.norm(a["x"].astype(np.float64) - b["x"], axis=1)}


def harris_near(terms, radius, threshold, spread=None):
    s = 0.0 if spread is None else spread["r"]
    tol = RTOL * np.maximum(terms["scale"], terms["smax"]) + s
    r = terms["r"].astype(np.float64)
    return (np.abs(r - threshold) <= RTOL * terms["scale"] + s) \
        | (np.abs(r - terms["nmax"]) <= tol) | terms["band"]


def iss_terms(points, params, device="cpu"):
    """The port's ISS3D values of every point: the eigenvalue ratios, e3,
    the saliency and its non-max radius's max."""
    p = torch.tensor(np.asarray(points, np.float32), device=device)
    mask = torch.ones(len(points), dtype=torch.bool, device=device)
    sal_r = float(params.iss_salient_radius)
    with full_fp32():
        ones = torch.ones((len(points), 1), dtype=p.dtype, device=p.device)
        cnt, _ = kd._in_radius_sums(p, mask, ones, sal_r)
        wj = 1.0 / torch.clamp(cnt.to(p.dtype), min=1.0)
        payload = torch.cat([wj[:, None], wj[:, None] * p,
                             wj[:, None] * kd.outer9(p)], 1)
        _, sums = kd._in_radius_sums(p, mask, payload, sal_r)
        S = kd.iss_scatter(p, torch.clamp(sums[:, 0], min=1e-12),
                           sums[:, 1:4], sums[:, 4:13].reshape(-1, 3, 3))
        vals, _ = kd.eigh3x3(S)
        e1, e2, e3 = vals[:, 2], vals[:, 1], vals[:, 0]
        ok, _ = kd.iss_saliency(S, float(params.iss_gamma21),
                                float(params.iss_gamma32))
        sal = torch.where(ok, e3, torch.full_like(e3, float("-inf")))
        _, nmax = kd.neighbor_max(p, mask, sal, float(params.iss_nonmax_radius))
        r21 = e2 / torch.clamp(e1, min=1e-12)
        r32 = e3 / torch.clamp(e2, min=1e-12)
    out = {k: v.cpu().numpy() for k, v in dict(
        r21=r21, r32=r32, e1=e1, e2=e2, e3=e3, sal=sal, nmax=nmax).items()}
    p64 = np.asarray(points, np.float64)
    out["dl"] = 16 * float(np.finfo(np.float32).eps) * (p64 * p64).sum(1)
    out["band"] = band_pairs(points, float(params.iss_nonmax_radius)) \
        | band_pairs(points, sal_r)
    return out


def iss_near(terms, params):
    sal, nmax, dl = terms["sal"], terms["nmax"], terms["dl"]
    fin = np.isfinite(sal) & np.isfinite(nmax)
    e1 = np.maximum(np.abs(terms["e1"].astype(np.float64)), 1e-12)
    e2 = np.maximum(np.abs(terms["e2"].astype(np.float64)), 1e-12)
    g21, g32 = float(params.iss_gamma21), float(params.iss_gamma32)
    return ((np.abs(terms["r21"] - g21) <= RTOL * g21 + dl * (1 + g21) / e1)
            | (np.abs(terms["r32"] - g32) <= RTOL * g32 + dl * (1 + g32) / e2)
            | (np.abs(terms["e3"]) <= RTOL * e2 + dl)
            | (fin & (np.abs(np.where(fin, sal, 0.0) - np.where(fin, nmax, 0.0))
                      <= RTOL * np.abs(np.where(fin, sal, 0.0)) + 2 * dl))
            | terms["band"])


def sift_terms(points, intensity, min_scale, device="cpu", n_octaves=4,
               scales_per_octave=3):
    """The port's SIFT3D values: per octave, the three DoG layers [3, N]
    and the neighbours' min and max over them (the point excluded)."""
    p = torch.tensor(np.asarray(points, np.float32), device=device)
    inten = torch.as_tensor(intensity, device=device)
    mask = torch.ones(len(points), dtype=torch.bool, device=device)
    out = []
    with full_fp32():
        for o in range(n_octaves):
            sig = kd.sift_sigmas(min_scale, o, scales_per_octave)
            sm = [kd.gaussian_smooth(p, mask, inten, s) for s in sig]
            dogs = torch.stack([sm[i + 1] - sm[i] for i in range(3)])
            any_nb, lo, hi = kd.sift_extrema(p, mask, dogs.T.contiguous(),
                                             sig[1])
            out.append({"dogs": dogs.cpu().numpy(), "lo": lo.cpu().numpy(),
                        "hi": hi.cpu().numpy(),
                        "any": any_nb.cpu().numpy()})
    return out


def sift_near(terms, spread):
    """bool [N]: a DoG of some octave's interior layer within the spread
    (or RTOL) of a value it is compared with."""
    near = np.zeros(terms[0]["dogs"].shape[1], bool)
    for t in terms:
        d = t["dogs"]
        dog = d[1]
        for other in (t["lo"], t["hi"], d[0], d[2]):
            fin = np.isfinite(other)
            near |= fin & _near(dog, np.where(fin, other, 0), atol=spread)
    return near


def sift_spread(intensity_a, intensity_b) -> float:
    """The bound on how far a DoG comparison can move between two
    intensity fields (module docstring)."""
    return 4.0 * float(np.max(np.abs(np.asarray(intensity_a, np.float64)
                                      - np.asarray(intensity_b))))


def unexplained(got_keep, want_keep, near):
    """Indices whose decisions differ and are not near ties."""
    diff = np.asarray(got_keep) != np.asarray(want_keep)
    return np.flatnonzero(diff & ~np.asarray(near))


def harris_positions_unexplained(got_pos, want_pos, both, terms, radius,
                                 spread=None):
    """Indices kept by both whose refined positions differ beyond the
    position contract (module docstring; plus the distance the two normal
    sets put between the port's solutions, `spread["x"]`) while the
    port's refinement gate is not near its threshold."""
    eps = float(np.finfo(np.float32).eps)
    sx = 0.0 if spread is None else spread["x"]
    tol = POS_RTOL * radius + 8 * eps * terms["cond"] \
        * np.linalg.norm(terms["x"], axis=1) + sx
    off = np.linalg.norm(np.asarray(got_pos, np.float64)
                         - np.asarray(want_pos), axis=1) > tol
    reach = np.sqrt(terms["d2"].astype(np.float64))
    gate = _near(terms["det"], 1e-9, rtol=1e-3) \
        | (np.abs(reach - radius) <= RTOL * radius + sx) | terms["band"]
    return np.flatnonzero(both & off & ~gate)


def feature_pairs(pos, keep, feat_pos, feat_desc, want_keep, want_kp_pos,
                  want_feat_pos, want_desc):
    """The features of the keypoints both sides keep, paired through the
    keypoint (each side's feature sits at its keypoint's position):
    (cosines [pairs], unexplained count -- a feature on one side only at a
    keypoint that did not move)."""
    want_pos = np.zeros_like(pos)
    want_pos[want_keep] = want_kp_pos
    mine = {tuple(p): i for i, p in enumerate(feat_pos)}
    theirs = {tuple(p): i for i, p in enumerate(want_feat_pos)}
    cos, unexplained = [], 0
    for j in np.flatnonzero(keep & want_keep):
        a, b = mine.get(tuple(pos[j])), theirs.get(tuple(want_pos[j]))
        if a is None or b is None:
            if (a is None) != (b is None) and np.array_equal(pos[j],
                                                             want_pos[j]):
                unexplained += 1
            continue
        u = feat_desc[a].astype(np.float64)
        v = want_desc[b].astype(np.float64)
        cos.append(float(u @ v / max(np.linalg.norm(u) * np.linalg.norm(v),
                                     1e-30)))
    return np.asarray(cos), unexplained
