"""The VoxelGridCulling contract between the port and the JAX package,
shared by tests/test_torch_culling.py (on the CPU) and chip_smoke.py's
phase 11c (on the card).

The culling decides on sorted scores (CutOff's quantiles, Auto's histogram
step, the fixed thresholds) and, when it refines, on the best-scoring
neighbour of each kept keypoint, so a score that differs in its last bits
can move a keypoint.  The contract, for each voxel keypoint:

  * it is kept by both or by neither, unless one of its scores (JAX's)
    lies within RTOL of a threshold its culling compares it with;
  * a refined keypoint kept by both has the same partner in both, unless
    it is near a threshold (its passed flags pick the list) or one of the
    lists its consolidation reads (geometry, colour, combined) is a near
    tie between the two partners: under JAX's scores the port's partner
    scores within RTOL of JAX's partner, and the two scores are not equal
    in both score sets (an exact tie in both is broken by distance order
    in both, the same way);
  * its refined position is otherwise JAX's within max(1e-5 x leaf,
    coord_tol).

Every moved keypoint is checked to be one of those; the scores themselves
are compared by the caller.
"""

import numpy as np

from point_cloud_donkey_tpu_torch.models.keypoints import (FLT_MIN,
                                                           _auto_threshold)

RTOL = 1e-4


def coord_tol(xyz):
    """16 float32 ulps of the largest coordinate: voxel means summed in
    another order (the card's against the JAX CPU's) differ by a few."""
    return 16 * float(np.finfo(np.float32).eps) * float(
        np.abs(xyz).max(initial=1.0))


def _methods(params):
    return (params.filter_method_geometry.lower(),
            params.filter_method_color.lower())


def combined_scores(geo, col):
    """The reference's combined score (culling.cpp:331-340)."""
    gmin, gmax = float(geo.min()), float(geo.max())
    cmin, cmax = float(col.min()), float(col.max())
    return ((geo - gmin) / gmax if gmax != 0 else geo * 0) + \
        ((col - cmin) / cmax if cmax != 0 else col * 0)


def thresholds(geo, col, params):
    """(t_geo, t_color, t_combined) as apply_culling_host sets them."""
    g, c = _methods(params)
    gtype = params.filter_type_geometry.lower()
    ctype = params.filter_type_color.lower()

    def quantile(s):
        srt = np.sort(s)
        return srt[min(int(params.filter_cutoff_ratio * len(srt)),
                       len(srt) - 1)]

    t_geo = t_color = t_comb = FLT_MIN
    if g != "none":
        t_geo = {"auto": lambda: _auto_threshold(np.sort(geo)),
                 "cutoff": lambda: quantile(geo),
                 "threshold": lambda: params.filter_threshold_geometry
                 }[gtype]()
    if c != "none":
        t_color = quantile(col) if ctype == "cutoff" \
            else params.filter_threshold_color
    if g != "none" and c != "none" and gtype == ctype == "cutoff":
        t_comb = quantile(combined_scores(geo, col))
    return t_geo, t_color, t_comb


def near_threshold(geo, col, params):
    """bool [K]: a score of the keypoint lies within RTOL of a threshold
    its culling compares it with."""
    g, c = _methods(params)
    t_geo, t_color, t_comb = thresholds(geo, col, params)
    near = np.zeros(len(geo), bool)
    pairs = []
    if g != "none" and c != "none" and \
            params.combine_filters == "RequireCombinedList":
        pairs.append((combined_scores(geo, col), t_comb))
    if g != "none":
        pairs.append((geo, t_geo))
    if c != "none":
        pairs.append((col, t_color))
    for s, t in pairs:
        near |= np.abs(s - t) <= RTOL * max(abs(float(t)), float(FLT_MIN))
    return near


def decisions(kp, geo, col, params):
    """The culling's decisions per voxel keypoint, as apply_culling_host
    makes them: (accept [K], partner [K] (-1 where not kept or not
    refined), the best neighbour under each list {name: [K]}, the lists
    each kept keypoint's consolidation reads {i: names})."""
    from scipy.spatial import cKDTree
    g, c = _methods(params)
    t_geo, t_color, t_comb = thresholds(geo, col, params)
    comb = combined_scores(geo, col)
    gp = geo >= t_geo if g != "none" else np.ones(len(kp), bool)
    cp = col >= t_color if c != "none" else np.ones(len(kp), bool)
    if g != "none" and c != "none":
        accept = {"RequireOne": gp | cp, "RequireBoth": gp & cp}.get(
            params.combine_filters, comb >= t_comb)
    else:
        accept = gp & cp
    partner = np.full(len(kp), -1)
    best = {}
    reads = {}
    if not params.refine_position or not accept.any():
        return accept, partner, best, reads
    lists = {"geo": geo, "col": col, "comb": comb}
    live = [k for k, on in (("geo", g != "none"), ("col", c != "none"),
                            ("comb", g != "none" and c != "none")) if on]
    for k in live:
        best[k] = np.full(len(kp), -1)
    r = params.leaf_size * 1.5
    tree = cKDTree(kp.astype(np.float64))
    for i in np.nonzero(accept)[0]:
        cand = np.asarray(tree.query_ball_point(kp[i], r * (1 + 1e-5)))
        d2 = ((kp[i][None] - kp[cand]) ** 2).sum(-1)   # as the port's
        idxs = np.sort(cand[d2 <= r * r])
        d2 = ((kp[i][None] - kp[idxs]) ** 2).sum(-1)
        order = idxs[np.argsort(d2, kind="stable")]
        for k in live:
            best[k][i] = order[np.argmax(lists[k][order])]
        if g == "none":
            reads[i], p = ("col",), best["col"][i]
        elif c == "none":
            reads[i], p = ("geo",), best["geo"][i]
        elif gp[i] and not cp[i]:
            reads[i], p = ("geo",), best["geo"][i]
        elif cp[i] and not gp[i]:
            reads[i], p = ("col",), best["col"][i]
        elif gp[i] and cp[i]:
            reads[i] = ("geo", "col", "comb")
            p = best["geo"][i] if best["geo"][i] == best["col"][i] \
                else best["comb"][i]
        else:
            reads[i], p = ("comb",), best["comb"][i]
        partner[i] = p
    return accept, partner, best, reads


def outputs(kp, accept, partner):
    """The culled keypoints the decisions give, in input order."""
    keep = np.nonzero(accept)[0]
    if (partner[keep] < 0).any():
        return kp[keep].astype(np.float32)
    return np.asarray(0.5 * (kp[partner[keep]] + kp[keep]), np.float32)


def classify(kp, want_scores, got_scores, want, got, params, what):
    """Compare a per-cloud culling (`got`, from its scores `got_scores`)
    with JAX's (`want`, from `want_scores`) on the same voxel keypoints
    `kp`, keypoint by keypoint, after checking that each output is its
    scores' decisions: the keypoints kept by one side only, those with
    another refinement partner, how many of those are near a threshold or
    a near tie, and those that are neither (``unexplained``)."""
    tol = max(1e-5 * params.leaf_size, coord_tol(kp))
    jx = decisions(kp, *want_scores, params)
    pt = decisions(kp, *got_scores, params)
    for (acc, par, _, _), out, who in ((jx, want, "JAX's"),
                                       (pt, got, "the other")):
        mine = outputs(kp, acc, par)
        assert mine.shape == out.shape and (
            np.abs(mine - out).max(initial=0.0) <= tol), \
            f"{what}: {who} culling is not its scores' decisions"
    near = near_threshold(*want_scores, params)
    lists = dict(zip(("geo", "col", "comb"),
                     (*want_scores, combined_scores(*want_scores))))
    lists_p = dict(zip(("geo", "col", "comb"),
                       (*got_scores, combined_scores(*got_scores))))

    def tied(i):
        for k in jx[3].get(i, ()):
            a, b = pt[2][k][i], jx[2][k][i]
            s, sp = lists[k], lists_p[k]
            if a >= 0 and a != b and abs(s[a] - s[b]) <= RTOL * max(
                    abs(float(s[b])), float(FLT_MIN)) and (
                    s[a] != s[b] or sp[a] != sp[b]):
                return True
        return False

    flipped = np.nonzero(jx[0] != pt[0])[0]
    both = np.nonzero(jx[0] & pt[0] & (jx[1] != pt[1]))[0]
    by_tie = [i for i in both if not near[i] and tied(i)]
    unexplained = [int(i) for i in flipped if not near[i]] + \
        [int(i) for i in both if not near[i] and i not in set(by_tie)]
    return {"kept": int(pt[0].sum()), "jax_kept": int(jx[0].sum()),
            "flipped": len(flipped), "partner": len(both),
            "tie": len(by_tie), "near": int(near.sum()),
            "ties": sum(tied(i) for i in pt[3]),
            "unexplained": unexplained}


def _line(r):
    return (f"{r['kept']} kept (JAX {r['jax_kept']}); {r['flipped']} kept "
            f"by one side only, {r['partner']} with another refinement "
            f"partner, {len(r['unexplained'])} of these neither near a "
            f"threshold nor a near tie ({r['tie']} near ties); "
            f"{r['near']} keypoints within rtol {RTOL:g} of a threshold, "
            f"{r['ties']} refinements a near tie")


def check_culled(kp, want_scores, got_scores, want, got, params, what,
                 control=None):
    """Hold a per-cloud culling to JAX's (:func:`classify`; prints the
    counts, returns them).  Without a control every moved keypoint must be
    near a threshold or a near tie.  With a control -- (scores, output) of
    the JAX package on the same cloud at the rounding of another float
    implementation -- the culling may move no more keypoints, and no more
    that are neither, than the control moves."""
    r = classify(kp, want_scores, got_scores, want, got, params, what)
    print(f"{what}: {_line(r)}")
    if control is None:
        assert not r["unexplained"], \
            f"{what}: keypoints {r['unexplained'][:10]} moved without a " \
            f"threshold or a near tie ({len(r['unexplained'])})"
        return r
    c = classify(kp, want_scores, control[0], want, control[1], params,
                 what + " control")
    print(f"{what}, the JAX control: {_line(c)}")
    for k in ("flipped", "partner"):
        assert r[k] <= c[k], f"{what}: {r[k]} keypoints {k}, the JAX " \
            f"control {c[k]}"
    assert len(r["unexplained"]) <= len(c["unexplained"]), \
        f"{what}: {len(r['unexplained'])} moved keypoints neither near a " \
        f"threshold nor a near tie, the control {len(c['unexplained'])}"
    r["control"] = c
    return r


def score_spread(got, want):
    """(share of scores off by more than rtol 1e-4, share off by more than
    rtol 1e-2, the largest relative difference) of `got` against `want`."""
    rel = np.abs(got.astype(np.float64) - want) / np.maximum(
        np.abs(want.astype(np.float64)), float(FLT_MIN))
    return (float((rel > RTOL).mean()), float((rel > 1e-2).mean()),
            float(rel.max(initial=0.0)))


def within_score_spread(reading, control):
    """Every figure of a score_spread reading at most the control's."""
    return all(a <= b for a, b in zip(reading, control))


def colour_explained(stats, want_col):
    """bool [K]: each keypoint's colour score is JAX's, or one that JAX's
    could be with the pairs that lie at a rounding of the decisions it
    counts.  `stats` [K, 5] (int) per keypoint: in-radius points,
    in-radius points whose colour distance exceeds the threshold, those
    whose distance lies within RTOL of it, points whose squared distance
    lies within the radius gate's rounding band, and those of them whose
    colour distance exceeds the threshold."""
    cnt, distant, col_amb, gate, gate_far = stats.T
    ok = (distant / np.maximum(cnt, 1)).astype(np.float32) == want_col
    for i in np.nonzero(~ok)[0]:
        for dc in range(-gate[i], gate[i] + 1):
            c = cnt[i] + dc
            dd = gate_far[i] + col_amb[i]
            for d in range(max(distant[i] - dd, 0), distant[i] + dd + 1):
                if np.float32(d / max(c, 1)) == np.float32(want_col[i]):
                    ok[i] = True
                    break
            if ok[i]:
                break
    return ok


def check_culled_features(kp, want_scores, want, got, params, what):
    """Hold the kept keypoints of a batched extraction (unrefined feature
    positions, `got`) to JAX's (`want`) on the cloud's voxel keypoints
    `kp`: each position is a voxel keypoint, and one kept by one side only
    is near a threshold.  Returns the count near a threshold."""
    from scipy.spatial import cKDTree
    assert not params.refine_position, what
    tol = coord_tol(kp)
    tree = cKDTree(kp)
    sides = []
    for pos in (want, got):
        d, i = tree.query(pos) if len(pos) else (np.zeros(0), np.zeros(0,
                                                                       int))
        assert (d <= tol).all(), f"{what}: a position off every voxel " \
            f"keypoint by {d.max():.2e}"
        sides.append(set(i.tolist()))
    near = near_threshold(*want_scores, params)
    bad = sorted(i for i in sides[0] ^ sides[1] if not near[i])
    assert not bad, f"{what}: voxel keypoints {bad[:10]} kept by one " \
        f"side only, none near a threshold"
    return int(near.sum())
