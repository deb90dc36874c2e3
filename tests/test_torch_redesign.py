"""The plain twins of K1 (radius moments) and K4 (chi-square top-k) against
the JAX package's Pallas kernels, run in interpret mode on the CPU, at the
edge cases of tests/redesign_cases.py: padded and invalid queries, masked
points holding NaN and huge coordinates, a cloud far wider than the
radius, ragged N; ragged D, C off the tiles, k in {1, 2, 3}, masked,
all-zero and duplicated codewords.  tests/test_torch_cuda.py holds the CUDA
kernels against these twins on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from redesign_cases import K1_CASES, K1_RADIUS, K4_DIMS, k1_case, k4_case
from torch_parity import assert_topk_close, n, t

from point_cloud_donkey_tpu.ops.pallas import lrf_moments as jlrf
from point_cloud_donkey_tpu.ops.pallas.chisq import \
    chi_square_distance_matrix_pallas
from point_cloud_donkey_tpu_torch.ops.kernels import chisq as tchisq
from point_cloud_donkey_tpu_torch.ops.kernels import lrf_moments as tlrfm


def _jax_moments(q, q_mask, p, mask, radius):
    """`_moments_call` per cloud on the lanes the JAX package builds:
    masked points and invalid queries parked at 1e9 -> (mom [B, Q, 10],
    count [B, Q])."""
    moms, cnts = [], []
    for qb, qm, pb, pm in zip(q, q_mask, p, mask):
        qs = np.where(qm[:, None], qb, 1e9).astype(np.float32)
        ps = np.where(pm[:, None], pb, 1e9).astype(np.float32)
        q_l = jlrf.to_lanes(jnp.asarray(qs), jlrf._pad_lanes(len(qs), jlrf.TQ))
        p_l = jlrf.to_lanes(jnp.asarray(ps), jlrf._pad_lanes(len(ps), jlrf.TN))
        with pltpu.force_tpu_interpret_mode():
            mom = np.asarray(jlrf._moments_call(q_l, p_l,
                                                jnp.float32(radius), "shot"))
        moms.append(mom[:10, :len(qs)].T)
        cnts.append(mom[jlrf.R_CNT, :len(qs)].astype(np.int32))
    return np.stack(moms), np.stack(cnts)


@pytest.mark.parametrize("case", K1_CASES)
def test_moments_twin_matches_pallas_at_edge_cases(case):
    """K1's twin vs `_moments_call` on the valid queries: weight sums rtol
    2e-4, counts +-1, covariance atol 5e-4 (the moments contract).  Masked
    points reach the twin with their own coordinates (NaN, +-1e30, +-inf)
    and the JAX kernel parked at 1e9: both leave them out.  Invalid
    queries (at 1e9) get 0 from the twin; the JAX kernel's are garbage
    (they meet the parked points) and its callers drop them."""
    q, q_mask, p, mask = k1_case(case)
    jmom, jcnt = _jax_moments(q, q_mask, p, mask, K1_RADIUS)
    mom, cnt = tlrfm.moments(t(q), t(p), t(mask), K1_RADIUS)
    mom, cnt = n(mom), n(cnt)
    assert np.isfinite(mom).all()
    assert not cnt[~q_mask].any() and not mom[~q_mask].any()
    if case == "no_valid_queries":
        return
    assert cnt[q_mask].max() > 1
    np.testing.assert_allclose(mom[q_mask][:, 0], jmom[q_mask][:, 0],
                               rtol=2e-4, atol=1e-6)
    assert (np.abs(cnt - jcnt)[q_mask] <= 1).all()
    tcov, _ = tlrfm.cov_from_moments(t(mom), t(q), t(q_mask))
    jcov, _ = tlrfm.cov_from_moments(t(jmom), t(q), t(q_mask))
    np.testing.assert_allclose(n(tcov)[q_mask], n(jcov)[q_mask], atol=5e-4)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dim", K4_DIMS)
def test_chisq_twin_matches_pallas_at_edge_cases(dim, k, signed):
    """K4's twin vs the Pallas chi-square matrix + the k smallest in
    (distance, index) order: distances rtol 1e-5, indices equal except at
    ties; the duplicated codeword's tie goes to the lower index, the
    all-zero pair is at distance 0, masked codewords never win; with
    signed values too (terms with a + b <= 0 count 0)."""
    a, b, b_mask = k4_case(dim, signed=signed)
    with pltpu.force_tpu_interpret_mode():
        d = np.asarray(chi_square_distance_matrix_pallas(jnp.asarray(a),
                                                         jnp.asarray(b)))
    d = np.where(b_mask[None, :], d, np.inf)
    ji = np.argsort(d, axis=1, kind="stable")[:, :k]
    jd = np.take_along_axis(d, ji, 1)
    td, ti = tchisq.chisq_topk(t(a), t(b), t(b_mask), k)
    assert_topk_close(td, ti, jd, ji)
    ti = n(ti)
    assert b_mask[ti].all()
    assert ti[9, 0] == 3 and n(td)[9, 0] == 0.0
    if k >= 2:
        assert ti[9, 1] == 7
    assert n(td)[5].min() == 0.0 and ti[5, 0] == 11
