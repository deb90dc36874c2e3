"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module caps torch's intra-op threads at 2: tier-1 runs six
xdist workers, each importing torch beside jax.  Inputs are made with
numpy from a seed and handed to both frameworks as arrays.

The contracts below are the JAX package's own between its Pallas kernels
and its XLA paths (tests/test_pallas_kernels.py, tests/test_shot_fused.py):
exact coordinate differences and the matmul identity can put a
radius-boundary point on different sides, and a near-tied LRF sign vote
can settle either way.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor."""
    a = np.asarray(x)
    return torch.from_numpy(a.copy() if dtype is None else a.astype(dtype))


def n(x) -> np.ndarray:
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_frames_close(fr_a, va_a, fr_b, va_b, tol=2e-3, share=0.97):
    """LRF contract: validity flags equal, and >= `share` of the valid
    frames within `tol` (max abs over the 3x3)."""
    va_a, va_b = n(va_a), n(va_b)
    assert (va_a == va_b).all(), int((va_a != va_b).sum())
    ok = va_a & va_b
    err = np.abs(n(fr_a)[ok] - n(fr_b)[ok]).max(axis=(-2, -1))
    assert (err < tol).mean() >= share, (err >= tol).sum()


def assert_descriptors_close(d_a, v_a, d_b, v_b, min_cos=0.999,
                             max_frac_off=1e-4):
    """Descriptor contract: validity equal; every common-valid pair of
    unit descriptors has cosine > min_cos, and < max_frac_off of their
    entries differ by more than 1e-3."""
    v_a, v_b = n(v_a), n(v_b)
    assert (v_a == v_b).all(), int((v_a != v_b).sum())
    both = v_a & v_b
    a, b = n(d_a)[both], n(d_b)[both]
    assert len(a) > 0
    cos = (a * b).sum(-1)
    assert cos.min() > min_cos, cos.min()
    assert (np.abs(a - b) > 1e-3).mean() < max_frac_off


def assert_topk_close(d_a, i_a, d_b, i_b, rtol=1e-5):
    """k-NN contract: distances within rtol; indices equal except where
    the distances they select are tied within that tolerance."""
    d_a, d_b, i_a, i_b = n(d_a), n(d_b), n(i_a), n(i_b)
    np.testing.assert_allclose(d_a, d_b, rtol=rtol, atol=1e-6)
    differ = i_a != i_b
    assert np.allclose(d_a[differ], d_b[differ], rtol=rtol, atol=1e-6)


def assert_decisions_match(scores, ref):
    """Slice contract (PLATFORM_DIVERGENCE.md): the same argmax on every
    cloud whose reference margin (top1 - top2) is > 3, and a score rms
    delta <= 5% of the score scale."""
    scores, ref = n(scores), n(ref)
    top2 = np.sort(ref, axis=1)[:, -2:]
    firm = top2[:, 1] - top2[:, 0] > 3.0
    assert firm.any()
    np.testing.assert_array_equal(scores.argmax(1)[firm],
                                  ref.argmax(1)[firm])
    rms = np.sqrt(((scores - ref) ** 2).mean())
    assert rms <= 0.05 * np.abs(ref).max(), rms


_INTERPRET = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.experimental.pallas import tpu as pltpu
a = dict(np.load(sys.argv[1]))
with pltpu.force_tpu_interpret_mode():
    scope = {"a": a}
    exec(sys.argv[3], scope)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in scope["out"].items()})
"""


def pallas_interpret(code: str, workdir, **arrays) -> dict:
    """Run `code` -- Python that sets `out`, a dict of arrays, from the
    numpy arrays in the dict `a` (= `arrays`) -- in a process of its own,
    with the JAX package's Pallas TPU kernels in interpret mode, and return
    `out` as numpy arrays.  The interpret mode keeps process-wide state and
    runs kernel bodies through host callbacks that dispatch JAX work of
    their own; full parallel test runs in which more test processes used
    it stalled now and then, so these comparisons keep it out of the test
    process."""
    inp, outp = os.path.join(workdir, "in.npz"), os.path.join(workdir,
                                                             "out.npz")
    np.savez(inp, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [
                   REPO, os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", _INTERPRET, inp, outp, code],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(outp) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False): the CUDA kernels run only on the card")
    return torch.device("cuda:0")
