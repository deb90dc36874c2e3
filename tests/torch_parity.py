"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module caps torch's intra-op threads at the CPUs this
process may use divided among the run's xdist workers (at most 2, at least
1): tier-1 runs six workers, each importing torch beside jax, and the
reference subprocesses take CPUs of their own (tests/jax_jobs.py).  Inputs
are made with numpy from a seed and handed to both frameworks as arrays.

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

from jax_jobs import CHILD_PRELUDE, child_args, child_env, wait_child

torch.set_num_threads(max(1, min(2, len(os.sched_getaffinity(0)) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))))
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


# The interpret-mode references are compile-bound (a second run in the
# same process takes a few percent of the first) and take their share of a
# busy CPU: the LRF v2 reference, 10-14 s alone, took 27-39 s six at once
# beside 12 single-threaded busy processes on 8 cores.  A run could hang:
# 3 of 36 such runs never ended, a kernel's io_callback thread and the
# main thread each dispatching an eager JAX op (stacks at
# interpret_pallas_call.get and lrf_moments.py:655); synchronous CPU
# dispatch and one XLA device did not prevent it
# (experiments/interpret_contention.py).  So the main thread waits for
# every computation with effects (the kernels' callbacks) to finish before
# it goes on: none of 72 such runs hung.  Each run holds one of the test
# run's reference slots (tests/jax_jobs.py); one past INTERPRET_TIMEOUT
# (~8x the slowest reference alone, ~40 s) after it took its slot ends
# with its stacks, and its test fails with them.
INTERPRET_TIMEOUT = 300

_INTERPRET = CHILD_PRELUDE + """
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.experimental.pallas import tpu as pltpu
import threading
from jax._src import dispatch
from jax._src.interpreters import pxla
execute = pxla.ExecuteReplicated.__call__


def execute_then_wait(self, *args):
    out = execute(self, *args)
    if (self.has_unordered_effects or self.ordered_effects) \\
            and threading.current_thread() is threading.main_thread():
        dispatch.runtime_tokens.block_until_ready()
    return out


pxla.ExecuteReplicated.__call__ = execute_then_wait
a = dict(np.load(sys.argv[1]))
with pltpu.force_tpu_interpret_mode():
    scope = {"a": a}
    exec(sys.argv[3], scope)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in scope["out"].items()})
"""


class InterpretRun:
    """:func:`pallas_interpret` started now in the background;
    :meth:`result` waits for it (a test module can start its slow
    references at once, so they overlap)."""

    def __init__(self, code: str, workdir, **arrays):
        self._inp = os.path.join(workdir, "in.npz")
        self._outp = os.path.join(workdir, "out.npz")
        np.savez(self._inp, **arrays)
        env = child_env(PYTHONPATH=os.pathsep.join(filter(None, [
            REPO, os.path.dirname(os.path.abspath(__file__)),
            os.environ.get("PYTHONPATH")])))
        # the output goes to a file: a pipe nobody reads before result()
        # would fill and stall the run
        self._log = open(os.path.join(workdir, "stderr.txt"), "w")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _INTERPRET, self._inp, self._outp, code,
             *child_args(INTERPRET_TIMEOUT)],
            env=env, stdout=subprocess.DEVNULL, stderr=self._log)
        self._out = None

    def result(self) -> dict:
        if self._out is not None:
            return self._out
        try:
            wait_child(self._proc, self._outp, INTERPRET_TIMEOUT,
                       "an interpret-mode reference", self._log)
        finally:
            self._log.close()
        with np.load(self._outp) as z:
            self._out = {k: z[k] for k in z.files}
        return self._out


class StartedReference:
    """An interpret-mode reference queued now and read like the dict
    :func:`pallas_interpret` returns; reading waits for it.  At most
    MAX_STARTED run at once, so a module can queue all of its references
    at its start and they overlap without crowding the CPU."""

    MAX_STARTED = 4
    _queue: list = []
    _running: list = []

    def __init__(self, code: str, workdir, **arrays):
        self._args = (code, workdir, arrays)
        self._run = None
        StartedReference._queue.append(self)
        StartedReference._fill()

    @classmethod
    def _fill(cls):
        cls._running = [r for r in cls._running
                        if r._run._proc.poll() is None]
        while cls._queue and len(cls._running) < cls.MAX_STARTED:
            ref = cls._queue.pop(0)
            ref._start()
            cls._running.append(ref)

    def _start(self):
        code, workdir, arrays = self._args
        self._run = InterpretRun(code, workdir, **arrays)

    def result(self) -> dict:
        if self._run is None:
            StartedReference._queue.remove(self)
            self._start()
        out = self._run.result()
        StartedReference._fill()
        return out

    def __getitem__(self, key):
        return self.result()[key]

    def __contains__(self, key):
        return key in self.result()

    def keys(self):
        return self.result().keys()


def pallas_interpret(code: str, workdir, **arrays) -> dict:
    """Run `code` -- Python that sets `out`, a dict of arrays, from the
    numpy arrays in the dict `a` (= `arrays`) -- in a process of its own,
    with the JAX package's Pallas TPU kernels in interpret mode, and return
    `out` as numpy arrays.  The interpret mode keeps process-wide state and
    runs kernel bodies through host callbacks that dispatch JAX work of
    their own; full parallel test runs in which more test processes used
    it stalled now and then, so every interpret-mode reference of the
    port's tests runs here, out of the test process, and its main thread
    waits out each kernel's callbacks (see INTERPRET_TIMEOUT).  A run that
    outlasts INTERPRET_TIMEOUT after it took its slot fails, with the
    stacks faulthandler printed, to show where it hung."""
    return InterpretRun(code, workdir, **arrays).result()


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False): the CUDA kernels run only on the card")
    return torch.device("cuda:0")
