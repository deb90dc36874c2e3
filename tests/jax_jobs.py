"""JAX reference trainings of the port's tests run in processes of their
own, a few at a time, so a test module can queue all of them at once and
the JAX package's CPU work overlaps instead of waiting behind one pytest
worker.

    pool = JaxPool(3)
    job = pool.train(files, cfg)        # queued; up to 3 run at once
    want, seeds = job.result()          # .state.codebook / .state.dims_map
    job = pool.call("zoo_jobs:features", cfg=cfg, files=files)
    arrays = job.result()               # the function's dict of arrays

Each job is a plain subprocess (no executor threads in the test process)
that runs the JAX package on the CPU and writes numpy arrays to a file; a
job past TIMEOUT is killed and the test fails.  Besides trainings, a pool
calls any function of a module under tests/ that returns a dict of
arrays (JaxPool.call).

Every reference subprocess of the port's tests -- these jobs and the
interpret-mode runs of tests/torch_parity.py -- first takes one of
slot_count() slots shared by the whole test run (lock files in a directory
named by the run's PYTEST_XDIST_TESTRUNUID, held with fcntl.flock until the
process exits), so however many xdist workers queue references, at most
that many run at once, each pinned to CHILD_THREADS of the run's CPUs with
its BLAS / OpenMP pools of that size (child_env).  Its time limit counts
from the moment it holds a slot: past it, faulthandler prints the child's
stacks and ends it, and the test fails with them (wait_child).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

TIMEOUT = 600
TESTS = os.path.dirname(os.path.abspath(__file__))
# the CPUs each reference subprocess is pinned to
CHILD_THREADS = 2


def slot_count() -> int:
    """Reference subprocesses that may run at once in the whole test run:
    one per two of the CPUs this process may use (at least one)."""
    return max(1, len(os.sched_getaffinity(0)) // CHILD_THREADS)


def slot_dir() -> str:
    """The run's slot directory (one per xdist run; per process
    otherwise)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    return os.path.join(tempfile.gettempdir(), f"pcd_ref_slots_{run}")


# the first lines of every reference subprocess: wait for a free slot
# (argv[-3] the slot directory, argv[-2] the slot count, argv[-1] the
# time limit), pin the process to CHILD_THREADS CPUs of the slot, mark the
# start (the file STARTED beside its output), and end with its stacks
# printed once the limit has passed
CHILD_PRELUDE = """
import fcntl, faulthandler, os, sys, time
_dir, _slots, _limit = sys.argv[-3], int(sys.argv[-2]), float(sys.argv[-1])
del sys.argv[-3:]
os.makedirs(_dir, exist_ok=True)
_slot_fd = None
while _slot_fd is None:
    for _i in range(_slots):
        _fd = os.open(os.path.join(_dir, "slot%%d" %% _i),
                      os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(_fd)
            continue
        _slot_fd = _fd
        _cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {_cpus[(_i * %d + _k) %% len(_cpus)]
                                 for _k in range(%d)})
        break
    else:
        time.sleep(0.2)
open(os.path.join(os.path.dirname(sys.argv[2]), "STARTED"), "w").close()
faulthandler.dump_traceback_later(_limit, exit=True)
""" % (CHILD_THREADS, CHILD_THREADS)


def child_env(**extra) -> dict:
    """The environment of a reference subprocess: JAX on the CPU, the
    BLAS / OpenMP pools CHILD_THREADS wide."""
    n = str(CHILD_THREADS)
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=n,
                MKL_NUM_THREADS=n, OPENBLAS_NUM_THREADS=n, **extra)


def child_args(limit: float) -> list:
    """The arguments CHILD_PRELUDE reads, last on the command line."""
    return [slot_dir(), str(slot_count()), str(limit)]


def wait_child(proc: subprocess.Popen, out_path: str, limit: float,
               what: str, log) -> str:
    """Wait for a reference subprocess started with CHILD_PRELUDE and
    return its standard error (`log`: the open file it writes to); fail
    with its stacks where it ran past `limit` seconds after it took its
    slot, or failed."""
    started = os.path.join(os.path.dirname(out_path), "STARTED")
    while proc.poll() is None:
        if os.path.exists(started) and \
                time.time() - os.path.getmtime(started) > limit + 60:
            proc.kill()   # faulthandler should have ended it
            proc.wait()
            break
        time.sleep(0.2)
    log.flush()
    with open(log.name) as f:
        err = f.read()
    if proc.returncode != 0:
        over = "Timeout" in err or proc.returncode < 0
        raise AssertionError(
            (f"{what} ran past {limit:.0f} s after it took its slot; "
             "its stacks:\n" if over else f"{what} failed:\n")
            + err[-6000:])
    return err


_CODE = CHILD_PRELUDE + """
import json, os, sys, contextlib
import numpy as np
sys.path[:0] = [%r, os.path.dirname(%r)]
spec = json.load(open(sys.argv[1]))
os.environ.update(spec["env"])
import jax
jax.config.update("jax_platforms", "cpu")
from point_cloud_donkey_tpu.models.ism import ImplicitShapeModel
from point_cloud_donkey_tpu.utils.config import IsmConfig
from torch_fixtures import recorded_kmeans_seeds
ctx = recorded_kmeans_seeds() if spec["record_seeds"] else \\
    contextlib.nullcontext({})
with ctx as seeds:
    ism = ImplicitShapeModel(IsmConfig.from_json(spec["cfg"]))
    for path, cid in spec["files"]:
        ism.add_training_model(path, cid, cid)
    ism.train()
out = {"cb_" + k: np.asarray(v)
       for k, v in ism.state.codebook._asdict().items()}
if ism.state.global_descriptors is not None:
    out["glob_desc"] = np.asarray(ism.state.global_descriptors)
keys = sorted(ism.state.dims_map)
out["dims_keys"] = np.array(keys)
out["dims_vals"] = np.array([ism.state.dims_map[k] for k in keys])
for k, v in seeds.items():
    out["seed_%%d" %% k] = v
np.savez(sys.argv[2], **out)
""" % (TESTS, TESTS)


_CALL = CHILD_PRELUDE + """
import importlib, json, os, sys
import numpy as np
sys.path[:0] = [%r, os.path.dirname(%r)]
spec = json.load(open(sys.argv[1]))
os.environ.update(spec["env"])
import jax
jax.config.update("jax_platforms", "cpu")
mod, fn = spec["func"].split(":")
out = getattr(importlib.import_module(mod), fn)(**spec["kwargs"])
np.savez(sys.argv[2], **out)
""" % (TESTS, TESTS)


class _Job:
    def __init__(self, pool, spec, code=_CODE):
        self._pool = pool
        self._code = code
        self._dir = tempfile.mkdtemp(prefix="jax_job_")
        self._spec = os.path.join(self._dir, "spec.json")
        self._out = os.path.join(self._dir, "out.npz")
        with open(self._spec, "w") as f:
            json.dump(spec, f)
        self._proc = None
        self._result = None

    def start(self):
        self._err = open(os.path.join(self._dir, "stderr.txt"), "w")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", self._code, self._spec, self._out,
             *child_args(TIMEOUT)],
            env=child_env(), stdout=subprocess.DEVNULL, stderr=self._err)

    def result(self):
        """(the trained model's state as numpy: .state.codebook,
        .state.dims_map and .state.global_descriptors, the k-means seeds
        JAX's k-means++ picked when recorded); a call's dict of arrays."""
        if self._result is None:
            self._pool._run_until(self)
            try:
                wait_child(self._proc, self._out, TIMEOUT,
                           "a JAX reference job", self._err)
            finally:
                self._err.close()
            with np.load(self._out) as z:
                a = dict(z)
            shutil.rmtree(self._dir, ignore_errors=True)
            if self._code is _CALL:
                self._result = a
                self._pool._done(self)
                return a
            cb = {k[3:]: v for k, v in a.items() if k.startswith("cb_")}
            dims = {int(k): tuple(float(x) for x in v)
                    for k, v in zip(a["dims_keys"], a["dims_vals"])}
            seeds = {int(k[5:]): v for k, v in a.items()
                     if k.startswith("seed_")}
            self._result = (SimpleNamespace(state=SimpleNamespace(
                codebook=SimpleNamespace(**cb), dims_map=dims,
                global_descriptors=a.get("glob_desc"))), seeds)
            self._pool._done(self)
        return self._result


class JaxPool:
    """Queues JAX trainings; at most `workers` run at once."""

    def __init__(self, workers: int = 3):
        self._workers = workers
        self._queued, self._running = [], []

    def train(self, files, cfg, record_seeds=False,
              env=(("PCD_TRAIN_FUSED", "1"), ("PCD_DENSE_DESC", "1"))):
        """The JAX package's training of `cfg` on the files [(path,
        class)] (by default its fused route where it applies and dense
        descriptors)."""
        job = _Job(self, {"files": [list(f) for f in files], "cfg": cfg,
                          "env": dict(env), "record_seeds": record_seeds})
        self._queued.append(job)
        self._fill()
        return job

    def call(self, func, env=(("PCD_TRAIN_FUSED", "1"),
                              ("PCD_DENSE_DESC", "1")), **kwargs):
        """`func` ("module:function" of a module under tests/) called on
        the CPU with the JSON-able `kwargs`; it returns a dict of numpy
        arrays, which result() gives back."""
        job = _Job(self, {"func": func, "kwargs": kwargs, "env": dict(env)},
                   _CALL)
        self._queued.append(job)
        self._fill()
        return job

    def _fill(self):
        self._running = [j for j in self._running if j._proc.poll() is None]
        while self._queued and len(self._running) < self._workers:
            job = self._queued.pop(0)
            job.start()
            self._running.append(job)

    def _run_until(self, job):
        if job in self._queued:      # start it now, ahead of its turn
            self._queued.remove(job)
            job.start()
            self._running.append(job)

    def _done(self, job):
        if job in self._running:
            self._running.remove(job)
        self._fill()

    def close(self):
        """Kill what still runs and drop what is queued."""
        for job in self._running:
            if job._proc.poll() is None:
                job._proc.kill()
                job._proc.wait()
        self._queued, self._running = [], []
