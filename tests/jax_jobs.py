"""JAX reference trainings of the port's tests run in processes of their
own, a few at a time, so a test module can queue all of them at once and
the JAX package's CPU work overlaps instead of waiting behind one pytest
worker.

    pool = JaxPool(3)
    job = pool.train(files, cfg)        # queued; up to 3 run at once
    want, seeds = job.result()          # .state.codebook / .state.dims_map

Each job is a plain subprocess (no executor threads in the test process)
that runs the JAX package on the CPU and writes numpy arrays to a file; a
job past TIMEOUT is killed and the test fails.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np

TIMEOUT = 600
TESTS = os.path.dirname(os.path.abspath(__file__))

_CODE = """
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
keys = sorted(ism.state.dims_map)
out["dims_keys"] = np.array(keys)
out["dims_vals"] = np.array([ism.state.dims_map[k] for k in keys])
for k, v in seeds.items():
    out["seed_%%d" %% k] = v
np.savez(sys.argv[2], **out)
""" % (TESTS, TESTS)


class _Job:
    def __init__(self, pool, spec):
        self._pool = pool
        self._dir = tempfile.mkdtemp(prefix="jax_job_")
        self._spec = os.path.join(self._dir, "spec.json")
        self._out = os.path.join(self._dir, "out.npz")
        with open(self._spec, "w") as f:
            json.dump(spec, f)
        self._proc = None
        self._result = None

    def start(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self._err = open(os.path.join(self._dir, "stderr.txt"), "w")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _CODE, self._spec, self._out], env=env,
            stdout=subprocess.DEVNULL, stderr=self._err)

    def result(self):
        """(the trained model's state as numpy: .state.codebook and
        .state.dims_map, the k-means seeds JAX's k-means++ picked when
        recorded)."""
        if self._result is None:
            self._pool._run_until(self)
            try:
                self._proc.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
                raise AssertionError(f"a JAX reference training ran past "
                                     f"{TIMEOUT} s")
            finally:
                self._err.close()
            with open(self._err.name) as f:
                err = f.read()
            assert self._proc.returncode == 0, err[-3000:]
            with np.load(self._out) as z:
                a = dict(z)
            shutil.rmtree(self._dir, ignore_errors=True)
            cb = {k[3:]: v for k, v in a.items() if k.startswith("cb_")}
            dims = {int(k): tuple(float(x) for x in v)
                    for k, v in zip(a["dims_keys"], a["dims_vals"])}
            seeds = {int(k[5:]): v for k, v in a.items()
                     if k.startswith("seed_")}
            self._result = (SimpleNamespace(state=SimpleNamespace(
                codebook=SimpleNamespace(**cb), dims_map=dims)), seeds)
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
