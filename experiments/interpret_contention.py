"""How the port's interpret-mode Pallas references behave on a busy CPU.

The references of tests/test_torch_*.py run the JAX package's Pallas
kernels in interpret mode, each in a process of its own
(tests/torch_parity.pallas_interpret).  This script times the one of
tests/test_torch_lrf_v2.py (the v2 LRF kernels, `pallas_v2`):

  * twice inside one process: the first run compiles, the second reuses
    the compiled programs (the compile share of its time);
  * in a fresh process (torch_parity's runner) alone;
  * in `rounds` rounds of `copies` fresh processes at once while
    `burners` processes keep the cores busy with numpy matrix products
    (`--burner-threads` BLAS threads each).  A process still running at
    `--limit` seconds has hung (alone it takes 10-15 s); the stacks that
    faulthandler prints 40 s before the limit go to `--stacks`.

`--no-wait` runs the references (the in-process ones too) without the
runner's main-thread wait for the kernels' callbacks; `--flag` extends XLA_FLAGS;
JAX_CPU_ENABLE_ASYNC_DISPATCH=false in the environment makes JAX dispatch
synchronously on the CPU.

    JAX_PLATFORMS=cpu python experiments/interpret_contention.py
        [--burners 12] [--burner-threads 1] [--copies 6] [--rounds 6]
        [--limit 140] [--no-wait] [--stacks DIR]
        [--flag=--xla_force_host_platform_device_count=1]
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TESTS = os.path.join(_REPO, "tests")
sys.path[:0] = [_TESTS, _REPO]

_BURN = """
import sys, time
import numpy as np
a = np.random.rand(600, 600)
t0 = time.time()
while time.time() - t0 < float(sys.argv[1]):
    a = a @ a
    a /= np.abs(a).max()
"""


def _reference():
    """(code, arrays) of test_torch_lrf_v2's `pallas_v2` fixture."""
    import test_torch_lrf_v2 as lrf_v2
    captured = {}
    arrays = lrf_v2.cloud.__wrapped__()

    def fake(code, workdir, **a):
        captured.update(code=code, arrays=a)
        return {}

    lrf_v2.pallas_interpret = fake
    lrf_v2.pallas_v2.__wrapped__(arrays, SimpleNamespace(mktemp=str))
    return captured["code"], captured["arrays"]


def _runner(wait: bool):
    """torch_parity's runner, or the same without the main-thread wait,
    and the lines of it that set up that wait ('' without it)."""
    import torch_parity
    runner = torch_parity._INTERPRET
    start = runner.index("import threading")
    end = runner.index("a = dict(np.load")
    if not wait:
        return runner[:start] + runner[end:], ""
    return runner, runner[start:end]


def compile_share(code, arrays, prelude):
    """Seconds of the first and the second run inside one process, after
    `prelude` (the runner's wait, or nothing)."""
    import jax
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu
    jax.config.update("jax_platforms", "cpu")
    exec(prelude, {})
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        with pltpu.force_tpu_interpret_mode():
            scope = {"a": dict(arrays)}
            exec(code, scope)
            for v in scope["out"].values():
                np.asarray(v)
        times.append(time.perf_counter() - t0)
    return times


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--burners", type=int, default=12)
    ap.add_argument("--burner-threads", type=int, default=1)
    ap.add_argument("--copies", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--limit", type=float, default=140.0)
    ap.add_argument("--no-wait", action="store_true")
    ap.add_argument("--stacks", default="")
    ap.add_argument("--flag", default="")
    args = ap.parse_args()
    import numpy as np
    if args.flag:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   + args.flag).strip()
    code, arrays = _reference()
    runner, prelude = _runner(not args.no_wait)
    first, second = compile_share(code, arrays, prelude)
    print(f"one process: first run {first:.2f} s, second {second:.2f} s")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)

    def start():
        """One fresh interpret-mode process: (Popen, start time, stderr)."""
        work = tempfile.mkdtemp()
        inp = os.path.join(work, "in.npz")
        np.savez(inp, **arrays)
        err = open(os.path.join(work, "stderr.txt"), "w+")
        return subprocess.Popen(
            [sys.executable, "-c", runner, inp, os.path.join(work, "out.npz"),
             code, str(max(args.limit - 40.0, 1.0))], env=env,
            stdout=subprocess.DEVNULL, stderr=err), time.perf_counter(), err

    def wait(runs):
        """Each run's seconds, or None where it ran past the limit."""
        out = [None] * len(runs)
        left = set(range(len(runs)))
        while left:
            for i in sorted(left):
                proc, t0, err = runs[i]
                rc = proc.poll()
                if rc is None and time.perf_counter() - t0 < args.limit:
                    continue
                left.discard(i)
                if rc is not None:
                    assert rc == 0, f"a reference failed with exit code {rc}"
                    out[i] = time.perf_counter() - t0
                else:
                    proc.kill()
                    proc.wait()
                    if args.stacks:
                        os.makedirs(args.stacks, exist_ok=True)
                        err.seek(0)
                        with open(os.path.join(args.stacks,
                                               f"{proc.pid}.txt"), "w") as f:
                            f.write(err.read())
                err.close()
            time.sleep(0.1)
        return out

    print(f"a fresh process alone: {wait([start()])[0]:.1f} s")
    threads = str(args.burner_threads)
    burn_env = dict(os.environ, OPENBLAS_NUM_THREADS=threads,
                    OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
    burners = [subprocess.Popen(
        [sys.executable, "-c", _BURN,
         str(args.rounds * (args.limit + 30.0))], env=burn_env)
        for _ in range(args.burners)]
    got = []
    try:
        for _ in range(args.rounds):
            got += wait([start() for _ in range(args.copies)])
    finally:
        for b in burners:
            b.kill()
            b.wait()
    done = [x for x in got if x is not None]
    print(f"{len(got)} fresh processes, {args.copies} at once, beside "
          f"{args.burners} burners of {threads} thread(s) "
          f"({os.cpu_count()} cores), main-thread wait "
          f"{not args.no_wait}, XLA_FLAGS "
          f"{os.environ.get('XLA_FLAGS', '')!r}, async dispatch "
          f"{os.environ.get('JAX_CPU_ENABLE_ASYNC_DISPATCH', 'default')}: "
          f"{len(got) - len(done)} ran past {args.limit:.0f} s"
          + (f"; the others took {min(done):.1f}-{max(done):.1f} s"
             if done else ""))


if __name__ == "__main__":
    main()
