"""Where the tier-1 run's time goes, per test file.

    python tests/suite_times.py table NAME RUN.xml [NAME RUN.xml ...]
        worker seconds per file, summed from the junit files of whole runs
        (pytest --junitxml), one column a run, as a markdown table: the
        files of 30 s or more in the first run's order, the rest summed
    python tests/suite_times.py cpu [-j 4] [FILE ...]
        each test file (default: tests/test_torch_*.py) run alone in a
        pytest process of its own, JAX_PLATFORMS=cpu, `-j` at once; one
        JSON line a file: [file, wall s, CPU s of the process and the
        subprocesses it waited for (wait4's rusage), exit status]

Run from the root of the repo.
"""

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor


def file_seconds(junit: str) -> dict:
    """{test file stem: summed testcase time} of one junit file."""
    out = collections.defaultdict(float)
    for case in ET.parse(junit).getroot().iter("testcase"):
        cls = case.get("classname", "")
        name = cls.split(".")[1] if cls.startswith("tests.") else cls
        out[name] += float(case.get("time", 0))
    return out


def table(pairs) -> None:
    names, runs = pairs[0::2], [file_seconds(p) for p in pairs[1::2]]
    files = sorted(set().union(*runs), key=lambda f: -runs[0].get(f, 0.0))
    print("| file | " + " | ".join(names) + " |")
    print("|---|" + "---|" * len(names))
    rest = [0.0] * len(runs)
    for f in files:
        v = [r.get(f, 0.0) for r in runs]
        if max(v) >= 30:
            print(f"| {f} | " + " | ".join(f"{x:.1f}" for x in v) + " |")
        else:
            rest = [a + b for a, b in zip(rest, v)]
    print("| the other files | " + " | ".join(f"{x:.1f}" for x in rest)
          + " |")
    print("| **worker s, all files** | "
          + " | ".join(f"{sum(r.values()):.1f}" for r in runs) + " |")


def run_alone(path: str):
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", path, "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    _, status, usage = os.wait4(proc.pid, 0)
    return [path, round(time.time() - t0, 1),
            round(usage.ru_utime + usage.ru_stime, 1), status]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("table")
    t.add_argument("pairs", nargs="+", metavar="NAME RUN.xml")
    c = sub.add_parser("cpu")
    c.add_argument("-j", type=int, default=4)
    c.add_argument("files", nargs="*")
    args = ap.parse_args(argv)
    if args.cmd == "table":
        if len(args.pairs) % 2:
            ap.error("table takes NAME RUN.xml pairs")
        table(args.pairs)
        return 0
    files = args.files or sorted(glob.glob("tests/test_torch_*.py"))
    with ThreadPoolExecutor(args.j) as pool:
        for row in pool.map(run_alone, files):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
