"""Run port test files again and again under Tier-1's pytest settings and
count the runs that fail, per file and per test.

    python tools/parity_loop.py tests/test_torch_probes.py --runs 30
    python tools/parity_loop.py tests/test_torch_probes.py --runs 30 --default
    python tools/parity_loop.py tests/test_torch_*.py --runs 10

Each run is one pytest process with JAX on the CPU. The flags are Tier-1's
(`-m 'not slow' --continue-on-collection-errors -p no:cacheprovider
-p xdist -n 6 --dist loadfile -p no:randomly`), or with ``--default`` the
repo's own addopts alone (`-n 2`, xdist's default `--dist load`). The run's
junit XML, log and saved failures go to ``<out>/run<i>/``. ``GSDX_PARITY_DUMP``
names that directory for the tests: a parity test that fails writes there
one ``.npz`` a failing case, holding its inputs and both sides' outputs
(`tests/test_torch_probes.py` `_save_on_failure`), so that the side that
moved can be found by comparing it with a passing run's.

Prints one line a run and, last, a JSON summary: the runs, and for each
file and each failing test the number of runs in which it failed. Exits 1
if any run failed.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TIER1_FLAGS = ["-q", "-m", "not slow", "--continue-on-collection-errors",
               "-p", "no:cacheprovider", "-p", "xdist", "-n", "6",
               "--dist", "loadfile", "-p", "no:randomly"]


def _outcomes(xml_path: Path) -> dict[str, str]:
    """test id -> "passed" / "failed" / "skipped" from a junit XML."""
    out = {}
    if not xml_path.exists():
        return out
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        path = case.get("classname", "").replace(".", "/") + ".py"
        tid = f"{path}::{case.get('name')}"
        if case.find("failure") is not None or case.find("error") is not None:
            out[tid] = "failed"
        elif case.find("skipped") is not None:
            out[tid] = "skipped"
        else:
            out[tid] = "passed"
    return out


def run_once(files: list[str], run_dir: Path, default: bool, timeout: float) -> dict:
    run_dir.mkdir(parents=True, exist_ok=True)
    xml = run_dir / "junit.xml"
    flags = ["-q", "-p", "no:cacheprovider"] if default else TIER1_FLAGS
    cmd = [sys.executable, "-m", "pytest", *files, *flags, f"--junitxml={xml}"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1",
               GSDX_PARITY_DUMP=str(run_dir))
    t0 = time.perf_counter()
    with open(run_dir / "pytest.log", "w") as log:
        try:
            rc = subprocess.run(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    outcomes = _outcomes(xml)
    return {"rc": rc, "seconds": round(time.perf_counter() - t0, 1),
            "passed": sum(v == "passed" for v in outcomes.values()),
            "failed": sorted(t for t, v in outcomes.items() if v == "failed")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+", help="test files, relative to the repo")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--default", action="store_true",
                    help="the repo's addopts (-n 2) instead of Tier-1's flags")
    ap.add_argument("--out", default=str(REPO / "build" / "parity_loop"),
                    help="where each run's XML, log and saved failures go")
    ap.add_argument("--timeout", type=float, default=1400.0, help="seconds a run")
    args = ap.parse_args()

    out = Path(args.out)
    runs = []
    for i in range(args.runs):
        r = run_once(args.files, out / f"run{i}", args.default, args.timeout)
        runs.append(r)
        print(json.dumps({"run": i, **r}), flush=True)
    by_test = collections.Counter(t for r in runs for t in r["failed"])
    by_file = collections.Counter()
    for r in runs:
        for f in {t.split("::")[0] for t in r["failed"]}:
            by_file[f] += 1
    bad_runs = sum(r["rc"] != 0 for r in runs)
    print(json.dumps({"files": args.files, "flags": "default" if args.default else "tier-1",
                      "runs": len(runs), "runs_failed": bad_runs,
                      "runs_failed_by_file": dict(by_file),
                      "runs_failed_by_test": dict(by_test)}))
    return 1 if bad_runs else 0


if __name__ == "__main__":
    sys.exit(main())
