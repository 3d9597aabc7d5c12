"""One run of one benchmark cell: set-up, measured window, check, result line.

`BENCHMARK.json` names each cell's configuration (its ``file``), traffic mix
(``traffic/<mix>.json``) and metrics. A mix names its driver, the general
generator in ``drivers/<driver>.py`` that reads the mix's parameters; a
per-layer metric is read by ``metrics/<metric>.py``. Nothing in this file
names a cell, a configuration or a metric: a later cell, mix or metric is a
new file and a new entry.

A driver module has ``setup(ctx) -> cell``. The cell has
``window(seconds) -> record`` (the measured work; ``record["metrics"]`` holds
the end-to-end readings by name, ``record["attempted"]`` the units of work
done, ``record["counters"]`` what the per-layer readers need),
``release()`` (frees the program's state) and ``check() -> list of
(name, value, limit)``: the numbers that decide ``correct``, each against
its limit, computed by the plain references after the window.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent
ROOT = PERFBENCH.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gsdx")


class NoDevice(RuntimeError):
    """The run found fewer CUDA devices than the cell asks for."""


def cache_environment(root: Path = ROOT) -> dict:
    """Fixed cache directories inside the checkout, set before torch is
    imported, so that only a cell's first run in a checkout compiles (the
    port's own nvcc libraries go to ``build/torch_kernels``, its
    `kernels/_build.py`); one host thread for PyTorch's CPU work."""
    base = root / "build" / "perfbench_cache"
    env = {"TRITON_CACHE_DIR": str(base / "triton"),
           "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
           "CUDA_CACHE_PATH": str(base / "cuda"),
           "USE_FLAX": "0", "USE_JAX": "0",
           # one host thread: the timed paths are host-bound, and idle
           # OpenMP workers spinning on a shared host take its cycles
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    os.environ.update(env)
    return env


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one harness file by its path (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """Everything one cell needs, found by the names in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(PERFBENCH / "traffic" / f"{cell['traffic']}.json")

    # an end-to-end metric without "workloads" (setup_s) is every cell's; a
    # per-layer metric names its cells
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return {"cell": cell, "config": config, "mix": mix,
            "driver": PERFBENCH / "drivers" / f"{mix['driver']}.py",
            "end_to_end": end_to_end, "per_layer": per_layer}


def metric_reader(name: str):
    return load_module(PERFBENCH / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_"))


def card(torch, chips: int) -> dict:
    """The device record of the result line; raises NoDevice without the
    cards the cell asks for. The power limit comes from nvidia-smi."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark "
                       "measures the CUDA port and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} found")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        info["nvidia_smi"] = out
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        info["nvidia_smi"] = f"not read: {e}"
    return info


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class HostWatch:
    """This process's CPU seconds, in user and in system mode, over the wall
    seconds of a window, for standard error: near 1, the window waits on
    the host's one thread, and a slower or busier host reads slower."""

    def __enter__(self):
        self.t, self.cpu = time.perf_counter(), os.times()
        return self

    def __exit__(self, *exc):
        now = os.times()
        print(f"perfbench: host during the window: {time.perf_counter() - self.t:.3f} s wall, "
              f"this process {now.user - self.cpu.user:.3f} s of CPU in user mode and "
              f"{now.system - self.cpu.system:.3f} s in system mode", file=sys.stderr)
        return False


def check_line(compared) -> tuple[bool, dict]:
    """``correct`` and the compared numbers as the result line gives them:
    each value beside its limit; a value that is not finite fails."""
    ok = bool(compared)
    out = {}
    for name, value, limit in compared:
        value = float(value)
        good = math.isfinite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def run_cell(args, t_start: float, bench: dict | None = None, require_card: bool = True,
             cell_hook=None, judge=None) -> tuple[int, dict | None]:
    """Run one cell once. Returns (exit code, result line or None).

    ``bench`` (the CPU tests) stands in for BENCHMARK.json, to run a cell it
    leaves out (``staged.json``); ``require_card`` False (the CPU tests)
    skips the look for a chip and runs on the CPU; ``cell_hook(cell)`` lets
    a test break the timed path underneath before the window;
    ``judge(cell)`` replaces ``cell.check()`` (the control's and the
    faults' readings, `control.py`)."""
    import gc

    import torch

    from perfbench import trace as tr

    spec = resolve(bench or load_json(ROOT / "BENCHMARK.json"), args.workload)
    chips = spec["cell"]["chips"]
    if require_card:
        device_info = card(torch, chips)
        device = torch.device("cuda", 0)
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
        device = torch.device("cpu")
    overrides = getattr(args, "overrides", None) or {}
    mix = {**spec["mix"], **overrides.get("mix", {})}
    config = {**spec["config"], **overrides.get("config", {})}
    driver = load_module(spec["driver"], "perfbench_driver_" + mix["driver"])
    ctx = {"config": config, "mix": mix, "seed": int(args.seed),
           "device": device, "t_start": t_start, "trace": bool(args.trace)}
    t_setup = time.perf_counter()
    cell = driver.setup(ctx)
    print(f"perfbench: process start to the driver's set-up {t_setup - t_start:.3f} s, "
          f"the driver's set-up {time.perf_counter() - t_setup:.3f} s", file=sys.stderr)
    if cell_hook is not None:
        cell_hook(cell)
    # set-up's objects are never freed before the close: the collector need
    # not walk them again inside the window
    gc.collect()
    gc.freeze()

    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics, breakdown = {}, None
    if args.trace:
        seconds = min(float(args.seconds), float(mix.get("trace_seconds", args.seconds)))
        # the same work untraced first: the profiler slows the host, so shares
        # of the wall time take it from this window
        with HostWatch():
            plain = cell.window(seconds)
        record, traced = tr.traced_window(cell, seconds, device)
        for m in spec["per_layer"]:
            value = metric_reader(m["name"]).read({**traced, "counters": record["counters"],
                                                   "units": record["units"], "plain": plain,
                                                   "config": config, "mix": mix})
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        breakdown = traced["breakdown"]
        if "missed" in traced:
            device_info["profiler_missed"] = traced["missed"]
    else:
        with HostWatch():
            record = cell.window(float(args.seconds))
        for m in spec["end_to_end"]:
            if m["name"] in record["metrics"]:
                metrics[m["name"]] = {"value": record["metrics"][m["name"]],
                                      "unit": units[m["name"]]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    cell.release()
    gc.unfreeze()
    compared = cell.check() if judge is None else judge(cell)
    correct, checked = check_line(compared)
    result = {"correct": correct, "attempted": int(record["attempted"]),
              "failed": int(record.get("failed", 0)) + (0 if correct else 1),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = checked
    return 0, result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        code, result = run_cell(args, t_start)
    except NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 4
    for name, c in result["checked"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code
