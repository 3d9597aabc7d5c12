"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole: ``gsdx_torch`` is the port, ``gsdx`` is not), and the plain
references nothing of the port either."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from tinycells import ROOT

PERFBENCH = pathlib.Path(ROOT) / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gsdx"}

LOAD_ALL = """
import json, pathlib, sys
sys.path.insert(0, {root!r})
from perfbench import harness, trace, scenes, flops, control
from perfbench.reference import gnn, mppi, render, tracking, training
for path in (harness.PERFBENCH / "drivers").glob("*.py"):
    harness.load_module(path, "d_" + path.stem)
for path in (harness.PERFBENCH / "metrics").glob("*.py"):
    harness.metric_reader(path.stem)
import gsdx_torch.plan.planner, gsdx_torch.track.trainer, gsdx_torch.kernels.gnn_forward
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL.format(root=ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gsdx_torch" in top
    assert not (top & FORBIDDEN), top & FORBIDDEN


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_names_jax_or_the_jax_package():
    for path in PERFBENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_the_references_import_nothing_of_the_port():
    for path in (PERFBENCH / "reference").glob("*.py"):
        assert "gsdx_torch" not in _imports(path), path
        assert "gsdx_torch" not in path.read_text(), path


def test_the_benchmark_reads_nothing_under_benchmarks_or_bench_py():
    """No path into the JAX package's benchmark folder or its script."""
    for path in PERFBENCH.rglob("*"):
        if path.suffix in (".py", ".json") and "tests" not in path.parts:
            text = path.read_text().replace("bench.py's", "")
            assert "benchmarks/" not in text and "bench.py" not in text, path
