"""Fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tinycells import bench_with_staged, harness  # noqa: E402


@pytest.fixture(scope="session", params=["BENCHMARK.json", "with staged.json"])
def bench(request):
    """BENCHMARK.json, and it with staged.json's entries, which have to keep
    to the same rules."""
    if request.param == "BENCHMARK.json":
        return harness.load_json(harness.ROOT / "BENCHMARK.json")
    return bench_with_staged()
