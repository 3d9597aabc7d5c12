"""BENCHMARK.json, the configuration files and the data-driven lookup."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
from tinycells import ROOT

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
        assert w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in bench["configs"]:
        names += c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    for text in ([w["why"] for w in bench["workloads"]] + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]] + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_bounds_and_setup(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_check_fits_the_budget(bench):
    """A full check of 24 cells at run_seconds fits 43,200 seconds."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        spec = harness.resolve(bench, w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]


def test_harness_finds_config_traffic_driver_and_readers_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = harness.load_json(ROOT + "/" + c["file"])
        assert cfg["name"] == c["name"]
    for w in bench["workloads"]:
        spec = harness.resolve(bench, w["name"])
        assert spec["driver"].exists()
        assert hasattr(harness.load_module(spec["driver"], "d_" + w["name"]), "setup")
        for m in spec["per_layer"]:
            assert callable(harness.metric_reader(m["name"]).read)
    with pytest.raises(KeyError):
        harness.resolve(bench, "no.such.cell")


def test_command_and_paths(bench):
    assert bench["command"][1].startswith(bench["paths"][0] + "/")
    for p in bench["paths"]:
        assert not p.startswith("/") and ".." not in p


def test_without_a_card_the_run_fails_and_prints_no_result():
    """No CPU fallback: on a machine without CUDA the run exits non-zero and
    its standard output is empty."""
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "rope.plan",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "cuda" in res.stderr.lower()
