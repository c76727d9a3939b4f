"""The run's result line, and the runs that must print none."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from hoibench import harness
from tiny import benchmark, run_tiny, tiny_cell


def cell_limits(name):
    return harness.load_cell(benchmark(), name)["limits"]


def test_untraced_result_keys_and_metrics():
    r = run_tiny(tiny_cell("scg_r50.serve_b1"))
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"serve_ms_p95", "setup_s"}
    assert r["metrics"]["serve_ms_p95"]["unit"] == "ms" and r["metrics"]["serve_ms_p95"]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(cell_limits("scg_r50.serve_b1"))
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(harness.finite(r))


def test_traced_result_has_a_breakdown_and_the_window():
    r = run_tiny(tiny_cell("detr_r50.detect_b8"), trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert set(r["device"]) >= {"busy_s", "window_s"} and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device trace on the CPU: no device metric is read there.
    assert r["metrics"] == {}


def test_no_card_exits_2_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "hoibench.run", "--workload", "detr_r50.detect_b8",
                          "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
                         cwd=harness.CHECKOUT, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(harness.CHECKOUT)})
    assert out.returncode == 2 and out.stdout == ""


def test_only_the_benchmark_files_fail_without_the_program(tmp_path):
    shutil.copytree(harness.PACKAGE, tmp_path / "hoibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "hoibench.run", "--workload", "detr_r50.detect_b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


def test_a_number_over_its_limit_makes_the_run_incorrect():
    cell = tiny_cell("scg_r50.serve_b1")
    cell["limits"] = dict(cell["limits"], score_gap=-1.0)
    r = run_tiny(cell)
    assert r["correct"] is False and r["checks"]["score_gap"]["limit"] == -1.0
