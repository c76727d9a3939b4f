"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and ``BENCHMARK.json`` entries alone: no file the benchmark
already has changes, and the harness finds them by name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap


def test_a_new_cell_config_traffic_and_metric_are_picked_up(tmp_path):
    from hoibench import harness

    root = tmp_path / "checkout"
    shutil.copytree(harness.PACKAGE, root / "hoibench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "hoibench").rglob("*") if p.is_file()}
    bench = harness.load_benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="scg_r50_b", file="hoibench/configs/scg_r50_b.json"))
    bench["workloads"].append(dict(name="scg_r50_b.serve_b2", config="scg_r50_b", traffic="serve_b2",
                                   chips=1, why="a new cell"))
    bench["per_layer"].append(dict(name="new_metric.serve", unit="ms", better="lower",
                                   source="device_trace", layer="device", moves="serve_ms_p95",
                                   workloads=["scg_r50_b.serve_b2"]))
    bench["end_to_end"].append(dict(name="serve_ms_p95", unit="ms", better="lower", bound=0.25,
                                    source="host_clock", workloads=["scg_r50_b.serve_b2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = root / "hoibench"
    (pkg / "configs" / "scg_r50_b.json").write_text((pkg / "configs" / "scg_r50.json").read_text())
    traffic = json.loads((pkg / "traffic" / "serve_b1.json").read_text())
    (pkg / "traffic" / "serve_b2.json").write_text(json.dumps(dict(traffic, batch=2)))
    (pkg / "workloads" / "scg_r50_b.serve_b2.json").write_text(json.dumps(
        dict(driver="scg_serve", traced_units=3, checked_requests=4, limits={"score_gap": 1.0})))
    (pkg / "metrics" / "new_metric.serve.py").write_text("def read(ctx):\n    return 42.0\n")

    probe = textwrap.dedent("""
        import json
        from hoibench import harness
        bench = harness.load_benchmark()
        cell = harness.load_cell(bench, "scg_r50_b.serve_b2")
        e2e, layer = harness.metrics_for(bench, "scg_r50_b.serve_b2")
        print(json.dumps(dict(batch=cell["traffic_params"]["batch"], driver=cell["driver"],
                              e2e=sorted(m["name"] for m in e2e),
                              layer=[m["name"] for m in layer],
                              read=harness.load_reader("new_metric.serve").read(None))))
    """)
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True, text=True,
                         check=True, env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(batch=2, driver="scg_serve", e2e=["serve_ms_p95", "setup_s"],
                       layer=["new_metric.serve"], read=42.0)
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_metric_of_a_new_cell_reads_with_the_file_of_its_stem():
    """``mfu.<cell kind>`` needs no file of its own: ``metrics/mfu.py`` serves
    every such name (a file with the whole name, as above, is taken first)."""
    from hoibench import harness

    assert harness.load_reader("mfu.new_kind").__file__.endswith("/metrics/mfu.py")
    assert harness.load_reader("device_idle_pct.new_kind").__file__.endswith(
        "/metrics/device_idle_pct.py")
