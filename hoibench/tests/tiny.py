"""A cell cut to a tiny canvas, and one run of it on the CPU through the harness."""

from __future__ import annotations

import copy
import time

import torch

from hoibench import harness

# A cell whose files the benchmark keeps but which ``BENCHMARK.json`` does
# not list, with the entries that listing it would add.
UNLISTED = {
    "workloads": [dict(name="scg_r50.serve_b1", config="scg_r50", traffic="serve_b1", chips=1,
                       why="one client, one image a request")],
    "end_to_end": [dict(name="serve_ms_p95", unit="ms", better="lower", bound=0.25,
                        source="host_clock", workloads=["scg_r50.serve_b1"])],
}


def benchmark() -> dict:
    """``BENCHMARK.json`` with the unlisted cells' entries added."""
    bench = harness.load_benchmark()
    for key, entries in UNLISTED.items():
        names = {e["name"] for e in bench[key]}
        bench[key] += [e for e in entries if e["name"] not in names]
    return bench


def tiny_cell(name: str, **overrides) -> dict:
    """The cell as ``BENCHMARK.json`` (or ``UNLISTED``) and its files give it,
    at 64x96 (96x64), at most two images a batch, a pool of three batches."""
    cell = copy.deepcopy(harness.load_cell(benchmark(), name))
    tp = cell["traffic_params"]
    tp["canvases"] = [[64, 96], [96, 64]][:len(tp["canvases"])]
    tp["image"] = dict(tp["image"], short=60, long=[70, 90])
    tp["batch"], tp["pool"] = min(tp["batch"], 2), 3
    cell["traced_units"] = 2
    cell["config_params"].update(overrides)
    return cell


def run_tiny(cell: dict, seed: int = 5, seconds: float = 0.5, trace: bool = False) -> dict:
    torch.manual_seed(0)
    return harness.run_cell(cell, benchmark(), seed, seconds, trace,
                            torch.device("cpu"), started=time.perf_counter(), log=lambda m: None)


