"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Everything that belongs to a cell is found by name:

- ``BENCHMARK.json`` (at the checkout's root): the cell's configuration,
  traffic and chips, and which end-to-end and per-layer metrics it reports;
- ``hoibench/workloads/<cell>.json``: the driver, the traced units and the
  limits of the numbers that decide ``correct``;
- ``hoibench/configs/<config>.json`` and ``hoibench/traffic/<traffic>.json``;
- ``hoibench/drivers/<driver>.py``: a ``Driver(cell, seed, device)`` with
  ``setup()``, ``window(seconds) -> {metric: value}``, ``run_units(n)``,
  ``release()`` and ``check() -> {number: value}``, and the attributes
  ``attempted``, ``failed`` and ``compile_s``.  A driver whose work runs in
  other processes (ranks on several cards) also defines ``trace(units)``,
  returning a :class:`~hoibench.trace.Trace` of its ranks, and
  ``memory_peak_bytes()``, the peak of its fullest card;
- ``hoibench/metrics/<metric>.py``: ``read(ctx) -> float or None`` over the
  traced window (``ctx.trace``, ``ctx.driver``, ``ctx.units``, ``ctx.kind``);
  where no file has the metric's whole name, the file named by its part
  before the first dot (``mfu.py`` for ``mfu.train`` and ``mfu.infer``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
CHECKOUT = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "skghoi_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def load_cell(benchmark: dict, name: str) -> dict:
    """The cell's entry in ``BENCHMARK.json`` with its workload file, and its
    configuration and traffic files under ``config_params``/``traffic_params``."""
    entries = [w for w in benchmark["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(entries[0])
    cell.update(load_json(PACKAGE / "workloads" / f"{name}.json"))
    cell["config_params"] = load_json(PACKAGE / "configs" / f"{cell['config']}.json")
    cell["traffic_params"] = load_json(PACKAGE / "traffic" / f"{cell['traffic']}.json")
    return cell


def metrics_for(benchmark: dict, cell: str):
    """The cell's end-to-end metric entries, and its per-layer metric entries:
    those that list it, or list no cells and move one of its metrics."""
    e2e = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def load_reader(name: str):
    """The metric's reader: ``metrics/<name>.py``, else ``metrics/<stem>.py``
    for the part of the name before its first dot."""
    path = PACKAGE / "metrics" / f"{name}.py"
    if not path.exists():
        path = PACKAGE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"hoibench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str):
    return importlib.import_module(f"hoibench.drivers.{name}")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = CHECKOUT / ".hoibench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    trace: Any
    driver: Any
    units: int
    kind: Optional[str]


def device_kind(device) -> Optional[str]:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else None


def traced(driver, units: int, device):
    """``units`` units under the profiler, in one ``hoibench.window`` range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hoibench.trace import Trace, WINDOW

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            driver.run_units(units)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return Trace(prof.events())


def run_cell(cell: dict, benchmark: dict, seed: int, seconds: float, trace: bool, device,
             started: Optional[float] = None, log=None) -> dict:
    """One run; returns the result line's object.  ``started``: the
    ``time.perf_counter()`` at which set-up began (default: process start)."""
    import torch

    from hoibench.checks import judge

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    e2e_entries, layer_entries = metrics_for(benchmark, cell["name"])
    age = (lambda: time.perf_counter() - started) if started is not None else process_age_s
    driver = load_driver(cell["driver"]).Driver(cell, seed, device)
    driver.setup()
    setup_s = age()
    log(f"[hoibench] {cell['name']} seed {seed}: set-up {setup_s:.3f} s "
        f"(of it, kernel build {driver.compile_s:.3f} s)")
    e2e = driver.window(seconds)
    e2e["setup_s"] = setup_s
    metrics: Dict[str, dict] = {}
    device_info: Dict[str, Any] = dict(platform="gpu" if device.type == "cuda" else device.type,
                                       kind=device_kind(device) or str(device), count=int(cell["chips"]))
    breakdown = None
    if trace:
        t0 = time.perf_counter()
        units = int(cell["traced_units"])
        tr = driver.trace(units) if hasattr(driver, "trace") else traced(driver, units, device)
        ctx = Context(tr, driver, units, device_kind(device))
        for m in layer_entries:
            value = load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = dict(device_ops=tr.device_ops(), idle_gaps=tr.idle_gaps())
        log(f"[hoibench] traced {ctx.units} units and read the trace in "
            f"{time.perf_counter() - t0:.3f} s")
    else:
        for m in e2e_entries:
            if m["name"] not in e2e:
                raise KeyError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = dict(value=float(e2e[m["name"]]), unit=m["unit"])
    if hasattr(driver, "memory_peak_bytes"):
        device_info["memory_peak_bytes"] = int(driver.memory_peak_bytes())
    else:
        device_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                            if device.type == "cuda" else 0)
    attempted, failed = int(driver.attempted), int(driver.failed)
    driver.release()
    t0 = time.perf_counter()
    checks = judge(driver.check(), cell["limits"])
    log(f"[hoibench] reference check in {time.perf_counter() - t0:.3f} s")
    result = dict(correct=all(c["ok"] for c in checks.values()), attempted=attempted,
                  failed=failed, metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: dict(value=v["value"], limit=v["limit"]) for k, v in checks.items()}
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}")
    return result


def finite(obj):
    """The result with non-finite numbers as strings (JSON has none)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj
