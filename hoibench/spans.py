"""The program's own spans in a traced window.

The program marks its layers with ``record_function`` ranges named
``skghoi.<layer>`` (``skghoi_torch.utils.profiling.SPANS``).  They sit in the
traced window's host rows (``Trace.host``) on the clock of the device rows,
so the host's launches and the device's idle gaps can be put down to the
layer the host was in.  A program without such spans (an older checkout)
gives ``None`` here, as does a trace with no device work.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Iterable, List, Optional, Tuple

from hoibench.trace import LAUNCH_PREFIXES

PREFIX = "skghoi."


def _intervals(trace, names: Iterable[str]) -> List[Tuple[float, float]]:
    """The named spans' host intervals, merged where they overlap, in order."""
    want = {PREFIX + n for n in names}
    merged: List[List[float]] = []
    for a, b in sorted((a, b) for n, a, b in trace.host if n in want):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def launches_under(trace, names: Iterable[str]) -> Optional[int]:
    """Launch API rows (``cudaLaunchKernel*``, ``cuLaunchKernel*``) whose start
    lies inside an interval of the named spans, on any thread (autograd's
    backward launches from its own thread while the caller's span is open)."""
    spans = _intervals(trace, names)
    if not spans or not trace.launches:
        return None
    starts = [a for a, _ in spans]
    count = 0
    for n, s, _ in trace.host:
        if n.startswith(LAUNCH_PREFIXES):
            i = bisect_right(starts, s) - 1
            count += i >= 0 and s < spans[i][1]
    return count


def _innermost(trace) -> Tuple[List[float], List[Optional[str]]]:
    """The window cut where any ``skghoi.`` span opens or closes: each
    stretch's start and the innermost span open over it (the last opened),
    ``None`` where none is."""
    spans = sorted((a, b, n[len(PREFIX):]) for n, a, b in trace.host if n.startswith(PREFIX))
    edges = sorted({t for a, b, _ in spans for t in (a, b)})
    names: List[Optional[str]] = []
    active: list = []
    k = 0
    for t in edges:
        while k < len(spans) and spans[k][0] <= t:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s[1] > t]
        names.append(max(active, key=lambda s: (s[0], -s[1]))[2] if active else None)
    return edges, names


def idle_under(trace, names: Iterable[str]) -> Optional[float]:
    """Seconds of the window's device-idle gaps whose start lies under one of
    the named spans as the innermost ``skghoi.`` span then open; each gap
    counts once, whole, wherever it ends."""
    names = set(names)
    if not trace.device or not _intervals(trace, names):
        return None
    edges, inner = _innermost(trace)
    bounds = [trace.t0] + [x for ab in trace.busy for x in ab] + [trace.t1]
    idle = 0.0
    for a, b in zip(bounds[::2], bounds[1::2]):
        a, b = max(a, trace.t0), min(b, trace.t1)
        if b <= a:
            continue
        i = bisect_right(edges, a) - 1
        if i >= 0 and inner[i] in names:
            idle += b - a
    return idle / 1e6


def launches_per_unit(ctx, names: Iterable[str]) -> Optional[float]:
    """``launches_under`` per traced unit."""
    n = launches_under(ctx.trace, names)
    return None if n is None else n / ctx.units


def idle_ms_per_unit(ctx, names: Iterable[str]) -> Optional[float]:
    """``idle_under`` in ms per traced unit."""
    s = idle_under(ctx.trace, names)
    return None if s is None else s / ctx.units * 1e3
