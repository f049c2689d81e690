"""The traced stretch: ``torch.profiler`` over whole blocks, reduced to
the device's busy time, kernel time by name, and the idle gaps named by
what the host was doing.

The span measured runs on the device's clock, from the end of a marker
kernel (``mark``), which the harness queues behind a lead-in block, to the
end of the last device activity: the traced blocks and the gap before
each, with the pipeline full.  The raw events are read from the
profiler's results directly (``kineto_results.events()``), not through
its per-op tables: a FedBWO block of the paper CNN replays some 150,000
kernels.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

# ``torch.cuda._sleep``'s kernel: no block of the port runs it
MARK = "spin_kernel"


@dataclasses.dataclass
class Trace:
    window_s: float                 # device clock, the marker's end to the last
    busy_s: float                   # union of device activity in that span
    rounds: int
    launches: int                   # the port's bwo_evolve counter
    kernels: Dict[str, Tuple[int, float]]   # name -> (count, seconds)
    gaps: List[Tuple[str, float]]   # longest idle gaps, by host activity
    short_gaps_s: float             # the idle gaps under 1 ms, summed


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")()) * 1000


def mark():
    """The marker kernel, on the current stream: it runs once the work
    queued before it has ended."""
    import torch
    torch.cuda._sleep(1)


def reduce_events(events):
    """(span seconds, busy seconds, kernels by name, the longest idle
    gaps, the idle gaps under 1 ms summed) from kineto events, over the
    span from the marker's end to the last device activity's end.
    Activities that began before the marker's end are
    clipped to the span and left out of the kernels by name."""
    from torch.autograd import DeviceType
    dev, host, marks = [], [], []
    for e in events:
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() != DeviceType.CUDA:
            host.append((start, start + dur, e.name()))
        elif MARK in e.name():
            marks.append(start + dur)
        else:
            dev.append((start, start + dur, e.name()))
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels "
                           f"({MARK}), not 1")
    lo = marks[0]
    dev = [d for d in dev if d[1] > lo]
    if not dev:
        raise RuntimeError("no device activity after the marker")
    hi = max(b for _, b, _ in dev)
    kernels = defaultdict(lambda: [0, 0])
    for a, b, name in dev:
        if a >= lo:
            k = kernels[name]
            k[0] += 1
            k[1] += b - a
    merged = [[lo, lo]]
    for a, b, _ in sorted((max(a, lo), b, n) for a, b, n in dev):
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)
    short = sum(g for g, _ in gaps if g < 1_000_000)
    gaps = gaps[:10]
    host.sort()
    named = []
    for length, at in gaps:
        # the innermost host activity under way when the device went idle
        under = [h for h in host if h[0] <= at < h[1]]
        name = max(under)[2] if under else "no host activity traced"
        named.append((f"host: {name}", length / 1e9))
    return (hi - lo) / 1e9, busy / 1e9, \
        {k: (c, s / 1e9) for k, (c, s) in kernels.items()}, named, short / 1e9


def trace(fn: Callable[[], int], rounds: int) -> Trace:
    """Run ``fn`` under the profiler, CPU and CUDA activity.  ``fn`` queues
    the marker and the ``rounds`` rounds traced behind it, ends in a sync,
    and returns the ``bwo_evolve`` launches it counted for them."""
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        launches = fn()
    span, busy, kernels, gaps, short = reduce_events(
        prof.profiler.kineto_results.events())
    return Trace(span, busy, rounds, launches, kernels, gaps, short)


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, seconds as measured."""
    ops = sorted(((name, s) for name, (_, s) in t.kernels.items()),
                 key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in t.gaps]}
