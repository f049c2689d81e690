"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), and the comparison that decides ``correct``.

* Set-up: the inputs from the seed (``bench/data.py``), ``build_experiment``
  at the traffic mix's settings (``bench/port.py``), then one block
  outside the window through the window's own calls (``dispatch_block`` /
  ``finish_block``): the eager warm-up round, the capture of the block's
  CUDA graph and its first replay.
* Window: ``Server.run_pipelined`` with a ``stop_fn`` on the harness's
  clock.  It ends at the sync of the last block that ran (the one that
  finished past ``seconds`` and the one in flight behind it), and every
  round of every block in it is counted: ``round_s`` is the window's
  seconds over its rounds.
* Traced stretch (``--trace 1``): after the window, ``trace_blocks`` more
  whole blocks under ``torch.profiler``, queued behind a lead-in block as
  the window's blocks queue behind each other (``traced_stretch``).
* Check: once the window has closed and the peak memory is read, the
  port's state is freed and the reference runs (``bench/check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import time
from pathlib import Path
from typing import Any, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Spec:
    workload: dict
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    follow_rounds: int
    limits: dict


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(name: str, manifest: Optional[dict] = None) -> Spec:
    """A cell of ``BENCHMARK.json`` and the files it names: the
    configuration's file, ``traffic/<traffic>.json``, ``limits/<cell>.json``
    and the metrics that apply to it."""
    m = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    lim = load_json(BENCH / "limits" / f"{name}.json")
    e2e = [e for e in m["end_to_end"]
           if name in e.get("workloads", [name])]
    moved = {e["name"] for e in e2e}
    layer = [p for p in m["per_layer"]
             if name in p.get("workloads", [name] if p["moves"] in moved
                              else [])]
    return Spec(w, cfg, traffic, e2e, layer, lim["follow_rounds"],
                lim["limits"])


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""
    cfg: dict
    traffic: dict
    trace: Any
    traced_from: int
    window: dict
    setup: dict


def read_metric(name: str, ctx: Context):
    return importlib.import_module(f"bench.metrics.{name}").read(ctx)


def traced_stretch(server, R: int, blocks: int, eval_data, every: int,
                   infos: list, sync):
    """``blocks`` whole blocks under the profiler, on a full pipeline: a
    lead-in block is dispatched first (on an idle card, so it pays the
    pipeline's fill), a marker kernel behind it on its stream, and the
    traced blocks queue behind that, as the window's do.  The reduction
    measures from the marker's end: ``blocks`` blocks and the gap before
    each.  The stretch's rounds go into ``infos``."""
    from bench import port, tracing
    from repro_torch.core.engine import pipeline_blocks
    from repro_torch.core.knobs import DEFAULT_PIPELINE_DEPTH
    counted = []

    def dispatch(n):
        pending = server.dispatch_block(n, eval_data, every)
        if not counted:
            tracing.mark()
            counted.append(port.bwo_launches())
        return pending

    def stretch():
        results, _, _ = pipeline_blocks(dispatch, server.finish_block,
                                        [R] * (1 + blocks),
                                        depth=DEFAULT_PIPELINE_DEPTH)
        infos.extend(i for blk in results for i in blk)
        sync()
        return port.bwo_launches() - counted[0]

    return tracing.trace(stretch, R * blocks)


def _finite(info: dict) -> bool:
    vals = list(info["scores"]) + [info.get("eval_loss", 0.0)]
    return all(math.isfinite(v) for v in vals)


def run(spec: Spec, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", engine: str = "auto",
        hook=None) -> dict:
    """One run; returns the result line's dict (``checks`` last).
    ``hook(obs, inputs, model, traffic)``, if given, runs after the check
    and its result goes under ``hook`` (``calibrate.py``'s readings)."""
    import torch

    from bench import check, data, port, tracing
    from bench.reference import fl

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg, traffic = spec.cfg, spec.traffic
    phases = {"start": time.perf_counter() - t_start}
    inputs = data.make_inputs(cfg, traffic, seed, device)
    sync()
    phases["inputs"] = time.perf_counter() - t_start
    layout = importlib.import_module(f"bench.models.{cfg['model']}") \
        .layout(cfg)
    exp = port.build(cfg, traffic, seed, inputs, layout, device, engine)
    server = exp.server
    R = server.rounds_per_dispatch
    every = traffic["eval_every"]
    run_traffic = dict(traffic, rounds_per_dispatch=R)
    sync()
    phases["built"] = time.perf_counter() - t_start

    # the set-up block, through the window's own calls
    sync()
    t0 = time.perf_counter()
    pending = server.dispatch_block(R, inputs.eval, every)
    warmup_capture_s = time.perf_counter() - t0
    first = server.finish_block(pending)
    del pending
    p_setup = port.flat_params(server.global_params)
    n_timed = len(server.meter.block_timings)
    sync()

    # the measured window
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    res = server.run_pipelined(
        R * 100_000, inputs.eval, every,
        stop_fn=lambda info: time.perf_counter() >= deadline)
    sync()
    t_w1 = time.perf_counter()
    infos = list(res.infos)
    window_timing = server.meter.block_timings[n_timed:]
    window = {"rounds": len(infos), "seconds": t_w1 - t_w0,
              "timing": {"dispatch_s": sum(t.dispatch_s
                                           for t in window_timing)}}
    traced, traced_from = None, server.rounds_completed + R
    later = []
    if trace:
        traced = traced_stretch(server, R, traffic["trace_blocks"],
                                inputs.eval, every, later, sync)
        phases["traced"] = time.perf_counter() - t_start
    p_final = port.flat_params(server.global_params)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    last = (later or infos)[-1]
    obs = check.Observed(first=first, ends=[(p_setup, first[-1]),
                                            (p_final, last)],
                         rounds=first + infos + later,
                         uplink=list(server.meter.uplink),
                         downlink=list(server.meter.downlink))
    del exp, server, res
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    model = fl.Model(cfg, device, fl.Precision("float64"))
    found = check.numbers(model, inputs, seed, run_traffic, obs,
                          spec.follow_rounds)
    correct, rows = check.judge(found, spec.limits)
    phases["checked"] = time.perf_counter() - t_start
    hooked = None if hook is None else hook(obs, inputs, model, run_traffic)

    metrics = {}
    if trace:
        ctx = Context(cfg, run_traffic, traced, traced_from, window,
                      {"warmup_capture_s": warmup_capture_s})
        for m in spec.per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"round_s": window["seconds"] / max(window["rounds"], 1),
               "setup_s": t_w0 - t_start}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct) and window["rounds"] > 0,
           "attempted": window["rounds"],
           "failed": sum(not _finite(i) for i in infos),
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        out["breakdown"] = tracing.breakdown(traced)
        out["trace_counts"] = {
            "device_events": sum(c for c, _ in traced.kernels.values()),
            "bwo_evolve": sum(c for name, (c, _) in traced.kernels.items()
                              if "bwo_evolve" in name),
            "launches": traced.launches, "rounds": traced.rounds,
            "short_gaps_s": traced.short_gaps_s}
    phases["window_end"] = t_w1 - t_start
    out["phases"] = phases
    if hooked is not None:
        out["hook"] = hooked
    out["numbers"] = found
    out["checks"] = rows
    return out
