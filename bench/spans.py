"""The port's span log (``repro_torch.spans``) as the per-layer metrics
read it: the latest round engine's device spans over the traced rounds,
summed by name, and its set-up's host spans.  A port without the log
gives None, as does a log without the spans asked for.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional


def _log():
    try:
        return importlib.import_module("repro_torch.spans")
    except ImportError:
        return None


def _owner(log) -> Optional[int]:
    """The latest round engine's owner number."""
    if log.BLOCKS:
        return log.BLOCKS[-1].owner
    owners = [o for o, _ in log.SETUP if o is not None]
    return owners[-1] if owners else None


def traced(ctx) -> Optional[Dict[str, dict]]:
    """By span name, over the latest engine's spans whose rounds lie in
    the traced rounds ``[traced_from, traced_from + rounds)``: ``s`` the
    seconds, ``self_s`` the seconds less those of the spans directly
    inside, ``count`` the work counts and ``n`` the spans.  None when the
    run was not traced or no span lies there."""
    log = _log()
    if log is None or ctx.trace is None or not log.BLOCKS:
        return None
    owner = _owner(log)
    lo, hi = ctx.traced_from, ctx.traced_from + ctx.trace.rounds
    sums: Dict[str, dict] = {}
    for block in log.BLOCKS:
        if block.owner != owner:
            continue
        inner = [0.0] * len(block.spans)
        for sp in block.spans:
            if sp.parent is not None:
                inner[sp.parent] += sp.seconds
        for sp, kids in zip(block.spans, inner):
            if sp.round is None or not lo <= sp.round < hi:
                continue
            d = sums.setdefault(sp.name, {"s": 0.0, "self_s": 0.0,
                                          "count": 0, "n": 0})
            d["s"] += sp.seconds
            d["self_s"] += sp.seconds - kids
            d["count"] += sp.count or 0
            d["n"] += 1
    return sums or None


def setup_seconds(name: str) -> Optional[float]:
    """The seconds of the latest engine's set-up host spans called
    ``name``, summed; None when it has none."""
    log = _log()
    if log is None:
        return None
    owner = _owner(log)
    found = [sp.seconds for o, sp in log.SETUP
             if o == owner and sp.name == name]
    return sum(found) if owner is not None and found else None
