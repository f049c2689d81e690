"""flcheck rule registry: the round engine's machine-checked invariants.

Each rule is a function ``check(ctx) -> Iterable[Finding]`` registered
with the :func:`rule` decorator; :func:`run_rules` runs the whole
catalogue over an ``AuditContext`` (``repro_torch.analysis.audit``) holding
the program subjects (the ops one run dispatched, and on the card the
captured block's CUDA graph) and the live server/engine.  A rule whose
subject half is absent says so in an ``info`` finding (the graph half on
the CPU, or with ``compile=False``) -- silence never means "checked and
clean"; a capture or a graph dump that fails on the card is an ``error``.

The catalogue (DESIGN.md §8), the reference's names and severities:

====================== ======== ==========================================
rule                   severity invariant
====================== ======== ==========================================
one-sync-per-block     error    no op that reads a tensor on the host in
                                any program; on the card no device->host
                                copy and no host node in the block's
                                graph, and a replay under sync-debug
                                "error" raises nothing
donation-honored       error    the captured block reuses its buffers:
                                static inputs keep their addresses, a
                                second replay allocates no more
no-f64                 error    no float64/complex128 output of any op,
                                and none among the graph's static buffers
no-weak-type-promotion warning  each program output has its declared
                                dtype (params out as params in, scores
                                float32): torch has no weak types
no-host-callback-in-   error    no host read fired in more than one round
scan                            of the fused loop (it would fire xR)
conv-policy            error    conv tasks stay off the batched CPU path
compile-cache-         error    gathered shards' signatures independent of
stability                       WHICH participants; no block shape
                                captured twice (``engine.captures``)
====================== ======== ==========================================

Pure helpers (``check_donation``, ``check_conv_policy``,
``check_cache_stability``) carry the rule logic so tests can drive each
rule's known-bad branch without building a bad engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.analysis.report import Finding
from repro_torch.analysis.walker import CONV_OPS, has_op, iter_sites, tensors

RULES: Dict[str, Callable] = {}

_F64 = ("float64", "complex128")


def rule(name: str):
    """Register a check under ``name`` (registration order = run order)."""
    def register(fn):
        fn.rule_name = name
        RULES[name] = fn
        return fn
    return register


def run_rules(ctx, only: Sequence[str] = ()) -> List[Finding]:
    """Run the catalogue (or the ``only`` subset) over ``ctx``."""
    findings: List[Finding] = []
    for name, check in RULES.items():
        if only and name not in only:
            continue
        findings.extend(check(ctx))
    return findings


def _no_graph(s, ctx) -> Optional[str]:
    """Why subject ``s`` has no graph to read, for an ``info`` finding;
    None when it has one, or when its graph failed (an error)."""
    if s.graph is not None or s.graph_error:
        return None
    if ctx.device == "cpu":
        return "no captured graph on the CPU; only the ops half of the " \
               "rule ran"
    if not s.is_fused:
        return "runs eagerly on the card (only fused blocks replay a " \
               "graph); only the ops half of the rule ran"
    return "graph half skipped (compile=False); only the ops half of " \
           "the rule ran"


# ------------------------------------------------------- one-sync-per-block
@rule("one-sync-per-block")
def check_one_sync_per_block(ctx) -> Iterable[Finding]:
    """The fused block's log fetch (the caller copying the program's
    outputs) must be the only device->host edge: no op of any program may
    read a tensor on the host, and on the card the block's graph may hold
    no device->host copy and no host node, and a replay of it under
    ``set_sync_debug_mode("error")`` may raise nothing."""
    out: List[Finding] = []
    for s in ctx.subjects:
        if s.ops is not None:
            for site in iter_sites(s.ops):
                if site.host_read:
                    out.append(Finding(
                        "one-sync-per-block", "error",
                        f"host read {site.op!r} in the program (x"
                        f"{site.multiplier}) -- a device->host edge "
                        f"besides the output fetch", subject=s.name,
                        location=site.location))
        if s.graph_error:
            out.append(Finding(
                "one-sync-per-block", "error",
                f"the block's graph could not be read: {s.graph_error}",
                subject=s.name))
            continue
        why = _no_graph(s, ctx)
        if why is not None:
            out.append(Finding("one-sync-per-block", "info", why,
                               subject=s.name))
            continue
        g = s.graph
        xfers = dict(g.host_transfers)
        if xfers:
            detail = ", ".join(f"{k} x{v}" for k, v in sorted(xfers.items()))
            out.append(Finding(
                "one-sync-per-block", "error",
                f"device->host nodes in the block's graph ({detail}) -- "
                f"the block must sync with the host exactly once, via its "
                f"output fetch", subject=s.name,
                details={"host_transfers": xfers}))
        if g.sync_error:
            out.append(Finding(
                "one-sync-per-block", "error",
                f"a replay under sync-debug 'error' raised: {g.sync_error}",
                subject=s.name))
        if not xfers and not g.sync_error:
            out.append(Finding(
                "one-sync-per-block", "info",
                f"0 device->host nodes in {sum(g.nodes.kinds.values())} "
                f"graph nodes; a sync-debug replay raised nothing",
                subject=s.name, details={
                    "kinds": g.nodes.kinds, "memcpy": g.nodes.memcpy,
                    "kernels": g.nodes.kernels, "launches": g.launches,
                    "seconds": g.seconds}))
    return out


# --------------------------------------------------------- donation-honored
def check_donation(reuse, expect_donation: bool,
                   subject: str = "") -> List[Finding]:
    """Pure rule core: compare the buffer reuse asked for against what two
    replays of the captured block showed (``reuse``: a
    :class:`repro_torch.launch.graph_analysis.BufferReuse`, or None when
    there is no graph)."""
    if not expect_donation:
        return [Finding(
            "donation-honored", "info",
            "no buffer reuse asked for on the CPU (blocks run eagerly, "
            "as the reference donates nothing there)", subject=subject)]
    if reuse is None:
        return [Finding(
            "donation-honored", "error",
            "buffer reuse was asked for but there is no captured graph to "
            "check it on", subject=subject)]
    bad = []
    if not reuse.ptrs_kept:
        bad.append("the static inputs moved between replays")
    if reuse.allocated_second > reuse.allocated_first:
        bad.append(f"the second replay left {reuse.allocated_second:,} "
                   f"bytes allocated against {reuse.allocated_first:,} "
                   f"after the first")
    if bad:
        return [Finding(
            "donation-honored", "error",
            "the captured block does not reuse its buffers: "
            + "; ".join(bad) + " (peak memory grows every block)",
            subject=subject, details=dataclasses.asdict(reuse))]
    return [Finding(
        "donation-honored", "info",
        f"buffer reuse honored: static inputs kept their addresses; "
        f"{reuse.allocated_first:,} then {reuse.allocated_second:,} bytes "
        f"allocated after two replays", subject=subject,
        details=dataclasses.asdict(reuse))]


@rule("donation-honored")
def check_donation_honored(ctx) -> Iterable[Finding]:
    out: List[Finding] = []
    for s in ctx.subjects:
        if not s.is_fused:
            continue
        if s.graph is None and not s.graph_error and s.expect_donation:
            out.append(Finding("donation-honored", "info",
                               _no_graph(s, ctx), subject=s.name))
            continue
        out.extend(check_donation(
            None if s.graph is None else s.graph.reuse,
            s.expect_donation, subject=s.name))
    return out


# ------------------------------------------------------------------- no-f64
@rule("no-f64")
def check_no_f64(ctx) -> Iterable[Finding]:
    """FL round programs are fp32 end to end (scores are 4-byte fp32 by
    protocol); any f64 value silently doubles compute, memory, and the
    uplink accounting."""
    out: List[Finding] = []
    for s in ctx.subjects:
        if s.ops is not None:
            bad = [site for site in iter_sites(s.ops)
                   if set(site.dtypes) & set(_F64)]
            if bad:
                kinds = sorted({d for site in bad for d in site.dtypes
                                if d in _F64})
                where = ", ".join(f"{site.op} at {site.location}"
                                  for site in bad[:4])
                out.append(Finding(
                    "no-f64", "error",
                    f"{'/'.join(kinds)} outputs of {len(bad)} op site(s) "
                    f"in the program ({where}) -- a stray promotion "
                    f"doubles every byte", subject=s.name,
                    location=bad[0].location))
        if s.graph is not None and set(s.graph.static_dtypes) & set(_F64):
            out.append(Finding(
                "no-f64", "error",
                "float64/complex128 buffers among the graph's static "
                "inputs and outputs", subject=s.name))
    if not out:
        out.append(Finding("no-f64", "info",
                           f"{len(ctx.subjects)} program(s) clean"))
    return out


# --------------------------------------------------- no-weak-type-promotion
@rule("no-weak-type-promotion")
def check_no_weak_type(ctx) -> Iterable[Finding]:
    """Torch has no weakly-typed values; the hazard the reference's rule
    guards, an output whose dtype drifts from what its consumer expects,
    shows here as an output whose dtype is not the declared one."""
    out: List[Finding] = []
    for s in ctx.subjects:
        wrong = [f"{k}: {s.outputs.get(k)} (declared {v})"
                 for k, v in s.declared.items() if s.outputs.get(k) != v]
        if wrong:
            out.append(Finding(
                "no-weak-type-promotion", "warning",
                f"{len(wrong)} program output(s) off their declared dtype "
                f"({', '.join(wrong[:4])}) -- pin dtypes at the boundary",
                subject=s.name))
    if not out:
        out.append(Finding("no-weak-type-promotion", "info",
                           "every program output has its declared dtype"))
    return out


# ------------------------------------------------- no-host-callback-in-scan
@rule("no-host-callback-in-scan")
def check_no_callback_in_scan(ctx) -> Iterable[Finding]:
    """A host read inside the fused loop fires once per round -- R host
    round-trips smuggled into the 'one sync per block' program."""
    out: List[Finding] = []
    for s in ctx.subjects:
        if s.ops is None:
            continue
        for site in iter_sites(s.ops):
            if site.host_read and site.in_loop:
                out.append(Finding(
                    "no-host-callback-in-scan", "error",
                    f"{site.op!r} inside the fused round loop -- fires "
                    f"x{site.multiplier} per dispatch, one host round-trip "
                    f"each", subject=s.name, location=site.location))
    if not out:
        out.append(Finding("no-host-callback-in-scan", "info",
                           "no host reads inside the fused round loop"))
    return out


# -------------------------------------------------------------- conv-policy
def check_conv_policy(has_conv: bool, backend: str,
                      engine: str, subject: str = "") -> List[Finding]:
    """Pure rule core: conv tasks must not run on the batched CPU path
    (measured slower under every batched traversal, DESIGN.md §4)."""
    if has_conv and backend == "cpu" and engine == "batched":
        return [Finding(
            "conv-policy", "error",
            "convolution task on the batched CPU engine — XLA:CPU runs "
            "convs slower under every batched client-axis traversal "
            "(grouped convs under vmap, no fast conv thunk in loop "
            "bodies); route it to the sequential engine",
            subject=subject)]
    return [Finding(
        "conv-policy", "info",
        f"ok (conv={has_conv}, backend={backend}, engine={engine})",
        subject=subject)]


@rule("conv-policy")
def check_conv_policy_rule(ctx) -> Iterable[Finding]:
    out: List[Finding] = []
    for s in ctx.subjects:
        if s.ops is None or not s.is_round:
            continue
        out.extend(check_conv_policy(has_op(s.ops, CONV_OPS), ctx.device,
                                     ctx.engine, subject=s.name))
    return out


# ---------------------------------------------------- compile-cache-stability
def check_cache_stability(aval_sets: Sequence, traced_counts: Sequence[int]
                          = (), subject: str = "") -> List[Finding]:
    """Pure rule core.

    ``aval_sets``: one hashable (shape, dtype) signature per permuted
    participant selection — all must be identical, or each distinct
    participant subset compiles its own executable (the sample-then-
    stack contract caps the cache at one executable per participant
    count ``m``).  ``traced_counts``: the engine's
    ``traced_participant_counts`` ledger — a repeated entry means one
    ``m`` was traced twice (a cache miss on an already-seen shape).
    """
    out: List[Finding] = []
    sigs = {repr(s) for s in aval_sets}
    if len(sigs) > 1:
        out.append(Finding(
            "compile-cache-stability", "error",
            f"round-program avals depend on WHICH participants are "
            f"sampled ({len(sigs)} distinct signatures across "
            f"permutations) — every round would compile a fresh "
            f"executable instead of one per participant count",
            subject=subject))
    counts = list(traced_counts)
    dupes = sorted({m for m in counts if counts.count(m) > 1})
    if dupes:
        out.append(Finding(
            "compile-cache-stability", "error",
            f"participant count(s) {dupes} traced more than once — the "
            f"per-m compile cache is not being hit", subject=subject))
    if not out:
        out.append(Finding(
            "compile-cache-stability", "info",
            f"stable: {len(aval_sets)} permutation(s), one aval "
            f"signature; traced counts {sorted(set(counts))}",
            subject=subject))
    return out


def _signature(nest) -> tuple:
    return tuple(sorted((str(tuple(t.shape)), str(t.dtype).replace(
        "torch.", "")) for t in tensors(nest)))


@rule("compile-cache-stability")
def check_cache_stability_rule(ctx) -> Iterable[Finding]:
    """Gather the round's shards under permuted participant subsets and
    assert their signatures depend only on the participant count ``m``;
    and that no block shape was captured twice (``engine.captures``, the
    counterpart of ``traced_participant_counts``: one entry per capture,
    the block's shape, passed to the pure core by ``repr``)."""
    eng = getattr(ctx, "server", None) and ctx.server._engine
    if not eng:
        return [Finding("compile-cache-stability", "info",
                        "no batched engine; nothing to check")]
    m = eng.n_participants
    n = eng.n_clients
    rng = np.random.default_rng(0)
    sels = [np.arange(m), np.arange(n)[::-1][:m]] + [
        rng.permutation(n)[:m] for _ in range(2)]
    sigs = []
    for sel in sels:
        idx = torch.tensor(np.array(sel), device=eng.device)
        sub = tree.map(lambda a: a.index_select(0, idx), eng.data)
        mask = None if eng.mask is None else eng.mask.index_select(0, idx)
        sigs.append(_signature((sub, mask)))
    return check_cache_stability(
        sigs, [repr(k) for k in eng.captures],
        subject=f"round[{ctx.task}/{ctx.strategy}]")
