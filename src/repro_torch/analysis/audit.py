"""flcheck orchestration: build program subjects from a live experiment
and run the rule catalogue + AST lint over them.

The reference traces and compiles its round programs and executes
nothing; eager torch has no trace to read, so ``collect_subjects`` runs
each engine-built program once, exactly as the server would dispatch it
and at the build's shapes -- the single-round program, the fused R-round
block and the eval fn (the client update on the sequential engine) --
under the op recorder (:mod:`repro_torch.analysis.walker`).  On the card,
with ``compile=True`` (the reference's switch name for its HLO half), it
also captures the block as a CUDA graph, dumps and counts its nodes,
replays it twice for buffer reuse and once under sync-debug "error"
(:mod:`repro_torch.launch.graph_analysis`).  The block's eager run goes on
the capture's own stream first, as the engine's warm-up round does.

Nothing of the server changes: every program runs on clones of its params
and key, and the ledgers the audit touches (the engine's ``captures``,
``bwo_evolve``'s launch counter) are restored.  **The block graph the
audit captures is dropped**, not kept for the run: the engine captures its
own at the run's first block, so the rounds of an audited build equal an
unaudited build's bit for bit.  A capture or a graph dump that fails on
the card, or a block that does not run there, is an error finding of
``one-sync-per-block`` and ``donation-honored``.

``audit_experiment`` is the one entry point: the CLI
(``repro_torch.analysis.cli``), the opt-in build hook
(``build_experiment(..., audit=...)``), and the tests all call it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import random, tree
from repro_torch.analysis.pylint_torch import lint_paths
from repro_torch.analysis.report import AuditError, Finding, Report
from repro_torch.analysis.rules import run_rules
from repro_torch.analysis.walker import OpRecording, record_ops
from repro_torch.core.engine import CapturedBlock
from repro_torch.core.knobs import DEFAULT_ROUNDS_PER_DISPATCH
from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
from repro_torch.launch.graph_analysis import BlockGraph, read_block_graph


@dataclasses.dataclass
class ProgramSubject:
    """One engine-built program under audit."""
    name: str
    ops: Optional[OpRecording] = None   # the ops one run dispatched
    graph: Optional[BlockGraph] = None  # on the card: the block's graph
    graph_error: str = ""               # why the card's graph is missing
    outputs: Dict[str, str] = dataclasses.field(default_factory=dict)
    declared: Dict[str, str] = dataclasses.field(default_factory=dict)
    expect_donation: bool = False       # buffer reuse asked for (the card)
    is_round: bool = False              # a client-training round program
    is_fused: bool = False              # the R-round block program


@dataclasses.dataclass
class AuditContext:
    """Everything the rules see: the subjects plus build metadata."""
    subjects: List[ProgramSubject]
    server: Any = None
    task: str = ""
    strategy: str = ""
    device: str = ""                    # "cpu" | "cuda"
    engine: str = "sequential"


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _dtypes(prefix: str, nest) -> Dict[str, str]:
    """``{name: dtype}`` for the tensors of a param tree or a dict of
    logs, named ``prefix/path``."""
    return {f"{prefix}{p}": _dtype(t)
            for p, t in zip(tree.paths(nest), tree.leaves(nest))}


def _record(s: ProgramSubject, fn, args, findings) -> Any:
    """Run ``fn`` under the op recorder into ``s.ops``: its output, or None
    (and an ``audit`` warning) when it raised."""
    try:
        s.ops, out = record_ops(fn, *args)
    except Exception as e:            # surface, don't crash the audit
        findings.append(Finding("audit", "warning",
                                f"could not run: {type(e).__name__}: {e}",
                                subject=s.name))
        return None
    return out


def _first_line(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"


def _read_graph(block, args, stream) -> tuple:
    """Capture ``block`` on ``stream`` (keeping its ``cudaGraph_t``), read
    it, and drop it: ``(BlockGraph, "")``, or ``(None, why)`` when the
    capture or the dump failed."""
    params, rng, data, mask, eval_batch, offset = args
    try:
        captured = CapturedBlock(block, params, rng, data, mask, eval_batch,
                                 offset, stream, keep_graph=True)
    except Exception as e:            # the capture refused an op: a finding
        return None, f"the capture failed: {_first_line(e)}"
    try:
        with tempfile.TemporaryDirectory() as d:
            return read_block_graph(captured, params, rng, eval_batch,
                                    os.path.join(d, "block.dot")), ""
    except Exception as e:
        return None, f"reading the captured graph failed: {_first_line(e)}"
    finally:
        captured.graph.reset()


def collect_subjects(server, eval_data=None, eval_every: int = 1,
                     compile: bool = True,
                     findings: Optional[List[Finding]] = None
                     ) -> List[ProgramSubject]:
    """Run the server's round programs once each as audit subjects (see
    the module docstring).

    Batched engine: the single-round program (FedX, or FedAvg at its
    participant count with the participants drawn and gathered), the
    fused ``rounds_per_dispatch``-round block (the knobs default when the
    server runs single-round dispatches, so the fused contract is audited
    regardless), and the eval fn.  Sequential engine: the per-client
    update program and the eval fn.
    """
    findings = [] if findings is None else findings
    subjects: List[ProgramSubject] = []
    eng = server._engine
    ledger = None if eng is None else list(eng.captures)
    launches = bwo_kernel.launches
    try:
        _collect(subjects, server, eng, eval_data, eval_every, compile,
                 findings)
    finally:
        bwo_kernel.launches = launches
        if eng is not None:
            eng.captures[:] = ledger
    return subjects


def _collect(subjects, server, eng, eval_data, eval_every, compile,
             findings):
    params = tree.map(torch.clone, server.global_params)
    rng = server.rng.clone()
    keys = random.split(rng, server.n_clients + 2)
    sel_key, ckeys = keys[1], keys[2:]
    declared = _dtypes("params", params)
    name = server.strategy.name
    if eng is not None:
        s = ProgramSubject(f"round[{name}]", is_round=True)
        if eng.is_fedx:
            out = _record(s, eng.fedx_round, (params, ckeys), findings)
        else:
            out = _record(s, eng.fedavg_round, (params, sel_key, ckeys),
                          findings)
        if out is not None:
            s.outputs = {**_dtypes("params", out[0]),
                         "scores": _dtype(out[1])}
            s.declared = {**declared, "scores": "float32"}
        subjects.append(s)
        rpd = (server.rounds_per_dispatch
               if server.rounds_per_dispatch > 1
               else DEFAULT_ROUNDS_PER_DISPATCH)
        every = eval_every if eval_data is not None else 0
        subjects.append(_block_subject(
            f"block[{name} x{rpd}]", eng, eng.fused_rounds(rpd, every),
            (params, rng, eng.data, eng.mask, eval_data, 0), declared,
            compile, findings))
    else:
        s = ProgramSubject(f"client_update[{name}]", is_round=True)
        out = _record(s, server._update,
                      (params, server.client_data[0], None, ckeys[0]),
                      findings)
        if out is not None:
            s.outputs = {"score": _dtype(out[0]),
                         **_dtypes("params", out[1])}
            s.declared = {"score": "float32", **declared}
        subjects.append(s)
    if eval_data is not None:
        s = ProgramSubject("eval")
        with torch.no_grad():
            out = _record(s, server.task.loss_fn, (params, eval_data),
                          findings)
        if out is not None:
            s.outputs = {"loss": _dtype(out[0]), "acc": _dtype(out[1])}
            s.declared = {"loss": "float32", "acc": "float32"}
        subjects.append(s)


def _block_subject(name, eng, block, args, declared, compile, findings):
    on_card = eng.device.type == "cuda"
    s = ProgramSubject(name, is_round=True, is_fused=True,
                       expect_donation=on_card)
    if not on_card:
        out = _record(s, block, args, findings)
    else:
        # the eager run on the capture's stream is also its warm-up
        stream = torch.cuda.Stream(eng.device)
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            out = _record(s, block, args, findings)
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        torch.cuda.synchronize(eng.device)
        if out is None:               # no graph to read: an error
            s.graph_error = f"the block did not run: {findings[-1].message}"
        elif compile:
            run_s = time.perf_counter() - t0
            s.graph, s.graph_error = _read_graph(block, args, stream)
            if s.graph is not None:
                s.graph.seconds["eager_run"] = run_s
    if out is not None:
        params, rng, logs = out
        s.outputs = {**_dtypes("params", params), "rng": _dtype(rng),
                     **_dtypes("logs", logs)}
        s.declared = {**declared, "rng": _dtype(args[1]),
                      "logs/scores": "float32"}
        s.declared.update({k: "float32" for k in ("logs/eval_loss",
                                                  "logs/eval_acc")
                           if k in s.outputs})
    return s


def audit_experiment(experiment, *, compile: bool = True,
                     lint: bool = True,
                     lint_roots: Optional[Sequence[str]] = None,
                     strict: bool = False) -> Report:
    """Audit a built :class:`repro_torch.core.api.Experiment` (or any
    object with ``.server`` / ``.eval_data``): run every rule over its
    round programs plus the AST lint over the package source.

    ``strict=True`` raises :class:`AuditError` when any error-severity
    finding survives -- the contract gate used by
    ``build_experiment(..., audit=True)`` and ``fl_train --audit``.
    """
    server = getattr(experiment, "server", experiment)
    eval_data = getattr(experiment, "eval_data", None)
    cfg = getattr(experiment, "cfg", None)
    report = Report()
    subjects = collect_subjects(server, eval_data=eval_data,
                                eval_every=getattr(cfg, "eval_every", 1),
                                compile=compile, findings=report.findings)
    ctx = AuditContext(
        subjects=subjects, server=server,
        task=getattr(cfg, "task", ""),
        strategy=server.strategy.name,
        device=server.device.type,
        engine=server.engine)
    report.extend(run_rules(ctx))
    if lint:
        report.extend(lint_paths(lint_roots))
    if strict and not report.ok:
        raise AuditError(report)
    return report
