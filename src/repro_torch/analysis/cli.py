"""flcheck CLI: audit the round engine's contracts in the port.

    PYTHONPATH=src python -m repro_torch.analysis.cli --device cpu \\
        --task mlp --strategy fedbwo --strict

Builds a small experiment for the requested (task, strategy) on
``--device`` (the card unless ``cpu``), runs its round programs once each
under the op recorder (and on the card captures and reads the block's CUDA
graph), runs the rule catalogue (repro_torch.analysis.rules) plus the AST
lint over ``src/repro_torch``, and prints the findings report.  Exit
status: 0 unless ``--strict`` is given and error-severity findings survive
(DESIGN.md §8).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.audit import audit_experiment
from repro_torch.core.api import (FLConfig, PARTITIONS, TASKS,
                                  build_experiment, strategy_names)


def build_audit_config(args) -> FLConfig:
    """A deliberately small config: the contracts are shape/program
    properties, so a 4-client toy build audits the same programs a
    production run would dispatch."""
    return FLConfig(
        strategy=args.strategy, task=args.task,
        n_clients=args.clients, client_ratio=args.client_ratio,
        partition=args.partition, n_train=240, n_test=60, batch_size=8,
        local_epochs=1, mh_pop=2, mh_generations=1,
        engine=args.engine, rounds_per_dispatch=args.rounds_per_dispatch,
        max_rounds=2, device=args.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.cli",
        description="flcheck: static auditor for the FL round engine")
    ap.add_argument("--task", default="mlp", choices=list(TASKS))
    ap.add_argument("--strategy", default="fedbwo",
                    choices=list(strategy_names()))
    ap.add_argument("--partition", default="iid",
                    choices=list(PARTITIONS))
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--client-ratio", type=float, default=1.0)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--rounds-per-dispatch", default="auto")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when error-severity findings survive")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the graph half on the card (the ops and "
                         "the AST only)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint pass")
    ap.add_argument("--show-info", action="store_true",
                    help="include info-severity findings in the report")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full report as JSON")
    args = ap.parse_args(argv)

    cfg = build_audit_config(args)
    exp = build_experiment(cfg)
    print(f"flcheck: auditing task={cfg.task} strategy={cfg.strategy} "
          f"engine={exp.server.engine} "
          f"rounds_per_dispatch={exp.server.rounds_per_dispatch} "
          f"clients={cfg.n_clients} device={exp.server.device}", flush=True)
    report = audit_experiment(exp, compile=not args.no_compile,
                              lint=not args.no_lint)
    print(report.render(show_info=args.show_info))
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.to_json())
    return 1 if (args.strict and not report.ok) else 0


if __name__ == "__main__":
    sys.exit(main())
