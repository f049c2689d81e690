"""FedBWO / FedAvg federated-training driver (the paper's experiment) on
the card, a thin CLI over the ``FLConfig`` experiment facade
(repro_torch.core.api).

    PYTHONPATH=src python -m repro_torch.launch.fl_train --bwo-kernel
    PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
        --clients 3 --rounds 2 --train 90 --test 30 --pop 2 --generations 1

The flags are the reference driver's, plus ``--bwo-kernel`` and
``--device``.  On the card ``--engine auto`` runs the batched engine (one
vmapped program over the clients); on the CPU it keeps the conv task
sequential, and ``--engine batched --vectorize vmap|scan`` batches it
anyway.  ``--rounds-per-dispatch auto`` (5 on the batched engine) runs
blocks of rounds, one CUDA graph replay each on the card, double-buffered
by default (``--pipeline-blocks``).  ``--audit`` runs the flcheck
static auditor (``repro_torch.analysis``) on the build before any round.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import FLConfig, build_experiment
from repro_torch.core.api import strategy_names, TASKS
from repro_torch.core.knobs import (AUDIT_MODES, validate_audit,
                                    validate_engine,
                                    validate_pipeline_blocks,
                                    validate_rounds_per_dispatch,
                                    validate_vectorize)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="fedbwo",
                    choices=list(strategy_names()))
    ap.add_argument("--task", default="cnn", choices=list(TASKS),
                    help="cnn = the paper's CNN; mlp = FedAvg 2NN")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--client-ratio", type=float, default=1.0)
    ap.add_argument("--train", type=int, default=1000)
    ap.add_argument("--test", type=int, default=300)
    ap.add_argument("--batch", type=int, default=10)       # paper §IV-A
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.0025)    # paper §IV-A
    ap.add_argument("--pop", type=int, default=6)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--tau", type=float, default=0.70)     # paper §IV-D
    ap.add_argument("--non-iid", action="store_true",
                    help="Dirichlet label-skew partition")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="Dirichlet concentration for --non-iid")
    ap.add_argument("--engine", default="auto", type=validate_engine,
                    metavar="auto|batched|sequential",
                    help="round engine: batched = one program over "
                         "every client a round (repro_torch.core.engine); "
                         "sequential = one client after another; auto "
                         "picks batched when client data stacks "
                         "(pad+mask for ragged), except conv tasks on "
                         "the CPU")
    ap.add_argument("--vectorize", default="auto", type=validate_vectorize,
                    metavar="auto|vmap|scan[:k]|unroll",
                    help="client-axis traversal of the batched engine")
    ap.add_argument("--rounds-per-dispatch", default="1",
                    type=validate_rounds_per_dispatch, metavar="auto|R",
                    help="fuse R rounds into one dispatch with one host "
                         "copy per block, one CUDA graph replay on the "
                         "card (batched engine only; auto = 5)")
    ap.add_argument("--pipeline-blocks", nargs="?", const="on",
                    default="auto", type=validate_pipeline_blocks,
                    metavar="auto|on|off",
                    help="double-buffer fused block dispatches against "
                         "host-side log processing; bare flag = on, "
                         "default auto pipelines whenever "
                         "rounds-per-dispatch > 1 on the batched engine")
    ap.add_argument("--eval-every", type=int, default=1, metavar="K",
                    help="evaluate the global model every K-th round; "
                         "fused blocks run the cadence on the device")
    ap.add_argument("--audit", nargs="?", const="strict", default="off",
                    type=validate_audit, metavar="|".join(AUDIT_MODES),
                    help="run the flcheck static auditor "
                         "(repro_torch.analysis) before training; bare "
                         "flag = strict (fail on error findings)")
    ap.add_argument("--bwo-kernel", action="store_true",
                    help="run every BWO generation through the "
                         "hand-written bwo_evolve CUDA kernel")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cfg = FLConfig(
        strategy=args.strategy, task=args.task, n_clients=args.clients,
        client_ratio=args.client_ratio,
        partition="dirichlet" if args.non_iid else "iid",
        dirichlet_alpha=args.alpha, n_train=args.train, n_test=args.test,
        batch_size=args.batch, local_epochs=args.local_epochs, lr=args.lr,
        mh_pop=args.pop, mh_generations=args.generations,
        engine=args.engine, vectorize=args.vectorize,
        rounds_per_dispatch=args.rounds_per_dispatch,
        pipeline_blocks=args.pipeline_blocks,
        eval_every=args.eval_every,
        max_rounds=args.rounds, tau=args.tau,
        device=args.device, bwo_kernel=args.bwo_kernel)
    exp = build_experiment(cfg, audit=args.audit)
    print(f"strategy={cfg.strategy} clients={cfg.n_clients} "
          f"partition={cfg.partition} engine={exp.server.engine} "
          f"device={exp.server.device} bwo_kernel={cfg.bwo_kernel} "
          f"rounds_per_dispatch={exp.server.rounds_per_dispatch} "
          f"pipeline_blocks={exp.server.pipeline_blocks} "
          f"model_bytes={exp.meter.model_bytes:,}")
    result = exp.run(verbose=True)

    summary = result.summary(fedavg_rounds=30)
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary,
                       "rounds": [vars(l) for l in result.logs]}, f,
                      indent=1, default=str)


if __name__ == "__main__":
    main()
