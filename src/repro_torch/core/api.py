"""Experiment facade: ``FLConfig`` -> ``build_experiment()`` -> ``run()``.

    cfg = FLConfig(strategy="fedbwo", bwo_kernel=True)      # on the card
    result = build_experiment(cfg).run(verbose=True)
    print(result.summary())

The port's counterpart of ``repro.core.api``, with three more fields:
``device`` ("cuda" unless the caller asks for "cpu"; a missing card
raises), ``bwo_kernel``, which routes every BWO generation through the
hand-written ``bwo_evolve`` kernel (the default stays the composed step,
as in the reference), and ``spans``, which stamps each fused block's
device spans (``repro_torch.spans``; on by default).
``build_experiment`` accepts ``task`` / ``client_data`` / ``eval_data`` /
``hp`` overrides so one synthesized dataset (or a custom task) can serve
many configs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch import random
from repro_torch.core.client import ClientHP, Task
from repro_torch.core.comm import fedavg_total, normalized_cost
from repro_torch.core.knobs import (parse_audit, validate_engine,
                                    validate_pipeline_blocks,
                                    validate_rounds_per_dispatch,
                                    validate_vectorize)
from repro_torch.core.protocol import RoundLog, StopConditions, run_federated
from repro_torch.core.server import Server, get_strategy
from repro_torch.device import resolve_device
from repro_torch.metaheuristics import REGISTRY

TASKS = ("cnn", "mlp")
PARTITIONS = ("iid", "dirichlet")


def strategy_names() -> tuple:
    """fedavg plus one fedX per ported meta-heuristic."""
    return ("fedavg",) + tuple(sorted("fed" + k for k in REGISTRY))


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Everything needed to reproduce one federated run.

    Defaults follow the paper's §IV-A setup (batch 10, lr 0.0025,
    tau 0.70); knob vocabularies are validated once, at construction.
    """
    strategy: str = "fedbwo"
    task: str = "cnn"               # "cnn" (paper) | "mlp" (FedAvg 2NN)
    n_clients: int = 10
    client_ratio: float = 1.0       # C — FedAvg participation ratio
    partition: str = "iid"          # "iid" | "dirichlet"
    dirichlet_alpha: float = 0.5
    n_train: int = 1000
    n_test: int = 300
    batch_size: int = 10            # paper §IV-A
    local_epochs: int = 2
    lr: float = 0.0025              # paper §IV-A
    mh_pop: int = 6
    mh_generations: int = 3
    # knobs.ENGINES; auto = batched, except conv tasks on the CPU
    engine: str = "auto"
    vectorize: str = "auto"         # knobs.VECTORIZE_MODES (batched engine)
    # rounds fused into one dispatch ("auto" | int >= 1): R > 1 runs
    # blocks of R rounds, one CUDA graph replay each on the card, with one
    # host copy per block; "auto" = 5 on the batched engine, 1 on the
    # sequential one
    rounds_per_dispatch: Any = 1
    # double-buffer fused blocks ("auto" | "on" | "off"); "auto" = on
    # whenever rounds_per_dispatch > 1 on the batched engine
    pipeline_blocks: Any = "auto"
    # evaluate the global model every k-th round (the last round always)
    eval_every: int = 1
    max_rounds: int = 8
    patience: int = 5               # paper: t = 5
    tau: float = 0.70               # paper §IV-D
    data_seed: int = 42
    partition_seed: int = 1
    server_seed: int = 7
    device: str = "cuda"            # "cuda" | "cpu"; no card -> raises
    # FedBWO: run each generation through the bwo_evolve kernel (the
    # reference's get_strategy(..., use_pallas=True) route)
    bwo_kernel: bool = False
    # stamp each fused block's device spans (repro_torch.spans): round,
    # sgd, fitness, threefry; off, no stamp is captured, same results
    spans: bool = True

    def __post_init__(self):
        validate_engine(self.engine)
        validate_vectorize(self.vectorize)
        validate_rounds_per_dispatch(self.rounds_per_dispatch)
        validate_pipeline_blocks(self.pipeline_blocks)
        if self.eval_every < 1:
            raise ValueError(f"eval_every={self.eval_every} must be >= 1")
        if self.task not in TASKS:
            raise ValueError(f"task={self.task!r} not in {TASKS}")
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"partition={self.partition!r} not in {PARTITIONS}")
        if self.strategy not in strategy_names():
            raise ValueError(f"strategy={self.strategy!r} not in "
                             f"{strategy_names()}")
        if not 0.0 < self.client_ratio <= 1.0:
            raise ValueError(
                f"client_ratio={self.client_ratio} not in (0, 1]")

    def client_hp(self) -> ClientHP:
        return ClientHP(local_epochs=self.local_epochs, lr=self.lr,
                        mh_pop=self.mh_pop,
                        mh_generations=self.mh_generations,
                        vectorize=self.vectorize)

    def stop_conditions(self) -> StopConditions:
        return StopConditions(max_rounds=self.max_rounds,
                              patience=self.patience, tau=self.tau)


def build_experiment(cfg: FLConfig, *, task: Optional[Task] = None,
                     client_data: Optional[list] = None,
                     eval_data: Any = None,
                     hp: Optional[ClientHP] = None,
                     audit: Any = "off") -> "Experiment":
    """Materialize an :class:`Experiment` from a config on ``cfg.device``:
    synthesize the dataset, partition and batch it across clients, and
    construct the ``Server``.  Overrides given as tensors must already
    lie on that device.

    ``audit`` opts the build into the flcheck static auditor
    (``repro_torch.analysis``, knobs.AUDIT_MODES): ``"report"`` runs the
    rule catalogue over the engine-built round programs and prints the
    findings; ``"strict"`` (or ``audit=True``) additionally raises
    :class:`repro_torch.analysis.AuditError` on any error-severity
    finding, so a contract regression fails the build before any round
    runs.  The audit leaves the server as it found it.
    """
    # local imports: repro_torch.data imports repro_torch.core.client
    from repro_torch.data.loader import client_batches
    from repro_torch.data.partition import partition_dirichlet, partition_iid
    from repro_torch.data.synthetic import cnn_task, make_cifar_like, mlp_task

    mode = parse_audit(audit)
    device = resolve_device(cfg.device)
    if task is None:
        task = cnn_task() if cfg.task == "cnn" else mlp_task()
    if client_data is None or eval_data is None:
        train, test = make_cifar_like(random.PRNGKey(cfg.data_seed, device),
                                      cfg.n_train, cfg.n_test)
        if eval_data is None:
            eval_data = test
        if client_data is None:
            pkey = random.PRNGKey(cfg.partition_seed, device)
            if cfg.partition == "dirichlet":
                parts = partition_dirichlet(pkey, train, cfg.n_clients,
                                            alpha=cfg.dirichlet_alpha)
            else:
                parts = partition_iid(pkey, train, cfg.n_clients)
            client_data = client_batches(parts, cfg.batch_size)
    mh_kw = {"use_kernel": cfg.bwo_kernel} if cfg.strategy == "fedbwo" else {}
    server = Server(task,
                    get_strategy(cfg.strategy,
                                 client_ratio=cfg.client_ratio, **mh_kw),
                    hp if hp is not None else cfg.client_hp(),
                    client_data, random.PRNGKey(cfg.server_seed, device),
                    engine=cfg.engine,
                    rounds_per_dispatch=cfg.rounds_per_dispatch,
                    pipeline_blocks=cfg.pipeline_blocks,
                    spans=cfg.spans)
    experiment = Experiment(cfg=cfg, server=server, eval_data=eval_data,
                            stop=cfg.stop_conditions())
    if mode != "off":
        # local import: repro_torch.analysis.audit imports this module's
        # collaborators from repro_torch.core, so the hook resolves lazily
        from repro_torch.analysis.audit import audit_experiment
        experiment.audit_report = audit_experiment(
            experiment, strict=(mode == "strict"))
        print(experiment.audit_report.render())
    return experiment


@dataclasses.dataclass
class Experiment:
    """A wired-up federated run: ``.run()`` drives it to completion."""
    cfg: FLConfig
    server: Server
    eval_data: Any
    stop: StopConditions
    audit_report: Any = None        # the build's flcheck Report, if audited

    @property
    def meter(self):
        return self.server.meter

    def run(self, verbose: bool = False) -> "ExperimentResult":
        logs = run_federated(self.server, self.eval_data, self.stop,
                             verbose=verbose,
                             eval_every=self.cfg.eval_every)
        return ExperimentResult(cfg=self.cfg, server=self.server,
                                logs=logs)


@dataclasses.dataclass
class ExperimentResult:
    cfg: FLConfig
    server: Server
    logs: List[RoundLog]

    def summary(self, fedavg_rounds: int = 30) -> dict:
        """Headline numbers plus the full CommMeter ledger; the
        normalized cost is computed against a ``fedavg_rounds``-round
        full-participation FedAvg baseline (paper default: 30): Eq. 4 for
        FedX runs, recorded uplink over the baseline's for FedAvg."""
        meter = self.server.meter
        if self.server.strategy.is_fedx:
            cost = normalized_cost(meter, t_avg=fedavg_rounds)
        else:
            cost = meter.total_uplink / max(1, fedavg_total(
                fedavg_rounds, 1.0, meter.n_clients, meter.model_bytes))
        return {
            "strategy": self.cfg.strategy,
            "task": self.cfg.task,
            "partition": self.cfg.partition,
            "engine": self.server.engine,
            "rounds_per_dispatch": self.server.rounds_per_dispatch,
            "pipeline_blocks": self.server.pipeline_blocks,
            "device": str(self.server.device),
            "bwo_kernel": self.cfg.bwo_kernel,
            "rounds": len(self.logs),
            "final_acc": self.logs[-1].test_acc,
            "final_loss": self.logs[-1].test_loss,
            "comm": meter.summary(),
            "block_timing": meter.timing_summary(),
            f"normalized_cost_vs_fedavg{fedavg_rounds}": cost,
        }
