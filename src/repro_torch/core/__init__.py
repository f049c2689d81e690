"""The FedBWO protocol in PyTorch: score-only uplink + best-client weight
fetch (FedX), and the FedAvg baseline.

``FLConfig`` -> ``build_experiment()`` -> ``run()`` (repro_torch.core.api)
is the one construction path for experiments; ``Server`` and
``make_client_update`` remain directly usable.
"""
from repro_torch.core.client import ClientHP, Task, make_client_update
from repro_torch.core.comm import (BlockTiming, CommMeter, fedavg_total,
                                   fedx_total, normalized_cost, SCORE_BYTES)
from repro_torch.core.protocol import RoundLog, StopConditions, run_federated
from repro_torch.core.server import Server, Strategy, get_strategy
from repro_torch.core.api import (Experiment, ExperimentResult, FLConfig,
                                  build_experiment)

__all__ = ["ClientHP", "Task", "make_client_update", "BlockTiming",
           "CommMeter", "fedavg_total", "fedx_total", "normalized_cost",
           "SCORE_BYTES", "RoundLog", "StopConditions", "run_federated",
           "Server", "Strategy", "get_strategy", "Experiment",
           "ExperimentResult", "FLConfig", "build_experiment"]
