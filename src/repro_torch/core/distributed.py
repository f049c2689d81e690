"""Distributed FL rounds as collective schedules across processes.

This is the paper's insight as a distributed program: clients map to the
ranks of the ``clients`` (or ``pod``) axis of a ``DeviceMesh``, one
process each, local training runs with **zero collectives**, and the
per-round cross-rank traffic is

  FedX:   all_gather of one fp32 score per client  (N x 4 bytes)
          + one broadcast of the winner's weights from its rank (M bytes)
  FedAvg: a full-model all-reduce every round (M bytes * N)

JAX has no broadcast from a source chosen at run time, so the reference
fetches the winner with ``psum(where(my_id == winner, w, 0))``, physically
an all-reduce of M bytes.  ``torch.distributed.broadcast`` takes its
source at run time, so here the M bytes leave the winner's rank once: the
paper's single model transfer, with the same values.  The round reads the
winner's index on the host to name that source (the reference keeps it on
the device).

The round builders themselves live in :mod:`repro_torch.core.engine`; the
processes come from :func:`repro_torch.launch.mesh.run_ranks` and the
mesh from :func:`repro_torch.launch.mesh.make_host_mesh`.
"""
from __future__ import annotations

from repro_torch.core.client import ClientHP, Task
from repro_torch.core.engine import (make_sharded_fedavg_round,
                                     make_sharded_fedx_round)
from repro_torch.metaheuristics import Metaheuristic


def make_fedx_round(task: Task, hp: ClientHP, mh: Metaheuristic,
                    mesh, axis: str = "clients"):
    """Returns ``round_fn(global_params, client_data, rng_keys) ->
    (new_global_params, scores)``, called by every rank of ``axis``.

    client_data: this rank's shard, a tree with a leading dim of 1.
    rng_keys:    this rank's (1, 2) key.
    """
    return make_sharded_fedx_round(task, hp, mh, mesh, axis)


def make_fedavg_round(task: Task, hp: ClientHP, mesh,
                      axis: str = "clients"):
    """Synchronous FedAvg: every round all-reduces the full model."""
    return make_sharded_fedavg_round(task, hp, mesh, axis)
