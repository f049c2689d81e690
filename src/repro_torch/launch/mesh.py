"""Mesh construction, and the launcher that starts one process per rank.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  2 pods = 512 ranks as (pod=2, data=16, model=16); the ``pod``
axis is the federation axis in FedX mode (params replicated per pod,
cross-pod traffic = scores + winner weights).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over an
initialised process group, one process per rank.  JAX builds a host mesh
inside one process by forcing the host's device count; PyTorch needs a
process per rank, so :func:`run_ranks` starts them: ``n`` processes by
``spawn`` (the caller may hold a CUDA context, which ``fork`` would
copy), a rendezvous through a ``FileStore`` in a temporary directory (no
TCP port to find), and each rank's result or traceback sent back to the
caller.  The backend is the caller's: ``gloo`` by default, the one
backend under which several ranks share one card; ``nccl`` wants a card
per rank.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")


def _mesh(device_type: str, shape: Sequence[int], names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(
            f"a {tuple(shape)} mesh over {tuple(names)} needs an initialised "
            f"world of {need} ranks (have {have}): start them with "
            f"run_ranks({need}, ...) or torch.distributed.init_process_group")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" in front;
    needs an initialised world of 256 or 512 ranks."""
    shape = ((2,) if multi_pod else ()) + PRODUCTION_SHAPE
    names = (("pod",) if multi_pod else ()) + PRODUCTION_AXES
    return _mesh(device_type, shape, names)


def make_host_mesh(n: int, axis: str = "clients", device_type: str = "cuda"):
    """A 1-D mesh of ``n`` ranks over the initialised world of ``n``: one
    FL client per rank.  Under gloo every rank may sit on one card."""
    return _mesh(device_type, (n,), (axis,))


def _rank_main(rank: int, n: int, tmp: str, backend: str,
               timeout_s: float, results) -> None:
    try:
        with open(os.path.join(tmp, "payload"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
            rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:
        # sent before the group closes, so the caller reads this rank's
        # traceback ahead of the errors the closing causes in the others
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised, or the ranks did not all finish within the time."""


def run_ranks(n: int, fn: Callable[..., Any], *args, backend: str = "gloo",
              timeout: float = 300.0) -> List[Any]:
    """Start ``n`` processes, each calling ``fn(rank, *args)`` inside an
    initialised process group of ``n`` ranks, and return their results by
    rank.  ``fn`` is sent by its import path and ``args`` and the results
    are pickled, so hand CPU tensors across (each rank moves its own to its
    device).  ``timeout`` (seconds) bounds the process group's collectives
    and the whole run: a rank that raises, or a run that outlasts it,
    stops every rank and raises :class:`RankError` here, with the first
    failing rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        # the work goes by a file: a process's arguments go down a pipe
        # that a child which fails early stops reading
        with open(os.path.join(tmp, "payload"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, tmp, backend, timeout, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n and failure is None:
                try:
                    rank, ok, body = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that raised sent its traceback before exiting;
                    # one that died sent nothing
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0][0]} of {n} exited with "
                                   f"code {dead[0][1]} and no result")
                    elif time.monotonic() > deadline:
                        missing = sorted(set(range(n)) - set(out))
                        failure = (f"ranks {missing} of {n} did not finish "
                                   f"within {timeout} s")
                    continue
                if ok:
                    out[rank] = pickle.loads(body)
                else:
                    failure = f"rank {rank} of {n} raised:\n{body}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        if failure is not None:
            raise RankError(failure)
    return [out[r] for r in range(n)]
