"""Multi-pod dry run: one recorded run of every (architecture x input-shape)
step on the production mesh, with the per-device cost, memory and
collectives for the roofline.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--fedx]

Each run writes results/dryrun/<arch>__<shape>__<mesh>.json (resumable:
existing files are skipped unless --force); a combination that raises
leaves ``<file>.FAILED`` with the error, and the command exits 1.

The reference lowers and compiles each step for 256 or 512 host devices.
Here the step runs once in this one process, over a world of 256 or 512
ranks that a fake process group stands up (torch's ``FakeStore``; this
process is rank 0): parameters, optimizer state, caches and batch are
``DTensor``s whose local shards are fake tensors (``FakeTensorMode``:
shapes and dtypes, no storage, so no full-width tensor is ever made),
placed by ``repro_torch.sharding.rules``; the step runs under
``implicit_replication()`` and ``mesh_context(mesh)``, recorded by the op
recorder (``analysis.walker``), which sees rank 0's local ops and the
collectives ``DTensor`` issues; ``graph_analysis.analyze`` counts them per
device and ``analysis.roofline`` sets them against the H100's rates.  An op
``DTensor`` has no rule for raises: nothing falls back.

Host-only by design, as the reference's (which forces the host platform):
a fake world has no card, and no kernel runs -- a kernel call is one
operator whose fake form gives its result's shape.  So there is no
``--device``.

The JSON keys are the reference's.  Where torch has no counterpart the key
holds ``null``: ``compile_s`` (nothing is compiled; ``lower_s`` is the
recorded run's seconds), ``memory.temp_bytes_per_device`` and
``generated_code_bytes`` (no compiler), ``cost.xla_bytes_uncorrected``.
``cost.xla_flops_uncorrected`` is ``FlopCounterMode``'s count of the
step's global ops divided by the chips.  ``memory.argument_bytes_per_device``
and ``output_bytes_per_device`` sum rank 0's local shards of the step's
arguments and results.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import random, tree
from repro_torch.analysis.walker import record_ops, tensors
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, get_shape
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.analysis import model_flops, roofline
from repro_torch.launch.graph_analysis import analyze
from repro_torch.launch.mesh import PRODUCTION_AXES, PRODUCTION_SHAPE
from repro_torch.launch.steps import (input_specs, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.transformer import build_model
from repro_torch.sharding import mesh_context, rules

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")


# ---------------------------------------------------------------- world --
def fake_world(n: int) -> None:
    """A world of ``n`` ranks in this process (rank 0), through a fake
    process group; a world of another size is destroyed first."""
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], names: Sequence[str]):
    """A CPU ``DeviceMesh`` of ``shape`` over a fake world of its size, with
    a flattened mesh for each set of two or more of its dims: ``DTensor``
    then reduces a sum pending over several dims (a replicated weight's
    gradient, partial over (data, model)) by one collective over their
    joint group, as XLA does, not by one a dim."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    for r in range(2, len(names) + 1):
        for dims in itertools.combinations(names, r):
            mesh[dims]._flatten("_".join(dims))
    return mesh


def production_mesh(multi_pod: bool, mesh_shape: Optional[tuple] = None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" in front;
    ``mesh_shape`` gives other sizes (2 or 3 axes) for small checks."""
    shape = mesh_shape or (((2,) if multi_pod else ()) + PRODUCTION_SHAPE)
    names = (("pod",) if len(shape) == 3 else ()) + PRODUCTION_AXES
    return make_mesh(shape, names)


# --------------------------------------------------------------- shards --
def _local_shape(shape, place, mesh) -> tuple:
    local = list(shape)
    for i, pl in enumerate(place):
        if pl.is_shard():
            if local[pl.dim] % mesh.size(i):
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over mesh dim {i} ({mesh.size(i)})")
            local[pl.dim] //= mesh.size(i)
    return tuple(local)


def sharded(meta_tree, mesh, place_tree) -> Any:
    """A tree of meta tensors as ``DTensor``s of empty local shards with the
    placements of ``place_tree`` (call under ``FakeTensorMode``: the shards
    are fake)."""
    from torch.distributed.tensor import DTensor

    def one(t, place):
        local = torch.empty(_local_shape(t.shape, place, mesh),
                            dtype=t.dtype)
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree.map(one, meta_tree, place_tree)


def local_bytes(obj) -> int:
    """Bytes of this rank's shards of every tensor in ``obj``."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tensors(obj):
        t = t.to_local() if isinstance(t, DTensor) else t
        n += t.numel() * t.element_size()
    return n


def _placed(mesh, meta_tree, rule):
    return sharded(meta_tree, mesh, rules.tree_shardings(mesh, meta_tree,
                                                         rule))


@contextlib.contextmanager
def _recording_context(mesh, batch_axes_override=None):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode(), implicit_replication(), \
            mesh_context(mesh, batch_axes_override):
        yield


def _run(fn):
    """Run ``fn()`` once, recorded with every op's operands (and counted by
    ``FlopCounterMode``); returns (recording, result, seconds, global
    FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter:
        rec, out = record_ops(fn, detail=True)
    return rec, out, time.perf_counter() - t0, counter.get_total_flops()


# ---------------------------------------------------------------- combos --
def lower_combo(arch_name: str, shape_name: str, *, multi_pod: bool = False,
                kv_int8: bool = False, cfg: Optional[ArchConfig] = None,
                shape: Optional[InputShape] = None,
                mesh_shape: Optional[tuple] = None) -> dict:
    """One recorded run of the step of ``shape_name``'s mode.  ``cfg``,
    ``shape`` and ``mesh_shape`` replace the named arch, the named input
    shape and the production mesh (the CPU tests' reduced runs; three axes
    are (pod, data, model)).  With a ``pod`` axis, collectives over ranks
    of more than one pod count as cross-pod traffic."""
    cfg = cfg or get_arch(arch_name)
    shape = shape or get_shape(shape_name)
    mesh = production_mesh(multi_pod, mesh_shape)
    chips = mesh.size()
    B, S = shape.global_batch, shape.seq_len
    window = (cfg.sliding_window
              if (shape_name == "long_500k"
                  and cfg.long_context == "sliding_window") else None)
    max_seq = S + (cfg.vision_tokens if shape.mode != "decode" else 0)
    model = build_model(cfg, max_seq=max_seq)
    # the trees' shapes on the meta device, drawn from nothing
    meta_key = random.PRNGKey(0, "meta")
    specs = input_specs(cfg, shape)
    if shape.mode == "train":
        train_step, init_state = make_train_step(model)
        state_meta = init_state(meta_key)
    else:
        params_meta = model.init(meta_key)

    with _recording_context(mesh):
        batch = _placed(mesh, specs, rules.batch_spec)
        if shape.mode == "train":
            state = sharded(state_meta, mesh,
                            rules.state_shardings(mesh, state_meta))
            args = (state, batch)
            rec, out, run_s, gflops = _run(lambda: train_step(state, batch))
        elif shape.mode == "prefill":
            params = _placed(mesh, params_meta, rules.param_spec)
            prefill = make_prefill_step(
                model, max_len=max_seq,
                cache_init=lambda b, n, device: _placed(
                    mesh, model.cache_init(b, n, device="meta"),
                    rules.cache_spec))
            args = (params, batch)
            rec, out, run_s, gflops = _run(lambda: prefill(params, batch))
        else:  # decode: one new token against a full cache
            params = _placed(mesh, params_meta, rules.param_spec)
            cache = _placed(mesh, model.cache_init(B, S, quantized=kv_int8,
                                                   device="meta"),
                            rules.cache_spec)
            tok, pos = batch["tokens"], S - 1
            step = make_serve_step(model, window=window)
            # the position is an argument where the step reads it: jit drops
            # an unread one (keep_unused=False), as for xLSTM's recurrences
            args = (params, tok, cache) + (
                (torch.zeros((), dtype=torch.int32),)
                if _reads_position(cfg) else ())
            rec, out, run_s, gflops = _run(
                lambda: step(params, tok, cache, pos))
        arg_bytes, out_bytes = local_bytes(args), local_bytes(out)

    pods = mesh.size(0) if "pod" in mesh.mesh_dim_names else 0
    hc = analyze(rec, chips, pod_size=chips // pods if pods else None)
    flops_per_dev = hc.dot_flops
    bytes_per_dev = hc.hbm_bytes
    coll_per_chip = hc.collective_link_bytes
    rf = roofline(flops_per_dev, bytes_per_dev, coll_per_chip, 1)

    n_params = cfg.num_params()
    n_active = cfg.num_active_params()
    tokens = B * (S if shape.mode in ("train", "prefill") else 1)
    mflops = model_flops(n_active, tokens,
                         "train" if shape.mode == "train" else "fwd")
    return {
        "arch": arch_name, "shape": shape_name,
        "mesh": _mesh_tag(mesh),
        "kv_int8": kv_int8,
        "chips": chips, "mode": shape.mode,
        "seq_len": S, "global_batch": B,
        "window": window,
        "lower_s": round(run_s, 2), "compile_s": None,
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": None,
            "generated_code_bytes": None,
        },
        "cost": {
            "flops_per_device": flops_per_dev,
            "hbm_bytes_per_device": bytes_per_dev,
            "xla_flops_uncorrected": gflops / chips,
            "xla_bytes_uncorrected": None,
            "n_dots": hc.n_dots, "n_collectives": hc.n_collectives,
            "analysis_flags": hc.flagged,
            "host_transfers": hc.host_transfers,
            "n_host_transfers": hc.n_host_transfers,
            "kernels": hc.kernels,
        },
        "collectives": {"link_bytes_per_chip": coll_per_chip,
                        "cross_pod_link_bytes": hc.cross_pod_link_bytes,
                        "by_kind": hc.collectives_by_kind,
                        "top": hc.top_collectives},
        "top_dots": hc.top_dots,
        "roofline": rf,
        "model": {"params": n_params, "active_params": n_active,
                  "model_flops_global": mflops,
                  "model_flops_per_device": mflops / chips,
                  "useful_flops_ratio":
                      (mflops / chips) / flops_per_dev if flops_per_dev
                      else None},
    }


def _reads_position(cfg: ArchConfig) -> bool:
    """Whether a decode step reads its cache position: attention writes its
    KV cache there (and RoPE or learned positions read it); recurrent
    layers (Mamba, xLSTM) carry their state and read none."""
    return "attn" in cfg.block_pattern or cfg.pos_emb == "learned"


def _mesh_tag(mesh) -> str:
    return "pod" + "x".join(str(s) for s in mesh.shape)


def lower_fedx_round(arch_name: str, local_steps: int = 8, *,
                     cfg: Optional[ArchConfig] = None,
                     shape: Optional[InputShape] = None,
                     mesh_shape: Optional[tuple] = None) -> dict:
    """The paper's technique at pod scale: each pod is a federation client
    holding a replica of the model.  Each pod runs ``local_steps`` AdamW
    steps on its half of the batch with ZERO cross-pod collectives (its
    state lives on its own (data, model) sub-mesh), uploads one fp32 score
    (an all-gather over ``pod``), and the winner's weights are fetched
    once (Alg. 3): each rank broadcasts its shard over ``pod``.  The
    winner is data: a fake run cannot read it, and the broadcast's cost is
    the same from any pod, so pod 0 sends.

    Compare ``cross_pod_link_bytes`` against the synchronous baseline
    (``train_4k`` on the same mesh) -- that is Fig. 6 at pod scale."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    cfg = cfg or get_arch(arch_name)
    shape = shape or get_shape("train_4k")
    mesh = production_mesh(True, mesh_shape)
    chips = mesh.size()
    n_pods = mesh.size(0)
    pod_mesh = mesh["data", "model"]
    pod_group = mesh.get_group("pod")
    model = build_model(cfg, max_seq=shape.seq_len)
    train_step, init_state = make_train_step(model)
    micro_shape = InputShape(shape.name, shape.seq_len,
                             shape.global_batch // n_pods // local_steps,
                             "train")

    state_meta = init_state(random.PRNGKey(0, "meta"))
    specs = input_specs(cfg, micro_shape)
    with _recording_context(pod_mesh, batch_axes_override=("data",)):
        state = sharded(state_meta, pod_mesh,
                        rules.state_shardings(pod_mesh, state_meta))
        micro = [_placed(pod_mesh, specs, rules.batch_spec)
                 for _ in range(local_steps)]

        def fed_round(state):
            for batch in micro:                 # one pod's local steps
                state, metrics = train_step(state, batch)
            score = metrics["loss"].to_local().reshape(1)
            scores = funcol.all_gather_tensor(score, 0, pod_group)
            winner = torch.argmin(scores)       # GetBestModel
            for p in tree.leaves(state["params"]):
                funcol.broadcast(p.to_local() if isinstance(p, DTensor)
                                 else p, 0, pod_group)
            return state, scores, winner

        rec, _, run_s, _ = _run(lambda: fed_round(state))

    hc = analyze(rec, chips, pod_size=chips // n_pods)
    rf = roofline(hc.dot_flops, hc.hbm_bytes, hc.collective_link_bytes, 1)
    return {
        "arch": arch_name, "shape": shape.name, "mesh": _mesh_tag(mesh),
        "mode": f"fedx_round(local_steps={local_steps})",
        "compile_s": None, "lower_s": round(run_s, 2),
        "cost": {"flops_per_device": hc.dot_flops,
                 "hbm_bytes_per_device": hc.hbm_bytes,
                 "host_transfers": hc.host_transfers,
                 "n_host_transfers": hc.n_host_transfers},
        "collectives": {"link_bytes_per_chip": hc.collective_link_bytes,
                        "cross_pod_link_bytes": hc.cross_pod_link_bytes,
                        "by_kind": hc.collectives_by_kind,
                        "top": hc.top_collectives},
        "roofline": rf,
    }


def run_one(arch: str, shape: str, multi_pod: bool, force: bool,
            out_dir: str, kv_int8: bool = False) -> bool:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{shape}_kvint8" if kv_int8 else shape
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{arch}__{tag}__{mesh_tag}.json")
    if os.path.exists(out) and not force:
        print(f"SKIP (exists) {arch} {tag} {mesh_tag}")
        return True
    print(f"=== dry-run {arch} x {tag} on {mesh_tag} ===", flush=True)
    try:
        res = lower_combo(arch, shape, multi_pod=multi_pod, kv_int8=kv_int8)
    except Exception as e:
        traceback.print_exc()
        if os.path.exists(out):
            os.remove(out)          # never leave a stale artifact behind
        with open(out + ".FAILED", "w") as f:
            f.write(f"{type(e).__name__}: {e}\n")
        return False
    if os.path.exists(out + ".FAILED"):
        os.remove(out + ".FAILED")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    r = res["roofline"]
    print(f"  run={res['lower_s']}s "
          f"flops/dev={res['cost']['flops_per_device']:.3e} "
          f"dominant={r['dominant']} bound={r['bound_s'] * 1e3:.3f}ms "
          f"coll_bytes/chip={res['collectives']['link_bytes_per_chip']:.3e}",
          flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fedx", action="store_true",
                    help="run the FedX cross-pod round for --arch")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache (decode shapes)")
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    try:
        if args.fedx:
            if not args.arch:
                ap.error("--fedx requires --arch")
            os.makedirs(args.out, exist_ok=True)
            out = os.path.join(args.out,
                               f"{args.arch}__fedx_round__pod2x16x16.json")
            try:
                res = lower_fedx_round(args.arch,
                                       local_steps=args.local_steps)
            except Exception as e:
                traceback.print_exc()
                with open(out + ".FAILED", "w") as f:
                    f.write(f"{type(e).__name__}: {e}\n")
                return 1
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
            print(f"fedx round: run={res['lower_s']}s cross_pod_bytes="
                  f"{res['collectives']['cross_pod_link_bytes']:.3e} "
                  f"total_coll={res['collectives']['link_bytes_per_chip']:.3e}")
            return 0

        archs = list(ARCHS) if (args.all or args.arch is None) \
            else [args.arch]
        shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
            else [args.shape]
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        ok = True
        for a in archs:
            for s in shapes:
                for mp in meshes:
                    ok &= run_one(a, s, mp, args.force, args.out,
                                  kv_int8=args.kv_int8)
        return 0 if ok else 1
    finally:
        close_world()


if __name__ == "__main__":
    sys.exit(main())
