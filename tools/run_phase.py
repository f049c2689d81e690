#!/usr/bin/env python3
"""One timed phase of the ``chip_smoke.py`` of a tree, alone, so that two
trees (this one and a parent unpacked by ``git archive`` into a directory
that ``.gitignore`` lists) can be compared on one card in one run.

    python3 tools/run_phase.py 10 [TREE]      # ssm_scan (phase 10)
    python3 tools/run_phase.py 7 [TREE]       # flash_attention (phase 7)
    python3 tools/run_phase.py seq [TREE]     # sequential FL rounds
    python3 tools/run_phase.py 3b             # gradient against float64
    python3 tools/run_phase.py 4c [TREE]      # fused rounds, CUDA graphs
    python3 tools/run_phase.py 20 [TREE]      # a train step (or 19)
    python3 tools/run_phase.py 17 [TREE]      # flash_attention's backward
    python3 tools/run_phase.py 18 [TREE]      # ssm_scan's backward
    python3 tools/run_phase.py 22 [TREE]      # a phase of 22-27 (or several:
                                              # 24,25)
    python3 tools/run_phase.py 28 [TREE]      # a phase of 28-32 (or several)
    python3 tools/run_phase.py 33 [TREE]      # the mesh schedules, 10 ranks
    python3 tools/run_phase.py 34 [TREE]      # flcheck on the card
    python3 tools/run_phase.py 35 [TREE]      # the dry run, the cost model

TREE defaults to this checkout.  The phase builds and loads the tree's own
kernels (its ``build/kernels``) and prints what that tree's phase prints,
then a JSON line of its times by shape.  Run each tree in its own process:
the two trees' packages share a name.

``seq`` needs nothing of the tree's ``chip_smoke.py`` but its path setup:
it runs ``FLConfig(bwo_kernel=True, device="cuda", engine="sequential")``
through ``build_experiment`` for 4 rounds (the first warms up) and times
one client's local SGD (2 epochs of 10 steps), so a tree from before the
batched engine can be compared.  ``3b`` runs this tree's phase 3b under
cuDNN's settings in turn (as set, ``benchmark``, ``deterministic``,
disabled) and with TF32 allowed, which its limit must refuse.  ``4c``
runs the tree's phase 4c: 10 full-width FedBWO rounds as two pipelined
blocks of 5, each one CUDA graph replay, against 5 eager rounds from the
same start, with the capture time, the amortized round, the peak memory,
both drivers' sync fractions and the card's busy share (trees from this
one on).  ``19`` and ``20`` run the tree's training phase (OLMo-1B, or
8-layer Jamba without experts): steps, launches, the step's parts, and
the gradients through the kernels against the plain versions; run twice
in two processes, they show whether a train step reproduces.  ``17`` and
``18`` run the tree's backward-kernel phases: each checked against its
plain version, then timed at the train shapes (flash on its route, with
SDPA's backward beside it), so a parent's backward kernels and this
tree's can be timed in one call (trees whose ``chip_smoke.py`` has them).
``22`` to ``27`` (comma-separated for several) run those phases of the
tree's ``chip_smoke.py`` (trees from the one that added them on):
flash's forward at Whisper-medium's and LLaVA-NeXT's shapes, its backward
where queries and keys differ in number, serving and training
Whisper-medium, serving LLaVA-NeXT, and the int8 KV cache at OLMo-1B.
``28`` to ``32`` likewise: serving xLSTM-1.3B (and its decode against the
full forward), training it at 12 layers, the continuous-batching server
at OLMo-1B and at 8-layer Jamba without experts (each with the kernels at
its shapes), and training LLaVA-NeXT at 8 layers.  ``33`` runs the
mesh schedules: 3 FedBWO rounds on 10 gloo ranks sharing the card, held
to the sequential and batched engines, and one FedAvg round.  ``34``
runs flcheck on the card: the strict audit of the FL main path at full
width (its block's CUDA graph read), its rounds against an unaudited
build's, FedAvg's audit and two planted faults.  ``35`` runs the dry
run at full width (four host-only subprocesses) and the cost model of
OLMo-1B's train step recorded on the card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> int:
    phase = sys.argv[1] if len(sys.argv) > 1 else ""
    slice_phases = set(phase.split(",")) <= {"22", "23", "24", "25", "26",
                                             "27"}
    new_paths = set(phase.split(",")) <= {"28", "29", "30", "31", "32"}
    if phase not in ("7", "10", "seq", "3b", "4c", "17", "18", "19",
                     "20", "33", "34", "35") and not slice_phases \
            and not new_paths:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(sys.argv[2] if len(sys.argv) > 2
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs     # puts the tree's src first on sys.path
    import torch
    if not torch.cuda.is_available():
        print("run_phase: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(f"tree {tree}: {cs.__file__}")
    mem, f32, bf16, exp = cs.card_rates(torch.cuda.get_device_name(0))
    if phase == "10":
        _, times = cs.ssm_phase(torch, mem, f32, exp)
    elif phase == "7":
        _, times = cs.flash_phase(torch, mem, bf16)
    elif phase == "seq":
        times = sequential_rounds(torch)
    elif phase == "17":
        times = cs.flash_bwd_phase(torch, mem, bf16)["shapes"]
    elif phase == "18":
        times = cs.ssm_bwd_phase(torch, mem, f32, exp)["shapes"]
    elif phase in ("19", "20"):
        from repro_torch.kernels.bwo_evolve import bwo_evolve
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_bwd)
        from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
        _, times = cs.train_phase(
            torch, (bwo_evolve, flash_attention, ssm_scan,
                    flash_attention_bwd, ssm_scan_bwd),
            *cs.train_cells()[phase])
    elif slice_phases or new_paths:
        import subprocess
        import time
        from repro_torch.kernels.bwo_evolve import bwo_evolve
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_bwd)
        from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi)
        counters = (bwo_evolve, flash_attention, ssm_scan,
                    flash_attention_bwd, ssm_scan_bwd)
        if slice_phases:
            out = cs.slice_phases(torch, counters, mem, bf16, smi,
                                  time.perf_counter(),
                                  only=set(phase.split(",")))
        else:
            out = cs.new_paths_phases(torch, counters, (mem, f32, bf16, exp),
                                      smi, time.perf_counter(),
                                      only=set(phase.split(",")))
        times = {k: v.get("shapes", v) if isinstance(v, dict) else v[-1]
                 for k, v in out.items()}
    elif phase == "33":
        times = cs.mesh_phase(torch)
    elif phase == "34":
        import subprocess
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi)
        times = cs.audit_phase(torch, smi)
    elif phase == "35":
        from repro_torch.kernels.bwo_evolve import bwo_evolve
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_bwd)
        from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
        times = cs.dryrun_phase(torch, (bwo_evolve, flash_attention, ssm_scan,
                                        flash_attention_bwd, ssm_scan_bwd))[1]
    elif phase == "4c":
        from repro_torch.kernels.bwo_evolve import bwo_evolve
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.ssm_scan import ssm_scan
        times = cs.fused_phase(torch, (bwo_evolve, flash_attention,
                                       ssm_scan))
    else:
        times = grad_variants(torch, cs)
    print(json.dumps({"tree": str(tree), "phase": phase, "ms": times}))
    return 0


def sequential_rounds(torch):
    """Round times (ms) of the sequential engine at full width, and one
    client's local SGD."""
    import time
    from repro_torch import random
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.core.client import ClientHP, make_local_sgd
    from repro_torch.data import synthetic
    cfg = FLConfig(strategy="fedbwo", task="cnn", bwo_kernel=True,
                   device="cuda", max_rounds=4, tau=1.01,
                   engine="sequential")
    exp = build_experiment(cfg)
    rounds = []
    for _ in range(cfg.max_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.server.run_round()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) * 1e3)
    print(f"  sequential rounds (ms; the first warms up): {rounds}")
    task = synthetic.cnn_task()
    data = exp.server.client_data[0]
    params = exp.server.global_params
    sgd = make_local_sgd(task, ClientHP(local_epochs=2))
    key = random.PRNGKey(5, torch.device("cuda"))
    sgd(params, data, key)
    sgd_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd(params, data, key)
        torch.cuda.synchronize()
        sgd_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  one client's local SGD, 20 steps (ms): {sgd_ms}")
    return {"rounds": rounds, "local_sgd": sgd_ms}


def grad_variants(torch, cs):
    """Phase 3b's largest errors under each cuDNN setting and with TF32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    variants = {"as set": {}, "cudnn.benchmark": {"benchmark": True},
                "cudnn.deterministic": {"deterministic": True},
                "cuDNN disabled": {"enabled": False},
                "TF32 allowed (must fail the limit)": {"allow_tf32": True}}
    out = {}
    for label, flags in variants.items():
        saved = {k: getattr(cudnn, k) for k in flags}
        saved_mm = matmul.allow_tf32
        try:
            for k, v in flags.items():
                setattr(cudnn, k, v)
            matmul.allow_tf32 = bool(flags.get("allow_tf32", saved_mm))
            print(f"-- {label}: cudnn enabled {cudnn.enabled}, benchmark "
                  f"{cudnn.benchmark}, deterministic {cudnn.deterministic}, "
                  f"allow_tf32 {cudnn.allow_tf32}, matmul allow_tf32 "
                  f"{matmul.allow_tf32}")
            r = cs.grad_phase(torch, strict=False)
            out[label] = {how: {
                "flips": r[how]["flips"],
                "max_op_rel_err": max(r[how]["op_rel_err"].values()),
                "max_leaf_rel_err": max(r[how]["leaf_rel_err"].values()),
                "max_leaf_rel_err_free": max(
                    r[how]["leaf_rel_err_free"].values())}
                for how in ("vmap", "loop")}
            print(f"   {json.dumps(out[label])}")
        finally:
            for k, v in saved.items():
                setattr(cudnn, k, v)
            matmul.allow_tf32 = saved_mm
    return out


if __name__ == "__main__":
    sys.exit(main())
