#!/usr/bin/env python3
"""What the tensor-core ``flash_attention`` backward's time follows: copies
of its source with one part taken out or changed, timed beside the kernel
on one NVIDIA GPU.

    python3 tools/flash_attention_bwd_ablation.py

Each copy of ``src/repro_torch/csrc/flash_attention_bwd_hopper.cu`` is made
by a text edit (every occurrence of the text) and built with the kernels'
own flags, all in parallel, and launched through the wrapper
(``flash_attention_bwd_cuda`` on the tensor-core route).  The copies that
take work out ("dq kernel alone", "dk/dv kernel alone", "no lse pass")
compute wrong results and are timed, never checked; the kernel and the
copies that keep its arithmetic (``CHECKED``) are checked against the
plain version first.  Every copy is timed at OLMo-1B's and Jamba's train
shapes as ``chip_smoke.py`` phase 17 times the kernel (a 256 MB write
flush and a ~1 ms device spin before each launch), in two rounds, forward
and backward.  The script prints the card's name and power limit, each
copy's registers and spills (ptxas), one line a copy and shape, and a JSON
line of the two rounds' times.  An edit that no longer finds its text
stops the script before anything is built: a diagnostic, it follows the
kernel and does not hold it.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# copy -> (what it shows, [(text in the source, its replacement), ...])
EDITS = {
    "kernel": ("the kernel as it is", []),
    "dq kernel alone": (
        "the dk/dv kernel returns at once: the dq kernel's time (its lse "
        "pass included)",
        [("  using L = KvSmem<HD>;",
          "  if (p.Sq > 0) return;\n  using L = KvSmem<HD>;")]),
    "dk/dv kernel alone": (
        "the dq kernel returns at once: the dk/dv kernel's time",
        [("  using L = DqSmem<HD>;",
          "  if (p.Sq > 0) return;\n  using L = DqSmem<HD>;")]),
    "no lse pass": (
        "the dq kernel's first pass (Q K^T and dO V^T for the rows' "
        "log-sum-exp and D) left out: two products in 9",
        [("for (int it = 0; it < 2 * n_tiles; ++it) {",
          "for (int it = 0; it < n_tiles; ++it) {"),
         ("  int it = 0;\n  for (int t = 0; t < n_tiles; ++t, ++it) {",
          "  int it = 0;\n  for (int t = 0; t < 0; ++t, ++it) {")]),
    "producer 40 registers": (
        "setmaxnreg 40 for the producer and 232 for the consumers, not 24 "
        "and 240",
        [("setmaxnreg.dec.sync.aligned.u32 24;",
          "setmaxnreg.dec.sync.aligned.u32 40;"),
         ("setmaxnreg.inc.sync.aligned.u32 240;",
          "setmaxnreg.inc.sync.aligned.u32 232;")]),
    "no remainders": (
        "P and dS through the gradient products as bf16 alone, as "
        "FlashAttention-2 and -3 do: the remainders' products left out",
        [("      issue_grad<HD>(dq, dl, k_addr);           // the remainder's "
          "share", ""),
         ("        issue_grad<HD>(acc, al, b_addr);        // the remainder's "
          "share", "")]),
    "3 stages": (
        "a ring of 3 stages, not 2 (the streamed tiles)",
        [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
}
CHECKED = ("kernel", "no remainders", "producer 40 registers", "3 stages")


def build_all(nvcc, source):
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (_, edits)) in enumerate(EDITS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        paths[name] = out / f"flash_attention_bwd_ablation_{i}.cu"
        paths[name].write_text(text)

    def build(path):
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(Path(tmp) / "lib.so"), str(path)],
                capture_output=True, text=True)
        return nvcc.build(path), proc.stderr

    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(build, paths.values())))
    for name, (_, log) in built.items():
        kernel = None
        for line in log.splitlines():
            m = re.search(r"fa_bwd_(dq|dkdv)_kernelILi(\d+)E", line)
            if m and "serialized" in line:
                print(f"ptxas, {name}: wgmma serialised in {m[1]} hd {m[2]}")
            elif m and "Compiling entry" in line:
                kernel = f"{m[1]} hd {m[2]}"
            elif kernel and "hd 128" in kernel and "spill" in line:
                print(f"ptxas, {name}, {kernel}: {line.strip()}")
    return {name: lib for name, (lib, _) in built.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_bwd_ablation: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd as fb, ref)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    libs = build_all(nvcc, fb.HOPPER_SOURCE.read_text())
    loaded = {}
    for name, lib in libs.items():
        fb._lib = {}
        fb.build = lambda source, lib=lib: lib
        loaded[name] = fb._load("tensor_core")

    def run(name, q, k, v, do, kw):
        fb._lib = {"tensor_core": loaded[name]}
        return fb.flash_attention_bwd_cuda(q, k, v, do, **kw)

    gen = torch.Generator(device="cuda").manual_seed(17)

    def inputs(B, Sq, Sk, H, KV, hd, causal, window):
        q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen)
        k, v = (torch.randn(B, Sk, KV, hd, device="cuda", generator=gen)
                for _ in range(2))
        do = torch.randn(B, Sq, H, hd, device="cuda", generator=gen)
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        kw = dict(causal=causal, window=window)
        return q, k, v, do, kw

    tol = cs.FA_BWD_TOL[cs.BF16]
    for shape in ((2, 300, 300, 8, 2, 128, True, 100),
                  (3, 77, 77, 8, 2, 64, False, 32)):
        q, k, v, do, kw = inputs(*shape)
        lse = ref.flash_attention_lse_ref(q, k, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)
        for name in CHECKED:
            errs = [cs.rel_to_largest(g, w)
                    for g, w in zip(run(name, q, k, v, do, kw), want)]
            print(f"  {name} at {shape}: dq, dk, dv errors "
                  f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.3g})")
            cs.check(all(e <= tol for e in errs),
                     f"{name} disagrees with the plain version at {shape}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rounds = {}
    for label, shape in cs.FA_BWD_TIMED:
        args = inputs(*shape)
        got = {}
        for order in (list(EDITS), list(EDITS)[::-1]):
            for name in order:
                got.setdefault(name, []).append(cs.time_ms(
                    torch, lambda: run(name, *args), flush=flush.zero_,
                    spin=True))
        for name, ms in got.items():
            print(f"{label} {name}: " + " / ".join(f"{t:.4f}" for t in ms)
                  + f" ms  ({EDITS[name][0]})")
            rounds[f"{label} {name}"] = ms
        del args
    print(json.dumps({"ablation_ms": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
