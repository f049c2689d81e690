#!/usr/bin/env python3
"""What the ``ssm_scan`` backward's time follows: copies of its source, each
with one part of the reverse pass taken out, timed beside the kernel on one
NVIDIA GPU.

    python3 tools/ssm_scan_bwd_ablation.py [TREE]

TREE (default: this checkout) is a tree whose ``src/repro_torch`` holds the
backward to take apart, for instance a parent unpacked with ``git archive
HEAD | tar -x -C build/parent``.  Each copy of the tree's
``csrc/ssm_scan_bwd.cu`` is made by a text edit and built with the
kernel's own flags, all in parallel, and launched through the tree's own
wrapper (``ssm_scan_bwd_cuda``), which sizes the scratch its design needs.
Two designs are known, each with its edits: the earlier one (one thread
a channel, the tile's states recomputed into shared memory) and the
current one (four lanes a channel, the tile's states in registers); the
tool takes the one whose texts the source holds, and stops before
building anything if neither fits (a diagnostic: it follows the kernel,
it does not hold it).  The copies that take work out compute wrong
results and are timed, never checked; the kernel and the copies that keep
its arithmetic (``CHECKED``) are checked against the plain version
first.  Every copy
is timed at Jamba's train shape as ``chip_smoke.py`` phase 18 times the
kernel (a 256 MB write flush and a ~1 ms device spin before each launch),
in two rounds, forward and backward; the script prints the card's name and
power limit, the kernels' registers and spills (ptxas), one line a copy,
and a JSON line of the two rounds' times.
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

# Sums that stand in for a removed reduction: every partial is still
# computed, only the shuffles go.
PLAIN_SUM_19 = ("float r = 0.f;\n#pragma unroll\n"
                "        for (int i = 0; i < V; ++i) r += v[i];")
PLAIN_SUM_20 = ("float s = 0.f;\n#pragma unroll\n"
                "        for (int i = 0; i < V; ++i) s += v[i];")

# design -> {copy: (what it shows, [(text in the source, replacement)])}
DESIGNS = {
    "one thread a channel, states in shared memory": {
        "kernel": ("the kernel as it is", []),
        "no recompute": (
            "the tile's states not recomputed into shared memory (the step "
            "back reads stale ones)",
            [("          hs[(j * N + n) * kThreads + tid] = h[n];\n"
              "          h[n] = fmaf(h[n], ex2(dts[j] * a2[n]), u * bt[n]);\n",
              "")]),
        "no transpose": (
            "dB and dC summed within the thread, no warp_transpose_sum "
            "shuffles",
            [("const float r = warp_transpose_sum<V>(v);", PLAIN_SUM_19)]),
        "no stores": (
            "dx, ddt and the per-block dB / dC partials not stored (all but "
            "never)",
            [("        if (live) {\n          const int64_t off",
              "        if (live && du == 1e-38f) {\n"
              "          const int64_t off"),
             ("      a.part[((row0 + t0 + j) * gridDim.x + blockIdx.x) * V + c]"
              " = s;",
              "      if (s == 1e-38f)\n        a.part[((row0 + t0 + j) * "
              "gridDim.x + blockIdx.x) * V + c] = s;")]),
        "no exp in the step back": (
            "ex2 left out of the step back (the decay is its argument)",
            [("const float e = ex2(dtt * a2[n]);",
              "const float e = dtt * a2[n];")]),
        "pass 1 alone": (
            "the reverse pass returns at once: the stored-state pass and "
            "the final sums",
            [("  const int tid = threadIdx.x;\n  const int lane = tid & 31;",
              "  if (a.S > 0) return;\n  const int tid = threadIdx.x;\n"
              "  const int lane = tid & 31;")]),
    },
    "four lanes a channel, states in registers": {
        "kernel": ("the kernel as it is", []),
        "no recompute": (
            "the tile's states not recomputed (the step back reads the "
            "tile's first state at every step)",
            [("          h[n] = fmaf(h[n], ex2(dtt * a2[n]), u * bv[n]);\n",
              "          ;\n")]),
        "no transpose": (
            "dB and dC summed within the lane, no channel_transpose_sum "
            "shuffles",
            [("const float s = channel_transpose_sum<V>(v, lane);",
              PLAIN_SUM_20)]),
        "no stores": (
            "dx, ddt and the per-block dB / dC partials not stored (all but "
            "never)",
            [("        if (live && q < 2) {",
              "        if (live && q < 2 && r == 1e-38f) {"),
             ("      a.part[((row0 + t0 + j) * gridDim.x + blockIdx.x) * 2 * N"
              " + col] = s;",
              "      if (s == 1e-38f)\n        a.part[((row0 + t0 + j) * "
              "gridDim.x + blockIdx.x) * 2 * N + col] = s;")]),
        "no exp in the step back": (
            "ex2 left out of the step back (the decay is its argument)",
            [("          const float e = ex2(dtt * a2[n]);",
              "          const float e = dtt * a2[n];")]),
        "decays kept": (
            "the step back reads each decay from the recompute (kT x N / 4 "
            "more registers) instead of taking its exponential again",
            [("    float hs[kT][NL];", "    float hs[kT][NL], es[kT][NL];"),
             ("        for (int n = 0; n < NL; ++n)\n"
              "          h[n] = fmaf(h[n], ex2(dtt * a2[n]), u * bv[n]);",
              "        for (int n = 0; n < NL; ++n) {\n"
              "          es[j][n] = ex2(dtt * a2[n]);\n"
              "          h[n] = fmaf(h[n], es[j][n], u * bv[n]);\n"
              "        }"),
             ("          const float e = ex2(dtt * a2[n]);",
              "          const float e = es[j][n];")]),
        "three blocks an SM": (
            "__launch_bounds__(256, 3) on the reverse pass: 85 registers a "
            "thread, 24 warps an SM",
            [("__launch_bounds__(kThreads) reverse_kernel",
              "__launch_bounds__(kThreads, 3) reverse_kernel")]),
        "tiles of 16 steps": (
            "states stored every 16 steps, not 8 (half the stored bytes, "
            "twice the tile's registers)",
            [("constexpr int kT = 8; ", "constexpr int kT = 16;")]),
        "ring of 2 stages": (
            "a ring of 2 tiles, not 4",
            [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
        "pass 1 alone": (
            "the reverse pass returns at once: the stored-state pass and "
            "the final sums",
            [("  float* red = smem + kStages * L::kFloats;",
              "  if (a.S > 0) return;\n"
              "  float* red = smem + kStages * L::kFloats;")]),
    },
}


CHECKED = ("kernel", "decays kept", "three blocks an SM", "tiles of 16 steps",
           "ring of 2 stages")


def pick_design(source):
    for name, edits in DESIGNS.items():
        if all(source.count(old) == 1 for _, subs in edits.values()
               for old, _ in subs):
            return name, edits
    raise RuntimeError("the source holds the texts of no known design: edit "
                       "the tool to follow the kernel")


def build_all(nvcc, source, edits):
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (_, subs)) in enumerate(edits.items()):
        text = source
        for old, new in subs:
            text = text.replace(old, new)
        paths[name] = out / f"ssm_scan_bwd_ablation_{i}.cu"
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        return dict(zip(paths, pool.map(nvcc.build, paths.values())))


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    import torch
    if not torch.cuda.is_available():
        print("ssm_scan_bwd_ablation: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))     # the tree's package first
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.ssm_scan import ref, ssm_scan_bwd as bwd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(f"tree {tree}: {bwd.__file__}")
    source = bwd.SOURCE.read_text()
    design, edits = pick_design(source)
    print(f"design: {design}")
    libs = build_all(nvcc, source, edits)

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(bwd.SOURCE)],
            capture_output=True, text=True, check=True)
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"(state|ckpt|reverse|finish)_kernelILi(\d+)E", line)
        if m and "Compiling entry" in line:
            kernel = f"{m[1]}_kernel N {m[2]}"
        elif kernel and ("Used" in line or "spill" in line):
            print(f"ptxas, {kernel}: {line.split(':', 1)[-1].strip()}")

    loaded = {}
    for name, lib in libs.items():
        bwd._lib = None
        bwd.build = lambda lib=lib: lib
        loaded[name] = bwd._load()

    def run(name, args, dy):
        bwd._lib = loaded[name]
        return bwd.ssm_scan_bwd_cuda(*args, dy)

    gen = torch.Generator(device="cuda").manual_seed(18)
    for shape in ((2, 77, 130, 16, True), cs.JAMBA_PREFILL):
        args = cs.ssm_inputs(torch, shape, gen, True)
        dy = torch.randn(*args[0].shape, device="cuda", generator=gen)
        want = ref.ssm_scan_bwd_ref(*args, dy)
        for name in CHECKED:
            if name in edits:
                errs = [cs.rel_to_largest(g, w)
                        for g, w in zip(run(name, args, dy), want)
                        if w is not None]
                cs.check(all(e <= cs.SSM_TOL for e in errs),
                         f"{name} disagrees with the plain version at {shape}")
        del want
    print(f"the kernel and the copies that keep its arithmetic agree with "
          f"the plain version within {cs.SSM_TOL}")

    args = cs.ssm_inputs(torch, cs.JAMBA_PREFILL, gen, True)
    dy = torch.randn(*args[0].shape, device="cuda", generator=gen)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    got = {}
    for order in (list(edits), list(edits)[::-1]):
        for name in order:
            got.setdefault(name, []).append(cs.time_ms(
                torch, lambda: run(name, args, dy), reps=10,
                flush=flush.zero_, spin=True))
    for name, ms in got.items():
        print(f"train {name}: " + " / ".join(f"{t:.4f}" for t in ms)
              + f" ms  ({edits[name][0]})")
    print(json.dumps({"design": design, "ablation_ms": got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
