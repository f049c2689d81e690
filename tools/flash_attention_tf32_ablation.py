#!/usr/bin/env python3
"""What the 3xTF32 ``flash_attention`` kernels' times follow: copies of
their sources with one part taken out or changed, timed beside the kernels
at Whisper-medium's float32 shapes on one NVIDIA GPU.

    python3 tools/flash_attention_tf32_ablation.py

Each copy of ``src/repro_torch/csrc/flash_attention_tf32.cu`` (the
forward) and ``flash_attention_bwd_tf32.cu`` (the backward) is made by a
text edit (every occurrence of the text), built with the kernels' own
flags, all in parallel, and launched through the wrapper on the
``tf32x3`` route.  The copies that take work out ("no split", "no
products", ...) compute wrong results and are timed, never checked; the
kernels and the copies that keep their arithmetic (``CHECKED``) are
checked against the plain versions first (phase 22's and 23's float32
limits), and "hi cleared by hand" is also compared with the kernel bit for
bit (the tensor cores read a float32 operand's top 19 bits).  Every copy is
timed as ``chip_smoke.py`` phases 22 and 23 time the kernels (a 256 MB
write flush and a ~1 ms device spin before each launch), in two rounds,
forward and backward.  The script prints the card's name and power limit,
each copy's spills (ptxas), one line a copy and shape, and a JSON line of
the two rounds' times.  An edit that no longer finds its text stops the
script before anything is built: a diagnostic, it follows the kernels and
does not hold them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SPLIT = ("  hi = __float_as_uint(x);\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));")
CVT_RNA = [(SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                   "  const float r = x - __uint_as_float(hi);\n"
                   '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));')]
HI_CLEARED = [(SPLIT, "  hi = __float_as_uint(x) & 0xFFFFE000u;\n"
                      "  lo = __float_as_uint(x - __uint_as_float(hi));")]
FWD_NO_PRODUCTS = [
    ('"wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "', '"// "')]
BWD_NO_PRODUCTS = FWD_NO_PRODUCTS + [
    ('"wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "', '"// "')]
FWD_NO_SPLIT = [("          split_tile<kBK,", "          if (0) split_tile<kBK,")]
BWD_NO_SPLIT = [("    fn(s, it);", "    if (0) fn(s, it);")]

# (source, copy) -> (what it shows, [(text in the source, replacement)])
EDITS = {
    ("fwd", "kernel"): ("the forward as it is", []),
    ("fwd", "no split"): ("the split warps free each stage unsplit",
                          FWD_NO_SPLIT),
    ("fwd", "no products"): ("every wgmma left out", FWD_NO_PRODUCTS),
    ("fwd", "neither"): ("no split and no products",
                         FWD_NO_SPLIT + FWD_NO_PRODUCTS),
    ("fwd", "cvt.rna split"): ("hi and lo rounded to nearest by "
                               "cvt.rna.tf32.f32", CVT_RNA),
    ("fwd", "hi cleared by hand"): ("hi's low 13 bits cleared before the "
                                    "tensor cores read it", HI_CLEARED),
    ("bwd", "kernel"): ("the backward as it is", []),
    ("bwd", "dq kernel alone"): (
        "the dk/dv kernel not launched: the dq kernel's time",
        [("  fa_tf32_dkdv_kernel<<<", "  if (0) fa_tf32_dkdv_kernel<<<")]),
    ("bwd", "dk/dv kernel alone"): (
        "the dq kernel not launched: the dk/dv kernel's time",
        [("  fa_tf32_dq_kernel<<<", "  if (0) fa_tf32_dq_kernel<<<")]),
    ("bwd", "no split"): ("the split warps free each stage unsplit",
                          BWD_NO_SPLIT),
    ("bwd", "no products"): ("every wgmma left out", BWD_NO_PRODUCTS),
    ("bwd", "cvt.rna split"): ("hi and lo rounded to nearest by "
                               "cvt.rna.tf32.f32", CVT_RNA),
    ("bwd", "hi cleared by hand"): ("hi's low 13 bits cleared before the "
                                    "tensor cores read it", HI_CLEARED),
}
CHECKED = ("kernel", "cvt.rna split", "hi cleared by hand")
SHAPES = {"fwd": (("whisper encoder", (4, 1500, 1500)),
                  ("whisper cross prefill", (4, 32, 1500))),
          "bwd": (("whisper encoder train", (4, 1500, 1500)),
                  ("whisper cross train", (4, 448, 1500)))}


def build_all(nvcc, sources):
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, ((which, name), (_, edits)) in enumerate(EDITS.items()):
        text = sources[which]
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{which} {name}: the source no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        paths[which, name] = out / f"flash_attention_tf32_ablation_{i}.cu"
        paths[which, name].write_text(text)

    def build(path):
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(Path(tmp) / "lib.so"), str(path)],
                capture_output=True, text=True)
        return nvcc.build(path), proc.stderr

    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(build, paths.values())))
    for (which, name), (_, log) in built.items():
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"ptxas, {which} {name}: {'; '.join(spills)}")
    return {key: lib for key, (lib, _) in built.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_tf32_ablation: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import (
        flash_attention as fk, flash_attention_bwd as fb, ref)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    libs = build_all(nvcc, {"fwd": fk.TF32_SOURCE.read_text(),
                            "bwd": fb.TF32_SOURCE.read_text()})
    fwd_build, bwd_build = fk.build, fb.build
    loaded = {}
    for (which, name), lib in libs.items():
        if which == "fwd":
            fk._tf32_lib = None
            fk.build = lambda source, lib=lib: lib
            loaded[which, name] = fk._load_tf32()
        else:
            fb._lib = {}
            fb.build = lambda source, lib=lib: lib
            loaded[which, name] = fb._load("tf32x3")
    fk.build, fb.build = fwd_build, bwd_build

    def run(which, name, q, k, v, do):
        if which == "fwd":
            fk._tf32_lib = loaded[which, name]
            return fk.flash_attention_cuda(q, k, v, causal=False)
        fb._lib = {"tf32x3": loaded[which, name]}
        return fb.flash_attention_bwd_cuda(q, k, v, do, causal=False)

    gen = torch.Generator(device="cuda").manual_seed(27)

    def inputs(B, Sq, Sk):
        q, do = (torch.randn(B, Sq, 16, 64, device="cuda", generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(B, Sk, 16, 64, device="cuda", generator=gen)
                for _ in range(2))
        return q, k, v, do

    q, k, v, do = inputs(2, 300, 500)
    want_fwd = ref.flash_attention_ref(q, k, v, causal=False)
    lse = ref.flash_attention_lse_ref(q, k, causal=False)
    want_bwd = ref.flash_attention_bwd_ref(q, k, v, do, lse, causal=False)
    for which in ("fwd", "bwd"):
        same = run(which, "kernel", q, k, v, do)
        for name in CHECKED:
            got = run(which, name, q, k, v, do)
            if which == "fwd":
                errs = [(got - want_fwd).abs().max().item()]
                tol = cs.FA_TOL[cs.F32]
                bits = torch.equal(got, same)
            else:
                errs = [cs.rel_to_largest(g, w)
                        for g, w in zip(got, want_bwd)]
                tol = cs.FA_BWD_TOL[cs.F32]
                bits = all(torch.equal(a, b) for a, b in zip(got, same))
            print(f"  {which} {name} at (2, 300, 500, 16 on 16, hd 64): "
                  f"errors {', '.join(f'{e:.2e}' for e in errs)} (tol "
                  f"{tol:.3g}); {'the' if bits else 'not the'} kernel's "
                  f"bits")
            cs.check(all(e <= tol for e in errs),
                     f"{which} {name} disagrees with the plain version")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rounds = {}
    for which in ("fwd", "bwd"):
        names = [name for w, name in EDITS if w == which]
        for label, shape in SHAPES[which]:
            args = inputs(*shape)
            got = {}
            for order in (names, names[::-1]):
                for name in order:
                    got.setdefault(name, []).append(cs.time_ms(
                        torch, lambda: run(which, name, *args),
                        flush=flush.zero_, spin=True))
            for name, ms in got.items():
                print(f"{label} {name}: " + " / ".join(f"{t:.4f}" for t in ms)
                      + f" ms  ({EDITS[which, name][0]})")
                rounds[f"{label} {name}"] = ms
            del args
    print(json.dumps({"ablation_ms": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
