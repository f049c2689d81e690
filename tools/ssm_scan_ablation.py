#!/usr/bin/env python3
"""What holds the ``ssm_scan`` kernel back: copies of its source, each with
one part taken out or changed, timed beside the kernel on one NVIDIA GPU.

    python3 tools/ssm_scan_ablation.py

Each copy of ``src/repro_torch/csrc/ssm_scan.cu`` is made by a text edit and
built with the kernel's own flags (``repro_torch.kernels.nvcc``), all in
parallel.  The copies that take work out ("no exp", "no loads", "decode
returns") compute wrong results: they are timed, never checked.  The
others are checked against the plain version.  The card's clock and power
are read while the kernel runs back to back.  Every copy is timed at Jamba's
prefill and decode shapes as ``chip_smoke.py`` phase 10 times the kernel
(a 256 MB write flush and a ~1 ms device spin before each launch), in two
rounds, forward and backward, and the script prints the card's name and
power limit, the kernel's registers and spills by instantiation (ptxas),
one line a copy and shape, and a JSON line of the two rounds' medians.
An edit that no longer finds its text in the source stops the script
before anything is built: a diagnostic, it follows the kernel and does
not hold it.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# 2^x for |x| < 126: x = j + f with j an integer and |f| <= 1/2 (by the
# 1.5 * 2^23 rounding trick), 2^f by its Taylor series to f^6, j added to
# the exponent bits
EXP2_POLY = """__device__ __forceinline__ float exp2_poly(float x) {
  x = fminf(fmaxf(x, -126.0f), 126.0f);
  const float r = x + 12582912.0f;
  const float f = x - (r - 12582912.0f);
  float p = 1.5403530393381606e-4f;
  p = fmaf(p, f, 1.3333558146428443e-3f);
  p = fmaf(p, f, 9.618129107628477e-3f);
  p = fmaf(p, f, 5.550410866482158e-2f);
  p = fmaf(p, f, 0.2402265069591007f);
  p = fmaf(p, f, 0.6931471805599453f);
  p = fmaf(p, f, 1.0f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(r) << 23));
}

"""

# name -> (what it shows, [(text in the source, its replacement), ...])
EDITS = {
    "kernel": ("the kernel as it is", []),
    "store under if": (
        "y stored under `if (store)` in every block, a branch between steps",
        [("if (ALL || store) *yp = yv;", "if (store) *yp = yv;")]),
    "unrolled by 8": (
        "the step loop unrolled by 8, not 16",
        [("#pragma unroll 16\n  for (int t = 0; t < n; ++t)",
          "#pragma unroll 8\n  for (int t = 0; t < n; ++t)")]),
    "compiler's registers": (
        "no blocks-an-SM bound: the compiler keeps registers for more blocks "
        "than the shared memory lets in",
        [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads)")]),
    "no exp": (
        "ex2 left out (the decay is its argument): the MUFU pipe's share",
        [("const float e = ex2(dtt * a2[i]);", "const float e = dtt * a2[i];")]),
    "no loads": (
        "no tile copied in (the steps read stale shared memory): the "
        "loads' share",
        [("    if (k < tiles)\n      load_tile", "    if (false)\n      load_tile"),
         ("    if (next < tiles)\n      load_tile",
          "    if (false)\n      load_tile")]),
    "4 of 16 exp by polynomial": (
        "exponents n = 3, 7, 11, 15 by a degree-6 polynomial on the FMA pipe "
        "(2^-22 relative), the rest on MUFU: fewer MUFU ops, more issued",
        [("// One step for one thread", EXP2_POLY + "// One step for one thread"),
         ("const float e = ex2(dtt * a2[i]);",
          "const float e = i % 4 == 3 ? exp2_poly(dtt * a2[i])\n"
          "                                 : ex2(dtt * a2[i]);")]),
    "decode returns": (
        "the S = 1 branch returns at once: the launch's own time",
        [("  if (S == 1) {\n    // decode",
          "  if (S == 1) return;\n  if (S == -1) {\n    // decode")]),
}
CHECKED = ("kernel", "store under if", "unrolled by 8", "compiler's registers",
           "4 of 16 exp by polynomial")


def build_all(nvcc):
    source = (ROOT / "src/repro_torch/csrc/ssm_scan.cu").read_text()
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (_, edits)) in enumerate(EDITS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r} once")
            text = text.replace(old, new)
        paths[name] = out / f"ssm_scan_ablation_{i}.cu"
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(nvcc.build, paths.values())))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).ssm_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssm_scan_ablation: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.ssm_scan import ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    fns = build_all(nvcc)
    # the kernel's registers and spills, per instantiation (N)
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(nvcc.SOURCE_DIR / "ssm_scan.cu")],
            capture_output=True, text=True, check=True)
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"ssm_scan_kernelILi(\d+)E", line)
        if m and "Compiling entry" in line:
            kernel = f"N {m[1]}"
        elif kernel and ("Used" in line or "spill" in line):
            print(f"ptxas, {kernel}: {line.split(':', 1)[-1].strip()}")

    def run(name, args, out):
        x, dt, A, Bc, Cc, h0 = args
        B, S, D = x.shape
        y = torch.empty_like(x)
        err = fns[name](x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        Bc.data_ptr(), Cc.data_ptr(),
                        None if h0 is None else h0.data_ptr(), y.data_ptr(),
                        out.data_ptr(), B, S, D, A.shape[1],
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return y, out

    gen = torch.Generator(device="cuda").manual_seed(13)
    for shape in (cs.JAMBA_PREFILL, (2, 77, 130, 16, True)):
        args = cs.ssm_inputs(torch, shape, gen, False)
        want_y, want_h = ref.ssm_scan_ref(*args)
        for name in CHECKED:
            y, h = run(name, args, torch.empty_like(want_h))
            (ey, sy), (eh, sh) = cs.ssm_err(y, want_y), cs.ssm_err(h, want_h)
            cs.check(ey <= cs.SSM_TOL * sy and eh <= cs.SSM_TOL * sh,
                     f"{name} disagrees with the plain version at {shape}")
    print("the kernel and the variants that keep its arithmetic agree "
          f"with the plain version within {cs.SSM_TOL} of scale")

    # the card's clock and power while the kernel runs back to back
    args = cs.ssm_inputs(torch, cs.JAMBA_PREFILL, gen, True)
    out = torch.zeros(4, 8192, 16, device="cuda")
    for _ in range(8000):                       # ~1.5 s of launches
        run("kernel", args, out)
    time.sleep(0.5)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    print(f"during back-to-back prefill launches: SM clock, memory clock, "
          f"power, temperature, throttle reasons: {smi}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rounds = {}
    for label, shape in (("prefill", cs.JAMBA_PREFILL),
                         ("decode", cs.JAMBA_DECODE)):
        args = cs.ssm_inputs(torch, shape, gen, True)
        out = torch.zeros(shape[0], shape[2], shape[3], device="cuda")
        got = {}
        for order in (list(EDITS), list(EDITS)[::-1]):
            for name in order:
                got.setdefault(name, []).append(cs.time_ms(
                    torch, lambda: run(name, args, out), flush=flush.zero_,
                    spin=True))
        for name, ms in got.items():
            print(f"{label} {name}: " + " / ".join(f"{t:.4f}" for t in ms)
                  + f" ms  ({EDITS[name][0]})")
            rounds[f"{label} {name}"] = ms
    print(json.dumps({"ablation_ms": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
