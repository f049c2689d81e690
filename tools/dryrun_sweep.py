#!/usr/bin/env python3
"""Every reduced arch's dry run on two small fake meshes, host-only.

    python3 tools/dryrun_sweep.py

Runs ``repro_torch.launch.dryrun.lower_combo`` for each arch's
``.reduced()`` configuration and each mode (train, prefill, decode; 8
sequences of 64 tokens) on a (2, 4) mesh over ("data", "model") and a (2,
2, 2) mesh over ("pod", "data", "model"), and prints one line for each:
its seconds and per-device FLOPs and argument bytes, or where it failed
(an op ``DTensor`` has no rule for, on the torch at hand).  It needs no
card: run it on the chip machine to see that machine's torch.  Exits 1
when a combination fails.
"""
from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS, InputShape, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

MESHES = ((2, 4), (2, 2, 2))
MODES = ("train", "prefill", "decode")


def main() -> int:
    failed = 0
    try:
        for mesh in MESHES:
            for arch in ARCHS:
                for mode in MODES:
                    t0 = time.perf_counter()
                    try:
                        r = dryrun.lower_combo(
                            arch, mode, cfg=get_arch(arch).reduced(),
                            shape=InputShape(mode, 64, 8, mode),
                            mesh_shape=mesh, multi_pod=len(mesh) == 3)
                        msg = (f"ok flops/dev "
                               f"{r['cost']['flops_per_device']:.4e} "
                               f"arguments/dev "
                               f"{r['memory']['argument_bytes_per_device']}")
                    except Exception as e:          # noqa: BLE001
                        failed += 1
                        where = [f"{f.filename.split('/src/')[-1]}:{f.lineno}"
                                 for f in traceback.extract_tb(e.__traceback__)
                                 if "/src/repro_torch/" in f.filename][-1:]
                        msg = (f"FAILED {type(e).__name__}: "
                               f"{str(e).splitlines()[0][:300]} at {where}")
                    print(f"{'x'.join(map(str, mesh))} {arch} {mode} "
                          f"{time.perf_counter() - t0:.1f} s {msg}",
                          flush=True)
    finally:
        dryrun.close_world()
    print(f"{failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
