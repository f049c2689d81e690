#!/usr/bin/env python3
"""The port's normal draw in many fresh processes, each at torch's default
thread count, counted against a reference draw: how many processes draw
any element more than 1e-6 (absolute and relative, as
``tests/test_torch_random.py::test_normal_at_torch_default_thread_count``
holds it) away.

    python3 tools/normal_draw_processes.py [-n 200] [--src DIR]

The processes run one after another.  Each draws what the test draws:
``random.normal`` under the keys of seeds 0, 1 and 42, shape (512, 256),
on the CPU.  The reference is the
port's own draw in one process pinned to one thread (no worker thread),
which ``tests/test_torch_random.py`` holds to JAX's; no JAX is imported
here.  ``--src`` runs another tree's ``repro_torch`` (a parent unpacked
with ``git archive HEAD | tar -x -C build/parent``: ``--src
build/parent/src``), so a fault and its repair can be counted on one
machine.  Run it on idle cores: a fault of thread start-up shows less
when other processes hold the cores.  Prints one line for each process
that is off (the seed, the elements off, the largest difference) and the
count; exits 1 when any process is off.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 42)
SHAPE = (512, 256)
TOL = 1e-6

DRAWS = """
import sys
import numpy as np
import torch
from repro_torch import random as R
if sys.argv[2] == "1":
    torch.set_num_threads(1)
out = {"threads": np.int64(torch.get_num_threads())}
for seed in (0, 1, 42):
    out[f"s{seed}"] = R.normal(R.PRNGKey(seed, "cpu"), (512, 256)).numpy()
np.savez(sys.argv[1], **out)
"""


def draw(src: Path, path: Path, one_thread: bool = False) -> dict:
    """The draws of one fresh process, by seed, and its thread count."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = str(src)
    subprocess.run([sys.executable, "-c", DRAWS, str(path),
                    "1" if one_thread else "0"], env=env, check=True,
                   timeout=300)
    with np.load(path) as got:
        return {k: got[k] for k in got.files}


def reference(src: Path, tmp: Path) -> dict:
    """The reference draws by seed: one process pinned to one thread."""
    got = draw(src, tmp / "reference.npz", one_thread=True)
    return {s: got[f"s{s}"] for s in SEEDS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=200, help="fresh processes")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the tree's src directory")
    args = ap.parse_args(argv)
    src = args.src.resolve()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        want = reference(src, tmp)
        n_off, threads = 0, set()
        for i in range(args.n):
            got = draw(src, tmp / f"draw{i}.npz")
            threads.add(int(got["threads"]))
            off = []
            for s in SEEDS:
                diff = np.abs(got[f"s{s}"] - want[s])
                bad = diff > TOL + TOL * np.abs(want[s])
                if bad.any():
                    off.append(f"seed {s}: {int(bad.sum())} elements off, "
                               f"largest {diff.max():.3e}")
            if off:
                n_off += 1
                print(f"process {i} ({int(got['threads'])} threads): "
                      + "; ".join(off), flush=True)
    print(f"{n_off} of {args.n} processes off by more than {TOL:g} against "
          f"one thread's draw (src {src}; torch threads {sorted(threads)})")
    return 1 if n_off else 0


if __name__ == "__main__":
    sys.exit(main())
