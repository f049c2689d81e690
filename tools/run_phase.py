#!/usr/bin/env python3
"""One timed phase of the ``chip_smoke.py`` of a tree, alone, so that two
trees (this one and a parent unpacked by ``git archive`` into a directory
that ``.gitignore`` lists) can be compared on one card in one run.

    python3 tools/run_phase.py 10 [TREE]      # ssm_scan (phase 10)
    python3 tools/run_phase.py 7 [TREE]       # flash_attention (phase 7)

TREE defaults to this checkout.  The phase builds and loads the tree's own
kernels (its ``build/kernels``) and prints what that tree's phase prints,
then a JSON line of its times by shape.  Run each tree in its own process:
the two trees' packages share a name.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> int:
    phase = sys.argv[1] if len(sys.argv) > 1 else ""
    if phase not in ("7", "10"):
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
    else:
        _, times = cs.flash_phase(torch, mem, bf16)
    print(json.dumps({"tree": str(tree), "phase": int(phase), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
