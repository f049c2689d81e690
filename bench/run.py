"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload cnn-fedbwo-iid --seed 1234 \
        --seconds 30 --trace 0

The cell, its configuration, traffic mix, limits and per-layer metrics
are found by name (``BENCHMARK.json``, ``bench/*/``).  Without a CUDA
device, or with fewer than the cell asks for, it exits 1 and prints no
result; so it does if JAX or the JAX package was loaded in this process.
The last line of standard output is the result's JSON; the compared
numbers and their limits are also the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def plain(x):
    """JSON-safe: a non-finite float as its name ("inf", "nan")."""
    if isinstance(x, float) and x != x or x in (float("inf"), float("-inf")):
        return str(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def loaded_forbidden(modules=None) -> list:
    """Modules of JAX or of the JAX package among ``modules`` (this
    process's by default), by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    from bench import cell
    spec = cell.load_spec(args.workload)
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = cell.run(spec, args.seed, args.seconds, bool(args.trace), T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, row in out["checks"].items():
        print(f"{name} {row['value']} limit {row['limit']}", file=sys.stderr)
    print(json.dumps(plain(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
