"""Readings for the limits of ``correct``: the program over many seeds,
and, on a few seeds, the control and the planted faults in the program's
place, each held to the float64 reference by the same numbers.

    python3 bench/calibrate.py --workload cnn-fedbwo-iid \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 1

One JSON line a reading: ``{"seed", "kind", "numbers"}``; ``kind`` is
``program``, ``control`` (the reference in TF32, the nearest precision
below the configuration's float32), or a fault: ``skip_sgd`` (a client's
step returns its state), ``keep_state`` (the server keeps the old
model), ``half_batch`` (each loss over half the batch), ``flip_best`` (the
winner reported one client on), and, in a cell that compares
``score_gap_p90``, ``tail_skip_sgd`` (the last tenth of the clients skip
their SGD).  Needs a CUDA device, as ``run.py``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FAULTS = ("skip_sgd", "keep_state", "half_batch", "flip_best")


def readings(spec, seed: int, device: str):
    """The control's and each fault's numbers on one seed."""
    from bench import check, data
    from bench.reference import fl
    cfg, traffic, n = spec.cfg, spec.traffic, spec.follow_rounds
    inputs = data.make_inputs(cfg, traffic, seed, device)
    ref = fl.Model(cfg, device, fl.Precision("float64"))
    follow = check.reference_rounds(ref, inputs, seed, traffic, n)[0]
    kinds = [("control", fl.Model(cfg, device, fl.Precision("tf32")), ())]
    planted = FAULTS
    if "score_gap_p90" in spec.limits:
        # a fault in a few clients, for the number that sees them
        planted += ("tail_skip_sgd",)
    for f in planted:
        if f == "flip_best" and traffic["strategy"] != "fedbwo":
            continue
        model = fl.Model(cfg, device, fl.Precision("float64"),
                         half_batch=f == "half_batch")
        kinds.append((f, model, () if f == "half_batch" else (f,)))
    for kind, model, faults in kinds:
        obs = check.observe_reference(model, inputs, seed, traffic, n,
                                      faults)
        yield kind, check.numbers(ref, inputs, seed, traffic, obs, n,
                                  follow=follow)


def control_at_ends(obs, inputs, model, traffic):
    """The control's end numbers at the program's own state: the models the
    program held at its block ends, evaluated (and, for FedBWO, the
    winner's fitness taken) in TF32 in the program's place."""
    from bench import check
    from bench.reference import fl
    ctrl = fl.Model(model.cfg, model.device, fl.Precision("tf32"))
    ends = []
    for flat, info in obs.ends:
        flat = flat.float()
        info = dict(info, eval_loss=ctrl.evaluate(flat, inputs.eval)[0])
        if "best_client" in info:
            k = info["best_client"]
            info["scores"] = list(info["scores"])
            info["scores"][k] = ctrl.fitness(flat, inputs.clients[k],
                                             traffic["fitness_batches"])
        ends.append((flat, info))
    return check.end_numbers(model, inputs, traffic, check.Observed(
        first=obs.first, ends=ends, rounds=obs.rounds))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from bench import cell
    from run import plain
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = cell.load_spec(args.workload)
    engine = "auto" if args.device == "cuda" else "batched"
    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.run(spec, int(s), args.seconds, False, t0, args.device,
                       engine, hook=control_at_ends)
        print(json.dumps(plain({"seed": int(s), "kind": "program",
                                "correct": out["correct"],
                                "seconds": time.perf_counter() - t0,
                                "setup_s": out["metrics"]["setup_s"]["value"],
                                "round_s": out["metrics"]["round_s"]["value"],
                                "numbers": out["numbers"]})), flush=True)
        print(json.dumps(plain({"seed": int(s), "kind": "control_at_ends",
                                "numbers": out["hook"]})), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        for kind, found in readings(spec, int(s), args.device):
            print(json.dumps(plain({"seed": int(s), "kind": kind,
                                    "numbers": found})), flush=True)
        print(json.dumps({"seed": int(s), "kind": "timing",
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
