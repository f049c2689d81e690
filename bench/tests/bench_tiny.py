"""Small configurations and mixes for the CPU tests: the cells' own
files with their sizes cut, so that a whole run takes seconds."""
import json
from pathlib import Path

from bench import cell

BENCH = Path(__file__).resolve().parents[1]

TINY = {
    "mlp": {"name": "tiny-mlp", "model": "mlp", "task": "mlp",
            "image_size": 8, "channels": 3, "hidden": 16,
            "num_classes": 10},
    "cnn": {"name": "tiny-cnn", "model": "cnn", "task": "cnn",
            "image_size": 8, "channels": 3, "conv1_filters": 4,
            "conv2_filters": 8, "kernel": 5, "dense_hidden": 16,
            "num_classes": 10, "dropout": 0.2},
}
CELL = {("mlp", "fedbwo"): "2nn-fedbwo-iid", ("cnn", "fedbwo"):
        "cnn-fedbwo-iid", ("cnn", "fedavg"): "cnn-fedavg-iid"}


def spec(model: str, strategy: str, lr: float = 0.3,
         name: str = None) -> cell.Spec:
    """The cell's spec (its mix, limits and follow rounds) at a tiny size:
    3 clients of 2 batches, 2 epochs at lr 0.3 (so that a round moves the
    model), pop 4, 2 generations, blocks of 2 rounds.  ``name``: another
    cell of the same model and strategy than ``CELL``'s."""
    real = cell.load_spec(name or CELL[(model, strategy)])
    t = dict(real.traffic, n_clients=3, n_train=60, n_test=30,
             local_epochs=2, lr=lr, mh_pop=4, mh_generations=2,
             rounds_per_dispatch=2, trace_blocks=1)
    return cell.Spec(real.workload, TINY[model], t, real.end_to_end,
                     real.per_layer, min(real.follow_rounds, 2), real.limits)


def load(name: str):
    return json.loads((BENCH / name).read_text())


# A sound tiny run against the float64 reference: float32 rounding over a
# few SGD steps and a tiny model (the cells' limits are set at their own
# sizes; a planted fault reads 1e-3 or more, the TF32 control 1e-5 or more).
TINY_GAP = 2e-6


def sound(numbers: dict, spec: cell.Spec) -> list:
    """The cell's compared numbers that a sound tiny run reads too high."""
    return [k for k in spec.limits
            if numbers[k] > (0 if k.endswith(("_miss", "_off")) else TINY_GAP)]
