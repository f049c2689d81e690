"""What the cells read must not move when the harness is reorganised: the
inputs that ``make_inputs`` makes from a seed (weights, the clients' and
the evaluation tensors, bit for bit) and the plain reference's readings at
the tiny sizes (its rounds in float64, the control's and the planted
faults' compared numbers), as digests recorded before the reorganisation.
CPU, seconds.  The readings are taken on one thread: float64 convolutions
on the CPU round differently when their work is split across threads."""
import contextlib
import hashlib
import json

import pytest
import torch

import bench_tiny
from bench import calibrate, check, data
from bench.reference import fl

SEEDS = (2**31 + 101, 7)
CASES = [("mlp", "fedbwo"), ("cnn", "fedbwo"), ("cnn", "fedavg")]

# recorded on the parent commit of the reorganisation (sha256, first 16
# hex digits), by the functions below
INPUTS = {
    ("mlp", "fedbwo", SEEDS[0]): "e3b9a4df4806f56e",
    ("mlp", "fedbwo", SEEDS[1]): "2bf71ba8094650f2",
    ("cnn", "fedbwo", SEEDS[0]): "acec8887f75d7694",
    ("cnn", "fedbwo", SEEDS[1]): "c684888797ba67fb",
    ("cnn", "fedavg", SEEDS[0]): "acec8887f75d7694",
    ("cnn", "fedavg", SEEDS[1]): "c684888797ba67fb",
}
READINGS = {
    ("mlp", "fedbwo", SEEDS[0]): "3b975de37caea6d6",
    ("mlp", "fedbwo", SEEDS[1]): "88fa4605c77c3f5d",
    ("cnn", "fedbwo", SEEDS[0]): "9c89177568ce5b22",
    ("cnn", "fedbwo", SEEDS[1]): "3f3868036e1806e5",
    ("cnn", "fedavg", SEEDS[0]): "66e2e3103b547470",
    ("cnn", "fedavg", SEEDS[1]): "ac11a19b03f098df",
}


def digest(obj) -> str:
    return hashlib.sha256(obj).hexdigest()[:16]


def tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    head = f"{t.dtype} {tuple(t.shape)};".encode()
    return head + t.numpy().tobytes()


def inputs_digest(inputs) -> str:
    parts = [tensor_bytes(inputs.weights)]
    for c in inputs.clients:
        parts += [k.encode() + tensor_bytes(c[k]) for k in sorted(c)]
    parts += [k.encode() + tensor_bytes(inputs.eval[k])
              for k in sorted(inputs.eval)]
    return digest(b"".join(parts))


@contextlib.contextmanager
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def readings(spec, seed: int) -> dict:
    """The reference's two rounds in float64 (each round's report and the
    model after it) and the numbers of the control and of each fault."""
    with one_thread():
        return _readings(spec, seed)


def _readings(spec, seed: int) -> dict:
    inputs = data.make_inputs(spec.cfg, spec.traffic, seed, "cpu")
    model = fl.Model(spec.cfg, "cpu", fl.Precision("float64"))
    infos, params = check.reference_rounds(model, inputs, seed,
                                           spec.traffic, 2)
    out = {"infos": [{k: (v.tolist() if hasattr(v, "tolist") else v)
                      for k, v in i.items()} for i in infos],
           "params": [digest(tensor_bytes(p)) for p in params]}
    out.update(calibrate.readings(spec, seed, "cpu"))
    return out


# numbers that the check computes since the digests were recorded
NEW_NUMBERS = ("score_gap_p90",)


def readings_digest(found: dict) -> str:
    found = {k: ({n: x for n, x in v.items() if n not in NEW_NUMBERS}
                 if k not in ("infos", "params") else v)
             for k, v in found.items()}
    return digest(json.dumps(found, sort_keys=True,
                             default=float).encode())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model, strategy", CASES)
def test_inputs_do_not_move(model, strategy, seed):
    spec = bench_tiny.spec(model, strategy)
    inputs = data.make_inputs(spec.cfg, spec.traffic, seed, "cpu")
    assert inputs_digest(inputs) == INPUTS[(model, strategy, seed)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model, strategy", CASES)
def test_reference_readings_do_not_move(model, strategy, seed):
    found = readings(bench_tiny.spec(model, strategy), seed)
    assert readings_digest(found) == READINGS[(model, strategy, seed)], \
        json.dumps(found, default=float)
