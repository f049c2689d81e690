"""flcheck's entry points in the port on the CPU: the CLI, ``fl_train
--audit`` and ``build_experiment(audit=...)`` (whose rounds must equal an
unaudited build's), and two faults planted in the engine's block, each
reported as its rule's error."""
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import random as R, tree  # noqa: E402
from repro_torch.analysis import AuditError  # noqa: E402
from repro_torch.analysis.audit import audit_experiment  # noqa: E402
from repro_torch.analysis.cli import main  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.api import FLConfig, build_experiment  # noqa: E402
from repro_torch.data.synthetic import mlp_task  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HIDDEN = 8


def _small(**kw):
    base = dict(task="mlp", strategy="fedbwo", n_clients=3, n_train=90,
                n_test=30, batch_size=8, local_epochs=1, mh_pop=2,
                mh_generations=1, max_rounds=3, rounds_per_dispatch=2,
                device="cpu")
    base.update(kw)
    return FLConfig(**base)


@pytest.mark.parametrize("strategy,engine", [
    ("fedbwo", "batched"), ("fedbwo", "sequential"), ("fedavg", "batched"),
    ("fedavg", "sequential")])
def test_cli_strict_exits_zero(strategy, engine, capsys):
    assert main(["--device", "cpu", "--task", "mlp", "--clients", "2",
                 "--strategy", strategy,
                 "--engine", engine, "--rounds-per-dispatch", "2",
                 "--strict"]) == 0
    assert "flcheck: 0 error(s)" in capsys.readouterr().out


def test_fl_train_audit_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_train", "--device",
         "cpu", "--audit", "--task", "mlp", "--strategy", "fedavg",
         "--clients", "3", "--rounds", "1", "--train", "60", "--test", "20",
         "--local-epochs", "1"], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "flcheck: 0 error(s)" in out.stdout


def test_build_hook_audits_and_the_rounds_equal_an_unaudited_builds():
    cfg = _small(pipeline_blocks="on", tau=1.01, bwo_kernel=True)
    audited = build_experiment(cfg, task=mlp_task(hidden=HIDDEN),
                               audit="strict")
    plain = build_experiment(cfg, task=mlp_task(hidden=HIDDEN))
    assert audited.audit_report.ok and plain.audit_report is None
    assert build_experiment(cfg, task=mlp_task(hidden=HIDDEN),
                            audit="report").audit_report.ok
    la, lp = audited.run().logs, plain.run().logs
    assert len(la) == len(lp) == 3
    for a, p in zip(la, lp):
        assert a.info == p.info and (a.test_loss, a.test_acc) == \
            (p.test_loss, p.test_acc)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(audited.server.global_params),
        tree.leaves(plain.server.global_params)))


def _planted(kind):
    """``repro_torch.random`` with ``split`` made bad for the engine's own
    calls (the block's key schedule): a ``.item()``, or float64 keys."""
    names = {k: getattr(R, k) for k in dir(R) if not k.startswith("__")}

    def split(key, num=2):
        out = R.split(key, num)
        if kind == "item":
            out.sum().item()
            return out
        return out.double().long()
    names["split"] = split
    return types.SimpleNamespace(**names)


@pytest.mark.parametrize("kind,rules", [
    ("item", {"one-sync-per-block", "no-host-callback-in-scan"}),
    ("double", {"no-f64"})])
def test_a_planted_fault_in_the_block_is_an_error(monkeypatch, kind, rules):
    texp = build_experiment(_small(), task=mlp_task(hidden=HIDDEN))
    monkeypatch.setattr(engine_mod, "random", _planted(kind))
    report = audit_experiment(texp, lint=False)
    assert {f.rule for f in report.errors} == rules
    assert {f.subject for f in report.errors} == {"block[fedbwo x2]"}
    if kind == "item":
        (loop,) = [f for f in report.errors
                   if f.rule == "no-host-callback-in-scan"]
        assert "x2" in loop.message and loop.location.startswith(
            "repro_torch/core/engine.py:")
    with pytest.raises(AuditError):
        audit_experiment(texp, lint=False, strict=True)
