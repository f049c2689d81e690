"""The port's examples (``examples/*_torch.py``) run with ``--device cpu``.

``serve_llm_torch.py`` and ``continuous_batching_torch.py`` run at their
references' sizes (a few seconds each).  ``quickstart_torch.py`` and
``fl_cifar_comparison_torch.py`` take minutes at theirs on this CPU (the
paper CNN, 5 and 10 clients, sequential on the CPU), so they run with
``FLConfig`` cut to a dense task, 3 clients, 90 images and one round: the
script's own wiring and printing, not its sizes.
"""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import core
from repro_torch.core import api

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "jamba-v0.1-52b"])
def test_serve_llm(arch):
    out = _run("serve_llm_torch.py", "--arch", arch)
    assert f"{arch} reduced:" in out
    m = re.search(r"generated 2x16 tokens, [\d.]+ ms/token", out)
    assert m, out
    tokens = re.search(r"tokens\[0\]: \[(.*)\]", out).group(1).split(", ")
    assert len(tokens) == 16


def test_continuous_batching():
    out = _run("continuous_batching_torch.py")
    assert "granite-8b reduced | 3 slots | stats=" in out
    assert "'completed': 6" in out and "'prefills': 6" in out


def _small(monkeypatch):
    """FLConfig cut to a dense task, 3 clients, 90 images, one round."""
    real = api.FLConfig

    def small(**kw):
        kw.update(task="mlp", n_clients=3, n_train=90, n_test=30,
                  max_rounds=1, mh_pop=2, mh_generations=1, local_epochs=1)
        return real(**kw)
    monkeypatch.setattr(core, "FLConfig", small)


def test_quickstart(monkeypatch, capsys):
    _small(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["quickstart_torch.py", "--device",
                                      "cpu"])
    runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"))
    out = capsys.readouterr().out
    assert "round engine = " in out and "FedBWO | 3 clients" in out
    assert re.search(r"rounds=1  uplink=[\d,]+ bytes", out)
    assert "final accuracy = " in out


def test_fl_cifar_comparison(monkeypatch, capsys):
    _small(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["fl_cifar_comparison_torch.py",
                                      "--fast", "--rounds", "1", "--device",
                                      "cpu"])
    runpy.run_path(str(ROOT / "examples" / "fl_cifar_comparison_torch.py"))
    out = capsys.readouterr().out
    table = out.split("--- paper Figs. 4-6 analogue (synthetic data) ---")[1]
    rows = [line.split() for line in table.strip().splitlines()[1:]]
    assert sorted(r[0] for r in rows) == sorted(api.strategy_names())
    assert all(r[1] == "1" for r in rows)
