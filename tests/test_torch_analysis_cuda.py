"""flcheck on the card: the block's CUDA graph read by the audit, a capture
that refuses a planted sync, a block that does not run, a block shape
captured twice, and an audited build's rounds against an unaudited one's.  No JAX here (the machine with the card has none); skips
where torch sees no CUDA device.  Run there without the JAX-importing
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_analysis_cuda.py
"""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as R, tree  # noqa: E402
from repro_torch.analysis.audit import audit_experiment  # noqa: E402
from repro_torch.analysis.report import AuditError  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.api import FLConfig, build_experiment  # noqa: E402

SMALL = dict(strategy="fedbwo", task="mlp", bwo_kernel=True, device="cuda",
             n_clients=3, n_train=90, n_test=30, mh_pop=2,
             mh_generations=1, local_epochs=1, rounds_per_dispatch=2,
             max_rounds=2, tau=1.01)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the audit reads a CUDA graph")


def _details(report, rule, subject):
    (f,) = [f for f in report.findings if f.rule == rule
            and f.subject == subject and f.severity == "info"]
    return f.details


@pytest.mark.cuda
def test_the_audit_reads_the_blocks_graph():
    _card()
    exp = build_experiment(FLConfig(**SMALL), audit="strict")
    report = exp.audit_report
    assert report.ok, report.render()
    sync = _details(report, "one-sync-per-block", "block[fedbwo x2]")
    # the vmap rule: one launch a generation for every client, 1 a round
    assert sync["kernels"]["bwo_evolve_kernel"] == sync["launches"] == 2
    assert sync["memcpy"].get("DtoH", 0) == 0
    assert sync["kinds"].get("HOST", 0) == 0
    reuse = _details(report, "donation-honored", "block[fedbwo x2]")
    assert reuse["ptrs_kept"]
    assert reuse["allocated_second"] <= reuse["allocated_first"]


@pytest.mark.cuda
def test_a_capture_that_refuses_a_planted_sync_is_an_error(monkeypatch):
    _card()
    exp = build_experiment(FLConfig(**SMALL))

    def split(key, num=2):
        out = R.split(key, num)
        out.sum().item()
        return out
    _planted_split(monkeypatch, split)
    report = audit_experiment(exp, lint=False)
    assert {"one-sync-per-block", "no-host-callback-in-scan"} <= \
        {f.rule for f in report.errors}
    assert any("capture failed" in f.message for f in report.errors
               if f.rule == "one-sync-per-block")


def _planted_split(monkeypatch, split):
    names = {k: getattr(R, k) for k in dir(R) if not k.startswith("__")}
    names["split"] = split
    monkeypatch.setattr(engine_mod, "random", types.SimpleNamespace(**names))


@pytest.mark.cuda
def test_a_block_that_does_not_run_is_an_error(monkeypatch):
    _card()
    exp = build_experiment(FLConfig(**SMALL))

    def split(key, num=2):
        raise RuntimeError("planted")
    _planted_split(monkeypatch, split)
    report = audit_experiment(exp, lint=False)
    block = "block[fedbwo x2]"
    for rule in ("one-sync-per-block", "donation-honored"):
        assert any(f.subject == block for f in report.errors
                   if f.rule == rule), report.render()
        assert not [f for f in report.findings if f.rule == rule
                    and f.subject == block and f.severity == "info"]
    assert any("did not run" in f.message for f in report.errors)
    with pytest.raises(AuditError):
        audit_experiment(exp, lint=False, strict=True)


@pytest.mark.cuda
def test_a_block_shape_captured_twice_is_an_error():
    _card()
    exp = build_experiment(FLConfig(**SMALL))
    assert audit_experiment(exp, compile=False, lint=False).ok
    server, eng = exp.server, exp.server._engine
    for n in (SMALL["n_test"], 10):    # then a shorter eval batch
        batch = tree.map(lambda a: a[:n], exp.eval_data)
        eng.run_block(server.global_params, server.rng, 2,
                      eval_batch=batch, eval_every=1)
    torch.cuda.synchronize()
    assert len(eng.graphs) == 2 and eng.captures == [eng.captures[0]] * 2
    report = audit_experiment(exp, compile=False, lint=False)
    assert [f.rule for f in report.errors] == ["compile-cache-stability"]
    assert eng.captures == [eng.captures[0]] * 2   # the audit restores it


@pytest.mark.cuda
def test_audited_rounds_equal_unaudited_rounds():
    _card()
    cudnn = torch.backends.cudnn
    saved, cudnn.deterministic = cudnn.deterministic, True
    try:
        runs = []
        for audit in ("strict", "off"):
            exp = build_experiment(FLConfig(**SMALL), audit=audit)
            logs = exp.run().logs
            runs.append((logs, tree.leaves(exp.server.global_params)))
    finally:
        cudnn.deterministic = saved
    (la, pa), (lu, pu) = runs
    assert [l.info for l in la] == [l.info for l in lu]
    assert all(torch.equal(a, b) for a, b in zip(pa, pu))
