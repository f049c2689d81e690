"""flcheck end to end, the port against the reference: the configs of the
reference's end-to-end audit tests (``tests/test_analysis.py``) built and
audited by both packages (on a narrower 2NN, passed to both), and the
ledgers an audit must leave as it found them."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.analysis.rules as jrules  # noqa: E402
from repro.analysis import AuditError as JAuditError  # noqa: E402
from repro.analysis import Finding as JFinding  # noqa: E402
from repro.analysis.audit import audit_experiment as jaudit  # noqa: E402
from repro.analysis.audit import collect_subjects as jcollect  # noqa: E402
from repro.core.api import FLConfig as JConfig  # noqa: E402
from repro.core.api import build_experiment as jbuild  # noqa: E402
from repro.data.synthetic import mlp_task as jmlp  # noqa: E402

import repro_torch.analysis.rules as trules  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.analysis import AuditError, Finding  # noqa: E402
from repro_torch.analysis.audit import (audit_experiment,  # noqa: E402
                                        collect_subjects)
from repro_torch.core.api import FLConfig, build_experiment  # noqa: E402
from repro_torch.data.synthetic import mlp_task  # noqa: E402
from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel  # noqa: E402

HIDDEN = 8


def _small(**kw):
    """The reference's ``_small_cfg``."""
    base = dict(task="mlp", strategy="fedbwo", n_clients=4, n_train=240,
                n_test=60, batch_size=8, local_epochs=1, mh_pop=2,
                mh_generations=1, max_rounds=3)
    base.update(kw)
    return base


def _pair(**kw):
    cfg = _small(**kw)
    return (jbuild(JConfig(**cfg), task=jmlp(hidden=HIDDEN)),
            build_experiment(FLConfig(**cfg, device="cpu"),
                             task=mlp_task(hidden=HIDDEN)))


def _named(findings):
    return {f.subject for f in findings if f.subject}


def _bad(findings):
    return sorted((f.rule, f.severity, f.subject) for f in findings
                  if f.severity != "info")


def test_fused_pipelined_mlp_build_audits_clean_in_both():
    jexp, texp = _pair(rounds_per_dispatch=3, pipeline_blocks="on")
    jrep = jaudit(jexp, lint=False)
    trep = audit_experiment(texp, lint=False)
    assert jrep.ok and trep.ok, trep.render()
    assert _named(trep.findings) == _named(jrep.findings)
    assert {"round[fedbwo]", "block[fedbwo x3]", "eval"} <= \
        _named(trep.findings)
    assert set(trules.RULES) <= {f.rule for f in trep.findings}
    assert set(jrules.RULES) <= {f.rule for f in jrep.findings}
    assert _bad(trep.findings) == _bad(jrep.findings) == []


def test_audit_leaves_the_server_as_it_found_it():
    """The reference keeps its trace ledger; the port its capture ledger,
    its graphs, the kernel's launch counter, and the server's state."""
    jexp, texp = _pair(strategy="fedavg")
    before = list(jexp.server._engine.traced_participant_counts)
    assert jaudit(jexp, compile=False, lint=False).ok
    assert jexp.server._engine.traced_participant_counts == before
    server, eng = texp.server, texp.server._engine
    eng.captures.append(("a key",))
    state = (tree.map(torch.clone, server.global_params), server.rng.clone(),
             server.rounds_completed, list(eng.captures), dict(eng.graphs),
             bwo_kernel.launches)
    assert audit_experiment(texp, lint=False).ok
    params, rng, done, captures, graphs, launches = state
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(server.global_params), tree.leaves(params)))
    assert torch.equal(server.rng, rng) and server.rounds_completed == done
    assert eng.captures == captures and eng.graphs == graphs
    assert bwo_kernel.launches == launches


def test_strict_raises_on_a_planted_rule_in_both(monkeypatch):
    jexp, texp = _pair(rounds_per_dispatch=2)
    monkeypatch.setitem(jrules.RULES, "planted",
                        lambda ctx: [JFinding("planted", "error", "boom")])
    monkeypatch.setitem(trules.RULES, "planted",
                        lambda ctx: [Finding("planted", "error", "boom")])
    with pytest.raises(JAuditError, match="planted: boom"):
        jaudit(jexp, compile=False, lint=False, strict=True)
    with pytest.raises(AuditError, match="planted: boom"):
        audit_experiment(texp, lint=False, strict=True)


def test_sequential_engine_subjects_equal_the_references():
    jexp, texp = _pair(engine="sequential")
    jnames = [s.name for s in jcollect(jexp.server, eval_data=jexp.eval_data,
                                       compile=False)]
    tnames = [s.name for s in collect_subjects(texp.server,
                                               eval_data=texp.eval_data)]
    assert tnames == jnames == ["client_update[fedbwo]", "eval"]
    assert audit_experiment(texp, lint=False).ok
