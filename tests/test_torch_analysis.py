"""flcheck in the port against the reference's: the findings model, the
pure rule cores, each rule's known-bad fixture at the reference's severity,
both lints on paired snippets, the op recorder, the CUDA graph parser (on
dumps taken on an H100, ``tests/data/``), and no float64 in any round
program."""
import inspect
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import report as jreport  # noqa: E402
from repro.analysis import rules as jrules  # noqa: E402
from repro.analysis.audit import AuditContext as JContext  # noqa: E402
from repro.analysis.audit import ProgramSubject as JSubject  # noqa: E402
from repro.analysis.pylint_jax import lint_source as jlint  # noqa: E402

from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.analysis import rules as trules  # noqa: E402
from repro_torch.analysis.audit import (AuditContext, ProgramSubject,  # noqa: E402
                                        collect_subjects)
from repro_torch.analysis.pylint_torch import lint_source as tlint  # noqa: E402
from repro_torch.analysis.walker import (CONV_OPS, count_ops, has_op,  # noqa: E402
                                         iter_dtypes, iter_sites,
                                         loss_uses_conv, record_ops)
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.core.api import FLConfig, build_experiment  # noqa: E402
from repro_torch.data.synthetic import cnn_task, mlp_task  # noqa: E402
from repro_torch.launch.graph_analysis import (BlockGraph, BufferReuse,  # noqa: E402
                                               count_host_transfers,
                                               kernel_name, parse_graph_dot)

DATA = Path(__file__).resolve().parent / "data"
NARROW = dict(conv1_filters=4, conv2_filters=8, dense_hidden=16)
RULE_NAMES = ["one-sync-per-block", "donation-honored", "no-f64",
              "no-weak-type-promotion", "no-host-callback-in-scan",
              "conv-policy", "compile-cache-stability"]


def _dicts(findings):
    return [f.to_dict() for f in findings]


def _worst(findings, rule):
    order = {"info": 0, "warning": 1, "error": 2}
    sev = [f.severity for f in findings if f.rule == rule]
    return max(sev, key=order.get) if sev else None


# ------------------------------------------------------------ the report --
def test_render_and_json_equal_the_references_for_the_same_findings():
    rng = np.random.default_rng(24)
    args = []
    for k in range(12):
        args.append((str(rng.choice(RULE_NAMES)),
                     str(rng.choice(["info", "warning", "error"])),
                     f"message {k}", str(rng.choice(["", "round[fedbwo]"])),
                     str(rng.choice(["", f"mod.py:{k}"])),
                     None if k % 3 else {"n": int(rng.integers(9))}))
    j = jreport.Report([jreport.Finding(*a) for a in args])
    t = treport.Report([treport.Finding(*a) for a in args])
    assert t.render() == j.render()
    assert t.render(show_info=True) == j.render(show_info=True)
    assert t.to_json() == j.to_json()
    assert (t.ok, t.counts()) == (j.ok, j.counts())
    assert str(treport.AuditError(t)) == str(jreport.AuditError(j))
    with pytest.raises(ValueError):
        treport.Finding("r", "fatal", "bad severity")


# --------------------------------------------------------- the pure cores --
@pytest.mark.parametrize("has_conv,backend,engine", itertools.product(
    [True, False], ["cpu", "gpu"], ["batched", "sequential"]))
def test_conv_policy_core_equals_the_references(has_conv, backend, engine):
    assert _dicts(trules.check_conv_policy(has_conv, backend, engine, "s")) \
        == _dicts(jrules.check_conv_policy(has_conv, backend, engine, "s"))


def test_cache_stability_core_equals_the_references():
    rng = np.random.default_rng(7)
    a, b = (("(4, 8)", "float32"),), (("(3, 8)", "float32"),)
    cases = [([a, a, a], [4]), ([a, b], []), ([a, a], [4, 4]),
             ([b, a, a], [3, 4, 3, 4]), ([a], [])]
    for _ in range(6):
        sigs = [a if rng.random() < 0.8 else b for _ in range(4)]
        cases.append((sigs, list(rng.integers(1, 4, size=rng.integers(4)))))
    for sigs, counts in cases:
        counts = [int(c) for c in counts]
        assert _dicts(trules.check_cache_stability(sigs, counts, "s")) == \
            _dicts(jrules.check_cache_stability(sigs, counts, "s"))


# ------------------------------------------------ known-bad fixtures --
def _jctx(*subjects, engine="batched"):
    return JContext(subjects=list(subjects), backend="cpu", engine=engine,
                    strategy="fedbwo", task="mlp")


def _tctx(*subjects, device="cpu", engine="batched", server=None):
    return AuditContext(subjects=list(subjects), device=device,
                        engine=engine, strategy="fedbwo", task="mlp",
                        server=server)


def _jsubject(fn, *args, compile=True, **kw):
    jit = jax.jit(fn)
    return JSubject(name="prog", jaxpr=jax.make_jaxpr(fn)(*args),
                    hlo=jit.lower(*args).compile().as_text()
                    if compile else None, **kw)


def _tsubject(fn, *args, **kw):
    ops, _ = record_ops(fn, *args)
    return ProgramSubject(name="prog", ops=ops, **kw)


def _jscan_with_callback(xs):
    def body(c, x):
        jax.debug.callback(lambda v: None, c)
        return c + x, x
    return jax.lax.scan(body, jnp.float32(0), xs)


def make_fused_rounds(n_rounds, host_read=True):
    """A fixture in the shape of the engine's fused loop (the recorder
    knows it by its qualified name): R rounds, one host read each."""
    def block_fn(x):
        for i in range(n_rounds):
            x = x * 2 + 1
            if host_read:
                x.sum().item()
        return x
    return block_fn


class _Engine:
    """The engine attributes the cache rule reads."""
    def __init__(self, captures):
        self.n_participants, self.n_clients = 2, 3
        self.device = torch.device("cpu")
        self.data = {"x": torch.zeros(3, 4, 5)}
        self.mask = None
        self.captures = captures


class _Server:
    def __init__(self, captures):
        self._engine = _Engine(captures)


def _jax_no_f64_severity():
    code = textwrap.dedent("""\
        import json, jax
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        from repro.analysis.audit import AuditContext, ProgramSubject
        from repro.analysis.rules import run_rules
        s = ProgramSubject(name="x64", jaxpr=jax.make_jaxpr(
            lambda x: x * 2.0)(np.float64(1.0)))
        f = run_rules(AuditContext(subjects=[s], backend="cpu"),
                      only=("no-f64",))
        print(json.dumps(sorted({x.severity for x in f})))
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    sev = json.loads(out.stdout.strip().splitlines()[-1])
    return "error" if "error" in sev else sev[-1]


def _reference_bad(rule):
    """The reference's known-bad fixture for ``rule`` (its tests'), and the
    worst severity it gives."""
    x = jnp.zeros((4,), jnp.float32)
    if rule == "one-sync-per-block":
        def with_callback(x):
            jax.debug.callback(lambda v: None, x)
            return x * 2
        f = jrules.run_rules(_jctx(_jsubject(with_callback, x)), only=(rule,))
    elif rule == "donation-honored":
        f = jrules.check_donation("HloModule jit_f\nENTRY %main () -> f32[2] {}",
                                  expect_donation=True)
    elif rule == "no-f64":
        return _jax_no_f64_severity()
    elif rule == "no-weak-type-promotion":
        s = JSubject(name="weak", jaxpr=jax.make_jaxpr(lambda x: x * 2)(1.0))
        f = jrules.run_rules(_jctx(s), only=(rule,))
    elif rule == "no-host-callback-in-scan":
        s = _jsubject(_jscan_with_callback, jnp.zeros(5, jnp.float32),
                      compile=False)
        f = jrules.run_rules(_jctx(s), only=(rule,))
        assert any("x5" in e.message for e in f if e.severity == "error")
    elif rule == "conv-policy":
        def convf(x, k):
            return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME")
        s = _jsubject(convf, jnp.zeros((1, 1, 8, 8), jnp.float32),
                      jnp.zeros((1, 1, 3, 3), jnp.float32), compile=False,
                      is_round=True)
        f = jrules.run_rules(_jctx(s), only=(rule,))
    else:
        f = jrules.check_cache_stability([(("(4, 8)", "float32"),),
                                          (("(3, 8)", "float32"),)])
    return _worst(f, rule)


def _port_bad(rule):
    """The port's known-bad torch fixture for ``rule``, and the worst
    severity it gives."""
    x = torch.zeros(4)
    if rule == "one-sync-per-block":
        f = trules.run_rules(_tctx(_tsubject(lambda x: float(x.sum().item())
                                             + 1, x)), only=(rule,))
    elif rule == "donation-honored":
        f = trules.check_donation(BufferReuse(True, 100, 164),
                                  expect_donation=True)
        assert trules.check_donation(BufferReuse(False, 100, 100), True)[0] \
            .severity == "error"
    elif rule == "no-f64":
        f = trules.run_rules(_tctx(_tsubject(lambda x: x.double() * 2, x)),
                             only=(rule,))
    elif rule == "no-weak-type-promotion":
        # an int tensor and a python float: the output promotes to float32
        s = _tsubject(lambda x: x + 1.5, torch.zeros(4, dtype=torch.int64))
        s.outputs, s.declared = {"out": "float32"}, {"out": "int64"}
        f = trules.run_rules(_tctx(s), only=(rule,))
    elif rule == "no-host-callback-in-scan":
        f = trules.run_rules(_tctx(_tsubject(make_fused_rounds(5), x)),
                             only=(rule,))
        assert any("x5" in e.message for e in f if e.severity == "error")
    elif rule == "conv-policy":
        s = _tsubject(torch.nn.functional.conv2d, torch.zeros(1, 1, 8, 8),
                      torch.zeros(1, 1, 3, 3), is_round=True)
        f = trules.run_rules(_tctx(s), only=(rule,))
    else:
        f = trules.run_rules(_tctx(server=_Server([(5, 1), (5, 1)])),
                             only=(rule,))
    return _worst(f, rule)


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_known_bad_fixture_fires_at_the_references_severity(rule):
    want = _reference_bad(rule)
    assert want in ("error", "warning")
    assert _port_bad(rule) == want
    assert trules.RULES[rule].rule_name == rule


def test_the_catalogue_has_the_references_names_in_its_order():
    assert list(trules.RULES) == list(jrules.RULES) == RULE_NAMES


def test_known_good_fixtures_are_clean():
    x = torch.zeros(4)
    clean = _tsubject(make_fused_rounds(5, host_read=False), x,
                      is_round=True, is_fused=True)
    clean.outputs = clean.declared = {"out": "float32"}
    findings = trules.run_rules(_tctx(clean, server=_Server([(5, 1)])))
    assert not [f for f in findings if f.severity != "info"]
    assert set(trules.RULES) <= {f.rule for f in findings}
    assert trules.check_donation(BufferReuse(True, 100, 100), True)[0] \
        .severity == "info"
    assert trules.check_donation(None, False)[0].severity == "info"


# ----------------------------------------------------------- the lints --
LINT_PAIRS = {
    "decorated": ("""\
        import jax

        @jax.jit
        def step(x):
            return float(x) + 1
        """, """\
        import torch

        @torch.library.custom_op("ns::step", mutates_args=())
        def step(x):
            return float(x) + 1
        """),
    "shapes and the allow comment": ("""\
        import jax

        @jax.jit
        def step(pop, frac):
            P, D = pop.shape
            keep = int(P * frac)
            n = int(len(pop.shape))
            bad = float(pop)  # flcheck: ok
            return keep + n
        """, """\
        import torch

        @torch.func.vmap
        def step(pop, frac):
            P, D = pop.shape
            keep = int(P * frac)
            n = int(pop.dim() + pop.numel())
            bad = pop.item()  # flcheck: ok
            return keep + n
        """),
    "a combinator": ("""\
        import jax

        def body(c, x):
            return c + int(x), x

        def run(xs):
            return jax.lax.scan(body, 0, xs)
        """, """\
        import torch

        def body(c, x):
            return c + x.item(), x

        def run(xs):
            return torch.func.vmap(body)(0, xs)
        """),
    "nested": ("""\
        import jax
        import numpy as np

        def outer(x):
            def inner(y):
                return np.asarray(y)
            return inner(x)

        run = jax.jit(outer)
        """, """\
        import torch
        import numpy as np

        def outer(x):
            def inner(y):
                return y.cpu()
            return inner(x)

        run = torch.func.grad(outer)
        """),
    "a graph capture": ("""\
        import jax

        def step(x):
            return bool(x)

        def run(x):
            return jax.jit(step)(x)
        """, """\
        import torch

        def step(x):
            return bool(x)

        def run(g, x):
            with torch.cuda.graph(g):
                return step(x)
        """),
    "paired conversions": ("""\
        def fetch(a, b):
            return float(a), float(b)
        """, """\
        def fetch(a, b):
            return float(a), float(b)
        """),
    "paired conversions after one copy": ("""\
        import jax

        def fetch(a, b):
            a, b = jax.device_get((a, b))
            return float(a), float(b)
        """, """\
        import torch

        def fetch(a, b):
            a, b = torch.stack([a, b]).cpu()
            return float(a), float(b)
        """),
    "mutable defaults": ("""\
        import jax.numpy as jnp

        def f(x, init=jnp.zeros((3,)), acc=[]):
            return x
        """, """\
        import torch

        def f(x, init=torch.zeros(3), acc=[]):
            return x
        """),
}


@pytest.mark.parametrize("case", list(LINT_PAIRS))
def test_lints_agree_on_paired_snippets(case):
    jsrc, tsrc = (textwrap.dedent(s) for s in LINT_PAIRS[case])

    def key(findings):
        return sorted((f.rule, f.severity, f.location) for f in findings)
    assert key(tlint(tsrc, "mod.py")) == key(jlint(jsrc, "mod.py"))


def test_engine_block_and_round_functions_are_traced():
    src = textwrap.dedent("""\
        def make(n):
            def round_fn(x):
                return x.tolist()

            def block_fn(x):
                return int(x)
            return round_fn, block_fn
        """)
    found = tlint(src, "engine.py")
    assert sorted((f.rule, f.location) for f in found) == [
        ("host-conversion-in-jit", "engine.py:3"),
        ("host-conversion-in-jit", "engine.py:6")]


def test_the_port_lints_clean():
    from repro_torch.analysis.pylint_torch import lint_paths
    assert [f.to_dict() for f in lint_paths()] == []


# ------------------------------------------------------- the op recorder --
def test_sites_count_rounds_of_the_fused_loop():
    rec, _ = record_ops(make_fused_rounds(5), torch.zeros(3))
    reads = [s for s in iter_sites(rec) if s.host_read]
    assert len(reads) == 1 and reads[0].multiplier == 5 and reads[0].in_loop
    lines, first = inspect.getsourcelines(make_fused_rounds)
    item = first + next(k for k, l in enumerate(lines) if ".item()" in l)
    assert reads[0].location == f"{Path(__file__).name}:{item}"
    assert count_ops(rec, ("aten._local_scalar_dense",), weighted=True) == \
        {"aten._local_scalar_dense": 5}
    assert count_ops(rec, ("aten._local_scalar_dense",)) == \
        {"aten._local_scalar_dense": 1}
    # outside the fused loop nothing is in a loop, however often it fires
    rec, _ = record_ops(lambda x: [x.sum().item() for _ in range(3)],
                        torch.zeros(3))
    (read,) = [s for s in iter_sites(rec) if s.host_read]
    assert read.multiplier == 3 and not read.in_loop


def test_has_op_and_dtypes():
    rec, _ = record_ops(lambda x: torch.sin(x) + 1, torch.zeros(3))
    assert has_op(rec, ("aten.sin",)) and not has_op(rec, CONV_OPS)
    assert set(iter_dtypes(rec)) == {"float32"}


def test_a_host_read_and_its_control():
    """Indexing by a 0-dim tensor reads it on the host; the same gather by
    ``index_select`` does not (the port's ``take``)."""
    from repro_torch.metaheuristics.base import take
    a, i = torch.arange(6.0).reshape(3, 2), torch.tensor(1)
    rec, _ = record_ops(lambda: a[i])
    assert [s.op for s in iter_sites(rec) if s.host_read] == \
        ["aten._local_scalar_dense"]
    rec, got = record_ops(take, a, i)
    assert not [s for s in iter_sites(rec) if s.host_read]
    assert torch.equal(got, a[1])


def test_loss_uses_conv_drives_the_engine_policy():
    from repro_torch import random
    from repro_torch.core.engine import task_uses_conv
    key = random.PRNGKey(0, "cpu")
    batch = {"images": torch.zeros(2, 32, 32, 3),
             "labels": torch.zeros(2, dtype=torch.int32)}
    conv, dense = cnn_task(CNNConfig(**NARROW)), mlp_task()
    assert task_uses_conv(conv, conv.init_params(key), batch)
    assert not task_uses_conv(dense, dense.init_params(key), batch)

    def boom(params, batch):
        raise RuntimeError("no")
    assert loss_uses_conv(boom, None, batch)


# ----------------------------------------------------- CUDA graph dumps --
def test_parse_the_block_dump_excerpt():
    text = (DATA / "cuda_graph_block_excerpt.dot").read_text()
    nodes = parse_graph_dot(text)
    assert nodes.kinds == {"KERNEL": 9, "MEMCPY": 2}
    assert nodes.kernels["bwo_evolve_kernel"] == 2
    assert nodes.memcpy == {"DtoD": 2} and nodes.host_nodes == 0
    assert count_host_transfers(nodes) == {}


def test_parse_the_copies_dump():
    text = (DATA / "cuda_graph_copies.dot").read_text()
    nodes = parse_graph_dot(text)
    assert nodes.kinds == {"KERNEL": 5, "MEMCPY": 3}
    assert nodes.memcpy == {"DtoD": 1, "DtoH": 1, "HtoD": 1}
    assert nodes.kernels == {"vectorized_elementwise_kernel": 4,
                             "CatArrayBatchedCopy_vectorized": 1}
    assert count_host_transfers(nodes) == {"DtoH": 1}


@pytest.mark.parametrize("symbol,name", [
    ("_ZN2at6native29vectorized_elementwise_kernelILi4EEEviT0_",
     "vectorized_elementwise_kernel"),
    ("_ZN46_GLOBAL__N__cdc61492_13_bwo_evolve_cu_5484f9de17bwo_evolve_"
     "kernelEPKfPKiS3_PKjS5_S1_Pflljf", "bwo_evolve_kernel"),
    ("_Z9my_kernelPf", "my_kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_cublas",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_cublas")])
def test_kernel_name(symbol, name):
    assert kernel_name(symbol) == name


def _graph(dot, **kw):
    text = (DATA / dot).read_text()
    facts = dict(nodes=parse_graph_dot(text), launches=2,
                 static_dtypes=("float32", "int64"),
                 reuse=BufferReuse(True, 100, 100), sync_error=None)
    facts.update(kw)
    return BlockGraph(**facts)


def _card_block(**kw):
    return ProgramSubject(name="block[fedbwo x5]", is_round=True,
                          is_fused=True, expect_donation=True, **kw)


def test_graph_half_of_the_rules():
    ok = _card_block(graph=_graph("cuda_graph_block_excerpt.dot"))
    found = trules.run_rules(_tctx(ok, device="cuda"))
    assert not [f for f in found if f.severity != "info"]
    sync = [f for f in found if f.rule == "one-sync-per-block"]
    assert sync[0].details["kernels"]["bwo_evolve_kernel"] == 2
    bad = {
        "one-sync-per-block": _card_block(
            graph=_graph("cuda_graph_copies.dot")),
        "no-f64": _card_block(graph=_graph(
            "cuda_graph_block_excerpt.dot",
            static_dtypes=("float32", "float64"))),
        "donation-honored": _card_block(graph=_graph(
            "cuda_graph_block_excerpt.dot",
            reuse=BufferReuse(True, 100, 200)))}
    for rule, subject in bad.items():
        assert _worst(trules.run_rules(_tctx(subject, device="cuda"),
                                       only=(rule,)), rule) == "error"
    for s in (_card_block(graph=_graph("cuda_graph_block_excerpt.dot",
                                       sync_error="RuntimeError: sync")),
              _card_block(graph_error="the capture failed: boom")):
        found = trules.run_rules(_tctx(s, device="cuda"),
                                 only=("one-sync-per-block",))
        assert _worst(found, "one-sync-per-block") == "error"
    # a capture that failed leaves no reuse to check: an error, not info
    failed = _card_block(graph_error="the capture failed: boom")
    assert _worst(trules.run_rules(_tctx(failed, device="cuda"),
                                   only=("donation-honored",)),
                  "donation-honored") == "error"
    # a block that did not run on the card has no ops and no graph: both
    # rules give errors, not the info of a graph half left out
    not_run = _card_block(graph_error="the block did not run: could not "
                                      "run: RuntimeError: boom")
    found = trules.run_rules(_tctx(not_run, device="cuda"), only=(
        "one-sync-per-block", "donation-honored"))
    for rule in ("one-sync-per-block", "donation-honored"):
        assert _worst(found, rule) == "error"
    assert not [f for f in found if f.severity == "info"]
    # on the CPU there is no graph: info
    cpu = ProgramSubject(name="block[fedbwo x5]", is_fused=True)
    assert _worst(trules.run_rules(_tctx(cpu), only=(
        "one-sync-per-block", "donation-honored")),
        "one-sync-per-block") == "info"


# -------------------------------------------- no float64 in round programs --
def _small(**kw):
    base = dict(task="mlp", strategy="fedbwo", n_clients=3, n_train=60,
                n_test=20, batch_size=10, local_epochs=1, mh_pop=2,
                mh_generations=2, max_rounds=2, rounds_per_dispatch=2,
                engine="batched", device="cpu")
    base.update(kw)
    return FLConfig(**base)


@pytest.mark.parametrize("case", ["fedbwo kernel", "fedbwo composed",
                                  "fedavg dropout"])
def test_round_programs_make_no_float64_tensor(case):
    cfg, task = {
        "fedbwo kernel": (_small(bwo_kernel=True), mlp_task(hidden=8)),
        "fedbwo composed": (_small(), mlp_task(hidden=8)),
        "fedavg dropout": (_small(strategy="fedavg", task="cnn",
                                  client_ratio=0.6),
                           cnn_task(CNNConfig(**NARROW)))}[case]
    exp = build_experiment(cfg, task=task)
    subjects = collect_subjects(exp.server, eval_data=exp.eval_data)
    assert [s.name for s in subjects] == [
        f"round[{cfg.strategy}]", f"block[{cfg.strategy} x2]", "eval"]
    for s in subjects:
        assert "float64" not in set(iter_dtypes(s.ops)), s.name
    ops = {s.op for s in iter_sites(subjects[0].ops)}
    if case == "fedbwo kernel":
        # the CPU's engine loops over the clients: one op a generation
        # and client (the card's vmap rule makes it one a generation)
        assert count_ops(subjects[0].ops, ("repro_torch.bwo_evolve",),
                         weighted=True)["repro_torch.bwo_evolve"] == 3 * 2
    if case == "fedavg dropout":
        assert {"aten.convolution"} & ops and has_op(subjects[0].ops,
                                                    ("aten.where",))
