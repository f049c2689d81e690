"""The port's dry run (``repro_torch.launch.dryrun``) at reduced archs on
small fake meshes, held against the reference's lowered steps, on the CPU.

The reference lowers and compiles each step with its rules on a host mesh
of 8 devices in a subprocess (``XLA_FLAGS`` forces the device count); the
port runs the same step once over a fake world of 8 ranks in this process.
Per device:

* argument bytes equal ``compiled.memory_analysis().argument_size_in_bytes``;
* the products' FLOPs (dots outside attention) agree within 2 % for
  prefill and decode and 5 % for train.  Attention is the one op class that
  differs, and is held on its own: the reference's blockwise attention
  multiplies every (query block, key) pair, the port's flash kernel counts
  the pairs its mask keeps.  The reference's attention FLOPs are its dots
  less those of the same step lowered with GQA's attention swapped for a
  stand-in without products (MLA's stays: both packages run it plainly).
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import random, tree
from repro_torch.configs import ARCHS, InputShape, get_arch
from repro_torch.launch import dryrun
from repro_torch.models import moe as moe_lib
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tr_lib
from repro_torch.models.transformer import build_model

ROOT = Path(__file__).resolve().parents[1]
B, S, MESH = 8, 64, (2, 4)
# (arch, mode): the dense GQA model, MoE with MLA, Mamba with MoE
CHECKED = [("olmo-1b", "train"), ("olmo-1b", "prefill"), ("olmo-1b", "decode"),
           ("deepseek-v2-236b", "train"), ("deepseek-v2-236b", "decode"),
           ("jamba-v0.1-52b", "train"), ("jamba-v0.1-52b", "decode")]
PRODUCTS_TOL = {"train": 0.05, "prefill": 0.02, "decode": 0.02}
# reduced archs whose dry run DTensor cannot take, by the op without a rule
KNOWN_FAILURES = {("xlstm-1.3b", "train"): "log_sigmoid_forward",
                  ("xlstm-1.3b", "decode"): "log_sigmoid_forward"}

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_arch
    from repro.configs.base import InputShape
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import (input_specs, make_prefill_step,
                                    make_serve_step, make_train_step)
    from repro.models.transformer import build_model
    import repro.models.attention as attn
    import repro.models.moe as moe
    from repro.sharding import mesh_context, rules

    # the reference's MoE mesh branch passes check_vma, which this JAX's
    # experimental shard_map names check_rep; jax.shard_map takes it
    moe.shard_map = jax.shard_map
    blockwise = attn.blockwise_attention

    def no_products(q, k, v, **kw):
        # GQA's attention without products, same shape, on q, k and v
        # alike (so no projection is dead code); MLA's (its v narrower
        # than q) as it is
        if q.shape[-1] != v.shape[-1]:
            return blockwise(q, k, v, **kw)
        rep = q.shape[2] // k.shape[2]
        kv = (k.astype(jnp.float32) + v.astype(jnp.float32)).mean(
            1, keepdims=True)
        return (q + jnp.repeat(kv, rep, axis=2)).astype(q.dtype)

    def tree_sh(mesh, t, rule):
        return jax.tree_util.tree_map_with_path(
            lambda p, l: NamedSharding(mesh, rule(mesh, p, l)), t)

    def lower(arch, mode, B, S, mesh):
        cfg = get_arch(arch).reduced()
        shape = InputShape("x", S, B, mode)
        max_seq = S + (cfg.vision_tokens if mode != "decode" else 0)
        model = build_model(cfg, max_seq=max_seq)
        key = jax.random.PRNGKey(0)
        with mesh_context(mesh):
            if mode == "train":
                step, init = make_train_step(model)
                st = jax.eval_shape(init, key)
                sh = rules.state_shardings(mesh, st)
                batch = input_specs(cfg, shape)
                fn = jax.jit(step, in_shardings=(
                    sh, tree_sh(mesh, batch, rules.batch_spec)),
                    out_shardings=(sh, None), donate_argnums=(0,))
                lowered = fn.lower(st, batch)
            elif mode == "prefill":
                ps = jax.eval_shape(model.init, key)
                batch = input_specs(cfg, shape)
                fn = jax.jit(make_prefill_step(model, max_len=max_seq),
                             in_shardings=(
                                 tree_sh(mesh, ps, rules.param_spec),
                                 tree_sh(mesh, batch, rules.batch_spec)))
                lowered = fn.lower(ps, batch)
            else:
                ps = jax.eval_shape(model.init, key)
                cs = jax.eval_shape(lambda: model.cache_init(B, S))
                csh = tree_sh(mesh, cs, rules.cache_spec)
                tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
                pos = jax.ShapeDtypeStruct((), jnp.int32)
                fn = jax.jit(make_serve_step(model), in_shardings=(
                    tree_sh(mesh, ps, rules.param_spec),
                    NamedSharding(mesh, rules.batch_spec(mesh, (), tok)),
                    csh, NamedSharding(mesh, P())),
                    out_shardings=(None, csh), donate_argnums=(2,))
                lowered = fn.lower(ps, tok, cs, pos)
            return lowered.compile()

    sizes, combos = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(sizes),
                ("data", "model"))
    out = {}
    for arch, mode, B, S in combos:
        compiled = lower(arch, mode, B, S, mesh)
        dots = analyze(compiled.as_text(), 8).dot_flops
        attn.blockwise_attention = no_products
        products = analyze(lower(arch, mode, B, S, mesh).as_text(),
                           8).dot_flops
        attn.blockwise_attention = blockwise
        out[f"{arch}|{mode}"] = {
            "argument_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
            "dot_flops": dots, "products": products}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    """The reference's figures for CHECKED, from a subprocess started
    before the port's runs (they overlap)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(MESH),
         json.dumps([[a, m, B, S] for a, m in CHECKED])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    got = {}

    def result():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port(reference):
    """Every reduced arch's train and decode dry run (and OLMo's prefill)
    on the (2, 4) mesh: the result, or the error it raised."""
    out = {}
    try:
        for arch in ARCHS:
            for mode in ("train", "decode") + (
                    ("prefill",) if arch == "olmo-1b" else ()):
                try:
                    out[arch, mode] = dryrun.lower_combo(
                        arch, mode, cfg=get_arch(arch).reduced(),
                        shape=InputShape(mode, S, B, mode), mesh_shape=MESH)
                except Exception as e:              # noqa: BLE001
                    out[arch, mode] = e
    finally:
        dryrun.close_world()
    return out


def _flash_flops(res) -> float:
    k = res["cost"]["kernels"]
    return sum(k[n]["flops"] for n in ("flash_attention",
                                       "flash_attention_bwd") if n in k)


def test_every_reduced_arch_runs_or_fails_loudly(port):
    """Each reduced arch's train and decode dry run completes, except the
    known ones, each of which raises where DTensor has no rule."""
    failed = {k: v for k, v in port.items() if isinstance(v, Exception)}
    assert set(failed) == set(KNOWN_FAILURES), {
        k: repr(v)[:200] for k, v in failed.items()}
    for key, op in KNOWN_FAILURES.items():
        assert isinstance(failed[key], NotImplementedError)
        assert op in str(failed[key])
    for key, res in port.items():
        if key not in failed:
            assert res["cost"]["flops_per_device"] > 0, key
            assert res["chips"] == 8 and res["mesh"] == "pod2x4"


@pytest.mark.parametrize("arch,mode", CHECKED)
def test_argument_bytes_equal_the_references(port, reference, arch, mode):
    got = port[arch, mode]["memory"]["argument_bytes_per_device"]
    assert got == reference()[f"{arch}|{mode}"]["argument_bytes"]


@pytest.mark.parametrize("arch,mode", CHECKED)
def test_product_flops_agree_with_the_references(port, reference, arch,
                                                 mode):
    res, ref = port[arch, mode], reference()[f"{arch}|{mode}"]
    products = res["cost"]["flops_per_device"] - _flash_flops(res)
    assert products == pytest.approx(ref["products"],
                                     rel=PRODUCTS_TOL[mode])


def test_attention_is_held_on_its_own(port, reference):
    """OLMo's prefill: the reference multiplies every (query, key) pair of
    its one 64-query block, the kernel the S (S + 1) / 2 its causal mask
    keeps; at decode the reference pads the one query to a block of 8."""
    ref = reference()
    pre = ref["olmo-1b|prefill"]
    got = _flash_flops(port["olmo-1b", "prefill"])
    assert got == (pre["dot_flops"] - pre["products"]) * (S + 1) / (2 * S)
    dec = ref["olmo-1b|decode"]
    got = _flash_flops(port["olmo-1b", "decode"])
    assert got == (dec["dot_flops"] - dec["products"]) / 8
    for arch, mode in CHECKED:
        assert _flash_flops(port[arch, mode]) <= (
            ref[f"{arch}|{mode}"]["dot_flops"]
            - ref[f"{arch}|{mode}"]["products"])


def test_moe_decode_dispatches_expert_parallel(port):
    """DeepSeek-V2's decode on the mesh gathers the expert buffer over
    ``model`` (the combine), and its kernels-free MLA runs shard by
    shard."""
    res = port["deepseek-v2-236b", "decode"]
    kinds = res["collectives"]["by_kind"]
    assert kinds.get("all-gather", 0) > 0
    assert res["cost"]["kernels"] == {}


def test_fedx_round_sends_less_across_pods_than_sync_steps():
    """The FedX round (local steps with no cross-pod collective, one score
    all-gather and one weight broadcast over ``pod``) moves fewer bytes
    between pods than ``local_steps`` synchronous steps on the same
    (pod, data, model) mesh: the paper's Fig. 6 at pod scale."""
    cfg = get_arch("olmo-1b").reduced()
    shape = InputShape("train_4k", 32, 32, "train")
    try:
        fedx = dryrun.lower_fedx_round("olmo-1b", local_steps=2, cfg=cfg,
                                       shape=shape, mesh_shape=(2, 2, 2))
        sync = dryrun.lower_combo("olmo-1b", "train_4k", multi_pod=True,
                                  cfg=cfg, shape=shape, mesh_shape=(2, 2, 2))
    finally:
        dryrun.close_world()
    fx = fedx["collectives"]
    assert 0 < fx["cross_pod_link_bytes"] \
        < sync["collectives"]["cross_pod_link_bytes"] * 2
    assert set(fx["by_kind"]) >= {"broadcast", "all-gather"}
    # the weights cross once: each rank sends its shard of the parameters
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(
        build_model(cfg, 32).init(random.PRNGKey(0, "meta"))))
    assert fx["by_kind"]["broadcast"] <= nbytes


def _reference_keys(node) -> dict:
    """The keys of a dict literal, nested dicts as dicts."""
    return {k.value: (_reference_keys(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}


def _keys(d) -> dict:
    return {k: (_keys(v) if isinstance(v, dict) and k in (
        "memory", "cost", "collectives", "model") else None)
        for k, v in d.items()}


def test_cli_writes_the_references_keys_and_failed_files(tmp_path):
    """``main`` writes <arch>__<shape>__pod16x16.json with the reference's
    keys from one process at full width, and a combination that raises
    leaves .FAILED and exits 1."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "lower_combo")
    result = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "result")
    want = _reference_keys(result)

    assert dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "olmo-1b__decode_32k__pod16x16.json")
                     .read_text())
    assert got["chips"] == 256 and got["cost"]["flops_per_device"] > 0
    extra = {"kernels"}                 # the port's per-kernel figures
    got_keys = _keys(got)
    got_keys["cost"] = {k: v for k, v in got_keys["cost"].items()
                        if k not in extra}
    assert got_keys == want

    assert dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    failed = tmp_path / "xlstm-1.3b__decode_32k__pod16x16.json.FAILED"
    assert "Error: " in failed.read_text()
    assert not (tmp_path / "xlstm-1.3b__decode_32k__pod16x16.json").exists()
    assert not torch.distributed.is_initialized()


# ------------------------------------------------ no mesh: no change --
def _moe_apply_before(p, x, cfg, *, capacity_factor: float = 1.25):
    """``moe_apply`` as it was before the expert-parallel branch."""
    import torch.nn.functional as F
    m = cfg.moe
    Bx, Sx, d = x.shape
    E, K = m.num_experts, m.top_k
    rt = moe_lib.route(p, x, cfg, capacity_factor=capacity_factor)
    C = rt.capacity
    e_flat = rt.eidx.reshape(Bx, Sx * K)
    pos_c = rt.pos.clamp(max=C - 1)
    rows = ((torch.arange(Bx)[:, None] * E + e_flat) * C
            + pos_c).reshape(-1)
    contrib = x.repeat_interleave(K, dim=1) * rt.keep[..., None].to(x.dtype)
    xb = x.new_zeros((Bx * E * C, d)).index_add_(0, rows,
                                                 contrib.reshape(-1, d))
    xb = xb.reshape(Bx, E, C, d)
    h = (F.silu(torch.einsum("becd,edf->becf", xb, p["wg"]))
         * torch.einsum("becd,edf->becf", xb, p["wi"]))
    yb = torch.einsum("becf,efd->becd", h, p["wo"])
    y_slot = (yb.reshape(Bx * E * C, d)[rows].reshape(Bx, Sx * K, d)
              * rt.keep[..., None].to(yb.dtype))
    y = (y_slot.reshape(Bx, Sx, K, d)
         * rt.gate.to(yb.dtype)[..., None]).sum(2)
    if m.num_shared_experts:
        y = y + nn.ffn_apply("swiglu", p["shared"], x)
    if m.dense_residual:
        y = y + nn.ffn_apply("swiglu", p["dense"], x)
    return y, rt.aux


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "arctic-480b",
                                  "jamba-v0.1-52b"])
def test_moe_without_a_mesh_is_bit_for_bit_as_before(name):
    cfg = get_arch(name).reduced()
    key = random.PRNGKey(0, "cpu")
    p = moe_lib.moe_init(key, cfg)
    x = random.normal(random.PRNGKey(1, "cpu"), (2, 16, cfg.d_model)).to(
        cfg.param_dtype)
    y, aux = moe_lib.moe_apply(p, x, cfg)
    y0, aux0 = _moe_apply_before(p, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("name", list(ARCHS))
def test_model_sites_are_identities_without_a_mesh(monkeypatch, name):
    """Every reduced arch's forward (train mode, no gradient) is bit for bit
    the same with the model-site constraints (``constrain``, ``tp_weight``)
    taken out."""
    cfg = get_arch(name).reduced()
    model = build_model(cfg, max_seq=32 + cfg.vision_tokens)
    params = model.init(random.PRNGKey(0, "cpu"))
    batch = {"tokens": random.randint(random.PRNGKey(1, "cpu"), (2, 32), 0,
                                      cfg.vocab_size)}
    if cfg.vision_tokens:
        batch["image_embeds"] = random.normal(
            random.PRNGKey(2, "cpu"), (2, cfg.vision_tokens, cfg.d_model))
    if cfg.encoder_layers:
        batch["encoder_embeds"] = random.normal(
            random.PRNGKey(3, "cpu"), (2, cfg.encoder_seq, cfg.d_model))
    with torch.no_grad():
        got = model.apply(params, batch, mode="train")
        for mod in (nn, tr_lib, moe_lib):
            monkeypatch.setattr(mod, "constrain", lambda x, *a: x)
        monkeypatch.setattr(nn, "tp_weight", lambda p, *a: p)
        want = model.apply(params, batch, mode="train")
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
