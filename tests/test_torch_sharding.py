"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``), leaf by leaf.

Specs: ``param_spec``, ``cache_spec`` (bf16 and int8 caches),
``batch_spec`` and ``state_shardings`` for every arch in ``configs/``,
reduced (real trees) and at full width (``jax.eval_shape`` beside the
port's meta-device trees), on (2, 4), (2, 2, 2) with ``pod``, (16, 16)
and (2, 16, 16) meshes: ``jax.sharding.AbstractMesh(axis_sizes,
axis_names)`` on the reference's side, ``AbstractMesh`` on the port's.
Then ``constrain``, the filter and the mesh context; and 8 gloo ranks
on the CPU, where each leaf of a reduced arch's train state is
distributed as the rules say and each rank's shard must equal the full
tensor at the reference's ``NamedSharding.devices_indices_map`` entry for
the same device (the reference in a subprocess with 8 host devices).
Every comparison is exact.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding.context import constrain as jconstrain  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.sharding import (batch_axes, constrain,  # noqa: E402
                                  current_mesh, mesh_context, rules)
from repro_torch.sharding.context import (AbstractMesh, _filter,  # noqa: E402
                                          placements)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = sorted(jconfigs.ARCHS)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MAX_SEQ = 64
CACHE = (2, 32)                       # batch, positions


def _arch(name, full):
    cfg, jcfg = get_arch(name), jconfigs.get_arch(name)
    return (cfg, jcfg) if full else (cfg.reduced(), jcfg.reduced())


_TREES = {}


def _trees(name, full):
    """Train state and caches (bf16, int8) of both packages: the port's on
    the meta device, the reference's by ``jax.eval_shape``."""
    if (name, full) not in _TREES:
        cfg, jcfg = _arch(name, full)
        jmodel, model = jbuild(jcfg, max_seq=MAX_SEQ), build_model(
            cfg, max_seq=MAX_SEQ)
        jstate = jax.eval_shape(jmake_train_step(jmodel)[1],
                                jax.random.PRNGKey(0))
        state = make_train_step(model)[1](R.PRNGKey(0, "meta"))
        caches = {q: (jax.eval_shape(lambda q=q: jmodel.cache_init(
                          *CACHE, quantized=q)),
                      model.cache_init(*CACHE, quantized=q, device="meta"))
                  for q in (False, True)}
        _TREES[name, full] = (jstate, state, caches)
    return _TREES[name, full]


def _jspecs(mesh, jtree, rule):
    specs = jax.tree_util.tree_map_with_path(
        lambda p, leaf: rule(mesh, p, leaf), jtree)
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _meshes(key):
    sizes, names = MESHES[key]
    return JAbstractMesh(sizes, names), AbstractMesh(sizes, names)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_state_specs_are_the_references(name, full, mesh):
    jstate, state, _ = _trees(name, full)
    jmesh, tmesh = _meshes(mesh)
    # the key paths the substring rules read, the optimizer's included
    paths = [rules._path_str(p) for p in tree.paths(state)]
    assert paths == [jrules._path_str(p) for p, _ in
                     jax.tree_util.tree_leaves_with_path(jstate)]
    assert any(p.startswith("opt/m/") for p in paths)
    assert [tuple(t.shape) for t in tree.leaves(state)] == [
        s.shape for s in jax.tree.leaves(jstate)]
    got = tree.leaves(rules.tree_specs(tmesh, state, rules.param_spec))
    assert got == _jspecs(jmesh, jstate, jrules.param_spec)
    want = [placements(tmesh, tuple(s.spec)) for s in
            jax.tree.leaves(jrules.state_shardings(jmesh, jstate))]
    assert tree.leaves(rules.state_shardings(tmesh, state)) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_are_the_references(name, full, quantized, mesh):
    _, _, caches = _trees(name, full)
    jcache, cache = caches[quantized]
    jmesh, tmesh = _meshes(mesh)
    assert [rules._path_str(p) for p in tree.paths(cache)] == [
        jrules._path_str(p) for p, _ in
        jax.tree_util.tree_leaves_with_path(jcache)]
    got = tree.leaves(rules.tree_specs(tmesh, cache, rules.cache_spec))
    assert got == _jspecs(jmesh, jcache, jrules.cache_spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_are_the_references(mesh):
    jmesh, tmesh = _meshes(mesh)
    for b in (1, 2, 3, 4, 8, 16, 32, 48, 512, 1024):
        shapes = {"tokens": (b, 64), "image_embeds": (b, 16, 32),
                  "labels": (b,), "scalar": ()}
        jbatch = {k: jax.ShapeDtypeStruct(s, np.float32)
                  for k, s in shapes.items()}
        batch = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        got = tree.leaves(rules.tree_specs(tmesh, batch, rules.batch_spec))
        assert got == _jspecs(jmesh, jbatch, jrules.batch_spec), b


# ------------------------------------------------------------ context --
def test_constrain_noop_without_mesh():
    x = torch.ones((4, 6))
    assert current_mesh() is None
    assert constrain(x, "data", None) is x
    np.testing.assert_array_equal(
        np.asarray(jconstrain(jax.numpy.ones((4, 6)), "data", None)),
        x.numpy())


def test_constrain_keeps_a_plain_tensor_and_checks_its_axes():
    x = torch.ones((4, 6))
    with mesh_context(AbstractMesh((2, 4), ("data", "model"))):
        assert constrain(x, "data", "model") is x
        with pytest.raises(AssertionError):
            constrain(x, "data")


@pytest.mark.parametrize("axis,dim,want", [
    (None, 8, None),
    ("data", 8, "data"),
    ("data", 3, None),                  # does not divide
    ("pod", 8, None),                   # not in the mesh
    (("pod", "data"), 8, ("data",)),    # pod dropped, data kept
    (("data", "model"), 8, ("data", "model")),
    (("data", "model"), 12, None),      # 2 x 4 does not divide 12
    (("pod",), 8, None),
    (["data"], 6, ("data",)),
])
def test_filter_drops_what_the_mesh_cannot_take(axis, dim, want):
    sizes, names = MESHES["2x4"]
    from repro.sharding.context import _filter as jfilter
    got = _filter(axis, AbstractMesh(sizes, names), dim)
    assert got == want
    assert got == jfilter(axis, JAbstractMesh(sizes, names), dim)


def test_batch_axes_follow_the_mesh_and_the_override():
    assert batch_axes() == ("data",)
    with mesh_context(AbstractMesh((2, 2, 2), ("pod", "data", "model"))):
        assert batch_axes() == ("pod", "data")
        with mesh_context(AbstractMesh((2, 4), ("data", "model")),
                          batch_axes_override=("data",)):
            assert batch_axes() == ("data",)
        assert batch_axes() == ("pod", "data")
    assert current_mesh() is None and batch_axes() == ("data",)


def test_mesh_context_is_thread_local():
    import threading
    seen = []
    with mesh_context(AbstractMesh((2, 4), ("data", "model"))):
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [None]


def test_placements_shard_major_to_minor_and_refuse_another_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements(mesh, (("data", "pod"),))


# ---------------------------------------------------- 8 ranks, gloo --
# dense GQA, MoE (expert parallel), MLA
RANK_ARCHS = ("granite-8b", "arctic-480b", "deepseek-v2-236b")
RANK_MESHES = ("2x4", "2x2x2")

INDEX_MAP = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import ARCHS
    from repro.launch.steps import make_train_step
    from repro.models.transformer import build_model
    from repro.sharding import rules

    meshes = json.loads(sys.argv[1])
    out = {}
    for name in json.loads(sys.argv[2]):
        model = build_model(ARCHS[name].reduced(), max_seq=64)
        state = jax.eval_shape(make_train_step(model)[1],
                               jax.random.PRNGKey(0))
        for key, (sizes, names) in meshes.items():
            mesh = Mesh(np.array(jax.devices()).reshape(sizes), names)
            shard = rules.state_shardings(mesh, state)
            leaves = jax.tree_util.tree_leaves_with_path(state)
            for (path, leaf), s in zip(leaves, jax.tree.leaves(shard)):
                idx = s.devices_indices_map(leaf.shape)
                out[f"{name}|{key}|{rules._path_str(path)}"] = [
                    [[sl.start or 0, leaf.shape[d] if sl.stop is None
                      else sl.stop] for d, sl in enumerate(idx[dev])]
                    for dev in jax.devices()]
    print(json.dumps(out))
""")


def _rank_shards(rank, index_map):
    """Distribute each leaf of the reduced archs' train states by the
    rules on both meshes; list the leaves whose local shard differs from
    the reference's index map entry for this device, or whose
    ``full_tensor()`` differs from the leaf.  A leaf holds its flat
    indices (each element tells where it belongs), the same on every
    rank."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    states = {}
    for name in RANK_ARCHS:
        model = build_model(get_arch(name).reduced(), max_seq=MAX_SEQ)
        states[name] = make_train_step(model)[1](R.PRNGKey(0, "meta"))
    out = {}
    for key in RANK_MESHES:
        sizes, names = MESHES[key]
        mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
        for name, state in states.items():
            shards = rules.state_shardings(mesh, state)
            bad, sharded = [], 0
            for path, leaf, place in zip(tree.paths(state),
                                         tree.leaves(state),
                                         tree.leaves(shards)):
                path = rules._path_str(path)
                full = torch.arange(leaf.numel()).to(leaf.dtype).reshape(
                    leaf.shape)
                dt = distribute_tensor(full, mesh, list(place))
                box = index_map[f"{name}|{key}|{path}"][rank]
                want = full[tuple(slice(a, b) for a, b in box)]
                if not torch.equal(dt.to_local(), want):
                    bad.append(("shard", path))
                if not torch.equal(dt.full_tensor(), full):
                    bad.append(("full_tensor", path))
                sharded += any(isinstance(p, Shard) for p in place)
            out[name, key] = (bad, sharded, len(tree.leaves(state)))
        # constrain on a DTensor: the named placements, names the mesh lacks
        # or that do not divide dropped
        x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
        rep = distribute_tensor(x, mesh, [Replicate()] * len(sizes))
        with mesh_context(mesh):
            y = constrain(rep, ("pod", "data"), "model", "model")
        out["constrain", key] = (tuple(y.placements), y.to_local().clone(),
                                 torch.equal(y.full_tensor(), x))
    return out


@pytest.fixture(scope="module")
def ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", INDEX_MAP,
         json.dumps({k: MESHES[k] for k in RANK_MESHES}),
         json.dumps(RANK_ARCHS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return run_ranks(8, _rank_shards, json.loads(res.stdout), timeout=300)


@pytest.mark.parametrize("mesh", RANK_MESHES)
@pytest.mark.parametrize("name", RANK_ARCHS)
def test_each_rank_holds_the_references_shard(ranks, name, mesh):
    for rank, out in enumerate(ranks):
        bad, sharded, n = out[name, mesh]
        assert bad == [], (rank, bad[:5])
        assert sharded > 0 and n > sharded


@pytest.mark.parametrize("mesh", RANK_MESHES)
def test_constrain_redistributes_a_dtensor(ranks, mesh):
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    sizes, names = MESHES[mesh]
    coords = np.unravel_index(np.arange(8), sizes)
    for rank, out in enumerate(ranks):
        got, local, whole = out["constrain", mesh]
        assert whole
        # the first dim over ("pod", "data") (the pod dropped where the mesh
        # has none), the second over "model"; the third (3) takes nothing
        want = [Shard(0) if n in ("pod", "data") else Shard(1)
                for n in names]
        assert list(got) == want and Replicate() not in got
        rows = 8 // int(np.prod([s for s, n in zip(sizes, names)
                                 if n != "model"]))
        row = 0
        for s, n, c in zip(sizes, names, coords):
            if n != "model":
                row = row * s + int(c[rank])
        m = names.index("model")
        cols = 12 // sizes[m]
        col = int(coords[m][rank]) * cols
        np.testing.assert_array_equal(
            local.numpy(),
            x[row * rows:(row + 1) * rows, col:col + cols].numpy())


def test_host_mesh_is_one_axis_of_the_world():
    """No world here: the mesh constructors name the ranks they need (the
    8-rank runs above build theirs inside the ranks)."""
    with pytest.raises(RuntimeError, match="world of 4 ranks"):
        make_host_mesh(4, axis="clients", device_type="cpu")
