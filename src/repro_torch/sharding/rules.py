"""Parameter / cache / batch partition specs.

Strategy (16x16 mesh, axes ``data`` x ``model``; multi-pod adds a leading
``pod`` axis), as the reference's ``repro.sharding.rules``:

- **Params: FSDP + TP.** Every weight matrix shards its *last* dim over
  ``model`` (tensor parallel) and its largest remaining dim over ``data``
  (ZeRO-3 style).  Params are *replicated* over ``pod`` — in the FedX
  protocol each pod is a federation client holding a full replica, and
  cross-pod traffic is scores + the winner's weights, not gradients.
- **MoE experts** shard the expert dim over ``model`` (expert parallel).
- **Optimizer state** inherits the spec of its param.
- **Batch** dims shard over ``(pod, data)``.
- **KV caches** shard batch over ``(pod, data)`` and heads over ``model``
  when divisible, else the *sequence* dim over ``model``.

Dims that don't divide their mesh axes are left unsharded (the helper
checks divisibility), so the same rules serve reduced smoke configs.

A spec is a tuple with one entry per tensor dim (``None``, an axis name or
a tuple of names), entry for entry the reference's ``PartitionSpec``; a
replicated small leaf gets ``()``, as ``P()``.  A leaf's path is the
``/``-joined key path of :func:`repro_torch.tree.paths`, the string the
reference's ``_path_str`` makes, so the substring rules (``"moe"``,
``"/k"``, ``"scale"``, ``"step"``, ...) see the same names.  A mesh is a
``DeviceMesh`` or an :class:`~repro_torch.sharding.context.AbstractMesh`.
"""
from __future__ import annotations

from typing import Any

from repro_torch import tree as tree_lib
from repro_torch.sharding.context import axes, placements

LARGE = 16384  # leaves smaller than this are replicated


def P(*entries) -> tuple:
    """A spec as JAX's ``PartitionSpec(*entries)`` holds it: a tuple of
    one name becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _ok(mesh, axis, size: int) -> bool:
    m = axes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            if a not in m.names:
                return False
            n *= m.size(a)
        return size % n == 0
    return axis in m.names and size % m.size(axis) == 0


def _path_str(path: str) -> str:
    """A ``tree.paths`` path ("/groups/sub0/attn/wq") as the reference's
    ``_path_str`` writes the same leaf's key path: without the leading
    "/"."""
    return path.lstrip("/")


def param_spec(mesh, path: str, leaf) -> tuple:
    """Spec for one parameter leaf (possibly with a leading stack dim)."""
    name = _path_str(path)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    if leaf.numel() < LARGE or ndim < 2:
        return P()
    spec = [None] * ndim

    # stacked-layer leading dims (groups / encoder) are never sharded;
    # work on the trailing "matrix" dims.
    if "moe" in name and any(k in name for k in ("wi", "wg", "wo")) \
            and ndim >= 3:
        # (..., E, a, b): expert-parallel over `model`, a over `data`
        e_dim, a_dim = ndim - 3, ndim - 2
        if _ok(mesh, "model", shape[e_dim]):
            spec[e_dim] = "model"
        if _ok(mesh, "data", shape[a_dim]):
            spec[a_dim] = "data"
        return P(*spec)

    last = ndim - 1
    if _ok(mesh, "model", shape[last]):
        spec[last] = "model"
    # largest remaining dim -> data (FSDP)
    rest = [d for d in range(ndim - 1)
            if not (ndim >= 3 and d < ndim - 2)]  # skip stack dims
    rest = [d for d in rest if _ok(mesh, "data", shape[d])]
    if rest:
        d = max(rest, key=lambda i: shape[i])
        spec[d] = "data"
    return P(*spec)


def cache_spec(mesh, path: str, leaf) -> tuple:
    """Spec for one KV-cache / recurrent-state leaf.

    Layouts: attn k/v (G,B,S,KV,hd); mla c_kv (G,B,S,L); mamba h
    (G,B,di,N), conv (G,B,w,di); mlstm C (G,B,h,dh,dh), n (G,B,h,dh),
    m (G,B,h); slstm (G,B,d).
    """
    name = _path_str(path)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec: list = [None] * ndim
    batch_ax = ("pod", "data") if "pod" in axes(mesh).names else ("data",)
    if ndim >= 2:
        if _ok(mesh, batch_ax, shape[1]):
            spec[1] = batch_ax
        elif _ok(mesh, "data", shape[1]):
            spec[1] = "data"
    if "scale" in name and ndim >= 4:          # (G,B,S,KV) int8 scales
        if _ok(mesh, "model", shape[3]):
            spec[3] = "model"
        elif _ok(mesh, "model", shape[2]):
            spec[2] = "model"
    elif ndim >= 4 and ("/k" in name or "/v" in name):
        kv_dim, seq_dim = 3, 2
        if _ok(mesh, "model", shape[kv_dim]):
            spec[kv_dim] = "model"
        elif _ok(mesh, "model", shape[seq_dim]):
            spec[seq_dim] = "model"
    elif "c_kv" in name or "k_rope" in name:
        if _ok(mesh, "model", shape[2]):
            spec[2] = "model"          # latent cache: shard seq over model
    elif ndim >= 3:
        # recurrent states: shard the widest non-batch dim over model
        cand = [d for d in range(2, ndim) if _ok(mesh, "model", shape[d])]
        if cand:
            spec[max(cand, key=lambda i: shape[i])] = "model"
    return P(*spec)


def batch_spec(mesh, path: str, leaf) -> tuple:
    batch_ax = ("pod", "data") if "pod" in axes(mesh).names else ("data",)
    shape = tuple(leaf.shape)
    spec: list = [None] * len(shape)
    if shape and _ok(mesh, batch_ax, shape[0]):
        spec[0] = batch_ax
    elif shape and _ok(mesh, "data", shape[0]):
        spec[0] = "data"
    return P(*spec)


def _map_with_path(fn, tree) -> Any:
    return tree_lib.unflatten(
        tree_lib.structure(tree),
        [fn(p, leaf) for p, leaf in zip(tree_lib.paths(tree),
                                        tree_lib.leaves(tree))])


def tree_specs(mesh, tree, rule) -> Any:
    return _map_with_path(lambda path, leaf: rule(mesh, path, leaf), tree)


def tree_shardings(mesh, tree, rule) -> Any:
    """DTensor placements (one per mesh dim) for every leaf, by ``rule``."""
    return _map_with_path(
        lambda path, leaf: placements(mesh, rule(mesh, path, leaf)), tree)


def state_shardings(mesh, state_tree) -> Any:
    """Placements for a train state {params, opt, step}: the step is
    replicated, every other leaf (the optimizer's moments carry their
    parameter's path under ``opt/m``, ``opt/v``) takes ``param_spec``."""
    def rule(path, leaf):
        if _path_str(path).startswith("step"):
            return placements(mesh, P())
        return placements(mesh, param_spec(mesh, path, leaf))
    return _map_with_path(rule, state_tree)
