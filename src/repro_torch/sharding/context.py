"""Mesh context for intermediate-activation sharding constraints.

Model code never imports a mesh directly; it calls
``constrain(x, "model", None, ...)`` with *logical* per-dim axis names.
The reference lowers that to ``with_sharding_constraint`` while a mesh
context is active; eager PyTorch has no compiler to hand a constraint to,
so here a ``DTensor`` is redistributed to the named placements and a plain
tensor is returned as it is.  Without a mesh context it is a no-op, so the
same model code runs on one device and on a mesh.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or an
:class:`AbstractMesh` (axis names and sizes only, JAX's ``AbstractMesh``),
which lets the rules run where no process group exists: a 256- or
512-rank world cannot be started on one host.  :func:`axes` reads both
the same way.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

_state = threading.local()


class AbstractMesh:
    """A mesh's axis names and sizes, without devices: the counterpart of
    ``jax.sharding.AbstractMesh(axis_sizes, axis_names)``."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} "
                             f"axis names")
        self.names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in axis_sizes)

    def size(self, axis: str) -> int:
        return self.sizes[self.names.index(axis)]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.sizes}, {self.names})"


def axes(mesh) -> AbstractMesh:
    """Axis names and sizes of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    if mesh.mesh_dim_names is None:
        raise ValueError("the sharding rules name mesh axes: build the "
                         "DeviceMesh with mesh_dim_names")
    return AbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh, batch_axes_override: Optional[tuple] = None):
    """``batch_axes_override``: replaces the default ("pod","data") batch
    axes — used by the FedX pod-round lowering where the pod dim is a
    vmap dim and per-pod code must shard batches over "data" only.
    Thread-local; the previous mesh and override come back on exit."""
    prev = current_mesh()
    prev_b = getattr(_state, "batch_override", None)
    _state.mesh = mesh
    _state.batch_override = batch_axes_override
    try:
        yield mesh
    finally:
        _state.mesh = prev
        _state.batch_override = prev_b


def _axis_size(axis, mesh) -> int:
    m = axes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= m.size(a)
        return n
    return m.size(axis)


def _filter(axis, mesh, dim_size) -> Union[None, str, tuple]:
    """Drop axis names not in the mesh or that don't divide the dim."""
    names = axes(mesh).names
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        if not kept or dim_size % _axis_size(kept, mesh) != 0:
            return None
        return kept
    if axis not in names or dim_size % _axis_size(axis, mesh) != 0:
        return None
    return axis


def placements(mesh, spec) -> tuple:
    """DTensor placements, one per mesh dim, for a spec (one entry per
    tensor dim: None, an axis name or a tuple of names): ``Shard(d)`` on
    each mesh dim named at tensor dim ``d``, ``Replicate()`` elsewhere.  A
    tuple shards one tensor dim over several mesh dims, major to minor,
    which is DTensor's order when the names follow the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axes(mesh).names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"{group} shards dim {d} in another order than "
                             f"the mesh's axes {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class _Constrain(torch.autograd.Function):
    """Redistribute a ``DTensor`` to ``place``, and its gradient too:
    ``with_sharding_constraint``'s transpose constrains the cotangent
    alike.  (``DTensor.redistribute`` alone sends a gradient back to the
    placements it came from, and a row-parallel product's pending sum would
    then reach the next product's weight gradient, which gathers its other
    operand whole.)"""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return _redistribute(x, place)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.place), None


def _redistribute(x, place):
    """``x.redistribute`` to ``place`` in two steps: first the mesh dims
    that ``place`` replicates (a gather or a reduction over each, the rest
    kept), then the rest.  A weight stored (data, model)-sharded and wanted
    row-parallel is gathered over ``data`` and its shards exchanged over
    ``model`` (an all-to-all), as XLA reshards it; ``DTensor``'s own plan
    gathers the whole weight and slices it."""
    first = tuple(t if t.is_replicate() else s
                  for s, t in zip(x.placements, place))
    if first != tuple(x.placements) and first != tuple(place):
        x = x.redistribute(x.device_mesh, first)
    return x.redistribute(x.device_mesh, place)


def constrain(x, *axes_):
    """Apply a sharding constraint if a mesh context is active.

    ``axes_`` gives one logical axis (or tuple, or None) per tensor dim.
    Names absent from the active mesh — or that don't divide the dim —
    are silently dropped, so the same model code serves every mesh.  A
    ``DTensor`` is redistributed to the filtered spec's placements on its
    own mesh, and so is its gradient; a plain tensor comes back unchanged,
    since eager PyTorch has no compiler to hand the constraint to.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    assert len(axes_) == x.ndim, (axes_, x.shape)
    spec = tuple(_filter(a, mesh, s) for a, s in zip(axes_, x.shape))
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _Constrain.apply(x, placements(x.device_mesh, spec))
    return x


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_dims(fn, *args, out):
    """Run ``fn`` on each rank's shard of its ``DTensor`` arguments, through
    ``local_map``: the sharding rule of an operator that works on one shard
    as it works on the whole (a kernel, a scatter).  ``args`` are pairs
    ``(tensor or None, roles)`` with one character per dim: ``b`` a batch
    dim, sharded over the batch axes (:func:`batch_axes`) where they divide
    every batch dim; ``m`` a model dim, sharded over ``model`` where it
    divides every model dim; ``.`` replicated.  ``out`` is the roles of the
    result, or a tuple of them for a tuple of results.  Roles may end in
    ``+`` and the roles whose axes hold partial sums: of a result (``+b``:
    a replicated weight's gradient summed over each rank's batch rows), or
    of an input's gradient (``fn``'s backward on each rank covers only its
    share).  Inputs are redistributed to these placements first."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t, _ in args if is_dtensor(t)).device_mesh
    m = axes(mesh)

    def sizes(role):
        return [t.shape[d] for t, roles in args if t is not None
                for d, r in enumerate(roles.partition("+")[0]) if r == role]

    batch = tuple(a for a in batch_axes() if a in m.names)
    if not batch or any(s % _axis_size(batch, mesh) for s in sizes("b")):
        batch = None
    model = ("model" if "model" in m.names
             and all(s % m.size("model") == 0 for s in sizes("m")) else None)

    def place(roles):
        from torch.distributed.tensor import Partial
        roles, _, partial = roles.partition("+")
        out = list(placements(mesh, [
            batch if r == "b" else model if r == "m" else None
            for r in roles]))
        summed = (batch or ()) if "b" in partial else ()
        summed += (model,) if "m" in partial and model else ()
        for a in summed:
            out[m.names.index(a)] = Partial()
        return out              # a list: local_map reads a tuple as outputs

    outs = (tuple(place(r) for r in out) if isinstance(out, tuple)
            else place(out))
    ins = tuple(place(roles.partition("+")[0]) if is_dtensor(t) else None
                for t, roles in args)
    grads = tuple(place(roles) if is_dtensor(t) else None
                  for t, roles in args)
    return local_map(fn, outs, ins, grads, mesh, redistribute_inputs=True)(
        *[t for t, _ in args])


def batch_axes():
    """Logical axes the batch dim shards over (pod-major when present)."""
    override = getattr(_state, "batch_override", None)
    if override is not None:
        return override
    mesh = current_mesh()
    if mesh is not None and "pod" in axes(mesh).names:
        return ("pod", "data")
    return ("data",)
