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


def constrain(x, *axes_):
    """Apply a sharding constraint if a mesh context is active.

    ``axes_`` gives one logical axis (or tuple, or None) per tensor dim.
    Names absent from the active mesh — or that don't divide the dim —
    are silently dropped, so the same model code serves every mesh.  A
    ``DTensor`` is redistributed to the filtered spec's placements on its
    own mesh; a plain tensor comes back unchanged, since eager PyTorch
    has no compiler to hand the constraint to.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    assert len(axes_) == x.ndim, (axes_, x.shape)
    spec = tuple(_filter(a, mesh, s) for a, s in zip(axes_, x.shape))
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))
    return x


def batch_axes():
    """Logical axes the batch dim shards over (pod-major when present)."""
    override = getattr(_state, "batch_override", None)
    if override is not None:
        return override
    mesh = current_mesh()
    if mesh is not None and "pod" in axes(mesh).names:
        return ("pod", "data")
    return ("data",)
