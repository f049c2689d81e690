"""Op recorder: flcheck's traversal core in the port.

The reference walks jaxprs; eager torch traces nothing, so the port's
counterpart of a jaxpr is the list of ops a program dispatches, recorded by
a ``TorchDispatchMode`` over one run of it at the build's shapes
(:func:`record_ops`).  Under ``torch.func.vmap`` the mode sees the batched
ops, so a vmapped client update records each op once for all clients, and
``repro_torch::bwo_evolve`` as one op after its vmap rule.  One recorder,
many callers: the round engine's conv-on-CPU auto policy
(:func:`repro_torch.core.engine.task_uses_conv`) and the flcheck rules
(``repro_torch.analysis.rules``) both read recordings through
:func:`iter_sites`.  Each site carries

* ``multiplier`` -- how often its op fired from its call site in the
  recorded call: for a fused block of R rounds, a site that fires once a
  round counts R (the reference's product of enclosing scan lengths), and
* ``in_loop`` -- whether it fired in more than one round of the fused loop
  (the ``for`` over rounds in ``make_fused_rounds``'s block function, the
  counterpart of the reference's round ``lax.scan``).

With ``detail=True`` the recorder also keeps each dispatch as an
:class:`OpCall` (its operands' and results' shapes and dtypes, its scalar
arguments, a collective's group), which the cost model
(``repro_torch.launch.graph_analysis.analyze``) reads.  A ``DTensor`` op is
left to ``DTensor`` (the mode returns ``NotImplemented``, as
``CommDebugMode`` does), so the recorder sees each rank's local ops and the
collectives that ``DTensor`` issues, at their local shapes; the ops
``DTensor`` runs at the global shape to propagate its sharding are not
recorded, and the all-gather and chunk with which a CPU process group
stands in for an all-to-all are recorded as the all-to-all asked for.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Ops that read a tensor on the host or build one from host data: each is
# a device->host sync (or a copy from pageable memory) on the card, the
# edge the round-engine contract forbids inside a block (DESIGN.md §6/§8),
# and one a CUDA graph capture refuses.
HOST_READ_OPS = ("aten._local_scalar_dense", "aten.nonzero",
                 "aten.masked_select", "aten.is_nonzero", "aten.equal",
                 "aten.lift_fresh", "aten.lift_fresh_copy", "aten.item")

CONV_OPS = ("aten.convolution", "aten._convolution")

# The fused loop: the block function of core/engine.py's
# make_fused_rounds, whose ``for i in range(n_rounds)`` runs the rounds.
FUSED_LOOP = ("make_fused_rounds.<locals>.block_fn", "i")

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.dirname(_PORT)
_ANALYSIS = os.path.join(_PORT, "analysis")
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One op at one call site, with the signature of its outputs."""
    op: str                       # overload packet, e.g. "aten.mul"
    dtypes: Tuple[str, ...]       # its outputs' dtypes
    shapes: Tuple[Tuple[int, ...], ...]
    device: str                   # its outputs' device type ("" if none)
    location: str                 # call site, "repro_torch/...py:line"
    host_copy: bool = False       # outputs on the host from inputs on a card
    multiplier: int = 1           # firings in the recorded call
    in_loop: bool = False         # fired in more than one fused round

    @property
    def host_read(self) -> bool:
        return self.op in HOST_READ_OPS or self.host_copy


Sig = Tuple[Tuple[int, ...], str]          # a tensor's (shape, dtype)


@dataclasses.dataclass(frozen=True)
class OpCall:
    """One dispatch, as the cost model reads it."""
    op: str                       # overload packet, e.g. "aten.mm"
    inputs: Tuple[Sig, ...]       # its tensor arguments, in order
    outputs: Tuple[Sig, ...]
    attrs: Tuple[Any, ...]        # its scalar arguments (int, float, bool,
                                  # str, None), in order
    group: Tuple[int, ...]        # a collective's ranks, () for other ops
    location: str


@dataclasses.dataclass
class OpRecording:
    """The ops of one recorded call: one event per dispatch, as
    ``(site without counts, round index or None)``; with ``detail`` each
    dispatch also as an :class:`OpCall`."""
    events: List[Tuple[OpSite, Optional[int]]] = dataclasses.field(
        default_factory=list)
    calls: List[OpCall] = dataclasses.field(default_factory=list)


def tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor in a nest of tuples, lists and dicts, in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors(o)


def _where(frame) -> Tuple[str, Optional[int]]:
    """The call site (the innermost frame of the port outside this
    package; else the innermost frame outside torch, for code such as a
    test's) and the fused round the call is in, if any."""
    site = fallback = ""
    round_idx = None
    while frame is not None:
        code = frame.f_code
        path = code.co_filename
        if not site and path.startswith(_PORT) \
                and not path.startswith(_ANALYSIS):
            site = f"{os.path.relpath(path, _SRC)}:{frame.f_lineno}"
        elif not fallback and not path.startswith(_TORCH) \
                and not path.startswith(_ANALYSIS) \
                and not path.startswith("<frozen"):
            fallback = f"{os.path.basename(path)}:{frame.f_lineno}"
        if round_idx is None and code.co_qualname == FUSED_LOOP[0]:
            round_idx = frame.f_locals.get(FUSED_LOOP[1])
        frame = frame.f_back
    return site or fallback, round_idx


# DTensor's own frames: its sharding propagation runs each op once at the
# global shape, and a CPU process group's stand-in for an all-to-all
_DTENSOR_META = "_propagate_tensor_meta_non_cached"
_ALLTOALL_FALLBACK = "shard_dim_alltoall"
_COLLECTIVE_PREFIX = ("_c10d_functional.", "_dtensor.", "c10d.")


def _dtensor_frame(frame) -> Optional[str]:
    """The DTensor frame the dispatch runs under (see above), if any."""
    while frame is not None:
        name = frame.f_code.co_name
        if name in (_DTENSOR_META, _ALLTOALL_FALLBACK):
            return name
        frame = frame.f_back
    return None


def _sig(t: torch.Tensor) -> Sig:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _scalars(obj) -> Iterator[Any]:
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _scalars(o)


def _group_ranks(attrs) -> Tuple[int, ...]:
    """The ranks of the process group a collective names (its last string
    argument, the group's name)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in attrs if isinstance(a, str)]
    if not name:
        return ()
    return tuple(dist.get_process_group_ranks(
        _resolve_process_group(name[-1])))


def _has_dtensor(types) -> bool:
    if all(t is torch.Tensor for t in types):    # plain tensors: no import
        return False
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched under it into ``self.recording`` (and,
    with ``detail``, each dispatch as an :class:`OpCall`)."""

    def __init__(self, detail: bool = False):
        super().__init__()
        self.recording = OpRecording()
        self.detail = detail

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        frame = sys._getframe(1)
        inside = _dtensor_frame(frame)
        op = str(func.overloadpacket)
        if inside == _DTENSOR_META or (
                inside == _ALLTOALL_FALLBACK
                and "all_gather" not in op):
            return out
        outs = list(tensors(out))
        dev = outs[0].device.type if outs else ""
        ins = list(tensors(args)) + list(tensors(kwargs))
        where, round_idx = _where(frame)
        if inside == _ALLTOALL_FALLBACK:
            # the all-to-all asked for: each rank sends and receives its
            # input's bytes
            op, outs = "_c10d_functional.all_to_all_single", ins[:1]
        if self.detail:
            attrs = tuple(_scalars(list(args) + list(kwargs.values())))
            self.recording.calls.append(OpCall(
                op=op, inputs=tuple(_sig(t) for t in ins),
                outputs=tuple(_sig(t) for t in outs), attrs=attrs,
                group=(_group_ranks(attrs)
                       if op.startswith(_COLLECTIVE_PREFIX) else ()),
                location=where))
        self.recording.events.append((OpSite(
            op=op,
            dtypes=tuple(str(t.dtype).replace("torch.", "") for t in outs),
            shapes=tuple(tuple(t.shape) for t in outs), device=dev,
            location=where,
            host_copy=dev == "cpu" and any(t.device.type != "cpu"
                                           for t in ins)), round_idx))
        return out


def record_ops(fn, *args, detail: bool = False,
               **kwargs) -> Tuple[OpRecording, Any]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpRecorder`
    (keeping each dispatch's :class:`OpCall` with ``detail``); returns
    ``(recording, result)``."""
    with OpRecorder(detail) as rec:
        result = fn(*args, **kwargs)
    return rec.recording, result


def iter_sites(recording: OpRecording) -> Iterator[OpSite]:
    """One site per op and call site (and output signature), in first-fire
    order, with its ``multiplier`` (firings) and ``in_loop`` (fired in more
    than one fused round)."""
    counts: Dict[OpSite, int] = {}
    rounds: Dict[OpSite, set] = {}
    for site, round_idx in recording.events:
        counts[site] = counts.get(site, 0) + 1
        rounds.setdefault(site, set()).add(round_idx)
    for site, n in counts.items():
        yield dataclasses.replace(
            site, multiplier=n,
            in_loop=len(rounds[site] - {None}) > 1)


def has_op(recording: OpRecording, names: Iterable[str]) -> bool:
    """True when any recorded op is one of ``names`` (the reference's
    ``jaxpr_has_primitive``)."""
    names = tuple(names)
    return any(site.op in names for site, _ in recording.events)


def count_ops(recording: OpRecording, names: Iterable[str] = (),
              weighted: bool = False) -> Dict[str, int]:
    """Sites per op name, restricted to ``names`` when given; with
    ``weighted=True`` each site counts its firings (the reference's
    ``count_primitives``)."""
    names = tuple(names)
    counts: Dict[str, int] = {}
    for s in iter_sites(recording):
        if names and s.op not in names:
            continue
        counts[s.op] = counts.get(s.op, 0) + (s.multiplier if weighted else 1)
    return counts


def iter_dtypes(recording: OpRecording) -> Iterator[str]:
    """Every output dtype of every recorded op (the reference's
    ``iter_avals``, by dtype)."""
    for site, _ in recording.events:
        yield from site.dtypes


def loss_uses_conv(loss_fn, params, sample_batch) -> bool:
    """Run ``loss_fn(params, batch)`` once without gradients and report
    whether it dispatched a convolution.  Drives the round engine's CPU
    engine="auto" decision (DESIGN.md §4) and flcheck's ``conv-policy``
    rule.  Returns True (the conservative answer) when the call raises."""
    try:
        with torch.no_grad():
            rec, _ = record_ops(loss_fn, params, sample_batch)
    except Exception:
        return True
    return has_op(rec, CONV_OPS)
