"""The port's ``repro.launch.hlo_analysis``: the cost model over a recorded
run, and a captured block's CUDA graph (its nodes by kind, buffer reuse).

The reference reads both from compiled HLO text.  The port reads the cost
from the ops one run of a step dispatched (:func:`analyze` over an
``analysis.walker.OpRecording`` made with ``detail=True``), and the host
transfers and aliases from the CUDA graph that the card replays for a fused
block (:class:`repro_torch.core.engine.CapturedBlock`).

* :func:`analyze` gives an :class:`OpCost` with ``HloCost``'s fields and
  their meaning: dot FLOPs, HBM bytes and ring link bytes per device, by
  the reference's formulas (see its docstring).

* :func:`dump_graph` prints the graph's nodes (``cudaGraphDebugDotPrint``
  through ``CUDAGraph.debug_dump``; the block must be captured with
  ``keep_graph=True``, since on torch 2.11 a graph in debug mode alone drops
  its ``cudaGraph_t`` at instantiation and the dump writes nothing);
  :func:`parse_graph_dot` counts the dump's nodes by kind, kernel nodes by
  kernel name and memcpy nodes by direction; :func:`count_host_transfers`
  keeps the device->host copies and host nodes.
* :func:`buffer_reuse` replays the block twice: its static inputs keep
  their addresses, and the memory allocated after the second replay (the
  first replay's outputs dropped) is no higher than after the first.
* :func:`replay_under_sync_debug` replays once under
  ``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.walker import OpCall, OpRecording, tensors

# one node: "graph_1_node_3"[... label="{KIND ...}"]; its label runs to "}"];
_NODE = re.compile(r'^"(?P<id>[^"]+)"\[[^\n]*?label="\{\s*(?P<kind>[A-Z_]+)'
                   r'(?P<body>.*?)\}"\];$', re.MULTILINE | re.DOTALL)
_KERNEL_SYMBOL = re.compile(r"\{ID \| [^|]*\| (?P<sym>[^\s\\|}]+)")
_MEMCPY_KIND = re.compile(r"\{kind \| (?P<dir>[A-Za-z]+)")


@dataclasses.dataclass
class GraphNodes:
    """A graph's nodes: by kind (``KERNEL``, ``MEMCPY``, ``MEMSET``,
    ``HOST``, ...), kernel nodes by kernel name, memcpy nodes by direction
    (``DtoD``, ``DtoH``, ``HtoD``, ``HtoH``)."""
    kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    memcpy: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def host_nodes(self) -> int:
        return self.kinds.get("HOST", 0)


def kernel_name(symbol: str) -> str:
    """The function's own name in a kernel's (Itanium-mangled) symbol:
    ``_ZN2at6native29vectorized_elementwise_kernelILi4E...`` ->
    ``vectorized_elementwise_kernel``; an unmangled name is returned as
    it is."""
    if not symbol.startswith("_Z"):
        return symbol
    i = 3 if symbol.startswith("_ZN") else 2
    name = symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name = symbol[j:j + n]
        i = j + n
        if symbol[2] != "N":
            break
    return name


def _inc(d: Dict[str, int], k: str) -> None:
    d[k] = d.get(k, 0) + 1


def parse_graph_dot(text: str) -> GraphNodes:
    """Count the nodes of a ``cudaGraphDebugDotPrint`` dump (verbose
    flags, as ``CUDAGraph.debug_dump`` prints)."""
    out = GraphNodes()
    for m in _NODE.finditer(text):
        kind, body = m.group("kind"), m.group("body")
        _inc(out.kinds, kind)
        if kind == "KERNEL":
            sym = _KERNEL_SYMBOL.search(body)
            _inc(out.kernels, kernel_name(sym.group("sym")) if sym
                 else "<unnamed>")
        elif kind == "MEMCPY":
            d = _MEMCPY_KIND.search(body)
            _inc(out.memcpy, d.group("dir") if d else "<unknown>")
    return out


def count_host_transfers(nodes: GraphNodes) -> Dict[str, int]:
    """Device->host edges among a graph's nodes (:func:`parse_graph_dot`),
    by kind: ``DtoH`` memcpy nodes and ``HOST`` nodes (host functions run
    by the graph); empty when there are none -- the quantity flcheck's
    ``one-sync-per-block`` rule bounds.  A copy of unknown direction counts
    as one, too."""
    out = {k: v for k, v in nodes.memcpy.items()
           if k in ("DtoH", "<unknown>")}
    if nodes.host_nodes:
        out["HOST"] = nodes.host_nodes
    return out


def dump_graph(block, path: str) -> str:
    """Print ``block``'s graph (captured with ``keep_graph=True``) to
    ``path`` and return the text.  A dump that writes nothing raises:
    ``debug_dump`` only warns when the print fails."""
    if os.path.exists(path):
        os.remove(path)
    block.graph.debug_dump(path)
    if not os.path.exists(path):
        raise RuntimeError(
            f"CUDAGraph.debug_dump wrote no file at {path}: capture the "
            f"block with keep_graph=True")
    with open(path) as f:
        return f.read()


@dataclasses.dataclass(frozen=True)
class BufferReuse:
    """What two replays of a captured block show: whether its static
    inputs kept their addresses, and the device memory allocated after the
    first replay and after the second (the first's outputs dropped)."""
    ptrs_kept: bool
    allocated_first: int
    allocated_second: int


def _static_ptrs(block) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in tensors(
        (block.params, block.rng, block.eval_batch)))


def static_dtypes(block) -> Tuple[str, ...]:
    """The dtypes of a captured block's static buffers: its inputs and the
    outputs the graph writes."""
    return tuple(sorted({str(t.dtype).replace("torch.", "") for t in tensors(
        (block.params, block.rng, block.eval_batch, block.out))}))


def buffer_reuse(block, params, rng, eval_batch) -> BufferReuse:
    """Replay ``block`` twice on these inputs (see :class:`BufferReuse`)."""
    ptrs = _static_ptrs(block)
    out = block(params, rng, eval_batch)
    torch.cuda.synchronize()
    first = torch.cuda.memory_allocated()
    del out
    out = block(params, rng, eval_batch)
    torch.cuda.synchronize()
    second = torch.cuda.memory_allocated()
    del out
    return BufferReuse(ptrs_kept=_static_ptrs(block) == ptrs,
                       allocated_first=first, allocated_second=second)


def replay_under_sync_debug(block, params, rng, eval_batch) -> Optional[str]:
    """Replay ``block`` once under ``set_sync_debug_mode("error")``; the
    error a synchronizing call raised, or None."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        block(params, rng, eval_batch)
    except RuntimeError as e:
        return f"{type(e).__name__}: {e}"
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return None


@dataclasses.dataclass
class BlockGraph:
    """What flcheck reads from a captured block on the card."""
    nodes: GraphNodes
    launches: int                 # bwo_evolve launches the capture recorded
    static_dtypes: Tuple[str, ...]
    reuse: BufferReuse
    sync_error: Optional[str]     # what a sync-debug replay raised, if any
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def host_transfers(self) -> Dict[str, int]:
        return count_host_transfers(self.nodes)


def read_block_graph(block, params, rng, eval_batch, path: str) -> BlockGraph:
    """Dump and count ``block``'s graph (to ``path``), then replay it:
    twice for buffer reuse, once under sync-debug "error".  ``seconds``
    holds the host time of the capture, the dump and its count, and the
    three replays."""
    t0 = time.perf_counter()
    text = dump_graph(block, path)
    nodes = parse_graph_dot(text)
    t1 = time.perf_counter()
    reuse = buffer_reuse(block, params, rng, eval_batch)
    sync_error = replay_under_sync_debug(block, params, rng, eval_batch)
    return BlockGraph(
        nodes=nodes, launches=block.launches,
        static_dtypes=static_dtypes(block), reuse=reuse,
        sync_error=sync_error, seconds={
            "capture": block.capture_s, "dump_and_count": t1 - t0,
            "three_replays": time.perf_counter() - t1})


# ------------------------------------------------------------ cost model --
_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "int64": 8, "uint64": 8,
    "int32": 4, "uint32": 4, "int16": 2, "uint16": 2, "int8": 1, "uint8": 1,
    "bool": 1, "complex64": 8, "complex128": 16}

# Ops that move no data: views, allocations and metadata (the reference's
# _NO_TRAFFIC: tuple, bitcast, reshape, broadcast, parameter, ...).
_NO_TRAFFIC = frozenset(
    "aten." + n for n in (
        "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
        "t", "select", "slice", "unsqueeze", "squeeze", "as_strided",
        "alias", "detach", "split", "split_with_sizes", "chunk", "unbind",
        "narrow", "diagonal", "view_as_real", "view_as_complex", "unfold",
        "movedim", "empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "lift_fresh", "_local_scalar_dense",
        "sym_size", "sym_stride", "sym_numel", "is_same_size",
        "resolve_conj", "resolve_neg", "set_",
        "_has_compatible_shallow_copy_type")) | {
    "prim.device", "prim.layout", "_c10d_functional.wait_tensor"}

# products: the contracting size is the last dim of the first matrix
# operand (the second input for addmm / baddbmm, whose first is the bias)
_DOTS = {"aten.mm": 0, "aten.bmm": 0, "aten.matmul": 0, "aten.mv": 0,
         "aten.dot": 0, "aten.addmm": 1, "aten.baddbmm": 1, "aten.addbmm": 1,
         "aten.addmv": 1}
_CONVS = ("aten.convolution", "aten._convolution")

# collectives by the reference's kinds; each rank's ring link bytes from
# b, the bytes of the result (the all-to-all's of its input), and the
# group's size n
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    "c10d.allreduce_": "all-reduce", "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all", "c10d.broadcast_": "broadcast"}


def _ring_bytes(kind: str, b: float, n: int) -> float:
    if kind == "all-reduce":
        return 2.0 * b * (n - 1) / max(n, 1)
    if kind in ("all-gather", "all-to-all"):
        return b * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return b * (n - 1)
    return b                                  # broadcast / permute


def sig_bytes(sig) -> int:
    shape, dtype = sig
    return math.prod(shape) * _DTYPE_BYTES.get(dtype, 4)


@functools.lru_cache(maxsize=4096)
def attention_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int],
                    q_offset: int = 0, kv_len: Optional[int] = None
                    ) -> Tuple[int, int]:
    """(query, key) pairs the attention mask keeps and the keys some query
    sees, per batch row and head, as chip_smoke.py's ``valid_pairs``: query
    i, at q_offset + i, sees keys max(0, q - window + 1) .. min(q if
    causal, kv_len - 1)."""
    n = Sk if kv_len is None else min(kv_len, Sk)
    pairs, lo_min, hi_max = 0, n, -1
    for q in range(q_offset, q_offset + Sq):
        hi = min(q, n - 1) if causal else n - 1
        lo = 0 if window is None else max(0, q - window + 1)
        if hi >= lo:
            pairs += hi - lo + 1
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    return pairs, max(0, hi_max - lo_min + 1)


def _kv_len(call: OpCall) -> Optional[int]:
    """A flash call's valid key length: its int, or every key where it
    takes a (B,) tensor (whose values a recording does not keep)."""
    return call.attrs[4] if len(call.attrs) > 4 else None


def kernel_cost(call: OpCall) -> Optional[Tuple[float, float, float]]:
    """(dot FLOPs, other FLOPs, bytes) of one hand-written kernel's call,
    by the formulas chip_smoke.py's bounds use for it at that shape; None
    for any other op."""
    op = call.op
    if op == "repro_torch.flash_attention":
        (q, qdt), (k, kdt) = call.inputs[0], call.inputs[1]
        B, Sq, H, hd = q
        Sk, KV = k[1], k[2]
        causal, window, q_offset = call.attrs[:3]
        pairs, keys = attention_pairs(Sq, Sk, causal, window, q_offset,
                                      _kv_len(call))
        size = _DTYPE_BYTES[qdt]
        return (4.0 * B * H * hd * pairs, 0.0,
                float((2 * B * Sq * H * hd + 2 * B * keys * KV * hd) * size))
    if op == "repro_torch.flash_attention_bwd":
        (q, qdt), (k, _) = call.inputs[0], call.inputs[1]
        B, Sq, H, hd = q
        Sk, KV = k[1], k[2]
        causal, window = call.attrs[:2]
        pairs, _ = attention_pairs(Sq, Sk, causal, window)
        size = _DTYPE_BYTES[qdt]
        return (10.0 * B * H * hd * pairs, 0.0,
                float((3 * B * Sq * H * hd + 4 * B * Sk * KV * hd) * size))
    if op in ("repro_torch.ssm_scan", "repro_torch.ssm_scan_into"):
        (x, _), (A, _) = call.inputs[0], call.inputs[2]
        B, S, D = x
        N = A[1]
        states = len(call.inputs) - 5          # h0 and h_out, when given
        nbytes = 4 * (3 * B * S * D + 2 * B * S * N + D * N
                      + max(1, states) * B * D * N)
        return 0.0, 7.0 * B * S * D * N, float(nbytes)
    if op == "repro_torch.ssm_scan_bwd":
        B, S, D = call.inputs[0][0]
        N = call.inputs[2][0][1]
        nbytes = 4 * (5 * B * S * D + 4 * B * S * N + 2 * D * N)
        return 0.0, 12.0 * B * S * D * N, float(nbytes)
    if op == "repro_torch.bwo_evolve":
        P, D = call.inputs[0][0]
        Dp = call.inputs[3][0][1]
        # every row counted as a parent read (a recording keeps no
        # indices); chip_smoke.py counts this draw's distinct parents
        nbytes = P * D * 4 + 2 * P * Dp * 4 + P * D * 4 + 2 * P * 4 + P * 4
        return 0.0, 15.0 * P * D, float(nbytes)
    return None


def dot_flops(call: OpCall) -> Optional[float]:
    """2 x prod(result) x contracting size of a product; the reference's
    2 x out x kernel elements / out features of a convolution (forward, or
    each gradient a backward computes); None for any other op."""
    if call.op in _DOTS:
        a = call.inputs[_DOTS[call.op]][0]
        return 2.0 * math.prod(call.outputs[0][0]) * (a[-1] if a else 1)
    if call.op in _CONVS:
        w = call.inputs[1][0]
        kel = math.prod(w) // max(w[0], 1)
        return 2.0 * math.prod(call.outputs[0][0]) * kel
    if call.op == "aten.convolution_backward":
        dy, w = call.inputs[0][0], call.inputs[2][0]
        kel = math.prod(w) // max(w[0], 1)
        grads = sum(1 for o in call.outputs[:2] if math.prod(o[0]))
        return 2.0 * math.prod(dy) * kel * grads
    return None


@dataclasses.dataclass
class OpCost:
    """``hlo_analysis.HloCost``'s fields, per device: ``n_dots`` and
    ``n_collectives`` count calls (the port runs every layer's ops, so a
    call is an execution); ``top_*`` group the calls of one op at one site
    and shape, ``mult`` their number.  ``kernels`` holds each hand-written
    kernel's calls, FLOPs and bytes: flash attention's FLOPs are products
    and count in ``dot_flops``, the scan's and bwo_evolve's are not."""
    dot_flops: float
    hbm_bytes: float
    collective_link_bytes: float
    collectives_by_kind: Dict[str, float]
    n_dots: int
    n_collectives: int
    flagged: List[str]
    top_collectives: List[dict] = dataclasses.field(default_factory=list)
    top_dots: List[dict] = dataclasses.field(default_factory=list)
    cross_pod_link_bytes: float = 0.0
    host_transfers: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_host_transfers: int = 0
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


def _top(items: Dict[Tuple, Dict[str, Any]], key: str) -> List[dict]:
    return sorted(items.values(), key=lambda d: -d[key])[:12]


def analyze(recording: OpRecording, total_devices: int,
            pod_size: Optional[int] = None) -> OpCost:
    """The cost of one recorded run (``record_ops(..., detail=True)``), per
    device.  Under a mesh the recorder sees each rank's local ops (a
    ``DTensor``'s shard, not its global shape) and the collectives, so
    every figure is this rank's.  No loop correction is needed: the port's
    layer loop runs eagerly, so every layer's ops are recorded
    (``models/transformer.py``).  ``pod_size``: when set, a collective
    whose group holds ranks of more than one pod (ranks on both sides of a
    multiple of ``pod_size``; a group it cannot read counts as spanning)
    adds its link bytes to ``cross_pod_link_bytes`` -- the traffic between
    pods."""
    flagged: List[str] = []
    flops = hbm = cross_pod = 0.0
    coll: Dict[str, float] = {}
    n_dots = n_coll = 0
    dots: Dict[Tuple, Dict[str, Any]] = {}
    colls: Dict[Tuple, Dict[str, Any]] = {}
    kernels: Dict[str, Dict[str, float]] = {}
    for call in recording.calls:
        kc = kernel_cost(call)
        if kc is not None:
            dflops, oflops, nbytes = kc
            k = kernels.setdefault(call.op.split(".", 1)[1], dict.fromkeys(
                ("calls", "flops", "bytes"), 0.0))
            k["calls"] += 1
            k["flops"] += dflops + oflops
            k["bytes"] += nbytes
            flops += dflops
            hbm += nbytes
            if dflops:
                n_dots += 1
                _add(dots, call, "flops", dflops)
            continue
        f = dot_flops(call)
        if f is not None:
            flops += f
            n_dots += 1
            _add(dots, call, "flops", f)
        kind = _COLLECTIVES.get(call.op)
        if kind is not None:
            n = len(call.group) or total_devices
            if not call.group:
                flagged.append(f"group-unresolved:{call.op}")
            b = float(sum(sig_bytes(o) for o in call.outputs))
            lb = _ring_bytes(kind, b, n)
            coll[kind] = coll.get(kind, 0.0) + lb
            n_coll += 1
            if pod_size is not None and (
                    not call.group
                    or len({r // pod_size for r in call.group}) > 1):
                cross_pod += lb
            _add(colls, call, "link_bytes", lb, kind=kind, group=n)
            continue
        if call.op not in _NO_TRAFFIC:
            hbm += float(sum(sig_bytes(t) for t in call.inputs)
                         + sum(sig_bytes(t) for t in call.outputs))
    host: Dict[str, float] = {}
    for site, _ in recording.events:
        if site.host_read:
            host[site.op] = host.get(site.op, 0.0) + 1
    return OpCost(dot_flops=flops, hbm_bytes=hbm,
                  collective_link_bytes=sum(coll.values()),
                  collectives_by_kind=coll, n_dots=n_dots,
                  n_collectives=n_coll, flagged=flagged[:20],
                  top_collectives=_top(colls, "link_bytes"),
                  top_dots=_top(dots, "flops"),
                  cross_pod_link_bytes=cross_pod, host_transfers=host,
                  n_host_transfers=int(sum(host.values())), kernels=kernels)


def _add(items, call: OpCall, key: str, value: float, **extra) -> None:
    """Add one call to its (op, site, shape) entry of a top list."""
    shape = str([s for s, _ in call.outputs])[:120]
    entry = items.setdefault((call.op, call.location, shape), dict(
        op=call.op, **extra, **{key: 0.0}, mult=0, shape=shape,
        location=call.location))
    entry[key] += value
    entry["mult"] += 1
