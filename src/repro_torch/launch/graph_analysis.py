"""Read a captured block's CUDA graph: its nodes by kind, and buffer reuse.

The port's counterpart of ``count_host_transfers`` and
``parse_input_output_aliases`` in ``repro.launch.hlo_analysis``: the
reference reads them from compiled HLO text, the port from the CUDA graph
that the card replays for a fused block
(:class:`repro_torch.core.engine.CapturedBlock`).

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

The cost model of ``hlo_analysis.analyze`` is not ported here.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis.walker import tensors

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
