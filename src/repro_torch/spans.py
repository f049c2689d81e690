"""Spans: named stretches of the federated round, stamped on the device
inside a fused block and on the host around the block's set-up.

A span records its name, its begin and end in nanoseconds, its parent (the
span open around it, by index in its block's list), the global round it
belongs to (``round_offset + i``: the identifier every span of one round
shares) and at most one work count.

**Device spans.** ``make_fused_rounds``' block function activates a
:class:`Recorder` around its body (:func:`recording`).  Inside it,
``with span(name, count):`` stamps once at entry and once at exit; outside
a recording ``span`` returns at once.  On the card a stamp is one launch of
``fl_span_stamp`` (``csrc/span_stamp.cu``) on the current stream, which
writes ``%globaltimer`` into one slot of the recorder's int64 buffer: in a
captured CUDA graph each stamp is a kernel node, and every replay writes
the block's stamps anew.  On the CPU a stamp is ``time.perf_counter_ns()``.
The block hands the buffer out with its logs (``logs["spans"]``, as int32
words, two a stamp, low word first, which the block's one float64 log copy
carries exactly).  The slot schema (name, parent, round within the block,
count, the two slots) is fixed per capture and kept on the host beside the
graph; ``Server.finish_block`` decodes the fetched words into
:class:`Span` s (:func:`record_block`).

A stamp passes no batched tensor, so ``torch.func.vmap`` does not see it:
a span opened inside the vmapped client update is one span for all
clients.  Its count is per client, as the shapes inside show it, and the
engine multiplies the counts opened under :func:`batched` by the
participant count.

**Host spans** (:func:`host`): the set-up's eager warm-up round and each
graph capture, on ``perf_counter_ns``, each also a profiler range of the
same name (:func:`host_range`), so a profiler trace shows it on the
profiler's host clock.

**The log** is bounded and in memory: :data:`BLOCKS` keeps the last
``BLOCKS_KEPT`` blocks' spans, :data:`SETUP` the last ``BLOCKS_KEPT`` host
spans.  Each round engine takes an owner number (:func:`new_owner`) that
tags what it records, so a reader can take the latest engine's alone.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

BLOCKS_KEPT = 64
CHUNK = 1024                 # stamps one chunk of a device buffer holds


class Span(NamedTuple):
    name: str
    begin_ns: int
    end_ns: int
    parent: Optional[int]    # index of the enclosing span in its list
    round: Optional[int]     # the global round
    count: Optional[int]     # its work count

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.begin_ns) / 1e9


class Slot(NamedTuple):
    """One span of a block's schema: its stamps' two slots in the buffer."""
    name: str
    parent: Optional[int]
    round: Optional[int]     # within the block
    count: Optional[int]
    begin: int
    end: int


class Block(NamedTuple):
    owner: int
    round_offset: int
    spans: Tuple[Span, ...]


BLOCKS: Deque[Block] = deque(maxlen=BLOCKS_KEPT)
SETUP: Deque[Tuple[Optional[int], Span]] = deque(maxlen=BLOCKS_KEPT)

_owners = itertools.count(1)
_active: Optional["Recorder"] = None
_lib = None


def new_owner() -> int:
    """A fresh owner number for a round engine's records."""
    return next(_owners)


def build():
    """Compile ``csrc/span_stamp.cu`` unless its library is built; returns
    the library's path."""
    from repro_torch.kernels import nvcc
    return nvcc.build(nvcc.SOURCE_DIR / "span_stamp.cu")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.span_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
        lib.span_stamp.restype = ctypes.c_int
        _lib = lib
    return _lib


class Recorder:
    """The device spans of one block: the schema on the host, the stamps
    in chunks of ``CHUNK`` int64 slots on the device (a host list on the
    CPU)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.slots: List[list] = []
        self.scale = 1
        self.n = 0
        self._open: List[Tuple[int, Optional[int]]] = []
        self._round: Optional[int] = None
        self._cuda = self.device.type == "cuda"
        self._chunks: List[torch.Tensor] = []
        self._host: List[int] = []
        if self._cuda:
            self._grow()

    def _grow(self):
        # plain storage even inside a torch.func transform, which would
        # wrap a tensor made there in one that has none
        with torch._C._DisableFuncTorch():
            self._chunks.append(torch.empty(CHUNK, dtype=torch.int64,
                                            device=self.device))

    def _stamp(self) -> int:
        slot = self.n
        self.n += 1
        if not self._cuda:
            self._host.append(time.perf_counter_ns())
            return slot
        j, k = divmod(slot, CHUNK)
        if j == len(self._chunks):
            self._grow()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _load().span_stamp(self._chunks[j].data_ptr(), k, stream)
        if err != 0:
            raise RuntimeError(f"span stamp launch failed: cudaError {err}")
        return slot

    def open(self, name: str, count, round) -> int:
        idx = len(self.slots)
        parent = self._open[-1][0] if self._open else None
        self._open.append((idx, self._round))
        if round is not None:
            self._round = round
        self.slots.append([name, parent, self._round,
                           None if count is None else int(count) * self.scale,
                           self._stamp(), None])
        return idx

    def close(self, idx: int):
        self.slots[idx][5] = self._stamp()
        _, self._round = self._open.pop()

    def finish(self) -> Tuple[torch.Tensor, Tuple[Slot, ...]]:
        """The stamps as int32 words (two a stamp, low word first) and the
        schema."""
        if self._cuda:
            used = self._chunks[:max(1, -(-self.n // CHUNK))]
            buf = (used[0] if len(used) == 1 else torch.cat(used))[:self.n]
        else:
            # written through numpy: a tensor made from host data would be
            # an op that reads the host, which a block may not issue
            buf = torch.empty(self.n, dtype=torch.int64)
            buf.numpy()[:] = self._host
        return buf.view(torch.int32), tuple(Slot(*s) for s in self.slots)


class _Open:
    __slots__ = ("rec", "name", "count", "round", "idx")

    def __init__(self, rec, name, count, round):
        self.rec, self.name, self.count, self.round = rec, name, count, round

    def __enter__(self):
        self.idx = self.rec.open(self.name, self.count, self.round)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.idx)
        return False


_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def recording(device):
    """Activate a fresh :class:`Recorder` on ``device`` for the body."""
    global _active
    rec, prev = Recorder(device), _active
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


def span(name: str, count=None, round: Optional[int] = None):
    """A device span around the body, while a recorder is active (else a
    no-op).  ``round``: the round within the block that the span and the
    spans inside it belong to."""
    rec = _active
    if rec is None:
        return _NULL
    return _Open(rec, name, count, round)


@contextlib.contextmanager
def batched(n: int):
    """Counts of spans opened in the body are per one of ``n`` clients
    under ``torch.func.vmap``: multiply them by ``n``."""
    rec = _active
    if rec is None:
        yield
        return
    prev = rec.scale
    rec.scale = prev * int(n)
    try:
        yield
    finally:
        rec.scale = prev


def host_range(name: str):
    """A profiler range on the host alone: a plain CPU-op range.  A
    ``torch.profiler.record_function`` range is a user annotation, which
    the profiler mirrors onto the device's timeline as one span over every
    kernel launched under it, and that span would count as device activity
    in a trace; a torch without the plain kind gets no range."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return contextlib.nullcontext() if fast is None else fast(name)


class Timed:
    """What :func:`host` yields: its span once the body has ended."""
    span: Optional[Span] = None

    @property
    def seconds(self) -> float:
        return self.span.seconds


@contextlib.contextmanager
def host(name: str, owner: Optional[int] = None):
    """A host span around the body, on ``perf_counter_ns``, kept in
    :data:`SETUP` under ``owner`` and opened as a profiler range of the
    same name (:func:`host_range`).  A body that raises records nothing."""
    timed = Timed()
    with host_range(name):
        t0 = time.perf_counter_ns()
        yield timed
        timed.span = Span(name, t0, time.perf_counter_ns(), None, None, None)
    SETUP.append((owner, timed.span))


def decode(schema: Tuple[Slot, ...], words, round_offset: int
           ) -> Tuple[Span, ...]:
    """A block's spans from its schema and its fetched int32 words."""
    w = np.asarray(words).astype(np.int64)
    stamps = (w[1::2] << 32) | (w[0::2] & 0xFFFFFFFF)
    return tuple(Span(s.name, int(stamps[s.begin]), int(stamps[s.end]),
                      s.parent,
                      None if s.round is None else round_offset + s.round,
                      s.count) for s in schema)


def record_block(owner: int, round_offset: int, schema, words) -> None:
    """Decode a fetched block's spans and append them to :data:`BLOCKS`."""
    BLOCKS.append(Block(owner, round_offset,
                        decode(schema, words, round_offset)))
