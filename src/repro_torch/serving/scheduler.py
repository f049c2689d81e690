"""Continuous-batching serving scheduler: the port of
``repro/serving/scheduler.py``.

A fixed pool of ``max_batch`` decode slots shares one batched cache.
Incoming requests are prefilled one at a time (B = 1) into a fresh cache,
which is written into a free slot; every engine step decodes ALL slots in
one batched decode with **per-slot cache positions** (a (B,) ``cache_pos``,
see ``repro_torch.models.attention``).  Finished requests free their slot
at once, so new work joins mid-flight, without waiting for the batch to
drain.

On the card, a B = 1 prefill takes the flash kernel's tensor-core route at
any prompt length and a decode step its split-K route with a (B,)
``kv_len``; Mamba and xLSTM states are per-slot rows of the cache, written
by ``_write_slot``.  Slot bookkeeping is on the host; the greedy tokens of
a step come back in one host sync, as the reference's ``device_get``.

Every slot's position advances each step, empty slots too, as the
reference's (``:110`` there): a slot freed at a high position passes the
cache's end while the others decode, and its writes land on the cache's
last position (``attention._write_at`` clamps as ``dynamic_update_slice``
does) until the next admit overwrites the row.  MLA (DeepSeek-V2) takes no
per-slot positions, in the reference either, and raises at the first
decode.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: torch.Tensor             # (prompt_len,) integer tokens
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the server:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _write_slot(batched, single, slot: int):
    """Write a B = 1 cache tree into slot ``slot`` of the batched cache, in
    place (leaves are (G, B, ...): the slot is dim 1)."""
    def upd(b, s):
        b[:, slot:slot + 1] = s.to(b.dtype)
        return b
    return tree.map(upd, batched, single)


class BatchedServer:
    """Greedy decoding (the reference's ``greedy`` flag, which nothing
    reads, is not kept).  ``params`` must live on ``device`` (the card
    unless the CPU is asked for)."""

    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_len: int = 256, window: Optional[int] = None,
                 device: str = "cuda"):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.B = max_batch
        self.max_len = max_len
        self.window = window
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        # per-slot decode positions
        self.pos = torch.zeros((max_batch,), dtype=torch.int32,
                               device=self.device)
        self.budget = [0] * max_batch
        self.cache = model.cache_init(max_batch, max_len, device=self.device)
        self._stats = {"steps": 0, "prefills": 0, "completed": 0}

    # ------------------------------------------------------------- api --
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.B):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            plen = int(req.prompt.shape[0])
            assert plen + req.max_new_tokens <= self.max_len
            cache1 = self.model.cache_init(1, self.max_len, device=self.device)
            logits, cache1, _ = self.model.apply(
                self.params, {"tokens": req.prompt.to(self.device)[None, :]},
                mode="prefill", cache=cache1)
            _write_slot(self.cache, cache1, slot)
            req.output.append(int(logits[0, -1].argmax()))
            self.slots[slot] = req
            self.pos[slot] = plen
            self.budget[slot] = req.max_new_tokens - 1
            self._stats["prefills"] += 1

    def step(self) -> int:
        """One engine step: admit + one batched decode.  Returns the
        number of active slots."""
        self._admit()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            return 0
        tok = torch.tensor([[self.slots[s].output[-1]
                             if self.slots[s] is not None else 0]
                            for s in range(self.B)], dtype=torch.int32,
                           device=self.device)
        logits, self.cache, _ = self.model.apply(
            self.params, {"tokens": tok}, mode="decode", cache=self.cache,
            cache_pos=self.pos, window=self.window)
        self.pos = self.pos + 1
        next_tok = logits[:, 0].argmax(-1).tolist()
        self._stats["steps"] += 1
        for s in active:
            req = self.slots[s]
            t = next_tok[s]
            req.output.append(t)
            self.budget[s] -= 1
            if self.budget[s] <= 0 or (req.eos_id is not None
                                       and t == req.eos_id):
                req.done = True
                self.slots[s] = None
                self._stats["completed"] += 1
        return len(active)

    def run(self, max_steps: int = 10_000) -> Dict[str, int]:
        while (self.queue or any(self.slots)) and max_steps:
            self.step()
            max_steps -= 1
        return dict(self._stats)
