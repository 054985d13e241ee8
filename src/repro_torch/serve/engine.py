"""Batched serving engine with continuous batching over the Roaring-paged KV
cache.

Flow: requests enter a queue; each engine step (1) admits new requests into
free batch slots, allocating pages from the RoaringPageTable, (2) runs one
``decode_step_paged`` over the whole batch for each fed token, (3) retires
finished sequences, returning their pages via Roaring OR into the free
bitmap. Prefill is token-streamed through the same decode path.

Admission backpressure: page-pool exhaustion during prefill or decode does
not crash the engine. The starved request is evicted — its pages (including
any partial allocation) go back to the pool via ``RoaringPageTable.release``
— and requeued at the head of the queue to be re-admitted once a resident
sequence retires (``requeues`` counts these). Only when *no other sequence
holds pages* does the original ``MemoryError`` propagate.

One difference from the reference engine: a step writes K/V only for the
row it advances. The reference scatters every row's K/V, and a row that is
empty, or whose next position starts a page it has not allocated, finds
the zero padding of ``gather_lists`` there and overwrites position 0 of
physical page 0 — another live sequence's first token. Its tokens are
right only at ``max_batch=1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch import _device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

from .kv_cache import RoaringPageTable


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray                       # i32[prompt_len]
    max_new_tokens: int = 16
    eos_id: int = -1                         # -1: never stop early
    generated: Optional[List[int]] = None
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 n_pages: int = 256, page_size: int = 16,
                 max_pages_per_seq: int = 32, device=None):
        if not all(k.startswith("attn") for k in cfg.block_kinds()):
            raise ValueError(
                f"{cfg.name}: the paged engine serves attention-pattern "
                "archs; Mamba / RWKV patterns decode over state caches with "
                "models.transformer.decode_step")
        self.cfg = cfg
        self.params = params
        self.device = _device.resolve(device)
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.table = RoaringPageTable(n_pages, page_size, device=self.device)
        self.pools = T.init_paged_caches(cfg, n_pages, page_size,
                                         device=self.device)
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.slots: List[Optional[int]] = [None] * max_batch
        self.pos: Dict[int, int] = {}
        self.steps_run = 0
        self.requeues = 0

    def submit(self, req: Request) -> None:
        req.generated = []
        self.queue.append(req)

    def _others_hold_pages(self, rid: int) -> bool:
        """True when any *other* sequence holds pages — i.e. eviction +
        retry can eventually succeed; False means the pool alone is too
        small for this request and requeueing would spin forever."""
        return any(s != rid and pages
                   for s, pages in self.table.seq_pages.items())

    def _evict_requeue(self, slot: int) -> None:
        """Backpressure: push the starved sequence out of its slot, return
        every page it holds (partial allocations included), and requeue it
        from scratch at the head of the queue."""
        rid = self.slots[slot]
        req = self.active.pop(rid)
        self.table.release(rid)
        self.slots[slot] = None
        self.pos.pop(rid, None)
        req.generated = []
        self.requeues += 1
        self.queue.insert(0, req)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req.req_id
                self.active[req.req_id] = req
                self.pos[req.req_id] = 0
        # prefill admitted sequences token by token
        for i, rid in enumerate(self.slots):
            if rid is None:
                continue
            req = self.active[rid]
            try:
                while self.pos[rid] < len(req.prompt) - 1:
                    self._advance(i, int(req.prompt[self.pos[rid]]),
                                  sample=False)
            except MemoryError:
                if not self._others_hold_pages(rid):
                    raise          # can never fit: pool < one request
                self._evict_requeue(i)

    def _batch_arrays(self):
        B = self.max_batch
        page_idx = np.zeros((B, self.max_pages), np.int32)
        counts = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        for i, rid in enumerate(self.slots):
            if rid is None:
                continue
            pi, cn, ln = self.table.gather_lists([rid], self.max_pages)
            page_idx[i], counts[i], lengths[i] = pi[0], cn[0], ln[0]
            pos[i] = self.pos[rid]
        return page_idx, counts, lengths, pos

    def _advance(self, slot: int, token: int, sample: bool) -> Optional[int]:
        """Feed `token` for the sequence in `slot`; optionally return the
        sampled next token. The step runs the whole batch, and only this
        slot's K/V is written."""
        rid = self.slots[slot]
        self.table.alloc(rid, 1)
        page_idx, counts, lengths, pos = self._batch_arrays()
        tok = np.zeros((self.max_batch, 1), np.int32)
        tok[slot, 0] = token
        lengths = np.maximum(lengths - 1, 0)     # decode adds the new token
        write = torch.zeros((self.max_batch,), dtype=torch.bool)
        write[slot] = True

        def dev(a):
            return torch.from_numpy(a).to(self.device)
        logits, self.pools = T.decode_step_paged(
            self.params, self.pools, dev(tok), dev(pos), dev(page_idx),
            dev(counts), dev(lengths), self.cfg, write=write)
        self.pos[rid] += 1
        self.steps_run += 1
        if sample:
            return int(torch.argmax(logits[slot, 0].float()))
        return None

    def _publish_gauges(self) -> None:
        """Refresh the serving gauges (queue depth, page pool) on the
        ``repro_torch.obs`` registry — called per step while telemetry is
        on, under the same names as the search service's gauges
        (``obs.publish_service_gauges``)."""
        obs.publish_service_gauges(
            "serve", queue_depth=len(self.queue), active=len(self.active),
            requeues=self.requeues, steps=self.steps_run,
            **{"page_pool.free_pages": len(self.table.free),
               "page_pool.utilization": float(self.table.utilization())})

    def step(self) -> None:
        """One continuous-batching iteration: admit, decode, retire."""
        with obs.span("serve.step"):
            self._step()
        if obs.enabled():
            self._publish_gauges()

    def _step(self) -> None:
        self._admit()
        active_slots = [i for i, r in enumerate(self.slots) if r is not None]
        for i in active_slots:
            rid = self.slots[i]
            req = self.active[rid]
            nxt_in = (int(req.prompt[-1]) if not req.generated
                      else req.generated[-1])
            try:
                out = self._advance(i, nxt_in, sample=True)
            except MemoryError:
                if not self._others_hold_pages(rid):
                    raise          # can never fit: pool < one request
                self._evict_requeue(i)
                continue
            req.generated.append(out)
            if (len(req.generated) >= req.max_new_tokens
                    or out == req.eos_id):
                req.done = True
                self.table.release(rid)
                self.slots[i] = None
                del self.active[rid]
                del self.pos[rid]

    def run_until_done(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.queue and not self.active:
                return
            self.step()

    def utilization(self) -> float:
        return self.table.utilization()
