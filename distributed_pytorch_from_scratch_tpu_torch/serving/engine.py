"""Continuous-batching inference engines (counterparts of
`ContinuousBatchingEngine` and `PagedEngine` in the JAX
`serving/engine.py`): the slot engine below, and the paged engine after it
(see `PagedEngine`).

The slot engine's HOST drives a loop of two device programs, built from the
decode lowerings in `models/decode.py`:

* **prefill**: the causal full-buffer forward over a bucket-padded prompt
  buffer (the flash-attention kernel on the card), the per-layer K/V
  written into the target slots' cache rows, and each row's first token;
* **step**: advances ALL slots one token — each row writes its pending
  token's K/V at its own cursor, attends over its prefix, and picks its
  next token. Free slots compute garbage that flows only into garbage.

Step loop: admit (FIFO groups -> prefill) -> one decode dispatch -> retire.
Each dispatch ends in a host copy of the chosen tokens, as the JAX engine's
`np.asarray(tok)` does. TTFT/TPOT/queue-wait are measured per request; the
JAX engine's tracing hooks (span tracer, metrics writer, request tracer,
flight recorder, telemetry, duty profiler, HBM plane) wait for the obs
slice (ROADMAP.md).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_dtype
from ..models.decode import (
    PAGED_ATTN_IMPLS, _decode_one, _paged_decode_one, _paged_prefill_chunk,
    _prefill, make_token_sampler)
from ..ops.rope import rope_tables
from .kv_manager import KVCachePool, PagedKVPool, PoolExhausted
from .scheduler import FIFOScheduler, SLOScheduler


@dataclass
class Request:
    """One generation request. `tokens` fills with the generated ids (EOS
    excluded); the *_t fields are engine-clock samples for the metrics.
    `tenant`/`slo_class` drive the paged engine's SLO scheduler (the FIFO
    scheduler ignores them)."""

    rid: int
    prompt: List[int]
    max_new: int
    seed: int = 0
    arrival: float = 0.0                 # loadgen's planned arrival offset
    tenant: str = "default"              # fair-queuing bucket (SLOScheduler)
    slo_class: Optional[str] = None      # TTFT deadline class (None=default)
    tokens: List[int] = field(default_factory=list)
    submit_t: Optional[float] = None     # entered the admission queue
    admit_t: Optional[float] = None      # left the queue (prefill dispatch)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    prompt_len: int = 0
    limit: int = 0
    deadline_t: Optional[float] = None   # submit_t + class TTFT budget
    preemptions: int = 0                 # times evicted and re-queued

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.submit_t is None or self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token AFTER the first; None with < 2 tokens."""
        if (self.first_token_t is None or self.finish_t is None
                or len(self.tokens) < 2):
            return None
        return (self.finish_t - self.first_token_t) / (len(self.tokens) - 1)


def decode_prompts(engine: "ContinuousBatchingEngine", prompts,
                   max_new, base_seed: int = 0) -> List[List[int]]:
    """Submit `prompts` FIFO with per-request seeds base_seed+i, drain the
    engine, and return the generated ids in PROMPT order. `max_new` is an
    int (shared budget) or a per-prompt sequence."""
    budgets = ([max_new] * len(prompts) if isinstance(max_new, int)
               else list(max_new))
    for i, pr in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=pr, max_new=budgets[i],
                              seed=base_seed + i))
    engine.run_to_completion()
    return [r.tokens for r in sorted(engine.completed, key=lambda r: r.rid)]


def _pow2_at_most(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap) if cap else p


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy that does not wait for the stream (the source
    is pageable memory, which CUDA stages before returning)."""
    return torch.from_numpy(a).to(device, non_blocking=True)


def _chunk_maps(ids, s: int, n: int, cw: int, ps: int, eos_id: int,
                scratch_page: int, tbl_row):
    """Host-side maps of one prefill chunk: the (1, cw) token buffer
    eos-padded past n, and each position's destination page and offset.
    Real positions land in `tbl_row`'s pages at (s+i)//ps, (s+i)%ps; pad
    positions write the scratch page at offsets i % ps, away from live
    rows."""
    buf = np.full((1, cw), eos_id, np.int32)
    buf[0, :n] = ids[s:s + n]
    dstp = np.full((1, cw), scratch_page, np.int32)
    dsto = np.zeros((1, cw), np.int32)
    for i in range(cw):
        if i < n:
            dstp[0, i] = tbl_row[(s + i) // ps]
            dsto[0, i] = (s + i) % ps
        else:
            dsto[0, i] = i % ps
    return buf, dstp, dsto


class ContinuousBatchingEngine:
    """Slot-based continuous batching on one device.

    The JAX engine takes (model, mesh, params, ...); here the model module
    carries its weights, which must already lie on `mesh.device`."""

    def __init__(self, model, mesh, num_slots: int, buf_len: int,
                 eos_id: int, temperature: float = 0.0,
                 prefill_bucket: int = 64, max_prefill_batch: int = 4,
                 max_queue: int = 0):
        if max_prefill_batch < 1:
            raise ValueError(f"max_prefill_batch must be >= 1, got "
                             f"{max_prefill_batch}")
        weights_on = model.embedding.weight.device
        if weights_on != mesh.device:
            raise ValueError(f"model weights lie on {weights_on}, the mesh "
                             f"on {mesh.device}")
        self.model = model
        self.device = mesh.device
        self.buf_len = buf_len
        self.eos_id = int(eos_id)
        self.max_prefill_batch = max_prefill_batch
        self._dtype = resolve_dtype(model.cfg.compute_dtype)
        table_len = max(model.cfg.maxlen, buf_len)
        self._cos, self._sin = rope_tables(table_len, model.cfg.head_dim,
                                           model.cfg.rope_theta, self.device)
        self._sample = make_token_sampler(model, temperature=temperature)
        self.pool = KVCachePool(model, mesh, num_slots, buf_len)
        self.scheduler = FIFOScheduler(buf_len, prefill_bucket=prefill_bucket,
                                       max_queue=max_queue)
        n = num_slots + 1  # + the scratch row (kv_manager.py)
        self._tokens = np.zeros(n, np.int64)
        self._pos = np.zeros(n, np.int64)
        self._slot_req: Dict[int, Request] = {}
        self.completed: List[Request] = []
        # -- aggregate stats ---------------------------------------------
        self.decode_steps = 0
        self.generated_tokens = 0
        self._occupancy_sum = 0.0
        self.prefill_positions = 0            # Σ nb * width dispatched
        self.prefill_positions_monolithic = 0  # Σ rows * buf_len (no bucket)
        self.prompt_tokens = 0
        self.prefill_dispatches = 0

    # -- request intake --------------------------------------------------
    def submit(self, req: Request) -> None:
        """FIFO enqueue (raises scheduler.QueueFull past the bound)."""
        self.scheduler.submit(req)

    def has_work(self) -> bool:
        return bool(self.scheduler.pending or self._slot_req)

    @property
    def live_requests(self) -> int:
        return len(self._slot_req)

    # -- the continuous-batching loop ------------------------------------
    def step(self) -> List[Request]:
        """One engine iteration: admit queued prompts into free slots
        (bucket-grouped prefills), then advance every live slot one token.
        Returns the requests that finished during this iteration."""
        done: List[Request] = []
        with torch.inference_mode():
            self._admit(done)
            if self._slot_req:
                self._decode(done)
        return done

    def run_to_completion(self) -> List[Request]:
        out: List[Request] = []
        while self.has_work():
            out.extend(self.step())
        return out

    # -- internals --------------------------------------------------------
    def _admit(self, done: List[Request]) -> None:
        while self.scheduler.pending and self.pool.free_slots:
            group = self.scheduler.take_batch(
                min(self.pool.free_slots, self.max_prefill_batch))
            if not group:
                break
            now = time.monotonic()
            ready = []
            for req in group:
                req.admit_t = now
                req.prompt_len = len(req.prompt)
                req.limit = min(req.prompt_len + req.max_new, self.buf_len)
                self.prompt_tokens += req.prompt_len
                if req.limit <= req.prompt_len:   # max_new == 0
                    req.finish_t = now
                    self._complete(req, done)
                else:
                    ready.append(req)
            if ready:
                self._prefill_group(ready, done)

    def _prefill_group(self, ready: List[Request], done: List[Request]):
        width = self.scheduler.group_width(ready)
        nb = _pow2_at_most(len(ready), self.max_prefill_batch)
        slots = self.pool.alloc_many(len(ready))
        buf = np.full((nb, width), self.eos_id, np.int64)
        plens = np.ones(nb, np.int64)          # pad rows: 1-token dummy
        slot_idx = np.full(nb, self.pool.scratch_slot, np.int64)
        for i, req in enumerate(ready):
            buf[i, : req.prompt_len] = req.prompt
            plens[i] = req.prompt_len
            slot_idx[i] = slots[i]
        ks, vs, logits = _prefill(self.model, _to_device(buf, self.device),
                                  _to_device(plens, self.device), self._cos,
                                  self._sin, self._dtype)
        # pad rows all aim at the scratch slot, so `idx` repeats it: which
        # duplicate write lands there does not matter, nothing reads it
        idx = _to_device(slot_idx, self.device)
        self.pool.ks[:, idx, :, :width, :] = ks
        self.pool.vs[:, idx, :, :width, :] = vs
        tok = self._sample(logits).cpu().numpy()
        self.prefill_dispatches += 1
        self.prefill_positions += nb * width
        self.prefill_positions_monolithic += len(ready) * self.buf_len
        now = time.monotonic()
        for i, req in enumerate(ready):
            req.first_token_t = now
            first = int(tok[i])
            if first == self.eos_id:              # 0 generated tokens
                req.finish_t = now
                self.pool.free(slots[i])
                self._complete(req, done)
                continue
            slot = slots[i]
            self._slot_req[slot] = req
            self._tokens[slot] = first
            self._pos[slot] = req.prompt_len

    def _decode(self, done: List[Request]) -> None:
        logits = _decode_one(self.model, self.pool.ks, self.pool.vs,
                             _to_device(self._tokens, self.device),
                             _to_device(self._pos, self.device), self.buf_len,
                             self._cos, self._sin, self._dtype)
        tok = self._sample(logits).cpu().numpy()
        now = time.monotonic()
        self.decode_steps += 1
        self._occupancy_sum += self.pool.occupancy
        for slot, req in list(self._slot_req.items()):
            # the pending token was written at `pos` by this dispatch: it
            # is now part of the output
            req.tokens.append(int(self._tokens[slot]))
            self.generated_tokens += 1
            cand = int(tok[slot])
            self._pos[slot] += 1
            gen = len(req.tokens)
            if cand == self.eos_id or req.prompt_len + gen >= req.limit:
                req.finish_t = now
                del self._slot_req[slot]
                self.pool.free(slot)
                self._complete(req, done)
            else:
                self._tokens[slot] = cand

    def _complete(self, req: Request, done: List[Request]) -> None:
        self.completed.append(req)
        done.append(req)

    # -- aggregate view ---------------------------------------------------
    def stats(self) -> dict:
        occ = (self._occupancy_sum / self.decode_steps
               if self.decode_steps else 0.0)
        mono = max(self.prefill_positions_monolithic, 1)
        return {
            "decode_steps": self.decode_steps,
            "generated_tokens": self.generated_tokens,
            "prompt_tokens": self.prompt_tokens,
            "completed": len(self.completed),
            "rejected": self.scheduler.rejected,
            "slot_occupancy_mean": round(occ, 4),
            "prefill_positions": self.prefill_positions,
            # share of the monolithic full-buffer prefill cost that
            # length-bucketing removed (can go negative when bucketing is
            # off but pow2 batch-padding added rows)
            "prefill_pad_waste_eliminated": round(
                1.0 - self.prefill_positions / mono, 4)
            if self.prefill_positions_monolithic else 0.0,
        }


@dataclass
class _PrefillState:
    """Host-side cursor of an in-flight (chunked) prefill: `ids` is the full
    token prefix to materialise (the prompt, plus any tokens a preempted
    request had already generated: the resume-through-prefill path), `s`
    the next position to process, `keys` the page-aligned prefix-index
    chain keys for registration."""

    req: Request
    ids: List[int]
    s: int
    keys: List[object] = field(default_factory=list)


class PagedEngine:
    """Continuous batching over a PAGED KV cache (the JAX `PagedEngine` at
    tp=cp=1, greedy).

    The same host-driven loop as `ContinuousBatchingEngine` — admit, pump
    prefill, one decode dispatch — over a pool of fixed-size pages
    (`kv_manager.PagedKVPool`) indexed through a (slots, max_pages) page
    table:

    * **capacity = live tokens, not worst-case rows**: a slot leases pages
      as its cursor grows; `num_pages` is the budget and oversubscribing
      slots past it is the point.
    * **copy-on-write prefix reuse**: identical prompt prefixes prefill
      once; later arrivals reference the donor's pages through the pool's
      prefix index and copy a page only when they write into it.
    * **chunked prefill**: a prompt prefills `prefill_chunk` positions at a
      time, interleaved with the decode loop, so a live stream's TPOT never
      stalls by more than one chunk.

    Admission is `scheduler.SLOScheduler`; when an overdue request cannot
    be admitted, or a live slot cannot grow a page, a victim is PREEMPTED:
    its pages are released and it re-enters the queue with its generated
    prefix re-prefilled through the COW path (greedy decode restarted from
    prompt + generated gives the same tokens as the uninterrupted run).

    Device work per dispatch: the page table, cursors and tokens go to the
    card in ONE copy, the lowering (`models/decode._paged_decode_one` or
    `_paged_prefill_chunk`) writes the pool in place and attends through
    `paged_attn_impl` — 'kernel' (the CUDA paged-attention kernel; its plain
    version on the CPU) or 'gather' (the dense page view, the oracle) — and
    the only sync is the host copy of the chosen tokens. The JAX engine's
    tracing hooks, handoff methods (disaggregated serving), speculative
    decoding, int8 decode weights and sampled decoding are not ported
    (ROADMAP)."""

    def __init__(self, model, mesh, num_slots: int, buf_len: int,
                 eos_id: int, page_size: int = 64, num_pages: int = 0,
                 prefill_chunk: int = 128, temperature: float = 0.0,
                 slo_classes=None, default_class: str = "standard",
                 max_queue: int = 0, kv_dtype=None,
                 paged_attn_impl: str = "kernel", clock=time.monotonic):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if paged_attn_impl not in PAGED_ATTN_IMPLS:
            raise ValueError(f"paged_attn_impl must be one of "
                             f"{PAGED_ATTN_IMPLS}, got {paged_attn_impl!r}")
        weights_on = model.embedding.weight.device
        if weights_on != mesh.device:
            raise ValueError(f"model weights lie on {weights_on}, the mesh "
                             f"on {mesh.device}")
        # the logical per-request buffer rounds UP to whole pages
        self.page_size = page_size
        self.max_pages = -(-buf_len // page_size)
        self.buf_len = self.max_pages * page_size
        if not num_pages:
            num_pages = num_slots * self.max_pages  # no oversubscription
        self.model = model
        self.device = mesh.device
        self.num_slots = num_slots
        self.eos_id = int(eos_id)
        self.prefill_chunk = prefill_chunk
        self._clock = clock
        self._dtype = resolve_dtype(model.cfg.compute_dtype)
        table_len = max(model.cfg.maxlen, self.buf_len)
        self._cos, self._sin = rope_tables(table_len, model.cfg.head_dim,
                                           model.cfg.rope_theta, self.device)
        self._sample = make_token_sampler(model, temperature=temperature)
        self.paged_attn_impl = paged_attn_impl
        self.kv_dtype = kv_dtype
        self.pool = PagedKVPool(model, mesh, num_pages, page_size,
                                kv_dtype=kv_dtype)
        self.scheduler = SLOScheduler(self.buf_len, classes=slo_classes,
                                      default_class=default_class,
                                      max_queue=max_queue, clock=clock)
        self._free_slots = deque(range(num_slots))
        # (slots, max_pages) page table; free rows aim at the scratch page
        self._tbl = np.full((num_slots, self.max_pages),
                            self.pool.scratch_page, np.int32)
        self._tokens = np.zeros(num_slots, np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._slot_req: Dict[int, Request] = {}
        self._prefilling: Dict[int, _PrefillState] = {}
        self.completed: List[Request] = []
        # -- aggregate stats ---------------------------------------------
        self.decode_steps = 0
        self.prefill_dispatches = 0         # chunk dispatches
        self.generated_tokens = 0
        self.prompt_tokens = 0
        self.prefill_positions = 0          # positions actually dispatched
        self.prefill_token_demand = 0       # sum of len(ids) at admissions
        self.prefix_hit_tokens = 0          # positions served from shared pages
        self.preemptions = 0
        self.max_live = 0
        self.max_interleaved_prefill = 0    # the chunk stall bound, measured
        self._occupancy_sum = 0.0
        self._kv_util_sum = 0.0
        self._pages_used_sum = 0

    # -- request intake ---------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue through the SLO scheduler (QueueFull past the
        backpressure bound). Refuses up front a request whose WORST-CASE
        private footprint cannot fit the page pool — admitted, it would
        deadlock preemption once it became the only live request."""
        need = -(-min(len(req.prompt) + req.max_new, self.buf_len)
                 // self.page_size)
        if need > self.pool.num_pages:
            raise ValueError(
                f"request {req.rid}: needs up to {need} pages "
                f"({len(req.prompt)}+{req.max_new} tokens / page_size "
                f"{self.page_size}) but the pool has {self.pool.num_pages} "
                f"— raise --num_pages or lower the budget")
        self.scheduler.submit(req)

    def has_work(self) -> bool:
        return bool(self.scheduler.pending or self._slot_req
                    or self._prefilling)

    @property
    def live_requests(self) -> int:
        return len(self._slot_req) + len(self._prefilling)

    # -- the engine loop --------------------------------------------------
    def step(self) -> List[Request]:
        """One iteration: admit (slots + shared-prefix match), pump AT MOST
        one chunk of prefill while streams are live (the TPOT stall bound),
        then advance every live slot one token."""
        done: List[Request] = []
        with torch.inference_mode():
            self._admit(done)
            self._pump_prefill(done)
            if self._slot_req:
                self._decode(done)
        self.max_live = max(self.max_live, self.live_requests)
        return done

    def run_to_completion(self) -> List[Request]:
        out: List[Request] = []
        while self.has_work():
            out.extend(self.step())
        return out

    # -- internals --------------------------------------------------------
    def _chain_keys(self, ids: List[int]) -> List[object]:
        """Prefix-index chain keys for every page-aligned run of `ids` (the
        last may be partial)."""
        ps, keys, parent = self.page_size, [], None
        for j in range(-(-len(ids) // ps)):
            parent = self.pool.chain_key(parent, ids[j * ps:(j + 1) * ps])
            keys.append(parent)
        return keys

    def _try_share(self, slot: int, st: _PrefillState) -> None:
        """At a page boundary, extend the slot's prefix through the pool's
        index instead of recomputing it: a donor page whose valid tokens
        lead-match the remaining ids is referenced in place (refcount++) and
        the cursor jumps past the shared run. A partial match still shares
        the matched positions (visibility masks the rest) but ends the walk.
        Capped at len(ids)-1 so at least one position is recomputed (its
        logits give the first sampled token)."""
        ps = self.page_size
        while st.s % ps == 0:
            cap = len(st.ids) - 1 - st.s
            if cap <= 0:
                break
            j = st.s // ps
            parent = st.keys[j - 1] if j else None
            window = st.ids[st.s:st.s + min(ps, cap)]
            best_page, best_len = None, 0
            for page, toks in self.pool.children(parent):
                n = 0
                for a, b in zip(toks, window):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best_page, best_len = page, n
            if best_len == 0:
                break
            self.pool.ref(best_page)
            self._tbl[slot, j] = best_page
            st.s += best_len
            self.prefix_hit_tokens += best_len
            if best_len < ps:
                break                      # partial match ends the walk

    def _admit(self, done: List[Request]) -> None:
        while self._free_slots or self.scheduler.pending:
            req = self.scheduler.peek()
            if req is None:
                break
            now = self._clock()
            overdue = req.deadline_t is not None and now >= req.deadline_t
            if not self._free_slots:
                # an overdue head may evict a looser-class victim
                if not (overdue and self._preempt_for(req)):
                    break
                continue
            ids = req.prompt + req.tokens
            # gate on the pages the FIRST chunk needs (prefix sharing,
            # resolved at chunk time, can only reduce it)
            need = -(-min(len(ids), self.prefill_chunk) // self.page_size)
            if not need <= self.pool.free_pages:
                if not (overdue and self._preempt_for(req)):
                    break
                continue
            self.scheduler.take()
            if req.admit_t is None:
                req.admit_t = now
                req.prompt_len = len(req.prompt)
                req.limit = min(req.prompt_len + req.max_new, self.buf_len)
                self.prompt_tokens += req.prompt_len
            if req.limit <= len(ids):      # max_new == 0
                req.finish_t = now
                self._complete(req, done)
                continue
            slot = self._free_slots.popleft()
            self.prefill_token_demand += len(ids)
            st = _PrefillState(req, ids, 0)
            st.keys = self._chain_keys(ids)
            self._prefilling[slot] = st

    def _candidates(self, exclude_slot=None):
        """Live + prefilling requests preemption may evict, worst first:
        loosest deadline class, then most generated tokens, then latest
        admission."""
        cands = [(slot, req) for slot, req in self._slot_req.items()
                 if slot != exclude_slot]
        cands += [(slot, st.req) for slot, st in self._prefilling.items()
                  if slot != exclude_slot]
        classes = self.scheduler.classes
        cands.sort(key=lambda sr: (-classes.get(sr[1].slo_class, 0.0),
                                   -len(sr[1].tokens),
                                   -(sr[1].admit_t or 0.0)))
        return cands

    def _preempt_for(self, req) -> bool:
        """Evict one victim from a STRICTLY looser deadline class than
        `req` (same-class work is never displaced: that would ping-pong).
        Returns True when something was freed."""
        classes = self.scheduler.classes
        bound = classes[req.slo_class or self.scheduler.default_class]
        for slot, victim in self._candidates():
            if classes.get(victim.slo_class, 0.0) > bound:
                self._preempt(slot)
                return True
        return False

    def _preempt(self, slot: int) -> None:
        """Evict a slot: pages unref'd (shared ones survive for their
        sharers), the request re-queued with prompt + generated as its new
        prefill prefix; its pending token is dropped (the resume prefill
        derives it again)."""
        if slot in self._slot_req:
            req = self._slot_req.pop(slot)
        else:
            req = self._prefilling.pop(slot).req
        self._release_slot(slot)
        req.preemptions += 1
        self.preemptions += 1
        self.scheduler.requeue(req)

    def _release_slot(self, slot: int) -> None:
        """Drop the slot's page references; its table row goes back to the
        scratch page and its cursor to 0, so a dense dispatch over every
        slot row keeps the free row in range and writing only scratch."""
        scratch = self.pool.scratch_page
        for j in range(self.max_pages):
            if self._tbl[slot, j] != scratch:
                self.pool.unref(int(self._tbl[slot, j]))
                self._tbl[slot, j] = scratch
        self._pos[slot] = 0
        self._free_slots.append(slot)

    def _alloc_page(self, needy_slot: int) -> int:
        """A free page, evicting victims while the pool is dry (never the
        needy slot itself). Submit-time validation guarantees a sole live
        request fits, so exhaustion with no victim cannot happen."""
        while True:
            try:
                return self.pool.alloc()
            except PoolExhausted:
                cands = self._candidates(exclude_slot=needy_slot)
                if not cands:
                    raise RuntimeError(
                        "page pool exhausted with no preemption candidate "
                        "— a single request outgrew num_pages (submit-time "
                        "validation should have refused it)")
                self._preempt(cands[0][0])

    def _ensure_writable(self, slot: int, lo: int, hi: int) -> None:
        """Positions [lo, hi) of `slot` must land in PRIVATE pages before a
        write dispatch: unmapped entries allocate, shared entries
        copy-on-write (one copy dispatch)."""
        ps, scratch = self.page_size, self.pool.scratch_page
        pairs = []
        for j in range(lo // ps, -(-hi // ps)):
            pid = int(self._tbl[slot, j])
            if pid == scratch:
                self._tbl[slot, j] = self._alloc_page(slot)
            elif self.pool.refcount[pid] > 1:
                new = self._alloc_page(slot)
                pairs.append((pid, new))
                self.pool.unref(pid)
                self._tbl[slot, j] = new
        self.pool.copy_pages(pairs)

    def _pump_prefill(self, done: List[Request]) -> None:
        """Advance prefills chunk by chunk. While ANY stream is live
        decoding, at most `prefill_chunk` positions are dispatched per
        engine step (`max_interleaved_prefill` records the realised max)."""
        interleaved = 0
        while self._prefilling:
            live_before = bool(self._slot_req)
            if live_before and interleaved >= self.prefill_chunk:
                break
            slot, st = next(iter(self._prefilling.items()))
            self._try_share(slot, st)      # COW prefix reuse, page-aligned
            budget = (self.prefill_chunk - interleaved if live_before
                      else self.prefill_chunk)
            n = min(len(st.ids) - st.s, budget)
            self._dispatch_chunk(slot, st, n, done)
            if live_before:
                interleaved += n
        self.max_interleaved_prefill = max(self.max_interleaved_prefill,
                                           interleaved)

    def _dispatch_chunk(self, slot: int, st: _PrefillState, n: int,
                        done: List[Request]) -> None:
        ps, mp = self.page_size, self.max_pages
        s, ids = st.s, st.ids
        self._ensure_writable(slot, s, s + n)
        cw = _pow2_at_most(n, self.prefill_chunk)
        buf, dstp, dsto = _chunk_maps(ids, s, n, cw, ps, self.eos_id,
                                      self.pool.scratch_page,
                                      self._tbl[slot])
        # one copy: tokens | start | qlen | table row | dst pages | offsets
        packed = np.concatenate([buf[0], np.array([s, n], np.int32),
                                 self._tbl[slot], dstp[0], dsto[0]])
        dev = _to_device(packed, self.device)
        o = cw + 2 + mp
        logits = _paged_prefill_chunk(
            self.model, self.pool.ks, self.pool.vs, dev[None, :cw],
            dev[cw:cw + 1], dev[cw + 1:cw + 2], dev[None, cw + 2:o],
            dev[None, o:o + cw], dev[None, o + cw:], ps, self._cos,
            self._sin, self._dtype, attn_impl=self.paged_attn_impl)
        tok = self._sample(logits).cpu().numpy()
        self.prefill_dispatches += 1
        self.prefill_positions += n
        # register freshly completed prompt pages in the prefix index: full
        # pages whose last position this chunk wrote, and the partial tail
        # once the whole prefix is in (shared donors dedupe inside
        # register_prefix)
        for j in range(s // ps, -(-(s + n) // ps)):
            end = min((j + 1) * ps, len(ids))
            if s + n >= end:
                parent = st.keys[j - 1] if j else None
                self.pool.register_prefix(parent, int(self._tbl[slot, j]),
                                          ids[j * ps:end])
        st.s += n
        if st.s >= len(ids):
            self._finish_prefill(slot, st, int(tok[0]), done)

    def _finish_prefill(self, slot: int, st: _PrefillState, first: int,
                        done: List[Request]) -> None:
        req = st.req
        del self._prefilling[slot]
        now = self._clock()
        if req.first_token_t is None:
            req.first_token_t = now
        if first == self.eos_id:              # 0 (more) generated tokens
            req.finish_t = now
            self._release_slot(slot)
            self._complete(req, done)
            return
        self._slot_req[slot] = req
        self._tokens[slot] = first
        self._pos[slot] = len(st.ids)

    def _decode(self, done: List[Request]) -> None:
        # grow/privatise the write page of every live slot FIRST — this may
        # itself preempt victims (page exhaustion), so iterate a snapshot
        # and re-check liveness
        for slot in list(self._slot_req):
            if slot not in self._slot_req:
                continue
            pos = int(self._pos[slot])
            self._ensure_writable(slot, pos, pos + 1)
        if not self._slot_req:
            return
        # the dispatch is dense over ALL slot rows, and a non-live row (a
        # slot mid-prefill, or freed this step) still flows through it with
        # cursor 0 and a stale pending token — so its position-0 K/V write
        # must land on the scratch page, NOT the real (possibly shared)
        # page its table maps. Freed slots' tables are already all-scratch;
        # mid-prefill slots' are not, so they are masked here.
        tbl = self._tbl
        if self._prefilling:
            tbl = self._tbl.copy()
            for slot in self._prefilling:
                tbl[slot, :] = self.pool.scratch_page
        n = self.num_slots
        # one copy: pending tokens | cursors | page table
        dev = _to_device(np.concatenate([self._tokens, self._pos,
                                         tbl.ravel()]), self.device)
        logits = _paged_decode_one(
            self.model, self.pool.ks, self.pool.vs, dev[:n], dev[n:2 * n],
            dev[2 * n:].view(n, self.max_pages), self.page_size, self._cos,
            self._sin, self._dtype, attn_impl=self.paged_attn_impl)
        tok = self._sample(logits).cpu().numpy()
        now = self._clock()
        self.decode_steps += 1
        live_tokens = sum(int(self._pos[s]) + 1 for s in self._slot_req)
        live_tokens += sum(st.s for st in self._prefilling.values())
        used = self.pool.pages_in_use
        self._occupancy_sum += self.live_requests / self.num_slots
        self._pages_used_sum += used
        if used:
            self._kv_util_sum += live_tokens / (used * self.page_size)
        for slot, req in list(self._slot_req.items()):
            # the pending token was written at `pos` by this dispatch: it
            # is now part of the output
            req.tokens.append(int(self._tokens[slot]))
            self.generated_tokens += 1
            cand = int(tok[slot])
            self._pos[slot] += 1
            if (cand == self.eos_id
                    or req.prompt_len + len(req.tokens) >= req.limit):
                req.finish_t = now
                del self._slot_req[slot]
                self._release_slot(slot)
                self._complete(req, done)
            else:
                self._tokens[slot] = cand

    def _complete(self, req: Request, done: List[Request]) -> None:
        self.completed.append(req)
        done.append(req)

    # -- aggregate view ---------------------------------------------------
    def stats(self) -> dict:
        steps = max(self.decode_steps, 1)
        demand = max(self.prefill_token_demand, 1)
        mean = lambda total: total / steps if self.decode_steps else 0.0
        return {
            "decode_steps": self.decode_steps,
            "generated_tokens": self.generated_tokens,
            "prompt_tokens": self.prompt_tokens,
            "completed": len(self.completed),
            "rejected": self.scheduler.rejected,
            "slot_occupancy_mean": round(mean(self._occupancy_sum), 4),
            "prefill_positions": self.prefill_positions,
            # -- token-granular occupancy ---------------------------------
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype or "native",
            "paged_attn": self.paged_attn_impl,
            "cp": 1,
            "pages_per_rank": self.pool.num_pages,
            "num_pages": self.pool.num_pages,
            "pages_in_use": self.pool.pages_in_use,
            "pages_in_use_mean": round(mean(self._pages_used_sum), 2),
            # live tokens / allocated page positions: 1.0 = no dead space
            "kv_util_mean": round(mean(self._kv_util_sum), 4),
            "kv_fragmentation_mean": round(
                1.0 - self._kv_util_sum / steps
                if self.decode_steps else 0.0, 4),
            # -- COW prefix cache -----------------------------------------
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": round(self.prefix_hit_tokens / demand, 4)
            if self.prefill_token_demand else 0.0,
            "cow_copies": self.pool.cow_copies,
            # -- scheduler/preemption -------------------------------------
            "preemptions": self.preemptions,
            "max_live": self.max_live,
            "max_interleaved_prefill_positions": self.max_interleaved_prefill,
        }
