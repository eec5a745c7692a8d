"""Continuous-batching inference engine over the slot-granular KV pool
(counterpart of `ContinuousBatchingEngine` in the JAX `serving/engine.py`).

The HOST drives a loop of two device programs, built from the decode
lowerings in `models/decode.py`:

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
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_dtype
from ..models.decode import _decode_one, _prefill, make_token_sampler
from ..ops.rope import rope_tables
from .kv_manager import KVCachePool
from .scheduler import FIFOScheduler


@dataclass
class Request:
    """One generation request. `tokens` fills with the generated ids (EOS
    excluded); the *_t fields are engine-clock samples for the metrics."""

    rid: int
    prompt: List[int]
    max_new: int
    seed: int = 0
    arrival: float = 0.0                 # loadgen's planned arrival offset
    tokens: List[int] = field(default_factory=list)
    submit_t: Optional[float] = None     # entered the admission queue
    admit_t: Optional[float] = None      # left the queue (prefill dispatch)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    prompt_len: int = 0
    limit: int = 0

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
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        ks, vs, logits = _prefill(self.model, self._to_device(buf),
                                  self._to_device(plens), self._cos,
                                  self._sin, self._dtype)
        # pad rows all aim at the scratch slot, so `idx` repeats it: which
        # duplicate write lands there does not matter, nothing reads it
        idx = self._to_device(slot_idx)
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
                             self._to_device(self._tokens),
                             self._to_device(self._pos), self.buf_len,
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
