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
`np.asarray(tok)` does. Both engines' decode step has one shape (every slot
row, the whole buffer or page table), so on a card at tp = 1 it is
captured once as a CUDA graph and replayed (`decode_graph`,
`runtime/graphs.py`): one launch from the host per step, where the eager
step is ~900, the JAX step's one compiled dispatch. The prefill and chunk
dispatches, whose widths vary by bucket, and the copy-on-write page copies
stay eager. Both engines send every device dispatch through a
`tp_dispatch.Dispatcher`: on more than one rank (tp, or the paged
engine's cp-sharded pages) rank 0 runs the host loop and broadcasts each
dispatch, and the other ranks run it on their shards
(`engine.dispatch.serve()`) until rank 0's `engine.dispatch.stop()`.
Sampling (`temperature > 0`, with `top_k` / `top_p`) draws each token from
the request's seed and the absolute position it will occupy
(`models/decode.sample_from_full`): the seeds ride in each dispatch's
packed payload (a uint32 per row, as int32 bits) next to the tokens and
cursors, so a captured decode step reads this step's seeds, not the ones
of its capture. `debug_host_sampler` returns the decode step's full-vocab
logits to the host and samples there (`host_sample_tokens`, the JAX
ablation path) — the fused sampler's oracle.
`decode_weight_dtype='int8'` serves int8 decode weights (the JAX engines'
`_setup_decode_weights`): the engine rewrites the model's weights IN
PLACE into int8 codes and f32 per-output-channel scales
(`ops/quant.quantize_decode_params`, at tp > 1 the shards of the JAX
function's output on the assembled tree), so the f32 masters leave the
device, and every read of a weight in the lowerings dequantizes it at use
(`codes * scale` in f32, JAX's order, through a property of the module's
class: `quantize_model`): per layer, inside the captured decode step too.
The products stay `torch.matmul` on the dequantized weight, as XLA's
convert-into-matmul fusion is JAX's. `weight_bytes` counts the weights
either way (the serve CLI reports it beside `stats()`, which stays the
JAX engine's).
TTFT/TPOT/queue-wait are measured per request. The JAX engines' obs hooks
are here, each None (and free) unless the caller passes it, and only on
the rank that runs the host loop: `tracer` (`obs.trace.SpanTracer`: one
host span per dispatch, the `slots_live` / `pages_in_use` counters),
`writer` (a `MetricsWriter`: `serve_request` events), `request_tracer`
(`obs.reqtrace.RequestTracer`: each request's contiguous span timeline and
page counters, continued from a `trace_ctx` another process handed over),
`flight` (`obs.flight.FlightRecorder`: pool stats per decode step, the
scheduler's and the pool's decisions, a dump on a PoolExhausted
preemption and on an in-run SLO collapse), `telemetry`
(`obs.telemetry.TelemetryExporter`: the live gauges and counters, and the
device-memory plane of `training.metrics.publish_hbm`) and, on the paged
engines, `controller` (`serving.controller.SLOController`, ticked and
actuated at the decode step's safe point). The JAX duty profiler waits for
the profilers (ROADMAP).
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_dtype_on
from ..models.decode import (
    PAGED_ATTN_IMPLS, _decode_one, _full_vocab_logits, _paged_decode_one,
    _paged_prefill_chunk, _prefill, decode_tables, host_sample_tokens,
    sample_from_full, validate_sampling)
from ..obs.control import control_safe_point
from ..obs.reqtrace import TraceContext
from ..ops.quant import quantize_decode_params
from ..parallel.moe import count_drops, dropped_share
from ..parallel.layout import tp_dim
from ..runtime.graphs import CapturedStep, use_decode_graph
from ..training.metrics import publish_hbm
from .kv_manager import KVCachePool, PagedKVPool, PoolExhausted, page_bytes
from .scheduler import FIFOScheduler, SLOScheduler
from .tp_dispatch import Dispatcher


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
    trace_id: Optional[str] = None       # per-request trace (obs/reqtrace)
    trace_ctx: Optional[dict] = None     # a wire TraceContext from another
    #                                      process: submit CONTINUES it
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


def _wire_ctx(req: Request):
    """A request's cross-process trace handoff, deserialized (or None)."""
    if req.trace_ctx is None:
        return None
    return TraceContext.from_wire(req.trace_ctx)


# device-memory watermark cadences: gauges every N decode steps, events
# every M (and at the first step, so a short run records one)
_HBM_GAUGE_EVERY = 10
_HBM_EVENT_EVERY = 100


def _publish_hbm_plane(engine, pool_bytes=None) -> None:
    """The engines' device-memory publication on its cadences (the JAX
    `_publish_hbm_plane`): live gauges into the exporter, `hbm_watermark`
    events into the metrics stream. `pool_bytes` is the paged pool's
    accounted page bytes."""
    step = engine.decode_steps
    gauge = engine.telemetry is not None and (
        step == 1 or step % _HBM_GAUGE_EVERY == 0)
    event = engine.writer is not None and (
        step == 1 or step % _HBM_EVENT_EVERY == 0)
    if not (gauge or event):
        return
    publish_hbm(telemetry=engine.telemetry if gauge else None,
                writer=engine.writer if event else None, step=step,
                pool_accounted_bytes=pool_bytes, event=event)


class _Obs:
    """The obs hooks both engines keep (see the module docstring)."""

    def _setup_obs(self, tracer, writer, request_tracer, flight,
                   telemetry) -> None:
        self.tracer = tracer
        self.writer = writer
        self.rt = request_tracer
        self.flight = flight
        self.telemetry = telemetry

    def _span(self, name, **args):
        if self.tracer is not None:
            return self.tracer.span(name, cat="serve", **args)
        return contextlib.nullcontext()

    def _request_event(self, req: Request, **extra) -> None:
        """Retire the request's timeline and write its `serve_request`."""
        if self.rt is not None:
            self.rt.retire(req)
        if self.writer is not None:
            ms = lambda s: None if s is None else round(s * 1e3, 3)
            self.writer.event(
                "serve_request", rid=req.rid, prompt_len=req.prompt_len,
                generated=len(req.tokens), **extra, trace_id=req.trace_id,
                queue_wait_ms=ms(req.queue_wait_s), ttft_ms=ms(req.ttft_s),
                tpot_ms=ms(req.tpot_s))


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


def _capture_decode(engine, mode: str, tp: int, example: np.ndarray,
                    cp: int = 1) -> Optional[CapturedStep]:
    """The engine's decode step `engine._decode_body(packed) -> (tokens,
    full-vocab logits)` captured for the packed dispatch's shape, where
    `mode` and the mesh say so (`use_decode_graph`), else None. The
    warm-up runs `example` for real: the engines pass one that writes only
    free rows and the scratch page."""
    if not use_decode_graph(mode, engine.device, tp, cp):
        return None
    with torch.no_grad():
        return CapturedStep(engine._decode_body,
                            [torch.from_numpy(example).to(engine.device)])


_INT8_CLASSES: Dict[tuple, type] = {}


def _int8_class(cls: type, names: tuple) -> type:
    """`cls` with each attribute of `names` a property that dequantizes the
    module's int8 codes `<name>_q` with its scale `<name>_scale`: one
    promoting product, `codes * scale` in f32, the JAX `(q.astype(f32) *
    scale)` bit for bit."""
    key = (cls, names)
    if key not in _INT8_CLASSES:
        def read(name):
            return property(lambda self: (self._buffers[name + "_q"]
                                          * self._buffers[name + "_scale"]))
        _INT8_CLASSES[key] = type(f"Int8{cls.__name__}", (cls,),
                                  {n: read(n) for n in names})
    return _INT8_CLASSES[key]


def _nbytes(t: torch.Tensor, shards: int) -> int:
    return t.numel() * t.element_size() * shards


def quantize_model(model, mesh=None) -> int:
    """Rewrite `model`'s weights in place into int8 decode weights: every
    leaf `quantize_decode_params` quantizes is dropped for two buffers, its
    int8 codes `<name>_q` and its scale `<name>_scale`, and its module's
    class becomes one whose `<name>` dequantizes them at every read
    (`_int8_class`), so the f32 master leaves the device. At tp > 1 every
    rank of `mesh` calls it (one all-reduce per tp-sharded contraction
    dim). Returns `weight_bytes` (`_setup_decode_weights`)."""
    if getattr(model.embedding, "int8_weights", False):
        raise ValueError("the model already holds int8 decode weights; "
                         "build a fresh model to quantize")
    tp = 1 if mesh is None else mesh.tp
    with torch.no_grad():
        qparams = quantize_decode_params(model.state_dict(), mesh)
    nbytes, by_module = 0, {}
    for key, leaf in qparams.items():
        dim = tp_dim(key)
        if not isinstance(leaf, dict):
            nbytes += _nbytes(leaf, 1 if dim is None else tp)
            continue
        q, scale = leaf["qweight"], leaf["scale"]
        mod_name, attr = key.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        del mod._parameters[attr]
        mod.register_buffer(attr + "_q", q)
        mod.register_buffer(attr + "_scale", scale)
        by_module.setdefault(mod, []).append(attr)
        # a scale over the tp-sharded dim is replicated on every rank
        nbytes += _nbytes(q, 1 if dim is None else tp) + _nbytes(
            scale, 1 if dim is None or scale.shape[dim] != q.shape[dim]
            else tp)
    for mod, names in by_module.items():
        mod.__class__ = _int8_class(type(mod), tuple(names))
        mod.int8_weights = True
    return nbytes


def _setup_decode_weights(engine, model, mesh, decode_weight_dtype) -> None:
    """The weight dtype both engines serve (the JAX `_setup_decode_weights`):
    None/'native' leaves the model as it is; 'int8' quantizes it in place
    (`quantize_model`). Sets `engine.decode_weight_dtype` and
    `engine.weight_bytes`: the weights' bytes as the assembled tree holds
    them (each tp shard counted once, a replicated leaf once), f32 masters
    or int8 codes + scales, the same at any tp."""
    if decode_weight_dtype in (None, "native"):
        tp = getattr(mesh, "tp", 1)
        engine.decode_weight_dtype = "native"
        engine.weight_bytes = sum(
            _nbytes(p, 1 if tp_dim(k) is None else tp)
            for k, p in model.named_parameters())
    elif decode_weight_dtype == "int8":
        engine.decode_weight_dtype = "int8"
        engine.weight_bytes = quantize_model(model, mesh)
    else:
        raise ValueError(f"decode_weight_dtype must be None/'native'/"
                         f"'int8', got {decode_weight_dtype!r}")


def _seed_bits(seeds: np.ndarray) -> np.ndarray:
    """uint32 request seeds as the int32 bits a packed payload carries."""
    return np.asarray(seeds, np.uint32).view(np.int32)


class _Sampling:
    """The sampling knobs both engines keep (the JAX engines' `_temperature`,
    `_top_k`, `_top_p`, `_debug_host_sampler`) and their one draw."""

    def _setup_sampling(self, model, temperature: float, top_k: int,
                        top_p: float, debug_host_sampler: bool) -> None:
        validate_sampling(model.cfg, temperature, top_k, top_p)
        self._sampling = (temperature, top_k, top_p)
        self._debug_host_sampler = debug_host_sampler

    def reset_drop_tally(self) -> None:
        """Restart the MoE model's drop tally (`parallel/moe.count_drops`)
        from zero; the constructors call it once their decode step's
        capture has run its warm-ups. `stats()` reports the tally as
        `moe_dropped_share`."""
        count_drops(self.model, self.device)

    def _drop_stats(self) -> dict:
        share = dropped_share([self.model])
        return {} if share is None else {"moe_dropped_share": share}

    def _sample(self, logits: torch.Tensor, seeds: torch.Tensor,
                positions: torch.Tensor, host: bool = False):
        """(tokens, full-vocab f32 logits) of this rank's vocab columns:
        the fused draw of each row's (seed, position) over the gathered
        logits (`sample_from_full`, so every tp rank picks the same
        tokens), or no tokens with `host` (the host samples the logits)."""
        full = _full_vocab_logits(self.model, logits)
        if host:
            return None, full
        return sample_from_full(full, seeds, positions, *self._sampling), full


def _run_decode_step(engine, packed: np.ndarray) -> np.ndarray:
    """The decode dispatch: the captured step's replay, or the eager step;
    the chosen tokens on the host. The payload opens with the rows'
    tokens, cursors and seeds (n each); under `debug_host_sampler` the
    host samples the step's full-vocab logits at cursor + 1."""
    if engine._decode_graph is not None:
        tok, full = engine._decode_graph(packed)
    else:
        tok, full = engine._decode_body(_to_device(packed, engine.device))
    if engine._debug_host_sampler:
        n = engine._decode_rows
        return host_sample_tokens(
            engine.model, full.cpu().numpy(), packed[2 * n:3 * n].view(
                np.uint32), packed[n:2 * n].astype(np.int64) + 1,
            *engine._sampling)
    return tok.cpu().numpy()


def graph_stats(engine) -> dict:
    """Whether the engine's decode step runs as graphs (one, or the
    speculative engine's round: its draft and verify graphs,
    `_round_graphs`), the step's replays and the kernel launches one
    step's replays hold, by kernel."""
    graphs = [g for g in getattr(engine, "_round_graphs",
                                 (engine._decode_graph,)) if g is not None]
    launches = Counter()
    for g in graphs:
        launches.update(g.kernel_launches)
    return {"decode_graph": bool(graphs),
            "decode_graph_replays": graphs[0].replays if graphs else 0,
            "decode_graph_launches": dict(launches)}


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


class ContinuousBatchingEngine(_Sampling, _Obs):
    """Slot-based continuous batching on one device, or across the tp ranks
    of `mesh` (one engine per rank; see `tp_dispatch`: the scheduler lives
    on tp rank 0 alone), for a model of either family.

    The JAX engine takes (model, mesh, params, ...); here the model module
    carries its weights (this rank's shard), which must already lie on
    `mesh.device`. `decode_graph` ('auto', 'on', 'off';
    `runtime/graphs.use_decode_graph`) says whether the decode step runs
    as a CUDA graph. `temperature`, `top_k`, `top_p`,
    `debug_host_sampler` and `decode_weight_dtype` (None/'native' or
    'int8', which quantizes the model in place) as the JAX engine's."""

    def __init__(self, model, mesh, num_slots: int, buf_len: int,
                 eos_id: int, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, prefill_bucket: int = 64,
                 max_prefill_batch: int = 4, max_queue: int = 0,
                 decode_graph: str = "auto",
                 debug_host_sampler: bool = False,
                 decode_weight_dtype=None, tracer=None, writer=None,
                 request_tracer=None, flight=None, telemetry=None,
                 clock=time.monotonic):
        if getattr(model, "cp_size", 1) > 1:
            raise ValueError(
                "the slot engine's per-slot caches are replicated over cp; "
                "long-context cp serving is the PAGED engine's job "
                f"(--paged with --cp {model.cp_size}) — use PagedEngine, or "
                "rebuild the model at cp=1")
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
        self._clock = clock
        self._setup_obs(tracer, writer, request_tracer, flight, telemetry)
        self._dtype = resolve_dtype_on(model.cfg.compute_dtype, mesh.device)
        self._cos, self._sin = decode_tables(
            model, max(model.cfg.maxlen, buf_len), self.device)
        self._setup_sampling(model, temperature, top_k, top_p,
                             debug_host_sampler)
        _setup_decode_weights(self, model, mesh, decode_weight_dtype)
        count_drops(model, self.device)     # before a capture adds to it
        self.pool = KVCachePool(model, mesh, num_slots, buf_len)
        self.dispatch = Dispatcher(mesh, {"slot_prefill": self._run_prefill,
                                          "slot_decode": self._run_decode})
        self.scheduler = (FIFOScheduler(buf_len,
                                        prefill_bucket=prefill_bucket,
                                        max_queue=max_queue, clock=clock,
                                        flight=flight)
                          if self.dispatch.leader else None)
        n = num_slots + 1  # + the scratch row (kv_manager.py)
        self._decode_rows = n
        self._tokens = np.zeros(n, np.int32)
        self._pos = np.zeros(n, np.int32)
        self._seeds = np.zeros(n, np.uint32)
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
        # the example: token 0 at cursor 0 in every row, all free now
        self._decode_graph = _capture_decode(self, decode_graph, mesh.tp,
                                             np.zeros(3 * n, np.int32))
        self.reset_drop_tally()

    # -- request intake --------------------------------------------------
    def submit(self, req: Request) -> None:
        """FIFO enqueue (raises scheduler.QueueFull past the bound). An
        accepted request opens its trace timeline at submit_t, or continues
        a `trace_ctx` handed over from another process."""
        self.scheduler.submit(req)
        if self.rt is not None:
            self.rt.begin(req, ctx=_wire_ctx(req))

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
            now = self._clock()
            ready = []
            for req in group:
                req.admit_t = now
                req.prompt_len = len(req.prompt)
                req.limit = min(req.prompt_len + req.max_new, self.buf_len)
                self.prompt_tokens += req.prompt_len
                if self.rt is not None:
                    self.rt.mark(req, "queued", now)
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
        buf = np.full((nb, width), self.eos_id, np.int32)
        plens = np.ones(nb, np.int32)          # pad rows: 1-token dummy
        slot_idx = np.full(nb, self.pool.scratch_slot, np.int32)
        seeds = np.zeros(nb, np.uint32)
        for i, req in enumerate(ready):
            buf[i, : req.prompt_len] = req.prompt
            plens[i] = req.prompt_len
            slot_idx[i] = slots[i]
            seeds[i] = np.uint32(req.seed)
        # one copy: the prompt buffer | prompt lengths | target slots |
        # seeds
        with self._span("prefill", rows=len(ready), nb=nb, width=width):
            tok = self.dispatch("slot_prefill", (nb, width), np.concatenate(
                [buf.ravel(), plens, slot_idx, _seed_bits(seeds)]))
        self.prefill_dispatches += 1
        self.prefill_positions += nb * width
        self.prefill_positions_monolithic += len(ready) * self.buf_len
        now = self._clock()
        for i, req in enumerate(ready):
            req.first_token_t = now
            if self.rt is not None:
                self.rt.mark(req, "prefill", now, positions=req.prompt_len)
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
            self._seeds[slot] = np.uint32(req.seed)

    def _run_prefill(self, shape, packed: np.ndarray) -> np.ndarray:
        """The prefill dispatch: the causal forward over the (nb, width)
        buffer, its K/V written into the target slots' rows, the first
        tokens (drawn at position prompt_len)."""
        nb, width = shape[:2]
        dev = _to_device(packed, self.device)
        o = nb * width
        plens = dev[o:o + nb]
        ks, vs, logits = _prefill(self.model, dev[:o].view(nb, width),
                                  plens, self._cos, self._sin, self._dtype)
        # pad rows all aim at the scratch slot, so `idx` repeats it: which
        # duplicate write lands there does not matter, nothing reads it
        idx = dev[o + nb:o + 2 * nb]
        self.pool.ks[:, idx, :, :width, :] = ks
        self.pool.vs[:, idx, :, :width, :] = vs
        return self._sample(logits, dev[o + 2 * nb:], plens)[0].cpu().numpy()

    def _decode_body(self, dev: torch.Tensor):
        """Every slot row one token on, from the packed dispatch on the card
        (pending tokens | cursors | seeds): (tokens, full-vocab logits)."""
        n = self._decode_rows
        logits = _decode_one(self.model, self.pool.ks, self.pool.vs, dev[:n],
                             dev[n:2 * n], self.buf_len, self._cos,
                             self._sin, self._dtype)
        return self._sample(logits, dev[2 * n:], dev[n:2 * n] + 1,
                            self._debug_host_sampler)

    def _run_decode(self, shape, packed: np.ndarray) -> np.ndarray:
        return _run_decode_step(self, packed)

    def _decode_payload(self) -> np.ndarray:
        """The decode dispatch, one copy: pending tokens | cursors |
        seeds."""
        return np.concatenate([self._tokens, self._pos,
                               _seed_bits(self._seeds)])

    def _decode(self, done: List[Request]) -> None:
        with self._span("decode_step", live=len(self._slot_req)):
            tok = self.dispatch("slot_decode", (), self._decode_payload())
        now = self._clock()
        self.decode_steps += 1
        self._occupancy_sum += self.pool.occupancy
        if self.tracer is not None:
            self.tracer.counter("slots_live", len(self._slot_req))
        if self.flight is not None:
            self.flight.record("pool_stats", live=len(self._slot_req),
                               free_slots=self.pool.free_slots,
                               queued=self.scheduler.pending)
        if self.telemetry is not None:
            tel = self.telemetry
            tel.gauge("serve/live", len(self._slot_req))
            tel.gauge("serve/queue_depth", self.scheduler.pending)
            tel.rate("serve/tokens_per_sec", self.generated_tokens)
            tel.counter("serve/decode_steps", self.decode_steps)
        _publish_hbm_plane(self)
        for slot, req in list(self._slot_req.items()):
            # the pending token was written at `pos` by this dispatch: it
            # is now part of the output
            if self.rt is not None:
                self.rt.mark(req, "decode", now)
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
        self._request_event(req)

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
            **self._drop_stats(),
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


class PagedEngine(_Sampling, _Obs):
    """Continuous batching over a PAGED KV cache (the JAX `PagedEngine`; at
    tp > 1 or cp > 1 one engine per rank, as the slot engine), for a model
    of either family, greedy or sampled as the slot engine.

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
    * **cp-sharded pages** (a model at `cp_size` > 1): each cp rank holds
      1 / cp of the pages (`kv_manager.PagedKVPool`), so per-rank KV bytes
      shrink ~1 / cp at equal context. The host keeps ONE global page table;
      column j belongs to rank j // (max_pages / cp), so `max_pages` and
      `num_pages` round up to cp multiples, each column's page is leased
      from its owner's slab, and a request's need is checked against one
      slab. Chunk widths round up to a cp multiple, as JAX's. The lowerings
      attend each rank's slab and combine the partials
      (`models/decode.cp_combine`); the tokens are cp = 1's.

    Admission is `scheduler.SLOScheduler`; when an overdue request cannot
    be admitted, or a live slot cannot grow a page, a victim is PREEMPTED:
    its pages are released and it re-enters the queue with its generated
    prefix re-prefilled through the COW path (decode restarted from prompt
    + generated gives the same tokens as the uninterrupted run, sampled
    too: a draw depends on the seed and the absolute position only).

    Device work per dispatch (a chunk, a decode step, or a copy-on-write
    page copy, each through `self.dispatch`): the page table, cursors and
    tokens go to the card in ONE copy, the lowering
    (`models/decode._paged_decode_one` or
    `_paged_prefill_chunk`) writes the pool in place and attends through
    `paged_attn_impl` — 'kernel' (the CUDA paged-attention kernel; its plain
    version on the CPU) or 'gather' (the dense page view, the oracle) — and
    the only sync is the host copy of the chosen tokens. Speculative
    decoding subclasses it (`serving/speculative.py`). The obs hooks and
    the `controller` as in the module docstring. `decode_graph`, the
    sampling knobs and `decode_weight_dtype` as the slot engine's.

    Disaggregated serving (`serving/transfer.py`), at any tp and cp: a
    `prefill_only` engine never decodes (and captures no decode step) —
    each finished prefill parks in `handoffs` with its page references
    until the caller streams it out (`export_handoff`: an `export_pages`
    dispatch, the global heads gathered to rank 0) and drops them
    (`finish_handoff`); a decode engine takes it in through
    `admit_prefilled`, which imports the pages (an `import_pages`
    dispatch: every rank writes its heads of the pages its slab owns) and
    installs the slot as `_finish_prefill` would, so decoding continues
    token for token."""

    # whether __init__ captures the one-token decode step (a subclass that
    # never runs it, the speculative engine, captures its own steps)
    _CAPTURES_DECODE_STEP = True

    def __init__(self, model, mesh, num_slots: int, buf_len: int,
                 eos_id: int, page_size: int = 64, num_pages: int = 0,
                 prefill_chunk: int = 128, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 slo_classes=None, default_class: str = "standard",
                 max_queue: int = 0, kv_dtype=None,
                 paged_attn_impl: str = "kernel", clock=time.monotonic,
                 decode_graph: str = "auto",
                 debug_host_sampler: bool = False,
                 decode_weight_dtype=None, prefill_only: bool = False,
                 tracer=None, writer=None, request_tracer=None,
                 flight=None, telemetry=None, controller=None):
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
        # cp-sharded pages: column j of the page table belongs to cp rank j
        # // (max_pages / cp), so max_pages rounds up to a cp multiple
        self.cp = max(1, int(getattr(model, "cp_size", 1)))
        if self.cp > 1 and mesh.cp != self.cp:
            raise ValueError(f"a model at cp {self.cp} shards its pages over "
                             f"the mesh's cp ranks; got a mesh at cp "
                             f"{mesh.cp}")
        # the logical per-request buffer rounds UP to whole pages
        self.page_size = page_size
        pages = -(-buf_len // page_size)
        self.max_pages = self.cp * -(-pages // self.cp)
        self.buf_len = self.max_pages * page_size
        self._mpp = self.max_pages // self.cp  # page-table columns per rank
        if not num_pages:
            num_pages = num_slots * self.max_pages  # no oversubscription
        # the pool splits its pages into equal per-rank slabs (cp=1: one)
        num_pages = self.cp * -(-num_pages // self.cp)
        self.model = model
        self.device = mesh.device
        self.num_slots = num_slots
        self.eos_id = int(eos_id)
        self.prefill_chunk = prefill_chunk
        self._clock = clock
        self._setup_obs(tracer, writer, request_tracer, flight, telemetry)
        # a serving.controller.SLOController, observed and actuated only
        # from `_control_tick` (the registered safe point)
        self.controller = controller
        self._dtype = resolve_dtype_on(model.cfg.compute_dtype, mesh.device)
        self._cos, self._sin = decode_tables(
            model, max(model.cfg.maxlen, self.buf_len), self.device)
        self._setup_sampling(model, temperature, top_k, top_p,
                             debug_host_sampler)
        _setup_decode_weights(self, model, mesh, decode_weight_dtype)
        count_drops(model, self.device)     # before a capture adds to it
        self.paged_attn_impl = paged_attn_impl
        self.kv_dtype = kv_dtype
        self.pool = PagedKVPool(model, mesh, num_pages, page_size,
                                kv_dtype=kv_dtype, flight=flight)
        # bytes one leased page costs: the pool-vs-device memory gauge
        self._page_bytes_each = page_bytes(model.cfg, page_size, kv_dtype)
        self.dispatch = Dispatcher(mesh, {"paged_chunk": self._run_chunk,
                                          "paged_decode": self._run_decode,
                                          "cow_copy": self._run_copy,
                                          "export_pages": self._run_export,
                                          "import_pages": self._run_import})
        self._import_payload = None          # the leader's (k, v) in flight
        self.scheduler = (SLOScheduler(self.buf_len, classes=slo_classes,
                                       default_class=default_class,
                                       max_queue=max_queue, clock=clock,
                                       flight=flight)
                          if self.dispatch.leader else None)
        self._free_slots = deque(range(num_slots))
        # (slots, max_pages) page table; free rows aim at the scratch page
        self._tbl = np.full((num_slots, self.max_pages),
                            self.pool.scratch_page, np.int32)
        self._decode_rows = num_slots
        self._tokens = np.zeros(num_slots, np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._seeds = np.zeros(num_slots, np.uint32)
        self._slot_req: Dict[int, Request] = {}
        self._prefilling: Dict[int, _PrefillState] = {}
        self.completed: List[Request] = []
        # disaggregated serving: finished prefills of a prefill_only engine
        # wait here, page references held, until the caller streams them
        self.prefill_only = bool(prefill_only)
        self.handoffs: deque = deque()
        self.handoffs_staged = 0
        self.pages_exported = 0
        self.pages_imported = 0
        # live per-class TTFT attainment, {class: [completed, hit]}, folded
        # by the fleet summary (`obs.telemetry.fleet_slo_attainment`); feeds
        # the live gauges and the in-run collapse dump (once per class)
        self._slo_counts: Dict[str, list] = {}
        self.slo_collapsed: set = set()
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
        # the example: token 0 at cursor 0 in every row, every table entry
        # on the scratch page, the only page it writes
        self._decode_graph = _capture_decode(
            self, decode_graph, mesh.tp, np.concatenate([
                np.zeros(3 * num_slots, np.int32),
                np.full(num_slots * self.max_pages, self.pool.scratch_page,
                        np.int32)]),
            self.cp) if self._CAPTURES_DECODE_STEP and not prefill_only \
            else None
        self.reset_drop_tally()

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
        # cp > 1: ownership is positional (column j -> rank j // mpp), so
        # the worst case drawn from ONE rank's slab is min(need, mpp) pages
        if min(need, self._mpp) > self.pool.pages_per_rank:
            raise ValueError(
                f"request {req.rid}: needs up to {min(need, self._mpp)} "
                f"pages from one cp rank's slab ({need} total over cp="
                f"{self.cp}) but each slab holds "
                f"{self.pool.pages_per_rank} — raise --num_pages or lower "
                f"the budget")
        self.scheduler.submit(req)
        if self.rt is not None:
            self.rt.begin(req, ctx=_wire_ctx(req))

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
            if self.rt is not None:
                self.rt.note(st.req, prefix_hit_tokens=best_len)
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
            if not self._fits_free(need):
                if not (overdue and self._preempt_for(req)):
                    break
                continue
            self.scheduler.take()
            if req.admit_t is None:
                req.admit_t = now
                req.prompt_len = len(req.prompt)
                req.limit = min(req.prompt_len + req.max_new, self.buf_len)
                self.prompt_tokens += req.prompt_len
            if self.rt is not None:
                # the first admission and every resume after a preemption
                # (the span since `preempted` was queue time)
                self.rt.mark(req, "queued", now)
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
        freed = self._release_slot(slot)
        req.preemptions += 1
        self.preemptions += 1
        if self.rt is not None:
            self.rt.mark(req, "preempted", self._clock())
            self.rt.note(req, pages_freed=freed)
        if self.flight is not None:
            self.flight.record("preempt", rid=req.rid, slot=slot,
                               generated=len(req.tokens),
                               pages_freed=freed, slo_class=req.slo_class)
        self.scheduler.requeue(req)

    def _release_slot(self, slot: int) -> int:
        """Drop the slot's page references; its table row goes back to the
        scratch page and its cursor to 0, so a dense dispatch over every
        slot row keeps the free row in range and writing only scratch.
        Returns the number of page references dropped."""
        scratch = self.pool.scratch_page
        freed = 0
        for j in range(self.max_pages):
            if self._tbl[slot, j] != scratch:
                self.pool.unref(int(self._tbl[slot, j]))
                self._tbl[slot, j] = scratch
                freed += 1
        self._pos[slot] = 0
        self._free_slots.append(slot)
        return freed

    def _fits_free(self, need: int) -> bool:
        """Can `need` pages for page-table columns [0, need) be leased now?
        At cp > 1 every rank's span of `mpp` columns must fit its own slab:
        ownership is positional, pages cannot migrate."""
        for o in range(self.cp):
            cols = max(0, min(need, (o + 1) * self._mpp) - o * self._mpp)
            if cols > self.pool.free_pages_of(o):
                return False
        return True

    def _alloc_page(self, needy_slot: int, owner: int = 0) -> int:
        """A free page from cp rank `owner`'s slab (cp = 1: the pool),
        evicting victims while the slab is dry (never the needy slot
        itself). Submit-time validation guarantees a sole live request
        fits, so exhaustion with no victim cannot happen. Such a preemption
        freezes the flight ring: the dump shows the pool and scheduler
        state that led to it."""
        while True:
            try:
                return self.pool.alloc(owner)
            except PoolExhausted:
                cands = self._candidates(exclude_slot=needy_slot)
                if not cands:
                    raise RuntimeError(
                        "page pool exhausted with no preemption candidate "
                        "— a single request outgrew num_pages (submit-time "
                        "validation should have refused it)")
                victim_slot, victim = cands[0]
                self._preempt(victim_slot)
                if self.flight is not None:
                    self.flight.dump(
                        {"kind": "pool_exhausted_preempt",
                         "needy_slot": needy_slot,
                         "victim_rid": victim.rid,
                         "victim_slot": victim_slot,
                         "victim_generated": len(victim.tokens),
                         "num_pages": self.pool.num_pages},
                        tag="pool_exhausted")

    def _ensure_writable(self, slot: int, lo: int, hi: int):
        """Positions [lo, hi) of `slot` must land in PRIVATE pages before a
        write dispatch: unmapped entries allocate, shared entries
        copy-on-write (one copy dispatch). Returns (pages allocated, pages
        copied), the owning request's timeline counters."""
        ps, scratch = self.page_size, self.pool.scratch_page
        pairs = []
        allocated = 0
        for j in range(lo // ps, -(-hi // ps)):
            owner = j // self._mpp     # the cp rank whose slab backs column j
            pid = int(self._tbl[slot, j])
            if pid == scratch:
                self._tbl[slot, j] = self._alloc_page(slot, owner)
                allocated += 1
            elif self.pool.refcount[pid] > 1:
                # same-column COW: source and copy share the owner
                new = self._alloc_page(slot, owner)
                pairs.append((pid, new))
                self.pool.unref(pid)
                self._tbl[slot, j] = new
        if pairs:
            self.dispatch("cow_copy", (), np.array(pairs, np.int32))
        return allocated, len(pairs)

    def _run_copy(self, shape, pairs: np.ndarray) -> None:
        """The copy-on-write dispatch: (src, dst) page pairs."""
        self.pool.copy_pages(pairs.reshape(-1, 2).tolist())

    def _pump_prefill(self, done: List[Request]) -> None:
        """Advance prefills chunk by chunk. While ANY stream is live
        decoding, at most `prefill_chunk` positions are dispatched per
        engine step (`max_interleaved_prefill` records the realised max).
        A prefill_only engine returns once a prefill is staged: its pages
        stay leased until the caller streams it out, so a burst prefilled
        in one step would hold every prompt's pages at once (and the first
        handoff would wait for the last prefill)."""
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
            if self.handoffs:
                break
        self.max_interleaved_prefill = max(self.max_interleaved_prefill,
                                           interleaved)

    def _dispatch_chunk(self, slot: int, st: _PrefillState, n: int,
                        done: List[Request]) -> None:
        ps = self.page_size
        s, ids, req = st.s, st.ids, st.req
        leased, cowed = self._ensure_writable(slot, s, s + n)
        cw = _pow2_at_most(n, self.prefill_chunk)
        # JAX's cp query ring splits the chunk into cp sub-blocks: its
        # widths round up to a cp multiple (pads are scratch-aimed), and so
        # do these, so the two engines dispatch the same shapes
        cw = self.cp * -(-cw // self.cp)
        buf, dstp, dsto = _chunk_maps(ids, s, n, cw, ps, self.eos_id,
                                      self.pool.scratch_page,
                                      self._tbl[slot])
        # one copy: tokens | start | qlen | table row | dst pages | offsets |
        # seed
        with self._span("prefill_chunk", slot=slot, pos0=s, n=n, cw=cw):
            tok = self.dispatch("paged_chunk", (cw,), np.concatenate([
                buf[0], np.array([s, n], np.int32), self._tbl[slot],
                dstp[0], dsto[0], _seed_bits([req.seed])]))
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
        if self.rt is not None:
            self.rt.mark(req, "prefill_chunk", self._clock(),
                         positions=n, cow=cowed)
            self.rt.note(req, pages_leased=leased, cow_copies=cowed)
        if st.s >= len(ids):
            self._finish_prefill(slot, st, int(tok[0]), done)

    def _run_chunk(self, shape, packed: np.ndarray) -> np.ndarray:
        """The chunk dispatch: one row's chunk of width shape[0]; its token
        is drawn at position start + qlen."""
        cw, mp = shape[0], self.max_pages
        dev = _to_device(packed, self.device)
        o = cw + 2 + mp
        start, qlen = dev[cw:cw + 1], dev[cw + 1:cw + 2]
        logits = _paged_prefill_chunk(
            self.model, self.pool.ks, self.pool.vs, dev[None, :cw], start,
            qlen, dev[None, cw + 2:o], dev[None, o:o + cw],
            dev[None, o + cw:o + 2 * cw], self.page_size, self._cos,
            self._sin, self._dtype, attn_impl=self.paged_attn_impl,
            cp=self.cp)
        return self._sample(logits, dev[o + 2 * cw:],
                            start + qlen)[0].cpu().numpy()

    def _finish_prefill(self, slot: int, st: _PrefillState, first: int,
                        done: List[Request]) -> None:
        req = st.req
        del self._prefilling[slot]
        now = self._clock()
        if req.first_token_t is None:
            req.first_token_t = now
        if self.prefill_only:
            self._stage_handoff(slot, st, first, now)
            return
        if first == self.eos_id:              # 0 (more) generated tokens
            req.finish_t = now
            freed = self._release_slot(slot)
            if self.rt is not None:
                self.rt.note(req, pages_freed=freed)
            self._complete(req, done)
            return
        self._install(slot, req, first, len(st.ids))

    def _install(self, slot: int, req: Request, first: int, pos: int) -> None:
        """Make `slot` a decoding row: pending token `first` at cursor
        `pos`."""
        self._slot_req[slot] = req
        self._tokens[slot] = first
        self._pos[slot] = pos
        self._seeds[slot] = np.uint32(req.seed)

    # -- disaggregated prefill -> decode handoff ---------------------------
    def _stage_handoff(self, slot: int, st: _PrefillState, first: int,
                       now: float) -> None:
        """Park a finished prefill for stream-out instead of decoding: the
        page-table row detaches into the handoff WITH its references (the
        pages, and their prefix-index entries, stay live for export and for
        sharing with later prefills) until `finish_handoff`. The slot frees
        at once, so the slots bound concurrent prefills, not handoffs in
        flight."""
        n_pages = -(-len(st.ids) // self.page_size)
        pages = [int(self._tbl[slot, j]) for j in range(n_pages)]
        self._tbl[slot, :] = self.pool.scratch_page
        self._pos[slot] = 0
        self._free_slots.append(slot)
        self.handoffs.append({"req": st.req, "pages": pages,
                              "first": first, "n_tokens": len(st.ids)})
        self.handoffs_staged += 1
        if self.rt is not None:
            self.rt.mark(st.req, "prefill_done", now, pages=n_pages)

    def export_handoff(self, h) -> tuple:
        """The host payload (k, v) of one staged handoff's pages
        (`PagedKVPool.export_pages`: the global heads, whatever this
        engine's tp; on more than one rank an `export_pages` dispatch, so
        every rank gives its share)."""
        pages = np.asarray(h["pages"], np.int32)
        k, v = self.dispatch("export_pages", (len(pages),), pages)
        self.pages_exported += len(h["pages"])
        return k, v

    def _run_export(self, shape, pages: np.ndarray):
        """The export dispatch: rank 0 gets the payload, the others None."""
        return self.pool.export_pages(pages.tolist())

    def _write_pages(self, pages, k, v) -> None:
        """`PagedKVPool.import_pages`' write, as an `import_pages` dispatch:
        the page ids ride in the payload, the KV payload goes from rank 0 to
        every rank inside the pool's write."""
        self._import_payload = (k, v)
        try:
            self.dispatch("import_pages", (len(pages),),
                          np.asarray(pages, np.int32))
        finally:
            self._import_payload = None

    def _run_import(self, shape, pages: np.ndarray) -> None:
        k, v = self._import_payload or (None, None)
        self.pool.write_pages(pages.tolist(), k, v)

    def finish_handoff(self, h) -> None:
        """Drop the handoff's page references once the receiving pool holds
        its own copies (shared prefix pages live on for their sharers), and
        retire the request's timeline here: the decode side continues it
        from the exported context."""
        for p in h["pages"]:
            self.pool.unref(p)
        if self.rt is not None:
            self.rt.retire(h["req"])

    def admit_prefilled(self, req: Request, k, v, first: int) -> int:
        """Take in an ALREADY-PREFILLED request: import its pages (the
        payload of another pool's `export_pages`), register them in the
        prefix index as a local donor's, and install the slot as
        `_finish_prefill` would, so decoding continues token for token.
        Returns the slot, or -1 when the request completes at admission
        (`first` is EOS, or its budget is spent). RuntimeError (no free
        slot) and PoolExhausted (no pages) are the caller's backpressure:
        nothing is admitted then."""
        ids = req.prompt + req.tokens
        n_pages = -(-len(ids) // self.page_size)
        if n_pages > self.max_pages:
            raise ValueError(
                f"handoff {req.rid}: {len(ids)} prefilled tokens need "
                f"{n_pages} page-table columns but the row has "
                f"{self.max_pages} (buf_len {self.buf_len})")
        need = -(-min(len(ids) + req.max_new, self.buf_len)
                 // self.page_size)
        if need > self.pool.num_pages:
            raise ValueError(
                f"handoff {req.rid}: worst case {need} pages exceeds the "
                f"pool's {self.pool.num_pages} — raise --num_pages")
        if not self._free_slots:
            raise RuntimeError(
                f"no free slot for handoff {req.rid} "
                f"({self.num_slots} slots busy)")
        now = self._clock()
        if req.submit_t is None:
            req.submit_t = now
        req.admit_t = now
        req.prompt_len = len(req.prompt)
        req.limit = min(req.prompt_len + req.max_new, self.buf_len)
        if self.rt is not None:
            self.rt.begin(req, ctx=_wire_ctx(req))
        with torch.inference_mode():
            pages = self.pool.import_pages(
                k, v, owners=[j // self._mpp for j in range(n_pages)],
                write=self._write_pages)
        self.prompt_tokens += req.prompt_len
        self.pages_imported += len(pages)
        slot = self._free_slots.popleft()
        self._tbl[slot, :n_pages] = pages
        # later LOCAL arrivals share the imported pages as a donor's
        keys = self._chain_keys(ids)
        ps = self.page_size
        for j in range(n_pages):
            self.pool.register_prefix(keys[j - 1] if j else None, pages[j],
                                      ids[j * ps:(j + 1) * ps])
        if self.rt is not None:
            self.rt.mark(req, "kv_import", self._clock(), pages=n_pages)
        if req.first_token_t is None:
            req.first_token_t = self._clock()
        if int(first) == self.eos_id or req.limit <= len(ids):
            req.finish_t = self._clock()
            freed = self._release_slot(slot)
            if self.rt is not None:
                self.rt.note(req, pages_freed=freed)
            self._complete(req, [])
            return -1
        self._install(slot, req, int(first), len(ids))
        self.max_live = max(self.max_live, self.live_requests)
        return slot

    def _decode_payload(self):
        """Make every live slot's write position private, then the decode
        dispatch (None when no slot is left live)."""
        # grow/privatise the write page of every live slot FIRST — this may
        # itself preempt victims (page exhaustion), so iterate a snapshot
        # and re-check liveness
        for slot in list(self._slot_req):
            if slot not in self._slot_req:
                continue
            pos = int(self._pos[slot])
            leased, cowed = self._ensure_writable(slot, pos, pos + 1)
            if self.rt is not None and (leased or cowed):
                req = self._slot_req.get(slot)
                if req is not None:
                    self.rt.note(req, pages_leased=leased, cow_copies=cowed)
        if not self._slot_req:
            return None
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
        # one copy: pending tokens | cursors | seeds | page table
        return np.concatenate([self._tokens, self._pos,
                               _seed_bits(self._seeds), tbl.ravel()])

    def _decode(self, done: List[Request]) -> None:
        payload = self._decode_payload()
        if payload is None:
            return
        with self._span("decode_step", live=len(self._slot_req)):
            tok = self.dispatch("paged_decode", (), payload)
        now = self._clock()
        self.decode_steps += 1
        used, live_tokens = self._step_accounting()
        self._after_step(used, live_tokens)
        for slot, req in list(self._slot_req.items()):
            # the pending token was written at `pos` by this dispatch: it
            # is now part of the output
            if self.rt is not None:
                self.rt.mark(req, "decode", now)
            req.tokens.append(int(self._tokens[slot]))
            self.generated_tokens += 1
            cand = int(tok[slot])
            self._pos[slot] += 1
            if (cand == self.eos_id
                    or req.prompt_len + len(req.tokens) >= req.limit):
                req.finish_t = now
                del self._slot_req[slot]
                self._retire_slot(slot, req, done)
            else:
                self._tokens[slot] = cand

    def _step_accounting(self) -> tuple:
        """A decode step's occupancy sums; returns (pages in use, live
        tokens)."""
        live_tokens = sum(int(self._pos[s]) + 1 for s in self._slot_req)
        live_tokens += sum(st.s for st in self._prefilling.values())
        used = self.pool.pages_in_use
        self._occupancy_sum += self.live_requests / self.num_slots
        self._pages_used_sum += used
        if used:
            self._kv_util_sum += live_tokens / (used * self.page_size)
        return used, live_tokens

    def _after_step(self, used: int, live_tokens: int,
                    pool_bytes: int = None, **extra) -> None:
        """The obs hooks of a decode step (the speculative engine's round
        too), once its tokens are on the host: the span tracer's counters,
        the flight ring's pool stats, the live gauges, the device-memory
        plane, and the controller's safe point. `extra`: the subclass's
        own pool numbers, in the flight record and as `serve/<name>`
        gauges."""
        if self.tracer is not None:
            self.tracer.counter("slots_live", len(self._slot_req))
            self.tracer.counter("pages_in_use", used)
        if self.flight is not None:
            self.flight.record("pool_stats", live=len(self._slot_req),
                               prefilling=len(self._prefilling),
                               pages_in_use=used,
                               free_pages=self.pool.free_pages, **extra,
                               queued=self.scheduler.pending)
        if self.telemetry is not None:
            self._publish_telemetry(used, live_tokens)
            for name, value in extra.items():
                self.telemetry.gauge(f"serve/{name}", value)
        _publish_hbm_plane(self, pool_bytes=used * self._page_bytes_each
                           if pool_bytes is None else pool_bytes)
        if self.controller is not None:
            self._control_tick()

    def _retire_slot(self, slot: int, req: Request, done) -> None:
        """A finished decoding row: its pages dropped, the request done."""
        freed = self._release_slot(slot)
        if self.rt is not None:
            self.rt.note(req, pages_freed=freed)
        self._complete(req, done)

    @control_safe_point
    def _control_tick(self) -> None:
        """The control plane's registered safe point: this decode step's
        device work is on the host already and nothing is being captured,
        so the SLO controller may observe and (act mode) actuate here."""
        self.controller.tick(self.decode_steps)
        self.controller.apply_decisions()

    def _publish_telemetry(self, pages_used: int, live_tokens: int) -> None:
        """The exporter's per-decode-step update: lock-guarded dict stores,
        no formatting and no I/O on the hot path."""
        tel = self.telemetry
        tel.gauge("serve/live", len(self._slot_req))
        tel.gauge("serve/prefilling", len(self._prefilling))
        tel.gauge("serve/queue_depth", self.scheduler.pending)
        tel.gauge("serve/pages_in_use", pages_used)
        tel.gauge("serve/free_pages", self.pool.free_pages)
        tel.gauge("serve/num_pages", self.pool.num_pages)
        if pages_used:
            tel.gauge("serve/kv_util",
                      live_tokens / (pages_used * self.page_size))
        tel.rate("serve/tokens_per_sec", self.generated_tokens)
        tel.counter("serve/decode_steps", self.decode_steps)
        tel.counter("serve/preemptions", self.preemptions)

    def _decode_body(self, dev: torch.Tensor):
        """Every slot row one token on, from the packed dispatch on the card
        (pending tokens | cursors | seeds | page table): (tokens, full-vocab
        logits)."""
        n = self.num_slots
        logits = _paged_decode_one(
            self.model, self.pool.ks, self.pool.vs, dev[:n], dev[n:2 * n],
            dev[3 * n:].view(n, self.max_pages), self.page_size, self._cos,
            self._sin, self._dtype, attn_impl=self.paged_attn_impl,
            cp=self.cp)
        return self._sample(logits, dev[2 * n:3 * n], dev[n:2 * n] + 1,
                            self._debug_host_sampler)

    def _run_decode(self, shape, packed: np.ndarray) -> np.ndarray:
        return _run_decode_step(self, packed)

    def _account_slo(self, req: Request) -> None:
        """Fold one completion into the live per-class attainment; an
        in-run collapse (under 50% attained over 4 or more completions)
        freezes the flight ring once per class, while the history that
        produced it is still in the ring."""
        cls = req.slo_class or self.scheduler.default_class
        deadline = self.scheduler.classes.get(cls)
        if deadline is None:
            return
        c = self._slo_counts.setdefault(cls, [0, 0])
        c[0] += 1
        if req.ttft_s is not None and req.ttft_s <= deadline:
            c[1] += 1
        attained = c[1] / c[0]
        if self.telemetry is not None:
            tel = self.telemetry
            tel.counter(f"slo/{cls}/completed", c[0])
            tel.counter(f"slo/{cls}/hit", c[1])
            tel.gauge(f"slo/{cls}/attained", attained)
        if (self.flight is not None and c[0] >= 4 and attained < 0.5
                and cls not in self.slo_collapsed):
            self.slo_collapsed.add(cls)
            self.flight.dump(
                {"kind": "slo_attainment_collapse", "slo_class": cls,
                 "completed": c[0], "attained": round(attained, 4),
                 "deadline_s": deadline},
                tag="slo_collapse")

    def _complete(self, req: Request, done: List[Request]) -> None:
        self.completed.append(req)
        done.append(req)
        if self.scheduler.classes:
            self._account_slo(req)
        self._request_event(req, tenant=req.tenant, slo_class=req.slo_class,
                            preemptions=req.preemptions)

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
            "cp": self.cp,
            "pages_per_rank": self.pool.pages_per_rank,
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
            # -- disaggregated handoff ------------------------------------
            "prefill_only": self.prefill_only,
            "handoffs_staged": self.handoffs_staged,
            "pages_exported": self.pages_exported,
            "pages_imported": self.pages_imported,
            **self._drop_stats(),
        }
