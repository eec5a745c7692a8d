"""Speculative decoding over the paged KV cache: `SpeculativeEngine`, the
counterpart of `SpeculativeEngine(PagedEngine)` in the JAX
`serving/speculative.py`.

A small DRAFTER model (the `tiny` preset by default) proposes k tokens per
round against its own paged pool, and the target scores all k+1 positions
of every live row in ONE chunk dispatch (`models/decode
._paged_prefill_chunk` with `all_logits=True`: on the card the paged
kernel's chunk route at width k+1, every slot row at once, each row with
its own start and valid length). Per round the host copies back only
(accepted count, tokens) per row: one copy for up to k+1 tokens.

Correctness (held against the JAX engine in
`tests/test_torch_speculative.py`):

* **greedy** (temperature 0): a draft is accepted iff it equals the target
  argmax at its position, and the first rejection (or the bonus position)
  emits the target argmax itself, so the tokens are the non-speculative
  paged engine's whatever the drafter proposes;
* **sampled**: exact rejection sampling. The drafter draws d ~ q by a
  Gumbel-max over its filtered, temperature-scaled logits, so q is exactly
  softmax(filtered / T); d is accepted when u q(d) < p(d); the first
  rejection redraws from norm(max(p - q, 0)), with q zeroed at the bonus
  position and outside the row's window (p itself where the residual is
  empty). The tokens are distributed as the plain sampler's (Leviathan et
  al.). Each draw hashes (request seed, absolute position) in a stream of
  its own (`decode.hash_uniform`, streams TAG_DRAFT, TAG_ACCEPT and
  TAG_RESAMPLE; the plain sampler's is stream 0), so a request's tokens
  depend on its seed and its own accepts, not on its batch (a preemption,
  which restarts its rounds from a prefill, draws anew).

Three device programs, each a dispatch kind of the engine's `Dispatcher`
(at tp > 1 rank 0 decides and every rank computes; every rank gathers the
full-vocab logits and draws from the same hash, so the ranks agree without
a further collective):

* **draft** (`spec_draft`): k+1 drafter single-token steps
  (`_paged_decode_one`, the paged kernel's decode route), step j feeding
  the round's j-th token at cursor + j. The last step only writes the last
  draft's K/V, so the drafter cache stays whole through an all-accept
  round. The drafts (b, k) and, when sampling, q (b, k, V) f32 stay on the
  card in engine-owned tensors that the verify reads;
* **verify** (`spec_verify`): the target over the (b, k+1) block, per-row
  `qlen = min(k+1, buf_len - pos)` (0 for rows not decoding), then the
  accept rule; returns (n_acc, out) as one (b, k+2) int32 tensor;
* **drafter chunk** (`drafter_chunk`): the drafter's prefill of a request's
  whole prefix in power-of-two chunks, at admission and at a preempted
  request's resume.

At tp = 1 on a card the draft and the verify are each captured once as a
CUDA graph and replayed (`decode_graph`, `runtime/graphs.py`); the engine
never runs, so never captures, the paged engine's one-token step.

The drafter keeps its own `PagedKVPool` (the target's `kv_dtype`), never
shares pages copy-on-write, and is freed with the target's pages when a
request retires or is preempted. A target at cp > 1 shards its pages over
the cp ranks (`PagedEngine`) and its verify width rounds up to a cp
multiple, as JAX's; the drafter stays at cp = 1, its whole pool on every
rank. int8 decode weights quantize the target
only. The paged engine's obs hooks run here too (the `draft` and
`verify` spans, a `spec_round` span per round in each request's timeline,
the drafter's pages in the flight ring and the gauges), and its
controller may move `k`: the next round dispatches at the new width (the
draft and verify headers carry k, so the other ranks follow), the graphs
captured at that width once (`round_captures` in `stats()`), up to
`k_max`, the largest k the drafter's page rows hold.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..config import resolve_dtype_on
from ..models.decode import (_filter_logits, _full_vocab_logits,
                             _paged_decode_one, _paged_prefill_chunk,
                             decode_tables, gumbel_noise, hash_uniform)
from ..runtime.graphs import CapturedStep, use_decode_graph
from .engine import (PagedEngine, Request, _chunk_maps, _pow2_at_most,
                     _to_device)
from .kv_manager import PagedKVPool, PoolExhausted, page_bytes

# the hash's streams of the speculative draws (0 is the plain sampler's)
TAG_DRAFT, TAG_ACCEPT, TAG_RESAMPLE = 1, 2, 3


def _leading(accept: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per row, the count of leading accepted drafts inside the row's
    valid window (draft i sits at window slot i + 1)."""
    return torch.cumprod((accept & valid).int(), dim=1).sum(dim=1)


class SpeculativeEngine(PagedEngine):
    """`PagedEngine` with a drafter: k tokens drafted per round by
    `drafter_model` over its own page pool, verified by the target in one
    (k+1)-position dispatch with exact rejection sampling (see the module
    docstring). The JAX engine takes (model, mesh, params, drafter_model,
    drafter_params, ...); here both models carry their weights (this
    rank's shard) on `mesh.device`. `drafter_pages` (0: every slot can
    hold its whole drafter row) sizes the drafter's pool; the other
    keyword arguments are `PagedEngine`'s."""

    _CAPTURES_DECODE_STEP = False

    def __init__(self, model, mesh, drafter_model, num_slots: int,
                 buf_len: int, eos_id: int, speculate_k: int = 4,
                 drafter_pages: int = 0, **kw):
        if speculate_k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {speculate_k}")
        if kw.get("debug_host_sampler"):
            raise ValueError(
                "debug_host_sampler is the NON-speculative engines' "
                "ablation knob (the speculative round never materialises "
                "host logits); drop --speculate to measure it")
        if drafter_model.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(
                f"drafter vocab {drafter_model.cfg.vocab_size} != target "
                f"vocab {model.cfg.vocab_size} — build the drafter preset "
                f"with the target's vocab_size (serve.py does)")
        if getattr(drafter_model, "cp_size", 1) > 1:
            raise ValueError(
                "speculative serving shards only the TARGET's pages over "
                "cp (supported shape: target cp>=1, drafter cp=1) — the "
                "drafter's pool is small enough to replicate, so build the "
                f"drafter preset with cp_size=1 (got "
                f"{drafter_model.cp_size})")
        weights_on = drafter_model.embedding.weight.device
        if weights_on != mesh.device:
            raise ValueError(f"drafter weights lie on {weights_on}, the mesh "
                             f"on {mesh.device}")
        super().__init__(model, mesh, num_slots, buf_len, eos_id, **kw)
        self._k = k = int(speculate_k)
        self.drafter_model = drafter_model
        self._ddtype = resolve_dtype_on(drafter_model.cfg.compute_dtype,
                                        mesh.device)
        ps = self.page_size
        # the drafter buffers buf_len + k + 1 positions: on an all-accept
        # round it has consumed one token past the target buffer's last
        self._d_max_pages = -(-(self.buf_len + k + 1) // ps)
        dbuf = self._d_max_pages * ps
        cap = getattr(drafter_model, "max_decode_positions", None)
        if cap is not None and dbuf > cap:
            raise ValueError(
                f"drafter buffer {dbuf} (buf_len {self.buf_len} + k {k} + "
                f"1, page-rounded) exceeds the drafter's learned position "
                f"table ({cap}); pick a RoPE drafter or shrink the buffer")
        self._dcos, self._dsin = decode_tables(
            drafter_model, max(drafter_model.cfg.maxlen, dbuf), self.device)
        if not drafter_pages:
            drafter_pages = num_slots * self._d_max_pages
        self.dpool = PagedKVPool(drafter_model, mesh, drafter_pages, ps,
                                 kv_dtype=self.kv_dtype)
        self._drafter_page_bytes_each = page_bytes(drafter_model.cfg, ps,
                                                   self.kv_dtype)
        self._dtbl = np.full((num_slots, self._d_max_pages),
                             self.dpool.scratch_page, np.int32)
        # the verify's width: k + 1 positions padded up to a cp multiple
        # (JAX's query ring splits it over cp; pads aim at the scratch
        # page and are never scored)
        self._vw = self.cp * -(-(k + 1) // self.cp)
        for kind, fn in (("spec_draft", self._run_draft),
                         ("spec_verify", self._run_verify),
                         ("drafter_chunk", self._run_drafter_chunk)):
            self.dispatch.register(kind, fn)
        # -- speculative stats -------------------------------------------
        self.spec_rounds = 0                 # verify dispatches
        self.spec_row_rounds = 0             # sum of live rows over rounds
        self.spec_emitted = 0                # tokens emitted by rounds
        self.drafter_s = 0.0                 # draft + drafter-prefill wall
        self.target_s = 0.0                  # verify wall
        self._acc_attempt = np.zeros(k, np.int64)
        self._acc_accept = np.zeros(k, np.int64)
        # the draft's outputs (drafts, q): the draft graph's static outputs
        # when the round is captured, else each eager draft's
        self._draft_out = None
        self._round_graphs = ()
        self._graphs_by_k = {}            # k -> (draft graph, verify graph)
        self.round_captures = 0
        self._graphed = use_decode_graph(kw.get("decode_graph", "auto"),
                                         self.device, mesh.tp, self.cp)
        if self._graphed:
            self._capture_round()
        self.reset_drop_tally()

    # -- the speculation width ---------------------------------------------
    @property
    def k(self) -> int:
        return self._k

    @k.setter
    def k(self, value: int) -> None:
        """A new speculation width (the SLO controller's knob): the next
        round drafts `value` tokens; its graphs are captured at that width
        at the first use."""
        k = int(value)
        if k == self._k:
            return
        if not 1 <= k <= self.k_max:
            raise ValueError(f"speculate_k {k} outside [1, {self.k_max}] "
                             f"(the drafter's page rows hold buf_len + "
                             f"k + 1 positions)")
        self._k = k
        self._vw = self.cp * -(-(k + 1) // self.cp)
        if k > len(self._acc_attempt):
            pad = np.zeros(k - len(self._acc_attempt), np.int64)
            self._acc_attempt = np.concatenate([self._acc_attempt, pad])
            self._acc_accept = np.concatenate([self._acc_accept, pad])
        if self._graphed:
            self._capture_round()

    @property
    def k_max(self) -> int:
        return self._d_max_pages * self.page_size - self.buf_len - 1

    # -- the round's device programs --------------------------------------
    def _capture_round(self) -> None:
        """The draft and the verify captured once each. Their examples write
        only the scratch pages: every table entry and destination on the
        scratch page, cursors 0, no valid verify column."""
        n, mp, cw = self.num_slots, self.max_pages, self._vw
        draft = np.concatenate([
            np.zeros(3 * n, np.int32),
            np.full(n * self._d_max_pages, self.dpool.scratch_page,
                    np.int32)])
        verify = np.concatenate([
            np.zeros(4 * n, np.int32),
            np.full(n * (mp + cw), self.pool.scratch_page, np.int32),
            np.tile(np.arange(cw, dtype=np.int32) % self.page_size, n)])
        if self._k not in self._graphs_by_k:
            with torch.no_grad():
                draft_graph = CapturedStep(
                    self._draft_body,
                    [torch.from_numpy(draft).to(self.device)])
                # the verify graph reads the draft graph's static outputs
                self._draft_out = draft_graph.outputs
                verify_graph = CapturedStep(
                    self._verify_body,
                    [torch.from_numpy(verify).to(self.device)])
            self._graphs_by_k[self._k] = (draft_graph, verify_graph)
            self.round_captures += 1
        self._round_graphs = self._graphs_by_k[self._k]
        self._draft_out = self._round_graphs[0].outputs

    def _propose(self, full: torch.Tensor, seeds: torch.Tensor,
                 positions: torch.Tensor):
        """The drafter's proposal at `positions` from its full-vocab
        logits: the argmax when greedy (q None), else a Gumbel-max draw in
        stream TAG_DRAFT over the filtered, scaled logits and q = their
        softmax (f32), the distribution the draw follows exactly."""
        temperature, top_k, top_p = self._sampling
        if temperature == 0.0:
            return torch.argmax(full, dim=-1), None
        scaled = _filter_logits(full / temperature, top_k, top_p)
        noise = gumbel_noise(seeds, positions, full.shape[-1], TAG_DRAFT)
        return (torch.argmax(scaled.double() + noise, dim=-1),
                torch.softmax(scaled, dim=-1))

    def _draft_body(self, dev: torch.Tensor):
        """k+1 drafter steps over every slot row from the packed dispatch
        (pending tokens | cursors | seeds | drafter table): (drafts (b, k)
        int32,) or, when sampling, (drafts, q (b, k, V) f32)."""
        n, k, ps = self.num_slots, self.k, self.page_size
        tok, pos, seeds = dev[:n], dev[n:2 * n], dev[2 * n:3 * n]
        tbl = dev[3 * n:].view(n, self._d_max_pages)
        drafts, qs = [], []
        for j in range(k + 1):
            logits = _paged_decode_one(
                self.drafter_model, self.dpool.ks, self.dpool.vs, tok,
                pos + j, tbl, ps, self._dcos, self._dsin, self._ddtype,
                attn_impl=self.paged_attn_impl)
            if j == k:              # its K/V written; its proposal unused
                break
            tok, q = self._propose(
                _full_vocab_logits(self.drafter_model, logits), seeds,
                pos + j + 1)
            drafts.append(tok)
            qs.append(q)
        draft = torch.stack(drafts, dim=1).to(torch.int32)
        if qs[0] is None:
            return (draft,)
        return draft, torch.stack(qs, dim=1)

    def _verify_body(self, dev: torch.Tensor) -> torch.Tensor:
        """The target over each row's (k+1)-position block from the packed
        dispatch (pending tokens | cursors | qlen | seeds | page table |
        destination pages | offsets, the last two at the verify width) and
        the draft's outputs, then the accept rule: (b, k+2) int32, each
        row's accepted count and its k+1 tokens (the accepted drafts, then
        the new pending token)."""
        n, k, mp, vw = self.num_slots, self.k, self.max_pages, self._vw
        cw = k + 1
        tok, pos = dev[:n], dev[n:2 * n]
        qlen, seeds = dev[2 * n:3 * n], dev[3 * n:4 * n]
        o = 4 * n + n * mp
        tbl = dev[4 * n:o].view(n, mp)
        dstp = dev[o:o + n * vw].view(n, vw)
        dsto = dev[o + n * vw:o + 2 * n * vw].view(n, vw)
        draft = self._draft_out[0]
        block = torch.cat([tok[:, None], draft], dim=1)      # (n, cw)
        if vw > cw:                       # pad columns: past every qlen
            block = torch.cat([block, torch.full_like(block[:, :vw - cw],
                                                      self.eos_id)], dim=1)
        logits = _paged_prefill_chunk(
            self.model, self.pool.ks, self.pool.vs, block, pos, qlen, tbl,
            dstp, dsto, self.page_size, self._cos, self._sin, self._dtype,
            all_logits=True, attn_impl=self.paged_attn_impl, cp=self.cp)
        full = _full_vocab_logits(self.model, logits[:, :cw])  # (n, cw, V)
        d = draft.long()
        ks = torch.arange(k, device=dev.device)
        valid = (ks[None, :] + 1) < qlen[:, None]            # (n, k)
        temperature, top_k, top_p = self._sampling
        if temperature == 0.0:
            tgt = torch.argmax(full, dim=-1)                 # (n, cw)
            n_acc = _leading(d == tgt[:, :k], valid)
            nxt = tgt.gather(1, n_acc[:, None].long())[:, 0]
        else:
            vocab = full.shape[-1]
            q = self._draft_out[1]                           # (n, k, V)
            scaled = _filter_logits(full.reshape(n * cw, vocab) / temperature,
                                    top_k, top_p)
            p = torch.softmax(scaled, dim=-1).reshape(n, cw, vocab)
            p_d = p[:, :k].gather(2, d[..., None])[..., 0]
            q_d = q.gather(2, d[..., None])[..., 0]
            u = hash_uniform(seeds[:, None], pos[:, None] + 1 + ks[None, :],
                             1, TAG_ACCEPT)[..., 0]
            # u < p/q  <=>  u q < p (q(d) > 0 for a token drawn from q)
            n_acc = _leading(u * q_d < p_d, valid)
            # the residual at the first rejected slot: q zeroed at the
            # bonus slot and where the window, not a test, ended the run,
            # so the draw there is from p itself
            at = n_acc[:, None, None].long().expand(n, 1, vocab)
            qpad = torch.cat([torch.where(valid[..., None], q, 0.0),
                              torch.zeros_like(q[:, :1])], dim=1)
            p_at = p.gather(1, at)[:, 0]
            res = torch.clamp(p_at - qpad.gather(1, at)[:, 0], min=0.0)
            # p == q empties the residual (only garbage rows reach it)
            res = torch.where(res.sum(-1, keepdim=True) > 0.0, res, p_at)
            logres = torch.where(res > 0.0, torch.log(res.double()),
                                 -torch.inf)
            nxt = torch.argmax(logres + gumbel_noise(
                seeds, pos + 1 + n_acc, vocab, TAG_RESAMPLE), dim=-1)
        out = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
        out.scatter_(1, n_acc[:, None].long(), nxt[:, None])
        return torch.cat([n_acc[:, None].long(), out], dim=1).to(torch.int32)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_draft(self, shape, packed: np.ndarray) -> None:
        # a round's dispatch carries its k: a rank at another width (the
        # controller moves rank 0's) takes it on first
        self.k = shape[0]
        if self._round_graphs:
            self._round_graphs[0](packed)   # writes self._draft_out
        else:
            self._draft_out = self._draft_body(_to_device(packed,
                                                          self.device))

    def _run_verify(self, shape, packed: np.ndarray) -> np.ndarray:
        self.k = shape[0]
        if self._round_graphs:
            res = self._round_graphs[1](packed)
        else:
            res = self._verify_body(_to_device(packed, self.device))
        return res.cpu().numpy()

    def _run_drafter_chunk(self, shape, packed: np.ndarray) -> None:
        """One drafter prefill chunk of width shape[0] (the payload of the
        paged engine's chunk, without a seed): only its K/V writes
        matter."""
        cw, mp = shape[0], self._d_max_pages
        dev = _to_device(packed, self.device)
        o = cw + 2 + mp
        _paged_prefill_chunk(
            self.drafter_model, self.dpool.ks, self.dpool.vs, dev[None, :cw],
            dev[cw:cw + 1], dev[cw + 1:cw + 2], dev[None, cw + 2:o],
            dev[None, o:o + cw], dev[None, o + cw:o + 2 * cw],
            self.page_size, self._dcos, self._dsin, self._ddtype,
            attn_impl=self.paged_attn_impl)

    # -- request intake ---------------------------------------------------
    def submit(self, req: Request) -> None:
        """`PagedEngine.submit` plus the drafter's worst case: admitted
        work must fit BOTH pools alone, else preemption could deadlock
        with the request as the sole survivor."""
        need_d = -(-min(len(req.prompt) + req.max_new + self.k + 1,
                        self._d_max_pages * self.page_size)
                   // self.page_size)
        if need_d > self.dpool.num_pages:
            raise ValueError(
                f"request {req.rid}: drafter needs up to {need_d} pages "
                f"but the drafter pool has {self.dpool.num_pages} — raise "
                f"--drafter_pages or lower the budget")
        super().submit(req)

    # -- drafter pages ----------------------------------------------------
    def _dalloc_page(self, needy_slot: int) -> int:
        while True:
            try:
                return self.dpool.alloc()
            except PoolExhausted:
                cands = self._candidates(exclude_slot=needy_slot)
                if not cands:
                    raise RuntimeError(
                        "drafter page pool exhausted with no preemption "
                        "candidate — a single request outgrew "
                        "drafter_pages (submit-time validation should "
                        "have refused it)")
                self._preempt(cands[0][0])

    def _ensure_drafter_writable(self, slot: int, lo: int, hi: int) -> None:
        """Drafter pages for positions [lo, hi): always private (the
        drafter never shares), so unmapped entries just allocate."""
        ps, scratch = self.page_size, self.dpool.scratch_page
        for j in range(lo // ps, -(-hi // ps)):
            if self._dtbl[slot, j] == scratch:
                self._dtbl[slot, j] = self._dalloc_page(slot)

    def _release_slot(self, slot: int) -> int:
        # retire and preempt free BOTH page lists, the drafter's first, so
        # a preemption for target pages cannot leak drafter pages
        scratch = self.dpool.scratch_page
        freed = 0
        for j in range(self._d_max_pages):
            if self._dtbl[slot, j] != scratch:
                self.dpool.unref(int(self._dtbl[slot, j]))
                self._dtbl[slot, j] = scratch
                freed += 1
        return freed + super()._release_slot(slot)

    # -- drafter prefill (admission and preempt-resume) -------------------
    def _drafter_prefill(self, slot: int, ids: List[int]) -> None:
        """The drafter's K/V for the whole prefix `ids`, in
        `prefill_chunk`-sized power-of-two dispatches (no prefix sharing:
        the positions the target shared are recomputed at drafter cost)."""
        ps, s = self.page_size, 0
        while s < len(ids):
            n = min(len(ids) - s, self.prefill_chunk)
            self._ensure_drafter_writable(slot, s, s + n)
            cw = _pow2_at_most(n, self.prefill_chunk)
            buf, dstp, dsto = _chunk_maps(ids, s, n, cw, ps, self.eos_id,
                                          self.dpool.scratch_page,
                                          self._dtbl[slot])
            t0 = time.monotonic()
            with self._span("drafter_prefill_chunk", slot=slot, pos0=s,
                            n=n):
                self.dispatch("drafter_chunk", (cw,), np.concatenate([
                    buf[0], np.array([s, n], np.int32), self._dtbl[slot],
                    dstp[0], dsto[0]]))
                self._sync()
            self.drafter_s += time.monotonic() - t0
            s += n

    def _finish_prefill(self, slot, st, first, done) -> None:
        # the target cache is whole: build the drafter's before the slot
        # goes live (a resumed request passes here too, so both caches
        # rebuild from the same prompt + generated prefix)
        self._drafter_prefill(slot, st.ids)
        if self.rt is not None:
            self.rt.mark(st.req, "drafter_prefill", self._clock(),
                         positions=len(st.ids))
        super()._finish_prefill(slot, st, first, done)

    # -- the speculative round --------------------------------------------
    def _round_payloads(self):
        """Make every live row's window writable in both pools, then the
        round's two dispatches: (draft payload, verify payload, qlen), or
        None when no slot is left live."""
        k, ps, vw = self.k, self.page_size, self._vw
        cw = k + 1
        # target pages for [pos, pos + qlen) (growth and copy-on-write),
        # drafter pages for [pos, pos + k + 1). Either may preempt, so
        # iterate snapshots and re-check liveness
        for slot in list(self._slot_req):
            if slot not in self._slot_req:
                continue
            pos = int(self._pos[slot])
            self._ensure_writable(slot, pos,
                                  pos + min(cw, self.buf_len - pos))
        for slot in list(self._slot_req):
            if slot not in self._slot_req:
                continue
            pos = int(self._pos[slot])
            self._ensure_drafter_writable(slot, pos, pos + cw)
        if not self._slot_req:
            return None
        b = self.num_slots
        dstp = np.full((b, vw), self.pool.scratch_page, np.int32)
        dsto = np.tile(np.arange(vw, dtype=np.int32)[None, :] % ps, (b, 1))
        qlen = np.zeros(b, np.int32)          # rows not decoding: none
        for slot in self._slot_req:
            pos = int(self._pos[slot])
            ql = min(cw, self.buf_len - pos)
            qlen[slot] = ql
            for i in range(ql):
                dstp[slot, i] = self._tbl[slot, (pos + i) // ps]
                dsto[slot, i] = (pos + i) % ps
        seeds = self._seeds.view(np.int32)
        return (np.concatenate([self._tokens, self._pos, seeds,
                                self._dtbl.ravel()]),
                np.concatenate([self._tokens, self._pos, qlen, seeds,
                                self._tbl.ravel(), dstp.ravel(),
                                dsto.ravel()]), qlen)

    def _decode(self, done: List[Request]) -> None:
        payloads = self._round_payloads()
        if payloads is None:
            return
        draft, verify, qlen = payloads
        k = self.k
        t0 = time.monotonic()
        with self._span("draft", live=len(self._slot_req), k=k):
            self.dispatch("spec_draft", (k,), draft)
            # sync, so the drafter/target split of the wall is honest (the
            # drafts stay on the card: the verify reads them there)
            self._sync()
        self.drafter_s += time.monotonic() - t0
        t0 = time.monotonic()
        with self._span("verify", live=len(self._slot_req), k=k):
            res = self.dispatch("spec_verify", (k,), verify)
        self.target_s += time.monotonic() - t0
        n_acc, out = res[:, 0], res[:, 1:]
        now = self._clock()
        self.decode_steps += 1
        self.spec_rounds += 1
        self.spec_row_rounds += len(self._slot_req)
        used, live_tokens = self._step_accounting()
        dused = self.dpool.pages_in_use
        self._after_step(used, live_tokens,
                         pool_bytes=used * self._page_bytes_each
                         + dused * self._drafter_page_bytes_each,
                         drafter_pages_in_use=dused)
        for slot, req in list(self._slot_req.items()):
            na = int(n_acc[slot])
            n_att = min(k, int(qlen[slot]) - 1)
            for j in range(min(na, n_att)):
                self._acc_attempt[j] += 1
                self._acc_accept[j] += 1
            if na < n_att:
                self._acc_attempt[na] += 1    # the first rejected draft
            if self.rt is not None:
                # one `spec_round` span per verify; `accepted` sums over
                # coalesced rounds
                self.rt.mark(req, "spec_round", now, accepted=na)
            # the pending token was written at `pos` by the verify: emitted
            req.tokens.append(int(self._tokens[slot]))
            self.generated_tokens += 1
            self.spec_emitted += 1
            adv, finished = 1, False
            for j in range(na + 1):
                cand = int(out[slot, j])
                if (cand == self.eos_id
                        or req.prompt_len + len(req.tokens) >= req.limit):
                    req.finish_t = now
                    del self._slot_req[slot]
                    self._retire_slot(slot, req, done)
                    finished = True
                    break
                if j < na:                    # an accepted draft: emitted
                    req.tokens.append(cand)
                    self.generated_tokens += 1
                    self.spec_emitted += 1
                    adv += 1
                else:                         # the round's new pending token
                    self._tokens[slot] = cand
            if not finished:
                self._pos[slot] += adv

    # -- aggregate view ---------------------------------------------------
    def stats(self) -> dict:
        st = super().stats()
        att = np.maximum(self._acc_attempt, 1)
        st.update({
            "speculate_k": self.k,
            "spec_rounds": self.spec_rounds,
            "round_captures": self.round_captures,
            # tokens emitted per ROW per target dispatch: the plain engine
            # emits 1.0, a perfect drafter k+1
            "accepted_tokens_per_dispatch": round(
                self.spec_emitted / max(self.spec_row_rounds, 1), 4),
            "acceptance_rate_by_position": [
                round(float(a) / float(t), 4)
                for a, t in zip(self._acc_accept, att)],
            "acceptance_rate": round(
                float(self._acc_accept.sum())
                / max(float(self._acc_attempt.sum()), 1.0), 4),
            "rounds_per_request": round(
                self.spec_rounds / max(len(self.completed), 1), 4),
            "drafter_ms_total": round(self.drafter_s * 1e3, 3),
            "target_ms_total": round(self.target_s * 1e3, 3),
            "drafter_num_pages": self.dpool.num_pages,
            "drafter_pages_in_use": self.dpool.pages_in_use,
            "drafter_page_bytes": page_bytes(self.drafter_model.cfg,
                                             self.page_size, self.kv_dtype),
            "target_page_bytes": page_bytes(self.model.cfg,
                                            self.page_size, self.kv_dtype),
        })
        return st
