"""KV-cache pools: the slot-granular `KVCachePool` of the continuous-
batching engine and the page pool `PagedKVPool` of the paged engine, whose
pages shard over the cp ranks at cp > 1 (counterparts of both and of
`local_page_ids` in the JAX `serving/kv_manager.py`).

One device tensor per K/V with a `slots` axis,

    (num_layers, num_slots + 1, kv_heads / tp, buf_len, head_dim)

in the compute dtype; at tp > 1 each rank's pool holds its kv_heads / tp
local heads (the JAX pools are sharded on that dim). `alloc()` leases a
free slot to a request; prefill writes the prompt's K/V into that slot's
rows; every decode step advances all slots; `free()` returns the slot.
The LAST slot (index `num_slots`) is a scratch row that is never leased:
prefill batches padded up to a bucket size aim their pad rows at it, so
pad work lands somewhere harmless.

The engine writes these tensors in place (index assignment under
`torch.inference_mode`), which takes the place of the JAX engine's buffer
donation: a refill never reallocates the pool.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np
import torch

from ..config import resolve_dtype
from ..ops.collectives import KV_GATHER, KV_SCATTER, all_gather, broadcast


def local_page_ids(ids: torch.Tensor, ppr: int, rank: int) -> torch.Tensor:
    """GLOBAL page ids -> cp rank `rank`'s LOCAL pool indices (the JAX
    `local_page_ids`): rank r's slab holds global pages [r * ppr, (r + 1) *
    ppr) at local [0, ppr) and its scratch page at local ppr. Any id the
    rank does not own (another rank's page, or the global scratch
    sentinel) maps to that local scratch: reads there are masked, writes
    quarantined. At cp = 1 (ppr = num_pages) it is the identity on every
    valid id."""
    lo = rank * ppr
    owned = (ids >= lo) & (ids < lo + ppr)
    return torch.where(owned, ids - lo, torch.full_like(ids, ppr))


def kv_token_bytes(cfg, kv_dtype=None) -> int:
    """K+V cache bytes per TOKEN POSITION at a model shape (all layers, all
    kv heads — every tp rank's together, as JAX counts them — K and V). An
    int8 pool pays one code per element plus the f32 scale of each stored
    head-vector."""
    if kv_dtype == "int8":
        per_head = cfg.head_dim + 4            # int8 codes + f32 scale
    else:
        itemsize = torch.empty((), dtype=resolve_dtype(
            cfg.compute_dtype)).element_size()
        per_head = cfg.head_dim * itemsize
    return 2 * cfg.num_layers * cfg.kv_heads * per_head


def page_bytes(cfg, page_size: int, kv_dtype=None) -> int:
    """K+V bytes of ONE page at a model shape (scratch page excluded)."""
    return kv_token_bytes(cfg, kv_dtype) * page_size


def kv_leaves(k, v) -> list:
    """[k, v] as tensors: native pools' two, int8 pools' (codes, scales)
    pairs flattened to [k codes, k scales, v codes, v scales] (the JAX
    tree order, which the page stream's blobs follow too)."""
    return [t for x in (k, v) for t in (x if isinstance(x, tuple) else (x,))]


def device_bytes(pool) -> int:
    """The bytes this rank's pool tensors hold (K and V, int8 scales
    included, the scratch entry too)."""
    return sum(t.numel() * t.element_size()
               for t in kv_leaves(pool.ks, pool.vs))


class KVCachePool:
    """Device-resident K/V pool + host-side slot free-list."""

    def __init__(self, model, mesh, num_slots: int, buf_len: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        cfg = model.cfg
        self.num_slots = num_slots
        self.buf_len = buf_len
        self.scratch_slot = num_slots          # never leased; pad-row target
        self.dtype = resolve_dtype(cfg.compute_dtype)
        shape = (cfg.num_layers, num_slots + 1, model.num_local_kv_heads,
                 buf_len, cfg.head_dim)
        self.ks = torch.zeros(shape, dtype=self.dtype, device=mesh.device)
        self.vs = torch.zeros(shape, dtype=self.dtype, device=mesh.device)
        self._free = deque(range(num_slots))

    # -- slot leasing ----------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_slots(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.live_slots / self.num_slots

    def alloc_many(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"KV pool exhausted: asked for {n} slots, "
                               f"{len(self._free)} free")
        return [self._free.popleft() for _ in range(n)]

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.num_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)


class PoolExhausted(RuntimeError):
    """Raised by PagedKVPool.alloc when no free page exists — the paged
    engine's signal to preempt a victim (or refuse admission)."""


class PagedKVPool:
    """Fixed-size KV PAGES + host-side free list, refcounts, and a
    content-addressed prefix index. The unit is a page of `page_size` token
    positions,

        (num_layers, num_pages + 1, kv_heads / tp, page_size, head_dim)

    and a request's logical cache row is its page list (the engine's
    (slots, max_pages) page table), leased as its cursor grows — capacity is
    live tokens, not slots x buf_len — and shared between prompts with a
    common prefix:

    * refcount[p] counts the page lists that reference page p. alloc()
      hands out a free page at 1, ref() adds a sharer, unref() drops one and
      frees the page (and its prefix-index entries) at 0; after every
      request retires the counts are all zero again.
    * copy-on-write: a writer whose page has refcount > 1 takes a private
      copy first (`copy_pages`); sharers keep the original bits.
    * prefix index: prompt pages register under a hash CHAIN key
      (key_j = (key_{j-1}, page_tokens)) with their valid tokens, so a new
      prompt walks the chain page by page and may end on a partial match
      inside the last page (visibility masks the rest). Index entries hold
      no refcount: sharing happens only against pages a live request still
      references.

    The LAST page (index num_pages) is scratch: free rows' page tables and
    chunk pad columns aim their writes at it, and no live row attends to
    it. `kv_dtype='int8'` stores (codes int8, scales f32) tuples with one
    scale per stored head-vector (scales start at ones, as in JAX), so
    append-only writes never requantize a page's earlier positions.

    At cp > 1 (the model's `cp_size`) the pages shard over the cp ranks:
    rank r holds only its own slab, global pages [r * ppr, (r + 1) * ppr)
    at local indices [0, ppr) plus a LOCAL scratch page at index ppr
    (pages_per_rank = ppr = num_pages / cp), so each rank's tensors are

        (num_layers, pages_per_rank + 1, kv_heads / tp, page_size, head_dim)

    The host keeps the global view: page ids are global, one free list per
    owning rank (`alloc(owner)`: page-table column j belongs to rank j //
    (max_pages / cp)), and the device side translates with
    `local_page_ids`. At cp = 1 the one slab is the whole pool.

    The pool tensors are written in place by the decode lowerings, which
    takes the place of the JAX engine's buffer donation. `export_pages` /
    `import_pages` move whole pages between pools through the host (the
    disaggregated prefill -> decode handoff, `serving/transfer.py`) in
    JAX's payload, the global heads, so the two pools may run at other tp
    and cp widths; on a sharded pool they are collectives over its
    mesh."""

    def __init__(self, model, mesh, num_pages: int, page_size: int,
                 kv_dtype=None, flight=None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in (None, "native", "int8"):
            raise ValueError(f"kv_dtype must be None/'native'/'int8', got "
                             f"{kv_dtype!r}")
        cfg = model.cfg
        self.cp = max(1, int(getattr(model, "cp_size", 1)))
        if num_pages % self.cp:
            raise ValueError(
                f"num_pages {num_pages} must be divisible by cp "
                f"{self.cp} (each cp rank owns an equal page slab; the "
                f"engine rounds up before building the pool)")
        self.num_pages = num_pages
        self.pages_per_rank = num_pages // self.cp
        # this process's slab: global pages [lo, lo + pages_per_rank)
        self.cp_rank = mesh.cp_rank if self.cp > 1 else 0
        self.tp = getattr(mesh, "tp", 1)
        self.tp_rank = mesh.tp_rank if self.tp > 1 else 0
        self.mesh = mesh
        self.world = getattr(mesh, "world", 1)
        self.leader = getattr(mesh, "rank", 0) == 0
        self.page_size = page_size
        self.flight = flight  # obs.flight.FlightRecorder: exhaustion, COW
        self.scratch_page = num_pages          # never leased; pad target
        self.kv_dtype = "int8" if kv_dtype == "int8" else None
        shape = (cfg.num_layers, self.pages_per_rank + 1,
                 model.num_local_kv_heads, page_size, cfg.head_dim)
        dev = mesh.device
        if self.kv_dtype:
            self.dtype = torch.int8
            alloc = lambda: (torch.zeros(shape, dtype=torch.int8, device=dev),
                             torch.ones(shape[:-1], dtype=torch.float32,
                                        device=dev))
        else:
            self.dtype = resolve_dtype(cfg.compute_dtype)
            alloc = lambda: torch.zeros(shape, dtype=self.dtype, device=dev)
        self.device = dev
        self.ks = alloc()
        self.vs = alloc()
        # one free list per owning cp rank (cp = 1: one)
        ppr = self.pages_per_rank
        self._free = [deque(range(r * ppr, (r + 1) * ppr))
                      for r in range(self.cp)]
        self.refcount = np.zeros(num_pages, np.int32)
        self._children = {}     # chain_key -> [(page_id, tokens_tuple)]
        self._page_keys = {}    # page_id -> parent chain_key (for dereg)
        self.cow_copies = 0

    # -- page leasing -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    def free_pages_of(self, owner: int) -> int:
        return len(self._free[owner])

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def alloc(self, owner: int = 0) -> int:
        """A free page from cp rank `owner`'s slab (cp = 1: the pool)."""
        if not self._free[owner]:
            if self.flight is not None:
                self.flight.record("pool_exhausted", owner=owner,
                                   num_pages=self.num_pages)
            raise PoolExhausted(
                f"page pool exhausted (rank {owner}'s slab of "
                f"{self.pages_per_rank} pages fully leased) — the engine "
                f"preempts or the scheduler gates admission")
        page = self._free[owner].popleft()
        self.refcount[page] = 1
        return page

    def ref(self, page: int) -> None:
        assert self.refcount[page] > 0, f"ref of free page {page}"
        self.refcount[page] += 1

    def unref(self, page: int) -> None:
        if not 0 <= page < self.num_pages:
            raise ValueError(f"page {page} out of range [0, {self.num_pages})")
        if self.refcount[page] <= 0:
            raise ValueError(f"page {page} unref'd below zero")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._deregister(page)
            self._free[page // self.pages_per_rank].append(page)

    # -- prefix index -----------------------------------------------------
    @staticmethod
    def chain_key(parent, tokens) -> tuple:
        """Content key of a page-aligned token run chained onto the key of
        everything before it (equal tokens under different prefixes must
        not collide: K/V depend on the whole prefix)."""
        return (parent, tuple(int(t) for t in tokens))

    def register_prefix(self, parent, page: int, tokens) -> None:
        """Index a prompt page under its prefix chain with its VALID tokens
        (page_size of them for a full page, fewer for a prompt's tail). A
        page already indexed (a shared donor announced again) is skipped."""
        if page in self._page_keys:
            return
        tokens = tuple(int(t) for t in tokens)
        self._children.setdefault(parent, []).append((page, tokens))
        self._page_keys[page] = parent

    def children(self, parent):
        """Candidate next pages under a prefix chain: [(page, tokens)]."""
        return self._children.get(parent, [])

    def _deregister(self, page: int) -> None:
        # the chain ROOT's parent key is None, so None cannot double as the
        # "not indexed" sentinel here
        if page not in self._page_keys:
            return
        parent = self._page_keys.pop(page)
        lst = [e for e in self._children.get(parent, []) if e[0] != page]
        if lst:
            self._children[parent] = lst
        else:
            self._children.pop(parent, None)

    # -- copy-on-write ----------------------------------------------------
    def copy_pages(self, pairs) -> None:
        """Materialise private copies: pairs of (src_page, dst_page) in one
        gather + scatter per pool tensor, each rank copying the pairs its
        slab holds. (The JAX pool pads the pairs to a power of two to bound
        its recompiles; eager torch has none.)"""
        if not pairs:
            return
        ppr = self.pages_per_rank
        for s, d in pairs:
            if s // ppr != d // ppr:
                raise ValueError(
                    f"COW pair ({s} -> {d}) crosses cp slabs (owners "
                    f"{s // ppr} -> {d // ppr}); a page-table column's "
                    f"replacement must stay with its owning rank")
        mine = [(s, d) for s, d in pairs if s // ppr == self.cp_rank]
        self.cow_copies += len(pairs)
        if self.flight is not None:
            self.flight.record("cow_copy", pages=len(pairs),
                               free_pages=self.free_pages)
        if not mine:
            return
        idx = np.array(mine, np.int64).T - self.cp_rank * ppr
        src, dst = torch.from_numpy(idx).to(self.device, non_blocking=True)
        # dim 1 is the page dim of codes (5-D) and scales (4-D) alike
        for a in kv_leaves(self.ks, self.vs):
            a[:, dst] = a[:, src]

    # -- host-side page transfer (disaggregated serving) -----------------
    def _check_pages(self, pages) -> None:
        for p in pages:
            if not 0 <= int(p) < self.num_pages:
                raise ValueError(f"page {p} out of range [0, "
                                 f"{self.num_pages})")

    def _local(self, pages) -> tuple:
        """(this rank's local indices of `pages`, whether it owns each):
        a page of another cp rank's slab maps to the local scratch page."""
        ids = torch.tensor([int(p) for p in pages], dtype=torch.long,
                           device=self.device)
        lo = self.cp_rank * self.pages_per_rank
        owned = (ids >= lo) & (ids < lo + self.pages_per_rank)
        return local_page_ids(ids, self.pages_per_rank, self.cp_rank), owned

    def export_pages(self, pages):
        """A host copy of `pages` (global ids, any order), for streaming to
        another pool: (k, v), each a CPU tensor of shape (layers,
        len(pages), kv_heads, page_size, head_dim) in the pool's dtype, or
        for int8 pools a (codes, scales) pair with scales (layers,
        len(pages), kv_heads, page_size) — the JAX `export_pages` payload,
        with the GLOBAL head count in JAX's order at any tp, each page from
        the cp slab that owns it. Pages stay leased: refcounts do not
        change.

        On one rank: one gather and one device-to-host copy per pool
        tensor. On a pool sharded over the ranks of `mesh` (tp, cp or cp x
        tp) it is a collective: every rank calls it with the same pages,
        each gathers its own heads of them (its scratch page for a page
        another slab owns), one all-gather per pool tensor over the mesh's
        'world' axis brings every rank's share to every rank (counted
        under `collectives.stats["kv_gather"]`), and rank 0 assembles and
        returns the payload; the other ranks return None."""
        self._check_pages(pages)
        local, _ = self._local(pages)
        parts = [t[:, local] for t in kv_leaves(self.ks, self.vs)]
        if self.world > 1:
            parts = [self._assemble(all_gather(x, self.mesh, "world",
                                               KV_GATHER), pages)
                     for x in parts]
            if not self.leader:
                return None
        out = [x.cpu() for x in parts]
        if self.kv_dtype:
            return (out[0], out[1]), (out[2], out[3])
        return out[0], out[1]

    def _assemble(self, g: torch.Tensor, pages) -> torch.Tensor:
        """Every rank's (layers, n, kv_heads / tp, ...) share of an export,
        stacked in rank order (rank r at tp r % tp, cp r // tp), as the
        payload: page i from the ranks of its owner's cp index, their heads
        concatenated in tp order."""
        tp, cp = self.tp, self.cp
        g = g.view((cp, tp) + tuple(g.shape[1:]))
        # (cp, tp, L, n, h, ...) -> (L, n, cp, tp, h, ...)
        g = g.permute((2, 3, 0, 1) + tuple(range(4, g.dim())))
        n = g.shape[1]
        owner = torch.tensor([int(p) // self.pages_per_rank for p in pages],
                             dtype=torch.long, device=g.device)
        g = g[:, torch.arange(n, device=g.device), owner]
        return g.reshape(g.shape[:2] + (tp * g.shape[3],)
                         + tuple(g.shape[4:]))

    def import_pages(self, k, v, owners=None, write=None) -> List[int]:
        """Lease one page per payload entry (refcount 1: the caller's page
        table row owns them) and write the payload of another pool's
        `export_pages` into them (`write_pages`, or the caller's `write`:
        the engine's dispatch, which runs it on every rank of its mesh);
        returns the page ids in payload order. Tensors or numpy arrays,
        cast to the pool's dtype, with the global head count whatever
        either side's tp. `owners[i]` names the slab page i comes from
        (cp = 1: slab 0). On PoolExhausted every page leased so far is
        returned before the raise, so no partial lease leaks. Refuses a
        payload of the other kind, another page_size or head_dim, and an
        `owners` of the wrong length, as JAX's does."""
        if self.kv_dtype:
            if not (isinstance(k, tuple) and isinstance(v, tuple)):
                raise ValueError("int8 pool import needs (codes, scales) "
                                 "payload tuples (export_pages on an int8 "
                                 "pool produces them)")
            head = k[0]
        else:
            if isinstance(k, tuple) or isinstance(v, tuple):
                raise ValueError("native pool cannot import an int8 "
                                 "(codes, scales) payload — kv_dtype must "
                                 "match across the transfer")
            head = k
        n, ps, hd = head.shape[1], head.shape[3], head.shape[4]
        if ps != self.page_size:
            raise ValueError(f"payload page_size {ps} != pool page_size "
                             f"{self.page_size} (pages are the transfer "
                             f"unit; both sides must agree)")
        want_hd = kv_leaves(self.ks, self.vs)[0].shape[4]
        if hd != want_hd:
            raise ValueError(f"payload head_dim {hd} != pool head_dim "
                             f"{want_hd} (different model shapes)")
        if owners is not None and len(owners) != n:
            raise ValueError(f"owners has {len(owners)} entries for {n} "
                             f"payload pages")
        pages: List[int] = []
        try:
            for i in range(n):
                pages.append(self.alloc(owners[i] if owners else 0))
        except PoolExhausted:
            for p in pages:
                self.unref(p)
            raise
        (write or self.write_pages)(pages, k, v)
        return pages

    def write_pages(self, pages, k=None, v=None) -> None:
        """Write an `export_pages` payload (global heads) into leased
        `pages`, one index-put per pool tensor. On a pool sharded over the
        ranks of `mesh` it is a collective: every rank passes the same
        pages, and rank 0's payload (the others' is not read) goes to every
        rank, one broadcast per pool tensor over the mesh's 'world' axis
        (counted under `collectives.stats["kv_scatter"]`); each rank writes
        its own heads of the pages its slab owns."""
        leaves = kv_leaves(self.ks, self.vs)
        src = kv_leaves(k, v) if self.leader else [None] * len(leaves)
        local, owned = self._local(pages)
        keep = local[owned]
        h = self.ks[0].shape[2] if self.kv_dtype else self.ks.shape[2]
        with torch.no_grad():
            for dst, x in zip(leaves, src):
                shape = (dst.shape[0], len(pages), h * self.tp) + tuple(
                    dst.shape[3:])
                if x is None:
                    x = torch.empty(shape, dtype=dst.dtype,
                                    device=self.device)
                else:
                    x = torch.as_tensor(x).to(self.device, dst.dtype)
                if self.world > 1:
                    x = broadcast(x.contiguous(), self.mesh, "world",
                                  KV_SCATTER)
                x = x[:, :, self.tp_rank * h:(self.tp_rank + 1) * h]
                # dim 1 is the page dim of codes (5-D) and scales (4-D)
                dst[:, keep] = x[:, owned]
