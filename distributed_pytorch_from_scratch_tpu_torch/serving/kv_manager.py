"""KV-cache pools: the slot-granular `KVCachePool` of the continuous-
batching engine and the page pool `PagedKVPool` of the paged engine
(counterparts of both in the JAX `serving/kv_manager.py`, at tp=cp=1).

One device tensor per K/V with a `slots` axis,

    (num_layers, num_slots + 1, kv_heads, buf_len, head_dim)

in the compute dtype. `alloc()` leases a free slot to a request; prefill
writes the prompt's K/V into that slot's rows; every decode step advances
all slots; `free()` returns the slot. The LAST slot (index `num_slots`) is
a scratch row that is never leased: prefill batches padded up to a bucket
size aim their pad rows at it, so pad work lands somewhere harmless.

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


def kv_token_bytes(cfg, kv_dtype=None) -> int:
    """K+V cache bytes per TOKEN POSITION at a model shape (all layers, all
    kv heads, K and V). An int8 pool pays one code per element plus the f32
    scale of each stored head-vector."""
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
        shape = (cfg.num_layers, num_slots + 1, cfg.kv_heads, buf_len,
                 cfg.head_dim)
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

        (num_layers, num_pages + 1, kv_heads, page_size, head_dim)

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

    The pool tensors are written in place by the decode lowerings, which
    takes the place of the JAX engine's buffer donation. Exporting and
    importing pages (disaggregated serving) and the cp-sharded layout are
    not ported (ROADMAP)."""

    def __init__(self, model, mesh, num_pages: int, page_size: int,
                 kv_dtype=None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in (None, "native", "int8"):
            raise ValueError(f"kv_dtype must be None/'native'/'int8', got "
                             f"{kv_dtype!r}")
        cfg = model.cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.scratch_page = num_pages          # never leased; pad target
        self.kv_dtype = "int8" if kv_dtype == "int8" else None
        shape = (cfg.num_layers, num_pages + 1, cfg.kv_heads, page_size,
                 cfg.head_dim)
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
        self._free = deque(range(num_pages))
        self.refcount = np.zeros(num_pages, np.int32)
        self._children = {}     # chain_key -> [(page_id, tokens_tuple)]
        self._page_keys = {}    # page_id -> parent chain_key (for dereg)
        self.cow_copies = 0

    # -- page leasing -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"page pool exhausted ({self.num_pages} pages fully leased) "
                f"— the engine preempts or the scheduler gates admission")
        page = self._free.popleft()
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
            self._free.append(page)

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
        gather + scatter per pool tensor. (The JAX pool pads the pairs to a
        power of two to bound its recompiles; eager torch has none.)"""
        if not pairs:
            return
        idx = np.array(pairs, np.int64).T
        src, dst = torch.from_numpy(idx).to(self.device, non_blocking=True)
        for pool in (self.ks, self.vs):
            # dim 1 is the page dim of codes (5-D) and scales (4-D) alike
            for a in (pool if isinstance(pool, tuple) else (pool,)):
                a[:, dst] = a[:, src]
        self.cow_copies += len(pairs)
