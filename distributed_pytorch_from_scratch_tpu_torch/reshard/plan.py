"""The redistribution pass: any-layout → any-layout reshard plans, the port
of the JAX `reshard/plan.py`, on host numpy only.

For each leaf (a checkpoint flat key, `param/...`, `mu/...` or `nu/...`,
with its GLOBAL shape) two facts are planned from the (source, target)
`Layout` pair:

* **File fragments**: the interval intersections of the source and target
  rank files' blocks, in each file's local coordinates. A rank file slices
  a leaf only on its tp dim and holds it whole otherwise (dp, pp, cp, ep
  and ZeRO never slice a file), so the fragments cross the source's tp
  blocking with the target's, possibly on different dims. Every fragment
  reads one source member and writes one target slice, the unit the
  streamed executor (`apply.py`) moves.
* **Device op**: what the live mesh does for the leaf, from the EFFECTIVE
  specs (the canonical spec, plus the ZeRO stage's dp dim by
  `layout.spec_zero_dim`, the rule the optimizer shards by):
  ``copy`` (the same partitioning), ``gather`` (the target strictly
  coarser: dp or pp dropped, tp 4 → 2), ``slice`` (strictly finer: local,
  no wire) or ``permute`` (mixed or moved dims).

`bytes_moved` counts the fragment bytes that change file (rank or extent):
a change of the ZeRO stage, dp or pp alone moves 0 bytes (the files are
already the same), any tp change moves every byte of every file written.

A layout that cannot be expressed is refused with `ReshardError`: a dim
that does not divide, or a key the source layout has no spec for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .layout import Layout, Spec, spec_tp_dim, spec_zero_dim

Interval = Tuple[int, int]                  # [start, stop)
SliceMap = Dict[int, Interval]              # dim -> interval (absent: whole)


class ReshardError(ValueError):
    """A layout the planner cannot express, refused: never a silent
    fallback to a wrong (or whole-tree) schedule."""


@dataclasses.dataclass(frozen=True)
class Fragment:
    src_rank: int
    src_slice: Tuple[Tuple[int, Interval], ...]   # local coords, sparse
    dst_slice: Tuple[Tuple[int, Interval], ...]
    nbytes: int


@dataclasses.dataclass
class LeafPlan:
    key: str
    shape: Tuple[int, ...]
    itemsize: int
    op: str                               # copy | gather | slice | permute
    moved_bytes: int
    fragments: Dict[int, List[Fragment]]  # dst_rank -> fragments

    @property
    def nbytes(self) -> int:
        n = self.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class ReshardPlan:
    src: Layout
    dst: Layout
    leaves: Dict[str, LeafPlan]

    def summary(self) -> dict:
        ops: Dict[str, int] = {}
        moved = 0
        max_leaf = 0
        for lp in self.leaves.values():
            ops[lp.op] = ops.get(lp.op, 0) + 1
            moved += lp.moved_bytes
            max_leaf = max(max_leaf, lp.nbytes)
        return {"src": self.src.describe(), "dst": self.dst.describe(),
                "ops": ops, "bytes_moved": moved,
                "n_leaves": len(self.leaves),
                "max_leaf_bytes": max_leaf}


def _subtree_start(key: str) -> int:
    """Leaves under the layers subtree keep their stacked layer dim (dim
    0) whole at stage 3 (JAX's `zero3_dims` rule)."""
    parts = key.split("/")
    return 1 if len(parts) > 1 and parts[1] == "layers" else 0


def effective_spec(layout: Layout, key: str, shape: Tuple[int, ...]) -> Spec:
    """The canonical spec plus the ZeRO stage's dp dim for one flat key:
    the params take it at stage 3 (the layers past their stacked dim), the
    moments from stage 1 (stages 1 and 2 from dim 0, stage 3 as the
    params)."""
    spec = layout.spec_for(key)
    dp, stage = layout.dp, layout.zero_stage
    kind = key.split("/", 1)[0]
    if dp == 1:
        return spec
    if kind == "param":
        if stage < 3:
            return spec
        start = _subtree_start(key)
    else:                                   # mu / nu
        if stage < 1:
            return spec
        start = _subtree_start(key) if stage >= 3 else 0
    dim = spec_zero_dim(spec, shape, dp, start=start)
    if dim < 0:
        return spec
    full = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return full[:dim] + ("dp",) + full[dim + 1:]


def _partitions(layout: Layout, spec: Spec, shape: Tuple[int, ...],
                key: str) -> Dict[int, int]:
    """dim -> the number of blocks the spec cuts it into on this layout's
    mesh (absent axes count 1; dims cut into 1 dropped)."""
    out: Dict[int, int] = {}
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= layout.axis_size(a)
        if n <= 1:
            continue
        if dim >= len(shape) or shape[dim] % n != 0:
            raise ReshardError(
                f"layout {layout.describe()} shards {key} dim {dim} "
                f"{n}-way but its size is "
                f"{shape[dim] if dim < len(shape) else '<missing>'} — "
                f"not evenly divisible; this layout is inexpressible "
                f"for the leaf")
        out[dim] = n
    return out


def _leaf_op(src_parts: Dict[int, int], dst_parts: Dict[int, int]) -> str:
    if src_parts == dst_parts:
        return "copy"
    coarser = finer = moved = False
    for d in set(src_parts) | set(dst_parts):
        s, t = src_parts.get(d, 1), dst_parts.get(d, 1)
        if s == t:
            continue
        if s > t and s % t == 0:
            coarser = True
        elif t > s and t % s == 0:
            finer = True
        else:
            moved = True
    if moved or (coarser and finer):
        return "permute"
    return "gather" if coarser else "slice"


def _overlap(a: Interval, b: Interval) -> Optional[Interval]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _block(n: int, parts: int, rank: int) -> Interval:
    w = n // parts
    return (rank * w, (rank + 1) * w)


def _frag_bytes(shape, itemsize: int, region: SliceMap) -> int:
    n = itemsize
    for d, size in enumerate(shape):
        lo, hi = region.get(d, (0, size))
        n *= hi - lo
    return n


def _sorted(region: SliceMap) -> Tuple[Tuple[int, Interval], ...]:
    return tuple(sorted(region.items()))


def file_fragments(shape: Tuple[int, ...], itemsize: int, src_spec: Spec,
                   src_tp: int, dst_spec: Spec,
                   dst_tp: int) -> Dict[int, List[Fragment]]:
    """dst_rank -> its fragments, by the files' rule: a rank file slices a
    leaf on its tp dim only. Local coordinates at both ends."""
    sdim = spec_tp_dim(src_spec) if src_tp > 1 else None
    ddim = spec_tp_dim(dst_spec) if dst_tp > 1 else None
    out: Dict[int, List[Fragment]] = {}
    for q in range(dst_tp):
        frags: List[Fragment] = []
        dblk = _block(shape[ddim], dst_tp, q) if ddim is not None else None
        if sdim is None:
            # a replicated (or tp 1) source: rank 0 holds the whole leaf
            region: SliceMap = {} if ddim is None else {ddim: dblk}
            dst_local = {} if ddim is None else {ddim: (0, dblk[1] - dblk[0])}
            frags.append(Fragment(0, _sorted(region), _sorted(dst_local),
                                  _frag_bytes(shape, itemsize, region)))
        else:
            for r in range(src_tp):
                sblk = _block(shape[sdim], src_tp, r)
                if ddim is None:
                    region = {sdim: sblk}
                    src_local = {sdim: (0, sblk[1] - sblk[0])}
                    dst_local = {sdim: sblk}
                elif ddim == sdim:
                    ov = _overlap(sblk, dblk)
                    if ov is None:
                        continue
                    region = {sdim: ov}
                    src_local = {sdim: (ov[0] - sblk[0], ov[1] - sblk[0])}
                    dst_local = {ddim: (ov[0] - dblk[0], ov[1] - dblk[0])}
                else:
                    region = {sdim: sblk, ddim: dblk}
                    src_local = {sdim: (0, sblk[1] - sblk[0]), ddim: dblk}
                    dst_local = {sdim: sblk, ddim: (0, dblk[1] - dblk[0])}
                frags.append(Fragment(r, _sorted(src_local),
                                      _sorted(dst_local),
                                      _frag_bytes(shape, itemsize, region)))
        out[q] = frags
    return out


def plan_reshard(keys: List[str], shapes: Dict[str, Tuple[int, ...]],
                 itemsizes: Dict[str, int], src: Layout,
                 dst: Layout) -> ReshardPlan:
    """Every leaf's fragments and device op for a src → dst reshard.
    `keys` are checkpoint flat keys, `shapes` their GLOBAL shapes. Refuses
    (ReshardError) a target it cannot express, or a key the source layout
    has no spec for."""
    missing = [k for k in keys
               if "param/" + k.partition("/")[2] not in src.specs
               and k not in src.specs]
    if missing:
        raise ReshardError(
            f"source layout has no spec for {len(missing)} checkpoint "
            f"key(s), e.g. {missing[:3]} — the checkpoint and the spec "
            f"tree disagree (wrong --model preset for a legacy source?)")
    leaves: Dict[str, LeafPlan] = {}
    for key in keys:
        shape = tuple(shapes[key])
        item = int(itemsizes[key])
        s_parts = _partitions(src, effective_spec(src, key, shape), shape,
                              key)
        d_parts = _partitions(dst, effective_spec(dst, key, shape), shape,
                              key)
        frags = file_fragments(shape, item, src.spec_for(key), src.tp,
                               dst.spec_for(key), dst.tp)
        moved = 0 if src.tp == dst.tp else sum(
            f.nbytes for fl in frags.values() for f in fl)
        leaves[key] = LeafPlan(key=key, shape=shape, itemsize=item,
                               op=_leaf_op(s_parts, d_parts),
                               moved_bytes=moved, fragments=frags)
    return ReshardPlan(src=src, dst=dst, leaves=leaves)
