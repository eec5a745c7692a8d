"""The reshard executors — the port of the JAX `reshard/apply.py`'s streamed
host paths.

Every path here moves ONE leaf at a time through one host buffer, never a
whole tree (`load_checkpoint`'s `np.load` of every member). An npz file is
a zip of `key.npy` members, so a member's header (shape, dtype) reads
without its payload, and its C-order payload streams straight into its
block of a preallocated global leaf (`_stream_member_into`: the block
along one dim of a C-contiguous buffer is one contiguous byte run per
leading index). The staging peak is therefore one global leaf, as
`HostMeter` meters it (the tests hold it to the largest leaf).

* `reshard_checkpoint`: file → file. A rank-file set at layout A becomes a
  `validate_checkpoint`-clean set at layout B, stamped with B (the
  offline CLI, `reshard/reshard_ckpt.py`).
* `stream_load`: file → this rank. Each global leaf is cut to this rank's
  part (its pp stage's layers, its tp slice, its ep rank's experts) and
  moved to its device, then freed: the elastic `train --resume`.
* `plan_checkpoint`: the plan alone, from the members' headers.

A reference `.pth` rank span (torch pickles) cannot stream: it is bridged
through `interop.load_reference_checkpoint`, with a loud note, and is
exempt from the one-leaf bound (the meter still records what it cost), as
in JAX. Moving live trees between meshes (`reshard_params`, the fleet's
replica restarts at a new tp) waits for the fleet at tp > 1 (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

import os
import re
import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import padded_vocab_size
from ..parallel.layout import VOCAB_KEYS, is_expert, tp_dim
from .layout import (LAYOUT_KEY, Layout, resolve_source_layout, spec_tp_dim,
                     stamp, transposed)
from .plan import ReshardError, ReshardPlan, plan_reshard


class HostMeter:
    """Live and peak bytes of the host staging buffers these paths
    allocate (the global leaves read, a Fortran-order member), so the
    tests can hold the streamed paths to their bound (peak ≤ the largest
    leaf). An account, as JAX's meter is, not the process's resident
    memory: the vocab leaves' tp pad in `_rank_leaves` is not counted."""

    def __init__(self):
        self.live = 0
        self.peak = 0

    def alloc(self, nbytes: int) -> int:
        self.live += int(nbytes)
        self.peak = max(self.peak, self.live)
        return int(nbytes)

    def free(self, nbytes: int) -> None:
        self.live -= int(nbytes)


def _read_header(f) -> Tuple[Tuple[int, ...], bool, np.dtype]:
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(f)
    return np.lib.format.read_array_header_2_0(f)


def member_headers(path: str) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """{key: (shape, dtype)} of every array of one npz file, from the
    `.npy` headers: no payload reaches the host."""
    out: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if not name.endswith(".npy"):
                continue
            with zf.open(name) as f:
                shape, _, dtype = _read_header(f)
            out[name[:-4]] = (tuple(shape), np.dtype(dtype))
    return out


def _readinto_exact(f, view) -> None:
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise ReshardError(
                f"npz member truncated: expected {len(view)} bytes, "
                f"got {got}")
        got += n


def _stream_member_into(zf: zipfile.ZipFile, key: str, out: np.ndarray,
                        dim: Optional[int], block: Tuple[int, int],
                        meter: Optional[HostMeter] = None) -> None:
    """One member's payload into `out[block along dim]` (all of `out` at
    dim None), without materialising the member."""
    with zf.open(key + ".npy") as f:
        shape, fortran, dtype = _read_header(f)
        expect = list(out.shape)
        if dim is not None:
            expect[dim] = block[1] - block[0]
        if tuple(shape) != tuple(expect) or np.dtype(dtype) != out.dtype:
            raise ReshardError(
                f"shard member {key!r} is {shape}/{np.dtype(dtype)}; the "
                f"plan expects {tuple(expect)}/{out.dtype} — shard files "
                f"disagree with their stamped layout")
        if fortran:
            # np.savez never writes one; survive it anyway, at the cost of
            # materialising this one member
            with zf.open(key + ".npy") as f2:
                arr = np.lib.format.read_array(f2, allow_pickle=False)
            if meter is not None:
                meter.alloc(arr.nbytes)
            sl = [slice(None)] * out.ndim
            if dim is not None:
                sl[dim] = slice(*block)
            out[tuple(sl)] = arr
            if meter is not None:
                meter.free(arr.nbytes)
            return
        mv = memoryview(out).cast("B")
        if dim is None:
            _readinto_exact(f, mv)
            return
        item = out.dtype.itemsize
        trail = int(np.prod(out.shape[dim + 1:], dtype=np.int64))
        lead = int(np.prod(out.shape[:dim], dtype=np.int64))
        run = (block[1] - block[0]) * trail * item
        stride = out.shape[dim] * trail * item
        off0 = block[0] * trail * item
        for b in range(lead):
            _readinto_exact(f, mv[b * stride + off0:
                                  b * stride + off0 + run])


class _NpzStreamWriter:
    """One destination rank file, written member by member (np.savez's zip
    of STORED `key.npy` members), published by an atomic rename."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = path + ".tmp"
        self.zf = zipfile.ZipFile(self.tmp, "w", zipfile.ZIP_STORED)

    def write(self, key: str, arr: np.ndarray) -> None:
        with self.zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(arr),
                                      allow_pickle=False)

    def close(self) -> None:
        self.zf.close()
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        self.zf.close()
        if os.path.exists(self.tmp):
            os.remove(self.tmp)


class _NpzSource:
    """A stamped or legacy npz rank-file set, indexed for leaf streaming."""

    def __init__(self, rank_files: Dict[int, str], layout: Layout):
        self.layout = layout
        self.tp = layout.tp
        self.zfs = {r: zipfile.ZipFile(rank_files[r])
                    for r in sorted(rank_files)}
        hdrs = member_headers(rank_files[min(rank_files)])
        self.meta = {k: v for k, v in hdrs.items() if k.startswith("__")}
        self.keys = sorted(k for k in hdrs if not k.startswith("__"))
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.dtypes: Dict[str, np.dtype] = {}
        for k in self.keys:
            shape, dtype = hdrs[k]
            sdim = self._sdim(k)
            g = list(shape)
            if sdim is not None:
                g[sdim] *= self.tp
            self.shapes[k] = tuple(g)
            self.dtypes[k] = dtype

    def _sdim(self, key: str) -> Optional[int]:
        return spec_tp_dim(self.layout.spec_for(key)) if self.tp > 1 else None

    def read_global(self, key: str,
                    meter: Optional[HostMeter] = None) -> np.ndarray:
        """ONE global leaf, streamed member by member into one buffer."""
        out = np.empty(self.shapes[key], self.dtypes[key])
        if meter is not None:
            meter.alloc(out.nbytes)
        sdim = self._sdim(key)
        if sdim is None:
            _stream_member_into(self.zfs[min(self.zfs)], key, out, None,
                                (0, 0), meter)
        else:
            n = out.shape[sdim] // self.tp
            for r, zf in self.zfs.items():
                _stream_member_into(zf, key, out, sdim,
                                    (r * n, (r + 1) * n), meter)
        return out

    def metadata(self) -> Dict[str, np.ndarray]:
        zf0 = self.zfs[min(self.zfs)]
        out = {}
        for k in self.meta:
            if k == LAYOUT_KEY:
                continue
            with zf0.open(k + ".npy") as f:
                out[k] = np.lib.format.read_array(f, allow_pickle=False)
        return out

    def close(self) -> None:
        for zf in self.zfs.values():
            zf.close()


class _TreeSource:
    """A flat global tree in memory, posing as a source (the `.pth`
    bridge)."""

    def __init__(self, flat: Dict[str, np.ndarray], layout: Layout,
                 meta: Optional[Dict[str, np.ndarray]] = None):
        self.layout = layout
        self.flat = flat
        self.keys = sorted(flat)
        self.shapes = {k: tuple(v.shape) for k, v in flat.items()}
        self.dtypes = {k: v.dtype for k, v in flat.items()}
        self.meta = dict(meta or {})

    def read_global(self, key: str,
                    meter: Optional[HostMeter] = None) -> np.ndarray:
        arr = self.flat[key]
        if meter is not None:
            meter.alloc(arr.nbytes)
        return arr

    def metadata(self) -> Dict[str, np.ndarray]:
        return dict(self.meta)

    def close(self) -> None:
        pass


def _parse_loss(rank_files: Dict[int, str]) -> str:
    m = re.search(r"_loss-(.+?)\.(npz|pth)$",
                  os.path.basename(rank_files[min(rank_files)]))
    return m.group(1) if m else "0.0000"


def _open_source(ckpt_dir: str, step: int, specs=None, ext: str = "npz",
                 cfg=None, echo=print):
    """(source, source layout, is_legacy, loss text) of any format on
    disk."""
    # imported here: training/checkpoint imports this package's layout
    from ..training.checkpoint import _flatten, validate_checkpoint
    src_layout, legacy = resolve_source_layout(ckpt_dir, step, specs=specs,
                                               ext=ext, echo=echo)
    _, rank_files = validate_checkpoint(ckpt_dir, step, ext=ext)
    loss = _parse_loss(rank_files)
    if ext == "npz":
        return _NpzSource(rank_files, src_layout), src_layout, legacy, loss
    if ext == "pth":
        if cfg is None:
            raise ValueError("a legacy .pth span needs the model config "
                             "(CLI: --model) to rebuild the tree")
        echo(f"note: legacy .pth span at {ckpt_dir} iter {step} — torch "
             f"pickles are not streamable; bridging through interop "
             f"(host cost: the param tree, once)")
        from ..interop import load_reference_checkpoint
        tree = load_reference_checkpoint(ckpt_dir, step, cfg,
                                         pad_vocab_multiple=max(
                                             1, src_layout.tp))
        return (_TreeSource(_flatten(tree, "param"), src_layout),
                src_layout, legacy, loss)
    raise ValueError(f"unknown checkpoint extension {ext!r}")


def _plan(source, src_layout: Layout, dst_layout: Layout) -> ReshardPlan:
    return plan_reshard(source.keys, source.shapes,
                        {k: d.itemsize for k, d in source.dtypes.items()},
                        src_layout, dst_layout)


def plan_checkpoint(ckpt_dir: str, step: int, dst_layout: Layout,
                    specs=None, ext: str = "npz", cfg=None,
                    echo=print) -> Tuple[ReshardPlan, Layout, bool]:
    """The plan alone of a reshard of a checkpoint on disk: (plan, source
    layout, is_legacy). An npz is read by its headers; the .pth bridge
    loads."""
    source, src_layout, legacy, _ = _open_source(ckpt_dir, step, specs=specs,
                                                 ext=ext, cfg=cfg, echo=echo)
    try:
        plan = _plan(source, src_layout, dst_layout)
    finally:
        source.close()
    return plan, src_layout, legacy


def reshard_checkpoint(src_dir: str, step: int, dst_dir: str,
                       dst_layout: Layout, specs=None, ext: str = "npz",
                       cfg=None, meter: Optional[HostMeter] = None,
                       echo=print) -> Tuple[List[str], ReshardPlan, dict]:
    """A rank-file set at layout A → a new set at layout B, one leaf at a
    time: (paths, plan, info), `info` the reshard_event payload (source and
    target layouts, bytes moved, op counts, wall ms, peak host bytes)."""
    t0 = time.perf_counter()
    meter = meter if meter is not None else HostMeter()
    source, src_layout, legacy, loss = _open_source(
        src_dir, step, specs=specs, ext=ext, cfg=cfg, echo=echo)
    try:
        plan = _plan(source, src_layout, dst_layout)
        os.makedirs(dst_dir, exist_ok=True)
        tp = dst_layout.tp
        writers = [_NpzStreamWriter(os.path.join(
            dst_dir, f"tprank-{q}_iter-{step}_loss-{loss}.npz"))
            for q in range(tp)]
        try:
            for key in source.keys:
                leaf = source.read_global(key, meter)
                ddim = spec_tp_dim(dst_layout.spec_for(key)) if tp > 1 \
                    else None
                for q, w in enumerate(writers):
                    if ddim is None:
                        w.write(key, leaf)
                    else:
                        n = leaf.shape[ddim] // tp
                        sl = [slice(None)] * leaf.ndim
                        sl[ddim] = slice(q * n, (q + 1) * n)
                        w.write(key, leaf[tuple(sl)])
                meter.free(leaf.nbytes)
                del leaf
            meta = source.metadata()
            meta["__step__"] = np.asarray(step, np.int64)
            meta["__tp_size__"] = np.asarray(tp, np.int64)
            meta.setdefault("__has_opt__", np.asarray(
                any(k.startswith("mu/") for k in source.keys)))
            meta["__zero_stage__"] = np.asarray(dst_layout.zero_stage,
                                                np.int64)
            stamp(meta, dst_layout)
            for w in writers:
                for k, v in meta.items():
                    w.write(k, v)
                w.close()
        except BaseException:
            for w in writers:
                w.abort()
            raise
    finally:
        source.close()
    info = dict(plan.summary(), legacy=bool(legacy),
                wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                peak_host_bytes=meter.peak)
    return [w.path for w in writers], plan, info


def _rank_leaves(key: str, leaf: np.ndarray, model
                 ) -> Dict[str, torch.Tensor]:
    """One global flat leaf (`param/...` or a moment's) -> this rank's
    state-dict entries of it, as host views: its stage's layers (under
    their ModuleList positions), in torch's layout, cut to its tp slice
    (the vocab leaves padded to its tp first) and its ep rank's
    experts."""
    parts = key.split("/")[1:]
    if parts[0] == "layers":
        name, rest = parts[1], ".".join(parts[2:])
        pairs = [(f"layers.{i}.{name}.{rest}", leaf[c])
                 for i, c in enumerate(model.layer_ids)]
    else:
        pairs = [(".".join(parts), leaf)]
    mesh = model.mesh
    out = {}
    for tkey, arr in pairs:
        x = torch.from_numpy(np.ascontiguousarray(arr))
        if transposed(tkey):
            x = x.T
        if tkey in VOCAB_KEYS and model.tp_size > 1:
            rows = padded_vocab_size(x.shape[0], model.tp_size)
            if rows > x.shape[0]:
                x = torch.cat([x, x.new_zeros((rows - x.shape[0],)
                                              + tuple(x.shape[1:]))])
        if model.ep_size > 1 and is_expert(tkey):
            x = x.chunk(model.ep_size, 0)[mesh.ep_rank]
        dim = tp_dim(tkey)
        if dim is not None and model.tp_size > 1:
            x = x.chunk(model.tp_size, dim)[mesh.tp_rank]
        out[tkey] = x
    return out


def stream_load(ckpt_dir: str, step: int, model, dst_layout: Layout,
                with_opt: bool = False, specs=None, ext: str = "npz",
                cfg=None, meter: Optional[HostMeter] = None, echo=print):
    """A checkpoint saved at ANY layout, loaded onto this rank one leaf at
    a time: a global leaf is streamed together on the host, cut to this
    rank's part of `model` (`_rank_leaves`) and copied to the model's
    device, then freed. Returns (state_dict, AdamState or None, step,
    info); the moments are whole leaves (a ZeRO plan shards them after),
    and only with `with_opt` and where the files hold them."""
    from ..training.optim import AdamState

    t0 = time.perf_counter()
    meter = meter if meter is not None else HostMeter()
    device = next(model.parameters()).device
    own = model.state_dict()
    source, src_layout, legacy, _ = _open_source(
        ckpt_dir, step, specs=specs, ext=ext, cfg=cfg, echo=echo)
    try:
        plan = _plan(source, src_layout, dst_layout)
        trees: Dict[str, Dict[str, torch.Tensor]] = {"param": {}, "mu": {},
                                                     "nu": {}}
        for key in source.keys:
            kind = key.split("/", 1)[0]
            if kind != "param" and not with_opt:
                continue
            leaf = source.read_global(key, meter)
            for tkey, x in _rank_leaves(key, leaf, model).items():
                if tkey not in own or own[tkey].shape != x.shape:
                    raise ReshardError(
                        f"checkpoint leaf {key} gives {tkey} "
                        f"{tuple(x.shape)} here, the model holds "
                        f"{tuple(own[tkey].shape) if tkey in own else None}")
                trees[kind][tkey] = x.to(device, copy=True)
            meter.free(leaf.nbytes)
            del leaf
        meta = source.metadata()
        step_loaded = int(meta.get("__step__", np.asarray(step)))
        opt_state = None
        if with_opt and bool(meta.get("__has_opt__", np.asarray(False))):
            opt_state = AdamState(step=step_loaded, mu=trees["mu"],
                                  nu=trees["nu"])
    finally:
        source.close()
    info = dict(plan.summary(), legacy=bool(legacy),
                wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                peak_host_bytes=meter.peak)
    return trees["param"], opt_state, step_loaded, info
