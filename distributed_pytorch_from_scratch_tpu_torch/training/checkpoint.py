"""Checkpoints in the JAX package's per-rank npz format, read and written.

The files are `tprank-{r}_iter-{n}_loss-{avg:.4f}.npz`, one per tp rank,
each holding flattened `param/<path>` (and `mu/`, `nu/` Adam moment)
leaves in the JAX tree layout — rank r's slice of every leaf on the dim its
JAX spec marks as 'tp', the moments sliced like their params — plus
`__step__`, `__tp_size__`, `__has_opt__`, `__zero_stage__` and the
`__layout__` stamp (`reshard/layout.py`: the mesh axes and every leaf's
spec, the string the JAX trainer writes for the same mesh and family):
the format of the JAX `training/checkpoint.py`, so either package resumes
or serves the other's files. `save_checkpoint` writes one rank's file from
that rank's shard; `load_checkpoint` reads every rank file, assembles the
global arrays and cuts the running rank's slice, so a file written at one
tp loads at another (the vocab leaves are padded to a multiple of the
writing tp: they must divide by the reading tp too); the trainer and the
serving CLI both load this way. Parameters are replicated over dp and cp,
so the ranks at dp = cp = 0 write, one file per tp rank, and every rank
reads. Under ZeRO the moments (and at stage 3 the params) are dp-sharded
on the ranks, but the files hold them whole, as JAX's do: every dp rank
gathers before a save, and a load is cut to this rank's dp shard by the
trainer (`training/zero.py`), so a checkpoint written at any stage
resumes at any other.

A pipeline stage holds its own layers, but the files hold them all, in the
canonical order (JAX's `to_canonical`): before a save at pp > 1 every rank
gathers the layers over its pp group (`gather_stages`) and the ranks at dp
= pp = cp = ep = 0 write; the stage cuts its own layers from a load
(`models/pipeline.from_canonical`).

A MoE model's experts are sharded over ep as well, but the files keep
JAX's tp-only format: each `tprank-*` file holds all E experts, sliced on
the tp dim. Before a save at ep > 1 every rank gathers the experts over
its ep group (`gather_experts`) and the ranks at dp = cp = ep = 0 write;
a load cuts this rank's E/ep experts (`load_checkpoint(..., ep_size,
ep_rank)`), so a file written at one ep loads at any ep that divides E.

`save_checkpoint(..., async_write=True)` returns an `AsyncSaveHandle`: the
state is snapshotted on the device at the call (one clone of the params
and both moments, enqueued on the current stream before any later step can
update them in place), and a writer thread copies the snapshot to the host
on a side stream, writes the file, publishes it and prunes; `join()` waits
for it and returns the paths.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import params_from_jax, params_to_jax
from ..ops.collectives import all_gather
from ..parallel.layout import assemble_params, is_expert, shard_params
from ..models.pipeline import stage_layer_ids
from ..reshard.layout import (MESH_AXES, Layout, canonical_specs,
                              make_layout, read_stamp, stamp)
from .optim import AdamState

CKPT_RE = re.compile(r"tprank-(\d+)_iter-(\d+)_loss-(.+?)\.npz$")


def list_checkpoints(save_dir: str, rank: int = 0) -> List[Tuple[int, str]]:
    """(iter, path) pairs for one rank, sorted by iter."""
    out = []
    for p in glob.glob(os.path.join(save_dir, f"tprank-{rank}_iter-*_loss-*.npz")):
        m = CKPT_RE.search(os.path.basename(p))
        if m:
            out.append((int(m.group(2)), p))
    return sorted(out)


def latest_step(save_dir: str) -> Optional[int]:
    ckpts = list_checkpoints(save_dir, rank=0)
    return ckpts[-1][0] if ckpts else None


def find_rank_shards(ckpt_dir: str, step: int,
                     ext: str = "npz") -> Dict[int, str]:
    """{rank: path} for the `tprank-{r}_iter-{step}_loss-*.{ext}` files."""
    pat = re.compile(rf"tprank-(\d+)_iter-(\d+)_loss-(.+?)\.{ext}$")
    rank_files: Dict[int, str] = {}
    for p in glob.glob(os.path.join(ckpt_dir,
                                    f"tprank-*_iter-{step}_loss-*.{ext}")):
        m = pat.search(os.path.basename(p))
        if m and int(m.group(2)) == step:
            rank_files[int(m.group(1))] = p
    return rank_files


def validate_checkpoint(ckpt_dir: str, step: int, ext: str = "npz"
                        ) -> Tuple[int, Dict[int, str]]:
    """(tp_size, {rank: path}) of iteration `step` when every rank file is
    there (the JAX function): the rank count from `__tp_size__` (an npz
    file's), else the highest rank + 1; a missing rank file is refused by
    name."""
    rank_files = find_rank_shards(ckpt_dir, step, ext=ext)
    if not rank_files:
        raise FileNotFoundError(f"no checkpoint for iter {step} in {ckpt_dir}")
    tp_size = None
    if ext == "npz":
        with np.load(rank_files[min(rank_files)]) as shard:
            if "__tp_size__" in shard.files:
                tp_size = int(shard["__tp_size__"])
    if tp_size is None:
        tp_size = max(rank_files) + 1
    missing = sorted(set(range(tp_size)) - set(rank_files))
    if missing:
        raise FileNotFoundError(
            f"checkpoint iter {step} was written with tp_size={tp_size} but "
            f"shard files for rank(s) {missing} are missing from {ckpt_dir} "
            f"— restore the missing rank file(s) or re-save the checkpoint")
    return tp_size, rank_files


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """`{prefix}/a/b/c` keys -> nested dicts {a: {b: {c: array}}}."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _read_rank_files(ckpt_dir: str, step: int
                     ) -> Tuple[int, List[Dict[str, np.ndarray]]]:
    """(tp_size, every rank file's members in rank order) of iteration
    `step`; a missing rank file is refused by name (the JAX
    `validate_checkpoint`)."""
    tp_size, rank_files = validate_checkpoint(ckpt_dir, step)
    files = []
    for r in range(tp_size):
        with np.load(rank_files[r]) as shard:
            files.append({k: shard[k] for k in shard.files})
    check_layout(read_stamp(files[0]), ckpt_dir, step)
    return tp_size, files


# the mesh axes the port runs: all five of the JAX mesh's
PORTED_AXES = MESH_AXES


def check_layout(layout: Optional[Layout], ckpt_dir: str, step: int) -> None:
    """Refuse a stamped layout whose mesh has an axis the port does not run;
    an unstamped file (None) passes, read as before the stamp."""
    if layout is None:
        return
    other = [a for a, _ in layout.mesh_axes if a not in PORTED_AXES]
    if other:
        raise ValueError(
            f"checkpoint iter {step} in {ckpt_dir} was written on a "
            f"{layout.describe()} mesh; the port runs the axes "
            f"{PORTED_AXES} only")


def _assemble(files: List[Dict[str, np.ndarray]], prefix: str,
              tp_size: int, tp_rank: int, ep_size: int = 1,
              ep_rank: int = 0) -> Dict[str, torch.Tensor]:
    """The `prefix` tree of every rank file, assembled on the tp dims into
    the global state dict, then sliced for rank (tp_rank of tp_size,
    ep_rank of ep_size)."""
    full = assemble_params([params_from_jax(_unflatten(f, prefix))
                            for f in files])
    rows = full["embedding.weight"].shape[0]
    if rows % tp_size:
        raise ValueError(
            f"the checkpoint's vocab leaves hold {rows} rows (padded for "
            f"tp={len(files)}), which do not shard over tp={tp_size}; "
            f"resume at a tp that divides {rows}")
    return shard_params(full, tp_size, tp_rank, ep_size, ep_rank)


def load_checkpoint(ckpt_dir: str, step: int, with_opt: bool = False,
                    tp_size: int = 1, tp_rank: int = 0, ep_size: int = 1,
                    ep_rank: int = 0
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[AdamState],
                               int]:
    """(state_dict, AdamState or None, step) of iteration `step`, for rank
    (tp_rank of tp_size, ep_rank of ep_size): every rank file is read and
    assembled into the global arrays (the JAX `load_checkpoint`), then
    this rank's slice is cut (its tp slice, and its E/ep experts), so a
    checkpoint written at any tp loads at any tp its vocab rows divide.
    The moments only with `with_opt` and when the files hold them."""
    _, files = _read_rank_files(ckpt_dir, step)
    saved_step = int(files[0]["__step__"])
    cut = (tp_size, tp_rank, ep_size, ep_rank)
    opt_state = None
    if with_opt and bool(files[0].get("__has_opt__", False)):
        opt_state = AdamState(step=saved_step,
                              mu=_assemble(files, "mu", *cut),
                              nu=_assemble(files, "nu", *cut))
    return _assemble(files, "param", *cut), opt_state, saved_step


@torch.no_grad()
def gather_experts(tree: Dict[str, torch.Tensor], mesh
                   ) -> Dict[str, torch.Tensor]:
    """`tree` (a state dict, or a moment tree keyed like it) with its
    expert leaves gathered over the ep group: every rank's E/ep experts in
    ep order, all E of them, through one all-gather. Every rank of the
    group must call it; at ep = 1 (or with no mesh) `tree` itself."""
    keys = [k for k in tree if is_expert(k)]
    if mesh is None or mesh.ep == 1 or not keys:
        return tree
    flat = torch.cat([tree[k].reshape(-1) for k in keys])
    parts = all_gather(flat, mesh, "ep").split(
        [tree[k].numel() for k in keys], dim=1)
    out = dict(tree)
    for k, part in zip(keys, parts):
        local = tree[k].shape
        out[k] = part.reshape((mesh.ep * local[0],) + tuple(local[1:]))
    return out


@torch.no_grad()
def gather_stages(tree: Dict[str, torch.Tensor], model
                  ) -> Dict[str, torch.Tensor]:
    """`tree` (a state dict, or a moment tree keyed like it) with every pp
    stage's layers, under their canonical indices: each stage's layers
    through one all-gather over pp, renamed by that stage's
    `layer_ids` (the interleaved schedule's blocks back in the canonical
    order). Every rank of the pp group must call it, on the loop's
    thread; at pp = 1 `tree` itself."""
    mesh = model.mesh
    if mesh is None or mesh.pp == 1:
        return tree
    keys = [k for k in tree if k.startswith("layers.")]
    flat = torch.cat([tree[k].reshape(-1) for k in keys])
    every = all_gather(flat, mesh, "pp")
    out = {k: v for k, v in tree.items() if not k.startswith("layers.")}
    for stage, part in enumerate(every):
        ids = stage_layer_ids(model.cfg.num_layers, mesh.pp, stage,
                              model.pp_schedule, model.pp_virtual)
        for k, x in zip(keys, part.split([tree[k].numel() for k in keys])):
            _, i, rest = k.split(".", 2)
            out[f"layers.{ids[int(i)]}.{rest}"] = x.view_as(tree[k])
    return out


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Nested dicts -> {`{prefix}/a/b/c`: array}, the JAX key paths."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}/{key}"))
        else:
            flat[f"{prefix}/{key}"] = np.asarray(val)
    return flat


class AsyncSaveHandle:
    """Join handle of a checkpoint written in the background
    (`save_checkpoint(..., async_write=True)`, the JAX handle): `step`, and
    `join()`, which waits for the writer thread and returns the paths it
    wrote, re-raising its exception."""

    def __init__(self, step: int, write):
        self.step = step
        self._paths: List[str] = []
        self._error: Optional[BaseException] = None

        def run():
            try:
                self._paths = write()
            except BaseException as e:  # surfaced at join()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def join(self) -> List[str]:
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._paths


def _snapshot(state_dict: Dict[str, torch.Tensor],
              opt_state: Optional[AdamState]):
    """Device clones of the params and moments, enqueued on the current
    stream, so no later in-place update reaches them, and the event the
    writer's copies wait on (None off the card)."""
    clone = lambda t: {k: v.detach().clone() for k, v in t.items()}
    snap_opt = (None if opt_state is None else
                AdamState(step=opt_state.step, mu=clone(opt_state.mu),
                          nu=clone(opt_state.nu)))
    snap = clone(state_dict)
    event = None
    if next(iter(snap.values())).is_cuda:
        event = torch.cuda.Event()
        event.record()
    return snap, snap_opt, event


def _to_host(tree: Dict[str, torch.Tensor], event) -> Dict[str, torch.Tensor]:
    """A snapshot's host copy. On the card the copies run on a side stream
    behind `event`, so they overlap the train loop's kernels instead of
    queueing behind them."""
    if event is None:
        return tree
    side = torch.cuda.Stream(device=next(iter(tree.values())).device)
    with torch.cuda.stream(side):
        side.wait_event(event)
        host = {k: v.to("cpu") for k, v in tree.items()}
    side.synchronize()
    return host


def _savez(path: str, members: Dict[str, np.ndarray]) -> None:
    """`np.savez(path, **members)`'s file (a stored zip of `<key>.npy`
    entries), each array's bytes handed to the zip from a view of the
    array, where numpy copies them into Python bytes objects 16 MiB at a
    time: that copy holds the GIL, and in the background writer it stalls
    the train loop's thread."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in members.items():
            arr = np.asarray(val)
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1).view(np.uint8)))


def save_checkpoint(save_dir: str, step: int, avg_loss: float,
                    state_dict: Dict[str, torch.Tensor],
                    opt_state: Optional[AdamState] = None,
                    reserve_last_n: int = -1, tp_size: int = 1,
                    tp_rank: int = 0, mesh_axes=None,
                    async_write: bool = False, zero_stage: int = 0):
    """Write tp rank tp_rank's npz of iteration `step` from this rank's
    shard of the params and moments; returns the paths written, or with
    `async_write` an `AsyncSaveHandle` whose `join()` returns them. Every
    leaf of the shard is that rank's slice of the JAX leaf
    (`interop.params_to_jax`), the JAX `_shard_slice`. `mesh_axes` ((axis,
    size) pairs; default the tp-only mesh the file names imply) goes into
    the `__layout__` stamp, the same string on every rank, with
    `zero_stage`, which `__zero_stage__` records too (JAX's metadata: the
    files hold whole leaves at every stage, so a reader ignores it). The
    file is published with an atomic rename, so a kill mid-write never
    leaves a truncated file under a checkpoint name.

    Under ZeRO the caller passes the whole tensors: every dp rank gathers
    its shards first (`zero.ZeroPlan.full_params` / `full_state`, a
    collective), on the main thread, before the writer thread starts; at
    pp > 1 likewise every stage's layers (`gather_stages`), so the file
    holds every layer in the canonical order and the stamp's layer specs
    name 'pp'."""
    os.makedirs(save_dir, exist_ok=True)
    axes = mesh_axes if mesh_axes is not None else (("tp", tp_size),)
    layout = make_layout(
        axes, canonical_specs({k: v.shape for k, v in state_dict.items()},
                              pp=dict(axes).get("pp", 1)),
        zero_stage=zero_stage)

    def write(params, opt, event=None) -> List[str]:
        shard = _flatten(params_to_jax(_to_host(params, event)), "param")
        if opt is not None:
            shard.update(_flatten(params_to_jax(_to_host(opt.mu, event)),
                                  "mu"))
            shard.update(_flatten(params_to_jax(_to_host(opt.nu, event)),
                                  "nu"))
        shard["__step__"] = np.asarray(step, np.int64)
        shard["__tp_size__"] = np.asarray(tp_size, np.int64)
        shard["__has_opt__"] = np.asarray(opt is not None)
        shard["__zero_stage__"] = np.asarray(zero_stage, np.int64)
        stamp(shard, layout)
        path = os.path.join(
            save_dir, f"tprank-{tp_rank}_iter-{step}_loss-{avg_loss:.4f}.npz")
        tmp = path + ".tmp"
        _savez(tmp, shard)
        os.replace(tmp, path)
        if reserve_last_n > 0:
            prune_checkpoints(save_dir, reserve_last_n, tp_rank)
        return [path]

    if not async_write:
        return write(state_dict, opt_state)
    snap, snap_opt, event = _snapshot(state_dict, opt_state)
    return AsyncSaveHandle(step, lambda: write(snap, snap_opt, event))


def prune_checkpoints(save_dir: str, reserve_last_n: int,
                      rank: int = 0) -> None:
    """Keep only the newest `reserve_last_n` iterations of tp rank `rank`'s
    files (each rank's writer prunes its own)."""
    for _, old in list_checkpoints(save_dir, rank)[:-reserve_last_n]:
        os.remove(old)
