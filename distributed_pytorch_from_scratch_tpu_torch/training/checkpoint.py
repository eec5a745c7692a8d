"""Checkpoints in the JAX package's per-rank npz format, read and written.

The files are `tprank-{r}_iter-{n}_loss-{avg:.4f}.npz`, one per tp rank,
each holding flattened `param/<path>` (and `mu/`, `nu/` Adam moment)
leaves in the JAX tree layout — rank r's slice of every leaf on the dim its
JAX spec marks as 'tp', the moments sliced like their params — plus
`__step__`, `__tp_size__`, `__has_opt__` and `__zero_stage__` metadata:
the format of the JAX `training/checkpoint.py`, so either package resumes
or serves the other's files. `save_checkpoint` writes one rank's file from
that rank's shard; `load_checkpoint` reads every rank file, assembles the
global arrays and cuts the running rank's slice, so a file written at one
tp loads at another (the vocab leaves are padded to a multiple of the
writing tp: they must divide by the reading tp too); the trainer and the
serving CLI both load this way. Parameters are replicated over dp and cp,
so the ranks at dp = cp = 0 write, one file per tp rank, and every rank
reads.

Not ported: the asynchronous writer (writes here are synchronous) and the
`__layout__` stamp (the JAX reader treats an unstamped file as a legacy
tp-only layout) — ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import params_from_jax, params_to_jax
from ..parallel.layout import assemble_params, shard_params
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


def find_rank_shards(ckpt_dir: str, step: int) -> Dict[int, str]:
    """{rank: path} for the `tprank-{r}_iter-{step}_loss-*.npz` files."""
    rank_files: Dict[int, str] = {}
    for p in glob.glob(os.path.join(ckpt_dir, f"tprank-*_iter-{step}_loss-*.npz")):
        m = CKPT_RE.search(os.path.basename(p))
        if m and int(m.group(2)) == step:
            rank_files[int(m.group(1))] = p
    return rank_files


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
    rank_files = find_rank_shards(ckpt_dir, step)
    if not rank_files:
        raise FileNotFoundError(f"no checkpoint for iter {step} in {ckpt_dir}")
    with np.load(rank_files[min(rank_files)]) as shard:
        tp_size = (int(shard["__tp_size__"]) if "__tp_size__" in shard.files
                   else max(rank_files) + 1)
    missing = sorted(set(range(tp_size)) - set(rank_files))
    if missing:
        raise FileNotFoundError(
            f"checkpoint iter {step} was written with tp_size={tp_size} but "
            f"shard files for rank(s) {missing} are missing from {ckpt_dir} "
            f"— restore the missing rank file(s) or re-save the checkpoint")
    files = []
    for r in range(tp_size):
        with np.load(rank_files[r]) as shard:
            files.append({k: shard[k] for k in shard.files})
    return tp_size, files


def _assemble(files: List[Dict[str, np.ndarray]], prefix: str,
              tp_size: int, tp_rank: int) -> Dict[str, torch.Tensor]:
    """The `prefix` tree of every rank file, assembled on the tp dims into
    the global state dict, then sliced for rank tp_rank of tp_size."""
    full = assemble_params([params_from_jax(_unflatten(f, prefix))
                            for f in files])
    rows = full["embedding.weight"].shape[0]
    if rows % tp_size:
        raise ValueError(
            f"the checkpoint's vocab leaves hold {rows} rows (padded for "
            f"tp={len(files)}), which do not shard over tp={tp_size}; "
            f"resume at a tp that divides {rows}")
    return shard_params(full, tp_size, tp_rank)


def load_checkpoint(ckpt_dir: str, step: int, with_opt: bool = False,
                    tp_size: int = 1, tp_rank: int = 0
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[AdamState],
                               int]:
    """(state_dict, AdamState or None, step) of iteration `step`, for rank
    tp_rank of tp_size: every rank file is read and assembled into the
    global arrays (the JAX `load_checkpoint`), then this rank's slice is
    cut, so a checkpoint written at any tp loads at any tp its vocab rows
    divide. The moments only with `with_opt` and when the files hold
    them."""
    _, files = _read_rank_files(ckpt_dir, step)
    saved_step = int(files[0]["__step__"])
    opt_state = None
    if with_opt and bool(files[0].get("__has_opt__", False)):
        opt_state = AdamState(step=saved_step,
                              mu=_assemble(files, "mu", tp_size, tp_rank),
                              nu=_assemble(files, "nu", tp_size, tp_rank))
    return (_assemble(files, "param", tp_size, tp_rank), opt_state,
            saved_step)


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Nested dicts -> {`{prefix}/a/b/c`: array}, the JAX key paths."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}/{key}"))
        else:
            flat[f"{prefix}/{key}"] = np.asarray(val)
    return flat


def save_checkpoint(save_dir: str, step: int, avg_loss: float,
                    state_dict: Dict[str, torch.Tensor],
                    opt_state: Optional[AdamState] = None,
                    reserve_last_n: int = -1, tp_size: int = 1,
                    tp_rank: int = 0) -> List[str]:
    """Write tp rank tp_rank's npz of iteration `step` from this rank's
    shard of the params and moments (synchronously); returns the paths
    written. Every leaf of the shard is that rank's slice of the JAX leaf
    (`interop.params_to_jax`), the JAX `_shard_slice`. The file is
    published with an atomic rename, so a kill mid-write never leaves a
    truncated file under a checkpoint name."""
    os.makedirs(save_dir, exist_ok=True)
    shard = _flatten(params_to_jax(state_dict), "param")
    if opt_state is not None:
        shard.update(_flatten(params_to_jax(opt_state.mu), "mu"))
        shard.update(_flatten(params_to_jax(opt_state.nu), "nu"))
    shard["__step__"] = np.asarray(step, np.int64)
    shard["__tp_size__"] = np.asarray(tp_size, np.int64)
    shard["__has_opt__"] = np.asarray(opt_state is not None)
    shard["__zero_stage__"] = np.asarray(0, np.int64)
    path = os.path.join(
        save_dir, f"tprank-{tp_rank}_iter-{step}_loss-{avg_loss:.4f}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **shard)
    os.replace(tmp, path)
    if reserve_last_n > 0:
        prune_checkpoints(save_dir, reserve_last_n, tp_rank)
    return [path]


def prune_checkpoints(save_dir: str, reserve_last_n: int,
                      rank: int = 0) -> None:
    """Keep only the newest `reserve_last_n` iterations of tp rank `rank`'s
    files (each rank's writer prunes its own)."""
    for _, old in list_checkpoints(save_dir, rank)[:-reserve_last_n]:
        os.remove(old)
