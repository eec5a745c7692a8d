"""Checkpoints in the JAX package's per-rank npz format, read and written.

The files are `tprank-{r}_iter-{n}_loss-{avg:.4f}.npz`, one per tp rank,
each holding flattened `param/<path>` (and `mu/`, `nu/` Adam moment)
leaves in the JAX tree layout plus `__step__`, `__tp_size__`,
`__has_opt__` and `__zero_stage__` metadata — the format of the JAX
`training/checkpoint.py`, so either package resumes or serves the other's
files. `load_params` reads the JAX param tree (nested dicts of numpy
arrays, which `interop.params_from_jax` maps onto the port's model);
`save_checkpoint`/`load_checkpoint` carry the port's state_dict and
AdamState through `interop`. tp=1 only: checkpoints written at tp > 1 are
refused until tensor parallelism is ported. Parameters are replicated over
cp, so a cp run's checkpoint is this same tp=1 file (its rank 0 writes it,
every rank reads it), and runs at any cp read each other's.

Not ported: the asynchronous writer (writes here are synchronous) and the
`__layout__` stamp (the JAX reader treats an unstamped file as a legacy
tp-only layout) — ROADMAP Queue 1 (a).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import params_from_jax, params_to_jax
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


def _read_shard(ckpt_dir: str, step: int) -> Dict[str, np.ndarray]:
    """Every member of iteration `step`'s tp=1 npz file."""
    rank_files = find_rank_shards(ckpt_dir, step)
    if not rank_files:
        raise FileNotFoundError(f"no checkpoint for iter {step} in {ckpt_dir}")
    with np.load(rank_files[min(rank_files)]) as shard:
        tp_size = (int(shard["__tp_size__"]) if "__tp_size__" in shard.files
                   else max(rank_files) + 1)
        if tp_size != 1:
            raise NotImplementedError(
                f"checkpoint iter {step} in {ckpt_dir} was written at "
                f"tp_size={tp_size}: loading tp>1 checkpoints is not ported "
                f"yet, see ROADMAP")
        return {k: shard[k] for k in shard.files}


def load_params(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """The param tree of iteration `step` from a tp=1 checkpoint."""
    return _unflatten(_read_shard(ckpt_dir, step), "param")


def load_checkpoint(ckpt_dir: str, step: int, with_opt: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[AdamState],
                               int]:
    """(state_dict, AdamState or None, step) of iteration `step`; the
    moments only with `with_opt` and when the file holds them."""
    flat = _read_shard(ckpt_dir, step)
    saved_step = int(flat["__step__"])
    opt_state = None
    if with_opt and bool(flat.get("__has_opt__", False)):
        opt_state = AdamState(step=saved_step,
                              mu=params_from_jax(_unflatten(flat, "mu")),
                              nu=params_from_jax(_unflatten(flat, "nu")))
    return params_from_jax(_unflatten(flat, "param")), opt_state, saved_step


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
                    reserve_last_n: int = -1) -> List[str]:
    """Write the tp=1 npz of iteration `step` (synchronously); returns the
    paths written. The file is published with an atomic rename, so a kill
    mid-write never leaves a truncated file under a checkpoint name."""
    os.makedirs(save_dir, exist_ok=True)
    shard = _flatten(params_to_jax(state_dict), "param")
    if opt_state is not None:
        shard.update(_flatten(params_to_jax(opt_state.mu), "mu"))
        shard.update(_flatten(params_to_jax(opt_state.nu), "nu"))
    shard["__step__"] = np.asarray(step, np.int64)
    shard["__tp_size__"] = np.asarray(1, np.int64)
    shard["__has_opt__"] = np.asarray(opt_state is not None)
    shard["__zero_stage__"] = np.asarray(0, np.int64)
    path = os.path.join(save_dir,
                        f"tprank-0_iter-{step}_loss-{avg_loss:.4f}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **shard)
    os.replace(tmp, path)
    if reserve_last_n > 0:
        prune_checkpoints(save_dir, reserve_last_n)
    return [path]


def prune_checkpoints(save_dir: str, reserve_last_n: int) -> None:
    """Keep only the newest `reserve_last_n` iterations (tp=1: one file
    each)."""
    for _, old in list_checkpoints(save_dir)[:-reserve_last_n]:
        os.remove(old)
