"""Reader for the JAX package's per-rank npz checkpoints (numpy only).

The files are `tprank-{r}_iter-{n}_loss-{avg}.npz`, one per tp rank, each
holding flattened `param/<path>` (and `mu/`, `nu/` optimizer) leaves plus
`__step__`/`__tp_size__` metadata — the format of the JAX
`training/checkpoint.py`. This copy reads tp=1 checkpoints into the JAX
param tree (nested dicts of numpy arrays), which `interop.params_from_jax`
maps onto the port's model. Checkpoints written at tp > 1 are refused
until tensor parallelism is ported.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

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


def load_params(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """The param tree of iteration `step` from a tp=1 checkpoint."""
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
        return _unflatten({k: shard[k] for k in shard.files}, "param")
