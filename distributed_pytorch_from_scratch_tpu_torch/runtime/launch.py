"""Run one function on every rank of a mesh (dp x cp x tp ranks): one
process per rank, started with `torch.multiprocessing.spawn` (start method
`spawn`: forking a process that has initialised CUDA breaks it), joined
through a `file://`
rendezvous in a fresh temporary directory (no port to collide with another
group on the same machine). A rank that raises fails the whole group: spawn
stops the others and re-raises it in the caller.

`spawn(fn, nprocs, *args)` calls `fn(rank, nprocs, init_method, *args)` in
each process and returns the ranks' return values in rank order (each is
pickled through a file in the temporary directory). `fn` must be importable
by name from a fresh interpreter, so the workers live in this package: a
group started from a test imports no jax.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _run(rank: int, fn: Callable, nprocs: int, workdir: str,
         args: tuple) -> None:
    init_method = f"file://{os.path.join(workdir, 'rendezvous')}"
    # the ranks share the host's cores: more threads than cores would spin
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    try:
        out = fn(rank, nprocs, init_method, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank-{rank}.pt"))


def spawn(fn: Callable, nprocs: int, *args: Any) -> List[Any]:
    """[fn(rank, nprocs, init_method, *args) for each rank], each run in a
    process of its own; see the module docstring."""
    with tempfile.TemporaryDirectory(prefix="mesh-group-") as workdir:
        mp.spawn(_run, args=(fn, nprocs, workdir, args), nprocs=nprocs,
                 join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank-{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
