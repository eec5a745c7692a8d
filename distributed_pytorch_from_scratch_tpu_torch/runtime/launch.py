"""Run one function on every rank of a mesh (dp x cp x tp ranks): one
process per rank, started with `torch.multiprocessing` (start method
`spawn`: forking a process that has initialised CUDA breaks it), joined
through a `file://` rendezvous in a fresh temporary directory (no port to
collide with another group on the same machine). A rank that raises fails
the whole group: the others are stopped and its error re-raised in the
caller.

`spawn(fn, nprocs, *args)` calls `fn(rank, nprocs, init_method, *args)` in
each process and returns the ranks' return values in rank order (each is
pickled through a file in the temporary directory). `fn` must be importable
by name from a fresh interpreter, so the workers live in this package: a
group started from a test imports no jax.

Signals: while the group runs, the launching process (from its main
thread) forwards SIGTERM and SIGINT to every rank and waits for them; ranks
that exit cleanly (the trainer checkpoints and returns) make a clean
return. Each rank runs in a process group of its own, so a terminal's
Ctrl-C reaches the ranks once, through the launcher, and a second one
reaches them as a second signal (the trainer's force-quit). On Linux a rank
is killed when the launcher dies.
"""

from __future__ import annotations

import ctypes
import os
import signal
import tempfile
import threading
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

FORWARDED = (signal.SIGTERM, signal.SIGINT)
_PR_SET_PDEATHSIG = 1


def _detach() -> None:
    """A process group of the rank's own, and SIGKILL when the launcher
    dies (Linux prctl; elsewhere the rank outlives it)."""
    os.setpgrp()
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _run(rank: int, fn: Callable, nprocs: int, workdir: str,
         args: tuple) -> None:
    _detach()
    init_method = f"file://{os.path.join(workdir, 'rendezvous')}"
    # the ranks share the host's cores: more threads than cores would spin
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    try:
        out = fn(rank, nprocs, init_method, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank-{rank}.pt"))


class _Forward:
    """SIGTERM and SIGINT handlers that pass each signal on to the ranks;
    installed from the main thread only, restored on exit."""

    def __init__(self, pids: List[int]):
        self.pids = pids
        self._prev = []

    def _handle(self, signum, frame) -> None:
        for pid in self.pids:
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._prev = [(s, signal.signal(s, self._handle))
                          for s in FORWARDED]
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev:
            signal.signal(sig, prev)


def spawn(fn: Callable, nprocs: int, *args: Any) -> List[Any]:
    """[fn(rank, nprocs, init_method, *args) for each rank], each run in a
    process of its own; see the module docstring."""
    with tempfile.TemporaryDirectory(prefix="mesh-group-") as workdir:
        ctx = mp.start_processes(_run, args=(fn, nprocs, workdir, args),
                                 nprocs=nprocs, join=False,
                                 start_method="spawn")
        with _Forward(ctx.pids()):
            while not ctx.join():
                pass
        return [torch.load(os.path.join(workdir, f"rank-{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
