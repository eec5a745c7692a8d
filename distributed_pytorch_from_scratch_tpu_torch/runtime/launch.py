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

Kept groups: inside `with kept_groups():`, `spawn` starts a group of each
size once and runs every later call of that size on the same processes,
one call after another (a script that runs many groups pays each
process's start, its imports and its card's first use once). The process
group stays joined between calls; a call's rank function finds it through
`make_mesh`, which joins only where none exists. A rank that raises, or
dies, stops its whole kept group and the error is raised in the caller; the
next call of that size starts a new one. Leaving the block stops them all.
Each call's card memory per rank (allocated before it, at its return,
and its peak) goes to `calls`.

Threads: each rank runs torch on its share of the host's cores (cores /
nprocs), and on no more threads than the launching process has
(`torch_threads` caps a launcher that shares its host).

Signals: while the group runs, the launching process (from its main
thread) forwards SIGTERM and SIGINT to every rank and waits for them; ranks
that exit cleanly (the trainer checkpoints and returns) make a clean
return. Each rank runs in a process group of its own, so a terminal's
Ctrl-C reaches the ranks once, through the launcher, and a second one
reaches them as a second signal (the trainer's force-quit). On Linux a rank
is killed when the launcher dies.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import queue
import signal
import tempfile
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

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


def _rank_threads(nprocs: int, threads: int) -> None:
    """A rank's torch threads: its share of the host's cores (the ranks
    share them: more threads than cores would spin), at most the
    launcher's own `threads`."""
    torch.set_num_threads(max(1, min(threads,
                                     (os.cpu_count() or 1) // nprocs)))


def _run(rank: int, fn: Callable, nprocs: int, workdir: str,
         args: tuple, threads: int) -> None:
    _detach()
    init_method = f"file://{os.path.join(workdir, 'rendezvous')}"
    _rank_threads(nprocs, threads)
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


def _serve_calls(rank: int, nprocs: int, workdir: str, calls, done,
                 threads: int) -> None:
    """A kept group's rank: runs each (index, fn, args) of `calls` until
    None, saving fn's return value as `_run` does and reporting (index,
    rank, None, its card memory) or (index, rank, traceback, None) on
    `done`; a call that raises ends the rank."""
    _detach()
    init_method = f"file://{os.path.join(workdir, 'rendezvous')}"
    _rank_threads(nprocs, threads)
    try:
        while True:
            call = calls.get()
            if call is None:
                return
            index, fn, args = call
            if torch.cuda.is_initialized():
                torch.cuda.reset_peak_memory_stats()
            before = _allocated()
            try:
                out = fn(rank, nprocs, init_method, *args)
                torch.save(out, os.path.join(workdir,
                                             f"call-{index}-rank-{rank}.pt"))
            except BaseException:
                done.put((index, rank, traceback.format_exc(), None))
                return
            del out
            mem = {"before": before, "live": _allocated(),
                   "peak": (torch.cuda.max_memory_allocated()
                            if torch.cuda.is_initialized() else 0)}
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
            done.put((index, rank, None, mem))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# each kept-group call's card memory per rank, in call order: {"nprocs",
# "fn", "ranks": [{"before", "live", "peak"}]} (bytes allocated at the
# call's start, at its return, and the call's peak)
calls: List[Dict[str, Any]] = []


def _allocated() -> int:
    return (torch.cuda.memory_allocated() if torch.cuda.is_initialized()
            else 0)


class _KeptGroup:
    """nprocs rank processes that run one call after another (see the
    module docstring)."""

    def __init__(self, nprocs: int):
        self.nprocs = nprocs
        self._dir = tempfile.TemporaryDirectory(prefix="mesh-group-")
        ctx = mp.get_context("spawn")
        self._calls = [ctx.Queue() for _ in range(nprocs)]
        self._done = ctx.Queue()
        self._procs = [ctx.Process(target=_serve_calls,
                                   args=(r, nprocs, self._dir.name,
                                         self._calls[r], self._done,
                                         torch.get_num_threads()))
                       for r in range(nprocs)]
        for p in self._procs:
            p.start()
        self._index = 0
        self.alive = True

    def run(self, fn: Callable, args: tuple) -> List[Any]:
        index, self._index = self._index, self._index + 1
        for q in self._calls:
            q.put((index, fn, args))
        pending = set(range(self.nprocs))
        mems = [None] * self.nprocs
        with _Forward([p.pid for p in self._procs]):
            while pending:
                try:
                    got, rank, err, mem = self._done.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r in pending
                            if not self._procs[r].is_alive()]
                    if dead:
                        self.close(clean=False)
                        raise RuntimeError(
                            f"rank {dead[0]} of a kept group of "
                            f"{self.nprocs} died (exit code "
                            f"{self._procs[dead[0]].exitcode})")
                    continue
                if err is not None:
                    self.close(clean=False)
                    raise RuntimeError(f"rank {rank} of a kept group of "
                                       f"{self.nprocs} raised:\n{err}")
                if got == index:
                    pending.discard(rank)
                    mems[rank] = mem
        calls.append({"nprocs": self.nprocs,
                      "fn": getattr(fn, "__name__", str(fn)), "ranks": mems})
        outs = []
        for r in range(self.nprocs):
            path = os.path.join(self._dir.name, f"call-{index}-rank-{r}.pt")
            outs.append(torch.load(path, weights_only=False))
            os.remove(path)
        return outs

    def close(self, clean: bool = True) -> None:
        """Stops the ranks: a clean end between calls, SIGKILL after a
        failed call (a rank may wait in a collective for the one that
        failed)."""
        if not self.alive:
            return
        self.alive = False
        for q in self._calls:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30 if clean else 0)
            if p.is_alive():
                p.kill()
                p.join()
        self._dir.cleanup()


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads in this process capped at `n` inside the
    block and restored on leaving (for callers that share the host's
    cores with other busy processes: more threads than cores spin)."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, min(n, before)))
    try:
        yield
    finally:
        torch.set_num_threads(before)


_KEPT: Optional[Dict[int, _KeptGroup]] = None
_KEPT_LOCK = threading.Lock()


@contextlib.contextmanager
def kept_groups():
    """Inside this block `spawn` keeps one group of each size and reuses it
    (see the module docstring); on leaving, every kept rank is stopped."""
    global _KEPT
    if _KEPT is not None:
        raise RuntimeError("kept_groups() is already active")
    _KEPT = {}
    try:
        yield
    finally:
        groups, _KEPT = _KEPT, None
        for group in groups.values():
            group.close()


def spawn(fn: Callable, nprocs: int, *args: Any) -> List[Any]:
    """[fn(rank, nprocs, init_method, *args) for each rank], each run in a
    process of its own (on a kept group's inside `kept_groups()`); see the
    module docstring."""
    if _KEPT is not None:
        with _KEPT_LOCK:
            group = _KEPT.get(nprocs)
            if group is None or not group.alive:
                group = _KEPT[nprocs] = _KeptGroup(nprocs)
            return group.run(fn, args)
    with tempfile.TemporaryDirectory(prefix="mesh-group-") as workdir:
        ctx = mp.start_processes(_run, args=(fn, nprocs, workdir, args,
                                             torch.get_num_threads()),
                                 nprocs=nprocs, join=False,
                                 start_method="spawn")
        with _Forward(ctx.pids()):
            while not ctx.join():
                pass
        return [torch.load(os.path.join(workdir, f"rank-{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
