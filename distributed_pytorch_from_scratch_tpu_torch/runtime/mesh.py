"""The port's counterpart of the JAX package's `runtime/mesh.py`.

The JAX mesh names five axes ('dp', 'pp', 'cp', 'ep', 'tp') over the devices
of one program. The port runs the cp axis as `torch.distributed` processes,
one per rank, as the reference ran its ranks (`mp.spawn` + NCCL): a `Mesh` is
this process's device plus, at cp > 1, its place in the cp group — the group
size, this process's rank, the process group and its backend. cp = 1 is one
device and no group. Every other axis > 1 is refused until its slice lands
(ROADMAP Queue 1).

Transport: NCCL (one card per rank) or gloo. NCCL refuses two ranks on one
card, so a cp group on a machine with fewer cards than ranks runs over gloo;
gloo moves CPU tensors only, so `ops/collectives.py` stages CUDA tensors
through host memory there. The transport is the caller's choice
(`--dist_backend`): nothing switches it silently.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig

AXIS_NAMES = ("dp", "pp", "cp", "ep", "tp")
BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this fails the run instead of
# hanging it (no step of this port waits on a peer for minutes)
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def resolve_device(name) -> torch.device:
    """torch.device for a `--device` value. A CUDA request with no visible
    card raises: the port never quietly runs on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False (no CUDA card visible to torch {torch.__version__}); "
            f"pass --device cpu to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}; expected cuda or cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cp_backend(backend: Optional[str], device: torch.device, cp: int) -> str:
    """The cp group's backend: `backend`, or NCCL on a card and gloo on the
    CPU when None. Raises where it cannot run: NCCL on CPU tensors, or NCCL
    with fewer cards than ranks (it refuses two ranks on one card)."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"dist backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("--dist_backend nccl moves CUDA tensors only; on "
                         "--device cpu use --dist_backend gloo")
    if backend == "nccl" and torch.cuda.device_count() < cp:
        raise RuntimeError(
            f"--dist_backend nccl needs one card per rank: {cp} ranks, "
            f"{torch.cuda.device_count()} card(s) visible (NCCL refuses two "
            f"ranks on one card); pass --dist_backend gloo to run the cp "
            f"group over gloo, its hops staged through host memory")
    return backend


@dataclass(frozen=True)
class Mesh:
    """This process's device and, at cp > 1, its place in the cp group."""

    device: torch.device
    cp: int = 1
    cp_rank: int = 0
    group: Any = None              # the cp process group; None at cp = 1
    backend: Optional[str] = None  # "nccl" or "gloo"; None at cp = 1


def make_mesh(cfg: MeshConfig, device="cuda", rank: int = 0,
              backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process. Refuses every axis > 1 but cp. At cp > 1
    this process is rank `rank` of the cp group: it takes card
    `rank % device_count` on a card, and joins the process group through
    `init_method` (e.g. `file://<dir>/rendezvous`) unless one exists.

    Also pins float32 matmuls to full float32 on the card (no TF32), so a
    float32 run here computes what the float32 reference computes."""
    for axis in AXIS_NAMES:
        n = getattr(cfg, axis)
        if n > 1 and axis != "cp":
            raise NotImplementedError(
                f"{axis}={n}: not ported yet, see ROADMAP Queue 1 (the port "
                f"runs dp=pp=ep=tp=1; cp through torch.distributed)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    if cfg.cp == 1:
        return Mesh(dev)
    if not 0 <= rank < cfg.cp:
        raise ValueError(f"rank {rank} outside the cp group of {cfg.cp}")
    backend = cp_backend(backend, dev, cfg.cp)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=cfg.cp, rank=rank,
                                timeout=COLLECTIVE_TIMEOUT)
    if dist.get_world_size() != cfg.cp or dist.get_rank() != rank:
        raise RuntimeError(f"the process group holds rank "
                           f"{dist.get_rank()} of {dist.get_world_size()}, "
                           f"not rank {rank} of cp {cfg.cp}")
    return Mesh(dev, cfg.cp, rank, dist.group.WORLD, backend)
