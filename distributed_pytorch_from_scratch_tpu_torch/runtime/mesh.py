"""The port's counterpart of the JAX package's `runtime/mesh.py`.

The JAX mesh names five axes ('dp', 'pp', 'cp', 'ep', 'tp') over the devices
of one program. The port runs every one of them as `torch.distributed`
processes, one per rank, as the reference ran its ranks (`mp.spawn` +
NCCL). Ranks take their coordinates in the JAX device order: the grid (dp,
pp, cp, ep, tp) with tp innermost, so global rank r sits at tp index r %
tp, ep index (r // tp) % ep, cp index (r // (tp * ep)) % cp, pp index (r //
(tp * ep * cp)) % pp and dp index r // (tp * ep * cp * pp).

A `Mesh` is this process's device plus its place on each axis: the axis
size, this process's index on it and the process group of the ranks that
differ from it on that axis alone. Two more groups hold the batch axes
(the JAX `batch_axes`): 'batch', the dp x cp x ep ranks that share this
process's pp and tp indices (the loss sums its numerator and count over
it, and the train step every gradient but the experts'), and, at ep > 1,
'expert_batch', the dp x cp ranks that share its pp, ep and tp indices
(the experts' gradients: each ep rank holds its own experts). The pp
index stays out of both: a pipeline stage holds its own layers, and only
the loss's sums and the gradients of the leaves every stage holds (the
embedding, the final norm, the head) add the 'pp' group on top. An axis
of size 1 has no group.

Transport: NCCL (one card per rank) or gloo. NCCL refuses two ranks on one
card, so a group on a machine with fewer cards than ranks runs over gloo;
gloo moves CPU tensors only, so `ops/collectives.py` stages CUDA tensors
through host memory there. The transport is the caller's choice
(`--dist_backend`): nothing switches it silently.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig

AXIS_NAMES = ("dp", "pp", "cp", "ep", "tp")
# the axes the port runs, and the order every rank creates their groups in
GROUP_AXES = ("dp", "pp", "cp", "ep", "tp", "batch", "expert_batch")
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


def dist_backend(backend: Optional[str], device: torch.device,
                 world: int) -> str:
    """The process groups' backend: `backend`, or NCCL on a card and gloo on
    the CPU when None. Raises where it cannot run: NCCL on CPU tensors, or
    NCCL with fewer cards than ranks (it refuses two ranks on one card)."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"dist backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("--dist_backend nccl moves CUDA tensors only; on "
                         "--device cpu use --dist_backend gloo")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"--dist_backend nccl needs one card per rank: {world} ranks, "
            f"{torch.cuda.device_count()} card(s) visible (NCCL refuses two "
            f"ranks on one card); pass --dist_backend gloo to run the groups "
            f"over gloo, their hops staged through host memory")
    return backend


def coords(rank: int, dp: int, cp: int, tp: int, ep: int = 1,
           pp: int = 1) -> Dict[str, int]:
    """Global rank -> {dp, pp, cp, ep, tp} indices, tp innermost (JAX
    device order)."""
    return {"dp": rank // (tp * ep * cp * pp),
            "pp": (rank // (tp * ep * cp)) % pp,
            "cp": (rank // (tp * ep)) % cp,
            "ep": (rank // tp) % ep, "tp": rank % tp}


def axis_groups(axis: str, dp: int, cp: int, tp: int, ep: int = 1,
                pp: int = 1) -> List[List[int]]:
    """Every group of `axis` as its ascending global ranks, in one fixed
    order. 'batch' groups the dp x cp x ep ranks of each (pp, tp) pair,
    'expert_batch' the dp x cp ranks of each (pp, ep, tp) triple."""
    world = dp * pp * cp * ep * tp
    at = lambda r: coords(r, dp, cp, tp, ep, pp)
    if axis == "batch":
        key = lambda r: (at(r)["pp"], at(r)["tp"])
    elif axis == "expert_batch":
        key = lambda r: (at(r)["pp"], at(r)["ep"], at(r)["tp"])
    else:
        # the ranks that agree on every other axis form one group
        key = lambda r: tuple(v for a, v in at(r).items() if a != axis)
    groups: Dict[Any, List[int]] = {}
    for r in range(world):
        groups.setdefault(key(r), []).append(r)
    return list(groups.values())


@dataclass(frozen=True)
class Axis:
    """This process's place on one axis: the axis size, its index there, the
    group's global ranks in index order and the process group (None at
    size 1)."""

    name: str
    size: int = 1
    rank: int = 0
    members: Tuple[int, ...] = (0,)
    group: Any = None


@dataclass(frozen=True)
class Mesh:
    """This process's device and its place on the dp, pp, cp, ep, tp and
    batch axes."""

    device: torch.device
    dp: int = 1
    cp: int = 1
    tp: int = 1
    rank: int = 0                  # global rank
    backend: Optional[str] = None  # "nccl" or "gloo"; None on one rank
    axes: Dict[str, Axis] = field(default_factory=dict)
    ep: int = 1
    pp: int = 1

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.cp * self.ep * self.tp

    def axis(self, name: str) -> Axis:
        return self.axes.get(name) or Axis(name)

    @property
    def dp_rank(self) -> int:
        return self.axis("dp").rank

    @property
    def pp_rank(self) -> int:
        return self.axis("pp").rank

    @property
    def cp_rank(self) -> int:
        return self.axis("cp").rank

    @property
    def ep_rank(self) -> int:
        return self.axis("ep").rank

    @property
    def tp_rank(self) -> int:
        return self.axis("tp").rank

    @property
    def coords(self) -> Dict[str, int]:
        return {"dp": self.dp_rank, "pp": self.pp_rank, "cp": self.cp_rank,
                "ep": self.ep_rank, "tp": self.tp_rank}

    @property
    def row_shard(self) -> Tuple[int, int]:
        """(blocks, this rank's block) of a batch's rows: the batch shards
        over ('dp', 'ep'), dp major (the JAX P(('dp', 'ep'), 'cp'))."""
        return self.dp * self.ep, self.dp_rank * self.ep + self.ep_rank


def make_mesh(cfg: MeshConfig, device="cuda", rank: int = 0,
              backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process: global rank `rank` of dp * pp * cp * ep *
    tp. With more than one rank it takes card `rank % device_count` on a card, joins
    the process group through `init_method` (e.g. `file://<dir>/rendezvous`)
    unless one exists, and creates every axis's groups — every rank creates
    every group, in the one order of `GROUP_AXES` and `axis_groups`
    (`dist.new_group` is a collective: a rank that skipped one would hang
    the others).

    Also pins float32 matmuls to full float32 on the card (no TF32), so a
    float32 run here computes what the float32 reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(device)
    world = cfg.dp * cfg.pp * cfg.cp * cfg.ep * cfg.tp
    shape = (f"dp {cfg.dp} x pp {cfg.pp} x cp {cfg.cp} x ep {cfg.ep} x tp "
             f"{cfg.tp}")
    if world == 1:
        return Mesh(dev)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside the mesh of {world} ranks "
                         f"({shape})")
    backend = dist_backend(backend, dev, world)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=COLLECTIVE_TIMEOUT)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend}")
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(f"the process group holds rank "
                           f"{dist.get_rank()} of {dist.get_world_size()}, "
                           f"not rank {rank} of {shape}")
    sizes = {"dp": cfg.dp, "pp": cfg.pp, "cp": cfg.cp, "ep": cfg.ep,
             "tp": cfg.tp,
             "batch": cfg.dp * cfg.cp * cfg.ep,
             # at ep = 1 the experts' group is 'batch' itself
             "expert_batch": cfg.dp * cfg.cp if cfg.ep > 1 else 1}
    axes = {}
    for name in GROUP_AXES:
        if sizes[name] == 1:
            continue
        for members in axis_groups(name, cfg.dp, cfg.cp, cfg.tp, cfg.ep,
                                   cfg.pp):
            group = dist.new_group(members, timeout=COLLECTIVE_TIMEOUT)
            if rank in members:
                axes[name] = Axis(name, sizes[name], members.index(rank),
                                  tuple(members), group)
    # every rank of the mesh, over the default group (no group to create):
    # a serving engine's dispatch broadcasts (serving/tp_dispatch.py)
    axes["world"] = Axis("world", world, rank, tuple(range(world)),
                         dist.group.WORLD)
    return Mesh(dev, cfg.dp, cfg.cp, cfg.tp, rank, backend, axes, cfg.ep,
                cfg.pp)
