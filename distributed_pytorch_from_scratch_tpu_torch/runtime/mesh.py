"""The 1-device counterpart of the JAX package's `runtime/mesh.py`.

The JAX mesh names five axes ('dp', 'pp', 'cp', 'ep', 'tp'). This slice of
the port runs on one device only, so the "mesh" is the device it holds;
any axis larger than 1 is refused until the `torch.distributed` slices
land (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import MeshConfig

AXIS_NAMES = ("dp", "pp", "cp", "ep", "tp")


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


@dataclass(frozen=True)
class Mesh:
    """One device: the mesh of this slice."""

    device: torch.device


def make_mesh(cfg: MeshConfig, device="cuda") -> Mesh:
    """Build the 1-device mesh on `device`. Refuses every axis > 1.

    Also pins float32 matmuls to full float32 on the card (no TF32), so a
    float32 run here computes what the float32 reference computes."""
    for axis in AXIS_NAMES:
        n = getattr(cfg, axis)
        if n > 1:
            raise NotImplementedError(
                f"{axis}={n}: multi-device meshes are not ported yet, see "
                f"ROADMAP (this slice runs dp=pp=cp=ep=tp=1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Mesh(resolve_device(device))
