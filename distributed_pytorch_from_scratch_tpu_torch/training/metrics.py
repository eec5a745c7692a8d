"""Training throughput accounting: model FLOPs per step (the JAX
`training/metrics.model_flops_per_step`) and the card's peak rate, for MFU.

MFU counts against the dense bf16 tensor-core peak of the cards the run
uses, as the JAX package counts against the chips' bf16 peak. Peaks are
NVIDIA's data-sheet numbers (SXM part, dense, at the full power limit).
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

# (device-name prefix, dense bf16 FLOP/s), matched against
# torch.cuda.get_device_name()
PEAK_FLOPS = [
    ("NVIDIA H100", 989e12),
]

_warned = set()


def device_peak_flops(device: torch.device) -> Optional[float]:
    """The card's dense bf16 peak, or None where there is none to count
    against (the CPU, or a card missing from the table — warned once)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peak in PEAK_FLOPS:
        if name.startswith(prefix):
            return peak
    if name not in _warned:
        _warned.add(name)
        print(f"Warning: no peak FLOP/s known for {name!r}; MFU not "
              f"reported (add it to training/metrics.PEAK_FLOPS)",
              file=sys.stderr)
    return None


def model_flops_per_step(cfg, batch: int, seqlen: int) -> float:
    """Model FLOPs of one fwd+bwd train step (no remat recompute counted):
    6N per token + the 12*L*h*T^2*hd attention term. Under context
    parallelism the count is the same: the dense T^2 attention term of the
    whole sequence, not the blocks the ring schedule computes (about half
    of them, the causal ones)."""
    n = cfg.num_params()
    return (6 * n * batch * seqlen
            + 12 * cfg.num_layers * batch * cfg.num_heads
            * seqlen * seqlen * cfg.head_dim)
