"""Training metrics: the metrics writer (the JAX `MetricsWriter`: a
`metrics.jsonl` stream, mirrored to TensorBoard when `tensorboardX`
imports), model FLOPs per step (the JAX `model_flops_per_step`) and the
card's peak rate, for MFU.

MFU counts against the dense bf16 tensor-core peak of the cards the run
uses, as the JAX package counts against the chips' bf16 peak. Peaks are
NVIDIA's data-sheet numbers (SXM part, dense, at the full power limit).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

# the JAX `obs/schema.EVENT_SCHEMA_VERSION` the records carry, so either
# package's readers take the other's files
EVENT_SCHEMA_VERSION = 7


class MetricsWriter:
    """Process 0 writes `metrics.jsonl`, process i > 0 `metrics.proc{i}
    .jsonl`, so processes sharing one log dir never interleave lines in one
    file (the JAX names; a process here is a rank, and `process_index`
    defaults to the torch.distributed rank). TensorBoard, when
    `tensorboardX` imports, gets the scalars and texts too (its file names
    embed host and pid, so writers in one dir never clobber). Size-based
    rotation: once a file passes `max_bytes` (0 = unbounded), a `rotated`
    event naming the next file is its last line and the stream goes on
    there (metrics.jsonl -> metrics.001.jsonl -> ...). Also a context
    manager, so the file closes on error paths."""

    def __init__(self, log_dir: str, process_index: Optional[int] = None,
                 max_bytes: int = 0):
        if process_index is None:
            process_index = dist.get_rank() if dist.is_initialized() else 0
        self.process_index = process_index
        os.makedirs(log_dir, exist_ok=True)
        name = ("metrics.jsonl" if process_index == 0
                else f"metrics.proc{process_index}.jsonl")
        self.path = os.path.join(log_dir, name)
        self.max_bytes = max_bytes
        self._base, self._ext = os.path.splitext(self.path)
        self._gen = 0
        self._jsonl = open(self.path, "a")
        # writes may come from more than one thread: serialize, or lines tear
        self._lock = threading.Lock()
        self._closed = False
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional
            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    def _write(self, rec: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
            if self.max_bytes and self._jsonl.tell() >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._gen += 1
        nxt = f"{self._base}.{self._gen:03d}{self._ext}"
        self._jsonl.write(json.dumps(
            {"tag": "rotated", "ts": time.time(),
             "schema_version": EVENT_SCHEMA_VERSION,
             "next": os.path.basename(nxt), "generation": self._gen}) + "\n")
        self._jsonl.close()
        self.path = nxt
        self._jsonl = open(nxt, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step),
                     "ts": time.time()})
        # after close, TensorBoard would start a fresh event file: drop
        if self._tb is not None and not self._closed:
            self._tb.add_scalar(tag, value, step)

    def text(self, tag: str, value: str, step: int = 0) -> None:
        self._write({"tag": tag, "text": value, "step": int(step)})
        if self._tb is not None and not self._closed:
            self._tb.add_text(tag, value, step)

    def event(self, tag: str, step: Optional[int] = None, **fields) -> None:
        """A structured one-off record, jsonl only, carrying
        `schema_version`."""
        rec = {"tag": tag, "ts": time.time(),
               "schema_version": EVENT_SCHEMA_VERSION, **fields}
        if step is not None:
            rec["step"] = int(step)
        self._write(rec)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

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


def model_flops_per_step(cfg, batch: int, seqlen: int,
                         params: Optional[int] = None) -> float:
    """Model FLOPs of one fwd+bwd train step (no remat recompute counted):
    6N per token + the 12*L*h*T^2*hd attention term. Under context
    parallelism the count is the same: the dense T^2 attention term of the
    whole sequence, not the blocks the ring schedule computes (about half
    of them, the causal ones).

    N is `cfg.num_params()`, the llama formula, unless `params` gives the
    real parameter count, as the gpt2 family must: its two-matmul MLP and
    tied head would otherwise be overcounted (the JAX
    `model_flops_per_step`)."""
    n = cfg.num_params() if params is None else params
    return (6 * n * batch * seqlen
            + 12 * cfg.num_layers * batch * cfg.num_heads
            * seqlen * seqlen * cfg.head_dim)
