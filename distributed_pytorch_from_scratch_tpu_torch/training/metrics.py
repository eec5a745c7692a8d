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
from typing import List, Optional

import torch
import torch.distributed as dist

from ..obs.schema import EVENT_SCHEMA_VERSION


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
    6N per token + the 12*L*h*T^2*hd attention term. For a MoE model N is
    the ACTIVE parameters: the (num_experts - top_k) experts a token is not
    routed through are taken out (the JAX convention; dropped routings are
    not counted). Under context
    parallelism the count is the same: the dense T^2 attention term of the
    whole sequence, not the blocks the ring schedule computes (about half
    of them, the causal ones).

    N is `cfg.num_params()`, the llama formula, unless `params` gives the
    real parameter count, as the gpt2 family must: its two-matmul MLP and
    tied head would otherwise be overcounted (the JAX
    `model_flops_per_step`)."""
    n = cfg.num_params() if params is None else params
    if cfg.num_experts:
        inactive = ((cfg.num_experts - cfg.moe_top_k)
                    * 3 * cfg.attn_dim * cfg.ffn_dim)
        n -= cfg.num_layers * max(0, inactive)
    return (6 * n * batch * seqlen
            + 12 * cfg.num_layers * batch * cfg.num_heads
            * seqlen * seqlen * cfg.head_dim)


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator statistics (`torch.cuda.memory_stats`) in the
    JAX `memory_stats()` names (`bytes_in_use`, `peak_bytes_in_use`,
    `bytes_limit`), or None where there are none (the CPU, or no card):
    callers render None as 'unavailable', never as 0 bytes (JAX's
    silent-zero rule)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_initialized():
        return None
    st = torch.cuda.memory_stats(device)
    if not st:
        return None
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}


def hbm_watermarks() -> Optional[List[dict]]:
    """One watermark per visible card (`bytes_in_use`, `peak_bytes`,
    `limit_bytes`: the JAX `hbm_watermarks`), None when no card reports
    stats — unavailable stays a value of its own, not a list of zeros."""
    out = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = device_memory_stats(torch.device("cuda", i))
            if stats is None:
                continue
            out.append({"device": f"cuda:{i}",
                        "bytes_in_use": stats["bytes_in_use"],
                        "peak_bytes": stats["peak_bytes_in_use"],
                        "limit_bytes": stats["bytes_limit"]})
    return out or None


def publish_hbm(telemetry=None, writer=None, step: Optional[int] = None,
                pool_accounted_bytes: Optional[int] = None,
                event: bool = False) -> Optional[List[dict]]:
    """The JAX `publish_hbm`: live device-memory gauges into `telemetry`
    and, with `event`, one `hbm_watermark` event into `writer`.

    Gauges: `hbm/available` (0/1: no stats is exported as 0-available,
    never as 0 bytes), and where available `hbm/bytes_in_use`,
    `hbm/peak_bytes`, `hbm/limit_bytes` (the worst card) plus per-card
    `hbm/d<i>/...`. `pool_accounted_bytes` (the paged pool's pages in use
    times page bytes) rides as `hbm/kv_accounted_bytes` and, with stats,
    `hbm/kv_accounted_frac` (accounted pool bytes over measured bytes in
    use). Returns the watermarks (None when unavailable)."""
    marks = hbm_watermarks()
    if telemetry is not None:
        telemetry.gauge("hbm/available", 0.0 if marks is None else 1.0)
        if marks is not None:
            telemetry.gauge("hbm/bytes_in_use",
                            max(m["bytes_in_use"] for m in marks))
            telemetry.gauge("hbm/peak_bytes",
                            max(m["peak_bytes"] for m in marks))
            telemetry.gauge("hbm/limit_bytes",
                            max(m["limit_bytes"] for m in marks))
            for i, m in enumerate(marks):
                telemetry.gauge(f"hbm/d{i}/bytes_in_use", m["bytes_in_use"])
                telemetry.gauge(f"hbm/d{i}/peak_bytes", m["peak_bytes"])
        if pool_accounted_bytes is not None:
            telemetry.gauge("hbm/kv_accounted_bytes", pool_accounted_bytes)
            if marks is not None:
                in_use = max(m["bytes_in_use"] for m in marks)
                if in_use:
                    telemetry.gauge("hbm/kv_accounted_frac",
                                    pool_accounted_bytes / in_use)
    if event and writer is not None:
        fields = {"devices": marks or [], "available": marks is not None}
        if pool_accounted_bytes is not None:
            fields["pool_accounted_bytes"] = int(pool_accounted_bytes)
        writer.event("hbm_watermark", step=step, **fields)
    return marks
