"""One captured program per fixed shape: the CUDA-graph runner, the port's
counterpart of `jax.jit` on the TPU side.

JAX turns a decode step or a train step into one compiled program that the
host dispatches once. The port runs eagerly, so the same step is hundreds
of small kernel launches from Python, and at serving sizes the host's
launch loop, not the card, sets the step's time. `CapturedStep` records the
step once as a CUDA graph (`torch.cuda.graph`) and replays it: one launch
from the host for the whole step, the same kernels on the card. The
hand-written kernels launch on `torch.cuda.current_stream()`, which during
the capture is the capture stream, so they are captured as they stand.

The rules:

* static buffers: the runner owns the step's input tensors; a call copies
  its arguments into them (a host array through a pinned buffer of the
  runner's, asynchronously) and replays. The outputs are the tensors the
  capture produced: the next replay overwrites them, so a caller that
  keeps one past its next call copies it;
* set-up: the body runs `warmup` times on a side stream (kernels built,
  cuBLAS and the allocator warmed), then is captured once. The body runs
  for real during the warm-up, on the example inputs, so a caller passes
  inputs whose effects are harmless or undoes them (the serving engines
  pass a dispatch that writes only free rows and the scratch page; the
  train step restores the parameters and moments the warm-up moved);
* launch counts stay true: a wrapper's Python counter rises when the body
  runs in Python, not when the card replays the graph. The runner puts
  every counter back after its set-up, keeps what the capture added (the
  kernels one replay launches) and adds that on each replay, so
  `ops.cuda.launch_counts()` still counts the kernels that ran;
* no fallback: the runner takes CUDA tensors only, and a capture that
  fails raises. The callers decide before building one whether a step is
  captured (`use_decode_graph`), and on the CPU they run the plain path.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.cuda import (add_to_counters, counter_delta, counter_state,
                        launch_counts, set_counters)

DECODE_GRAPH_MODES = ("auto", "on", "off")


def use_decode_graph(mode: str, device, tp: int, cp: int = 1) -> bool:
    """Whether a serving engine captures its decode step: 'auto' on a card
    at tp = 1 and cp = 1 (eager on the CPU and at tp or cp > 1), 'off'
    never (the eager step, the graph's oracle), 'on' always, refused where
    it cannot run: on the CPU there is no graph, and at tp > 1 or on a
    cp-sharded page pool the gloo hops inside the step are staged through
    host memory, which a capture cannot hold (NCCL hops could be captured,
    but no machine here runs NCCL: ROADMAP Queue 1 items 2 and 3)."""
    if mode not in DECODE_GRAPH_MODES:
        raise ValueError(f"decode_graph must be one of {DECODE_GRAPH_MODES}, "
                         f"got {mode!r}")
    capturable = torch.device(device).type == "cuda" and tp == 1 and cp == 1
    if mode == "on" and not capturable:
        raise ValueError(
            f"decode_graph 'on' needs tp=1 on a CUDA card and cp=1 (got "
            f"device {device}, tp {tp}, cp {cp}): no graph on the CPU, and "
            f"at tp > 1 or cp > 1 the host-staged hops cannot be captured, "
            f"see ROADMAP Queue 1 items 2 and 3")
    return mode != "off" and capturable


class CapturedStep:
    """`fn(*inputs) -> outputs` captured once for the example inputs'
    shapes; `step(*inputs)` replays it on new inputs of those shapes and
    returns the static outputs (see the module docstring)."""

    def __init__(self, fn: Callable, examples: Sequence[torch.Tensor],
                 warmup: int = 2):
        if not all(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in examples):
            raise ValueError("CapturedStep captures CUDA tensors only")
        self.device = examples[0].device
        self.inputs = [x.clone() for x in examples]
        self._pinned = {}       # input index -> its pinned host buffer
        self._staged = None     # the event after the last host copy
        before = counter_state()
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            pre, names = counter_state(), launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
        # what one replay launches, by counter and by kernel name
        self.launches = counter_delta(counter_state(), pre)
        self.kernel_launches = {k: n - names[k]
                                for k, n in launch_counts().items()
                                if n != names[k]}
        set_counters(before)
        self.replays = 0

    def __call__(self, *inputs):
        staged = False
        for i, x in enumerate(inputs):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if x.device.type == "cpu":
                if i not in self._pinned:
                    self._pinned[i] = torch.empty(
                        x.shape, dtype=x.dtype).pin_memory()
                elif self._staged is not None:
                    self._staged.synchronize()   # its last copy is done
                self._pinned[i].copy_(x)
                x, staged = self._pinned[i], True
            self.inputs[i].copy_(x, non_blocking=True)
        if staged:
            self._staged = torch.cuda.Event()
            self._staged.record()
        self.graph.replay()
        add_to_counters(self.launches)
        self.replays += 1
        return self.outputs
