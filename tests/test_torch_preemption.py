"""The port's preemption-safe training loop (the JAX `tests/test_preemption.py`
on the port's CLI), at the tiny preset in float32 on the CPU.

* SIGTERM to a `--device cpu` training process after its first step line:
  it exits 0, prints `shutdown requested: checkpointed at step N`, and
  `--resume` from that checkpoint continues to N + 2.
* The same at tp = 2 over gloo, the signal sent to the launching process
  only (it forwards it to both ranks): exit 0, and both tp rank files hold
  the same step.
* A run stopped at step 2 by the shutdown flag and resumed to step 4 ends
  with the parameters of 4 uninterrupted steps (within 1e-6).
* With no signal the loop is what it was: the prefetch thread and the
  asynchronous saves give the losses, parameters and files of a loop that
  collates inline and saves synchronously, bit for bit.
"""

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from _torch_threads import two_torch_threads  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
         "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import json
    path = tmp_path_factory.mktemp("preempt") / "tokens.json"
    rng = np.random.default_rng(0)
    train = [rng.integers(3, 1024, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=200)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": 1024}, f)
    return str(path)


def _signalled_run(args):
    """Start the train CLI, SIGTERM it after its first `step` line; returns
    (exit code, its output)."""
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pytorch_from_scratch_tpu_torch"
         ".train", *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env=env, cwd=ROOT)
    lines, seen = [], threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step "):
                seen.set()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        assert seen.wait(timeout=120), "no step within 120 s:\n" + "".join(
            lines)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
    t.join(timeout=10)
    return rc, "".join(lines)


def _args(corpus, save_dir, extra=()):
    return FLAGS + ["--data_path", corpus, "--save_dir", save_dir,
                    "--log_interval", "1", "--save_interval", "100000",
                    *extra]


def test_sigterm_checkpoints_and_resumes(corpus, tmp_path):
    save = str(tmp_path / "ck")
    rc, out = _signalled_run(_args(corpus, save, ["--max_steps", "100000"]))
    assert rc == 0, out
    assert "shutdown requested: checkpointed at step" in out, out
    stopped = checkpoint.latest_step(save)
    assert stopped is not None and stopped >= 1
    assert f"checkpointed at step {stopped};" in out
    resumed = subprocess.run(
        [sys.executable, "-m", "distributed_pytorch_from_scratch_tpu_torch"
         ".train", *_args(corpus, save, ["--max_steps", str(stopped + 2),
                                         "--resume"])],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert f"resumed from iter {stopped}" in resumed.stdout
    assert f"training finished at step {stopped + 2}" in resumed.stdout


def test_sigterm_at_tp2_checkpoints_every_rank(corpus, tmp_path):
    save = str(tmp_path / "ck")
    rc, out = _signalled_run(_args(corpus, save, [
        "--max_steps", "100000", "--tp_size", "2", "--dist_backend",
        "gloo"]))
    assert rc == 0, out
    assert "shutdown requested: checkpointed at step" in out, out
    steps = [checkpoint.list_checkpoints(save, r) for r in (0, 1)]
    assert len(steps[0]) == len(steps[1]) == 1, steps
    assert steps[0][0][0] == steps[1][0][0] >= 1


class _FlagAfter(train_cli._ShutdownFlag):
    """A shutdown flag that turns on at its third read, as if a signal came
    after the second step."""

    reads = 0

    @property
    def requested(self):
        type(self).reads += 1
        return type(self).reads > 2

    @requested.setter
    def requested(self, value):
        pass


def _final(save, step):
    sd, st, n = checkpoint.load_checkpoint(save, step, with_opt=True)
    assert n == step
    return sd, st


def test_resumed_run_equals_uninterrupted(corpus, tmp_path, monkeypatch):
    base = FLAGS + ["--data_path", corpus, "--log_interval", "1",
                    "--save_interval", "100000", "--max_steps", "4"]
    whole = train_cli.main(base + ["--save_dir", str(tmp_path / "whole")])
    _FlagAfter.reads = 0
    monkeypatch.setattr(train_cli, "_ShutdownFlag", _FlagAfter)
    stopped = train_cli.main(base + ["--save_dir", str(tmp_path / "cut")])
    monkeypatch.undo()
    assert stopped["shutdown"] and stopped["steps"] == 2
    resumed = train_cli.main(base + ["--save_dir", str(tmp_path / "cut"),
                                     "--resume"])
    assert resumed["start_step"] == 2 and resumed["steps"] == 4
    np.testing.assert_allclose(stopped["losses"] + resumed["losses"],
                               whole["losses"], rtol=1e-6)
    (a, sa), (b, sb) = _final(str(tmp_path / "whole"), 4), _final(
        str(tmp_path / "cut"), 4)
    for k in a:
        assert (a[k] - b[k]).abs().max().item() <= 1e-6, k
        assert (sa.mu[k] - sb.mu[k]).abs().max().item() <= 1e-6, k


class _InlineWindows:
    """The prefetcher's interface with no thread: the transform runs in
    the loop."""

    def __init__(self, src, depth=2, transform=None):
        self._it = (transform(x) for x in src)
        self.wait_time = 0.0

    def __iter__(self):
        return self._it

    def close(self):
        pass


def test_prefetch_and_async_saves_change_nothing(corpus, tmp_path,
                                                 monkeypatch):
    base = FLAGS + ["--data_path", corpus, "--log_interval", "2",
                    "--save_interval", "3", "--max_steps", "7",
                    "--grad_accum", "2"]
    save = checkpoint.save_checkpoint
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # sums in a fixed order: bitwise runs
    try:
        ours = train_cli.main(base + ["--save_dir", str(tmp_path / "ours")])
        monkeypatch.setattr(train_cli, "Prefetcher", _InlineWindows)
        monkeypatch.setattr(train_cli, "save_checkpoint",
                            lambda *a, async_write=False, **k: _Joined(
                                save(*a, **k), a[1]))
        plain = train_cli.main(base + ["--save_dir",
                                       str(tmp_path / "plain")])
    finally:
        torch.set_num_threads(threads)
    assert ours["losses"] == plain["losses"]
    names = lambda s: [os.path.basename(p) for p in s["checkpoints"]]
    assert names(ours) == names(plain) and len(names(ours)) == 3
    for name in names(ours):
        with np.load(str(tmp_path / "ours" / name)) as a, \
                np.load(str(tmp_path / "plain" / name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Joined:
    """A synchronous save's paths behind the async handle's interface."""

    def __init__(self, paths, step):
        self.paths, self.step = paths, step

    def join(self):
        return self.paths
