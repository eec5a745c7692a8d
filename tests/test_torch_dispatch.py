"""One dispatch per step and the remat policies (PyTorch port) against the
JAX package, on the CPU.

(a) `training/memory.py`: the port's estimates and picks against the JAX
    module's over a grid of presets, shapes, meshes, ZeRO stages and
    budgets (within 1e-9, the same picks and messages);
(b) `Transformer(remat="dots")`: loss and every gradient against the JAX
    model's 'dots' (1e-5 relative), true / false / dots against each other
    (bitwise: the same ops on the same values), the activation bytes each
    keeps for the backward (true < dots < false), and the flash op's
    forward run once per layer under dots (its (o, lse) kept, not
    recomputed) and twice under true;
(c) `adam_update` from a device-tensor scalar table bitwise the
    host-scalar update;
(d) `build_train_step_multi`: N = 4 bitwise N = 1, and within 1e-5 of
    the JAX `build_train_step_multi`; the CLI's `--steps_per_dispatch`
    (tail, saves on dispatch boundaries) and every refusal of this slice.

The bitwise checks run torch on one thread: the CPU's multi-threaded
kernels do not add in a fixed order, so two runs of the same step can
differ in the last bit; on one thread they do not.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig, model_preset as jmodel_preset)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import memory as jmemory
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, ModelConfig, OptimizerConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax, params_to_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import (
    transformer as transformer_mod)
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.ops import cuda as ops_cuda
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import (
    flash_attention as flash_mod)
from distributed_pytorch_from_scratch_tpu_torch.runtime.graphs import (
    use_decode_graph)
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from distributed_pytorch_from_scratch_tpu_torch.training import memory
from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
    adam_scalars, adam_update, init_adam_state)
from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
    build_train_step, build_train_step_multi)
from _torch_threads import two_torch_threads  # noqa: F401


SHAPE = dict(dataclasses.asdict(model_preset("tiny")), num_kv_heads=2,
             compute_dtype="float32")
B, T = 2, 32


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(remat, seed=0):
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1, remat=remat)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    model = Transformer(ModelConfig(**SHAPE), remat=remat)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, tree, model


def _batch(rng, lead=()):
    """(ids, targets, positions) int32 of shape lead + (B, T); the second
    row's tail is padding (IGNORE_INDEX targets)."""
    ids = rng.integers(3, SHAPE["vocab_size"], size=lead + (B, T + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, T - 7:] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), lead + (B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


def _torch(arrays):
    return [torch.from_numpy(a).long() for a in arrays]


# ------------------------------------------------------ (a) memory.py

MEMORY_GRID = [  # (preset, batch, seqlen, tp, world, zero stage, dp)
    ("45m", 32, 1000, 1, 1, 0, 1), ("45m", 8, 1000, 2, 2, 0, 1),
    ("45m", 32, 1000, 2, 8, 1, 4), ("45m", 32, 1000, 1, 8, 2, 8),
    ("45m", 32, 1000, 1, 8, 3, 8), ("gpt2-124m", 8, 1024, 1, 1, 0, 1),
    ("gpt2-355m", 16, 1024, 4, 8, 1, 2), ("45m-moe8", 32, 1000, 1, 2, 0, 2),
    ("tiny", 4, 256, 1, 1, 0, 1)]


@pytest.mark.parametrize("case", MEMORY_GRID,
                         ids=lambda c: "-".join(map(str, c)))
def test_memory_estimates_and_picks_match_jax(case, capsys):
    name, b, t, tp, world, zero, dp = case
    cfg, jcfg = model_preset(name), jmodel_preset(name)
    for policy in ("false", "dots", "true"):
        ours = memory.estimate_step_gib(cfg, b, t, policy, tp=tp,
                                        world=world, zero_stage=zero, dp=dp)
        theirs = jmemory.estimate_step_gib(jcfg, b, t, policy, tp=tp,
                                           world=world, zero_stage=zero,
                                           dp=dp)
        assert abs(ours - theirs) <= 1e-9 * max(theirs, 1.0)
    assert (memory.zero_state_bytes_per_param(zero, dp, cfg)
            == jmemory.zero_state_bytes_per_param(zero, dp, jcfg))
    for budget in (0.1, 2.0, 10.0, 16.0, 80.0, 1e9):
        kw = dict(tp=tp, world=world, budget_gib=budget, zero_stage=zero,
                  dp=dp)
        pick = memory.select_remat(cfg, b, t, **kw)
        ours = capsys.readouterr().err
        assert pick == jmemory.select_remat(jcfg, b, t, **kw)
        assert ours == capsys.readouterr().err      # the same message


def test_memory_refusals_and_budget_on_cpu(capsys):
    for mod, cfg in ((memory, model_preset("45m")),
                     (jmemory, jmodel_preset("45m"))):
        with pytest.raises(ValueError, match="remat must be one of"):
            mod.estimate_step_gib(cfg, 32, 1000, "sometimes")
    # no card: JAX's v5e default, said once
    memory._warned_assumed_budget.clear()
    assert memory.hbm_budget_gib() == 16.0
    assert memory.hbm_budget_gib(device="cpu") == 16.0
    err = capsys.readouterr().err
    assert err.count("HBM budget UNAVAILABLE, assuming 16 GiB") == 1
    # the validated picks of the JAX tests (test_attribution.py)
    assert memory.select_remat(model_preset("45m"), 32, 1000,
                               budget_gib=16.0, verbose=False) == "false"
    assert memory.select_remat(model_preset("45m"), 32, 1000, budget_gib=1e9,
                               verbose=False, zero_stage=3, dp=8) == "dots"


# ------------------------------------------------------ (b) remat='dots'


def test_dots_loss_and_grads_match_jax():
    jmodel, tree, model = _models(remat="dots", seed=1)
    ids, tgt, pos = _batch(np.random.default_rng(1))
    mesh = jmake_mesh(JMeshConfig(tp=1))
    jloss, jgrads = jax.value_and_grad(jmodel.make_loss(mesh))(
        tree, ids, tgt, pos)
    loss = model.loss(*_torch((ids, tgt, pos)))
    loss.backward()
    # 1e-5 relative: f32 on both sides, summed in different orders
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads):
        ref = np.asarray(ref)
        err = np.abs(np.asarray(flat[path]) - ref).max()
        assert err <= 1e-5 * max(np.abs(ref).max(), 1e-30), (path, err)


class _AliveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The bytes of the storages that ops made under the mode and that are
    still alive: after a forward, what it keeps for the backward (the
    checkpoint's and the selective policy's own stores included, which an
    outer `saved_tensors_hooks` does not see)."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef
        out = func(*args, **(kwargs or {}))
        for x in torch.utils._pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                self.made[st._cdata] = (StorageWeakRef(st), st.nbytes())
        return out

    def alive(self) -> int:
        return sum(n for ref, n in self.made.values() if not ref.expired())


def test_remat_policies_agree_and_keep_what_they_say(one_thread):
    ids, tgt, pos = _torch(_batch(np.random.default_rng(2)))
    res = {}
    for remat in (True, "dots", False):
        _, _, model = _models(remat=remat, seed=2)
        with _AliveBytes() as mode:
            loss = model.loss(ids, tgt, pos)
        kept = mode.alive()
        loss.backward()
        res[remat] = (loss, {k: p.grad for k, p in model.named_parameters()},
                      kept)
    loss, grads, _ = res[True]
    for remat in ("dots", False):
        assert torch.equal(res[remat][0], loss)
        for k, g in grads.items():
            assert torch.equal(res[remat][1][k], g), (remat, k)
    assert res[True][2] < res["dots"][2] < res[False][2], {
        k: v[2] for k, v in res.items()}


def test_dots_keeps_the_flash_op_outputs(monkeypatch):
    """The card's attention is the `flash_attention` op (on CPU tensors its
    plain version): under dots its forward runs once per layer, its (o,
    lse) kept by the policy, as under false; under true twice (the
    recompute). The gradients are the plain attention's."""
    calls = []
    plain = flash_mod.flash_attention_fwd_plain
    monkeypatch.setattr(flash_mod, "flash_attention_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    ids, tgt, pos = _torch(_batch(np.random.default_rng(3)))
    _, _, ref = _models(remat=True, seed=3)
    ref.loss(ids, tgt, pos).backward()
    monkeypatch.setattr(transformer_mod, "causal_attention",
                        lambda q, k, v: flash_mod.flash_attention(
                            q.contiguous(), k.contiguous(),
                            v.contiguous())[0])
    layers = SHAPE["num_layers"]
    for remat, runs in ((True, 2), ("dots", 1), (False, 1)):
        _, _, model = _models(remat=remat, seed=3)
        calls.clear()
        model.loss(ids, tgt, pos).backward()
        assert len(calls) == runs * layers, remat
        for k, p in model.named_parameters():
            g = dict(ref.named_parameters())[k].grad
            assert (p.grad - g).abs().max() <= 1e-5 * g.abs().max(), k


def test_remat_refusals():
    # the JAX constructor's: 'auto' is the CLI's to resolve
    for policy in ("auto", "sometimes", None):
        with pytest.raises(ValueError, match="remat must be True, False or "
                                             "'dots'"):
            Transformer(ModelConfig(**SHAPE), remat=policy)
        with pytest.raises(ValueError, match="remat must be True, False or "
                                             "'dots'"):
            JTransformer(JModelConfig(**SHAPE), remat=policy)


# ------------------------------------------------------ (c) Adam scalars

ADAM_CFGS = {
    "onecycle": dict(lr=1e-2, warmup_steps=2, max_steps=5, clip_grad_norm=0.5,
                     weight_decay=0.1),
    "cosine": dict(lr=1e-2, warmup_steps=2, max_steps=5, lr_schedule="cosine",
                   clip_grad_norm=0.5, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(ADAM_CFGS))
def test_adam_device_scalars_bitwise_host(name, one_thread):
    cfg = OptimizerConfig(**ADAM_CFGS[name])
    rng = np.random.default_rng(4)
    shapes = {"w": (64, 33), "b": (33,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    host = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    dev = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    sh, sd = init_adam_state(host), init_adam_state(dev)
    for _ in range(5):
        grads = {k: torch.from_numpy(rng.standard_normal(s)
                                     .astype(np.float32))
                 for k, s in shapes.items()}
        sh = adam_update(cfg, host, grads, sh)
        sd = adam_update(cfg, dev, grads, sd, scalars=torch.from_numpy(
            adam_scalars(cfg, sd.step)))
        assert sh.step == sd.step
        for ours, theirs in ((dev, host), (sd.mu, sh.mu), (sd.nu, sh.nu)):
            for k in shapes:
                assert torch.equal(ours[k], theirs[k]), k


# ------------------------------------------------------ (d) N per dispatch


def test_multi_step_bitwise_single_and_close_to_jax(one_thread):
    kw = dict(lr=1e-3, warmup_steps=2, max_steps=8)
    ids, tgt, pos = _batch(np.random.default_rng(5), (8,))
    runs = {}
    for n in (1, 4):
        _, tree, model = _models(remat=True, seed=5)
        state = init_adam_state(dict(model.named_parameters()))
        if n == 1:
            step = build_train_step(model, OptimizerConfig(**kw))
            losses = []
            for i in range(8):
                loss, _, state = step(state, *_torch((ids[i], tgt[i],
                                                      pos[i])))
                losses.append(loss)
            losses = torch.stack(losses)
        else:
            step = build_train_step_multi(model, OptimizerConfig(**kw))
            losses = []
            for j in (0, 4):
                loss, _, state = step(state, *_torch((
                    ids[j:j + 4], tgt[j:j + 4], pos[j:j + 4])))
                losses.append(loss)
            losses = torch.cat(losses)
        runs[n] = (losses, dict(model.named_parameters()), state)
    (l1, p1, s1), (l4, p4, s4) = runs[1], runs[4]
    assert s4.step == s1.step == 8
    assert torch.equal(l4, l1)
    for k in p1:
        assert torch.equal(p4[k], p1[k]) and torch.equal(s4.nu[k], s1.nu[k])
    # the JAX scanned program, two dispatches of 4
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1, remat=True)
    mesh = jmake_mesh(JMeshConfig(tp=1))
    jparams = jax.device_put(jax.tree.map(jnp.asarray, tree),
                             jmodel.shardings(mesh))
    jstate = joptim.init_adam_state(jparams)
    jstep = jtrain_step.build_train_step_multi(jmodel, mesh,
                                               JOptimizerConfig(**kw))
    jlosses = []
    for j in (0, 4):
        jparams, jstate, jl = jstep(jparams, jstate, ids[j:j + 4],
                                    tgt[j:j + 4], pos[j:j + 4])
        jlosses.extend(np.asarray(jl).tolist())
    np.testing.assert_allclose(l4.numpy(), jlosses, rtol=1e-5)


def _write_corpus(path, docs=40, lo=5, hi=60, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(lo, hi, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


TINY_FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
              "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
              "--log_interval", "2", "--device", "cpu", "--max_steps", "10",
              "--save_interval", "3"]


def test_cli_steps_per_dispatch_matches_single(tmp_path, one_thread):
    """N = 4 over 10 steps: dispatches of 4, 4 and 2 (the tail shrinks to
    max_steps), the losses of N = 1 bit for bit, and saves where a
    dispatch crosses a save interval (as the JAX
    tests/test_multi_step.py)."""
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    runs = {n: train_cli.main(TINY_FLAGS + [
        "--data_path", data, "--save_dir", str(tmp_path / f"ck{n}"),
        "--steps_per_dispatch", str(n)]) for n in (1, 4)}
    assert runs[1]["steps"] == runs[4]["steps"] == 10
    assert runs[4]["steps_per_dispatch"] == 4
    assert runs[4]["losses"] == runs[1]["losses"]
    steps = lambda n: [s for s, _ in checkpoint.list_checkpoints(
        str(tmp_path / f"ck{n}"))]
    assert steps(1) == [3, 6, 9, 10] and steps(4) == [4, 8, 10]
    sd1, _, _ = checkpoint.load_checkpoint(str(tmp_path / "ck1"), 10)
    sd4, _, _ = checkpoint.load_checkpoint(str(tmp_path / "ck4"), 10)
    assert all(torch.equal(sd4[k], v) for k, v in sd1.items())


def test_cli_remat_auto_resolves(tmp_path, capsys):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    out = train_cli.main(TINY_FLAGS + ["--data_path", data, "--save_dir",
                                       str(tmp_path / "ck"), "--max_steps",
                                       "2", "--remat", "auto"])
    # no card: the 16 GiB assumption, against which the tiny model fits
    assert out["remat"] == "false" and len(out["losses"]) == 2
    assert "remat auto: picked 'false'" in capsys.readouterr().err


def test_dispatch_refusals(tmp_path, capsys):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    base = ["--data_path", data, "--save_dir", str(tmp_path / "ck"),
            "--model", "tiny", "--max_steps", "1", "--device", "cpu"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_cli.main(base + ["--steps_per_dispatch", "2", "--grad_accum",
                               "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        train_cli.main(base + ["--steps_per_dispatch", "2", "--tp_size",
                               "2", "--dist_backend", "gloo"])
    for device, tp in (("cpu", "1"), ("cuda", "2")):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--dry_run", "--device", device, "--tp_size", tp,
                        "--decode_graph", "on"])
        assert exc.value.code == 2
        assert "decode_graph 'on' needs tp=1 on a CUDA card" in \
            capsys.readouterr().err
    assert use_decode_graph("auto", "cuda", 1)
    assert not use_decode_graph("auto", "cuda", 2)
    assert not use_decode_graph("auto", "cpu", 1)
    assert not use_decode_graph("off", "cuda", 1)
    with pytest.raises(ValueError, match="decode_graph must be one of"):
        use_decode_graph("always", "cuda", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        build_train_step_multi(SimpleNamespace(mesh=SimpleNamespace(
            world=2)), OptimizerConfig())


def test_launch_counter_arithmetic():
    """What the graph runner does to the counters (CPU: the arithmetic
    only): a delta of ints and dicts, added k times, then put back."""
    saved = ops_cuda.counter_state()
    try:
        pa = flash_mod.flash_attention_fwd
        from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import (
            paged_attention as paged_mod)
        before = ops_cuda.counter_state()
        pa.launches += 2
        paged_mod.paged_attention.launches_by_route["decode"] += 12
        delta = ops_cuda.counter_delta(ops_cuda.counter_state(), before)
        ops_cuda.set_counters(before)
        assert ops_cuda.counter_state() == before
        ops_cuda.add_to_counters(delta, times=3)
        after = ops_cuda.launch_counts()
        assert after["flash_attention_fwd"] == before[0] + 6
        assert (paged_mod.paged_attention.launches_by_route["decode"]
                == before[4]["decode"] + 36)
    finally:
        ops_cuda.set_counters(saved)
