"""The port's training slice (PyTorch) against the JAX package's.

Both packages get the same inputs, made from a seed with numpy, and the
same weights (a JAX `Transformer.init` tree mapped by
`interop.params_from_jax`):

(a) `flash_attention_bwd_plain` — the plain version of the CUDA backward
    kernels — against `jax.grad` of the Pallas `flash_attention` run in
    interpret mode, including the split dq/dkv kernels (t = 300, 128-row
    backward blocks); 1e-5 at f32;
(b) the `flash_attention` op with its gradient on CPU tensors against
    torch autograd through `causal_attention_plain`;
(c) the model's loss and every parameter gradient against
    `jax.value_and_grad(model.make_loss(mesh))`, with and without remat;
(d) `adam_update` against the JAX one over 5 steps (OneCycle, cosine,
    clipping, weight decay);
(e) a 10-step loss trajectory of `build_train_step` and
    `build_grad_accum_step` against the JAX builders;
(f) the data loaders' batches, byte for byte, against the JAX numpy
    backend;
(g) the train CLI on the CPU: its checkpoint reads back in JAX, the port's
    serve CLI loads it, a JAX checkpoint resumes in the port, and with no
    card and no `--device cpu` it exits non-zero.

Tolerances are stated per test; XLA-CPU and torch-CPU sum in different
orders, so f32 agreement is allclose, not bitwise.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig)
from distributed_pytorch_from_scratch_tpu.data import dataset as jdataset
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops.pallas.flash_attention import (
    flash_attention)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, ModelConfig, OptimizerConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.data import dataset
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    adam_state_from_jax, adam_state_to_jax, params_from_jax, params_to_jax)
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.ops.attention import (
    causal_attention, causal_attention_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    flash_attention as flash_attention_op)
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
    adam_update, init_adam_state)
from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
    build_grad_accum_step, build_train_step)
from _torch_threads import two_torch_threads  # noqa: F401


# the tiny preset with grouped-query attention (2 kv heads), so the
# model-level tests also cover the GQA backward
SHAPE = dict(dataclasses.asdict(model_preset("tiny")), num_kv_heads=2,
             compute_dtype="float32")
B, T = 2, 32


def _attn_inputs(b, h, hkv, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, t, d)).astype(np.float32)
            for n in (h, hkv, hkv, h)]


def _models(remat=True, seed=0):
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1, remat=remat)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    model = Transformer(ModelConfig(**SHAPE), remat=remat)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, tree, model


def _batch(rng, lead=()):
    """(ids, targets, positions) int32 arrays of shape lead + (B, T); the
    second row's tail is padding (IGNORE_INDEX targets)."""
    ids = rng.integers(3, SHAPE["vocab_size"], size=lead + (B, T + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, T - 7:] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), lead + (B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


def _torch(arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def _assert_trees_close(port_tree, jax_tree, rtol):
    """Every leaf: max |port - jax| <= rtol * max |jax leaf|."""
    flat_p = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    flat_j = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(flat_p) == len(flat_j)
    for path, ref in flat_j:
        ref = np.asarray(ref)
        err = np.abs(np.asarray(flat_p[path]) - ref).max()
        assert err <= rtol * max(np.abs(ref).max(), 1e-30), (path, err)


# (b, h, hkv, t, d, t_real, bwd blocks): MHA; GQA with pad rows; t = 77;
# t = 300 with 128-row backward blocks (the TPU's split dq/dkv kernels)
BWD_CASES = [(2, 4, 4, 128, 32, None, None), (1, 4, 2, 200, 32, 150, None),
             (2, 2, 1, 77, 64, None, None), (1, 2, 2, 300, 64, None, 128)]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_bwd_plain_matches_jax_grad(case):
    b, h, hkv, t, d, t_real, blk = case
    q, k, v, do = _attn_inputs(b, h, hkv, t, d, seed=t)
    blocks = {} if blk is None else dict(bwd_block_q=blk, bwd_block_k=blk)
    ref = jax.grad(lambda q, k, v: jnp.vdot(
        flash_attention(q, k, v, t_real=t_real, **blocks), do),
        (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, t_real=t_real)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, t_real=t_real)
    for x, r in zip(got, ref):
        assert x.dtype == torch.float32 and x.shape == r.shape
        assert np.abs(x.numpy() - np.asarray(r)).max() < 1e-5
    if t_real is not None:
        # pad rows and pad keys: exact-zero gradients in both packages
        for x, r in zip(got, ref):
            assert (x[:, :, t_real:] == 0).all()
            assert (np.asarray(r)[:, :, t_real:] == 0).all()


def test_flash_function_on_cpu_is_plain_autograd():
    q, k, v, do = (torch.from_numpy(x)
                   for x in _attn_inputs(1, 4, 2, 96, 32, seed=4))
    grads = []
    for fn in (lambda *a: flash_attention_op(*a, 70)[0],
               lambda *a: causal_attention_plain(*a, t_real=70)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        grads.append([out.detach()] + [x.grad for x in leaves])
    for a, r in zip(*grads):
        assert (a - r).abs().max().item() < 1e-5
    # on CPU tensors no wrapper launches a kernel
    launches = (flash_attention_fwd.launches,
                flash_attention_bwd.launches_dq,
                flash_attention_bwd.launches_dkv)
    flash_attention_bwd(q, k, v, *flash_attention_fwd(q, k, v), do)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    causal_attention(*leaves).sum().backward()
    assert launches == (flash_attention_fwd.launches,
                        flash_attention_bwd.launches_dq,
                        flash_attention_bwd.launches_dkv)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(remat):
    jmodel, tree, model = _models(remat=remat, seed=1)
    ids, tgt, pos = _batch(np.random.default_rng(1))
    mesh = jmake_mesh(JMeshConfig(tp=1))
    jloss, jgrads = jax.value_and_grad(jmodel.make_loss(mesh))(
        tree, ids, tgt, pos)
    loss = model.loss(*_torch((ids, tgt, pos)))
    loss.backward()
    # 1e-5 relative: f32 on both sides, summed in different orders
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(grads, jgrads, rtol=1e-5)
    # the 'gather' name computes the same value at tp=1
    assert torch.equal(model.loss(*_torch((ids, tgt, pos)), mode="gather"),
                       model.loss(*_torch((ids, tgt, pos))))


def test_remat_policies_refused():
    # the JAX constructor's contract: True, False or 'dots'; 'auto' is the
    # CLI's to resolve
    for policy in ("auto", "sometimes"):
        with pytest.raises(ValueError, match="remat must be True, False or "
                                             "'dots'"):
            Transformer(ModelConfig(**SHAPE), remat=policy)


ADAM_CFGS = {
    "onecycle": dict(lr=1e-2, warmup_steps=2, max_steps=5),
    "cosine": dict(lr=1e-2, warmup_steps=2, max_steps=5,
                   lr_schedule="cosine"),
    "clip_wd": dict(lr=1e-2, warmup_steps=1, max_steps=5, clip_grad_norm=0.5,
                    weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(ADAM_CFGS))
def test_adam_update_matches_jax(name):
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = joptim.init_adam_state(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = init_adam_state(tparams)
    jcfg = JOptimizerConfig(**ADAM_CFGS[name])
    cfg = OptimizerConfig(**ADAM_CFGS[name])
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate = joptim.adam_update(jcfg, jparams, grads, jstate)
        state = adam_update(cfg, tparams,
                            {k: torch.from_numpy(g) for k, g in grads.items()},
                            state)
        assert state.step == int(jstate.step)
        for ours, theirs in ((tparams, jparams), (state.mu, jstate.mu),
                             (state.nu, jstate.nu)):
            for k in shapes:
                np.testing.assert_allclose(ours[k].numpy(),
                                           np.asarray(theirs[k]),
                                           rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_ten_step_trajectory_matches_jax(accum):
    jmodel, tree, model = _models(seed=3)
    mesh = jmake_mesh(JMeshConfig(tp=1))
    kw = dict(lr=1e-3, warmup_steps=2, max_steps=10)
    lead = (10,) if accum == 1 else (10, accum)
    ids, tgt, pos = _batch(np.random.default_rng(3), lead)
    jbuild = (jtrain_step.build_train_step if accum == 1
              else jtrain_step.build_grad_accum_step)
    jstep = jbuild(jmodel, mesh, JOptimizerConfig(**kw), with_grad_norm=True)
    jparams = jax.device_put(jax.tree.map(jnp.asarray, tree),
                             jmodel.shardings(mesh))
    jstate = joptim.init_adam_state(jparams)
    build = build_train_step if accum == 1 else build_grad_accum_step
    step = build(model, OptimizerConfig(**kw))
    state = init_adam_state(dict(model.named_parameters()))
    jlosses, losses = [], []
    for i in range(10):
        jparams, jstate, (jl, jg) = jstep(jparams, jstate, ids[i], tgt[i],
                                          pos[i])
        loss, gnorm, state = step(state, *_torch((ids[i], tgt[i], pos[i])))
        jlosses.append(float(jl))
        losses.append(loss.item())
        assert abs(gnorm.item() - float(jg)) <= 1e-4 * float(jg)
    # 1e-4 relative over 10 Adam steps from one init: each step's f32
    # rounding differs between the frameworks and Adam carries it forward
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == int(jstate.step) == 10


def _write_corpus(path, docs=40, lo=5, hi=60, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(lo, hi, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


@pytest.mark.parametrize("mode", ["docs", "packed"])
def test_data_loaders_byte_identical_to_jax(tmp_path, mode):
    path = str(tmp_path / "tokens.json")
    _write_corpus(path)
    kw = dict(batch_size=4, maxlen=32, seed=7, data_mode=mode)
    if mode == "docs":
        kw["backend"] = "numpy"
    ours = dataset.get_dataloader(path, **kw)
    theirs = jdataset.get_dataloader(path, **kw)
    assert len(ours) == len(theirs) > 0
    for epoch in (0, 1):
        pairs = list(zip(ours.epoch(epoch), theirs.epoch(epoch)))
        assert len(pairs) == len(theirs)
        for a, b in pairs:
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key]), (epoch, key)
    if mode == "docs":
        # the native C++ collate gives the numpy path's bytes
        native = dataset.get_dataloader(path, **dict(kw, backend="native"))
        for a, b in zip(native.epoch(1), theirs.epoch(1)):
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key]), key


TINY_FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
              "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
              "--log_interval", "2", "--device", "cpu"]


def test_checkpoint_writer_reads_back_in_jax(tmp_path):
    jmodel, tree, model = _models(seed=4)
    rng = np.random.default_rng(4)
    moment = lambda: jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    state = adam_state_from_jax(joptim.AdamState(step=np.int32(7),
                                                 mu=moment(), nu=moment()))
    paths = checkpoint.save_checkpoint(str(tmp_path), 7, 1.5,
                                       model.state_dict(), state)
    assert paths == [str(tmp_path / "tprank-0_iter-7_loss-1.5000.npz")]
    params, jstate, step = jckpt.load_checkpoint(
        str(tmp_path), 7, tree, jmodel.specs(), with_opt=True)
    assert step == 7 and int(jstate.step) == 7
    back = adam_state_to_jax(state)
    for ours, theirs in ((tree, params), (back["mu"], jstate.mu),
                         (back["nu"], jstate.nu)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                     ours, theirs)
    # and the port reads its own file back to the same state
    sd, st, n = checkpoint.load_checkpoint(str(tmp_path), 7, with_opt=True)
    assert n == st.step == 7
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    assert all(torch.equal(st.mu[k], state.mu[k]) for k in state.mu)
    checkpoint.prune_checkpoints(str(tmp_path), 1)
    assert checkpoint.latest_step(str(tmp_path)) == 7


def test_train_cli_checkpoint_round_trips(tmp_path):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    save = str(tmp_path / "ck")
    out = train_cli.main(TINY_FLAGS + ["--data_path", data, "--save_dir", save,
                                       "--max_steps", "3",
                                       "--save_interval", "2"])
    assert out["steps"] == 3 and out["start_step"] == 0
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["device"] == "cpu" and out["mfu"] is None
    assert [s for s, _ in checkpoint.list_checkpoints(save)] == [2, 3]
    # the JAX loader reads the port's file into the JAX model's tree
    jmodel = JTransformer(JModelConfig(**dict(SHAPE, maxlen=64)), tp_size=1)
    template = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    params, jstate, step = jckpt.load_checkpoint(
        save, 3, template, jmodel.specs(), with_opt=True)
    sd, state, _ = checkpoint.load_checkpoint(save, 3, with_opt=True)
    assert step == 3 and int(jstate.step) == state.step == 3
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(sd), params)
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(state.nu),
                 jstate.nu)
    # the port's serve CLI serves it
    served = serve.main(["--ckpt_dir", save, "--model", "tiny",
                         "--num_kv_heads", "2", "--maxlen", "64",
                         "--vocab_size", "1024", "--no-bf16", "--device",
                         "cpu", "--num_requests", "2", "--arrival", "burst",
                         "--max_new_tokens", "3", "--prompt_len_max", "8"])
    assert served["completed"] == 2


def test_jax_checkpoint_resumes_in_port(tmp_path):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    jmodel = JTransformer(JModelConfig(**dict(SHAPE, maxlen=64)), tp_size=1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(5)))
    jstate = joptim.init_adam_state(params)
    jstate = joptim.AdamState(step=np.int32(3), mu=jstate.mu, nu=jstate.nu)
    jckpt.save_checkpoint(str(tmp_path), 3, 6.5, params, jmodel.specs(), 1,
                          jstate)
    out = train_cli.main(TINY_FLAGS + ["--data_path", data, "--save_dir",
                                       str(tmp_path), "--max_steps", "4",
                                       "--resume"])
    assert out["start_step"] == 3 and out["steps"] == 4
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])


def test_train_cli_refusals(tmp_path):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    base = ["--data_path", data, "--save_dir", str(tmp_path / "ck"),
            "--model", "tiny", "--max_steps", "1"]
    with pytest.raises(SystemExit) as exc:   # no card, no --device cpu
        train_cli.main(base)
    assert exc.value.code not in (0, None)
    for flags in (["--seq_bucket", "128"], ["--no_trace"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_cli.main(base + ["--device", "cpu"] + flags)
    # the ring is ported: without --sequence_parallel it is refused in
    # JAX's words (tests/test_torch_overlap.py holds the message)
    with pytest.raises(ValueError, match="requires sequence_parallel"):
        train_cli.main(base + ["--device", "cpu", "--tp_overlap", "ring"])
