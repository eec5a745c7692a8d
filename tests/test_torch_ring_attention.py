"""The port's context-parallel slice (PyTorch, gloo ranks on the CPU)
against the JAX package's.

Both packages get the same inputs, made from a seed with numpy, and the
same weights (a JAX `Transformer.init` tree mapped by
`interop.params_from_jax`). JAX runs its ring inside `shard_map` on the
8-device virtual CPU mesh with impl='xla' (what 'auto' picks on the CPU);
the port runs cp ranks as spawned processes over gloo
(`runtime/launch.spawn`, the rank programs of `runtime/cp_checks.py`).

(a) `block_attention_plain` — the plain version of the CUDA block kernels —
    against `_block_attn_xla` and the Pallas `block_attention` in interpret
    mode, forward and the (do, dlse) backward (`block_attention_bwd_plain`
    against `jax.vjp`), GQA, tq != tk and an all-dead row;
(b) `ring_attention` at cp 1, 2 and 4 (contiguous, zig-zag, shifted
    positions) and `ulysses_attention` at cp 2 against the JAX ops, outputs
    and q/k/v gradients;
(c) the model's cp=2 loss and every gradient (ring contiguous, ring
    zig-zag, Ulysses) against JAX `make_loss` at cp=2, on a batch whose
    padding falls unevenly on the two chunks, and a 5-step Adam trajectory;
(d) the train CLI at cp=2 on the CPU: it resumes from a JAX checkpoint and
    writes one that JAX and a cp=1 run read; its refusals, with the JAX
    messages.

Tolerances are stated per test; XLA-CPU and torch-CPU sum in different
orders, so f32 agreement is allclose, not bitwise.
"""

import dataclasses
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer, validate_cp as jvalidate_cp)
from distributed_pytorch_from_scratch_tpu.ops.pallas.flash_attention import (
    block_attention as jblock_attention)
from distributed_pytorch_from_scratch_tpu.ops.ring_attention import (
    _block_attn_xla, ring_attention as jring_attention,
    ulysses_attention as julysses_attention, zigzag_perm as jzigzag_perm)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, MeshConfig, ModelConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax, params_to_jax)
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.block_attention import (
    MASK, BlockAttention, block_attention_bwd, block_attention_bwd_plain,
    block_attention_fwd, block_attention_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.ring_attention import (
    block_schedule, cp_chunk_index, ring_attention, ring_schedule,
    zigzag_perm)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    cp_checks, launch)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from _torch_threads import two_torch_threads  # noqa: F401


# ---- (a) one block: plain vs the JAX block math and the Pallas kernel ----

# (b, h, hkv, tq, tk, d): GQA with tq != tk and row 0 dead; MHA, tq < tk;
# head_dim 32 (the tiny preset's) with GQA group 4
BLOCK_CASES = [(2, 4, 2, 48, 80, 16), (1, 2, 2, 33, 70, 16),
               (1, 8, 2, 40, 72, 32)]


def _block_inputs(case, seed):
    b, h, hkv, tq, tk, d = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, do = f(b, h, tq, d), f(b, hkv, tk, d), f(b, hkv, tk, d), f(
        b, h, tq, d)
    dlse = f(b, h, tq)
    qp = rng.integers(100, 500, (b, tq)).astype(np.int32)
    qp[:, 0] = 0                      # row 0 sees nothing: every kv >= 100
    kp = rng.integers(100, 500, (b, tk)).astype(np.int32)
    return q, k, v, qp, kp, do, dlse


@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_block_plain_matches_jax_block_math(case):
    q, k, v, qp, kp, do, dlse = _block_inputs(case, seed=case[3])
    scale = 1.0 / np.sqrt(case[-1])
    (jo, jlse), vjp = jax.vjp(
        lambda q, k, v: _block_attn_xla(q, k, v, qp, kp, scale), q, k, v)
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    t = [torch.from_numpy(x) for x in (q, k, v, qp, kp, do, dlse)]
    o, lse = block_attention_plain(*t[:5])
    dead = np.asarray(jlse) <= MASK / 2
    assert dead[:, :, 0].all() and not dead[:, :, 1:].all()
    # 2e-5: f32 on both sides, summed in different orders
    assert np.abs(o.numpy() - np.asarray(jo)).max() < 2e-5
    assert np.abs(np.where(dead, 0, lse.numpy() - np.asarray(jlse))).max() < 2e-5
    assert (o.numpy()[dead] == 0).all() and (lse.numpy()[dead] == MASK).all()
    grads = block_attention_bwd_plain(*t[:5], o, lse, t[5], t[6])
    for x, r in zip(grads, jgrads):
        assert x.shape == r.shape
        assert np.abs(x.numpy() - np.asarray(r)).max() < 5e-5
    # the dead row's query gets exactly no gradient
    assert (grads[0].numpy()[:, :, 0] == 0).all()


def _check_plain_against_pallas(case, seed):
    q, k, v, qp, kp, do, dlse = _block_inputs(case, seed=seed)
    (jo, jlse), vjp = jax.vjp(
        lambda q, k, v: jblock_attention(q, k, v, qp, kp), q, k, v)
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    t = [torch.from_numpy(x) for x in (q, k, v, qp, kp, do, dlse)]
    o, lse = block_attention_plain(*t[:5])
    live = np.asarray(jlse) > MASK / 2
    assert np.abs(o.numpy() - np.asarray(jo)).max() < 2e-5
    assert np.abs(np.where(live, lse.numpy() - np.asarray(jlse), 0)).max() < 2e-5
    assert (np.asarray(jlse)[~live] == MASK).all()
    grads = block_attention_bwd_plain(*t[:5], o, lse, t[5], t[6])
    for x, r in zip(grads, jgrads):
        assert np.abs(x.numpy() - np.asarray(r)).max() < 5e-5


def test_block_plain_matches_pallas_kernel_in_interpret_mode():
    _check_plain_against_pallas(BLOCK_CASES[0], seed=3)


def test_block_plain_matches_pallas_kernel_at_head_dim_32():
    """The Pallas kernel (interpret mode) at head_dim 32, where the card's
    block kernels are built too (`block_attention.HEAD_DIMS`)."""
    _check_plain_against_pallas(BLOCK_CASES[2], seed=4)


def test_block_function_on_cpu_is_plain_autograd():
    """`BlockAttention` (explicit backward formulas) against torch autograd
    through the plain forward, with both outputs used; no kernel launches on
    CPU tensors."""
    q, k, v, qp, kp, do, dlse = (torch.from_numpy(x) for x in
                                 _block_inputs(BLOCK_CASES[0], seed=5))
    counts = (block_attention_fwd.launches, block_attention_bwd.launches_dq,
              block_attention_bwd.launches_dkv)
    grads = []
    for fn in (BlockAttention.apply, block_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = fn(*leaves, qp, kp)
        live = lse > MASK / 2
        # autograd through the plain lse would see the dead rows' constant
        torch.autograd.backward([o, torch.where(live, lse, 0.0)],
                                [do, torch.where(live, dlse, 0.0)])
        grads.append([x.grad for x in leaves])
    for a, r in zip(*grads):
        assert (a - r).abs().max().item() < 1e-5
    assert counts == (block_attention_fwd.launches,
                      block_attention_bwd.launches_dq,
                      block_attention_bwd.launches_dkv)


# ---- (b) ring and Ulysses ops at cp 1, 2, 4 against JAX ----

B, H, HKV, T, D = 2, 4, 2, 32, 16


def _op_inputs(seed, shift=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1)) + shift
    return dict(q=f(B, H, T, D), k=f(B, HKV, T, D), v=f(B, HKV, T, D),
                w=f(B, H, T, D), pos=pos)


# name: (impl, layout, position shift)
OP_CASES = {"ring_contiguous": ("ring", "contiguous", 0),
            "ring_zigzag": ("ring", "zigzag", 0),
            "ring_shifted_positions": ("ring", "contiguous", 7),
            "ulysses": ("ulysses", "contiguous", 0)}
OP_RUNS = [(2, n) for n in OP_CASES] + [(4, "ring_contiguous"),
                                        (4, "ring_zigzag")]


@functools.lru_cache(maxsize=None)
def _jax_op_fn(cp, impl):
    """Jitted (q, k, v, pos, w) -> ((sum(o * w), o), (dq, dk, dv)) of JAX's
    op on a (cp, tp=1) mesh; positions and weights are arguments, so one
    program serves every case of a (cp, impl)."""
    mesh = jmake_mesh(JMeshConfig(dp=1, cp=cp, tp=1))
    spec = P(None, None, "cp", None)
    if impl == "ring":
        fn = functools.partial(jring_attention, axis="cp")
        in_specs = (spec,) * 3 + (P(None, "cp"),)
    else:
        fn = functools.partial(julysses_attention, axis="cp", impl="xla")
        in_specs = (spec,) * 3
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=spec)

    def loss(q, k, v, pos, w):
        o = sharded(*((q, k, v, pos) if impl == "ring" else (q, k, v)))
        return jnp.sum(o * w), o

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


def _jax_op(cp, impl, layout, x):
    """JAX's op output and q/k/v gradients of sum(o * w), natural order.
    Under the zig-zag layout JAX takes the permuted batch (its make_loss
    does the same) and the results are put back in order."""
    perm = jzigzag_perm(T, cp) if layout == "zigzag" else np.arange(T)
    inv = np.argsort(perm)
    (_, o), grads = _jax_op_fn(cp, impl)(
        *(jnp.asarray(x[n][:, :, perm]) for n in "qkv"), x["pos"][:, perm],
        x["w"][:, :, perm])
    return {"o": np.asarray(o)[:, :, inv],
            **{f"d{n}": np.asarray(g)[:, :, inv] for n, g in zip("qkv", grads)}}


def _assemble(per_rank, key):
    full = np.zeros((B, per_rank[0][key].shape[1], T, D), np.float32)
    for res in per_rank:
        full[:, :, res["idx"]] = res[key]
    return full


@pytest.fixture(scope="module")
def op_runs():
    """Every (cp, case) of the op tests: the port's, one spawned gloo group
    per cp (in the background), and JAX's meanwhile."""
    cases = {}
    for i, (cp, name) in enumerate(OP_RUNS):
        impl, layout, shift = OP_CASES[name]
        cases[cp, name] = dict(_op_inputs(i, shift), impl=impl, layout=layout)
    with ThreadPoolExecutor(max_workers=2) as pool:
        groups = {cp: pool.submit(launch.spawn, cp_checks.attention_grads, cp,
                                  [c for (n, _), c in cases.items() if n == cp])
                  for cp in (2, 4)}
        refs = {key: _jax_op(key[0], c["impl"], c["layout"], c)
                for key, c in cases.items()}
        results = {cp: g.result() for cp, g in groups.items()}
    runs = {}
    for cp, per_rank in results.items():
        names = [n for c, n in OP_RUNS if c == cp]
        for i, name in enumerate(names):
            runs[cp, name] = ([r[i] for r in per_rank], refs[cp, name])
    return runs


@pytest.mark.parametrize("cp,name", OP_RUNS)
def test_cp_op_matches_jax(op_runs, cp, name):
    per_rank, ref = op_runs[cp, name]
    # outputs within 1e-5 at f32; gradients within 5e-5
    for key, tol in (("o", 1e-5), ("dq", 5e-5), ("dk", 5e-5), ("dv", 5e-5)):
        got = _assemble(per_rank, key)
        assert np.abs(got - ref[key]).max() < tol, key


def test_ring_at_cp1_matches_jax_in_process():
    x = _op_inputs(9)
    mesh = make_mesh(MeshConfig(), device="cpu")
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    schedule = ring_schedule(torch.from_numpy(x["pos"]), mesh)
    o = ring_attention(q, k, v, schedule, mesh)
    o.backward(torch.from_numpy(x["w"]))
    ref = _jax_op(1, "ring", "contiguous", x)
    assert np.abs(o.detach().numpy() - ref["o"]).max() < 1e-5
    for n, leaf in zip("qkv", (q, k, v)):
        assert np.abs(leaf.grad.numpy() - ref[f"d{n}"]).max() < 5e-5


def test_zigzag_perm_and_ring_schedule():
    assert np.array_equal(zigzag_perm(16, 4), jzigzag_perm(16, 4))
    with pytest.raises(ValueError, match="divisible"):
        zigzag_perm(10, 4)
    assert np.array_equal(np.concatenate([cp_chunk_index(16, 4, r, "zigzag")
                                          for r in range(4)]),
                          jzigzag_perm(16, 4))
    # the 45m cp=2 path: 1000 positions, halves of 250
    for layout, per_rank in (("zigzag", [5, 5]), ("contiguous", [3, 7])):
        pos = np.stack([np.tile(cp_chunk_index(1000, 2, r, layout), (8, 1))
                        for r in range(2)])
        sched = block_schedule(pos)
        assert [sum(len(s) for s in r) for r in sched] == per_rank


# ---- (c) the model at cp=2 against JAX make_loss ----

SHAPE = dict(dataclasses.asdict(model_preset("tiny")), num_kv_heads=2,
             compute_dtype="float32")
MB, MT = 2, 32


def _model_batch(rng, lead=()):
    """(ids, targets, positions) int32 (lead + (MB, MT)); the padding is
    uneven: row 1's tail (the last 11 tokens) lies in the second chunk
    only, and the first chunk holds a short ignored span of row 0."""
    ids = rng.integers(3, SHAPE["vocab_size"], size=lead + (MB, MT + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, MT - 11:] = IGNORE_INDEX
    tgt[..., 0, 3:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(MT), lead + (MB, MT))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


MODEL_MODES = {"ring_contiguous": ("ring", "contiguous"),
               "ring_zigzag": ("ring", "zigzag"),
               "ulysses": ("ulysses", "contiguous")}
ADAM = dict(lr=1e-3, warmup_steps=2, max_steps=5)


@functools.lru_cache(maxsize=None)
def _jax_loss_fn(impl, layout):
    """(model, mesh, jitted value_and_grad of JAX `make_loss` at cp=2)."""
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1, cp_size=2,
                          cp_impl=impl, cp_layout=layout)
    mesh = jmake_mesh(JMeshConfig(cp=2))
    return jmodel, mesh, jax.jit(jax.value_and_grad(jmodel.make_loss(mesh)))


def _jax_trajectory(tree, steps):
    """JAX's 5 Adam steps at cp=2 (ring, zig-zag): its loss and gradient,
    then its `adam_update`, as its train step composes them."""
    jmodel, mesh, fn = _jax_loss_fn("ring", "zigzag")
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jmodel.shardings(mesh))
    state = joptim.init_adam_state(params)
    losses = []
    for i in range(5):
        loss, grads = fn(params, *(x[i] for x in steps))
        params, state = joptim.adam_update(JOptimizerConfig(**ADAM), params,
                                           grads, state)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def model_runs():
    """The port's cp=2 runs, one spawned gloo group in the background (each
    mode's loss and grads on one batch, then a 5-step trajectory, ring
    zig-zag), and JAX's meanwhile."""
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1)))
    batch = _model_batch(np.random.default_rng(1))
    steps = _model_batch(np.random.default_rng(2), lead=(5,))
    runs = [dict(impl=i, layout=l, batch=batch)
            for i, l in MODEL_MODES.values()]
    runs.append(dict(impl="ring", layout="zigzag", batch=steps, steps=5,
                     optim=ADAM))
    with ThreadPoolExecutor(max_workers=1) as pool:
        group = pool.submit(launch.spawn, cp_checks.model_runs, 2, SHAPE,
                            params_from_jax(tree), runs)
        refs = {}
        for mode, (impl, layout) in MODEL_MODES.items():
            jm, mesh, fn = _jax_loss_fn(impl, layout)
            params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                    jm.shardings(mesh))
            refs[mode] = fn(params, *batch)
            if mode == "ring_zigzag":
                refs["logits"] = jm.make_forward(mesh)(params, batch[0],
                                                       batch[2])
        refs["trajectory"] = _jax_trajectory(tree, steps)
        out = group.result()
    # every rank holds the global loss and the same summed gradients
    for a, b in zip(*out):
        assert a.get("loss") == b.get("loss")
        assert a.get("losses") == b.get("losses")
        for k, g in a.get("grads", {}).items():
            assert np.array_equal(g, b["grads"][k]), k
        if "logits" in a:
            assert np.array_equal(a["logits"], b["logits"])
    return out[0], refs


@pytest.mark.parametrize("mode", list(MODEL_MODES))
def test_cp2_loss_and_grads_match_jax(model_runs, mode):
    results, refs = model_runs
    jloss, jgrads = refs[mode]
    got = results[list(MODEL_MODES).index(mode)]
    # 1e-5 relative: f32 on both sides, summed in different orders
    assert abs(got["loss"] - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = params_to_jax({k: torch.from_numpy(g)
                           for k, g in got["grads"].items()})
    flat_p = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads):
        ref = np.asarray(ref)
        err = np.abs(np.asarray(flat_p[path]) - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (path, err)


def test_cp2_zigzag_logits_come_back_in_natural_order(model_runs):
    """`full_logits` (the JAX `make_forward`): every rank's chunk gathered
    and the zig-zag order undone, against JAX's, within 1e-5 of the
    largest |logit| (f32, summed in different orders)."""
    results, refs = model_runs
    got = results[list(MODEL_MODES).index("ring_zigzag")]["logits"]
    ref = np.asarray(refs["logits"])
    assert got.shape == ref.shape == (MB, MT, SHAPE["vocab_size"])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cp2_five_step_trajectory_matches_jax(model_runs):
    results, refs = model_runs
    # 1e-4 relative over 5 Adam steps from one init (the 10-step cp=1
    # trajectory's bound): each step's f32 rounding differs and carries on
    np.testing.assert_allclose(results[-1]["losses"], refs["trajectory"],
                               rtol=1e-4)


# ---- (d) the train CLI at cp=2 ----

TINY_FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
              "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
              "--log_interval", "2", "--device", "cpu", "--cp_size", "2",
              "--dist_backend", "gloo", "--cp_layout", "zigzag"]


def _write_corpus(path, docs=40, lo=5, hi=60, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(lo, hi, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


def test_cp2_cli_resumes_jax_checkpoint_and_writes_one(tmp_path):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    save = str(tmp_path / "ck")
    jmodel = JTransformer(JModelConfig(**dict(SHAPE, maxlen=64)), tp_size=1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(5)))
    jstate = joptim.init_adam_state(params)
    jstate = joptim.AdamState(step=np.int32(3), mu=jstate.mu, nu=jstate.nu)
    jckpt.save_checkpoint(save, 3, 6.5, params, jmodel.specs(), 1, jstate)
    out = train_cli.main(TINY_FLAGS + ["--data_path", data, "--save_dir",
                                       save, "--max_steps", "5", "--resume"])
    assert out["start_step"] == 3 and out["steps"] == 5
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert (out["cp"], out["cp_layout"], out["dist_backend"]) == (
        2, "zigzag", "gloo")
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    assert out["checkpoints"] == [c for _, c in
                                  checkpoint.list_checkpoints(save)
                                  if "iter-5_" in c]
    # the JAX loader reads the cp=2 file into the tp=1 tree, as the port does
    template = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    jparams, jst, step = jckpt.load_checkpoint(save, 5, template,
                                               jmodel.specs(), with_opt=True)
    sd, state, _ = checkpoint.load_checkpoint(save, 5, with_opt=True)
    assert step == 5 and int(jst.step) == state.step == 5
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(sd), jparams)
    # and a cp=1 run resumes from it
    flags = TINY_FLAGS[:TINY_FLAGS.index("--cp_size")]
    out1 = train_cli.main(flags + ["--data_path", data, "--save_dir", save,
                                   "--max_steps", "6", "--resume"])
    assert out1["start_step"] == 5 and out1["steps"] == 6


def _refusal(flags, tmp_path):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    return train_cli.main(["--data_path", data, "--save_dir",
                           str(tmp_path / "ck"), "--model", "tiny",
                           "--max_steps", "1"] + flags)


def test_cp_cli_refusals(tmp_path):
    with pytest.raises(SystemExit) as exc:        # no card, no --device cpu
        _refusal(["--cp_size", "2"], tmp_path)
    assert exc.value.code not in (0, None) and "no CUDA card" in str(
        exc.value.code)
    with pytest.raises(SystemExit, match="--dist_backend gloo"):
        _refusal(["--cp_size", "2", "--device", "cpu", "--dist_backend",
                  "nccl"], tmp_path)
    # the JAX package's messages
    heads = lambda kv: JModelConfig(**dict(SHAPE, num_kv_heads=kv))
    for flags, args in (
            (["--num_kv_heads", "1", "--cp_impl", "ulysses"],
             (heads(1), 1, 2, "ulysses", "contiguous")),
            (["--cp_impl", "ulysses", "--cp_layout", "zigzag"],
             (heads(None), 1, 2, "ulysses", "zigzag"))):
        with pytest.raises(ValueError) as theirs:
            jvalidate_cp(*args)
        with pytest.raises(ValueError) as ours:
            _refusal(["--cp_size", "2", "--device", "cpu"] + flags, tmp_path)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit, match="--maxlen 63 must be divisible by "
                                         "--cp_size 2"):
        _refusal(["--cp_size", "2", "--device", "cpu", "--maxlen", "63"],
                 tmp_path)
    with pytest.raises(ValueError, match="needs the Mesh"):
        Transformer(ModelConfig(**SHAPE), cp_size=2)
