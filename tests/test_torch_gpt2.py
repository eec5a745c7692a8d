"""The port's gpt2 family (`models/gpt2.py`, the generic decode lowerings,
the engines and CLIs at `--family gpt2`) against the JAX package's
`GPT2Transformer`, on the CPU, at the tiny preset's widths (d 128, 4
heads, 2 layers, vocab 1024; 1023 where tp must pad it) in float32.

Both packages get the same weights (a JAX `init` tree, through
`interop.params_from_jax`) and the same numpy-seeded inputs. The port's
2-rank runs (tp 2, dp 2, cp 2) share one spawned gloo group
(`runtime/tp_checks.py`), in the background while JAX computes; JAX runs
on the virtual CPU devices, compiled once per mesh.

(a) LayerNorm against JAX's, and the forward logits within 1e-5;
(b) the loss within 1e-5 and every gradient within rtol 1e-4 at (dp, cp,
    tp) in (1,1,1), (1,1,2) (SP off and on, vocab 1023 padded to 1024),
    (2,1,1) and (1,2,1) (ring, zig-zag) against `make_loss` on the same
    mesh; the tied embedding takes both gradients; a tp 2 model from a
    seed is the tp 1 model from it;
(c) 5 clipped Adam steps at tp 1 and at tp 2 with SP within 1e-4 of JAX's
    `build_train_step`;
(d) checkpoints both ways at tp 1 and tp 2 (JAX writes, the port reads at
    either tp; the port writes, JAX reads the global tree), the .pth
    bridge refusing the family by name, and the train CLI at `--family
    gpt2` (its MFU counting N from the real parameters);
(e) `_prefill`, `_decode_one` and `_paged_decode_one` logits within 1e-4
    of JAX's at tp 1 and tp 2; greedy tokens through the slot engine and
    the paged engine (gather, and the kernel's plain version) identical
    to the JAX engines', at tp 1 and 2; sampled tokens at tp 2 equal to
    tp 1's;
(f) `evaluate` and `generate` at `--family gpt2` give JAX's losses and
    strings; the gpt2 buffer clamp and its refusal.
"""

import dataclasses
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu import evaluate as jevaluate
from distributed_pytorch_from_scratch_tpu import generate as jgenerate
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig)
from distributed_pytorch_from_scratch_tpu.models import decode as jdecode
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.parallel.norm import (
    LayerNorm as JLayerNorm)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving.kv_manager import POOL_SPEC
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu_torch import (evaluate, generate,
                                                        interop, train)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, MeshConfig, ModelConfig, OptimizerConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax, params_to_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import (
    build_model, num_params)
from distributed_pytorch_from_scratch_tpu_torch.models.gpt2 import (
    GPT2Transformer)
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    assemble_params)
from distributed_pytorch_from_scratch_tpu_torch.parallel.norm import (
    LayerNorm)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from distributed_pytorch_from_scratch_tpu_torch.training.metrics import (
    model_flops_per_step)
from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
    init_adam_state)
from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
    build_train_step)
from _torch_threads import two_torch_threads  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "tokenizer", "tokenizer.json")
TINY = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
            vocab_size=1024, maxlen=64, compute_dtype="float32")
PAD = dict(TINY, vocab_size=1023)           # pads to 1024 at tp 2
CFGS = {"tiny": TINY, "pad": PAD}
B, T = 4, 32
EOS, BUF = 1, 40
ADAM = dict(lr=1e-3, warmup_steps=2, max_steps=5, clip_grad_norm=0.5)
# JAX loss references: name -> (cfg, (dp, cp, tp), layout)
MESHES = {"tp1": ("tiny", (1, 1, 1), "contiguous"),
          "tp2": ("pad", (1, 1, 2), "contiguous"),
          "dp2": ("tiny", (2, 1, 1), "contiguous"),
          "cp2": ("tiny", (1, 2, 1), "zigzag")}
# port runs in the group: name -> (JAX reference, sp)
GROUP_RUNS = {"tp2": ("tp2", False), "tp2_sp": ("tp2", True),
              "dp2": ("dp2", False), "cp2_zigzag": ("cp2", False)}
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
SLOT_KW = dict(num_slots=3, buf_len=BUF, eos_id=EOS, prefill_bucket=8,
               max_prefill_batch=2)
PAGED_KW = dict(num_slots=3, buf_len=BUF, eos_id=EOS, page_size=8,
                prefill_chunk=8)
PROMPTS = [[0, 5, 17, 33, 60, 2, 8, 9, 11, 40], [0, 5, 17, 33, 60, 2, 7],
           [0, 95, 4, 12], [0, 70, 8, 8, 8, 51, 13, 2, 9, 31, 77, 19],
           [0, 44]]
MAX_NEW = 10
TICK = 0.02
# engine runs: name -> (engine, kwargs)
SERVE = {"slot": ("slot", SLOT_KW),
         "paged_gather": ("paged", dict(PAGED_KW, paged_attn_impl="gather")),
         "paged_kernel": ("paged", dict(PAGED_KW, paged_attn_impl="kernel")),
         "slot_sampled": ("slot", dict(SLOT_KW, **SAMPLED)),
         "paged_sampled": ("paged", dict(PAGED_KW, **SAMPLED))}


def _tree(cfg, tp, seed=3):
    jm = JGPT2(JModelConfig(**cfg), tp_size=tp)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _batch(rng, vocab, lead=()):
    ids = rng.integers(0, vocab, size=lead + (B, T + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, T - 11:] = IGNORE_INDEX
    tgt[..., 3, 2:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), lead + (B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


def _jax_loss(name, tree, batch):
    cfg, (dp, cp, tp), layout = MESHES[name]
    jm = JGPT2(JModelConfig(**CFGS[cfg]), tp_size=tp, cp_size=cp,
               cp_layout=layout)
    mesh = jmake_mesh(JMeshConfig(dp=dp, cp=cp, tp=tp))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss(mesh)))(
        params, *batch)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _jax_trajectory(tree, steps):
    jm = JGPT2(JModelConfig(**TINY))
    mesh = jmake_mesh(JMeshConfig())
    step = jtrain_step.build_train_step(jm, mesh, JOptimizerConfig(**ADAM),
                                        with_grad_norm=True)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    state = joptim.init_adam_state(params)
    losses, gnorms = [], []
    for i in range(5):
        params, state, (loss, gnorm) = step(params, state,
                                            *(x[i] for x in steps))
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return losses, gnorms


def _decode_calls(rng):
    """One prefill, two slot decode steps, two paged decode steps:
    [(kind, args, page_size)], caches and pools random (every head)."""
    L, h, hd = TINY["num_layers"], TINY["num_heads"], 32
    b, t, ps, pages = 3, 24, 8, 10
    buf = rng.integers(3, 1024, (b, 16)).astype(np.int32)
    calls = [("prefill", (buf, np.array([16, 5, 11], np.int32)), None)]
    for cur in ([4, 17, 23], [0, 9, 12]):
        cache = lambda: rng.standard_normal((L, b, h, t, hd), np.float32)
        calls.append(("decode", (cache(), cache(),
                                 rng.integers(3, 1024, b).astype(np.int32),
                                 np.array(cur, np.int32)), None))
    tbl = np.array([[3, 7, 1, 0], [5, 2, 9, pages], [4, 6, 8, pages]],
                   np.int32)
    for cur in ([30, 14, 20], [2, 21, 9]):
        pool = lambda: rng.standard_normal((L, pages + 1, h, ps, hd),
                                           np.float32)
        calls.append(("paged_decode", (pool(), pool(),
                                       rng.integers(3, 1024, b).astype(
                                           np.int32),
                                       np.array(cur, np.int32), tbl), ps))
    return calls


def _jax_decode_logits(jm, mesh, params, kind, args, ps, fns):
    """JAX's logits of one call; `fns` keeps one jitted program per kind
    and page size, so calls of one shape compile once."""
    if (kind, ps) not in fns:
        fns[kind, ps] = _jax_decode_fn(jm, mesh, kind, ps, len(args))
    return np.asarray(fns[kind, ps](params, *(jnp.asarray(a) for a in args)))


def _jax_decode_fn(jm, mesh, kind, ps, n_args):
    def fn(params, *a):
        if kind == "prefill":
            return jdecode._prefill(jm, params, *a, None, None,
                                    jnp.float32)[2]
        if kind == "decode":
            return jdecode._decode_one(jm, params, *a, a[0].shape[3], None,
                                       None, jnp.float32)[2]
        return jdecode._paged_decode_one(jm, params, *a, ps, None, None,
                                         jnp.float32)[2]

    cache = 0 if kind == "prefill" else 2
    specs = (POOL_SPEC,) * cache + (P(),) * (n_args - cache)
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(jm.specs(),) + specs,
                                 out_specs=P(None, "tp")))


def _requests(seed0=0):
    return [(list(p), MAX_NEW, "default", None, seed0 + i)
            for i, p in enumerate(PROMPTS)]


def _serve_jobs():
    return [dict(engine=eng, kw=kw, requests=_requests(100), stagger=2,
                 tick=TICK) for eng, kw in SERVE.values()]


def _jax_engine_tokens(jm, mesh, params, kind):
    if kind == "slot":
        eng = jengine.ContinuousBatchingEngine(jm, mesh, params, **SLOT_KW)
    else:
        eng = jengine.PagedEngine(jm, mesh, params, paged_attn_impl="gather",
                                  clock=tp_checks.counting_clock(TICK),
                                  **PAGED_KW)
    reqs = [jengine.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m, _, _, _) in enumerate(_requests(100))]
    return tp_checks.drive(eng, reqs, 2)[0]


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    trees = {"tiny": _tree(TINY, 1), "pad": _tree(PAD, 2)}
    batches = {c: _batch(rng, CFGS[c]["vocab_size"]) for c in CFGS}
    steps = _batch(np.random.default_rng(10), 1024, lead=(5,))
    calls = _decode_calls(np.random.default_rng(4))

    def model_job(name):
        ref, sp = GROUP_RUNS[name]
        cfg, (dp, cp, tp), layout = MESHES[ref]
        return ("model_runs", dict(dp=dp, cp=cp, tp=tp), dict(
            cfg=CFGS[cfg], tree=trees[cfg],
            runs=[dict(sp=sp, layout=layout, batch=batches[cfg])]))

    todo = [model_job(n) for n in GROUP_RUNS] + [
        ("model_runs", {"tp": 2}, dict(
            cfg=TINY, tree=trees["tiny"],
            runs=[dict(sp=True, batch=steps, steps=5, optim=ADAM)])),
        ("seed_identity", {"tp": 2}, dict(cfg=PAD, seed=11,
                                          batch=batches["pad"],
                                          family="gpt2")),
        ("serve_runs", {"tp": 2}, dict(cfg=TINY, tree=trees["tiny"],
                                       runs=_serve_jobs())),
        ("decode_logits", {"tp": 2}, dict(
            cfg=TINY, tree=trees["tiny"],
            calls=[dict(kind=k, args=a, page_size=ps)
                   for k, a, ps in calls]))]
    with ThreadPoolExecutor(max_workers=1) as pool:
        group = pool.submit(launch.spawn, tp_checks.jobs, 2, todo)
        jm = JGPT2(JModelConfig(**TINY))
        mesh = jmake_mesh(JMeshConfig())
        params = jax.device_put(jax.tree.map(jnp.asarray, trees["tiny"]),
                                jm.shardings(mesh))
        fns = {}
        refs = {
            "loss": {n: _jax_loss(n, trees[MESHES[n][0]],
                                  batches[MESHES[n][0]]) for n in MESHES},
            "logits": np.asarray(jm.make_forward(mesh)(
                params, *(jnp.asarray(batches["tiny"][i]) for i in (0, 2)))),
            "trajectory": _jax_trajectory(trees["tiny"], steps),
            "decode": [_jax_decode_logits(jm, mesh, params, *c, fns)
                       for c in calls],
            "engines": {k: _jax_engine_tokens(jm, mesh, params, k)
                        for k in ("slot", "paged")},
        }
        port = group.result()
    names = list(GROUP_RUNS) + ["trajectory", "seed", "serve", "decode"]
    group_out = {n: [rank[i] for rank in port] for i, n in enumerate(names)}
    tp1 = tp_checks.serve_runs(make_mesh(MeshConfig(), device="cpu"), TINY,
                               trees["tiny"], _serve_jobs())
    return dict(trees=trees, batches=batches, steps=steps, calls=calls,
                refs=refs, group=group_out, serve_tp1=tp1)


def _port(tree, cfg=TINY, **kw):
    model = GPT2Transformer(ModelConfig(**cfg), **kw)
    model.load_state_dict(params_from_jax(tree))
    return model


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).long()


# ---- (a) ----

def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    ln = LayerNorm(48)
    ln.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    ref = np.asarray(JLayerNorm(48).apply({"scale": scale, "bias": bias},
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
        got_bf16 = ln(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.abs(got - ref).max() < 1e-5
    ref_bf16 = np.asarray(JLayerNorm(48).apply(
        {"scale": scale, "bias": bias},
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    # bf16 rounds where JAX rounds: normed, then scale * normed + bias
    assert np.abs(got_bf16 - ref_bf16).max() <= 0.0625


def test_forward_logits_match_jax(runs):
    model = _port(runs["trees"]["tiny"])
    ids, _, pos = runs["batches"]["tiny"]
    with torch.no_grad():
        got = model(_t(ids), _t(pos)).numpy()
    ref = runs["refs"]["logits"]
    assert got.shape == ref.shape == (B, T, 1024)
    assert np.abs(got - ref).max() < 1e-5


def test_module_tree_and_hooks():
    model = GPT2Transformer(ModelConfig(**TINY))
    assert not hasattr(model, "lm_head")
    assert (model.uses_rope, model.attn_norm_key, model.ffn_norm_key) == (
        False, "ln1", "ln2")
    assert model.max_decode_positions == 64
    jtree = _tree(TINY, 1)
    flat = lambda t: {k for k, _ in interop._walk(t)}
    assert flat(params_to_jax(model.state_dict())) == flat(jtree)
    with pytest.raises(ValueError, match="the gpt2 family is MHA"):
        GPT2Transformer(ModelConfig(**dict(TINY, num_kv_heads=2)))
    # gpt2 x MoE: the routed SwiGLU experts in place of fc/proj, as JAX's
    moe = GPT2Transformer(ModelConfig(**dict(TINY, num_experts=4)))
    assert "moe" in moe.layers[0] and "fc" not in moe.layers[0]
    assert flat(params_to_jax(moe.state_dict())) == flat(
        _tree(dict(TINY, num_experts=4), 1))
    with pytest.raises(ValueError, match="unknown model family"):
        build_model("bert", ModelConfig(**TINY))


# ---- (b) ----

def _close_grads(got, ref, name):
    assert set(got) == set(ref), name
    for k in ref:
        g, r = np.asarray(got[k]), ref[k].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name}: {k}")


def test_loss_and_grads_tp1_match_jax(runs):
    model = _port(runs["trees"]["tiny"], remat=False)
    loss = model.loss(*(_t(x) for x in runs["batches"]["tiny"]))
    loss.backward()
    ref_loss, ref_grads = runs["refs"]["loss"]["tp1"]
    assert abs(loss.item() - ref_loss) < 1e-5
    _close_grads({k: p.grad.numpy() for k, p in model.named_parameters()},
                 ref_grads, "tp1")
    # the tied embedding took both gradients: the head's reaches every row
    g = model.embedding.weight.grad
    assert (g.abs().sum(dim=1) > 0).all()


@pytest.mark.parametrize("name", list(GROUP_RUNS))
def test_loss_and_grads_on_two_ranks_match_jax(runs, name):
    per_rank = [r[0] for r in runs["group"][name]]
    ref_loss, ref_grads = runs["refs"]["loss"][GROUP_RUNS[name][0]]
    for r in per_rank:
        assert abs(r["loss"] - ref_loss) < 1e-5, (name, r["loss"], ref_loss)
    tp = MESHES[GROUP_RUNS[name][0]][1][2]
    if tp > 1:
        grads = assemble_params([{k: torch.from_numpy(v) for k, v in
                                  r["grads"].items()} for r in per_rank])
    else:     # dp and cp: every rank holds the whole (reduced) gradient
        for r in per_rank[1:]:
            for k, v in r["grads"].items():
                np.testing.assert_array_equal(v, per_rank[0]["grads"][k])
        grads = per_rank[0]["grads"]
    _close_grads({k: np.asarray(v) for k, v in grads.items()}, ref_grads,
                 name)


def test_tp2_model_from_a_seed_is_the_tp1_model(runs):
    for r in runs["group"]["seed"]:
        assert abs(r["tp"] - r["tp1"]) < 1e-5


def test_init_distributions():
    model = GPT2Transformer(ModelConfig(**TINY)).init_weights(0)
    emb, pos = model.embedding.weight, model.pos_embedding.weight
    assert abs(emb.std().item() - 0.02) < 2e-3
    assert abs(pos.std().item() - 0.02) < 2e-3
    ln = model.layers[0]["ln1"]
    assert bool((ln.scale == 1).all()) and bool((ln.bias == 0).all())
    fc = model.layers[0]["fc"].weight
    assert fc.abs().max().item() <= 1 / np.sqrt(128)


# ---- (c) ----

def test_trajectory_tp1_matches_jax(runs):
    model = _port(runs["trees"]["tiny"])
    step = build_train_step(model, OptimizerConfig(**ADAM))
    state = init_adam_state(dict(model.named_parameters()))
    losses, gnorms = [], []
    for i in range(5):
        loss, gnorm, state = step(state, *(_t(x[i]) for x in runs["steps"]))
        losses.append(loss.item())
        gnorms.append(gnorm.item())
    ref_l, ref_g = runs["refs"]["trajectory"]
    np.testing.assert_allclose(losses, ref_l, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gnorms, ref_g, rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0]


def test_trajectory_tp2_sp_matches_jax(runs):
    ref_l, ref_g = runs["refs"]["trajectory"]
    for r in runs["group"]["trajectory"]:
        np.testing.assert_allclose(r[0]["losses"], ref_l, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r[0]["gnorms"], ref_g, rtol=1e-4,
                                   atol=1e-4)


# ---- (d) ----

def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in interop._walk(tree)}


@pytest.mark.parametrize("tp", [1, 2])
def test_jax_checkpoint_loads_in_port_at_any_tp(tmp_path, tp):
    cfg = TINY if tp == 1 else PAD
    jm = JGPT2(JModelConfig(**cfg), tp_size=tp)
    tree = _tree(cfg, tp, seed=9)
    state = joptim.init_adam_state(tree)
    state = joptim.AdamState(step=np.int32(3),
                             mu=jax.tree.map(lambda a: a + 1e-3, state.mu),
                             nu=jax.tree.map(lambda a: a + 1e-6, state.nu))
    jckpt.save_checkpoint(str(tmp_path), 3, 6.5, tree, jm.specs(), tp, state)
    for read_tp in (1, 2):
        shards = [checkpoint.load_checkpoint(str(tmp_path), 3, True,
                                             read_tp, r)
                  for r in range(read_tp)]
        for r, (sd, opt, step) in enumerate(shards):
            want = params_from_jax(tree, read_tp, r)
            assert step == 3 and set(sd) == set(want)
            for k in want:
                assert torch.equal(sd[k], want[k]), (tp, read_tp, k)
            assert torch.equal(opt.mu["pos_embedding.weight"],
                               want["pos_embedding.weight"] * 0 + 1e-3)


@pytest.mark.parametrize("tp", [1, 2])
def test_port_checkpoint_loads_in_jax(tmp_path, tp):
    cfg = TINY if tp == 1 else PAD
    tree = _tree(cfg, tp, seed=5)
    for r in range(tp):
        checkpoint.save_checkpoint(str(tmp_path), 4, 2.5,
                                   params_from_jax(tree, tp, r), None,
                                   tp_size=tp, tp_rank=r)
    jm = JGPT2(JModelConfig(**cfg), tp_size=tp)
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    got, _, step = jckpt.load_checkpoint(str(tmp_path), 4, template,
                                         jm.specs())
    assert step == 4
    want, have = _flat(tree), _flat(jax.tree.map(np.asarray, got))
    assert set(want) == set(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_pth_bridge_refuses_the_gpt2_family():
    tree = _tree(TINY, 1)
    with pytest.raises(ValueError, match="gpt2"):
        interop.export_state_dicts(tree, ModelConfig(**TINY), 1)
    sd = {k: v.numpy() for k, v in params_from_jax(tree).items()}
    with pytest.raises(ValueError, match="gpt2"):
        interop.convert_state_dicts([sd], ModelConfig(**TINY))


def _write_corpus(path, vocab=1024, docs=30):
    rng = np.random.default_rng(0)
    train_docs = [rng.integers(3, vocab, size=int(n)).tolist()
                  for n in rng.integers(5, 60, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train_docs, "validation": train_docs[:6],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


def test_train_cli_runs_gpt2_and_counts_its_params(tmp_path, capsys):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    flags = ["--family", "gpt2", "--model", "tiny", "--maxlen", "64",
             "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
             "--log_interval", "2", "--device", "cpu", "--data_path", data,
             "--save_dir", str(tmp_path / "ck")]
    out = train.main(flags + ["--max_steps", "3"])
    assert "model[gpt2]" in capsys.readouterr().out
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
    resumed = train.main(flags + ["--max_steps", "4", "--resume"])
    assert resumed["start_step"] == 3 and resumed["steps"] == 4
    sd, _, _ = checkpoint.load_checkpoint(str(tmp_path / "ck"), 4)
    assert "pos_embedding.weight" in sd and "lm_head.weight" not in sd
    # the real N against the llama formula: GPT-2 small's 124,439,808
    cfg = model_preset("gpt2-124m")
    with torch.device("meta"):
        n = num_params(GPT2Transformer(cfg))
    jm = JGPT2(JModelConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n == 124_439_808 < cfg.num_params()
    attn = 12 * 12 * 8 * 12 * 1024 * 1024 * 64     # 12 L b h t^2 hd
    assert model_flops_per_step(cfg, 8, 1024, params=n) == (
        6 * n * 8 * 1024 + attn)


# ---- (e) ----

def test_decode_logits_match_jax_at_tp1_and_tp2(runs):
    mesh = make_mesh(MeshConfig(), device="cpu")
    tp1 = tp_checks.decode_logits(mesh, TINY, runs["trees"]["tiny"], [
        dict(kind=k, args=a, page_size=ps) for k, a, ps in runs["calls"]])
    tp2 = runs["group"]["decode"]          # per rank: the calls' logits
    for i, ref in enumerate(runs["refs"]["decode"]):
        assert ref.shape == (3, 1024)
        for got in (tp1[i], tp2[0][i], tp2[1][i]):
            assert np.abs(got - ref).max() < 1e-4, (i, np.abs(got - ref).max())


@pytest.mark.parametrize("name", ["slot", "paged_gather", "paged_kernel"])
def test_greedy_engines_match_jax_at_tp1_and_tp2(runs, name):
    kind = SERVE[name][0]
    ref = runs["refs"]["engines"][kind]
    i = list(SERVE).index(name)
    tp1 = runs["serve_tp1"][i]["tokens"]
    r0, r1 = (r[i] for r in runs["group"]["serve"])
    assert tp1 == ref and r0["tokens"] == ref, name
    assert sum(len(t) for t in ref.values()) > len(PROMPTS)
    assert r0["dispatches"] == r1["dispatches"]


@pytest.mark.parametrize("name", ["slot_sampled", "paged_sampled"])
def test_sampled_engines_tp2_equal_tp1(runs, name):
    i = list(SERVE).index(name)
    tp1 = runs["serve_tp1"][i]["tokens"]
    r0, r1 = (r[i] for r in runs["group"]["serve"])
    assert r0["tokens"] == tp1
    assert r0["dispatches"] == r1["dispatches"]
    greedy = {"slot_sampled": "slot", "paged_sampled": "paged_gather"}[name]
    assert tp1 != runs["serve_tp1"][list(SERVE).index(greedy)]["tokens"]


# ---- (f) ----

MODEL = ["--family", "gpt2", "--model", "tiny", "--maxlen", "64",
         "--no-bf16"]


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    from tokenizers import Tokenizer
    d = tmp_path_factory.mktemp("gpt2_eval")
    tok = Tokenizer.from_file(SHIPPED)
    rng = np.random.default_rng(0)
    words = ("the king rode out at dawn with his men a quiet morning on "
             "the river bank Nice to meet you it's").split()
    texts = [" ".join(rng.choice(words, size=rng.integers(3, 20)))
             for _ in range(14)]
    data = d / "tokens.json"
    data.write_text(json.dumps({
        "train": [tok.encode(t).ids for t in texts[:8]],
        "validation": [tok.encode(t).ids for t in texts[8:]],
        "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
        "vocab_size": 1024}))
    src = d / "ckpt"
    for it, seed in ((10, 1), (20, 2)):
        checkpoint.save_checkpoint(str(src), it, 5.0,
                                   params_from_jax(_tree(TINY, 1, seed)))
    return dict(d=d, data=str(data), src=src)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize("extra", [[], ["--no_kv_cache"],
                                   ["--temperature", "0.8",
                                    "--decode_top_k", "40"]])
def test_evaluate_gpt2_matches_jax(eval_setup, extra):
    tag = "_".join(extra).replace("-", "") or "kv"
    base = ["--data_path", eval_setup["data"], "--tokenizer_path", SHIPPED,
            "--batch_size", "4", "--max_decode_len", "24"] + MODEL + extra
    d = eval_setup["d"]
    theirs = jevaluate.evaluate(jevaluate.get_eval_args(
        base + ["--ckpt_dir", _copy(eval_setup["src"], d / f"j_{tag}")]))
    ours = evaluate.main(base + ["--ckpt_dir",
                                 _copy(eval_setup["src"], d / f"p_{tag}"),
                                 "--device", "cpu"])
    assert set(ours["val_losses"]) == set(theirs["val_losses"])
    for it, loss in theirs["val_losses"].items():
        assert abs(ours["val_losses"][it] - loss) < 1e-5
    if "--temperature" not in extra:   # jax.random draws: other tokens
        assert ours["decoded"] == theirs["decoded"]
    assert len(ours["decoded"]) == 8


def test_generate_gpt2_matches_jax_greedy_and_samples(eval_setup):
    args = ["--ckpt_dir", str(eval_setup["src"]), "-t", SHIPPED,
            "--max_new_tokens", "12", "--prompt", "Nice to meet you",
            "--prompt", "The brave man"] + MODEL
    assert generate.main(args + ["--device", "cpu"]) == jgenerate.main(args)
    sampled = args + ["--device", "cpu", "--temperature", "0.8",
                      "--decode_top_p", "0.9", "--seed", "4"]
    a, b = generate.main(sampled), generate.main(sampled)
    assert a == b and a[0].startswith("Nice to meet you")
    assert generate.main(sampled[:-1] + ["5"]) != a


def test_gpt2_buffer_clamps_to_the_position_table(eval_setup, capsys):
    args = ["--ckpt_dir", str(eval_setup["src"]), "-t", SHIPPED,
            "--prompt", "hi", "--device", "cpu"] + MODEL
    # 200 new tokens would pass the 64-row table: clamped, not refused
    outs = generate.main(args + ["--max_new_tokens", "200"])
    assert outs[0].startswith("hi")
    long_prompt = " ".join(["the king"] * 40)
    with pytest.raises(SystemExit, match="position table"):
        generate.main(args[:5] + [long_prompt] + args[6:])
