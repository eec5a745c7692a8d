"""The port's MoE family (PyTorch, gloo ranks on the CPU) against the JAX
package's: the routed-expert layer, the model at ep > 1 composed with dp,
cp, tp and sequence parallelism, Adam steps, checkpoints, both serving
engines and the evaluation loss, in float32.

Both packages get the same inputs, made from a seed with numpy, and the
same weights (a JAX `init` tree with its zero router replaced by a seeded
normal one, so tokens route unevenly; the ranks take their shard through
`interop.params_from_jax(tree, tp, tp_rank, ep, ep_rank)`). The shape is
the JAX MoE tests' (d 32, 4 heads, 2 layers, vocab 96, 4 experts, top 2).
The port's ranks run `runtime/tp_checks.py`'s rank programs in one kept
group of 2 and one of 4 (`launch.kept_groups`), in the background while
JAX computes.

(a) the layer against JAX `MoEFFN.apply` on one device: output and aux
    sums within 1e-5, slots equal and weights within 1e-6 (XLA's and
    torch's float32 exp differ in the last bit) — at ample capacity (cf
    8.0), at cf 1.0 where choices drop, and under the zero router where
    every expert ties (ties go to the lowest index);
(b) the model's loss, logits and every gradient at ep 2, ep 2 x tp 2,
    ep 2 x tp 2 with SP, dp 2 x ep 2 and cp 2 x ep 2 (cf 8.0: nothing
    drops, so JAX's one-device run is the reference) and at ep 2 with cf
    1.0 (capacity then depends on the mesh: JAX at ep 2), and gpt2 x MoE
    at tp 1; loss rtol 1e-5, logits 1e-4, gradients rtol 1e-4 atol 1e-5;
(c) five Adam steps at ep 2 x tp 2 against JAX `build_train_step` at the
    same mesh: losses within 1e-4 relative;
(d) checkpoints both ways at ep 2 x tp 2 (a JAX file resumed by the port,
    the port's file loaded by JAX; the next step's loss agrees), and the
    `__layout__` stamp byte-identical to JAX's at (ep 2) and (dp 2, ep 2);
(e) the slot and paged engines at tp 1, and the paged engine at tp 2,
    give the JAX engines' greedy tokens at cf 0.5, where prefill and
    decode dispatches drop choices (so the padded and dead rows of a
    dispatch take part: the tokens differ from cf 8.0's);
(f) `doc_loss` (the evaluation sweep's per-document losses) within 1e-5 of
    JAX `make_doc_loss`; `model_flops_per_step` of `45m-moe8` equals
    JAX's; the MoE train CLI at ep 2 over gloo, then evaluate and generate
    on its checkpoint; the library keeps JAX's ep checks. (The MoE serving
    paths beyond the two engines, and evaluate / generate at cp 2, are
    `tests/test_torch_moe_paths.py`'s.)
"""

import dataclasses
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
    OptimizerConfig as JOptimizerConfig, model_preset as jmodel_preset)
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.parallel.moe import (
    MoEFFN as JMoEFFN, aux_zeros as jaux_zeros)
from distributed_pytorch_from_scratch_tpu.reshard import layout as jlayout
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    metrics as jmetrics)
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu_torch import (evaluate, generate,
                                                        train as train_cli)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, MeshConfig, ModelConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    assemble_params)
from distributed_pytorch_from_scratch_tpu_torch.parallel.moe import (
    MoEFFN, capacity, route)
from distributed_pytorch_from_scratch_tpu_torch.reshard import layout
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.training import (
    checkpoint, metrics)
from _torch_threads import two_torch_threads  # noqa: F401


CFG = dict(attn_dim=32, ffn_dim=64, num_heads=4, num_layers=2,
           vocab_size=96, maxlen=64, num_experts=4, moe_top_k=2,
           moe_capacity_factor=8.0)
TIGHT = dict(CFG, moe_capacity_factor=1.0)      # choices drop at ep 2
SERVE = dict(CFG, moe_capacity_factor=0.5)      # ... in every dispatch
B, T = 4, 32
ADAM = dict(lr=1e-2, warmup_steps=2, max_steps=20)
SHIPPED = "tokenizer/tokenizer.json"

# name: (port mesh axes, sp, cfg, the JAX mesh of the reference)
MODEL_RUNS = {
    "ep2": (dict(ep=2), False, CFG, {}),
    "ep2_tp2": (dict(ep=2, tp=2), False, CFG, {}),
    "ep2_tp2_sp": (dict(ep=2, tp=2), True, CFG, {}),
    "dp2_ep2": (dict(dp=2, ep=2), False, CFG, {}),
    "cp2_ep2": (dict(cp=2, ep=2), False, CFG, {}),
    "ep2_drops": (dict(ep=2), False, TIGHT, dict(ep=2)),
}

# the engines' load: burst requests of shared-prefix and unrelated prompts
PROMPTS = [[5, 17, 33, 60, 2, 8, 9], [5, 17, 33, 60, 2, 8, 9, 11, 40, 3],
           [70, 4, 12], [8, 8, 8, 1, 9], [51, 13, 2, 9, 31, 77, 19, 6],
           [44, 90], [23, 3, 14, 15, 92, 65], [7, 7]]
BUF, EOS, MAX_NEW = 32, 1, 10
SLOT_KW = dict(num_slots=6, buf_len=BUF, eos_id=EOS, prefill_bucket=8,
               max_prefill_batch=2)
PAGED_KW = dict(num_slots=6, buf_len=BUF, eos_id=EOS, page_size=8,
                prefill_chunk=8)
TICK = 0.02


def _tree(cfg, family="llama", seed=0):
    """A JAX init tree with a seeded normal router (the init's is zero)."""
    cls = JTransformer if family == "llama" else JGPT2
    tree = jax.tree.map(np.asarray,
                        cls(JModelConfig(**cfg)).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    moe = tree["layers"]["moe"]
    moe["router"] = rng.standard_normal(moe["router"].shape).astype(
        np.float32)
    return tree


def _batch(rng, lead=()):
    """(ids, targets, positions) int32 (lead + (B, T)); some targets
    ignored, unevenly over rows and sequence chunks."""
    ids = rng.integers(0, CFG["vocab_size"], size=lead + (B, T + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, T - 11:] = IGNORE_INDEX
    tgt[..., 3, 2:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), lead + (B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


def _jax_model(cfg, family="llama", **mesh):
    cls = JTransformer if family == "llama" else JGPT2
    jm = cls(JModelConfig(**cfg), tp_size=mesh.get("tp", 1),
             ep_size=mesh.get("ep", 1))
    return jm, jmake_mesh(JMeshConfig(**mesh))


def _jax_loss(cfg, tree, batch, family="llama", **mesh):
    """(loss, port-keyed gradients, full logits) of JAX on `mesh`."""
    jm, m = _jax_model(cfg, family, **mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(m))
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss(m)))(params,
                                                               *batch)
    logits = jm.make_forward(m)(params, batch[0], batch[2])
    return (float(loss), params_from_jax(jax.tree.map(np.asarray, grads)),
            np.asarray(logits))


def _jax_steps(tree, batches, load=None):
    """JAX `build_train_step` at ep 2 x tp 2: the losses of len(batches)
    steps from `tree` (or, with `load` = (dir, step), from that
    checkpoint, moments included), and the final state."""
    jm, m = _jax_model(CFG, ep=2, tp=2)
    step_fn = _jax_step_fn()
    put = lambda t: jax.device_put(jax.tree.map(jnp.asarray, t),
                                   jm.shardings(m))
    if load is None:
        params = put(tree)
        state = joptim.init_adam_state(params)
    else:
        params, state, _ = jckpt.load_checkpoint(*load, tree, jm.specs(),
                                                 with_opt=True)
        params = put(params)
        state = joptim.AdamState(step=state.step, mu=put(state.mu),
                                 nu=put(state.nu))
    losses = []
    for batch in batches:
        params, state, loss = step_fn(params, state, *batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), state


_STEP = {}


def _jax_step_fn():
    if "fn" not in _STEP:
        jm, m = _jax_model(CFG, ep=2, tp=2)
        _STEP["fn"] = jtrain_step.build_train_step(
            jm, m, JOptimizerConfig(**ADAM))
    return _STEP["fn"]


def _jax_engine_tokens(kind, tree, tp=1):
    jm, m = _jax_model(SERVE, tp=tp)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(m))
    if kind == "slot":
        eng = jengine.ContinuousBatchingEngine(jm, m, params, **SLOT_KW)
    else:
        eng = jengine.PagedEngine(jm, m, params, paged_attn_impl="gather",
                                  clock=tp_checks.counting_clock(TICK),
                                  **PAGED_KW)
    reqs = [jengine.Request(rid=i, prompt=list(p), max_new=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    return tp_checks.drive(eng, reqs, 1)[0]


def _port_engine_tokens(kind, tree, cfg=SERVE):
    model = build_model("llama", ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(tree))
    mesh = make_mesh(MeshConfig(), device="cpu")
    if kind == "slot":
        eng = ContinuousBatchingEngine(model, mesh, **SLOT_KW)
    else:
        eng = PagedEngine(model, mesh, paged_attn_impl="kernel",
                          clock=tp_checks.counting_clock(TICK), **PAGED_KW)
    reqs = [Request(rid=i, prompt=list(p), max_new=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    return tp_checks.drive(eng, reqs, 1)[0]


def _write_corpus(path, docs=24, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


CLI_MODEL = ["--model", "tiny", "--num_experts", "4", "--maxlen", "64"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    trees = {"cfg": _tree(CFG), "tight": _tree(TIGHT),
             "serve": _tree(SERVE, seed=1), "gpt2": _tree(CFG, "gpt2"),
             "gpt2_batch": _batch(np.random.default_rng(3))}
    batch = _batch(rng)
    steps = _batch(np.random.default_rng(5), lead=(5,))
    ck_batches = _batch(np.random.default_rng(6), lead=(3,))
    root = tmp_path_factory.mktemp("moe")
    dirs = {k: str(root / k) for k in ("jax", "port", "cli")}
    jm, m = _jax_model(CFG, ep=2, tp=2)
    jstate = joptim.init_adam_state(trees["cfg"])
    jstate = joptim.AdamState(
        step=np.int32(3), mu=jax.tree.map(lambda a: a + 1e-3, jstate.mu),
        nu=jax.tree.map(lambda a: a + 1e-6, jstate.nu))
    jckpt.save_checkpoint(dirs["jax"], 3, 4.5, trees["cfg"], jm.specs(), 2,
                          jstate, mesh_axes=m)

    def model_job(name, logits=True):
        axes, sp, cfg, _ = MODEL_RUNS[name]
        tree = trees["tight" if cfg is TIGHT else "cfg"]
        return ("model_runs", axes, dict(cfg=cfg, tree=tree, runs=[dict(
            sp=sp, batch=batch, logits=logits)]))

    serve_reqs = [(list(p), MAX_NEW, "default", None) for p in PROMPTS]
    todo2 = [model_job("ep2"), model_job("ep2_drops"),
             ("serve_runs", {"tp": 2}, dict(cfg=SERVE, tree=trees["serve"],
                                            runs=[dict(
                engine="paged", kw=dict(PAGED_KW, paged_attn_impl="kernel"),
                requests=serve_reqs, stagger=1, tick=TICK)]))]
    todo4 = [model_job(n) for n in ("ep2_tp2", "ep2_tp2_sp", "dp2_ep2",
                                    "cp2_ep2")]
    todo4 += [("model_runs", dict(ep=2, tp=2), dict(
        cfg=CFG, tree=trees["cfg"], runs=[dict(batch=steps, steps=5,
                                                optim=ADAM)])),
              ("checkpoint_steps", dict(ep=2, tp=2), dict(
                  cfg=CFG, family="llama", load_dir=dirs["jax"], step=3,
                  save_dir=dirs["port"], batches=ck_batches, optim=ADAM))]
    data = str(root / "tokens.json")
    _write_corpus(data)
    cli_flags = CLI_MODEL + [
        "--batch_size", "4", "--max_steps", "2", "--warmup_steps", "1",
        "--log_interval", "1", "--device", "cpu", "--data_path", data,
        "--save_dir", dirs["cli"], "--ep_size", "2", "--dist_backend",
        "gloo"]

    # JAX's references compile in threads of their own, beside the groups
    jax_refs = {
        "one": lambda: _jax_loss(CFG, trees["cfg"], batch),
        "drops": lambda: _jax_loss(TIGHT, trees["tight"], batch, ep=2),
        "gpt2": lambda: _jax_loss(CFG, trees["gpt2"], trees["gpt2_batch"],
                                  family="gpt2"),
        # one compiled step for both (`_jax_step_fn`), in one thread
        "steps": lambda: (
            _jax_steps(trees["cfg"], [[x[i] for x in steps]
                                      for i in range(5)])[0],
            _jax_steps(trees["cfg"], [[x[0] for x in ck_batches]],
                       load=(dirs["jax"], 3))),
        "slot": lambda: _jax_engine_tokens("slot", trees["serve"]),
        "paged": lambda: _jax_engine_tokens("paged", trees["serve"]),
        "paged_tp2": lambda: _jax_engine_tokens("paged", trees["serve"],
                                                tp=2),
    }
    with launch.kept_groups(), ThreadPoolExecutor(
            max_workers=2 + len(jax_refs)) as pool:
        g2 = pool.submit(lambda: (launch.spawn(tp_checks.jobs, 2, todo2),
                                  train_cli.main(cli_flags)))
        g4 = pool.submit(launch.spawn, tp_checks.jobs, 4, todo4)
        futures = {k: pool.submit(f) for k, f in jax_refs.items()}
        refs = {k: f.result() for k, f in futures.items()}
        refs["trajectory"], refs["resume"] = refs.pop("steps")
        two, cli = g2.result()
        four = g4.result()
    # the port's file, loaded by JAX, and its next step
    refs["loaded"] = _jax_steps(trees["cfg"], [[x[i] for x in ck_batches]
                                               for i in range(1, 2)],
                                load=(dirs["port"], 4))
    names2 = ["ep2", "ep2_drops", "serve"]
    names4 = ["ep2_tp2", "ep2_tp2_sp", "dp2_ep2", "cp2_ep2", "trajectory",
              "checkpoint"]
    res = {n: [rank[i] for rank in two] for i, n in enumerate(names2)}
    res.update({n: [rank[i] for rank in four]
                for i, n in enumerate(names4)})
    return dict(trees=trees, batch=batch, refs=refs, res=res, dirs=dirs,
                cli=cli, data=data)


# ---- (a) the layer ----

LAYER_CASES = {"ample": (8.0, False), "drops": (1.0, False),
               "ties": (2.0, True)}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_moe_layer_matches_jax(name):
    cf, zero_router = LAYER_CASES[name]
    jm = JMoEFFN(16, 32, 4, top_k=2, capacity_factor=cf)
    p = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    if not zero_router:
        p["router"] = np.random.default_rng(1).standard_normal(
            (16, 4)).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((2, 24, 16)).astype(
        np.float32)
    mesh = jmake_mesh(JMeshConfig())
    aux_specs = jax.tree.map(lambda _: P(), jaux_zeros(4))

    def run(params, x):
        y, aux = jm.apply(params, x)
        return jax.lax.psum(y, "ep"), aux

    jy, jaux = jax.jit(jax.shard_map(run, mesh=mesh,
                                     in_specs=(jm.specs(), P()),
                                     out_specs=(P(), aux_specs)))(p, x)
    logits = x.reshape(-1, 16) @ p["router"]
    jslots, jweights, _ = jax.jit(jm._route)(jnp.asarray(logits))
    layer = MoEFFN(16, 32, 4, top_k=2, capacity_factor=cf)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x), torch.float32)
        slots, weights, _ = route(torch.from_numpy(logits), 2, cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.array_equal(slots.numpy(), np.asarray(jslots))
    # one ulp apart at most: XLA's and torch's float32 exp differ there
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights),
                               rtol=1e-6, atol=0)
    dropped = float(aux["dropped"])
    assert (dropped > 0) == (name == "drops")
    if zero_router:       # every token ties: experts 0 and 1, lowest first
        C = capacity(48, 4, 2, cf)
        assert set(np.unique(slots.numpy() // C)) == {0, 1}


# ---- (b) the model ----

def _assemble(per_rank, key):
    """The global gradients (or the logits of the whole batch) from every
    rank's result."""
    c = lambda r: r["coords"]
    if key == "logits":
        rows = {}
        for r in per_rank:
            blk = c(r)["dp"] * 2 + c(r)["ep"] if "ep" in c(r) else 0
            rows.setdefault(blk, {})[c(r)["cp"]] = r["logits"]
        return np.concatenate([np.concatenate([rows[b][k] for k in
                                               sorted(rows[b])], axis=1)
                               for b in sorted(rows)])
    ep = max(c(r)["ep"] for r in per_rank) + 1
    tp = max(c(r)["tp"] for r in per_rank) + 1
    first = {(c(r)["ep"], c(r)["tp"]): r["grads"] for r in per_rank
             if c(r)["dp"] == 0 and c(r)["cp"] == 0}
    for r in per_rank:
        for k, g in r["grads"].items():
            assert np.array_equal(g, first[c(r)["ep"], c(r)["tp"]][k]), k
    return assemble_params([{k: torch.from_numpy(g) for k, g in
                             first[e, t].items()}
                            for e in range(ep) for t in range(tp)], ep)


@pytest.mark.parametrize("name", list(MODEL_RUNS))
def test_model_loss_logits_grads_match_jax(runs, name):
    per_rank = [r[0] for r in runs["res"][name]]
    jloss, jgrads, jlogits = runs["refs"]["drops" if name == "ep2_drops"
                                          else "one"]
    for r in per_rank:
        assert abs(r["loss"] - jloss) <= 1e-5 * abs(jloss)
    if name == "ep2_drops":
        assert per_rank[0]["moe"]["dropped_frac"] > 0
    else:
        assert per_rank[0]["moe"]["dropped_frac"] == 0
    logits = _assemble(per_rank, "logits")
    np.testing.assert_allclose(logits, jlogits[..., :logits.shape[-1]],
                               rtol=1e-4, atol=1e-4)
    grads = _assemble(per_rank, "grads")
    assert grads.keys() == jgrads.keys()
    for k, ref in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_gpt2_moe_matches_jax(runs):
    tree, batch = runs["trees"]["gpt2"], runs["trees"]["gpt2_batch"]
    jloss, jgrads, jlogits = runs["refs"]["gpt2"]
    model = build_model("gpt2", ModelConfig(**CFG))
    model.load_state_dict(params_from_jax(tree))
    ids, tgt, pos = (torch.from_numpy(x).long() for x in batch)
    loss = model.loss(ids, tgt, pos)
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    with torch.no_grad():
        np.testing.assert_allclose(model(ids, pos).numpy(), jlogits,
                                   rtol=1e-4, atol=1e-4)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ---- (c) Adam steps ----

def test_five_adam_steps_at_ep2_tp2_match_jax(runs):
    ref = runs["refs"]["trajectory"]
    for r in runs["res"]["trajectory"]:
        np.testing.assert_allclose(r[0]["losses"], ref, rtol=1e-4)


# ---- (d) checkpoints ----

def test_checkpoints_cross_both_ways_at_ep2_tp2(runs):
    jl1 = runs["refs"]["resume"][0][0]
    jl2, jparams = runs["refs"]["loaded"][0][0], runs["refs"]["loaded"][1]
    for r in runs["res"]["checkpoint"]:
        l1, l2 = r["losses"]
        assert abs(l1 - jl1) <= 1e-5 * abs(jl1)   # JAX's file, resumed
        assert abs(l2 - jl2) <= 1e-4 * abs(jl2)   # the port's, by JAX
    # the port's file: all E experts in each tp file, JAX's stamp
    sd, opt, step = checkpoint.load_checkpoint(runs["dirs"]["port"], 4,
                                               with_opt=True)
    assert step == opt.step == 4
    assert sd["layers.0.moe.gate"].shape == (4, 32, 64)
    jm, m = _jax_model(CFG, ep=2, tp=2)
    with np.load(sorted(__import__("glob").glob(
            runs["dirs"]["port"] + "/tprank-1_*.npz"))[0]) as f:
        assert f["param/layers/moe/gate"].shape == (2, 4, 32, 32)
        assert str(f["__layout__"]) == jlayout.make_layout(
            m, jm.canonical_specs()).to_json()
    # an ep 2 slice of it is those experts
    half, _, _ = checkpoint.load_checkpoint(runs["dirs"]["port"], 4,
                                            tp_size=2, tp_rank=1,
                                            ep_size=2, ep_rank=1)
    assert torch.equal(half["layers.1.moe.down"],
                       sd["layers.1.moe.down"][2:, 32:])


@pytest.mark.parametrize("axes", [dict(ep=2), dict(dp=2, ep=2)])
def test_layout_stamp_is_jax_bytes(axes):
    jm, m = _jax_model(CFG, **axes)
    theirs = jlayout.make_layout(m, jm.canonical_specs()).to_json()
    shapes = {k: v.shape for k, v in
              build_model("llama", ModelConfig(**CFG)).state_dict().items()}
    ours = layout.make_layout(axes, layout.canonical_specs(shapes)).to_json()
    assert ours == theirs


# ---- (e) serving ----

@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_engines_give_jax_tokens_where_choices_drop(runs, kind):
    ours = _port_engine_tokens(kind, runs["trees"]["serve"])
    assert ours == runs["refs"][kind]
    assert sum(len(t) for t in ours.values()) > len(PROMPTS)
    if kind == "slot":   # the drops change the tokens
        assert ours != _port_engine_tokens(kind, runs["trees"]["serve"],
                                           dict(SERVE,
                                                moe_capacity_factor=8.0))


def test_paged_engine_tp2_gives_jax_tokens(runs):
    r0, r1 = (r[0] for r in runs["res"]["serve"])
    assert r0["tokens"] == runs["refs"]["paged_tp2"]
    assert r0["dispatches"] == r1["dispatches"]


# ---- (f) evaluation, FLOPs, the CLIs, refusals ----

def test_doc_loss_matches_jax():
    tree = _tree(TIGHT)
    batch = _batch(np.random.default_rng(7))
    jm, m = _jax_model(TIGHT)
    jmeans, jreal = jm.make_doc_loss(m)(jax.tree.map(jnp.asarray, tree),
                                        *batch)
    model = build_model("llama", ModelConfig(**TIGHT))
    model.load_state_dict(params_from_jax(tree))
    means, real = model.doc_loss(*(torch.from_numpy(x).long()
                                   for x in batch))
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans),
                               rtol=1e-5, atol=1e-6)
    assert np.array_equal(real.numpy(), np.asarray(jreal))


def test_model_flops_of_45m_moe8_match_jax():
    ours = metrics.model_flops_per_step(model_preset("45m-moe8"), 32, 1000)
    theirs = jmetrics.model_flops_per_step(jmodel_preset("45m-moe8"), 32,
                                           1000)
    assert ours == theirs
    assert ours < metrics.model_flops_per_step(
        dataclasses.replace(model_preset("45m-moe8"), num_experts=0,
                            ffn_dim=8 * 2048), 32, 1000)


def test_train_cli_at_ep2_then_evaluate_and_generate(runs):
    cli = runs["cli"]
    assert (cli["ep"], cli["steps"], cli["dist_backend"]) == (2, 2, "gloo")
    assert np.isfinite(cli["losses"]).all()
    assert all(r["collectives"]["ep"]["calls"] > 0 for r in cli["ranks"])
    assert [p.split("/")[-1].split("_")[0] for p in cli["checkpoints"]] == [
        "tprank-0"]
    args = ["--ckpt_dir", runs["dirs"]["cli"], "-t", SHIPPED, "--no-bf16",
            "--device", "cpu"] + CLI_MODEL
    out = evaluate.evaluate(evaluate.get_eval_args(
        args + ["--data_path", runs["data"], "--batch_size", "4",
                "--max_decode_len", "12"]))
    assert np.isfinite(list(out["val_losses"].values())).all()
    texts = generate.main(args + ["--prompt", "hi", "--max_new_tokens", "4"])
    assert texts[0].startswith("hi")


def test_library_refusals_and_train_checks(tmp_path):
    # the JAX checks, with its messages: experts over ep, dense ep
    for experts, jax_fn in (
            (3, lambda: JMoEFFN(128, 512, 3, ep_size=2)),
            (0, lambda: JTransformer(JModelConfig(num_experts=0),
                                     ep_size=2))):
        with pytest.raises(ValueError) as theirs:
            jax_fn()
        flags = ["--num_experts", str(experts)]
        with pytest.raises(ValueError) as ours:
            train_cli.main(CLI_MODEL[:2] + flags + [
                "--data_path", "x", "--device", "cpu", "--ep_size", "2",
                "--dist_backend", "gloo"])
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit, match="dp_size\\*ep_size 4"):
        train_cli.main(CLI_MODEL + ["--data_path", "x", "--device", "cpu",
                                    "--ep_size", "2", "--dp_size", "2",
                                    "--batch_size", "6", "--dist_backend",
                                    "gloo"])
