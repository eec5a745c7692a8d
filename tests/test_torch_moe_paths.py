"""The MoE model on the port's serving and evaluation paths (PyTorch, gloo
ranks on the CPU) against the JAX package's, in float32: int8 decode
weights with experts, speculative decoding with a MoE target, cp-sharded
pages, the serving fleet, and `evaluate` / `generate` at --cp_size 2.

The serving shape is the JAX MoE tests' (d 32, 4 heads, 2 layers, vocab 96,
4 experts, top 2), the CLIs' the tiny preset with 4 experts (vocab 1024,
the shipped tokenizer's). Both packages get the same weights: a JAX `init`
tree with its zero router replaced by a seeded normal one, so tokens route
unevenly. Every case runs in two regimes of the capacity factor: cf 1.0,
where a dispatch of S tokens gives each expert max(4, S/2) slots and
choices drop, and cf 2.0 = E/k, where C >= S and nothing drops (a
token's output then depends on no other token of its dispatch).

(a) int8 decode weights: `quantize_decode_params` gives JAX's codes and
    scales byte for byte on the router (d, E) and the experts (E, d, f),
    (E, f, d), at tp 1 and as the tp 2 shards of JAX's output on the
    assembled tree (`down`'s scale over the tp-sharded f is the same on
    both ranks); with int8 weights the slot engine gives the JAX engine's
    tokens with drops, the paged engine without, at tp 1 and at tp 2;
(b) speculative decoding with a MoE target: JAX's `SpeculativeEngine`
    tokens and acceptance with a dense drafter where choices drop and with
    a MoE drafter (the target itself) where none do; without drops the
    tokens are the plain paged engine's, with either drafter, and drafter
    = target accepts every draft;
(c) cp-sharded pages: JAX's `PagedEngine(gather)` at cp 2 with drops and
    at cp 2 x tp 2 without (tokens, page tables after every step, stats,
    one cp hop per layer per dispatch on every rank); without drops the
    tokens are cp 1's;
(d) the fleet: without drops the router fleet's tokens are one engine's
    and JAX's fleet's, and `--disagg`'s too; with drops every token is in
    the vocabulary, every pool drains and the dropped share is reported;
(e) `evaluate --cp_size 2` with drops (the sweep's capacity from each
    rank's local tokens, the decode through the cp paged engine) gives
    JAX's losses within 1e-5, its decoded pairs and `val.txt`;
    `generate --cp_size 2` without drops JAX's texts;
(f) the `serve` (int8 weights, `--speculate`, `--paged --cp 2`, the slot
    engine at tp 2) and `serve_fleet` dry runs at `--model 45m-moe8` run to
    the end and report the dropped share, and the kept ranks hold no
    tensor after them.

The port's ranks run in one kept group of 2 and one of 4
(`launch.kept_groups`) while JAX's references run in threads.
"""

import gc
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu import evaluate as jevaluate
from distributed_pytorch_from_scratch_tpu import generate as jgenerate
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops import quant as jquant
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving import loadgen as jloadgen
from distributed_pytorch_from_scratch_tpu.serving import router as jrouter
from distributed_pytorch_from_scratch_tpu.serving.speculative import (
    SpeculativeEngine as JSpeculativeEngine)
from distributed_pytorch_from_scratch_tpu_torch import evaluate, generate
from distributed_pytorch_from_scratch_tpu_torch.config import MeshConfig
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.ops import quant
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import tp_dim
from distributed_pytorch_from_scratch_tpu_torch.parallel.moe import (
    dropped_share)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import (
    serve, serve_fleet, transfer)
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.serving.loadgen import (
    run_fleet_loadgen)
from distributed_pytorch_from_scratch_tpu_torch.serving.router import (
    FleetRouter)
from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
    SpeculativeEngine)
from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
    save_checkpoint)
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_decode_weights import _assert_q_equal, _flat, _port_as_jax


CFG = dict(attn_dim=32, ffn_dim=64, num_heads=4, num_layers=2,
           vocab_size=96, maxlen=64, num_experts=4, moe_top_k=2)
# the capacity factor of each regime (E / k = 2: C >= S, nothing drops)
REGIMES = {"drops": 1.0, "nodrop": 2.0}
DRAFT = dict(attn_dim=16, ffn_dim=32, num_heads=2, num_layers=1,
             vocab_size=96, maxlen=64)
BUF, EOS, TICK, MAX_NEW, STAGGER = 32, 1, 0.02, 10, 3
# a 10-token shared prefix that ends mid-page (copy-on-write, prefix hits)
PREFIX = [0, 5, 17, 33, 60, 2, 8, 9, 11, 40]
PROMPTS = [PREFIX + s for s in ([3, 7], [95, 4, 12, 6, 22], [70], [8, 8, 8],
                                [51, 13, 2, 9, 31, 77, 19])]
SLOT_KW = dict(num_slots=3, buf_len=BUF, eos_id=EOS, prefill_bucket=8,
               max_prefill_batch=2)
# 6 slots: at cf 1.0 a decode step's 12 choices meet 4 slots per expert
PAGED_KW = dict(num_slots=6, buf_len=BUF, eos_id=EOS, page_size=8,
                prefill_chunk=4)
SPEC_KW = dict(PAGED_KW, speculate_k=3)
KW = {"slot": SLOT_KW, "paged": PAGED_KW}
# (engine, regime) of the int8 cases, (drafter, regime) of the speculative
# ones held against JAX
INT8_CASES = [("slot", "drops"), ("paged", "nodrop")]
SPEC_CASES = [("dense", "drops"), ("moe", "nodrop")]
# the cp meshes, each in one regime
CP_CASES = {"cp2": "drops", "cp2tp2": "nodrop"}
CP_AXES = {"cp2": {"cp": 2}, "cp2tp2": {"cp": 2, "tp": 2}}
FLEET_KW = dict(num_slots=4, buf_len=BUF, eos_id=EOS, page_size=8,
                prefill_chunk=8)
# the CLIs' model: the tiny preset with 4 experts
SHIPPED = "tokenizer/tokenizer.json"
CLI_CFG = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
               vocab_size=1024, maxlen=64, num_experts=4, moe_top_k=2)
CLI_MODEL = ["--model", "tiny", "--num_experts", "4", "--maxlen", "64",
             "--no-bf16"]
GEN_PROMPTS = ["hello world", "The brave man"]
PORT_CPU2 = ["--device", "cpu", "--dist_backend", "gloo"]
DRY = ["--dry_run", "--device", "cpu", "--model", "45m-moe8"]
DRY_RUNS = {
    "int8": lambda: serve.main(DRY + ["--decode_weight_dtype", "int8"]),
    "speculate": lambda: serve.main(DRY + ["--paged", "--speculate", "2"]),
    "paged_cp": lambda: serve.main(DRY + ["--paged", "--cp", "2",
                                          "--dist_backend", "gloo"]),
    "slot_tp2": lambda: serve.main(DRY + ["--tp_size", "2",
                                          "--dist_backend", "gloo"]),
    "fleet": lambda: serve_fleet.main(DRY),
}
CPU = make_mesh(MeshConfig(), device="cpu")


def _cfg(regime, base=CFG):
    return dict(base, moe_capacity_factor=REGIMES[regime])


def _tree(cfg, seed=0):
    """A JAX init tree; a MoE one with a seeded normal router."""
    tree = jax.tree.map(np.asarray, JTransformer(JModelConfig(**cfg)).init(
        jax.random.key(seed)))
    if cfg.get("num_experts"):
        moe = tree["layers"]["moe"]
        moe["router"] = np.random.default_rng(seed + 100).standard_normal(
            moe["router"].shape).astype(np.float32)
    return tree


def _requests(cls, prompts=PROMPTS, max_new=MAX_NEW):
    return [cls(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]


def _tokens(reqs):
    return {r.rid: list(r.tokens) for r in reqs}


# ---- JAX's references ----

def _jax_model(cfg, tree, axes):
    mesh = jmake_mesh(JMeshConfig(**axes))
    jm = JTransformer(JModelConfig(**cfg), tp_size=axes.get("tp", 1),
                      cp_size=axes.get("cp", 1))
    return jm, mesh, jax.device_put(jax.tree.map(jnp.asarray, tree),
                                    jm.shardings(mesh))


def _jax_engine(cfg, tree, kind, kw, axes=None, drafter=None):
    """JAX's engine of `kind` (slot, paged or speculative with `drafter` =
    (cfg, tree), at tp = cp = 1), the paged ones on the gather impl under
    the scripted clock, on a mesh of `axes`, on the staggered drive:
    (tokens, page tables after every step, stats)."""
    axes = axes or {}
    jm, mesh, params = _jax_model(cfg, tree, axes)
    paged = dict(paged_attn_impl="gather",
                 clock=tp_checks.counting_clock(TICK))
    if kind == "slot":
        eng = jengine.ContinuousBatchingEngine(jm, mesh, params, **kw)
    elif kind == "paged":
        eng = jengine.PagedEngine(jm, mesh, params, **paged, **kw)
    else:
        dm, _, dparams = _jax_model(drafter[0], drafter[1], axes)
        eng = JSpeculativeEngine(jm, mesh, params, dm, dparams, **paged,
                                 **kw)
    toks, tables = tp_checks.drive(eng, _requests(jengine.Request), STAGGER)
    return toks, tables, eng.stats()


def _jax_fleet(cfg, tree):
    """JAX's 2-replica router fleet's tokens."""
    jm, mesh, params = _jax_model(cfg, tree, {})
    router = jrouter.FleetRouter([jengine.PagedEngine(
        jm, mesh, params, **FLEET_KW) for _ in range(2)], prefix_weight=0.5)
    reqs = _requests(jengine.Request)
    jloadgen.run_fleet_loadgen(router, reqs, session_key=lambda r: None)
    return _tokens(reqs)


def _jax_quantized(tree):
    jm, _, params = _jax_model(_cfg("drops"), tree, {})
    return _flat(jquant.quantize_decode_params(params, jm.specs())[0])


# ---- the port ----

def _port_engine(cfg, tree, kind, kw, drafter=None):
    """The port's engine of `kind` at tp 1 on the CPU (the paged attends on
    the kernel's plain version), on the staggered drive: ({rid: tokens},
    the engine)."""
    model = tp_checks._serving_model(CPU, cfg, tree)
    clock = dict(clock=tp_checks.counting_clock(TICK))
    if kind == "slot":
        eng = ContinuousBatchingEngine(model, CPU, **kw)
    elif kind == "paged":
        eng = PagedEngine(model, CPU, **clock, **kw)
    else:
        eng = SpeculativeEngine(
            model, CPU, tp_checks._serving_model(CPU, *drafter, cp_size=1),
            **clock, **kw)
    return tp_checks.drive(eng, _requests(Request), STAGGER)[0], eng


def _serve_run(kind, kw, **extra):
    return dict(engine=kind, kw=dict(kw, **extra),
                requests=[(list(p), MAX_NEW, "default", None)
                          for p in PROMPTS], stagger=STAGGER, tick=TICK)


def _corpus(path):
    rng = np.random.default_rng(0)
    docs = [rng.integers(3, 1024, size=int(n)).tolist()
            for n in rng.integers(5, 60, size=12)]
    with open(path, "w") as f:
        json.dump({"train": docs, "validation": docs[:6],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": 1024}, f)


def _engines():
    """How many serving engines of the port this process holds."""
    return sum(issubclass(type(o), (ContinuousBatchingEngine, PagedEngine))
               for o in gc.get_objects())


def _cf(regime):
    return ["--moe_capacity_factor", str(REGIMES[regime])]


def _gen_args(ckpt, regime):
    args = ["--ckpt_dir", ckpt, "-t", SHIPPED, "--max_new_tokens", "8",
            "--cp_size", "2"] + CLI_MODEL + _cf(regime)
    for p in GEN_PROMPTS:
        args += ["--prompt", p]
    return args


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_paths")
    tree = _tree(CFG)          # the init does not read the capacity factor
    trees = {r: tree for r in REGIMES}
    dtree = _tree(DRAFT, seed=1)
    src = str(root / "ckpt")
    save_checkpoint(src, 10, 5.0, params_from_jax(_tree(CLI_CFG, seed=2)))
    data = str(root / "tokens.json")
    _corpus(data)
    eval_args = lambda name: [
        "--data_path", data, "--ckpt_dir",
        shutil.copytree(src, str(root / name)), "-t", SHIPPED,
        "--batch_size", "4", "--max_decode_len", "12", "--cp_size", "2"] \
        + CLI_MODEL + _cf("drops")

    # the port's ranks: the int8 codes and the int8 paged engine at tp 2,
    # cp 2 (group of 2); cp 2 x tp 2 (group of 4)
    todo2 = [("quantized_params", {"tp": 2},
              dict(cfg=_cfg("drops"), tree=trees["drops"])),
             ("serve_runs", {"tp": 2}, dict(
                 cfg=_cfg("nodrop"), tree=trees["nodrop"], runs=[_serve_run(
                     "paged", PAGED_KW, paged_attn_impl="kernel",
                     decode_weight_dtype="int8")]))]
    cp_job = lambda mesh: ("serve_runs", CP_AXES[mesh], dict(
        cfg=_cfg(CP_CASES[mesh]), tree=trees[CP_CASES[mesh]],
        runs=[_serve_run("paged", PAGED_KW, paged_attn_impl="kernel")]))
    todo2.append(cp_job("cp2"))
    todo4 = [cp_job("cp2tp2")]

    def group2():
        ranks = launch.spawn(tp_checks.jobs, 2, todo2)
        # from here on the ranks' collector is off: `live_tensors` counts
        # what a reference cycle of the calls below would keep
        launch.spawn(tp_checks.jobs, 2, [("hold_garbage", {"tp": 2}, {})])
        port_eval = evaluate.evaluate(evaluate.get_eval_args(
            eval_args("port") + PORT_CPU2))
        gen = generate.main(_gen_args(src, "nodrop") + PORT_CPU2)
        gc.collect()
        gc.disable()
        try:
            before = _engines()
            dry = {name: fn() for name, fn in DRY_RUNS.items()}
            # the engines of the in-process runs that only a reference
            # cycle still keeps
            dry["engines_left"] = _engines() - before
        finally:
            gc.enable()
        # what the ranks still hold after every call above
        dry["live"] = launch.spawn(tp_checks.jobs, 2, [
            ("live_tensors", {"tp": 2}, {})])
        return ranks, port_eval, gen, dry

    jax_refs = {
        "quantized": lambda: _jax_quantized(trees["drops"]),
        "eval": lambda: jevaluate.evaluate(jevaluate.get_eval_args(
            eval_args("jax"))),
        "generate": lambda: jgenerate.main(_gen_args(src, "nodrop")),
    }
    for kind, r in INT8_CASES:
        jax_refs[("int8", kind, r)] = lambda k=kind, r=r: _jax_engine(
            _cfg(r), trees[r], k, dict(KW[k], decode_weight_dtype="int8"))
    for drafter, r in SPEC_CASES:
        jax_refs[("spec", drafter, r)] = lambda d=drafter, r=r: _jax_engine(
            _cfg(r), trees[r], "spec", SPEC_KW, drafter=(
                (DRAFT, dtree) if d == "dense" else (_cfg(r), trees[r])))
    for mesh, r in CP_CASES.items():
        jax_refs[mesh] = lambda m=mesh, r=r: _jax_engine(
            _cfg(r), trees[r], "paged", PAGED_KW, CP_AXES[m])
    jax_refs["fleet"] = lambda: _jax_fleet(_cfg("nodrop"), trees["nodrop"])
    with launch.kept_groups(), ThreadPoolExecutor(max_workers=6) as pool:
        g2 = pool.submit(group2)
        g4 = pool.submit(launch.spawn, tp_checks.jobs, 4, todo4)
        futures = {k: pool.submit(f) for k, f in jax_refs.items()}
        refs = {k: f.result() for k, f in futures.items()}
        ranks2, port_eval, gen, dry = g2.result()
        ranks4 = g4.result()
    res = {"quantized_tp2": [r[0] for r in ranks2],
           "int8_tp2": [r[1][0] for r in ranks2],
           "cp2": [r[2][0] for r in ranks2],
           "cp2tp2": [r[0][0] for r in ranks4]}
    return dict(trees=trees, dtree=dtree, refs=refs, res=res, root=root,
                port_eval=port_eval, gen=gen, dry=dry)


# ---- (a) int8 decode weights ----

def _assemble(ranks):
    """The tp ranks' quantized shards -> the assembled quantized state dict:
    codes joined on the leaf's tp dim, scales too unless the scale reduces
    that dim (then every rank holds the same one)."""
    out = {}
    for key, leaf in ranks[0].items():
        dim = tp_dim(key)
        join = lambda part: np.concatenate([r[key][part] if part else r[key]
                                            for r in ranks], dim)
        if not isinstance(leaf, dict):
            out[key] = leaf if dim is None else join(None)
            continue
        if dim is None or dim == quant._reduce_dim(key, leaf["qweight"].ndim):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key]["scale"], leaf["scale"])
            scale = leaf["scale"]
        else:
            scale = join("scale")
        out[key] = {"qweight": leaf["qweight"] if dim is None
                    else join("qweight"), "scale": scale}
    return out


def _port_quantized(tree):
    model = tp_checks._serving_model(CPU, _cfg("drops"), tree)
    q = quant.quantize_decode_params(model.state_dict())
    return {k: ({n: v.numpy() for n, v in leaf.items()}
                if isinstance(leaf, dict) else leaf.detach().numpy())
            for k, leaf in q.items()}


@pytest.mark.parametrize("tp", [1, 2])
def test_int8_expert_codes_and_scales_match_jax(runs, tp):
    if tp == 1:
        ours = _port_quantized(runs["trees"]["drops"])
    else:
        ours = _assemble(runs["res"]["quantized_tp2"])
    flat = _port_as_jax(ours, CFG["num_layers"])
    _assert_q_equal(flat, runs["refs"]["quantized"])
    # the router's and the experts' scales run over JAX's axis -2: d for
    # the router and gate/up, f for down
    E, d, f = CFG["num_experts"], CFG["attn_dim"], CFG["ffn_dim"]
    L = CFG["num_layers"]
    assert flat["param/layers/moe/router"]["scale"].shape == (L, 1, E)
    assert flat["param/layers/moe/gate"]["scale"].shape == (L, E, 1, f)
    assert flat["param/layers/moe/down"]["scale"].shape == (L, E, 1, d)


@pytest.mark.parametrize("kind,regime", INT8_CASES)
def test_int8_engines_match_jax(runs, kind, regime):
    kw = dict(KW[kind], decode_weight_dtype="int8")
    ours, eng = _port_engine(_cfg(regime), runs["trees"][regime], kind, kw)
    assert ours == runs["refs"][("int8", kind, regime)][0]
    assert sum(map(len, ours.values())) > len(PROMPTS)
    # the experts' weights are codes now: about a quarter of the f32 bytes
    moe = eng.model.layers[0]["moe"]
    assert moe.gate_q.dtype == moe.down_q.dtype == moe.router_q.dtype
    assert "gate" not in dict(eng.model.named_parameters())
    share = eng.stats()["moe_dropped_share"]
    assert (share > 0) if regime == "drops" else share == 0.0


def test_int8_paged_engine_tp2_matches_jax(runs):
    r0, r1 = runs["res"]["int8_tp2"]
    assert r0["tokens"] == runs["refs"][("int8", "paged", "nodrop")][0]
    assert r0["drained"] and r0["dispatches"] == r1["dispatches"]


# ---- (b) speculative decoding ----

@pytest.mark.parametrize("drafter,regime", SPEC_CASES)
def test_speculative_moe_target_matches_jax(runs, drafter, regime):
    tree = runs["trees"][regime]
    dr = (DRAFT, runs["dtree"]) if drafter == "dense" else (_cfg(regime),
                                                            tree)
    ours, eng = _port_engine(_cfg(regime), tree, "spec", SPEC_KW, dr)
    toks, _, stats = runs["refs"][("spec", drafter, regime)]
    assert ours == toks
    st = eng.stats()
    for k in ("spec_rounds", "accepted_tokens_per_dispatch",
              "acceptance_rate", "generated_tokens", "cow_copies"):
        assert st[k] == stats[k], k
    assert tp_checks._drained(eng)


def test_speculative_without_drops_is_plain_and_accepts_all(runs):
    """The no-drop identities: speculative greedy = plain greedy (either
    drafter), and drafter = target accepts every draft."""
    cfg, tree = _cfg("nodrop"), runs["trees"]["nodrop"]
    plain, _ = _port_engine(cfg, tree, "paged", PAGED_KW)
    for drafter in ((DRAFT, runs["dtree"]), (cfg, tree)):
        ours, eng = _port_engine(cfg, tree, "spec", SPEC_KW, drafter)
        assert ours == plain
    assert eng.stats()["acceptance_rate"] == 1.0
    assert runs["refs"][("spec", "moe", "nodrop")][0] == plain


# ---- (c) cp-sharded pages ----

@pytest.mark.parametrize("mesh", list(CP_CASES))
def test_cp_paged_engine_matches_jax(runs, mesh):
    ranks = runs["res"][mesh]
    toks, tables, stats = runs["refs"][mesh]
    r0 = ranks[0]
    assert r0["tokens"] == toks
    assert len(r0["tables"]) == len(tables)
    for i, (a, b) in enumerate(zip(r0["tables"], tables)):
        assert np.array_equal(a, b), ("step", i)
    ours = dict(r0["stats"])
    share = ours.pop("moe_dropped_share")
    assert ours == {k: ("kernel" if k == "paged_attn" else stats[k])
                    for k in ours}
    assert (share > 0) if CP_CASES[mesh] == "drops" else share == 0.0
    assert r0["drained"] and stats["cp"] == 2
    # every rank runs the same dispatches, one cp hop per layer of each
    model_dispatches = sum(n for k, n in r0["dispatches"].items()
                           if k != "cow_copy")
    for r in ranks:
        assert r["dispatches"] == r0["dispatches"]
        assert r["cp_hops"] == CFG["num_layers"] * model_dispatches


def test_cp2_without_drops_gives_cp1_tokens(runs):
    cp1, _ = _port_engine(_cfg("nodrop"), runs["trees"]["nodrop"], "paged",
                          PAGED_KW)
    assert runs["res"]["cp2tp2"][0]["tokens"] == cp1


# ---- (d) the fleet ----

def _fleet(regime, tree, replicas=2):
    models = [tp_checks._serving_model(CPU, _cfg(regime), tree)
              for _ in range(replicas)]
    router = FleetRouter([(f"r{i}", PagedEngine(m, CPU, **FLEET_KW))
                          for i, m in enumerate(models)], prefix_weight=0.5)
    reqs = _requests(Request)
    summary = run_fleet_loadgen(router, reqs, session_key=lambda r: None)
    return _tokens(reqs), router, summary


def test_fleet_without_drops_is_one_engine_and_jax(runs):
    tree = runs["trees"]["nodrop"]
    ours, router, summary = _fleet("nodrop", tree)
    model = tp_checks._serving_model(CPU, _cfg("nodrop"), tree)
    single = PagedEngine(model, CPU, **FLEET_KW)
    for r in _requests(Request):
        single.submit(r)
    single.run_to_completion()
    single = _tokens(single.completed)
    assert ours == runs["refs"]["fleet"] == single
    assert min(router.dispatched.values()) >= 1, router.dispatched
    pre = PagedEngine(model, CPU, prefill_only=True, **FLEET_KW)
    dec = PagedEngine(model, CPU, **FLEET_KW)
    out = transfer.run_disaggregated(pre, dec, _requests(Request))
    assert _tokens(out["completed"]) == single
    for eng in [e for _, e in router.replicas] + [pre, dec]:
        assert tp_checks._drained(eng)


def test_fleet_with_drops_holds_its_invariants(runs):
    ours, router, summary = _fleet("drops", runs["trees"]["drops"])
    assert summary["completed"] == len(PROMPTS)
    assert all(0 <= t < CFG["vocab_size"] and len(v) >= 1
               for v in ours.values() for t in v)
    for _, e in router.replicas:
        assert tp_checks._drained(e)
    share = dropped_share(e.model for _, e in router.replicas)
    assert 0 < share < 1


# ---- (e) evaluate and generate at cp 2 ----

def test_evaluate_cp2_matches_jax(runs):
    ours, theirs = runs["port_eval"], runs["refs"]["eval"]
    assert sorted(ours["val_losses"]) == sorted(theirs["val_losses"]) == [10]
    assert abs(ours["val_losses"][10] - theirs["val_losses"][10]) < 1e-5
    assert ours["decoded"] == [tuple(p) for p in theirs["decoded"]]
    assert ours["prefill_dispatches"] >= 1 and len(ours["ranks"]) == 2
    root = str(runs["root"])
    lines = lambda name: open(os.path.join(root, name, "val", "val.txt")
                              ).read().replace(os.path.join(root, name), "")
    assert lines("port") == lines("jax")


def test_generate_cp2_matches_jax(runs):
    ours, theirs = runs["gen"], runs["refs"]["generate"]
    assert ours == theirs
    assert all(o.startswith(p) for o, p in zip(ours, GEN_PROMPTS))


# ---- (f) the CLIs' dry runs ----

def test_kept_ranks_hold_no_tensors_between_calls(runs):
    """After the evaluate, generate and serve calls at tp 2 and cp 2, no
    rank of the kept group holds a tensor, with its garbage collector off
    since before them: a worker runs its dispatches under inference mode,
    as the leader does, so no autograd graph ties the caches to the
    weights, and an engine's dispatcher holds its lowerings weakly, so no
    reference cycle keeps the engine."""
    assert [r[0] for r in runs["dry"]["live"]] == [0, 0]


def test_served_engines_need_no_collector(runs):
    """The in-process dry runs (int8, speculative, the fleet) leave no
    engine behind with the garbage collector off: nothing but a caller
    keeps an engine's pool and weights."""
    assert runs["dry"]["engines_left"] == 0


@pytest.mark.parametrize("case", list(DRY_RUNS))
def test_moe_serving_dry_runs(runs, case):
    out = runs["dry"][case]
    assert out["completed"] == out["requests"] > 0
    share = out.get("moe_dropped_share",
                    out.get("engine_stats", {}).get("moe_dropped_share"))
    assert 0 <= share < 1
