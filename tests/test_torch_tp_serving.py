"""The port's serving at tp > 1 (PyTorch, two gloo ranks on the CPU) against
the JAX package's engines at tp 2, at the tiny preset (d 128, 4 heads, 2
layers, vocab 1024) in float32.

JAX runs its engines on the virtual CPU devices over `make_mesh(tp=2)`;
the port runs one engine per rank in spawned processes
(`runtime/launch.spawn`, the rank programs `tp_checks.serve_runs` and
`tp_checks.decode_logits`): tp rank 0 drives the scheduler and broadcasts
each dispatch, rank 1 serves them. One group runs every engine case, in
the background while JAX computes its references.

(a) the slot engine and the paged engine (native and int8 pages, a shared
    prefix that ends mid-page so copy-on-write runs, and an
    oversubscribed pool that preempts) at tp 2 give greedy tokens and
    stats (dispatches, decode steps, COW copies, prefix hits, preemptions,
    and the rest) identical to the JAX engines at tp 2, the paged engine
    under one scripted clock with its page table after every step; both
    ranks ran the same dispatches; the paged runs equal the port's own tp
    1;
(b) `_prefill`, `_decode_one` and `_paged_decode_one` at tp 2: the logits
    gathered over the ranks within 1e-5 of JAX's;
(c) the CLI: `serve --tp_size 2 --device cpu --dist_backend gloo` from
    `--random_init` gives tp 1's tokens; a tp 2 checkpoint written by the
    JAX trainer serves at tp 2 and at tp 1 with the JAX engine's tokens;
    no card without `--device cpu` and `--tp_size 2 --cp 2` are refused.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models import decode as jdecode
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops.rope import (
    rope_tables as jrope_tables)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving.kv_manager import POOL_SPEC
from distributed_pytorch_from_scratch_tpu.serving.loadgen import (
    synthetic_requests as jsynthetic_requests)
from distributed_pytorch_from_scratch_tpu.training.checkpoint import (
    save_checkpoint as jsave_checkpoint)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.ops import collectives
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
    KVCachePool, PagedKVPool, kv_token_bytes, page_bytes)
from distributed_pytorch_from_scratch_tpu_torch.serving.tp_dispatch import (
    Dispatcher)
from _torch_threads import two_torch_threads  # noqa: F401


TINY = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
            vocab_size=1024, maxlen=256)
BUF, EOS, SEED = 32, 1, 3
# the slot engine's load: the CLI's seeded burst (serve --seed SEED)
LOAD = dict(num=6, prompt_len_min=4, prompt_len_max=12, max_new=8,
            vocab_size=1024, seed=SEED, arrival="burst")
SLOT_KW = dict(num_slots=3, buf_len=BUF, eos_id=EOS, prefill_bucket=8,
               max_prefill_batch=2)
CLI = ["--model", "tiny", "--no-bf16", "--vocab_size", "1024",
       "--num_requests", "6", "--arrival", "burst", "--prompt_len_min", "4",
       "--prompt_len_max", "12", "--max_new_tokens", "8", "--seed",
       str(SEED), "--slots", "3", "--buf_len", str(BUF), "--prefill_bucket",
       "8", "--max_prefill_batch", "2", "--device", "cpu"]
TP2 = ["--tp_size", "2", "--dist_backend", "gloo"]

# the paged cases: a 10-token shared prefix ends mid-page at page size 8,
# so sharers copy that page before they write (COW) and hit the prefix
PREFIX = [0, 5, 17, 33, 60, 2, 8, 9, 11, 40]
SHARED = [PREFIX + s for s in ([3, 7], [95, 4, 12, 6, 22], [70], [8, 8, 8],
                               [51, 13, 2, 9, 31, 77, 19], [44])]
SLO_PROMPTS = [[0, 5, 9, 60, 2, 8, 33], [0, 11, 4, 7, 21, 35, 2],
               [0, 44, 17, 8, 52, 3, 71]]
PAGED = {  # name: (engine kwargs, prompts, max_new, stagger)
    "native": (dict(num_slots=2, page_size=8, prefill_chunk=4), SHARED, 10,
               3),
    "int8": (dict(num_slots=2, page_size=8, prefill_chunk=4,
                  kv_dtype="int8"), SHARED, 10, 3),
    "preempt": (dict(num_slots=3, page_size=8, num_pages=4,
                     prefill_chunk=8), SLO_PROMPTS, 12, 0),
}
TICK = 0.02


def _jax(tp=2, seed=7):
    jmodel = JTransformer(JModelConfig(**TINY), tp_size=tp)
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    params = jmodel.init(jax.random.key(seed))
    return jmodel, mesh, params


def _paged_requests(name):
    _, prompts, max_new, _ = PAGED[name]
    return [(list(p), max_new, "default", None) for p in prompts]


def _jax_paged(jmodel, mesh, sharded, name):
    kw, _, _, stagger = PAGED[name]
    eng = jengine.PagedEngine(jmodel, mesh, sharded, buf_len=BUF,
                              eos_id=EOS, paged_attn_impl="gather",
                              clock=tp_checks.counting_clock(TICK), **kw)
    reqs = [jengine.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m, _, _) in enumerate(_paged_requests(name))]
    toks, tables = tp_checks.drive(eng, reqs, stagger)
    return toks, tables, eng.stats()


def _jax_slot(jmodel, mesh, sharded):
    """The JAX slot engine on the seeded burst: once with the staggered
    drive (tokens and stats), then, on the same engine, submitted at once
    as the CLI's loadgen does (tokens)."""
    eng = jengine.ContinuousBatchingEngine(jmodel, mesh, sharded, **SLOT_KW)
    toks, _ = tp_checks.drive(eng, jsynthetic_requests(**LOAD), 1)
    stats = eng.stats()
    eng.completed.clear()
    for r in jsynthetic_requests(**LOAD):
        eng.submit(r)
    eng.run_to_completion()
    return toks, stats, {r.rid: list(r.tokens) for r in eng.completed}


def _decode_calls(rng, cfg):
    """Inputs of one prefill, two slot decode steps and two paged decode
    steps, made from `rng`: [(kind, args, page_size)], the caches and pools
    filled with random values (every kv head)."""
    L, kvh, hd = cfg["num_layers"], cfg["num_heads"], 32
    b, t, ps, pages = 3, 24, 8, 10
    buf = rng.integers(3, 1024, (b, 16)).astype(np.int32)
    calls = [("prefill", (buf, np.array([16, 5, 11], np.int32)), None)]
    for cur in ([4, 17, 23], [0, 9, 12]):
        cache = lambda: rng.standard_normal((L, b, kvh, t, hd), np.float32)
        calls.append(("decode", (cache(), cache(),
                                 rng.integers(3, 1024, b).astype(np.int32),
                                 np.array(cur, np.int32)), None))
    tbl = np.array([[3, 7, 1, 0], [5, 2, 9, pages], [4, 6, 8, pages]],
                   np.int32)
    for cur in ([30, 14, 20], [2, 21, 9]):
        pool = lambda: rng.standard_normal((L, pages + 1, kvh, ps, hd),
                                           np.float32)
        calls.append(("paged_decode", (pool(), pool(),
                                       rng.integers(3, 1024, b).astype(
                                           np.int32),
                                       np.array(cur, np.int32), tbl), ps))
    return calls


def _jax_logits(jmodel, mesh, sharded, kind, args, ps):
    """The JAX lowering at tp 2 under shard_map: its logits, gathered over
    the vocab shards by the out spec."""
    cos, sin = jrope_tables(TINY["maxlen"], jmodel.cfg.head_dim)

    def fn(params, *a):
        if kind == "prefill":
            return jdecode._prefill(jmodel, params, *a, cos, sin,
                                    jnp.float32)[2]
        if kind == "decode":
            return jdecode._decode_one(jmodel, params, *a, a[0].shape[3],
                                       cos, sin, jnp.float32)[2]
        return jdecode._paged_decode_one(jmodel, params, *a, ps, cos, sin,
                                         jnp.float32)[2]

    cache = 0 if kind == "prefill" else 2
    specs = (POOL_SPEC,) * cache + (P(),) * (len(args) - cache)
    run = jax.jit(jax.shard_map(fn, mesh=mesh,
                                in_specs=(jmodel.specs(),) + specs,
                                out_specs=P(None, "tp")))
    return np.asarray(run(sharded, *(jnp.asarray(a) for a in args)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmodel, mesh, params = _jax()
    tree = jax.tree.map(np.asarray, params)
    sharded = jax.device_put(params, jmodel.shardings(mesh))
    calls = _decode_calls(np.random.default_rng(4), TINY)
    slot_reqs = [(r.prompt, r.max_new, "default", None)
                 for r in jsynthetic_requests(**LOAD)]
    serve_jobs = [dict(engine="slot", kw=SLOT_KW, requests=slot_reqs,
                       stagger=1, tick=TICK)]
    for name, (kw, _, _, stagger) in PAGED.items():
        serve_jobs.append(dict(engine="paged", kw=dict(
            kw, buf_len=BUF, eos_id=EOS, paged_attn_impl="kernel"),
            requests=_paged_requests(name), stagger=stagger, tick=TICK))
    todo = [("serve_runs", {"tp": 2}, dict(cfg=TINY, tree=tree,
                                           runs=serve_jobs)),
            ("decode_logits", {"tp": 2}, dict(
                cfg=TINY, tree=tree, calls=[dict(kind=k, args=a,
                                                 page_size=ps)
                                            for k, a, ps in calls]))]
    ckpt = str(tmp_path_factory.mktemp("tp2_ckpt"))
    jsave_checkpoint(ckpt, 4, 2.5, tree, jmodel.specs(), 2)
    with ThreadPoolExecutor(max_workers=3) as pool:
        group = pool.submit(launch.spawn, tp_checks.jobs, 2, todo)
        cli_seed = pool.submit(serve.main, CLI + TP2 + ["--random_init"])
        cli_ckpt = pool.submit(serve.main, CLI + TP2 + ["--ckpt_dir", ckpt])
        refs = {"slot": _jax_slot(jmodel, mesh, sharded),
                "paged": {n: _jax_paged(jmodel, mesh, sharded, n)
                          for n in PAGED},
                "logits": [_jax_logits(jmodel, mesh, sharded, *c)
                           for c in calls]}
        port = group.result()
        cli = {"seed": cli_seed.result(), "ckpt": cli_ckpt.result()}
    cli["seed_tp1"] = serve.main(CLI + ["--random_init"])
    cli["ckpt_tp1"] = serve.main(CLI + ["--ckpt_dir", ckpt])
    return dict(tree=tree, refs=refs, port=port, cli=cli,
                names=["slot"] + list(PAGED))


def _case(runs, name):
    """(rank 0's result, rank 1's) of the serve job `name`."""
    i = runs["names"].index(name)
    return [rank[0][i] for rank in runs["port"]]


# ---- (a) ----

def _assert_lockstep(r0, r1):
    assert r0["dispatches"] == r1["dispatches"]
    assert r0["shapes"] == r1["shapes"]
    assert sum(r0["dispatches"].values()) > 0


def test_slot_engine_tp2_matches_jax(runs):
    r0, r1 = _case(runs, "slot")
    toks, stats, _ = runs["refs"]["slot"]
    assert r0["tokens"] == toks
    assert sum(len(t) for t in toks.values()) > LOAD["num"]  # real decoding
    assert r0["stats"] == stats
    _assert_lockstep(r0, r1)
    assert r0["dispatches"]["slot_decode"] == stats["decode_steps"]


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_engine_tp2_matches_jax(runs, name):
    r0, r1 = _case(runs, name)
    toks, tables, stats = runs["refs"]["paged"][name]
    assert sorted(r0["tokens"]) == list(range(len(PAGED[name][1])))
    assert r0["tokens"] == toks, name
    assert len(r0["tables"]) == len(tables)
    for i, (a, b) in enumerate(zip(r0["tables"], tables)):
        assert np.array_equal(a, b), (name, "step", i)
    assert r0["stats"] == {k: ("kernel" if k == "paged_attn" else stats[k])
                           for k in r0["stats"]}
    _assert_lockstep(r0, r1)
    d = r0["dispatches"]
    assert d["paged_decode"] == stats["decode_steps"]
    assert d["paged_chunk"] > 0
    assert d["cow_copy"] <= stats["cow_copies"]
    if name == "preempt":
        assert stats["preemptions"] > 0
    else:
        assert stats["cow_copies"] > 0 and stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_engine_tp2_equals_port_tp1(runs, name):
    """The port's tp 1 engine (in this process) on the same tree and
    clock: the same tokens and stats as its tp 2."""
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine, Request)
    kw, _, _, stagger = PAGED[name]
    r0, _ = _case(runs, name)
    mesh = make_mesh(MeshConfig(), device="cpu")
    model = tp_checks._serving_model(mesh, TINY, runs["tree"])
    eng = PagedEngine(model, mesh, buf_len=BUF, eos_id=EOS,
                      clock=tp_checks.counting_clock(TICK), **kw)
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m, _, _) in enumerate(_paged_requests(name))]
    toks, tables = tp_checks.drive(eng, reqs, stagger)
    assert toks == r0["tokens"]
    assert eng.stats() == r0["stats"]
    assert all(np.array_equal(a, b) for a, b in zip(tables, r0["tables"]))
    assert eng.dispatch.counts == r0["dispatches"]


# ---- (b) ----

def test_decode_logits_tp2_match_jax(runs):
    refs = runs["refs"]["logits"]
    got0, got1 = (rank[1] for rank in runs["port"])
    assert len(got0) == len(refs) == 5
    for i, (a, b, ref) in enumerate(zip(got0, got1, refs)):
        assert a.shape == ref.shape == (3, TINY["vocab_size"]), i
        np.testing.assert_array_equal(a, b)       # every rank, the same
        assert np.abs(a - ref).max() < 1e-5, (i, np.abs(a - ref).max())


def test_pools_hold_local_heads_and_bytes_count_all():
    """At tp 2 each rank's pools hold kv_heads / 2 heads; the byte counts
    stay those of every kv head, as JAX counts them."""
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)

    cfg = ModelConfig(**TINY)
    one = Transformer(cfg)
    # a tp 2 rank's model and mesh, as far as the pools read them
    two = SimpleNamespace(cfg=cfg, num_local_kv_heads=cfg.kv_heads // 2)
    mesh = SimpleNamespace(device=torch.device("cpu"))
    slot = KVCachePool(two, mesh, num_slots=2, buf_len=16)
    paged = PagedKVPool(two, mesh, num_pages=3, page_size=8,
                        kv_dtype="int8")
    assert slot.ks.shape == (2, 3, 2, 16, 32)
    assert paged.ks[0].shape == (2, 4, 2, 8, 32)
    assert paged.ks[1].shape == (2, 4, 2, 8)
    assert one.num_local_kv_heads == 4
    assert kv_token_bytes(cfg) == 2 * 2 * 4 * 32 * 4
    assert page_bytes(cfg, 8, "int8") == 2 * 2 * 4 * (32 + 4) * 8


def test_dispatcher_at_tp1_runs_the_lowering_with_no_broadcast():
    collectives.reset_stats()
    seen = []
    d = Dispatcher(make_mesh(MeshConfig(), device="cpu"),
                   {"cow_copy": lambda shape, p: seen.append((shape, p))})
    d("cow_copy", (3,), np.array([[1, 2], [4, 5]]))
    d.stop()
    assert seen[0][0] == (3, 0, 0, 0, 0, 0)
    assert seen[0][1].dtype == np.int32
    assert seen[0][1].tolist() == [1, 2, 4, 5]
    assert d.counts == {"cow_copy": 1}
    assert collectives.total_stats()["dispatch"]["calls"] == 0
    with pytest.raises(RuntimeError, match="decides the dispatches"):
        d.serve()


# ---- (c) ----

def test_cli_tp2_serves_tp1_tokens_from_random_init(runs):
    tp2, tp1 = runs["cli"]["seed"], runs["cli"]["seed_tp1"]
    assert tp2["completed"] == tp2["requests"] == 6
    assert tp2["outputs"] == tp1["outputs"]
    assert tp2["engine_stats"] == tp1["engine_stats"]
    ranks = tp2["ranks"]
    assert [r["tp"] for r in ranks] == [0, 1]
    assert ranks[0]["dispatches"] == ranks[1]["dispatches"]
    n = sum(ranks[0]["dispatches"].values())
    layers = TINY["num_layers"]
    for r in ranks:
        # the wo and down_proj all-reduces, the embedding's and the logits
        # gather; the dispatch broadcasts (a header and a payload each, and
        # the stop) apart
        assert r["tp_hops"]["calls"] == (2 * layers + 2) * n
        assert r["dispatch_broadcasts"]["calls"] == 2 * n + 1
    assert tp1["ranks"][0]["dispatch_broadcasts"]["calls"] == 0


def test_cli_serves_jax_tp2_checkpoint_at_tp2_and_tp1(runs):
    jax_tokens = runs["refs"]["slot"][2]
    assert runs["cli"]["ckpt"]["outputs"] == jax_tokens
    assert runs["cli"]["ckpt_tp1"]["outputs"] == jax_tokens


def test_cli_tp2_refusals(monkeypatch):
    with pytest.raises(SystemExit) as e:
        serve.main(["--dry_run", "--device", "cpu", "--tp_size", "2",
                    "--cp", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        serve.main(["--dry_run", "--device", "cpu", "--tp_size", "3"])
    assert "not divisible by tp_size 3" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        serve.main(["--dry_run", "--device", "cpu", "--tp_size", "2",
                    "--dist_backend", "nccl"])
    assert "gloo" in str(e.value.code)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        serve.main(["--dry_run", "--tp_size", "2"])
    assert e.value.code not in (0, None)
    assert "no CUDA card" in str(e.value.code)
