"""The port's serving fleet at tp > 1 (PyTorch, two gloo ranks on the CPU)
against the JAX package's, at the tiny preset (d 128, 4 heads, 2 layers,
vocab 1024) in float32, pages of 8, six prompts behind one full shared
page.

The port's runs go through `runtime/fleet_checks.py` in one spawned group
of two ranks, in the background while JAX builds its references (its
engines on the virtual CPU devices at tp 1 and tp 2, one init shared with
the port through `interop.params_from_jax`).

(a) `PagedKVPool.export_pages` / `import_pages` sharded over the ranks:
    a tp 2 pool takes a global-head payload and exports it back byte for
    byte, as JAX's tp 2 pool does, native and int8, and a tp 1 pool takes
    the tp 2 export on unchanged (and the other way); a cp 2 pool leases
    owners [0, 1, 1] as pages [0, 8, 9], exports them back, and rolls a
    payload too large for it back whole, as JAX's.
(b) the router fleet of two replicas at tp 2: tokens and `dispatched`
    equal JAX's fleet at tp 2 and the single engine's tokens; every pool
    drains; both ranks ran the same dispatches.
(c) disaggregated at (prefill tp, decode tp) in {(2, 1), (1, 2), (2, 2)}
    native and (2, 1) int8: tokens equal the colocated engine's (JAX's),
    and the frames' blobs (dtype, global-head shape, bytes) equal JAX's
    run_disaggregated's.
(d) `reshard_params` 2 -> 1 and 1 -> 2: every leaf equals JAX's
    `reshard_params` of the same tree; a replica restarted at the other
    width serves the second wave with the single engine's tokens, its
    `replica_restart` event carries the plan's summary as JAX's planner
    gives it; the CLI refuses a width whose padded vocab differs, in
    JAX's words.
(e) `serve_fleet` at tp 2 (`--dry_run --device cpu --dist_backend gloo`):
    the router fleet, `--disagg --prefill_tp 2` into decode tp 1 and
    `--restart_tp 1` give the tp 1 fleet's keys and serve every request.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.reshard import (
    make_layout as jmake_layout, plan_reshard as jplan_reshard)
from distributed_pytorch_from_scratch_tpu.reshard.apply import (
    reshard_params as jreshard_params)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving import (
    kv_manager as jkv_manager)
from distributed_pytorch_from_scratch_tpu.serving import router as jrouter
from distributed_pytorch_from_scratch_tpu.serving import (
    transfer as jtransfer)
from distributed_pytorch_from_scratch_tpu.training.checkpoint import (
    _flatten as jflatten)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    fleet_checks, launch)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import serve_fleet
from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
    PagedKVPool)
from _torch_threads import two_torch_threads  # noqa: F401


TINY = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
            vocab_size=1024, maxlen=256)
BUF, EOS, PS, NEW = 32, 1, 8, 6
_BASE = [0, 5, 17, 33, 60, 2, 4, 6]
PROMPTS = [_BASE + [7], _BASE + [9, 11], _BASE + [3, 5, 7, 11],
           _BASE + [13], _BASE + [21, 23], _BASE + [25]]
REQS = [(p, NEW) for p in PROMPTS]
ENGINE = dict(num_slots=4, buf_len=BUF, eos_id=EOS, page_size=PS,
              prefill_chunk=PS)
DISAGG = [(2, 1, None), (1, 2, None), (2, 2, None), (2, 1, "int8")]
RESTART = [(2, 1), (1, 2)]
DRY = ["--dry_run", "--device", "cpu", "--dist_backend", "gloo"]
CLI_RUNS = {"fleet": ["--tp_size", "2"],
            "disagg": ["--disagg", "--prefill_tp", "2"],
            "restart": ["--tp_size", "2", "--restart_tp", "1"]}


def _jengine(params, tp, **kw):
    jmodel = JTransformer(JModelConfig(**TINY), tp_size=tp)
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    return jengine.PagedEngine(
        jmodel, mesh, jax.device_put(params, jmodel.shardings(mesh)),
        **dict(ENGINE, **kw))


def _jreqs(rid0=0):
    return [jengine.Request(rid=rid0 + i, prompt=list(p), max_new=NEW)
            for i, p in enumerate(PROMPTS)]


def _toks(reqs):
    return {r.rid: list(r.tokens) for r in reqs}


def _jpool(tp=1, cp=1, kv=None, num_pages=8):
    model = SimpleNamespace(cfg=JModelConfig(**TINY), cp_size=cp)
    return jkv_manager.PagedKVPool(model, jmake_mesh(JMeshConfig(tp=tp,
                                                                 cp=cp)),
                                   num_pages, PS, kv_dtype=kv)


def _payload(pool, n, rng):
    def one(a):
        shape = (a.shape[0], n) + tuple(a.shape[2:])
        if np.issubdtype(np.dtype(a.dtype), np.integer):
            return rng.integers(-100, 100, shape).astype(a.dtype)
        return rng.standard_normal(shape).astype(a.dtype)
    return tuple(jax.tree.map(one, x) for x in (pool.ks, pool.vs))


def _flat(kv):
    return [np.asarray(a) for x in kv
            for a in (x if isinstance(x, tuple) else (x,))]


def _jax_frames(pre, dec):
    """JAX's run_disaggregated with each frame's blobs recorded."""
    frames = []
    send = jtransfer.send_frame

    def taped(sock, header, blobs):
        frames.append([(b.dtype.name, list(b.shape), b.nbytes)
                       for b in blobs])
        return send(sock, header, blobs)

    jtransfer.send_frame = taped
    try:
        res = jtransfer.run_disaggregated(pre, dec, _jreqs())
    finally:
        jtransfer.send_frame = send
    return _toks(res["completed"]), frames, res["transferred_pages"]


def _jax_refs(params, tree, pool_cases):
    out = {}
    single = _jengine(params, 1)
    for r in _jreqs():
        single.submit(r)
    out["coloc"] = _toks(single.run_to_completion())
    b, c = _jengine(params, 2), _jengine(params, 2)
    router = jrouter.FleetRouter([b, c], prefix_weight=0.5)
    reqs = _jreqs()
    for r in reqs:
        router.submit(r)
    router.run_to_completion()
    out["fleet"] = (_toks(reqs), dict(router.dispatched))
    for kv in (None, "int8"):
        dec = single if kv is None else _jengine(params, 1, kv_dtype=kv)
        out[("disagg", kv)] = _jax_frames(
            _jengine(params, 2, prefill_only=True, kv_dtype=kv), dec)
    # the pools: the same payloads into JAX's tp 2 and cp 2 pools
    pools = []
    for case in pool_cases:
        pool = _jpool(case["tp"], case["cp"], case["kv"], case["num_pages"])
        pages = pool.import_pages(case["k"], case["v"], case["owners"])
        pools.append((pages, _flat(pool.export_pages(pages))))
    out["pools"] = pools
    # the planner on JAX's own flat tree, and reshard_params both ways
    plans, leaves = {}, {}
    for src, dst in RESTART:
        model_s = JTransformer(JModelConfig(**TINY), tp_size=src)
        model_d = JTransformer(JModelConfig(**TINY), tp_size=dst)
        flat = jflatten(tree, "param")
        plans[(src, dst)] = jplan_reshard(
            sorted(flat), {k: tuple(v.shape) for k, v in flat.items()},
            {k: v.dtype.itemsize for k, v in flat.items()},
            jmake_layout((("tp", src),), model_s.specs()),
            jmake_layout((("tp", dst),), model_d.specs())).summary()
        live = jax.device_put(params, model_s.shardings(
            jmake_mesh(JMeshConfig(tp=src))))
        moved = jreshard_params(live, jmake_mesh(JMeshConfig(tp=dst)),
                                model_d.specs())
        leaves[(src, dst)] = jax.tree.map(np.asarray, moved)
    out["plans"], out["leaves"] = plans, leaves
    return out


def _pool_cases(rng):
    jp = lambda kv, tp=1, cp=1, n=8: _jpool(tp, cp, kv, n)
    cases = []
    for kv in (None, "int8"):
        k, v = _payload(jp(kv), 3, rng)
        cases.append(dict(tp=2, cp=1, kv=kv, num_pages=8, page_size=PS,
                          k=k, v=v, owners=None))
    k, v = _payload(jp(None), 3, rng)
    big = _payload(jp(None), 14, rng)
    cases.append(dict(tp=1, cp=2, kv=None, num_pages=16, page_size=PS,
                      k=k, v=v, owners=[0, 1, 1], big=big))
    return cases


@pytest.fixture(scope="module")
def runs():
    jmodel = JTransformer(JModelConfig(**TINY), tp_size=1)
    params = jmodel.init(jax.random.key(7))
    tree = jax.tree.map(np.asarray, params)
    cases = _pool_cases(np.random.default_rng(3))
    fleet = [dict(kind="fleet", tp=2, requests=REQS)]
    fleet += [dict(kind="disagg", prefill_tp=p, decode_tp=d, kv=kv,
                   requests=REQS) for p, d, kv in DISAGG]
    fleet += [dict(kind="restart", tp=s, restart_tp=d, requests=REQS,
                   requests2=REQS, prefix_weight=0.0) for s, d in RESTART]
    todo = [("pool_cases", dict(cfg=TINY, cases=cases)),
            ("fleet_runs", dict(cfg=TINY, tree=tree, runs=fleet,
                                engine_kw=ENGINE))]
    todo += [("reshard_leaves", dict(cfg=TINY, tree=tree, src_tp=s,
                                     dst_tp=d)) for s, d in RESTART]
    with ThreadPoolExecutor(max_workers=2) as pool:
        group = pool.submit(launch.spawn, fleet_checks.jobs, 2, todo)
        cli = pool.submit(lambda: {
            name: serve_fleet.run(serve_fleet.parse_args(DRY + flags))[0]
            for name, flags in CLI_RUNS.items()})
        refs = _jax_refs(params, tree, cases)
        port = group.result()
        cli = cli.result()
    cli["tp1"] = serve_fleet.run(serve_fleet.parse_args(
        ["--dry_run", "--device", "cpu"]))[0]
    return dict(tree=tree, cases=cases, refs=refs, port=port, cli=cli)


def _rank0(runs, job):
    return runs["port"][0][job]


# ---- (a) ----

@pytest.mark.parametrize("i", [0, 1], ids=["native", "int8"])
def test_tp2_pool_payload_matches_jax_both_ways(runs, i):
    case = runs["cases"][i]
    got = _rank0(runs, 0)[i]
    pages, want = runs["refs"]["pools"][i]
    assert got["pages"] == pages == [0, 1, 2]
    exp = _flat(got["export"])
    for a, b, c in zip(exp, want, _flat((case["k"], case["v"]))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(a, c)
    assert a.shape[2] == TINY["num_heads"]          # the global heads
    # a tp 1 pool takes the tp 2 export on unchanged, and back
    one = PagedKVPool(SimpleNamespace(cfg=ModelConfig(**TINY), cp_size=1,
                                      num_local_kv_heads=4),
                      make_mesh(MeshConfig(), device="cpu"), 8, PS,
                      kv_dtype=case["kv"])
    back = one.export_pages(one.import_pages(*got["export"]))
    assert all(np.array_equal(x, y) for x, y in zip(_flat(back), exp))
    assert _rank0(runs, 0)[i]["free"] == 8 - 3
    assert runs["port"][1][0][i]["pages"] == pages     # lockstep leases


def test_cp2_pool_owner_mapping_and_rollback_match_jax(runs):
    case = runs["cases"][2]
    got = _rank0(runs, 0)[2]
    pages, want = runs["refs"]["pools"][2]
    assert got["pages"] == pages == [0, 8, 9]
    for a, b in zip(_flat(got["export"]), want):
        assert np.array_equal(a, b)
    assert got["raised"] and got["free_after_big"] == got["free"] == 13
    assert runs["port"][1][0][2]["pages"] == pages


# ---- (b) ----

def _lockstep(runs, i):
    r0 = _rank0(runs, 1)[i]["ranks"]
    r1 = runs["port"][1][1][i]["ranks"]
    for name, rec in r1.items():
        assert rec == r0[name], name
    return r0


def test_tp2_router_fleet_matches_jax_and_one_engine(runs):
    got = _rank0(runs, 1)[0]
    toks, dispatched = runs["refs"]["fleet"]
    assert got["tokens"] == toks == runs["refs"]["coloc"]
    assert got["dispatched"] == dispatched
    assert min(dispatched.values()) >= 1
    assert all(got["drained"])
    ranks = _lockstep(runs, 0)
    assert set(ranks) == {"r0", "r1"}
    assert all(r["counts"]["paged_decode"] > 0 for r in ranks.values())


# ---- (c) ----

@pytest.mark.parametrize("i", range(len(DISAGG)),
                         ids=[f"p{p}d{d}-{kv or 'native'}"
                              for p, d, kv in DISAGG])
def test_disagg_across_widths_matches_colocated_and_jax(runs, i):
    p, d, kv = DISAGG[i]
    got = _rank0(runs, 1)[1 + i]
    toks, frames, pages = runs["refs"][("disagg", kv)]
    assert got["tokens"] == toks == runs["refs"]["coloc"]
    assert got["pages"] == pages == sum(-(-len(q) // PS) for q in PROMPTS)
    assert sorted(map(str, got["frames"])) == sorted(map(str, frames))
    assert all(got["drained"])
    ranks = _lockstep(runs, 1 + i)
    assert ranks["prefill"]["counts"]["export_pages"] == len(PROMPTS)
    assert ranks["decode"]["counts"]["import_pages"] == len(PROMPTS)


# ---- (d) ----

@pytest.mark.parametrize("j", range(len(RESTART)),
                         ids=[f"tp{s}to{d}" for s, d in RESTART])
def test_reshard_params_leaves_match_jax(runs, j):
    src, dst = RESTART[j]
    want = runs["refs"]["leaves"][(src, dst)]
    for r in range(dst):
        got = runs["port"][r][2 + j]
        ref = params_from_jax(want, dst, r)
        assert set(got) == set(ref)
        for k in ref:
            assert np.array_equal(got[k], ref[k].numpy()), (r, k)
    assert all(runs["port"][r][2 + j] is None for r in range(dst, 2))


@pytest.mark.parametrize("j", range(len(RESTART)),
                         ids=[f"tp{s}to{d}" for s, d in RESTART])
def test_restarted_replica_serves_one_engines_tokens(runs, j):
    src, dst = RESTART[j]
    got = _rank0(runs, 1)[1 + len(DISAGG) + j]
    coloc = runs["refs"]["coloc"]
    want = {**coloc, **{rid + 100: t for rid, t in coloc.items()}}
    assert got["tokens"] == want
    assert got["served_after"] >= 1
    assert all(got["drained"])
    (ev,) = got["events"]
    plan = runs["refs"]["plans"][(src, dst)]
    assert ev["replica"] == "r1"
    assert set(ev["reshard"]) == set(plan) | {"wall_ms"}
    assert {k: ev["reshard"][k] for k in plan} == plan
    assert got["hop_bytes"] > 0
    _lockstep(runs, 1 + len(DISAGG) + j)


def test_restart_refuses_a_width_with_other_vocab_padding():
    args = serve_fleet.parse_args(
        ["--device", "cpu", "--model", "tiny", "--vocab_size", "1023",
         "--random_init", "--restart_tp", "2"])
    with pytest.raises(SystemExit, match="vocab padding differs between "
                                         "tp1 \\(1023\\) and tp2 \\(1024\\)"):
        serve_fleet.run(args)


# ---- (e) ----

@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_serve_fleet_cli_at_tp2(runs, name):
    out = runs["cli"][name]
    assert out["completed"] == 8
    ranks = out["ranks"]
    assert len(ranks) == 2 and ranks[1]["rank"] == 1
    if name == "fleet":
        tp1 = runs["cli"]["tp1"]
        assert set(out) - {"ranks"} == set(tp1)
    elif name == "disagg":
        assert (out["prefill_tp"], out["decode_tp"]) == (2, 1)
        assert ranks[0]["kv_gather"]["calls"] > 0
        assert ranks[1]["kv_gather"]["calls"] == ranks[0]["kv_gather"][
            "calls"]
    else:
        assert out["mode"] == "fleet+restart"
        assert out["restart"]["src"] == "tp2 zero0"
        assert out["restart"]["dst"] == "single zero0"
        assert out["restart"]["hops"]["hop_bytes"] > 0
