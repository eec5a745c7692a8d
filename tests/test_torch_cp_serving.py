"""The port's cp-sharded paged serving (PyTorch, gloo ranks on the CPU)
against the JAX package's `PagedEngine` on the same mesh, at the tiny
preset (d 128, 4 heads, 2 layers, vocab 1024) in float32.

At cp > 1 each cp rank holds 1/cp of the KV pages (`PagedKVPool`: its slab
+ a local scratch page), every layer attends each rank's own pages and the
ranks' partial (o, lse) merge in one all-gather (`decode.cp_combine`).
JAX runs its engine with the gather impl on the virtual CPU devices over
`make_mesh(cp=2[, tp=2])`; the port runs one engine per rank in spawned
processes (`runtime/launch.spawn`, `tp_checks.jobs`), rank 0 driving the
scheduler and broadcasting every dispatch: one group at cp 2 and one at
cp 2 x tp 2, in the background while JAX computes its references.

(a) at cp 2 and cp 2 x tp 2, page size 8 and 16, native and int8 pages,
    the gather and kernel impls (the kernel's plain version here): greedy
    tokens, the page table after every step and `stats()` equal to JAX's
    engine at the same mesh under one scripted clock (a shared prefix
    ending mid-page, so copy-on-write runs), the tokens equal to the
    port's cp = 1 engine, every rank in lockstep with one cp hop per layer
    per dispatch, the pools drained;
(b) the first chunk's logits and a decode step's (every position of the
    chunk, across the two ranks' pages) within 1e-5 of JAX's lowering at
    cp 1 on the same pool, native and int8 pages, both impls;
(c) the counterparts of JAX's `tests/test_serving_cp.py`: COW on a shared
    prefix, preempt and resume, chunk-boundary invariance (chunk 4, 5 -> 6,
    64), and at equal per-rank page bytes cp 2 serves a request that cp 1
    refuses at submit;
(d) `cp_combine` within 1e-6 of JAX's `_cp_combine`, dead ranks and
    all-dead rows included;
(e) the speculative target at cp 2 (the drafter at cp 1 on every rank):
    the tokens of the port's plain paged engine at cp 2 and of JAX's
    `SpeculativeEngine` at cp 2;
(f) the pool's slabs and free lists, the refusals, and the CLI:
    `serve --paged --cp 2 --dry_run` gives cp 1's tokens.
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
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving.kv_manager import (
    KV_SCALE_SPEC as SCALE_SPEC, POOL_SPEC)
from distributed_pytorch_from_scratch_tpu.serving.speculative import (
    SpeculativeEngine as JSpeculativeEngine)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
    PagedKVPool, local_page_ids)
from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
    SpeculativeEngine)
from _torch_threads import two_torch_threads  # noqa: F401


TINY = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
            vocab_size=1024, maxlen=256)
DRAFT = dict(attn_dim=32, ffn_dim=64, num_heads=1, num_layers=1,
             vocab_size=1024, maxlen=256)
BUF, EOS, TICK, SEED = 32, 1, 0.02, 7
# a 10-token shared prefix ends mid-page at page size 8: sharers copy that
# page before they write (COW) and hit the prefix
PREFIX = [0, 5, 17, 33, 60, 2, 8, 9, 11, 40]
SHARED = [PREFIX + s for s in ([3, 7], [95, 4, 12, 6, 22], [70], [8, 8, 8],
                               [51, 13, 2, 9, 31, 77, 19], [44])]
MAX_NEW, STAGGER = 10, 3
MATRIX = [(ps, kv, impl) for ps in (8, 16) for kv in (None, "int8")
          for impl in ("gather", "kernel")]
MESHES = {"cp2": {"cp": 2}, "cp2tp2": {"cp": 2, "tp": 2}}
MKW = lambda ps, kv: dict(num_slots=2, buf_len=BUF, eos_id=EOS,
                          page_size=ps, prefill_chunk=4, kv_dtype=kv)
# the counterparts of JAX's test_serving_cp.py cases: name -> (engine
# kwargs, prompts, max_new, stagger)
_rng = np.random.default_rng(5)
LONG = [0] + [int(t) for t in _rng.integers(3, 1024, size=39)]
_rng = np.random.default_rng(9)
EQUAL = [0] + [int(t) for t in _rng.integers(3, 1024, size=34)]
COW_PRE = [0, 7, 3, 9, 22, 41, 5, 13, 28, 31, 6, 44, 2, 19, 55, 8, 60, 12]
CASES = {
    "cow": (dict(num_slots=3, buf_len=BUF, eos_id=EOS, page_size=8,
                 prefill_chunk=32),
            [COW_PRE + [70], COW_PRE + [80], COW_PRE + [90, 33]], 8, 3),
    "preempt": (dict(num_slots=3, buf_len=BUF, eos_id=EOS, page_size=8,
                     num_pages=4, prefill_chunk=8),
                [[0, 5, 9, 60, 2, 8, 33], [0, 11, 4, 7, 21, 35, 2],
                 [0, 44, 17, 8, 52, 3, 71]], 12, 0),
    **{f"chunk{c}": (dict(num_slots=2, buf_len=48, eos_id=EOS, page_size=8,
                          prefill_chunk=c), [[0, 5, 9], LONG], 6, 1)
       for c in (4, 5, 64)},
    # 35 + 5 tokens = 5 pages of 8: cp 1 with 4 pages refuses it, cp 2 with
    # 8 (4 per rank, the same page bytes per rank) serves it
    "equal_bytes": (dict(num_slots=1, buf_len=48, eos_id=EOS, page_size=8,
                         num_pages=8, prefill_chunk=8), [EQUAL], 5, 0),
}
SPEC_KW = dict(num_slots=2, buf_len=BUF, eos_id=EOS, page_size=8,
               prefill_chunk=4, speculate_k=3)
# every stat JAX's speculative engine shares with the port's
SPEC_KEYS = ("decode_steps", "generated_tokens", "completed", "spec_rounds",
             "accepted_tokens_per_dispatch", "acceptance_rate",
             "preemptions", "cow_copies", "prefix_hit_tokens",
             "pages_in_use", "cp", "pages_per_rank", "num_pages")


def _requests(cls, prompts, max_new):
    return [cls(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]


def _run(engine, kw, prompts, max_new, stagger, **extra):
    return dict(engine=engine, kw=dict(kw, **extra),
                requests=[(list(p), max_new, "default", None)
                          for p in prompts], stagger=stagger, tick=TICK)


def _logit_calls(rng, ps):
    """A chunk of 8 positions from 11 (the prefix in random pages) whose
    positions cross from cp rank 0's columns into rank 1's, then a decode
    step at the chunk's end: (kind, args) over a whole pool of 8 pages +
    scratch, native and int8. Each column's page comes from the slab of
    the rank that owns the column at cp 2 (pages 0-3: rank 0, 4-7: rank
    1), as the engine leases them."""
    L, kvh, hd, pages = 2, 4, 32, 8
    mp = 32 // ps
    half = mp // 2                       # columns per cp rank
    tbl = np.empty((2, mp), np.int32)
    for o in range(2):
        slab = o * 4 + rng.permutation(4)
        tbl[:, o * half:(o + 1) * half] = slab[:2 * half].reshape(2, half)
    start = np.array([11, 3], np.int32)
    qlen = np.array([8, 5], np.int32)
    dstp = np.full((2, 8), pages, np.int32)
    dsto = np.tile(np.arange(8, dtype=np.int32) % ps, (2, 1))
    for r in range(2):
        for i in range(qlen[r]):
            dstp[r, i] = tbl[r, (start[r] + i) // ps]
            dsto[r, i] = (start[r] + i) % ps
    shape = (L, pages + 1, kvh, ps, hd)
    out = {}
    for kv in (None, "int8"):
        if kv:
            pool = lambda: (rng.integers(-127, 128, shape).astype(np.int8),
                            (0.01 + 0.04 * rng.random(shape[:-1])).astype(
                                np.float32))
        else:
            pool = lambda: rng.standard_normal(shape).astype(np.float32)
        pk, pv = pool(), pool()
        chunk = rng.integers(3, 1024, (2, 8)).astype(np.int32)
        out[kv] = [("paged_chunk", (pk, pv, chunk, start, qlen, tbl, dstp,
                                    dsto)),
                   ("paged_decode", (pk, pv, chunk[:, 0].copy(),
                                     start + qlen, tbl))]
    return out


def _jax_logits(jmodel, params, kind, args, ps):
    """JAX's gather lowering at cp 1 under shard_map on a tp=1 mesh: the
    chunk's logits at every position, or the decode step's."""
    mesh = jmake_mesh(JMeshConfig(tp=1))
    quantized = isinstance(args[0], tuple)
    spec = (POOL_SPEC, SCALE_SPEC) if quantized else POOL_SPEC
    chunk = kind == "paged_chunk"

    def fn(p, pk, pv, *a):
        cos, sin = jdecode.rope_tables(TINY["maxlen"], jmodel.cfg.head_dim)
        if chunk:
            return jdecode._paged_prefill_chunk(
                jmodel, p, pk, pv, *a, ps, cos, sin, jnp.float32,
                all_logits=True)[2]
        return jdecode._paged_decode_one(jmodel, p, pk, pv, *a, ps, cos,
                                         sin, jnp.float32)[2]

    run = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(jmodel.specs(), spec, spec)
        + (P(),) * (len(args) - 2),
        out_specs=P(None, None, "tp") if chunk else P(None, "tp")))
    pools = [jax.tree.map(jnp.asarray, a) for a in args[:2]]
    return np.asarray(run(params, *pools,
                          *(jnp.asarray(a) for a in args[2:])))


def _jax_engine(tree, axes, kw, prompts, max_new, stagger, spec=None):
    """JAX's paged (or speculative, with `spec` = the drafter tree) engine,
    gather impl, on a cp x tp mesh under the scripted clock: (tokens, page
    tables after every step, stats)."""
    cp, tp = axes.get("cp", 1), axes.get("tp", 1)
    mesh = jmake_mesh(JMeshConfig(cp=cp, tp=tp))
    jm = JTransformer(JModelConfig(**TINY), tp_size=tp, cp_size=cp)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    clock = tp_checks.counting_clock(TICK)
    if spec is None:
        eng = jengine.PagedEngine(jm, mesh, params, paged_attn_impl="gather",
                                  clock=clock, **kw)
    else:
        dm = JTransformer(JModelConfig(**DRAFT), tp_size=tp)
        dparams = jax.device_put(jax.tree.map(jnp.asarray, spec),
                                 dm.shardings(mesh))
        eng = JSpeculativeEngine(jm, mesh, params, dm, dparams,
                                 paged_attn_impl="gather", clock=clock, **kw)
    toks, tables = tp_checks.drive(eng, _requests(jengine.Request, prompts,
                                                  max_new), stagger)
    return toks, tables, eng.stats()


def _jax_combine(o, lse):
    mesh = jmake_mesh(JMeshConfig(cp=2))
    spec = P("cp")
    fn = jax.jit(jax.shard_map(
        lambda a, b: jdecode._cp_combine(a[0], b[0])[None], mesh=mesh,
        in_specs=(spec, spec), out_specs=spec))
    return np.asarray(fn(jnp.asarray(o), jnp.asarray(lse)))[0]


def _combine_inputs():
    """Partials of two ranks over (b 3, h 4, t 5, hd 8): rank 1 dead on
    row 0, rank 0 dead on row 1, both dead on row 2 (a free row)."""
    rng = np.random.default_rng(3)
    o = rng.standard_normal((2, 3, 4, 5, 8)).astype(np.float32)
    lse = (3 * rng.standard_normal((2, 3, 4, 5))).astype(np.float32)
    for r, row in ((1, 0), (0, 1), (0, 2), (1, 2)):
        o[r, row], lse[r, row] = 0.0, -1e30
    return o, lse


@pytest.fixture(scope="module")
def runs():
    jm = JTransformer(JModelConfig(**TINY))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(SEED)))
    dtree = jax.tree.map(np.asarray, JTransformer(JModelConfig(**DRAFT))
                         .init(jax.random.key(SEED + 1)))
    rng = np.random.default_rng(11)
    calls = {ps: _logit_calls(rng, ps) for ps in (8, 16)}
    logit_jobs = [dict(kind=k, args=a, page_size=ps, attn_impl=impl,
                       all_logits=k == "paged_chunk")
                  for ps in (8, 16) for kv in (None, "int8")
                  for k, a in calls[ps][kv] for impl in ("gather", "kernel")]
    matrix = [_run("paged", MKW(ps, kv), SHARED, MAX_NEW, STAGGER,
                   paged_attn_impl=impl) for ps, kv, impl in MATRIX]
    cases = [_run("paged", kw, p, m, s, paged_attn_impl="kernel")
             for kw, p, m, s in CASES.values()]
    spec = [dict(_run("speculative", SPEC_KW, SHARED, MAX_NEW, STAGGER,
                      paged_attn_impl="kernel"), drafter=(DRAFT, dtree)),
            _run("paged", SPEC_KW, SHARED, MAX_NEW, STAGGER,
                 paged_attn_impl="kernel")]
    del spec[1]["kw"]["speculate_k"]
    o, lse = _combine_inputs()
    kw = dict(cfg=TINY, tree=tree)
    todo = {
        "cp2": [("serve_runs", MESHES["cp2"],
                 dict(kw, runs=matrix + cases + spec)),
                ("decode_logits", MESHES["cp2"], dict(kw, calls=logit_jobs)),
                ("combine", MESHES["cp2"], dict(o=o, lse=lse))],
        "cp2tp2": [("serve_runs", MESHES["cp2tp2"], dict(kw, runs=matrix)),
                   ("decode_logits", MESHES["cp2tp2"],
                    dict(kw, calls=logit_jobs))],
    }
    dry = ["--paged", "--dry_run", "--device", "cpu"]
    with ThreadPoolExecutor(max_workers=3) as pool:
        groups = {"cp2": pool.submit(launch.spawn, tp_checks.jobs, 2,
                                     todo["cp2"]),
                  "cp2tp2": pool.submit(launch.spawn, tp_checks.jobs, 4,
                                        todo["cp2tp2"]),
                  "cli": pool.submit(serve.main, dry + [
                      "--cp", "2", "--dist_backend", "gloo"])}
        jmatrix = {(name, ps, kv): _jax_engine(tree, axes, MKW(ps, kv),
                                               SHARED, MAX_NEW, STAGGER)
                   for name, axes in MESHES.items()
                   for ps in (8, 16) for kv in (None, "int8")}
        jspec = _jax_engine(tree, MESHES["cp2"], SPEC_KW, SHARED, MAX_NEW,
                            STAGGER, spec=dtree)
        params = jax.tree.map(jnp.asarray, tree)
        jax_calls = {id(c["args"]): c for c in logit_jobs}   # impl apart
        by_args = {k: _jax_logits(jm, params, c["kind"], c["args"],
                                  c["page_size"])
                   for k, c in jax_calls.items()}
        jlogits = [by_args[id(c["args"])] for c in logit_jobs]
        jcombine = _jax_combine(o, lse)
        port = {k: g.result() for k, g in groups.items()}
    cli1 = serve.main(dry)
    return dict(tree=tree, port=port, jmatrix=jmatrix, jspec=jspec,
                jlogits=jlogits, jcombine=jcombine, combine_in=(o, lse),
                cli1=cli1, n_matrix=len(matrix), n_cases=len(cases))


def _ranks(runs, mesh, job, i):
    """Every rank's result of job `job`, item `i`, in the `mesh` group."""
    return [rank[job][i] for rank in runs["port"][mesh]]


_ORACLES = {}


def _oracle(tree, kw, prompts, max_new):
    """The port's cp = 1 engine in this process, every prompt admitted at
    once into a pool with pages to spare (no preemption), the gather
    attend (its tokens are the kernel's, tests/test_torch_paged.py):
    {rid: tokens}, computed once per engine shape and load."""
    kw = dict(kw, num_pages=0, paged_attn_impl="gather")
    key = repr((sorted(kw.items()), prompts, max_new))
    if key not in _ORACLES:
        mesh = make_mesh(MeshConfig(), device="cpu")
        model = tp_checks._serving_model(mesh, TINY, tree)
        eng = PagedEngine(model, mesh, clock=tp_checks.counting_clock(TICK),
                          **dict(kw, num_slots=len(prompts)))
        _ORACLES[key] = tp_checks.drive(
            eng, _requests(Request, prompts, max_new), 0)[0]
    return _ORACLES[key]


def _assert_lockstep(ranks, layers=TINY["num_layers"]):
    """Every rank ran the same dispatches, and one cp hop per layer per
    model dispatch (the copy-on-write dispatches have none)."""
    d = ranks[0]["dispatches"]
    model_dispatches = sum(n for k, n in d.items() if k != "cow_copy")
    assert model_dispatches > 0
    for r in ranks:
        assert r["dispatches"] == d and r["shapes"] == ranks[0]["shapes"]
        assert r["cp_hops"] == layers * model_dispatches


# ---- (a) ----

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("ps,kv,impl", MATRIX)
def test_cp_engine_matches_jax_and_cp1(runs, mesh, ps, kv, impl):
    ranks = _ranks(runs, mesh, 0, MATRIX.index((ps, kv, impl)))
    r0 = ranks[0]
    toks, tables, stats = runs["jmatrix"][(mesh, ps, kv)]
    assert sorted(r0["tokens"]) == list(range(len(SHARED)))
    assert r0["tokens"] == toks
    assert sum(len(t) for t in toks.values()) > len(SHARED)
    assert len(r0["tables"]) == len(tables)
    for i, (a, b) in enumerate(zip(r0["tables"], tables)):
        assert np.array_equal(a, b), ("step", i)
    assert r0["stats"] == {k: (impl if k == "paged_attn" else stats[k])
                           for k in r0["stats"]}
    assert stats["cp"] == 2 and stats["pages_per_rank"] * 2 == \
        stats["num_pages"]
    assert stats["cow_copies"] > 0 and stats["prefix_hit_tokens"] > 0
    assert r0["drained"]
    _assert_lockstep(ranks)
    assert _oracle(runs["tree"], MKW(ps, kv), SHARED, MAX_NEW) \
        == r0["tokens"]


# ---- (b) ----

@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_chunk_and_decode_logits_match_jax(runs, mesh):
    got = [rank[1] for rank in runs["port"][mesh]]
    refs = runs["jlogits"]
    assert len(got[0]) == len(refs) == 16
    for i, ref in enumerate(refs):
        for g in got[1:]:
            np.testing.assert_array_equal(got[0][i], g[i])  # every rank
        a = got[0][i]
        if a.ndim == 3:                    # a chunk: its valid columns
            qlen = [8, 5]
            diff = max(np.abs(a[r, :n] - ref[r, :n]).max()
                       for r, n in enumerate(qlen))
        else:
            diff = np.abs(a - ref).max()
        assert diff < 1e-5, (i, diff)


# ---- (c) ----

@pytest.mark.parametrize("name", list(CASES))
def test_cp_serving_cases(runs, name):
    """COW, preempt-resume, chunk-boundary invariance and equal bytes at
    cp 2: the tokens of the port's uninterrupted cp = 1 engine (pages to
    spare, at the widest of the cases' chunks); every page back on its
    owner's free list."""
    kw, prompts, max_new, stagger = CASES[name]
    ranks = _ranks(runs, "cp2", 0, runs["n_matrix"] + list(CASES).index(name))
    r0 = ranks[0]
    assert r0["tokens"] == _oracle(runs["tree"], dict(kw, prefill_chunk=64),
                                   prompts, max_new)
    assert r0["drained"]
    _assert_lockstep(ranks)
    st = r0["stats"]
    assert st["cp"] == 2 and st["pages_per_rank"] == st["num_pages"] // 2
    if name == "cow":
        assert st["prefix_hit_tokens"] >= 16 and st["cow_copies"] >= 1
    if name == "preempt":
        assert st["preemptions"] >= 1
    if name == "chunk5":        # a width of 5 rounds up to 6 at cp 2
        assert any(s[0] == 6 for k, s, _ in r0["shapes"]
                   if k == "paged_chunk")
    if name == "equal_bytes":
        assert st["pages_per_rank"] == 4
        mesh = make_mesh(MeshConfig(), device="cpu")
        small = PagedEngine(tp_checks._serving_model(mesh, TINY,
                                                     runs["tree"]), mesh,
                            **dict(kw, num_pages=4))
        with pytest.raises(ValueError, match="needs up to 5 pages"):
            small.submit(Request(rid=0, prompt=list(EQUAL), max_new=5))


# ---- (d) ----

def test_cp_combine_matches_jax(runs):
    got = [rank[2] for rank in runs["port"]["cp2"]]
    ref = runs["jcombine"]
    np.testing.assert_array_equal(got[0], got[1])
    assert np.abs(got[0] - ref).max() < 1e-6
    o, lse = runs["combine_in"]
    assert (got[0][2] == 0).all()                   # dead on every rank
    np.testing.assert_allclose(got[0][0], o[0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0][1], o[1, 1], rtol=0, atol=1e-6)


def test_kept_group_reuses_its_ranks(runs):
    """`launch.kept_groups`: calls of one size run one after another on the
    same rank processes and give a fresh group's values; a call that raises
    stops its group and the next call starts another; leaving the block
    stops every rank."""
    o, lse = runs["combine_in"]
    fresh = [rank[2] for rank in runs["port"]["cp2"]]
    todo = [("combine", MESHES["cp2"], dict(o=o, lse=lse))]
    with launch.kept_groups():
        first = launch.spawn(tp_checks.jobs, 2, todo)
        group = launch._KEPT[2]
        second = launch.spawn(tp_checks.jobs, 2, todo)
        assert launch._KEPT[2] is group
        assert all(p.is_alive() for p in group._procs)
        with pytest.raises(RuntimeError, match="of a kept group of 2 raised"):
            launch.spawn(tp_checks.jobs, 2, [("no_such_job", MESHES["cp2"],
                                              {})])
        assert not group.alive
        third = launch.spawn(tp_checks.jobs, 2, todo)
        assert launch._KEPT[2] is not group
        procs = group._procs + launch._KEPT[2]._procs
    assert launch._KEPT is None
    assert not any(p.is_alive() for p in procs)
    for out in (first, second, third):
        for r in range(2):
            np.testing.assert_array_equal(out[r][0], fresh[r])


# ---- (e) ----

def test_speculative_target_at_cp2(runs):
    i = runs["n_matrix"] + runs["n_cases"]
    spec = _ranks(runs, "cp2", 0, i)
    plain = _ranks(runs, "cp2", 0, i + 1)[0]
    toks, _, stats = runs["jspec"]
    r0 = spec[0]
    assert r0["tokens"] == plain["tokens"] == toks
    assert {k: r0["stats"][k] for k in SPEC_KEYS} == \
        {k: stats[k] for k in SPEC_KEYS}
    assert r0["drained"]
    # one cp hop per layer per target dispatch; the drafter's (cp 1) none
    d = r0["dispatches"]
    assert r0["cp_hops"] == TINY["num_layers"] * (d["paged_chunk"]
                                                  + d["spec_verify"])
    assert d["spec_draft"] == d["spec_verify"] > 0 and d["drafter_chunk"]
    for r in spec[1:]:
        assert r["cp_hops"] == r0["cp_hops"]
        assert r["dispatches"] == r0["dispatches"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(r["rounds"], r0["rounds"]))
    assert r0["rounds"][0].shape == (SPEC_KW["num_slots"], 3 + 2)


# ---- (f) ----

def _pool_at(cp, rank, num_pages, kv_dtype=None):
    cfg = ModelConfig(**TINY)
    model = SimpleNamespace(cfg=cfg, cp_size=cp, num_local_kv_heads=4)
    mesh = SimpleNamespace(device=torch.device("cpu"), cp_rank=rank)
    return PagedKVPool(model, mesh, num_pages, 8, kv_dtype=kv_dtype)


def test_pool_slabs_and_free_lists():
    pool = _pool_at(2, 1, 6, "int8")
    assert pool.pages_per_rank == 3
    assert pool.ks[0].shape == (2, 4, 4, 8, 32)     # 3 pages + scratch
    assert pool.ks[1].shape == (2, 4, 4, 8)
    assert [pool.alloc(0), pool.alloc(1), pool.alloc(1)] == [0, 3, 4]
    assert pool.free_pages_of(0) == 2 and pool.free_pages_of(1) == 1
    pool.unref(4)
    assert pool.free_pages_of(1) == 2 and pool.pages_in_use == 2
    ids = torch.tensor([[0, 3, 5, 6]], dtype=torch.int32)
    assert local_page_ids(ids, 3, 1).tolist() == [[3, 0, 2, 3]]
    assert local_page_ids(ids, 6, 0).tolist() == [[0, 3, 5, 6]]
    # a copy-on-write pair stays on its owner's slab; rank 1 copies its own
    pool.ks[0][:, 0] = 5
    pool.copy_pages([(3, 5), (0, 1)])
    assert (pool.ks[0][:, 2] == 5).all() and pool.cow_copies == 2
    with pytest.raises(ValueError, match="crosses cp slabs"):
        pool.copy_pages([(2, 3)])
    with pytest.raises(ValueError, match="divisible by cp"):
        _pool_at(2, 0, 5)
    with pytest.raises(Exception, match="rank 0's slab"):
        p = _pool_at(2, 0, 2)
        p.alloc(0)
        p.alloc(0)


def test_refusals_and_graph_mode():
    from distributed_pytorch_from_scratch_tpu_torch.runtime.graphs import (
        use_decode_graph)
    mesh = make_mesh(MeshConfig(), device="cpu")
    model = build_model("llama", ModelConfig(**TINY))
    model.cp_size = 2
    with pytest.raises(ValueError, match="PAGED"):
        ContinuousBatchingEngine(model, mesh, num_slots=2, buf_len=BUF,
                                 eos_id=EOS)
    target = build_model("llama", ModelConfig(**TINY))
    with pytest.raises(ValueError, match="drafter cp=1"):
        SpeculativeEngine(target, mesh, model, num_slots=2, buf_len=BUF,
                          eos_id=EOS, page_size=8)
    assert not use_decode_graph("auto", "cuda", 1, 2)
    with pytest.raises(ValueError, match="cp=1"):
        use_decode_graph("on", "cuda", 1, 2)
    for flags in (["--cp", "0", "--paged"], ["--cp", "2"],
                  ["--paged", "--cp", "2", "--decode_graph", "on"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--dry_run", "--device", "cpu", *flags])
        assert e.value.code == 2


def test_cli_cp2_dry_run_serves_cp1_tokens(runs):
    cp2, cp1 = runs["port"]["cli"], runs["cli1"]
    assert cp2["completed"] == cp2["requests"] == 6
    assert cp2["outputs"] == cp1["outputs"]
    st = cp2["engine_stats"]
    assert st["cp"] == 2 and st["pages_per_rank"] * 2 == st["num_pages"]
    assert st["pages_in_use"] == 0 and st["prefix_hit_tokens"] > 0
    for k in ("prefix_hit_tokens", "cow_copies", "decode_steps",
              "generated_tokens"):
        assert st[k] == cp1["engine_stats"][k], k
    ranks = cp2["ranks"]
    assert [(r["cp"], r["tp"]) for r in ranks] == [(0, 0), (1, 0)]
    d = ranks[0]["dispatches"]
    model_dispatches = sum(n for k, n in d.items() if k != "cow_copy")
    for r in ranks:
        assert r["dispatches"] == d
        assert r["cp_hops"]["calls"] == 2 * model_dispatches
        assert r["tp_hops"]["calls"] == 0
        # a header and a payload per dispatch, and the stop
        assert r["dispatch_broadcasts"]["calls"] == 2 * sum(d.values()) + 1
