"""The port's speculative decoding (`serving/speculative.py`
`SpeculativeEngine`, the `serve --paged --speculate K` flags) against the
JAX package's `SpeculativeEngine`, on the CPU at the JAX tests' tiny shapes
(target d 32, 8 heads, 2 layers; drafter d 16, 2 heads, 1 layer; vocab 96)
in float32, the paged attends through the gather view or the kernel's plain
version.

Both packages get the same weights (JAX `init` trees through
`interop.params_from_jax`); JAX runs its engines with the gather impl, the
port's tp = 2 runs go to one spawned gloo group (`tp_checks.serve_runs`) in
the background while JAX computes.

(a) greedy: staggered admissions (5 prompts through 2 slots) with a random
    drafter give tokens equal to the port's `PagedEngine`, JAX's
    `SpeculativeEngine` and JAX's `GreedyDecoder`, with the JAX engine's
    acceptance numbers and stats, at tp 1 for k in {2, 4} x page size
    {8, 16}, at tp 2 (both ranks compute the same verdicts), for the gpt2
    family, with int8 pages and int8 decode weights; both pools drain;
(b) drafter = target: at prompt lengths 6, 7, 8 every round that the
    buffer does not cut accepts every draft (k+1 tokens), across page
    edges;
(c) preempt-resume at tp 2 over a 4-page pool: both page lists freed and
    rebuilt, JAX's tokens and stats;
(d) sampling: the hash's stream 0 is the plain sampler's bit for bit; a
    two-sample chi-square of positions 1 and 2 against the plain paged
    engine (temperature 1, top-k 8, p = 0.001) passes and its power control
    (top-k 4) rejects; a request's tokens depend on its seed only; at tp 2
    the ranks' (n_acc, out) are equal and the tokens are tp 1's;
(e) refusals (engine and CLI) and `serve --dry_run --paged --speculate`.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.decode import GreedyDecoder
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving.speculative import (
    SpeculativeEngine as JSpeculativeEngine)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.models import (
    build_model, decode)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
    TAG_ACCEPT, TAG_DRAFT, TAG_RESAMPLE, SpeculativeEngine)
from distributed_pytorch_from_scratch_tpu_torch.serving.tp_dispatch import (
    Dispatcher)
from _torch_threads import two_torch_threads  # noqa: F401


CFG = dict(attn_dim=32, ffn_dim=64, num_heads=8, num_layers=2,
           vocab_size=96, maxlen=64, compute_dtype="float32")
# the drafter: cheaper than the target in every dimension, same vocab
DCFG = dict(attn_dim=16, ffn_dim=32, num_heads=2, num_layers=1,
            vocab_size=96, maxlen=64, compute_dtype="float32")
BUF, EOS, TICK, MAX_NEW = 32, 1, 0.02, 10
PROMPTS = [
    [0, 5, 17, 33, 60],
    [0, 95],                        # boundary vocab id
    [0, 2, 4, 6, 8, 10, 12, 14],    # page-boundary prompt at ps=8
    [0, 7],
    [0, 9, 11],
]
PREEMPT_PROMPTS = [[0, 5, 9, 60, 2, 8, 33], [0, 11, 4, 7, 21, 35, 2],
                   [0, 44, 17, 8, 52, 3, 71]]
ENGINE_KW = dict(num_slots=2, buf_len=BUF, eos_id=EOS, prefill_chunk=4)
PREEMPT_KW = dict(num_slots=3, buf_len=BUF, eos_id=EOS, speculate_k=2,
                  page_size=8, num_pages=4, prefill_chunk=8)
SAMPLED = dict(temperature=1.0, top_k=8)
FAMILIES = {"llama": JTransformer, "gpt2": JGPT2}
# greedy runs against JAX: name -> (family, k, page size, extra kwargs)
GREEDY = {f"k{k}_ps{ps}": ("llama", k, ps, {})
          for k in (2, 4) for ps in (8, 16)}
GREEDY.update({"gpt2": ("gpt2", 4, 8, {}),
               "int8_pages": ("llama", 2, 8, dict(kv_dtype="int8")),
               "int8_weights": ("llama", 2, 8,
                                dict(decode_weight_dtype="int8"))})
# the speculative engine's stats that JAX's carries too
SPEC_KEYS = ("decode_steps", "generated_tokens", "completed", "spec_rounds",
             "accepted_tokens_per_dispatch", "acceptance_rate",
             "acceptance_rate_by_position", "rounds_per_request",
             "preemptions", "cow_copies", "prefix_hit_tokens",
             "drafter_num_pages", "drafter_pages_in_use", "pages_in_use",
             "drafter_page_bytes", "target_page_bytes")
CPU = make_mesh(MeshConfig(), device="cpu")


def _tree(family, cfg, seed):
    jm = FAMILIES[family](JModelConfig(**cfg))
    return jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _jax(family, cfg, tree, mesh, tp):
    jm = FAMILIES[family](JModelConfig(**cfg), tp_size=tp)
    return jm, jax.device_put(jax.tree.map(jnp.asarray, tree),
                              jm.shardings(mesh))


def _requests(cls, prompts=PROMPTS, max_new=MAX_NEW):
    return [cls(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]


def _jax_spec(family, tp, tree, dtree, kw, prompts=PROMPTS, max_new=MAX_NEW,
              stagger=3):
    """JAX's speculative engine (gather impl, scripted clock) on the
    staggered drive: ({rid: tokens}, stats)."""
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    jm, params = _jax(family, CFG, tree, mesh, tp)
    dm, dparams = _jax(family, DCFG, dtree, mesh, tp)
    eng = JSpeculativeEngine(jm, mesh, params, dm, dparams,
                             paged_attn_impl="gather",
                             clock=tp_checks.counting_clock(TICK), **kw)
    toks, _ = tp_checks.drive(eng, _requests(jengine.Request, prompts,
                                             max_new), stagger)
    return toks, eng.stats()


def _jax_greedy(family, tp, tree, prompts=PROMPTS, max_new=MAX_NEW):
    """JAX's `GreedyDecoder` on each prompt alone: {rid: tokens}."""
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    jm, params = _jax(family, CFG, tree, mesh, tp)
    dec = GreedyDecoder(jm, mesh, BUF)
    return {i: list(dec.decode(params, p, EOS, max_total_len=len(p)
                               + max_new)) for i, p in enumerate(prompts)}


def _model(family, cfg, tree):
    model = build_model(family, ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(tree))
    return model


def _port(family, tree, dtree=None, **kw):
    """The port's speculative engine (a drafter tree given) or paged
    engine on the staggered drive under the scripted clock: ({rid:
    tokens}, the engine)."""
    model = _model(family, CFG, tree)
    clock = tp_checks.counting_clock(TICK)
    if dtree is None:
        eng = PagedEngine(model, CPU, clock=clock, **kw)
    else:
        eng = SpeculativeEngine(model, CPU, _model(family, DCFG, dtree),
                                clock=clock, **kw)
    toks, _ = tp_checks.drive(eng, _requests(Request), 3)
    return toks, eng


def _assert_drained(eng):
    """No page leak in either pool: every target and drafter page back on
    its free list, refcounts at zero, the drafter table on scratch."""
    assert tp_checks._drained(eng)
    assert eng.stats()["pages_in_use"] == 0
    assert eng.stats()["drafter_pages_in_use"] == 0


def _greedy_kw(name):
    _, k, ps, extra = GREEDY[name]
    return dict(ENGINE_KW, speculate_k=k, page_size=ps, **extra)


@pytest.fixture(scope="module")
def runs():
    """JAX's references, and the port's tp = 2 group run meanwhile."""
    trees = {f: (_tree(f, CFG, 7), _tree(f, DCFG, 21)) for f in FAMILIES}
    preempt_tree = _tree("llama", CFG, 3)
    tree, dtree = trees["llama"]
    spec = lambda kw, **run: dict(
        engine="speculative", kw=dict(kw, paged_attn_impl="kernel"),
        drafter=(DCFG, dtree), tick=TICK, **run)
    reqs = lambda prompts, max_new, seed0=0: [
        (p, max_new, "default", None, seed0 + i)
        for i, p in enumerate(prompts)]
    todo = [("serve_runs", {"tp": 2}, dict(cfg=CFG, tree=tree, runs=[
                spec(_greedy_kw("k2_ps8"), requests=reqs(PROMPTS, MAX_NEW),
                     stagger=3),
                spec(dict(_greedy_kw("k2_ps8"), **SAMPLED),
                     requests=reqs(PROMPTS, MAX_NEW, 40), stagger=3)])),
            ("serve_runs", {"tp": 2}, dict(cfg=CFG, tree=preempt_tree, runs=[
                spec(PREEMPT_KW, requests=reqs(PREEMPT_PROMPTS, 12),
                     stagger=0)]))]
    # JAX's engines and decoders are independent of one another: two
    # threads build and drive them (its compiles run outside the GIL)
    with ThreadPoolExecutor(max_workers=1) as pool, \
            ThreadPoolExecutor(max_workers=2) as jpool:
        group = pool.submit(launch.spawn, tp_checks.jobs, 2, todo)
        spec = {name: jpool.submit(_jax_spec, GREEDY[name][0], 1,
                                   *trees[GREEDY[name][0]], _greedy_kw(name))
                for name in GREEDY}
        spec["tp2"] = jpool.submit(_jax_spec, "llama", 2, tree, dtree,
                                   _greedy_kw("k2_ps8"))
        spec["preempt"] = jpool.submit(_jax_spec, "llama", 2, preempt_tree,
                                       dtree, PREEMPT_KW, PREEMPT_PROMPTS,
                                       12, 0)
        greedy = {"llama": jpool.submit(_jax_greedy, "llama", 1, tree),
                  "gpt2": jpool.submit(_jax_greedy, "gpt2", 1,
                                       trees["gpt2"][0]),
                  "tp2": jpool.submit(_jax_greedy, "llama", 2, tree),
                  "preempt": jpool.submit(_jax_greedy, "llama", 2,
                                          preempt_tree, PREEMPT_PROMPTS, 12)}
        jax_spec = {k: f.result() for k, f in spec.items()}
        greedy = {k: f.result() for k, f in greedy.items()}
        ranks = group.result()
    return dict(trees=trees, jax_spec=jax_spec, greedy=greedy,
                group=[[r[0][i] for r in ranks] for i in range(2)]
                + [[r[1][0] for r in ranks]])


def _assert_like_jax(eng, toks, ref_toks, ref_stats, *others):
    assert sorted(toks) == sorted(ref_toks)
    for rid in ref_toks:
        assert toks[rid] == list(ref_toks[rid]), (rid, toks[rid])
        for other in others:
            assert toks[rid] == list(other[rid]), (rid, toks[rid])
    st = eng.stats()
    assert {k: st[k] for k in SPEC_KEYS} == {k: ref_stats[k]
                                             for k in SPEC_KEYS}
    assert st["spec_rounds"] > 0
    assert st["accepted_tokens_per_dispatch"] >= 1.0
    _assert_drained(eng)


# ---- (a) greedy identity ----

@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("name", sorted(GREEDY))
def test_greedy_matches_paged_and_jax(runs, name, impl):
    family, k, ps, extra = GREEDY[name]
    tree, dtree = runs["trees"][family]
    kw = dict(ENGINE_KW, page_size=ps, paged_attn_impl=impl, **extra)
    toks, eng = _port(family, tree, dtree, speculate_k=k, **kw)
    paged, _ = _port(family, tree, **kw)
    ref_toks, ref_stats = runs["jax_spec"][name]
    others = [paged] if extra else [paged, runs["greedy"][family]]
    _assert_like_jax(eng, toks, ref_toks, ref_stats, *others)


def test_greedy_tp2_matches_jax_and_ranks_agree(runs):
    r0, r1 = runs["group"][0]
    ref_toks, ref_stats = runs["jax_spec"]["tp2"]
    assert r0["tokens"] == {k: list(v) for k, v in ref_toks.items()}
    assert r0["tokens"] == runs["greedy"]["tp2"]
    assert {k: r0["stats"][k] for k in SPEC_KEYS} == {
        k: ref_stats[k] for k in SPEC_KEYS}
    assert r0["drained"]
    # every rank ran the same dispatches and computed the same verdicts
    assert r0["shapes"] == r1["shapes"]
    assert r0["dispatches"]["spec_verify"] == r0["stats"]["spec_rounds"]
    assert len(r0["rounds"]) == len(r1["rounds"]) > 0
    for a, b in zip(r0["rounds"], r1["rounds"]):
        np.testing.assert_array_equal(a, b)


# ---- (b) drafter = target ----

@pytest.mark.parametrize("plen", [6, 7, 8])
def test_self_drafting_accepts_every_draft_across_page_edges(runs, plen):
    """The drafter is the target: greedy drafts equal the target argmax,
    so every round whose window the buffer does not cut accepts all k
    drafts and emits k+1 tokens, the cursor landing on and crossing page
    edges (ps 8) with page growth inside a verify."""
    tree, _ = runs["trees"]["llama"]
    prompt = [0] + [3 + (7 * i) % 90 for i in range(plen - 1)]
    model = _model("llama", CFG, tree)
    eng = SpeculativeEngine(model, CPU, model, num_slots=1, buf_len=BUF,
                            eos_id=EOS, speculate_k=4, page_size=8,
                            prefill_chunk=8, paged_attn_impl="kernel")
    seen = []
    verify = eng.dispatch.lowerings["spec_verify"]

    def record(shape, packed):
        res = verify(shape, packed)
        seen.append((int(packed[2]), int(res[0, 0])))   # (qlen, n_acc)
        return res

    eng.dispatch.lowerings["spec_verify"] = record
    eng.submit(Request(rid=0, prompt=prompt, max_new=14))
    eng.run_to_completion()
    ref = _jax_greedy("llama", 1, tree, [prompt], 14)[0]
    assert eng.completed[0].tokens == ref
    assert seen and all(n_acc == min(4, qlen - 1) for qlen, n_acc in seen)
    st = eng.stats()
    assert st["acceptance_rate"] == 1.0, st
    assert st["spec_rounds"] == len(seen) < 14
    _assert_drained(eng)


# ---- (c) preempt-resume at tp 2 ----

def test_preempt_resume_tp2_matches_jax(runs):
    (r0, r1), = [runs["group"][2]]
    ref_toks, ref_stats = runs["jax_spec"]["preempt"]
    assert r0["tokens"] == {k: list(v) for k, v in ref_toks.items()}
    assert r0["tokens"] == runs["greedy"]["preempt"]
    assert {k: r0["stats"][k] for k in SPEC_KEYS} == {
        k: ref_stats[k] for k in SPEC_KEYS}
    assert r0["stats"]["preemptions"] >= 1
    assert r0["drained"]
    assert r0["shapes"] == r1["shapes"]


# ---- (d) sampling ----

def _gumbel_noise_before(seeds, positions, vocab):
    """`decode.gumbel_noise` as it stood before it took a stream."""
    m32 = 0xFFFFFFFF
    seed = seeds.long() & m32
    pos = positions.long() & m32
    key = decode._fmix32(decode._fmix32((seed + 0x9E3779B9) & m32)
                         ^ pos)[:, None]
    col = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = decode._fmix32(key ^ decode._mul32(col + 1, 0x27D4EB2F))
    h = decode._fmix32((h + decode._fmix32(key ^ 0x165667B1)) & m32)
    u = (h.double() + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def test_hash_stream_zero_is_the_plain_sampler_bit_for_bit():
    rng = np.random.default_rng(5)
    seeds = torch.from_numpy(np.concatenate([
        rng.integers(0, 2**32, 200), [0, 2**32 - 1]]).astype(np.int64))
    pos = torch.from_numpy(rng.integers(0, 2**31, 202))
    before = _gumbel_noise_before(seeds, pos, 97)
    for got in (decode.gumbel_noise(seeds, pos, 97),
                decode.gumbel_noise(seeds, pos, 97, stream=0)):
        assert torch.equal(got.view(torch.int64), before.view(torch.int64))
    streams = [decode.hash_uniform(seeds, pos, 97, s)
               for s in (0, TAG_DRAFT, TAG_ACCEPT, TAG_RESAMPLE)]
    for i, u in enumerate(streams):
        assert bool(((u > 0) & (u < 1)).all())
        for v in streams[i + 1:]:
            assert (u != v).float().mean() > 0.99      # independent bits
    # a (b, k) grid of positions hashes as its rows do one by one
    grid = decode.hash_uniform(seeds[:4, None], pos[:4, None]
                               + torch.arange(3)[None, :], 1, TAG_ACCEPT)
    for j in range(3):
        assert torch.equal(grid[:, j], decode.hash_uniform(
            seeds[:4], pos[:4] + j, 1, TAG_ACCEPT))


# chi-square 0.999 quantiles by df: a statistic above this rejects at
# p < 0.001
_CHI2_999 = {1: 10.828, 2: 13.816, 3: 16.266, 4: 18.467, 5: 20.515,
             6: 22.458, 7: 24.322, 8: 26.125, 9: 27.877, 10: 29.588,
             11: 31.264, 12: 32.909, 13: 34.528, 14: 36.123, 15: 37.697}


def _chi2_two_sample(a_tokens, b_tokens, vocab):
    """Two-sample chi-square over token histograms, low-count bins pooled
    (combined count >= 10 per kept bin): (stat, critical value)."""
    a = np.bincount(a_tokens, minlength=vocab).astype(float)
    b = np.bincount(b_tokens, minlength=vocab).astype(float)
    comb = a + b
    order = np.argsort(-comb)
    keep = [i for i in order if comb[i] >= 10]
    rest = [i for i in order if 0 < comb[i] < 10]
    bins = [(a[i], b[i]) for i in keep]
    if rest:
        bins.append((a[rest].sum(), b[rest].sum()))
    assert len(bins) >= 2, "distribution collapsed to one bin"
    sa, sb = a.sum(), b.sum()
    r1, r2 = np.sqrt(sb / sa), np.sqrt(sa / sb)
    stat = sum((x * r1 - y * r2) ** 2 / (x + y) for x, y in bins)
    return stat, _CHI2_999[min(len(bins) - 1, max(_CHI2_999))]


def _sampled(eng, n, seed0, max_new=3):
    for i in range(n):
        eng.submit(Request(rid=i, prompt=[0, 5, 9], max_new=max_new,
                           seed=seed0 + i))
    eng.run_to_completion()
    toks = {r.rid: r.tokens for r in eng.completed}
    assert len(toks) == n
    return toks


def test_sampling_distribution_matches_the_plain_engine(runs):
    """256 fixed-seed requests through the speculative engine (a
    disagreeing random drafter, so the accept and the residual paths both
    fire) against 256 through the plain paged engine: positions 1 and 2,
    which the accept/resample rule drew, pass a two-sample chi-square at
    p = 0.001; the same statistic rejects top-k 4 (the power control)."""
    n = 256
    tree, dtree = runs["trees"]["llama"]
    model = _model("llama", CFG, tree)
    kw = dict(num_slots=8, buf_len=BUF, eos_id=EOS, page_size=8,
              prefill_chunk=16, paged_attn_impl="kernel", **SAMPLED)
    spec_eng = SpeculativeEngine(model, CPU, _model("llama", DCFG, dtree),
                                 speculate_k=2, **kw)
    spec = _sampled(spec_eng, n, seed0=1000)
    plain = _sampled(PagedEngine(model, CPU, **kw), n, seed0=5000)
    st = spec_eng.stats()
    assert 0.0 < st["acceptance_rate"] < 1.0, st
    for pos in (1, 2):
        s = np.array([t[pos] for t in spec.values() if len(t) > pos])
        p = np.array([t[pos] for t in plain.values() if len(t) > pos])
        assert min(len(s), len(p)) > n // 2, (pos, len(s), len(p))
        stat, crit = _chi2_two_sample(s, p, CFG["vocab_size"])
        assert stat < crit, (pos, stat, crit)
    ctl = _sampled(PagedEngine(model, CPU, **dict(kw, top_k=4)), 128,
                   seed0=9000)
    s = np.array([t[1] for t in spec.values() if len(t) > 1])
    c = np.array([t[1] for t in ctl.values() if len(t) > 1])
    stat, crit = _chi2_two_sample(s, c, CFG["vocab_size"])
    assert stat > crit, ("power control failed to reject", stat, crit)


def test_sampled_tokens_depend_on_the_request_seed_only(runs):
    tree, dtree = runs["trees"]["llama"]
    kw = dict(num_slots=3, buf_len=BUF, eos_id=EOS, speculate_k=2,
              page_size=8, prefill_chunk=8, **SAMPLED)
    build = lambda: SpeculativeEngine(_model("llama", CFG, tree), CPU,
                                      _model("llama", DCFG, dtree), **kw)
    solo = build()
    solo.submit(Request(rid=0, prompt=[0, 5, 17], max_new=8, seed=11))
    solo.run_to_completion()
    crowd = build()
    crowd.submit(Request(rid=90, prompt=[0, 9, 11, 13], max_new=6, seed=4))
    crowd.step()
    crowd.submit(Request(rid=91, prompt=[0, 2], max_new=6, seed=5))
    crowd.submit(Request(rid=0, prompt=[0, 5, 17], max_new=8, seed=11))
    crowd.run_to_completion()
    solo_tokens = solo.completed[0].tokens
    assert {r.rid: r.tokens for r in crowd.completed}[0] == solo_tokens
    assert all(0 <= t < CFG["vocab_size"] for t in solo_tokens)


def test_sampled_tp2_ranks_agree_and_equal_tp1(runs):
    r0, r1 = runs["group"][1]
    tree, dtree = runs["trees"]["llama"]
    seeded = [Request(rid=i, prompt=list(p), max_new=MAX_NEW, seed=40 + i)
              for i, p in enumerate(PROMPTS)]
    eng = SpeculativeEngine(_model("llama", CFG, tree), CPU,
                            _model("llama", DCFG, dtree),
                            paged_attn_impl="kernel",
                            clock=tp_checks.counting_clock(TICK),
                            **dict(_greedy_kw("k2_ps8"), **SAMPLED))
    toks, _ = tp_checks.drive(eng, seeded, 3)
    assert r0["tokens"] == toks
    assert r0["stats"]["acceptance_rate"] == eng.stats()["acceptance_rate"]
    assert len(r0["rounds"]) == len(r1["rounds"]) > 0
    for a, b in zip(r0["rounds"], r1["rounds"]):
        np.testing.assert_array_equal(a, b)


# ---- (e) refusals, the dispatcher, the CLI ----

def test_engine_refusals(runs):
    tree, dtree = runs["trees"]["llama"]
    model, dmodel = _model("llama", CFG, tree), _model("llama", DCFG, dtree)
    kw = dict(num_slots=2, buf_len=BUF, eos_id=EOS, page_size=8)
    with pytest.raises(ValueError, match="debug_host_sampler"):
        SpeculativeEngine(model, CPU, dmodel, speculate_k=2,
                          debug_host_sampler=True, **kw)
    with pytest.raises(ValueError, match="speculate_k"):
        SpeculativeEngine(model, CPU, dmodel, speculate_k=0, **kw)
    wrong = build_model("llama", ModelConfig(**dict(DCFG, vocab_size=64)))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(model, CPU, wrong, speculate_k=2, **kw)
    dmodel.cp_size = 2
    with pytest.raises(ValueError, match="cp=1"):
        SpeculativeEngine(model, CPU, dmodel, speculate_k=2, **kw)
    dmodel.cp_size = 1
    # a cp target shards its pages over the mesh's cp ranks (served at cp
    # 2 in test_torch_cp_serving.py): a one-rank mesh is refused
    model.cp_size = 2
    with pytest.raises(ValueError, match="mesh at cp 1"):
        SpeculativeEngine(model, CPU, dmodel, speculate_k=2, **kw)
    model.cp_size = 1
    # a gpt2 drafter whose learned position table the buffer outgrows
    short = build_model("gpt2", ModelConfig(**dict(DCFG, maxlen=32)))
    gpt2 = build_model("gpt2", ModelConfig(**CFG))
    with pytest.raises(ValueError, match="position table"):
        SpeculativeEngine(gpt2, CPU, short, speculate_k=2, **kw)
    # a request whose worst case outgrows the drafter pool: refused
    eng = SpeculativeEngine(model, CPU, dmodel, speculate_k=2,
                            drafter_pages=2, **kw)
    with pytest.raises(ValueError, match="drafter"):
        eng.submit(Request(rid=0, prompt=[0] * 12, max_new=12))


def test_dispatcher_registers_kinds():
    calls = []
    d = Dispatcher(CPU, {"a": lambda s, p: calls.append(("a", s))})
    d.register("b", lambda s, p: calls.append(("b", s)) or 7)
    with pytest.raises(ValueError, match="already registered"):
        d.register("a", lambda s, p: None)
    assert d("b", (3,), np.zeros(2, np.int32)) == 7
    d("a", (), np.zeros(0, np.int32))
    assert d.counts == {"a": 1, "b": 1}
    assert calls == [("b", (3, 0, 0, 0, 0, 0)), ("a", (0,) * 6)]


@pytest.mark.parametrize("flags", [
    ["--speculate", "2"],                                    # needs --paged
    ["--paged", "--speculate", "2", "--debug_host_sampler"],
    ["--paged", "--drafter_pages", "4"],                     # needs K
    ["--paged", "--speculate", "2", "--drafter_iter", "3"],  # needs a dir
])
def test_serve_parser_refusals(flags):
    with pytest.raises(SystemExit):
        serve.get_serve_args(["--dry_run", "--device", "cpu"] + flags)


def test_serve_dry_run_speculates(capsys):
    args = serve.get_serve_args(["--dry_run", "--paged", "--speculate", "3",
                                 "--drafter_pages", "16", "--device", "cpu"])
    assert args.speculate == 3 and args.drafter_pages == 16
    out = serve.main(["--dry_run", "--paged", "--speculate", "2",
                      "--device", "cpu"])
    assert out["completed"] == out["requests"] > 0
    st = out["engine_stats"]
    assert st["speculate_k"] == 2 and st["spec_rounds"] > 0
    assert st["accepted_tokens_per_dispatch"] >= 1.0
    assert len(st["acceptance_rate_by_position"]) == 2
    assert st["drafter_ms_total"] > 0 and st["target_ms_total"] > 0
    assert st["drafter_pages_in_use"] == 0 and st["pages_in_use"] == 0
    assert st["target_page_bytes"] > st["drafter_page_bytes"]
    assert out["ranks"][0]["dispatches"]["spec_verify"] == st["spec_rounds"]
    assert "spec k=2" in capsys.readouterr().err
    # greedy speculation leaves the plain paged engine's tokens
    plain = serve.main(["--dry_run", "--paged", "--device", "cpu"])
    assert out["outputs"] == plain["outputs"]

