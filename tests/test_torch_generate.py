"""The port's one-shot decoder (`models/decode.make_generate`,
`GreedyDecoder`, the cp ring prefill `_prefill_cp`) against the JAX
package's, on the CPU at the tiny widths in f32.

Both packages get the same weights (a JAX `init` tree) and the same
prompts. At tp 1 the port runs in this process; at tp 2 and cp 2 it runs
on two gloo ranks (`runtime/launch.spawn`, the rank program
`tp_checks.generate_runs`), started in the background while JAX builds its
decoders (one jitted program each).

(a) greedy tokens identical to JAX's `GreedyDecoder.decode_batch` on
    prompts of mixed lengths, llama and gpt2 at tp 1, llama at tp 2 and at
    cp 2 (JAX at attn_impl 'xla'; the ring prefill on the port's side),
    where the cp 2 tokens also equal the port's cp 1 tokens; the whole
    output of `make_generate` (buffer and per-row lengths) equals JAX's
    under per-row `max_total_len`;
(b) the refusals: cp decode under the zig-zag layout or Ulysses, a buffer
    that does not split over cp, and gpt2's position cap, in JAX's words;
(c) sampled draws (temperature, top-k, top-p, one seed per row) within a
    chi-square bound of the filtered softmax of JAX's logits;
(d) the host syncs of a generation: the final read and one read of the
    done mask per `DONE_CHECK_EVERY` steps, none per token.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.stats import chi2

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models import decode as jdecode
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu_torch.config import ModelConfig
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.models import decode
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from _torch_threads import two_torch_threads  # noqa: F401


CFG = dict(attn_dim=32, ffn_dim=64, num_heads=4, num_kv_heads=2,
           num_layers=2, vocab_size=96, maxlen=64, compute_dtype="float32")
CFGS = {"llama": CFG, "gpt2": dict(CFG, num_kv_heads=None)}
BUF, EOS = 32, 1
PROMPTS = [[0, 5, 17, 33, 60], [0, 95], [0, 2, 4, 6, 8, 10, 12, 14], [0, 7],
           [0, 3, 9]]
LIMIT = 24
P_CRIT = 1e-3


def _jmodel(family, **kw):
    cls = JTransformer if family == "llama" else JGPT2
    return cls(JModelConfig(**CFGS[family]), **kw)


def _tree(family, seed=3):
    return jax.tree.map(np.asarray, _jmodel(family).init(
        jax.random.key(seed)))


def _ours(family, tree, **kw):
    m = build_model(family, ModelConfig(**CFGS[family]), **kw)
    m.load_state_dict(params_from_jax(tree))
    return m


def _jax_decode(family, tree, axes, **kw):
    """JAX's GreedyDecoder tokens on the mesh `axes`."""
    jm = _jmodel(family, tp_size=axes.get("tp", 1),
                 cp_size=axes.get("cp", 1), **kw)
    mesh = jmake_mesh(JMeshConfig(**axes))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    return jdecode.GreedyDecoder(jm, mesh, BUF).decode_batch(
        params, PROMPTS, EOS, LIMIT)


def _jax_generate_rows(tree, limits):
    """JAX's make_generate output (buffer, lengths) under per-row limits."""
    jm, mesh = _jmodel("llama"), jmake_mesh(JMeshConfig())
    buf = np.full((len(PROMPTS), BUF), EOS, np.int32)
    for i, p in enumerate(PROMPTS):
        buf[i, :len(p)] = p
    plens = np.asarray([len(p) for p in PROMPTS], np.int32)
    gen = jdecode.make_generate(jm, mesh, BUF)
    out, flen = gen(jax.tree.map(jnp.asarray, tree), jnp.asarray(buf),
                    jnp.asarray(plens), jnp.asarray(EOS, jnp.int32),
                    jnp.asarray(limits), jax.random.key(0))
    return buf, plens, np.asarray(out), np.asarray(flen)


LIMITS = np.asarray([9, 30, 12, 20, 3], np.int32)   # row 4: at its prompt
REFUSED = [dict(layout="zigzag"), dict(impl="ulysses"),
           dict(buf_len=BUF - 1)]


def _jax_refusal(impl="ring", layout="contiguous", buf_len=BUF):
    jm = _jmodel("llama", cp_size=2, cp_impl=impl, cp_layout=layout)
    with pytest.raises(ValueError) as e:
        jdecode.GreedyDecoder(jm, jmake_mesh(JMeshConfig(cp=2)), buf_len)
    return str(e.value)


@pytest.fixture(scope="module")
def runs():
    trees = {f: _tree(f) for f in CFGS}
    greedy = dict(prompts=PROMPTS, eos=EOS, max_total_len=LIMIT,
                  buf_len=BUF)
    refusals = [dict(greedy, **r) for r in REFUSED]
    todo = [("generate_runs", {"tp": 2},
             dict(cfg=CFG, tree=trees["llama"], runs=[greedy])),
            ("generate_runs", {"cp": 2},
             dict(cfg=CFG, tree=trees["llama"], runs=[greedy] + refusals))]
    with ThreadPoolExecutor(max_workers=1) as pool:
        group = pool.submit(launch.spawn, tp_checks.jobs, 2, todo)
        with ThreadPoolExecutor(max_workers=3) as jpool:
            refs = {k: jpool.submit(_jax_decode, f, trees[f], axes, **kw)
                    for k, f, axes, kw in (
                        ("llama", "llama", {}, {}),
                        ("gpt2", "gpt2", {}, {}),
                        ("tp2", "llama", {"tp": 2}, {}),
                        ("cp2", "llama", {"cp": 2}, {"attn_impl": "xla"}))}
            rows = jpool.submit(_jax_generate_rows, trees["llama"], LIMITS)
            refs = {k: f.result() for k, f in refs.items()}
            rows = rows.result()
        res = group.result()
    return dict(trees=trees, refs=refs, rows=rows,
                tp2=[r[0] for r in res], cp2=[r[1] for r in res],
                refused=[_jax_refusal(**r) for r in REFUSED])


# ---- (a) ----

@pytest.mark.parametrize("family", list(CFGS))
def test_tp1_greedy_tokens_equal_jaxs(runs, family):
    dec = decode.GreedyDecoder(_ours(family, runs["trees"][family]), None,
                               BUF)
    got = dec.decode_batch(PROMPTS, EOS, LIMIT)
    assert got == runs["refs"][family]
    # one prompt alone decodes as in the batch
    assert dec.decode(PROMPTS[2], EOS, LIMIT) == got[2]


def test_make_generate_per_row_limits_equal_jaxs(runs):
    buf, plens, want_buf, want_len = runs["rows"]
    gen = decode.make_generate(_ours("llama", runs["trees"]["llama"]), None,
                               BUF)
    out, flen = gen(buf, plens, EOS, LIMITS)
    np.testing.assert_array_equal(flen, want_len)
    np.testing.assert_array_equal(out, want_buf)
    assert flen[4] == plens[4]          # a row at its limit adds nothing


@pytest.mark.parametrize("mesh", ["tp2", "cp2"])
def test_multi_rank_greedy_tokens_equal_jaxs(runs, mesh):
    for rank in runs[mesh]:
        assert rank[0]["tokens"] == runs["refs"][mesh]
    # the ring prefill gives cp 1's tokens, and hops over cp
    if mesh == "cp2":
        assert runs["cp2"][0][0]["tokens"] == runs["refs"]["llama"]
        assert all(r[0]["cp_hops"] > 0 for r in runs["cp2"])


# ---- (b) ----

@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_cp_refusals_are_jaxs(runs, i):
    for rank in runs["cp2"]:
        assert rank[1 + i] == {"error": runs["refused"][i]}


def test_gpt2_position_cap_refusal_is_jaxs(runs):
    jm = _jmodel("gpt2")
    too_long = CFG["maxlen"] + 1
    with pytest.raises(ValueError) as theirs:
        jdecode.GreedyDecoder(jm, jmake_mesh(JMeshConfig()), too_long)
    with pytest.raises(ValueError) as ours:
        decode.GreedyDecoder(_ours("gpt2", runs["trees"]["gpt2"]), None,
                             too_long)
    assert str(ours.value) == str(theirs.value)


# ---- (c) ----

def test_sampled_draws_follow_the_filtered_softmax(runs):
    n, temperature, top_k, top_p = 4000, 0.8, 20, 0.9
    prompt = PROMPTS[0]
    tree = runs["trees"]["llama"]
    dec = decode.GreedyDecoder(_ours("llama", tree), None, BUF,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p)
    draws = np.asarray([t[0] for t in dec.decode_batch(
        [prompt] * n, EOS, len(prompt) + 1, seed=np.arange(n))])
    jm, mesh = _jmodel("llama"), jmake_mesh(JMeshConfig())
    ids = jnp.asarray([prompt], jnp.int32)
    logits = jm.make_forward(mesh)(jax.tree.map(jnp.asarray, tree), ids,
                                   jnp.arange(len(prompt))[None])
    row = np.asarray(logits, np.float32)[0, -1, :CFG["vocab_size"]]
    scaled = jdecode._filter_logits(jnp.asarray(row[None]) / temperature,
                                    top_k, top_p)[0]
    probs = np.asarray(jax.nn.softmax(scaled), np.float64)
    assert set(np.unique(draws)) <= set(np.flatnonzero(probs > 0))
    counts = np.bincount(draws, minlength=len(probs)).astype(float)
    exp = probs * n
    keep = exp >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    want = np.append(exp[keep], exp[~keep].sum())
    if want[-1] < 1e-9:
        obs, want = obs[:-1], want[:-1]
    stat = float(((obs - want) ** 2 / want).sum())
    assert len(obs) > 3
    assert stat < float(chi2.ppf(1 - P_CRIT, len(obs) - 1)), stat
    # the same seeds draw the same tokens; other seeds others
    again = [t[0] for t in dec.decode_batch([prompt] * 64, EOS,
                                            len(prompt) + 1,
                                            seed=np.arange(64))]
    assert again == draws[:64].tolist()


# ---- (d) ----

def test_host_syncs_are_the_final_read_and_the_done_checks(runs):
    dec = decode.GreedyDecoder(_ours("llama", runs["trees"]["llama"]), None,
                               80)
    dec.decode_batch([[0, 5]], EOS, 80)
    steps = 80 - 2
    assert 1 <= dec.host_syncs <= 1 + (steps - 1) // decode.DONE_CHECK_EVERY
    for rank in runs["tp2"] + runs["cp2"]:
        assert rank[0]["host_syncs"] == 1      # 19 steps at most: no check
