"""The port's int8 decode weights (PyTorch) against the JAX package's, at
the tiny preset in float32, for both families.

(a) `quantize_decode_params` gives the JAX function's codes and scales
    byte for byte, after the layout mapping (the port's (odim, idim)
    weights transposed, its per-layer leaves stacked): at tp 1 on the whole
    tree, and at tp 2 (two gloo ranks, `runtime/tp_checks
    .quantized_params`) as the shards of the JAX output on the assembled
    tree; the dequantized weights are bit-equal to JAX's;
(b) both engines with int8 weights give the tokens of the JAX engines
    with int8 weights (the slot engine on a seeded burst, the paged engine
    under a scripted clock), at tp 1 and at tp 2, and the prefill's logits
    are within 1e-5 of the JAX lowering's on its dequantized weights; the
    resident weights are about a quarter of the f32 ones, and the engines
    refuse any other dtype by name.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models import decode as jdecode
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops import quant as jquant
from distributed_pytorch_from_scratch_tpu.ops.rope import (
    rope_tables as jrope_tables)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving.loadgen import (
    synthetic_requests as jsynthetic_requests)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_to_jax
from distributed_pytorch_from_scratch_tpu_torch.models import decode
from distributed_pytorch_from_scratch_tpu_torch.ops import quant
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import tp_dim
from distributed_pytorch_from_scratch_tpu_torch.reshard.layout import (
    jax_key, transposed)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, PagedEngine, Request)

TINY = {k: getattr(model_preset("tiny"), k)
        for k in ("attn_dim", "ffn_dim", "num_heads", "num_layers",
                  "vocab_size", "maxlen")}
FAMILIES = {"llama": JTransformer, "gpt2": JGPT2}
BUF, EOS, TICK = 32, 1, 0.02
LOAD = dict(num=6, prompt_len_min=4, prompt_len_max=12, max_new=8,
            vocab_size=TINY["vocab_size"], seed=3, arrival="burst")
SLOT_KW = dict(num_slots=3, buf_len=BUF, eos_id=EOS, prefill_bucket=8,
               max_prefill_batch=2)
PAGED_KW = dict(num_slots=2, buf_len=BUF, eos_id=EOS, page_size=8,
                prefill_chunk=4)
PREFIX = [0, 5, 17, 33, 60, 2, 8, 9, 11, 40]
PAGED_PROMPTS = [PREFIX + s for s in ([3, 7], [95, 4, 12, 6, 22], [70],
                                      [8, 8, 8], [51, 13, 2, 9, 31, 77, 19])]
PREFILL = (np.random.default_rng(5).integers(3, 1024, (3, 16)).astype(
    np.int32), np.array([16, 5, 11], np.int32))


def _jax(family, tp, seed=7):
    jmodel = FAMILIES[family](JModelConfig(**TINY), tp_size=tp)
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    params = jmodel.init(jax.random.key(seed))
    return jmodel, mesh, params


def _port_as_jax(qport, num_layers):
    """The port's quantized state dict in the JAX tree's flat layout:
    {flat JAX key: {"qweight", "scale"} or array}, linear weights
    transposed, per-layer leaves stacked (a per-layer 1-D leaf's shared
    scale row as the JAX (1, d) scale)."""
    out = {}
    for key, leaf in qport.items():
        jkey, stacked = jax_key(key)
        if stacked and not key.startswith("layers.0."):
            continue
        keys = ([key.replace("layers.0.", f"layers.{i}.", 1)
                 for i in range(num_layers)] if stacked else [key])
        leaves = [qport[k] for k in keys]
        if not isinstance(leaf, dict):
            out[jkey] = np.stack(leaves) if stacked else leaf
            continue
        t = (lambda a: a.T) if transposed(key) else (lambda a: a)
        q = [t(x["qweight"]) for x in leaves]
        s = [t(x["scale"]) for x in leaves]
        if not stacked:
            out[jkey] = {"qweight": q[0], "scale": s[0]}
        elif leaf["qweight"].ndim == 1:       # scale over the layers
            out[jkey] = {"qweight": np.stack(q), "scale": s[0][None]}
        else:
            out[jkey] = {"qweight": np.stack(q), "scale": np.stack(s)}
    return out


def _flat(tree):
    """{flat JAX key: leaf}, a {"qweight", "scale"} dict kept whole."""
    out = {}
    pairs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, dict) and "qweight" in x)[0]
    for path, leaf in pairs:
        key = "param" + "".join(f"/{p.key}" for p in path)
        out[key] = (jax.tree.map(np.asarray, leaf) if isinstance(leaf, dict)
                    else np.asarray(leaf))
    return out


def _assemble(ranks):
    """Every tp rank's quantized shard -> the assembled quantized state
    dict: codes joined on the leaf's tp dim, scales too unless the tp dim
    is the one the scale reduces (then every rank holds the same one)."""
    out = {}
    for key, leaf in ranks[0].items():
        dim = tp_dim(key)
        if not isinstance(leaf, dict):
            out[key] = (leaf if dim is None else
                        np.concatenate([r[key] for r in ranks], dim))
            continue
        q = (leaf["qweight"] if dim is None else np.concatenate(
            [r[key]["qweight"] for r in ranks], dim))
        if dim is None or (q.ndim == 2
                           and dim == quant._reduce_dim(key, q.ndim)):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key]["scale"], leaf["scale"])
            s = leaf["scale"]
        else:
            s = np.concatenate([r[key]["scale"] for r in ranks], dim)
        out[key] = {"qweight": q, "scale": s}
    return out


def _assert_q_equal(port_flat, jax_flat):
    assert sorted(port_flat) == sorted(jax_flat)
    for key, ref in jax_flat.items():
        got = port_flat[key]
        if isinstance(ref, dict):
            assert isinstance(got, dict), key
            for part in ("qweight", "scale"):
                assert got[part].dtype == ref[part].dtype, (key, part)
                assert got[part].shape == ref[part].shape, (key, part)
                np.testing.assert_array_equal(got[part], ref[part],
                                              err_msg=f"{key}/{part}")
        else:
            assert not isinstance(got, dict), key
            np.testing.assert_array_equal(got, ref, err_msg=key)


def _jax_prefill(jmodel, mesh, params):
    """The JAX prefill logits on `params` (dense) under shard_map."""
    cos, sin = jrope_tables(TINY["maxlen"], jmodel.cfg.head_dim)

    def fn(p, buf, plen):
        return jdecode._prefill(jmodel, p, buf, plen, cos, sin,
                                jnp.float32)[2]

    run = jax.jit(jax.shard_map(fn, mesh=mesh,
                                in_specs=(jmodel.specs(), P(), P()),
                                out_specs=P(None, "tp")))
    sharded = jax.device_put(params, jmodel.shardings(mesh))
    return np.asarray(run(sharded, *(jnp.asarray(a) for a in PREFILL)))


def _jax_engines(jmodel, mesh, params):
    """The JAX engines with int8 weights: slot tokens on the seeded burst,
    paged tokens under the scripted clock."""
    sharded = jax.device_put(params, jmodel.shardings(mesh))
    eng = jengine.ContinuousBatchingEngine(
        jmodel, mesh, sharded, decode_weight_dtype="int8", **SLOT_KW)
    slot, _ = tp_checks.drive(eng, jsynthetic_requests(**LOAD), 1)
    eng = jengine.PagedEngine(jmodel, mesh, sharded,
                              decode_weight_dtype="int8",
                              paged_attn_impl="gather",
                              clock=tp_checks.counting_clock(TICK),
                              **PAGED_KW)
    paged, _ = tp_checks.drive(
        eng, [jengine.Request(rid=i, prompt=list(p), max_new=10)
              for i, p in enumerate(PAGED_PROMPTS)], 3)
    return {"slot": slot, "paged": paged}


def _serve_jobs():
    slot_reqs = [(r.prompt, r.max_new, "default", None)
                 for r in jsynthetic_requests(**LOAD)]
    paged_reqs = [(list(p), 10, "default", None) for p in PAGED_PROMPTS]
    return [dict(engine="slot", kw=dict(SLOT_KW, decode_weight_dtype="int8"),
                 requests=slot_reqs, stagger=1, tick=TICK),
            dict(engine="paged", kw=dict(PAGED_KW, decode_weight_dtype="int8",
                                         paged_attn_impl="kernel"),
                 requests=paged_reqs, stagger=3, tick=TICK)]


@pytest.fixture(scope="module")
def tp2():
    """One 2-rank gloo group for both families' tp 2 jobs, in the
    background while JAX computes the references."""
    jax_runs, refs, todo = {f: _jax(f, 2) for f in FAMILIES}, {}, []
    for family, (_, _, params) in jax_runs.items():
        tree = jax.tree.map(np.asarray, params)
        todo += [("quantized_params", {"tp": 2}, dict(cfg=TINY, tree=tree)),
                 ("serve_runs", {"tp": 2},
                  dict(cfg=TINY, tree=tree, runs=_serve_jobs())),
                 ("decode_logits", {"tp": 2},
                  dict(cfg=TINY, tree=tree, calls=[dict(
                      kind="prefill", args=PREFILL, page_size=None)],
                      decode_weight_dtype="int8"))]
    with ThreadPoolExecutor(max_workers=1) as pool:
        group = pool.submit(launch.spawn, tp_checks.jobs, 2, todo)
        for family, (jmodel, mesh, params) in jax_runs.items():
            qp, _ = jquant.quantize_decode_params(params, jmodel.specs())
            deq = jquant.dequantize_decode_params(qp)
            refs[family] = dict(
                q=_flat(qp), engines=_jax_engines(jmodel, mesh, params),
                logits=_jax_prefill(jmodel, mesh, deq))
        ranks = group.result()
    per_family = {f: [r[3 * i:3 * i + 3] for r in ranks]
                  for i, f in enumerate(FAMILIES)}
    return refs, per_family


def _port_model(tree):
    """The port's model of `tree`'s family at tp 1 on the CPU, and its
    mesh."""
    mesh = make_mesh(MeshConfig(), device="cpu")
    return tp_checks._serving_model(mesh, TINY, tree), mesh


# ---- (a) ----

@pytest.mark.parametrize("family", list(FAMILIES))
def test_codes_and_scales_match_jax_tp1(family):
    jmodel, _, params = _jax(family, 1)
    tree = jax.tree.map(np.asarray, params)
    model, _ = _port_model(tree)
    q = quant.quantize_decode_params(model.state_dict())
    as_np = {k: ({n: v.numpy() for n, v in leaf.items()}
                 if isinstance(leaf, dict) else leaf.detach().numpy())
             for k, leaf in q.items()}
    jq, _ = jquant.quantize_decode_params(params, jmodel.specs())
    _assert_q_equal(_port_as_jax(as_np, TINY["num_layers"]), _flat(jq))
    # only the top-level 1-D leaves pass through as f32
    plain = sorted(k for k, v in q.items() if not isinstance(v, dict))
    assert plain == sorted(k for k in ("norm.scale", "norm.bias",
                                       "lm_head.bias") if k in q)
    # the dequantized weights, bit for bit
    deq = quant.dequantize_decode_params(q)
    jdeq = jquant.dequantize_decode_params(jq)
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(deq),
                 jax.tree.map(np.asarray, jdeq))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_codes_and_scales_match_jax_tp2(tp2, family):
    refs, ranks = tp2
    shards = [r[0] for r in ranks[family]]
    _assert_q_equal(_port_as_jax(_assemble(shards), TINY["num_layers"]),
                    refs[family]["q"])
    # a row weight's scale is the assembled tree's: the same on both ranks,
    # not each shard's own
    key = "layers.0.wo.weight" if family == "llama" else "layers.0.proj.weight"
    np.testing.assert_array_equal(shards[0][key]["scale"],
                                  shards[1][key]["scale"])


def test_weight_roundtrip_bound_and_axes():
    """Each weight's round-trip error is within its slice's amax / 254,
    over the dim JAX's axis -2 maps to."""
    g = torch.Generator().manual_seed(0)
    sd = {"layers.0.wq.weight": torch.randn(8, 16, generator=g),
          "lm_head.weight": torch.randn(10, 16, generator=g),
          "embedding.weight": torch.randn(10, 16, generator=g),
          "layers.0.wq.bias": torch.randn(8, generator=g),
          "layers.1.wq.bias": 3 * torch.randn(8, generator=g),
          "norm.scale": torch.randn(16, generator=g)}
    q = quant.quantize_decode_params(sd)
    assert q["norm.scale"] is sd["norm.scale"]
    dims = {"layers.0.wq.weight": -1, "lm_head.weight": -1,
            "embedding.weight": 0}
    for key, dim in dims.items():
        assert q[key]["scale"].shape[dim] == 1
        err = (quant.dequantize_weight(q[key]) - sd[key]).abs()
        amax = sd[key].abs().amax(dim=dim, keepdim=True)
        assert bool((err.amax(dim=dim, keepdim=True)
                     <= amax / 254 + 1e-12).all()), key
    # the layers' biases share one scale row (the JAX (2, 8) leaf's)
    assert torch.equal(q["layers.0.wq.bias"]["scale"],
                       q["layers.1.wq.bias"]["scale"])
    both = torch.stack([sd["layers.0.wq.bias"], sd["layers.1.wq.bias"]])
    assert torch.equal(q["layers.0.wq.bias"]["scale"],
                       both.abs().amax(0) / quant.QMAX)


# ---- (b) ----

def _port_engines(tree):
    out = {}
    model, mesh = _port_model(tree)
    eng = ContinuousBatchingEngine(model, mesh, decode_weight_dtype="int8",
                                   **SLOT_KW)
    out["slot"], _ = tp_checks.drive(
        eng, [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                      seed=r.seed) for r in jsynthetic_requests(**LOAD)], 1)
    out["slot_bytes"] = eng.weight_bytes
    model, mesh = _port_model(tree)
    eng = PagedEngine(model, mesh, decode_weight_dtype="int8",
                      clock=tp_checks.counting_clock(TICK), **PAGED_KW)
    out["paged"], _ = tp_checks.drive(
        eng, [Request(rid=i, prompt=list(p), max_new=10)
              for i, p in enumerate(PAGED_PROMPTS)], 3)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engines_tp1_match_jax_int8_engines(family):
    jmodel, jmesh, params = _jax(family, 1)
    tree = jax.tree.map(np.asarray, params)
    ref = _jax_engines(jmodel, jmesh, params)
    got = _port_engines(tree)
    for kind in ("slot", "paged"):
        assert got[kind] == ref[kind], kind
        assert sum(len(t) for t in got[kind].values()) > len(got[kind])
    # resident weights: int8 codes + f32 scales, about a quarter of f32
    model, mesh = _port_model(tree)
    native = ContinuousBatchingEngine(model, mesh, **SLOT_KW).weight_bytes
    assert native == 4 * sum(p.numel() for p in model.parameters())
    assert 0.25 < got["slot_bytes"] / native < 0.3
    # the prefill's logits within 1e-5 of JAX's on its dequantized weights
    qp, _ = jquant.quantize_decode_params(params, jmodel.specs())
    ref_logits = _jax_prefill(jmodel, jmesh,
                              jquant.dequantize_decode_params(qp))
    model, mesh = _port_model(tree)
    ContinuousBatchingEngine(model, mesh, decode_weight_dtype="int8",
                             **SLOT_KW)
    cos, sin = decode.decode_tables(model, TINY["maxlen"], "cpu")
    with torch.inference_mode():
        logits = decode._prefill(model, *(torch.from_numpy(a)
                                          for a in PREFILL), cos, sin,
                                 torch.float32)[2]
    assert np.abs(logits.numpy() - ref_logits).max() < 1e-5


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engines_tp2_match_jax_int8_engines(tp2, family):
    refs, ranks = tp2
    ref = refs[family]
    (_, serve0, logits0), (_, serve1, logits1) = ranks[family]
    for i, kind in enumerate(("slot", "paged")):
        assert serve0[i]["tokens"] == ref["engines"][kind], kind
        assert serve0[i]["dispatches"] == serve1[i]["dispatches"]
    np.testing.assert_array_equal(logits0[0], logits1[0])
    assert np.abs(logits0[0] - ref["logits"]).max() < 1e-5


def test_engines_refuse_other_weight_dtypes():
    jmodel, _, params = _jax("llama", 1)
    model, mesh = _port_model(jax.tree.map(np.asarray, params))
    for cls, kw in ((ContinuousBatchingEngine, SLOT_KW),
                    (PagedEngine, PAGED_KW)):
        with pytest.raises(ValueError, match="decode_weight_dtype"):
            cls(model, mesh, decode_weight_dtype="fp4", **kw)
    ContinuousBatchingEngine(model, mesh, decode_weight_dtype="int8",
                             **SLOT_KW)
    with pytest.raises(ValueError, match="already holds int8"):
        PagedEngine(model, mesh, decode_weight_dtype="int8", **PAGED_KW)
