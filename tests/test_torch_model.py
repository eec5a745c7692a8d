"""The port's model and decode lowerings (PyTorch) against the JAX package's.

Both packages get the same weights: a JAX `Transformer.init` tree mapped
onto the port's module by `interop.params_from_jax`. The port's `_prefill`
(per-layer K/V caches, last-position logits) and `_decode_one` (logits,
updated caches) must match the JAX functions run under `jax.shard_map` on
a tp=1 mesh, within 1e-4 at f32 (XLA-CPU and torch-CPU sum in different
orders). Plus: the weight map round-trips, out-of-range ids embed as zero
rows, and no module of the port imports jax or the JAX package.
"""

import os
import subprocess
import sys

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
from distributed_pytorch_from_scratch_tpu_torch.config import ModelConfig
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax, params_to_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import decode
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.ops.rope import rope_tables
from _torch_threads import two_torch_threads  # noqa: F401


SHAPE = dict(attn_dim=64, ffn_dim=128, num_heads=4, num_kv_heads=2,
             num_layers=2, vocab_size=96, maxlen=64)
BUF = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_SPEC = P(None, None, "tp", None, None)


def _models(seed=0):
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    model = Transformer(ModelConfig(**SHAPE))
    model.load_state_dict(params_from_jax(tree))
    return jmodel, tree, model


def _jax_prefill(jmodel, tree, buf, plen):
    mesh = jmake_mesh(JMeshConfig(tp=1))

    def fn(params, buf, plen):
        cos, sin = jdecode.rope_tables(BUF, jmodel.cfg.head_dim)
        return jdecode._prefill(jmodel, params, buf, plen, cos, sin,
                                jnp.float32)

    f = jax.shard_map(fn, mesh=mesh, in_specs=(jmodel.specs(), P(), P()),
                      out_specs=(CACHE_SPEC, CACHE_SPEC, P(None, "tp")))
    return [np.asarray(x) for x in jax.jit(f)(tree, buf, plen)]


def _jax_decode(jmodel, tree, ck, cv, token, cur):
    mesh = jmake_mesh(JMeshConfig(tp=1))

    def fn(params, ck, cv, token, cur):
        cos, sin = jdecode.rope_tables(BUF, jmodel.cfg.head_dim)
        return jdecode._decode_one(jmodel, params, ck, cv, token, cur, BUF,
                                   cos, sin, jnp.float32)

    f = jax.shard_map(fn, mesh=mesh,
                      in_specs=(jmodel.specs(), CACHE_SPEC, CACHE_SPEC, P(),
                                P()),
                      out_specs=(CACHE_SPEC, CACHE_SPEC, P(None, "tp")))
    return [np.asarray(x) for x in jax.jit(f)(tree, ck, cv, token, cur)]


def test_params_round_trip():
    _, tree, model = _models(seed=1)
    back = params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]), path
    # the module holds exactly the mapped keys
    assert set(model.state_dict()) == set(params_from_jax(tree))


def test_out_of_range_ids_embed_as_zero_rows():
    _, _, model = _models()
    ids = torch.tensor([[-1, 0, 95, 96, 1000]])
    out = model.embedding(ids)
    assert (out[0, [0, 3, 4]] == 0).all()
    assert torch.equal(out[0, 1], model.embedding.weight[0])
    assert torch.equal(out[0, 2], model.embedding.weight[95])


def test_prefill_and_decode_match_jax():
    jmodel, tree, model = _models(seed=2)
    rng = np.random.default_rng(0)
    b, t = 2, 24
    buf = rng.integers(3, SHAPE["vocab_size"], size=(b, t)).astype(np.int32)
    buf[1, 5] = 100                          # out of range: a zero row
    plen = np.array([24, 13], np.int32)
    jk, jv, jlogits = _jax_prefill(jmodel, tree, buf, plen)

    cos, sin = rope_tables(BUF, model.cfg.head_dim)
    with torch.inference_mode():
        ks, vs, logits = decode._prefill(
            model, torch.from_numpy(buf).long(),
            torch.from_numpy(plen).long(), cos, sin, torch.float32)
    assert ks.shape == (2, b, 2, t, 16) and logits.shape == (b, 96)
    assert np.abs(ks.numpy() - jk).max() < 1e-4
    assert np.abs(vs.numpy() - jv).max() < 1e-4
    assert np.abs(logits.numpy() - jlogits).max() < 1e-4

    # one decode step at per-row cursors against caches padded to BUF
    ck = np.zeros((2, b, 2, BUF, 16), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :, :, :t] = jk
    cv[:, :, :, :t] = jv
    token = np.array([7, 50], np.int32)
    cur = np.array([24, 13], np.int32)
    jck, jcv, jlog = _jax_decode(jmodel, tree, ck, cv, token, cur)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        log = decode._decode_one(model, tk, tv, torch.from_numpy(token).long(),
                                 torch.from_numpy(cur).long(), BUF, cos, sin,
                                 torch.float32)
    assert np.abs(log.numpy() - jlog).max() < 1e-4
    assert np.abs(tk.numpy() - jck).max() < 1e-4
    assert np.abs(tv.numpy() - jcv).max() < 1e-4


def test_greedy_sampler_first_max_and_refuses_sampling():
    _, _, model = _models()
    sample = decode.make_token_sampler(model)
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 0.0, 3.0]])
    assert sample(logits).tolist() == [1, 0]
    # sampling is ported: a sampled call returns in-vocab tokens (the
    # sampler's own tests are tests/test_torch_sampling.py)
    sampled = decode.make_token_sampler(model, temperature=0.7, top_k=5)
    full = torch.randn(3, model.cfg.vocab_size)
    tok = sampled(full, torch.tensor([0, 1, 2]), torch.tensor([4, 4, 9]))
    assert tok.shape == (3,)
    assert all(0 <= t < model.cfg.vocab_size for t in tok.tolist())
    with pytest.raises(ValueError, match="temperature"):
        decode.make_token_sampler(model, temperature=-1.0)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import cleanly without
    pulling in jax, the JAX package (whose name is a prefix of the
    port's) or ml_dtypes (which the card machine lacks)."""
    code = r"""
import importlib, pkgutil, sys
import distributed_pytorch_from_scratch_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
ref = "distributed_pytorch_from_scratch_tpu"
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "ml_dtypes")
       or n == ref or n.startswith(ref + ".")]
assert not bad, bad
print(len(mods))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
