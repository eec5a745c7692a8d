"""The port's tp ring collective matmuls (PyTorch, gloo ranks on the CPU)
against the JAX package's: `ops/overlap.ag_matmul` / `matmul_rs`, the
layers' `overlap`, and `--tp_overlap ring | ring_q` through the model and
the train CLI, both families, composed with dp, pp and cp.

Both packages get the same inputs, made from a seed with numpy, and the
same weights (a JAX `init` tree; each port rank takes its stage's layers
and its tp shard of it). The port's ranks run over gloo in two groups (2
and 4 ranks, `runtime/launch.spawn`, the rank programs
`tp_checks.ring_ops` and `tp_checks.model_runs`) started in the background
while JAX compiles one jitted program per reference case.

The oracles (the JAX model's ring arms fail under jax 0.9's custom-VJP
type check, so none of them is used for gradients):
(a) op level, tp 2 and 4: `ag_matmul` with 1 and 3 weights and
    `matmul_rs`, forward and both gradients, against JAX's ops under
    `jax.shard_map(..., check_vma=False)` — ring within 1e-5, ring_q's
    forward within 1e-5 of JAX's ring_q, and ring_q against the
    gather-then-dot oracle within JAX's pinned bounds (2^-6 forward, 2^-4
    gradients, of the oracle's max); the hops per call are the ring's
    (n - 1 forward, 2 (n - 1) for ag's backward, n - 1 for rs's), and
    ring_q's carry fewer bytes;
(b) ring_q's payload: the int8 codes and scales one hop carries are
    JAX's `quantize_rows`, byte for byte;
(c) the refusals: an uneven sequence, an unknown overlap mode, and the
    model's `validate_tp_overlap` (no SP, MoE, an unknown mode), JAX's
    messages string for string;
(d) model level: the port's ring loss within 1e-5 (relative) of JAX's
    `off` loss on the same mesh and every rank's gradient shard within rtol
    1e-4 (atol 1e-5) of JAX's global gradient, at tp 2 (both families), tp
    2 x dp 2, pp 2 x tp 2 and cp 2 x tp 2; ring_q within 1e-4 and 2^-4;
    the port's ring / ring_q loss within 1e-6 of the JAX model's ring /
    ring_q forward at tp 2;
(e) `train --tp_size 2 --sequence_parallel --tp_overlap ring` for 2 steps
    on the CPU: the losses of `--tp_overlap off` within 1e-5, and more tp
    hops per step (the summary's per-axis collectives), whose calls and
    bytes at ring and ring_q are those chip_smoke.py's `ring_hops_want`
    derives from off's (the rule that holds the card's runs); the CLI
    refuses the ring without --sequence_parallel and with a MoE model, in
    JAX's words.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models import transformer as jtf
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops import overlap as joverlap
from distributed_pytorch_from_scratch_tpu.ops.quant import (
    quantize_rows as jquantize_rows)
from distributed_pytorch_from_scratch_tpu.parallel import linear as jlinear
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.models import pipeline
from distributed_pytorch_from_scratch_tpu_torch.models import (
    transformer as tf)
from distributed_pytorch_from_scratch_tpu_torch.ops import overlap
from distributed_pytorch_from_scratch_tpu_torch.parallel import linear
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    shard_params)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from _torch_threads import two_torch_threads  # noqa: F401

import torch

# ---- (a) inputs: x chunks (B, TL, D) per rank ----
B, TL, D = 2, 3, 8
OP_CASES = [(n, op, q) for n in (2, 4) for op in ("ag1", "ag3", "rs")
            for q in (False, True)]


def _op_inputs(n, op, seed):
    """Per-rank inputs stacked on a leading axis, f32; weights in torch's
    (o, i) layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if op.startswith("ag"):
        ws = [f(n, o, D) for o in (6, 4, 4)[:int(op[2])]]
        return dict(x=f(n, B, TL, D), ws=ws,
                    dys=[f(n, B, TL * n, w.shape[1]) for w in ws])
    return dict(x=f(n, B, TL * n, 6), ws=[f(n, 5, 6)], dys=[f(n, B, TL, 5)])


def _oracle(n, op, x, ws, dys):
    """Gather-then-dot (and reduce-then-scatter) in float64: per rank the
    outputs, dx and the weight gradients."""
    x, ws, dys = (np.float64(x), [np.float64(w) for w in ws],
                  [np.float64(d) for d in dys])
    rows = lambda a, r, tl: a[:, r * tl:(r + 1) * tl]
    if op.startswith("ag"):
        X = np.concatenate(list(x), axis=1)
        ys = [[X @ w[r].T for w in ws] for r in range(n)]
        dX = sum(d[s] @ w[s] for w, d in zip(ws, dys) for s in range(n))
        dx = [rows(dX, r, TL) for r in range(n)]
        dws = [[np.einsum("bto,btd->od", d[r], X) for d in dys]
               for r in range(n)]
    else:
        full = sum(x[s] @ ws[0][s].T for s in range(n))
        ys = [[rows(full, r, TL)] for r in range(n)]
        DY = np.concatenate(list(dys[0]), axis=1)
        dx = [DY @ ws[0][r] for r in range(n)]
        dws = [[np.einsum("bto,btf->of", DY, x[r])] for r in range(n)]
    return ys, dx, dws


def _jax_op(n, op, q, x, ws, dys):
    """JAX's ring op and its VJP on each rank (`check_vma=False`): per
    rank the outputs, dx and the weight gradients (torch layout)."""
    mesh = jmake_mesh(JMeshConfig(tp=n))

    def body(x, ws, dys):
        x, ws, dys = x[0], [w[0].T for w in ws], [d[0] for d in dys]

        def loss(x, ws):
            ys = ((joverlap.matmul_rs(x, ws[0], "tp", q),) if op == "rs"
                  else joverlap.ag_matmul(x, tuple(ws), "tp", q))
            return sum(jnp.sum(y * d) for y, d in zip(ys, dys)), ys

        (_, ys), (gx, gws) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, ws)
        return [y[None] for y in ys], gx[None], [g.T[None] for g in gws]

    spec = P("tp")
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                               out_specs=spec, check_vma=False))
    ys, gx, gws = jax.tree.map(np.asarray, fn(x, ws, dys))
    return ([[y[r] for y in ys] for r in range(n)], list(gx),
            [[g[r] for g in gws] for r in range(n)])


# ---- (d) the models ----
CFG = dict(attn_dim=32, ffn_dim=64, num_heads=4, num_kv_heads=2,
           num_layers=2, vocab_size=96, maxlen=32, compute_dtype="float32")
# two setups: "gqa" (GQA, t 16, seeded numpy batch) for the ring against
# off on every mesh; "pinned" for ring_q, the models, init key and batch of
# JAX's own ring_q pin (`tests/test_quant.py`
# `test_model_ring_q_matches_off_within_bound`: test_overlap.CFG's llama,
# its gpt2 config, key 0, `make_batch(key 2)`), where its 1e-4 / 2^-4
# bounds were set
SETUPS = {
    "gqa": {"llama": CFG, "gpt2": dict(CFG, num_kv_heads=None)},
    "pinned": {"llama": dict(attn_dim=32, ffn_dim=64, num_heads=8,
                             num_layers=2, vocab_size=96, maxlen=64,
                             compute_dtype="float32"),
               "gpt2": dict(attn_dim=32, ffn_dim=64, num_heads=4,
                            num_layers=2, vocab_size=96, maxlen=64,
                            compute_dtype="float32")},
}
# name: (setup, family, port mesh axes, tp_overlap)
MODEL_CASES = {
    "llama_tp2_ring": ("gqa", "llama", dict(tp=2), "ring"),
    "gpt2_tp2_ring": ("gqa", "gpt2", dict(tp=2), "ring"),
    "llama_tp2_dp2_ring": ("gqa", "llama", dict(dp=2, tp=2), "ring"),
    "llama_pp2_tp2_ring": ("gqa", "llama", dict(pp=2, tp=2), "ring"),
    "llama_cp2_tp2_ring": ("gqa", "llama", dict(cp=2, tp=2), "ring"),
    "llama_tp2_ring_q": ("pinned", "llama", dict(tp=2), "ring_q"),
    "gpt2_tp2_ring_q": ("pinned", "gpt2", dict(tp=2), "ring_q"),
}
# JAX's `off` on each case's mesh, and the JAX model's forward through its
# own ring at each tp 2 case
OFF_REFS = sorted({(st, f, tuple(sorted(a.items())))
                   for st, f, a, _ in MODEL_CASES.values()})
FWD_REFS = [(st, f, ov) for st, f, a, ov in MODEL_CASES.values()
            if a == {"tp": 2}]


def _tree(setup, family):
    cls = JTransformer if family == "llama" else JGPT2
    seed = 0 if setup == "pinned" else 3
    return jax.tree.map(np.asarray, cls(JModelConfig(
        **SETUPS[setup][family])).init(jax.random.key(seed)))


def _batch(setup):
    if setup == "pinned":       # test_overlap.make_batch(key 2)
        key = jax.random.key(2)
        k1, k2 = jax.random.split(key)
        ids = jax.random.randint(k1, (4, 32), 0, 96)
        tgt = jax.random.randint(k2, (4, 32), 0, 96)
        mask = jax.random.bernoulli(jax.random.fold_in(key, 9), 0.2, (4, 32))
        tgt = jnp.where(mask, IGNORE_INDEX, tgt)
        pos = jnp.tile(jnp.arange(32)[None, :], (4, 1))
        return [np.asarray(a, dtype=np.int32) for a in (ids, tgt, pos)]
    rng = np.random.default_rng(5)
    ids = rng.integers(0, CFG["vocab_size"], size=(ROWS, T + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, T - 5:] = IGNORE_INDEX
    tgt[-1, 2:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), (ROWS, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[:, :-1], tgt, pos)]


T, ROWS = 16, 4


def _jax_model(setup, family, axes, tp_overlap="off"):
    cls = JTransformer if family == "llama" else JGPT2
    jm = cls(JModelConfig(**SETUPS[setup][family]),
             tp_size=axes.get("tp", 1), cp_size=axes.get("cp", 1),
             pp_size=axes.get("pp", 1), sequence_parallel=True,
             tp_overlap=tp_overlap)
    return jm, jmake_mesh(JMeshConfig(**axes))


def _jax_off(setup, family, axes, tree, batch):
    """JAX's loss and global gradients (port keys) at tp_overlap 'off'."""
    jm, mesh = _jax_model(setup, family, dict(axes))
    params = jax.device_put(jm.from_canonical(jax.tree.map(jnp.asarray,
                                                           tree)),
                            jm.shardings(mesh))
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss(mesh)))(params,
                                                                  *batch)
    return float(loss), params_from_jax(jm.to_canonical(
        jax.tree.map(np.asarray, grads)))


def _jax_fwd(setup, family, tp_overlap, tree, batch):
    """The JAX model's loss at tp 2 through its ring (forward only)."""
    jm, mesh = _jax_model(setup, family, {"tp": 2}, tp_overlap)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    return float(jm.make_loss(mesh)(params, *batch))


def _world(axes):
    return int(np.prod(list(axes.values())))


TINY_FLAGS = ["--model", "tiny", "--maxlen", "64", "--batch_size", "4",
              "--warmup_steps", "2", "--lr", "1e-3", "--log_interval", "1",
              "--max_steps", "2", "--device", "cpu", "--dist_backend",
              "gloo", "--tp_size", "2", "--sequence_parallel"]


def _write_corpus(path, docs=40, vocab=1024, seed=0):
    import json
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two groups and its two CLI runs in the background, JAX's
    references meanwhile."""
    ops = {c: _op_inputs(c[0], c[1], seed=i) for i, c in enumerate(OP_CASES)}
    trees = {(st, f): _tree(st, f) for st in SETUPS for f in SETUPS[st]}
    batches = {st: _batch(st) for st in SETUPS}
    jobs = {2: [], 4: []}
    for n in (2, 4):
        cases = [dict(op="rs" if op == "rs" else "ag", quantized=q,
                      **ops[(m, op, q)]) for m, op, q in OP_CASES if m == n]
        jobs[n].append(("ring_ops", {"tp": n}, dict(cases=cases)))
    names = {2: [], 4: []}
    for name, (st, family, axes, ov) in MODEL_CASES.items():
        run = dict(batch=batches[st], sp=True, tp_overlap=ov)
        jobs[_world(axes)].append(("model_runs", axes, dict(
            cfg=SETUPS[st][family], tree=trees[st, family], runs=[run])))
        names[_world(axes)].append(name)
    root = tmp_path_factory.mktemp("overlap_cli")
    data = str(root / "tokens.json")
    _write_corpus(data)
    with ThreadPoolExecutor(max_workers=4) as pool:
        groups = {n: pool.submit(launch.spawn, tp_checks.jobs, n, jobs[n])
                  for n in (2, 4)}
        cli = {ov: pool.submit(train_cli.main, TINY_FLAGS + [
            "--data_path", data, "--save_dir", str(root / ov),
            "--tp_overlap", ov]) for ov in ("off", "ring", "ring_q")}
        # JAX compiles with the GIL released: three at a time
        with ThreadPoolExecutor(max_workers=3) as jpool:
            jops = {c: jpool.submit(_jax_op, *c, **ops[c]) for c in OP_CASES}
            offs = {k: jpool.submit(_jax_off, *k, trees[k[:2]],
                                    batches[k[0]]) for k in OFF_REFS}
            fwds = {k: jpool.submit(_jax_fwd, *k, trees[k[:2]],
                                    batches[k[0]]) for k in FWD_REFS}
            jops = {c: f.result() for c, f in jops.items()}
            offs = {k: f.result() for k, f in offs.items()}
            fwds = {k: f.result() for k, f in fwds.items()}
        res = {n: g.result() for n, g in groups.items()}
        cli = {k: f.result() for k, f in cli.items()}
    ours = {c: [rank[0][i] for rank in res[n]] for n in (2, 4)
            for i, c in enumerate(c for c in OP_CASES if c[0] == n)}
    models = {name: [rank[1 + i][0] for rank in res[n]]
              for n in (2, 4) for i, name in enumerate(names[n])}
    return dict(ops=ops, ours=ours, jops=jops, offs=offs, fwds=fwds,
                models=models, cli=cli)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


# ---- (a) ----

@pytest.mark.parametrize("case", OP_CASES, ids=lambda c: f"{c}")
def test_ring_ops_match_jax_and_the_oracle(runs, case):
    n, op, q = case
    inp = runs["ops"][case]
    jys, jdx, jdws = runs["jops"][case]
    oys, odx, odws = _oracle(n, op, inp["x"], inp["ws"], inp["dys"])
    for r, got in enumerate(runs["ours"][case]):
        for y, jy, oy in zip(got["ys"], jys[r], oys[r]):
            # the forward: JAX's ring (or ring_q) within 1e-5
            np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
            assert _rel(y, oy) < (2.0 ** -6 if q else 1e-5)
        pairs = [(got["dx"], jdx[r], odx[r])] + list(
            zip(got["dws"], jdws[r], odws[r]))
        for g, jg, og in pairs:
            if q:       # JAX's pinned bound for the quantized gradients
                assert _rel(g, og) < 2.0 ** -4
            else:
                np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5)
                assert _rel(g, og) < 1e-5
        # n - 1 hops forward; ag's backward runs two rings, rs's one
        assert got["calls"] == (n - 1) * (3 if op.startswith("ag") else 2)


@pytest.mark.parametrize("n,op", [(2, "ag3"), (4, "rs")])
def test_ring_q_hops_carry_fewer_bytes(runs, n, op):
    ring, ring_q = (runs["ours"][(n, op, q)][0] for q in (False, True))
    assert ring_q["calls"] == ring["calls"]
    # int8 codes plus one f32 scale per row, against f32 rows
    assert ring_q["bytes"] < 0.5 * ring["bytes"]


# ---- (b) ----

@pytest.mark.parametrize("shape", [(2, 5, 8), (3, 4, 16)])
def test_ring_q_payload_is_jax_quantize_rows_byte_for_byte(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32) * 3
    x[0, 1] = 0.0                        # an all-zero row: scale 1
    msg, chunk = overlap._encode(torch.from_numpy(x), True)
    codes, scales = overlap._unpack_rows(msg, torch.from_numpy(x))
    jq, js = jquantize_rows(jnp.asarray(x))
    assert codes.dtype == torch.int8 and msg.dtype == torch.int8
    assert msg.numel() == x.size + 4 * x.size // shape[-1]
    assert np.array_equal(codes.numpy(), np.asarray(jq))
    assert np.asarray(js).tobytes() == scales.numpy().tobytes()
    back = overlap._decode(msg, torch.from_numpy(x), True)
    assert torch.equal(back, chunk)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq, np.float32) * np.asarray(js)[..., None])


# ---- (c) ----

def test_uneven_sequence_refusal_is_jaxs():
    mesh = jmake_mesh(JMeshConfig(tp=2))
    fn = jax.shard_map(lambda x, w: joverlap.matmul_rs(x, w, "tp"),
                       mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                       check_vma=False)
    with pytest.raises(ValueError) as theirs:
        fn(jnp.zeros((2, 5, 4)), jnp.zeros((4, 3)))
    stub = types.SimpleNamespace(
        axis=lambda name: types.SimpleNamespace(size=2))
    with pytest.raises(ValueError) as ours:
        overlap.matmul_rs(torch.zeros(2, 5, 4), torch.zeros(3, 4), stub)
    assert str(ours.value) == str(theirs.value)


def test_unknown_overlap_mode_refusal_is_jaxs():
    with pytest.raises(ValueError) as theirs:
        jlinear.ColumnParallelLinear(8, 8, overlap="ring2")
    with pytest.raises(ValueError) as ours:
        linear.ColumnParallelLinear(8, 8, overlap="ring2")
    assert str(ours.value) == str(theirs.value)
    assert linear.OVERLAP_MODES == jlinear.OVERLAP_MODES


@pytest.mark.parametrize("mode,sp,experts", [
    ("ring", False, 0), ("ring_q", False, 0), ("ring", True, 4),
    ("ring_q", True, 4), ("bogus", True, 0)])
def test_validate_tp_overlap_messages_are_jaxs(mode, sp, experts):
    with pytest.raises(ValueError) as theirs:
        jtf.validate_tp_overlap(mode, sp, experts)
    with pytest.raises(ValueError) as ours:
        tf.validate_tp_overlap(mode, sp, experts)
    assert str(ours.value) == str(theirs.value)
    # and through the model constructors of both packages
    cfg = dict(CFG, num_kv_heads=None, num_experts=experts)
    with pytest.raises(ValueError) as jm:
        JTransformer(JModelConfig(**cfg), tp_size=2, sequence_parallel=sp,
                     tp_overlap=mode)
    with pytest.raises(ValueError) as pm:
        build_model("llama", ModelConfig(**cfg), sequence_parallel=sp,
                    tp_overlap=mode)
    assert str(pm.value) == str(jm.value)


# ---- (d) ----

@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_ring_matches_jax_off(runs, name):
    st, family, axes, ov = MODEL_CASES[name]
    loss, grads = runs["offs"][(st, family, tuple(sorted(axes.items())))]
    for res in runs["models"][name]:
        c = res["coords"]
        want = shard_params(grads, axes.get("tp", 1), c["tp"])
        stage = pipeline.stage_layer_ids(SETUPS[st][family]["num_layers"],
                                         axes.get("pp", 1), c["pp"])
        assert {int(k.split(".")[1]) for k in res["grads"]
                if k.startswith("layers.")} == set(stage)
        if ov == "ring":
            np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
        else:
            assert abs(res["loss"] - loss) / abs(loss) < 1e-4
        for k, g in res["grads"].items():
            w = want[k].numpy()
            if ov == "ring":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} {c} {k}")
            else:
                assert _rel(g, w) < 2.0 ** -4, f"{name} {c} {k}"


@pytest.mark.parametrize("setup,family,ov", FWD_REFS)
def test_model_ring_loss_matches_jax_ring_forward(runs, setup, family, ov):
    want = runs["fwds"][(setup, family, ov)]
    for res in runs["models"][f"{family}_tp2_{ov}"]:
        assert abs(res["loss"] - want) / abs(want) < 1e-6, (res["loss"],
                                                            want)


# ---- (e) ----

def test_train_cli_ring_equals_off(runs):
    off, ring = runs["cli"]["off"], runs["cli"]["ring"]
    assert ring["tp_overlap"] == "ring" and off["tp_overlap"] == "off"
    assert len(ring["losses"]) == 2
    np.testing.assert_allclose(ring["losses"], off["losses"], rtol=1e-5)
    hops = [r["ranks"][0]["hops_per_step"]["tp"] for r in (off, ring)]
    assert hops[1]["calls"] > hops[0]["calls"] > 0
    assert hops[1]["host_ms"] >= 0


@pytest.mark.parametrize("mode", ["ring", "ring_q"])
def test_chip_smoke_hop_rule_is_the_cpu_count(runs, mode):
    """chip_smoke's `ring_hops_want` (which holds the card's 45m runs)
    against the tp hops the port's CLI counted per step on the CPU."""
    import chip_smoke
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        model_preset)
    cfg = model_preset("tiny")
    off, run = runs["cli"]["off"], runs["cli"][mode]
    for rank, off_rank in zip(run["ranks"], off["ranks"]):
        got = rank["hops_per_step"]["tp"]
        want = chip_smoke.ring_hops_want(
            off_rank["hops_per_step"]["tp"], cfg.num_layers, rows=4 * 64 // 2,
            d=cfg.attn_dim, item=4, tp=2, mode=mode)
        assert (got["calls"], got["bytes"]) == want


@pytest.mark.parametrize("flags,match", [
    (["--tp_overlap", "ring"], "requires sequence_parallel"),
    (["--tp_overlap", "ring_q", "--sequence_parallel", "--num_experts",
      "4"], "does not compose with MoE")])
def test_train_cli_refuses_ring_like_jax(flags, match):
    argv = [f for f in TINY_FLAGS if f != "--sequence_parallel"] + flags + [
        "--data_path", "unused.json"]
    with pytest.raises(ValueError, match=match):
        train_cli.main(argv)
