"""The port's ZeRO stages and dp gradient wires (PyTorch, gloo ranks on the
CPU) against the JAX package's, in float32 at the `tiny` preset.

Every ZeRO stage computes plain data-parallel Adam's update, so the port
is held to JAX's stage-0 `build_train_step` (one jitted reference per
mesh), to its own stage 0, and to the JAX pure functions
(`quantize_groups`, `bucket_partition`, the dp-dim rule, the int8 ring
under `shard_map`). JAX's stage-2/3 grad functions and int8 wire are no
oracle here: under this jax they fail their own tests. The port's ranks
run `runtime/zero_checks.py`'s rank programs (through `tp_checks.jobs`)
in one kept group of 2 and one of 4 (`launch.kept_groups`), in the
background while JAX computes.

(a) `quantize_groups` / `dequantize_groups` equal JAX's byte for byte,
    at sizes that are not multiples of 512 and at all zeros;
(b) `bucket_partition` equals JAX's for random sizes and bounds;
(c) the port's dp dim of every parameter equals JAX's (`zero1_specs` for
    the non-layer leaves, `zero3_dims` - 1 for the layer ones, through the
    checkpoint key names) at dp 2 and 4, tp 1 and 2, both families and the
    MoE;
(d) the int8 ring all-reduce and reduce-scatter over dp 2 and 4: bitwise
    the same on every rank, within 1e-6 of JAX's `_quantized_allreduce_
    axis` / `quantized_reduce_scatter` under `jax.shard_map`;
(e) stages 0-3 (and stages 1 and 2 with small buckets, stage 3 under remat
    dots) at dp 2, dp 2 x tp 2 with SP and dp 2 x cp 2, f32 wire, three
    clipped AdamW steps from JAX's weights: each loss within 1e-5
    relative of JAX's stage-0 step and the parameters after three steps
    within rtol 1e-4 / atol 1e-5; every stage's losses within 1e-6 of the
    port's stage 0 (gpt2 at dp 2 too);
(f) the bf16 and int8 wires of the bucketed all-reduce and reduce-scatter
    within 2^-7 and 2^-4 of the f32 reducer's gradients, relative to each
    leaf's max (JAX's pinned bounds), the gradients f32;
(g) `--zero 1` with the MoE at dp 2 x ep 2 equal to `--zero 0`;
(h) a stage-2 checkpoint of the train CLI at dp 2 that JAX's
    `load_checkpoint` reads equal to a stage-0 one, its `__layout__`
    stamp byte-identical to JAX's at that mesh and stage; resumed at
    stages 0 and 3 it continues within 1e-6 of an uninterrupted run;
(i) every ZeRO refusal of the train CLI in JAX's words (JAX's own CLI
    run on the same flags), and the four flags no longer refused as not
    ported;
(j) each rank's held params, grads and moments equal
    `memory.zero_state_bytes_per_param`'s count, stage by stage lower.
"""

import dataclasses
import glob
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from distributed_pytorch_from_scratch_tpu import train as jtrain
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig)
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops import overlap as joverlap
from distributed_pytorch_from_scratch_tpu.ops import quant as jquant
from distributed_pytorch_from_scratch_tpu.reshard import layout as jlayout
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu.training import zero as jzero
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, ModelConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.ops import overlap, quant
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    assemble_params, shard_params)
from distributed_pytorch_from_scratch_tpu_torch.reshard.layout import (
    jax_key, transposed)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.training.memory import (
    zero_state_bytes_per_param)
from distributed_pytorch_from_scratch_tpu_torch.training.zero import (
    zero_dim)
from _torch_threads import two_torch_threads  # noqa: F401

CFG = dict(dataclasses.asdict(model_preset("tiny")), maxlen=64,
           compute_dtype="float32")
MOE = dict(CFG, num_experts=4, moe_capacity_factor=8.0)
B, T, STEPS = 4, 64, 3
ADAM = dict(lr=1e-2, warmup_steps=2, max_steps=20, clip_grad_norm=0.5,
            weight_decay=0.01)
SMALL_MB = 0.25         # ~13 buckets of the tiny model's 3.2 MB of grads
WIRE_BOUND = {"bf16": 2.0 ** -7, "int8": 2.0 ** -4}

# name: (port mesh axes, sp) of the trajectories held to JAX
MESHES = {"dp2": (dict(dp=2), False),
          "dp2_tp2_sp": (dict(dp=2, tp=2), True),
          "dp2_cp2": (dict(dp=2, cp=2), False)}
# the runs of each mesh: (stage, bucket_mb, remat)
STAGES = {"zero0": (0, 0.0, True), "zero1": (1, 0.0, True),
          "zero2": (2, 0.0, True), "zero3": (3, 0.0, True)}
DP2_EXTRA = {"zero1_buckets": (1, SMALL_MB, True),
             "zero2_buckets": (2, SMALL_MB, True),
             "zero3_dots": (3, 0.0, "dots")}
# (f): stage-0 buckets and stage 2, each wire, against the flat reducer
WIRE_RUNS = [(s, w) for s in (0, 2) for w in ("f32", "bf16", "int8")]


def _jtree(cfg, family="llama", seed=0):
    cls = JTransformer if family == "llama" else JGPT2
    tree = jax.tree.map(np.asarray,
                        cls(JModelConfig(**cfg)).init(jax.random.key(seed)))
    if cfg.get("num_experts"):   # a seeded router: tokens route unevenly
        moe = tree["layers"]["moe"]
        moe["router"] = np.random.default_rng(seed + 100).standard_normal(
            moe["router"].shape).astype(np.float32)
    return tree


def _batch(rng, lead=()):
    ids = rng.integers(0, CFG["vocab_size"], size=lead + (B, T + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, T - 11:] = IGNORE_INDEX
    tgt[..., 3, 2:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), lead + (B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


def _jax_trajectory(axes, sp, tree, steps):
    """JAX's stage-0 `build_train_step` on the mesh: the losses of STEPS
    steps and the parameters after them."""
    jm = JTransformer(JModelConfig(**CFG), tp_size=axes.get("tp", 1),
                      cp_size=axes.get("cp", 1), sequence_parallel=sp)
    mesh = jmake_mesh(JMeshConfig(**axes))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    step = jtrain_step.build_train_step(jm, mesh, JOptimizerConfig(**ADAM))
    state = joptim.init_adam_state(params)
    losses = []
    for i in range(STEPS):
        params, state, loss = step(params, state, *(x[i] for x in steps))
        losses.append(float(loss))
    return losses, params_from_jax(jax.tree.map(np.asarray, params))


def _jax_ring(n, x, blocks):
    """JAX's int8 ring all-reduce and reduce-scatter over n devices."""
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("dp",))
    run = lambda f, a: np.asarray(jax.jit(jax.shard_map(
        lambda v: f(v[0], "dp")[None], mesh=mesh, in_specs=P("dp"),
        out_specs=P("dp"), check_vma=False))(a))
    return (run(joverlap._quantized_allreduce_axis, x),
            run(joverlap.quantized_reduce_scatter, blocks))


def _ring_inputs(n, seed):
    rng = np.random.default_rng(seed)
    # leaves of very different scales, and a length no multiple of 512
    x = rng.standard_normal((n, 1300)).astype(np.float32)
    x[:, :300] *= 1e-3
    blocks = rng.standard_normal((n, n, 1024)).astype(np.float32)
    return x, blocks


def _write_corpus(path, docs=40, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


CLI = ["--model", "tiny", "--maxlen", "64", "--batch_size", "4",
       "--warmup_steps", "2", "--lr", "1e-3", "--log_interval", "2",
       "--device", "cpu", "--dp_size", "2", "--dist_backend", "gloo"]


def _cli_runs(root, data):
    """The train CLI at dp 2: 2 steps at stages 2 and 0 (each saved), 4
    uninterrupted steps at stage 2, and the stage-2 checkpoint resumed to
    step 4 at stages 0 and 3 (each from its own copy)."""
    run = lambda d, steps, stage, extra=(): train_cli.main(
        CLI + ["--data_path", data, "--save_dir", os.path.join(root, d),
               "--max_steps", str(steps), "--zero", str(stage), *extra])
    out = {"zero2": run("zero2", 2, 2), "zero0": run("zero0", 2, 0),
           "whole": run("whole", 4, 2)}
    for stage in (0, 3):
        shutil.copytree(os.path.join(root, "zero2"),
                        os.path.join(root, f"resume{stage}"))
        out[f"resume{stage}"] = run(f"resume{stage}", 4, stage,
                                    ["--resume"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zero"))
    data = os.path.join(root, "tokens.json")
    _write_corpus(data)
    tree, gtree, mtree = _jtree(CFG), _jtree(CFG, "gpt2"), _jtree(MOE)
    steps = _batch(np.random.default_rng(1), lead=(STEPS,))
    batch = _batch(np.random.default_rng(2))
    rings = {n: _ring_inputs(n, n) for n in (2, 4)}

    def traj(axes, sp, names, t=tree, cfg=CFG):
        every = {**STAGES, **DP2_EXTRA}
        return ("zero_runs", axes, dict(cfg=cfg, tree=t, runs=[
            dict(stage=every[n][0], bucket_mb=every[n][1],
                 remat=every[n][2], sp=sp, batch=steps, steps=STEPS,
                 optim=ADAM) for n in names]))

    def grads(axes, sp, cases):
        return ("zero_runs", axes, dict(cfg=CFG, tree=tree, runs=[
            dict(stage=s, bucket_mb=SMALL_MB if (s or w != "flat") else 0.0,
                 wire="f32" if w == "flat" else w, sp=sp, batch=batch,
                 grads=True) for s, w in cases]))

    todo2 = [traj({"dp": 2}, False, [*STAGES, *DP2_EXTRA]),
             traj({"dp": 2}, False, ["zero0", "zero3"], gtree),
             grads({"dp": 2}, False, [(0, "flat")] + WIRE_RUNS),
             ("int8_ring", {"dp": 2}, dict(x=rings[2][0],
                                           blocks=rings[2][1]))]
    todo4 = [traj(MESHES["dp2_tp2_sp"][0], True, STAGES),
             traj(MESHES["dp2_cp2"][0], False, STAGES),
             grads({"dp": 2, "tp": 2}, True, [(0, "flat"), (2, "int8")]),
             traj({"dp": 2, "ep": 2}, False, ["zero0", "zero1"], mtree, MOE),
             ("int8_ring", {"dp": 4}, dict(x=rings[4][0],
                                           blocks=rings[4][1]))]
    with launch.kept_groups(), ThreadPoolExecutor(max_workers=6) as pool:
        g2 = pool.submit(lambda: (launch.spawn(tp_checks.jobs, 2, todo2),
                                  _cli_runs(root, data)))
        g4 = pool.submit(launch.spawn, tp_checks.jobs, 4, todo4)
        jax_refs = {name: pool.submit(_jax_trajectory, axes, sp, tree, steps)
                    for name, (axes, sp) in MESHES.items()}
        jrings = {n: _jax_ring(n, *rings[n]) for n in (2, 4)}
        refs = {k: f.result() for k, f in jax_refs.items()}
        two, cli = g2.result()
        four = g4.result()
    per = lambda res, i: [rank[i] for rank in res]
    res = {"dp2": per(two, 0), "gpt2": per(two, 1), "wires": per(two, 2),
           "ring2": per(two, 3), "dp2_tp2_sp": per(four, 0),
           "dp2_cp2": per(four, 1), "wires_tp2": per(four, 2),
           "moe": per(four, 3), "ring4": per(four, 4)}
    return dict(res=res, refs=refs, jrings=jrings, rings=rings, cli=cli,
                root=root, data=data)


# ---- (a), (b) the pure functions ----

@pytest.mark.parametrize("n", [1, 511, 512, 1300, 4097])
@pytest.mark.parametrize("kind", ["normal", "zeros", "mixed"])
def test_quantize_groups_bytes_match_jax(n, kind):
    rng = np.random.default_rng(n)
    x = {"normal": rng.standard_normal(n) * 3, "zeros": np.zeros(n),
         "mixed": np.where(np.arange(n) % 700 < 350, 0.0,
                           rng.standard_normal(n) * 1e-4)}[kind]
    x = x.astype(np.float32)
    jq, js = jquant.quantize_groups(jnp.asarray(x))
    q, s = quant.quantize_groups(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.asarray(jq).tobytes() == q.numpy().tobytes()
    assert np.asarray(js).tobytes() == s.numpy().tobytes()
    back = quant.dequantize_groups(q, s, n)
    assert (np.asarray(jquant.dequantize_groups(jq, js, n)).tobytes()
            == back.numpy().tobytes())
    if kind == "zeros":
        assert not back.any() and (s == 1).all()


@pytest.mark.parametrize("seed", range(6))
def test_bucket_partition_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5000, size=int(rng.integers(1, 60))).tolist()
    bound = int(rng.integers(4, 40000))
    for itemsize in (2, 4):
        assert (overlap.bucket_partition(sizes, bound, itemsize)
                == joverlap.bucket_partition(sizes, bound, itemsize))


# ---- (c) the dp dim of every leaf ----

def _jleaf(tree, key):
    node = tree
    for part in jax_key(key)[0].split("/")[1:]:
        node = node[part]
    return node


@pytest.mark.parametrize("model", ["llama", "gpt2", "moe"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dp", [2, 4])
def test_dp_dims_match_jax(model, tp, dp):
    family = "gpt2" if model == "gpt2" else "llama"
    cfg = MOE if model == "moe" else CFG
    cls = JGPT2 if family == "gpt2" else JTransformer
    jm = cls(JModelConfig(**cfg), tp_size=tp)
    mesh = jmake_mesh(JMeshConfig(dp=dp, tp=tp))
    shapes = jzero._eval_shapes(jm)
    z1 = jzero.zero1_specs(jm.specs(), shapes, mesh)
    z3 = jzero.zero3_dims(jm, dp)
    full = build_model(family, ModelConfig(**cfg)).state_dict()
    sharded = 0
    for key, x in shard_params(full, tp, 0).items():
        d = zero_dim(key, x.shape, dp)
        stacked = jax_key(key)[1]
        jd = -1 if d < 0 else ((x.ndim - 1 - d if transposed(key) else d)
                               + stacked)
        want3 = _jleaf(z3, key)
        if stacked:
            assert jd == want3, key
        else:
            spec = tuple(_jleaf(z1, key))
            want1 = spec.index("dp") if "dp" in spec else -1
            assert jd == want1 == want3, key
        sharded += d >= 0
    assert sharded > len(full) // 2


# ---- (d) the int8 ring ----

@pytest.mark.parametrize("n", [2, 4])
def test_int8_ring_matches_jax_and_is_rank_identical(runs, n):
    got = runs["res"][f"ring{n}"]
    jall, jrs = runs["jrings"][n]
    for r in got:
        assert r["allreduce"].tobytes() == got[0]["allreduce"].tobytes()
        np.testing.assert_allclose(r["allreduce"], jall[r["coords"]["dp"]],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["reduce_scatter"],
                                   jrs[r["coords"]["dp"]], rtol=0, atol=1e-6)
    x, blocks = runs["rings"][n]
    exact = x.astype(np.float64).sum(0)
    # n requantizations of at most amax/254 each, per 512-element group
    assert np.abs(got[0]["allreduce"] - exact).max() <= n * np.abs(x).sum(
        0).max() / 254


# ---- (e) the stages against JAX's stage 0 and the port's ----

def _whole(per_rank, key="params"):
    """The tp-assembled tree of the dp = cp = 0 ranks (every dp rank holds
    the same whole leaves: checked)."""
    c = lambda r: r["coords"]
    first = {c(r)["tp"]: r[key] for r in per_rank
             if c(r)["dp"] == 0 and c(r)["cp"] == 0}
    for r in per_rank:
        for k, v in r[key].items():
            assert np.array_equal(v, first[c(r)["tp"]][k]), k
    return assemble_params([{k: torch.from_numpy(v) for k, v in
                             first[t].items()} for t in sorted(first)])


def _names(mesh):
    return list(STAGES) + (list(DP2_EXTRA) if mesh == "dp2" else [])


@pytest.mark.parametrize("mesh,stage", [(m, s) for m in MESHES
                                        for s in _names(m)])
def test_stage_matches_jax_stage0(runs, mesh, stage):
    i = _names(mesh).index(stage)
    per_rank = [r[i] for r in runs["res"][mesh]]
    base = [r[0] for r in runs["res"][mesh]]
    jlosses, jparams = runs["refs"][mesh]
    for r, b in zip(per_rank, base):
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], b["losses"], rtol=1e-6)
    params = _whole(per_rank)
    assert params.keys() == jparams.keys()
    for k, ref in jparams.items():
        np.testing.assert_allclose(params[k].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_gpt2_stage3_matches_stage0(runs):
    z0, z3 = ([r[i] for r in runs["res"]["gpt2"]] for i in (0, 1))
    for a, b in zip(z3, z0):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
    p0, p3 = _whole(z0), _whole(z3)
    for k in p0:
        if k.endswith("wk.bias"):
            # softmax ignores a shift shared by every key, so this
            # gradient is rounding noise, which Adam scales up to steps
            # of ~lr: the gathered weights round differently from the
            # resting ones. Bounded by the three steps' lr
            assert float((p3[k] - p0[k]).abs().max()) <= STEPS * ADAM["lr"]
            continue
        np.testing.assert_allclose(p3[k].numpy(), p0[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the tied embedding and the position table rest as dp shards (d and
    # maxlen: the first free dims)
    assert z3[0]["dims"]["embedding.weight"] == 1
    assert z3[0]["dims"]["pos_embedding.weight"] == 0


# ---- (f) the wires ----

@pytest.mark.parametrize("case", WIRE_RUNS + [(2, "int8_tp2_sp")])
def test_wire_within_bound_of_f32_reducer(runs, case):
    stage, wire = case
    if wire == "int8_tp2_sp":
        res, i, wire = runs["res"]["wires_tp2"], 1, "int8"
    else:
        res, i = runs["res"]["wires"], 1 + WIRE_RUNS.index(case)
    ref = _whole([r[0] for r in res], "grads")
    got = _whole([r[i] for r in res], "grads")
    assert all(r[i]["dtypes"] == ["torch.float32"] for r in res)
    bound = WIRE_BOUND.get(wire, 1e-6)
    for k, g in ref.items():
        top = float(g.abs().max())
        err = float((got[k] - g).abs().max())
        assert err <= bound * max(top, 1e-30), (k, err / top)
    if wire == "f32":
        return
    # the compressed wire does change the numbers
    assert any(not torch.equal(got[k], ref[k]) for k in ref)


# ---- (g) MoE ----

def test_moe_zero1_equals_zero0(runs):
    z0, z1 = ([r[i] for r in runs["res"]["moe"]] for i in (0, 1))
    for a, b in zip(z1, z0):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
        for k, v in b["params"].items():
            np.testing.assert_allclose(a["params"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    # the expert moments shard over dp on their d dim
    assert z1[0]["dims"]["layers.0.moe.gate"] == 1
    assert z1[0]["held"]["moments"] < z0[0]["held"]["moments"]


# ---- (h) checkpoints ----

def _jax_load(d, step):
    jm = JTransformer(JModelConfig(**CFG))
    tmpl = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    params, state, got = jckpt.load_checkpoint(d, step, tmpl, jm.specs(),
                                               with_opt=True)
    assert got == step
    return jax.tree.map(np.asarray, (params, state.mu, state.nu))


def test_stage2_checkpoint_is_jax_format_and_resumes_anywhere(runs):
    root, cli = runs["root"], runs["cli"]
    two = _jax_load(os.path.join(root, "zero2"), 2)
    zero = _jax_load(os.path.join(root, "zero0"), 2)
    for a, b in zip(jax.tree.leaves(two), jax.tree.leaves(zero)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    jm = JTransformer(JModelConfig(**CFG))
    want = jlayout.make_layout(jmake_mesh(JMeshConfig(dp=2)),
                               jm.canonical_specs(), zero_stage=2).to_json()
    (path,) = glob.glob(os.path.join(root, "zero2", "tprank-0_iter-2_*.npz"))
    with np.load(path) as f:
        assert str(f["__layout__"]) == want
        assert int(f["__zero_stage__"]) == 2
    whole = cli["whole"]["losses"]
    for stage in (0, 3):
        out = cli[f"resume{stage}"]
        assert out["start_step"] == 2 and out["zero_stage"] == stage
        np.testing.assert_allclose(out["losses"], whole[2:], rtol=1e-6)
    # one reduce-scatter bucket, one all-reduce bucket of the leaves that
    # do not shard (the column biases); the flat buffer at stage 0
    assert cli["zero2"]["buckets"] == 2 and cli["zero0"]["buckets"] == 0


# ---- (i) refusals ----

REFUSED = [["--zero", "3", "--dp_reduce_dtype", "bf16"],
           ["--dp_reduce_dtype", "int8"],
           ["--zero", "1", "--dp_reduce_dtype", "bf16"],
           ["--dp_reduce_bucket_mb", "25", "--pp_size", "2"],
           ["--dp_reduce_bucket_mb", "25", "--num_experts", "4"],
           ["--zero", "2", "--num_experts", "4"],
           ["--zero", "3", "--num_experts", "4"],
           ["--zero", "2", "--pp_size", "2"],
           ["--zero", "2", "--tp_size", "2"],
           ["--zero", "3", "--tp_size", "2"],
           ["--zero", "3", "--remat", "false"]]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: "_".join(f))
def test_refusals_in_jax_words(tmp_path, flags):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    base = ["--model", "tiny", "--maxlen", "64", "--data_path", data,
            "--save_dir", str(tmp_path / "ck"), "--max_steps", "1",
            "--no_sentinel"]
    with pytest.raises(SystemExit) as theirs:
        jtrain.main(base + flags)
    with pytest.raises(SystemExit) as ours:
        train_cli.main(base[:-1] + ["--device", "cpu"] + flags)
    assert isinstance(theirs.value.code, str)
    assert ours.value.code == theirs.value.code


@pytest.mark.parametrize("flags", [["--zero", "1"], ["--zero", "2"],
                                   ["--zero", "3"], ["--zero1"],
                                   ["--dp_reduce_bucket_mb", "25"],
                                   ["--zero", "2", "--dp_reduce_dtype",
                                    "int8"],
                                   ["--dp_reduce_bucket_mb", "4",
                                    "--dp_reduce_dtype", "bf16"]])
def test_zero_flags_are_ported(flags):
    args = train_cli.get_train_args(["--data_path", "x", "--dp_size", "2"]
                                    + flags)
    train_cli.refuse_off_slice(args)          # no NotImplementedError


# ---- (j) the held bytes ----

@pytest.mark.parametrize("mesh", list(MESHES))
def test_held_bytes_follow_the_ladder(runs, mesh):
    per_stage = {}
    for i, name in enumerate(STAGES):
        for r in (rank[i] for rank in runs["res"][mesh]):
            held = sum(r["held"].values())
            assert held == r["expected"], (name, r["held"])
            if name == "zero0":
                n = r["held"]["params"] // 4
                assert held == n * zero_state_bytes_per_param(0, 2)
            per_stage.setdefault(name, set()).add(held)
    sizes = [per_stage[n].pop() for n in STAGES]   # the same on every rank
    assert sizes[0] > sizes[1] > sizes[2] > sizes[3]
    held = [runs["res"][mesh][0][i]["held"] for i in range(4)]
    assert held[1]["moments"] < held[0]["moments"]
    assert held[2]["grads"] < held[1]["grads"] == held[0]["grads"]
    assert held[3]["params"] < held[2]["params"] == held[0]["params"]


def test_cli_reports_held_bytes_and_hops(runs):
    cli = runs["cli"]
    for name in ("zero0", "zero2", "resume3"):
        for r in cli[name]["ranks"]:
            assert sum(r["state_bytes"].values()) == r[
                "expected_state_bytes"]
    z0, z2 = (cli[n]["ranks"][0]["hops_per_step"] for n in ("zero0",
                                                            "zero2"))
    # stage 0: the loss's sum and the flat gradient all-reduce over the
    # batch group; stage 2: the loss's sum and the leaves that do not
    # shard over it, and over dp the norm's sum, one reduce-scatter and
    # the parameter all-gather
    assert z0["batch"]["calls"] == 2 and "dp" not in z0
    assert z2["batch"]["calls"] == 2 and z2["dp"]["calls"] == 3
    # the reduce-scatter moves half the bytes the all-reduce did, and the
    # all-gather adds them back
    total = lambda z: sum(v["ring_bytes"] for v in z.values())
    np.testing.assert_allclose(total(z2), total(z0), rtol=1e-5)
    assert z2["batch"]["ring_bytes"] < 0.1 * z0["batch"]["ring_bytes"]
