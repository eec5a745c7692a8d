"""The port's tensor-parallel slice (PyTorch, gloo ranks on the CPU) against
the JAX package's: tp > 1, the dp axis and sequence parallelism (SP),
composed with cp.

Both packages get the same inputs, made from a seed with numpy, and the
same weights (a JAX `init` tree; the port's ranks take their shard through
`interop.params_from_jax(tree, tp, rank)`). JAX runs on the virtual CPU
devices inside `shard_map` over `make_mesh(MeshConfig(dp, cp, tp))`; the
port runs its ranks as spawned processes over gloo (`runtime/launch.spawn`,
the rank programs of `runtime/tp_checks.py`): three groups, started once
and in the background while JAX compiles.

(a) the Megatron pairs of `ops/collectives.py` (copy_to, reduce_from,
    split_to, gather_from and reduce_scatter along the last and the
    sequence dim, the max) at tp 2 and 4, forward and backward, against
    JAX's `ops/collectives` in the same scalar losses; outputs and
    gradients within 1e-6, the scalar loss (a sum of a few hundred
    products) within 1e-5 relative;
(b) the column and row layers in every layout and the vocab-parallel
    embedding (vocab 96, and a padded 97 with ids outside the table),
    values and every rank's gradient shard against JAX's global gradients,
    sliced; within 1e-6 + 1e-5 of each tensor's largest |value|;
(c) the model's loss and every gradient at (dp, cp, tp) in (1, 1, 2),
    (1, 1, 4), (2, 1, 2) and (1, 2, 2), SP off and on, both loss modes, a
    padded vocab, and Ulysses at tp 2 x cp 2, after the train step's
    gradient reductions, against `jax.value_and_grad(make_loss(mesh))` on
    the same mesh (the JAX loss and gradient are one function of the
    params in every layout and mode: each port variant is held against the
    JAX value of its mesh, JAX at both SP settings and both modes at tp 2);
    loss rtol 1e-5, gradients rtol 1e-4 atol 1e-5;
(d) 5 train steps with `--clip_grad_norm` at tp 2 with SP and at tp 2 x
    dp 2 against JAX `build_train_step`: loss and grad norm within 1e-4;
    a tp=2 model and a tp=1 model from one seed give one loss (1e-5);
(e) checkpoints: a JAX tp=2 checkpoint resumes in the port's CLI at tp=2
    and at tp=1 to the same losses, the tp=2 files the port writes load in
    JAX and in the port at tp=1 to the same global params; the CLI's
    refusals and divisibility errors.
"""

import dataclasses
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops import collectives as JC
from distributed_pytorch_from_scratch_tpu.parallel.embedding import (
    VocabParallelEmbedding as JEmbedding)
from distributed_pytorch_from_scratch_tpu.parallel.linear import (
    ColumnParallelLinear as JColumn, RowParallelLinear as JRow)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, MeshConfig, ModelConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax, params_to_jax, shards_to_jax)
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    assemble_params)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
    axis_groups, coords, make_mesh)
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from _torch_threads import two_torch_threads  # noqa: F401


# ---- shapes and inputs ----

GQA = dict(attn_dim=64, ffn_dim=128, num_heads=4, num_kv_heads=2,
           num_layers=2, vocab_size=96, maxlen=32, compute_dtype="float32")
MHA = dict(GQA, num_kv_heads=None)       # tp 4 and Ulysses at tp 2 x cp 2
PAD = dict(GQA, vocab_size=97)           # the vocab pads to 98 at tp 2
CFGS = {"gqa": GQA, "mha": MHA, "pad": PAD}
B, T = 4, 32


def _batch(rng, vocab, lead=()):
    """(ids, targets, positions) int32 (lead + (B, T)); some targets
    ignored, unevenly over rows and sequence chunks."""
    ids = rng.integers(0, vocab, size=lead + (B, T + 1))
    tgt = ids[..., 1:].copy()
    tgt[..., 1, T - 11:] = IGNORE_INDEX
    tgt[..., 3, 2:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), lead + (B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[..., :-1], tgt, pos)]


def _tree(cfg, tp):
    jm = JTransformer(JModelConfig(**cfg), tp_size=tp)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(3)))


# ---- (a) the collective pairs ----

# name: (op, dim); x is (2, 4, 8) per rank
PAIRS = {"copy_to": ("copy_to", -1), "reduce_from": ("reduce_from", -1),
         "split_to": ("split_to", -1),
         "gather_from_last": ("gather_from", -1),
         "gather_from_seq": ("gather_from", -2),
         "reduce_scatter_last": ("reduce_scatter", -1),
         "reduce_scatter_seq": ("reduce_scatter", -2),
         "all_max": ("all_max", -1)}
PAIR_RUNS = [(tp, name) for tp in (2, 4) for name in PAIRS]
XS = (2, 4, 8)


def _pair_inputs(tp, name, seed):
    """x, w: stacked over the ranks (varying) or whole (replicated), the
    shapes `tp_checks.collective_pairs` documents."""
    op, dim = PAIRS[name]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if op == "copy_to":
        return f(*XS), f(tp, *XS)
    if op == "reduce_from":
        return f(tp, *XS), f(*XS)
    if op == "split_to":
        return f(*XS), f(tp, *XS[:-1], XS[-1] // tp)
    if op == "gather_from":
        shape = list(XS)
        shape[dim] *= tp
        return f(tp, *XS), f(tp, *shape)
    if op == "reduce_scatter":
        shape = list(XS)
        shape[dim] //= tp
        return f(tp, *XS), f(tp, *shape)
    return f(tp, *XS), None


@functools.lru_cache(maxsize=None)
def _jax_pair_fn(tp, name):
    """Jitted (x, w) -> ((loss, y stacked over ranks), dx) of JAX's op in
    the scalar loss `tp_checks.collective_pairs` builds."""
    op, dim = PAIRS[name]
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    varying_x = op in ("reduce_from", "gather_from", "reduce_scatter",
                       "all_max")
    x_spec = P("tp") if varying_x else P()
    w_spec = P() if op == "reduce_from" else P("tp")

    def shard(x, w):
        x = x[0] if varying_x else x
        if op == "all_max":
            return jnp.zeros(()), jax.lax.pmax(x, "tp")[None]
        w = w if op == "reduce_from" else w[0]
        if op == "copy_to":
            y = JC.copy_to(x, "tp")
        elif op == "reduce_from":
            y = JC.reduce_from(x, "tp")
        elif op == "split_to":
            y = JC.split_to(x, "tp")
        elif op == "gather_from":
            y = JC.gather_from(x, "tp", tiled_axis=dim)
        else:
            y = JC.reduce_scatter(x, "tp", scatter_axis=dim)
        s = jnp.sum(y * w)
        if op == "reduce_from":
            loss = s
        elif op == "gather_from":
            loss = JC.reduce_from(s, "tp") / tp
        else:
            loss = JC.reduce_from(s, "tp")
        return loss, y[None]

    fn = jax.shard_map(shard, mesh=mesh, in_specs=(x_spec, w_spec),
                       out_specs=(P(), P("tp")))
    if op == "all_max":
        return jax.jit(fn)
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


# ---- (b) the layers ----

D_IN, D_OUT = 16, 24
# name: (kind, options, x_dim, w_dim (of the output, None: replicated))
LAYERS = {
    "column_replicated": ("column", dict(input_layout="replicated"),
                          None, 2),
    "column_gather_output": ("column", dict(input_layout="replicated",
                                            gather_output=True), None, None),
    "column_seq_sharded": ("column", dict(input_layout="seq_sharded"), 1, 2),
    "column_gathered": ("column", dict(input_layout="gathered",
                                       pre_gather=True), 1, 2),
    "row_replicated": ("row", dict(output_layout="replicated"), 2, None),
    "row_split_input": ("row", dict(output_layout="replicated",
                                    split_input=True), None, None),
    "row_seq_sharded": ("row", dict(output_layout="seq_sharded"), 2, 1),
    "embedding_96": ("embedding", dict(output_layout="replicated"),
                     None, None),
    "embedding_97_padded": ("embedding", dict(output_layout="replicated"),
                            None, None),
    "embedding_97_seq_sharded": ("embedding",
                                 dict(output_layout="seq_sharded"), None, 1),
}
LAYER_TP = 2


def _spec(dim, ndim=3):
    spec = [None] * ndim
    if dim is not None:
        spec[dim] = "tp"
    return P(*spec)


@functools.lru_cache(maxsize=None)
def _jax_layer(name):
    """The JAX layer of case `name`, its params, and its per-shard apply
    (made once per case: the fixture and the reference share them)."""
    kind, opts, _, _ = LAYERS[name]
    key = jax.random.key(len(name))
    if kind == "embedding":
        vocab = 96 if "96" in name else 97
        layer = JEmbedding(vocab, D_IN, tp_size=LAYER_TP)
        apply = lambda p, x: layer.apply(p, x, opts["output_layout"])
        return layer, layer.init(key), apply
    if kind == "column":
        layer = JColumn(D_IN, D_OUT,
                        gather_output=opts.get("gather_output", False))

        def apply(p, x):
            if opts.get("pre_gather"):
                x = JC.gather_from(x, "tp", tiled_axis=-2)
            return layer.apply(p, x, input_layout=opts["input_layout"])
    else:
        layer = JRow(D_OUT, D_IN, split_input=opts.get("split_input", False))
        apply = lambda p, x: layer.apply(p, x,
                                         output_layout=opts["output_layout"])
    params = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.fold_in(key, a.size), a.shape), layer.init(key))
    return layer, params, apply


def _layer_inputs(name):
    kind, _, _, w_dim = LAYERS[name]
    rng = np.random.default_rng(len(name) + 7)
    if kind == "embedding":
        vocab = 96 if "96" in name else 97
        # out-of-range ids both sides, and 97: a padded row at tp 2
        x = rng.integers(-3, vocab + 4, size=(2, 8)).astype(np.int32)
        x[0, :3] = (-1, vocab, 97)
        out = (2, 8, D_IN)
    else:
        idim, odim = (D_IN, D_OUT) if kind == "column" else (D_OUT, D_IN)
        x = rng.standard_normal((2, 8, idim)).astype(np.float32)
        out = (2, 8, odim)
    return x, rng.standard_normal(out).astype(np.float32)


def _jax_layer_ref(name, x, w):
    """JAX's output and the global gradients of sum(out * w) in the params
    and x, in one jitted program (one compile per case: the eager
    shard_map and its gradient compiled several). A replicated output that
    a gather made is the mean of the tp copies, inside the shard_map (as
    `tp_checks.layer_cases` takes it)."""
    kind, opts, x_dim, w_dim = LAYERS[name]
    layer, params, apply = _jax_layer(name)
    mesh = jmake_mesh(JMeshConfig(tp=LAYER_TP))
    in_specs = (layer.specs(), _spec(x_dim, x.ndim))
    if opts.get("gather_output"):
        def shard(p, x):
            y = apply(p, x)
            return JC.reduce_from(jnp.sum(y * w), "tp") / LAYER_TP, y[None]

        fn = jax.shard_map(shard, mesh=mesh, in_specs=in_specs,
                           out_specs=(P(), P("tp")))
        loss = lambda p, x: fn(p, x)[0]
        out = lambda p, x: fn(p, x)[1][0]
    else:
        fn = jax.shard_map(apply, mesh=mesh, in_specs=in_specs,
                           out_specs=_spec(w_dim))
        loss = lambda p, x: jnp.sum(fn(p, x) * w)
        out = fn
    argnums = 0 if kind == "embedding" else (0, 1)
    y, grads = jax.jit(lambda p, x: (out(p, x), jax.grad(
        loss, argnums=argnums)(p, x)))(params, x)
    grads, dx = (grads, None) if kind == "embedding" else grads
    return (jax.tree.map(np.asarray, params), np.asarray(y),
            jax.tree.map(np.asarray, grads),
            None if dx is None else np.asarray(dx))


# ---- (c), (d) the model ----

# JAX references: name -> (cfg, (dp, cp, tp), sp, mode, cp_impl)
JAX_MODEL = {
    "gqa_tp2": ("gqa", (1, 1, 2), False, "vocab_parallel", "ring"),
    "gqa_tp2_sp_gather": ("gqa", (1, 1, 2), True, "gather", "ring"),
    "pad_tp2": ("pad", (1, 1, 2), True, "vocab_parallel", "ring"),
    "mha_tp4": ("mha", (1, 1, 4), True, "vocab_parallel", "ring"),
    "mha_dp2_tp2": ("mha", (2, 1, 2), True, "vocab_parallel", "ring"),
    "mha_cp2_tp2": ("mha", (1, 2, 2), True, "vocab_parallel", "ring"),
    "mha_cp2_tp2_ulysses": ("mha", (1, 2, 2), False, "vocab_parallel",
                            "ulysses"),
}
VARIANTS = [(sp, mode) for sp in (False, True)
            for mode in ("vocab_parallel", "gather")]
# port run name -> (JAX reference, sp, mode)
MODEL_RUNS = {
    **{f"gqa_tp2-sp{int(sp)}-{mode}": (
        "gqa_tp2" if mode == "vocab_parallel" else "gqa_tp2_sp_gather",
        sp, mode) for sp, mode in VARIANTS},
    **{f"{ref}-sp{int(sp)}-{mode}": (ref, sp, mode)
       for ref in ("pad_tp2", "mha_tp4", "mha_dp2_tp2", "mha_cp2_tp2")
       for sp, mode in VARIANTS},
    **{f"mha_cp2_tp2_ulysses-sp{int(sp)}-vocab_parallel": (
        "mha_cp2_tp2_ulysses", sp, "vocab_parallel") for sp in (False, True)},
}
ADAM = dict(lr=1e-3, warmup_steps=2, max_steps=5, clip_grad_norm=0.5)
# name -> (cfg, (dp, cp, tp), sp)
TRAJECTORIES = {"tp2_sp": ("gqa", (1, 1, 2), True),
                "tp2_dp2": ("mha", (2, 1, 2), False)}


def _axes(mesh):
    return dict(zip(("dp", "cp", "tp"), mesh))


def _jax_model_ref(name, tree, batch):
    cfg, mesh_shape, sp, mode, impl = JAX_MODEL[name]
    dp, cp, tp = mesh_shape
    jm = JTransformer(JModelConfig(**CFGS[cfg]), tp_size=tp, cp_size=cp,
                      cp_impl=impl, sequence_parallel=sp)
    mesh = jmake_mesh(JMeshConfig(dp=dp, cp=cp, tp=tp))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss(mesh, mode)))(
        params, *batch)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _jax_trajectory(name, tree, steps):
    cfg, (dp, cp, tp), sp = TRAJECTORIES[name]
    jm = JTransformer(JModelConfig(**CFGS[cfg]), tp_size=tp,
                      sequence_parallel=sp)
    mesh = jmake_mesh(JMeshConfig(dp=dp, cp=cp, tp=tp))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    step = jtrain_step.build_train_step(jm, mesh, JOptimizerConfig(**ADAM),
                                        with_grad_norm=True)
    state = joptim.init_adam_state(params)
    losses, gnorms = [], []
    for i in range(5):
        params, state, (loss, gnorm) = step(params, state,
                                            *(x[i] for x in steps))
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return losses, gnorms


# ---- (e) the CLI ----

TINY = dict(dataclasses.asdict(model_preset("tiny")), num_kv_heads=2,
            maxlen=64, compute_dtype="float32")
TINY_FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
              "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
              "--log_interval", "2", "--device", "cpu"]
TP2 = ["--tp_size", "2", "--dist_backend", "gloo"]


def _write_corpus(path, docs=40, lo=5, hi=60, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(lo, hi, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


def _jax_tp2_checkpoint(save_dir):
    """A JAX tp=2 checkpoint at iter 3 (params and moments) of the tiny
    shape; returns the JAX model."""
    jm = JTransformer(JModelConfig(**TINY), tp_size=2)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(5)))
    state = joptim.init_adam_state(params)
    state = joptim.AdamState(step=np.int32(3),
                             mu=jax.tree.map(lambda a: a + 1e-3, state.mu),
                             nu=jax.tree.map(lambda a: a + 1e-6, state.nu))
    jckpt.save_checkpoint(save_dir, 3, 6.5, params, jm.specs(), 2, state)
    return jm


# ---- the runs, once per module ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's three groups in the background — two ranks (tp 2: pairs,
    layers, models, a trajectory, the seed identity), four ranks (tp 4,
    tp x dp, tp x cp: pairs, models, a trajectory) and the tp=2 CLI — and
    JAX's references meanwhile."""
    rng = np.random.default_rng(0)
    trees = {"gqa": _tree(GQA, 1), "mha": _tree(MHA, 1), "pad": _tree(PAD, 2)}
    batches = {c: _batch(rng, CFGS[c]["vocab_size"]) for c in CFGS}
    steps = {n: _batch(np.random.default_rng(10 + i),
                       CFGS[TRAJECTORIES[n][0]]["vocab_size"], lead=(5,))
             for i, n in enumerate(TRAJECTORIES)}
    pairs = {(tp, n): _pair_inputs(tp, n, seed=i)
             for i, (tp, n) in enumerate(PAIR_RUNS)}
    layers = {n: _layer_inputs(n) for n in LAYERS}
    layer_params = {n: jax.tree.map(np.asarray, _jax_layer(n)[1])
                    for n in LAYERS}

    def pair_job(tp):
        cases = [dict(op=PAIRS[n][0], dim=PAIRS[n][1], x=pairs[t, n][0],
                      w=pairs[t, n][1]) for t, n in PAIR_RUNS if t == tp]
        return ("collective_pairs", {"tp": tp}, {"cases": cases})

    def model_job(names):
        out = []
        for mesh in sorted({JAX_MODEL[MODEL_RUNS[n][0]][1] for n in names}):
            for cfg in ("gqa", "pad", "mha"):
                group = [n for n in names
                         if JAX_MODEL[MODEL_RUNS[n][0]][1] == mesh
                         and JAX_MODEL[MODEL_RUNS[n][0]][0] == cfg]
                if not group:
                    continue
                out.append(("model_runs", _axes(mesh), dict(
                    cfg=CFGS[cfg], tree=trees[cfg],
                    runs=[dict(sp=MODEL_RUNS[n][1], mode=MODEL_RUNS[n][2],
                               impl=JAX_MODEL[MODEL_RUNS[n][0]][4],
                               batch=batches[cfg]) for n in group])))
                out[-1][2]["names"] = group
        return out

    def trajectory_job(name):
        cfg, mesh, sp = TRAJECTORIES[name]
        return ("model_runs", _axes(mesh), dict(
            cfg=CFGS[cfg], tree=trees[cfg],
            runs=[dict(sp=sp, batch=steps[name], steps=5, optim=ADAM)]))

    two = [n for n in MODEL_RUNS if JAX_MODEL[MODEL_RUNS[n][0]][1] ==
           (1, 1, 2)]
    four = [n for n in MODEL_RUNS if n not in two]
    layer_cases = [dict(kind=LAYERS[n][0], options=LAYERS[n][1],
                        params=layer_params[n], x=layers[n][0],
                        w=layers[n][1], x_dim=LAYERS[n][2],
                        w_dim=LAYERS[n][3],
                        vocab_size=96 if "96" in n else 97) for n in LAYERS]
    todo2 = ([pair_job(2), ("layer_cases", {"tp": 2},
                            {"cases": layer_cases})]
             + model_job(two) + [trajectory_job("tp2_sp"), (
                 "seed_identity", {"tp": 2},
                 dict(cfg=GQA, seed=11, batch=batches["gqa"]))])
    todo4 = [pair_job(4)] + model_job(four) + [trajectory_job("tp2_dp2")]
    names = {k: [j[2].pop("names") if "names" in j[2] else None for j in t]
             for k, t in (("two", todo2), ("four", todo4))}

    # the CLI: the tp=2 run resumes a JAX tp=2 checkpoint, 2 steps
    root = tmp_path_factory.mktemp("tp_cli")
    data = str(root / "tokens.json")
    _write_corpus(data)
    cli_dirs = {k: str(root / k) for k in ("tp2", "tp1")}
    jm = _jax_tp2_checkpoint(cli_dirs["tp2"])
    _jax_tp2_checkpoint(cli_dirs["tp1"])
    cli_flags = TINY_FLAGS + ["--data_path", data, "--max_steps", "5",
                              "--resume"]

    with ThreadPoolExecutor(max_workers=3) as pool:
        g2 = pool.submit(launch.spawn, tp_checks.jobs, 2, todo2)
        g4 = pool.submit(launch.spawn, tp_checks.jobs, 4, todo4)
        cli = pool.submit(train_cli.main, cli_flags + TP2 + [
            "--save_dir", cli_dirs["tp2"]])
        refs = {
            "pairs": {k: _jax_pair_fn(*k)(*(jnp.asarray(a) for a in
                                            pairs[k] if a is not None))
                      if PAIRS[k[1]][0] != "all_max" else
                      _jax_pair_fn(*k)(jnp.asarray(pairs[k][0]),
                                       jnp.zeros((k[0], 1)))
                      for k in PAIR_RUNS},
            "layers": {n: _jax_layer_ref(n, *layers[n]) for n in LAYERS},
            "model": {n: _jax_model_ref(n, trees[JAX_MODEL[n][0]],
                                        batches[JAX_MODEL[n][0]])
                      for n in JAX_MODEL},
            "trajectory": {n: _jax_trajectory(n, trees[TRAJECTORIES[n][0]],
                                              steps[n])
                           for n in TRAJECTORIES},
        }
        results = {"two": g2.result(), "four": g4.result()}
        cli_tp2 = cli.result()
    cli_tp1 = train_cli.main(cli_flags + ["--save_dir", cli_dirs["tp1"]])
    return dict(refs=refs, results=results, names=names, pairs=pairs,
                layers=layers, cli=dict(tp2=cli_tp2, tp1=cli_tp1,
                                        dirs=cli_dirs, jmodel=jm,
                                        data=data))


def _job(runs, group, name):
    """The per-rank results of the job `name` (a job kind, or a model run's
    name) in `group`."""
    res, names = runs["results"][group], runs["names"][group]
    for j in range(len(names)):
        if names[j] is not None and name in names[j]:
            i = names[j].index(name)
            return [rank[j][i] for rank in res]
    raise KeyError(name)


# ---- (a) ----

@pytest.mark.parametrize("tp,name", PAIR_RUNS)
def test_collective_pair_matches_jax(runs, tp, name):
    group = "two" if tp == 2 else "four"
    i = [n for t, n in PAIR_RUNS if t == tp].index(name)
    per_rank = [rank[0][i] for rank in runs["results"][group]]
    ref = runs["refs"]["pairs"][tp, name]
    if PAIRS[name][0] == "all_max":
        _, y = ref
        for r, got in enumerate(per_rank):
            np.testing.assert_allclose(got["y"], np.asarray(y)[r], atol=1e-6)
        return
    (loss, y), dx = ref
    dx = np.asarray(dx)
    varying = PAIRS[name][0] in ("reduce_from", "gather_from",
                                 "reduce_scatter")
    for r, got in enumerate(per_rank):
        # the scalar sums a few hundred products in another order: 1e-5
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        np.testing.assert_allclose(got["y"], np.asarray(y)[r], atol=1e-6)
        np.testing.assert_allclose(got["dx"], dx[r] if varying else dx,
                                   atol=1e-6)


# ---- (b) ----

def _layer_shard(name, key, arr, r):
    """Rank r's shard of a JAX global layer gradient, in torch's layout."""
    kind = LAYERS[name][0]
    if kind == "embedding":
        return np.array_split(arr, LAYER_TP, 0)[r]
    if key == "weight":
        return np.array_split(arr.T, LAYER_TP, 0 if kind == "column" else
                              1)[r]
    return np.array_split(arr, LAYER_TP)[r] if kind == "column" else arr


def _close(got, ref, what=""):
    """Within 1e-6 + 1e-5 of the tensor's largest |value| (rtol 1e-5, atol
    1e-6, scaled as the cp tests scale theirs): a sum of many f32 terms in
    another order errs by its terms' size, not its result's."""
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= 1e-6 + 1e-5 * np.abs(ref).max(), (what, err)


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(runs, name):
    kind, opts, x_dim, w_dim = LAYERS[name]
    i = list(LAYERS).index(name)
    per_rank = [rank[1][i] for rank in runs["results"]["two"]]
    _, y, grads, dx = runs["refs"]["layers"][name]
    for r, got in enumerate(per_rank):
        want = y if w_dim is None else np.array_split(y, LAYER_TP, w_dim)[r]
        _close(got["y"], want)
        for key, g in got["grads"].items():
            if kind == "row" and key == "bias" and w_dim is not None:
                # the full bias added to a sequence chunk: each rank holds
                # its chunk's part, summed over tp by the train step (SP)
                g = sum(p["grads"]["bias"] for p in per_rank)
            _close(g, _layer_shard(name, key, grads[key], r), key)
        if dx is not None:
            want = dx if x_dim is None else np.array_split(
                dx, LAYER_TP, x_dim)[r]
            _close(got["dx"], want, "dx")


# ---- (c) ----

def _assemble_grads(per_rank):
    """The global gradient from every rank's shard: the tp ranks at dp = cp
    = 0 in tp order; every other rank must hold its tp index's copy."""
    by_tp = {}
    for res in per_rank:
        c = res["coords"]
        if c["dp"] == 0 and c["cp"] == 0:
            by_tp[c["tp"]] = res["grads"]
    for res in per_rank:
        first = by_tp[res["coords"]["tp"]]
        for k, g in res["grads"].items():
            assert np.array_equal(g, first[k]), (res["coords"], k)
    return assemble_params([{k: torch.from_numpy(g) for k, g in
                             by_tp[t].items()} for t in sorted(by_tp)])


@pytest.mark.parametrize("name", list(MODEL_RUNS))
def test_model_loss_and_grads_match_jax(runs, name):
    ref_name = MODEL_RUNS[name][0]
    group = "two" if JAX_MODEL[ref_name][1] == (1, 1, 2) else "four"
    per_rank = _job(runs, group, name)
    jloss, jgrads = runs["refs"]["model"][ref_name]
    for res in per_rank:
        assert abs(res["loss"] - jloss) <= 1e-5 * abs(jloss)
    grads = _assemble_grads(per_rank)
    assert grads.keys() == jgrads.keys()
    for k, ref in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---- (d) ----

@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_trajectory_with_clipping_matches_jax(runs, name):
    group = "two" if name == "tp2_sp" else "four"
    per_rank = [rank[-2 if group == "two" else -1][0]
                for rank in runs["results"][group]]
    jlosses, jgnorms = runs["refs"]["trajectory"][name]
    assert max(jgnorms) > ADAM["clip_grad_norm"]    # the clip acts
    for res in per_rank:
        np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
        np.testing.assert_allclose(res["gnorms"], jgnorms, rtol=1e-4)


def test_tp2_model_from_a_seed_is_the_tp1_model(runs):
    for rank in runs["results"]["two"]:
        out = rank[-1]
        assert abs(out["tp"] - out["tp1"]) <= 1e-5 * abs(out["tp1"])


# ---- (e) ----

def test_cli_tp2_resumes_jax_checkpoint_like_tp1(runs):
    cli = runs["cli"]
    tp2, tp1 = cli["tp2"], cli["tp1"]
    assert tp2["start_step"] == tp1["start_step"] == 3
    assert tp2["steps"] == tp1["steps"] == 5
    assert (tp2["tp"], tp2["dp"], tp2["cp"], tp2["dist_backend"]) == (
        2, 1, 1, "gloo")
    assert [(r["rank"], r["tp"]) for r in tp2["ranks"]] == [(0, 0), (1, 1)]
    assert all(r["collectives"]["tp"]["calls"] > 0 for r in tp2["ranks"])
    # one function of the same params and batches: 1e-5 relative (f32,
    # summed in different orders)
    np.testing.assert_allclose(tp2["losses"], tp1["losses"], rtol=1e-5)
    assert all(np.isfinite(tp2["losses"]))
    # one file per tp rank, in the JAX shard format
    assert [p.split("/")[-1].split("_")[0] for p in tp2["checkpoints"]] == [
        "tprank-0", "tprank-1"]


def test_port_tp2_checkpoint_loads_in_jax_and_at_tp1(runs):
    cli = runs["cli"]
    save, jm = cli["dirs"]["tp2"], cli["jmodel"]
    template = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    jparams, jstate, step = jckpt.load_checkpoint(save, 5, template,
                                                  jm.specs(), with_opt=True)
    sd, state, n = checkpoint.load_checkpoint(save, 5, with_opt=True)
    assert step == n == int(jstate.step) == state.step == 5
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(sd), jparams)
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(state.mu),
                 jstate.mu)
    # each rank's shard, assembled, is the same global tree
    shards = [checkpoint.load_checkpoint(save, 5, tp_size=2, tp_rank=r)[0]
              for r in range(2)]
    jax.tree.map(np.testing.assert_array_equal, shards_to_jax(shards),
                 jparams)
    # and a tp=1 run resumes from it
    out = train_cli.main(TINY_FLAGS + ["--data_path", cli["data"],
                                       "--save_dir", save, "--max_steps",
                                       "6", "--resume"])
    assert out["start_step"] == 5 and out["steps"] == 6
    assert np.isfinite(out["losses"][0])


def test_padded_vocab_checkpoint_refuses_a_tp_it_cannot_map(tmp_path):
    jm = JTransformer(JModelConfig(**dict(TINY, vocab_size=1021)), tp_size=2)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    jckpt.save_checkpoint(str(tmp_path), 2, 7.0, params, jm.specs(), 2)
    sd, _, _ = checkpoint.load_checkpoint(str(tmp_path), 2)
    assert sd["embedding.weight"].shape[0] == 1022      # padded at tp 2
    with pytest.raises(ValueError, match="do not shard over tp=4"):
        checkpoint.load_checkpoint(str(tmp_path), 2, tp_size=4)
    model = Transformer(ModelConfig(**dict(TINY, vocab_size=1021)))
    with pytest.raises(SystemExit, match="does not map onto this run"):
        train_cli._load_into(model, sd, str(tmp_path))


def _cli(tmp_path, flags):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    return train_cli.main(TINY_FLAGS + ["--data_path", data, "--save_dir",
                                        str(tmp_path / "ck"),
                                        "--max_steps", "1"] + flags)


def test_tp_cli_refusals_and_divisibility_errors(tmp_path):
    # still refused, each naming its ROADMAP item
    for flags in (["--tp_overlap", "ring"], ["--coordinator", "h:1"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _cli(tmp_path, TP2 + flags)
    # ep > 1 runs a MoE model; a dense one is refused with JAX's message
    with pytest.raises(ValueError) as theirs:
        JTransformer(JModelConfig(**TINY), ep_size=2)
    with pytest.raises(ValueError) as ours:
        _cli(tmp_path, TP2 + ["--tp_size", "1", "--ep_size", "2"])
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as e:   # serving at tp>1 has no cp yet
        serve.main(["--dry_run", "--device", "cpu", "--tp_size", "2",
                    "--cp", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as exc:          # no card, no --device cpu
        train_cli.main(["--data_path", "x", "--tp_size", "2"])
    assert "no CUDA card" in str(exc.value.code)
    # the JAX package's divisibility errors, with its messages
    for tp in (3, 4):       # heads 4 over 3; kv heads 2 over 4
        flags = ["--tp_size", str(tp)]
        with pytest.raises(ValueError) as theirs:
            JTransformer(JModelConfig(**TINY), tp_size=tp)
        with pytest.raises(ValueError) as ours:
            _cli(tmp_path, TP2 + flags)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit, match="divisible by --dp_size 3"):
        _cli(tmp_path, ["--dp_size", "3", "--dist_backend", "gloo"])
    with pytest.raises(SystemExit, match="--sequence_parallel needs"):
        _cli(tmp_path, TP2 + ["--tp_size", "4", "--num_kv_heads", "4",
                              "--maxlen", "66", "--sequence_parallel"])
    # pp > 1 builds a mesh: two ranks, each on its stage, with a pp group
    meshes = launch.spawn(tp_checks.jobs, 2,
                          [("mesh_axes", {"pp": 2}, {})])
    assert [m[0]["coords"]["pp"] for m in meshes] == [0, 1]
    assert all(m[0]["axes"]["pp"] == [0, 1] and m[0]["world"] == 2
               for m in meshes)


def test_mesh_coordinates_follow_the_jax_device_order():
    """Global rank r sits where the JAX mesh puts device r: the grid (dp,
    pp, cp, ep, tp), tp innermost; the groups are the mesh's rows."""
    dp, cp, tp = 2, 2, 2
    jmesh = jmake_mesh(JMeshConfig(dp=dp, cp=cp, tp=tp))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(dp * cp * tp):
        c = coords(r, dp, cp, tp)
        assert ids[c["dp"], 0, c["cp"], 0, c["tp"]] == r
    assert axis_groups("tp", dp, cp, tp) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert axis_groups("cp", dp, cp, tp) == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert axis_groups("dp", dp, cp, tp) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert axis_groups("batch", dp, cp, tp) == [[0, 2, 4, 6], [1, 3, 5, 7]]


def test_checkpoint_missing_a_rank_file_is_refused_by_name(tmp_path):
    _jax_tp2_checkpoint(str(tmp_path))
    (rank1,) = tmp_path.glob("tprank-1_iter-3_*.npz")
    rank1.unlink()
    with pytest.raises(FileNotFoundError, match=r"rank\(s\) \[1\] are "
                                                r"missing"):
        checkpoint.load_checkpoint(str(tmp_path), 3, tp_size=2, tp_rank=0)
