"""The port's pipeline axis (PyTorch, gloo ranks on the CPU) against the JAX
package's: `--pp_size` through training, both schedules, composed with dp,
tp (SP off and on), cp (ring and Ulysses) and ep, both families, and pp
checkpoints.

Both packages get the same inputs, made from a seed with numpy, and the
same weights (a JAX `init` tree; each port rank takes its stage's layers
and its tp and ep shard of it). JAX runs `Transformer(pp_size=...)` (or
`GPT2Transformer`) on the virtual CPU devices of the same mesh, one jitted
program per case; the port runs its ranks over gloo (`runtime/launch
.spawn`, the rank program `tp_checks.model_runs`), two groups started in
the background while JAX compiles.

(a) the loss within 1e-5 (relative) and every rank's gradient shard, after
    the train step's reductions, within rtol 1e-4 (atol 1e-5) of JAX's
    global gradient, sliced: gpipe at pp 2 and 4, pp 2 with 4
    microbatches, pp 2 x tp 2 with SP off and on, pp 2 x dp 2, pp 2 x cp 2
    (ring and Ulysses), interleaved at pp 2 and pp 4 (V 2), per-step
    remat, the masked head (b 10 at pp 4, M 5: the batch does not split
    over the stages), MoE at pp 2 and pp 2 x ep 2 with dropped choices (cf
    1.0), and gpt2 interleaved at pp 2 x tp 2;
(b) `validate_pp`'s errors are JAX's, string for string; the mesh
    coordinates of a dp 2 x pp 2 x tp 2 world are JAX's device grid;
(c) a 4-step `train --pp_size 2` trajectory (gpipe and interleaved) equals
    the pp 1 trajectory within 1e-5;
(d) a pp 2 checkpoint carries the stamp JAX writes for that mesh, byte for
    byte, JAX's `load_checkpoint` reads it, and it resumes at pp 1 (the
    elastic path, with its `reshard_event`) as a pp 1 checkpoint resumes
    at pp 2, within 1e-5 of the pp 1 checkpoint resumed at pp 1.
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models import transformer as jtf
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.reshard import layout as jlayout
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    IGNORE_INDEX, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models import pipeline
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    shard_params)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
    axis_groups, coords)
from _torch_threads import two_torch_threads  # noqa: F401


CFG = dict(attn_dim=32, ffn_dim=64, num_heads=4, num_kv_heads=2,
           num_layers=4, vocab_size=96, maxlen=32, compute_dtype="float32")
CFGS = {"gqa": CFG, "deep": dict(CFG, num_layers=8),
        "moe": dict(CFG, num_kv_heads=None, num_experts=4, moe_top_k=2,
                    moe_capacity_factor=1.0),
        "gpt2": dict(CFG, num_kv_heads=None)}
T = 16
# name: (cfg, family, port mesh axes, batch rows, model options)
CASES = {
    "pp2": ("gqa", "llama", dict(pp=2), 4, {}),
    "pp4": ("gqa", "llama", dict(pp=4), 4, {}),
    "pp2_m4": ("gqa", "llama", dict(pp=2), 4, dict(pp_microbatches=4)),
    "pp2_tp2": ("gqa", "llama", dict(pp=2, tp=2), 4, {}),
    "pp2_tp2_sp": ("gqa", "llama", dict(pp=2, tp=2), 4, dict(sp=True)),
    "pp2_dp2": ("gqa", "llama", dict(dp=2, pp=2), 4, {}),
    "pp2_cp2_ring": ("gqa", "llama", dict(pp=2, cp=2), 4, {}),
    "pp2_cp2_ulysses": ("gqa", "llama", dict(pp=2, cp=2), 4,
                        dict(impl="ulysses")),
    "pp2_interleaved": ("gqa", "llama", dict(pp=2), 4,
                        dict(pp_schedule="interleaved")),
    "pp4_interleaved": ("deep", "llama", dict(pp=4), 4,
                        dict(pp_schedule="interleaved")),
    "pp2_remat_steps": ("gqa", "llama", dict(pp=2), 4,
                        dict(pp_microbatches=4, pp_remat_steps=True)),
    "pp4_masked_head": ("gqa", "llama", dict(pp=4), 10,
                        dict(pp_microbatches=5)),
    "moe_pp2": ("moe", "llama", dict(pp=2), 4, {}),
    "moe_pp2_ep2": ("moe", "llama", dict(pp=2, ep=2), 4, {}),
    "gpt2_pp2_tp2_interleaved": ("gpt2", "gpt2", dict(pp=2, tp=2), 4,
                                 dict(pp_schedule="interleaved", sp=True)),
}
JAX_OPTS = ("pp_microbatches", "pp_schedule", "pp_virtual",
            "pp_remat_steps")


def _tree(cfg, family, seed=3):
    cls = JTransformer if family == "llama" else JGPT2
    tree = jax.tree.map(np.asarray,
                        cls(JModelConfig(**CFGS[cfg])).init(
                            jax.random.key(seed)))
    if "moe" in tree["layers"]:     # a seeded router (the init's is zero)
        moe = tree["layers"]["moe"]
        moe["router"] = np.random.default_rng(seed).standard_normal(
            moe["router"].shape).astype(np.float32)
    return tree


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], size=(rows, T + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, T - 5:] = IGNORE_INDEX
    tgt[-1, 2:5] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(T), (rows, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (ids[:, :-1], tgt, pos)]


def _jax_ref(name, tree, batch):
    """JAX's loss and global gradients (port keys) on the case's mesh."""
    cfg, family, axes, _, opts = CASES[name]
    cls = JTransformer if family == "llama" else JGPT2
    jm = cls(JModelConfig(**CFGS[cfg]), tp_size=axes.get("tp", 1),
             cp_size=axes.get("cp", 1), ep_size=axes.get("ep", 1),
             pp_size=axes["pp"], cp_impl=opts.get("impl", "ring"),
             sequence_parallel=opts.get("sp", False),
             **{k: opts[k] for k in JAX_OPTS if k in opts})
    mesh = jmake_mesh(JMeshConfig(**axes))
    params = jax.device_put(jm.from_canonical(jax.tree.map(jnp.asarray,
                                                           tree)),
                            jm.shardings(mesh))
    loss, grads = jax.jit(jax.value_and_grad(jm.make_loss(mesh)))(params,
                                                                  *batch)
    grads = jm.to_canonical(jax.tree.map(np.asarray, grads))
    return float(loss), params_from_jax(grads)


def _job(name, tree, batch):
    cfg, _, axes, _, opts = CASES[name]
    run = dict(batch=batch, sp=opts.get("sp", False),
               impl=opts.get("impl", "ring"),
               **{k: opts[k] for k in JAX_OPTS if k in opts})
    return ("model_runs", axes, dict(cfg=CFGS[cfg], tree=tree, runs=[run]))


def _world(name):
    return int(np.prod(list(CASES[name][2].values())))


TINY_FLAGS = ["--model", "tiny", "--num_layers", "4", "--maxlen", "64",
              "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
              "--log_interval", "2", "--device", "cpu", "--dist_backend",
              "gloo"]


def _write_corpus(path, docs=40, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


def _cli(data, save, *flags):
    return train_cli.main(TINY_FLAGS + ["--data_path", data, "--save_dir",
                                        save] + list(flags))


RESUMES = (("pp1", ()), ("pp2", ()), ("pp1", ("--pp_size", "2")))


def _resume(data, d, src, flags, done):
    """A copy of the 4-step run `src`'s checkpoint dir, resumed to step 6
    with `flags`, once `done` (that run's future) is: (summary, the
    copy's reshard_event records)."""
    import shutil
    done.result()
    shutil.copytree(d[src], d[src, flags])
    out = _cli(data, d[src, flags], "--max_steps", "6", "--resume", *flags)
    with open(os.path.join(d[src, flags], "logs", "metrics.jsonl")) as f:
        events = [json.loads(x) for x in f if "reshard_event" in x]
    return out, events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two groups (2 and 4 ranks), its CLI runs and their
    resumes in the background, JAX's references meanwhile."""
    trees = {n: _tree(c[0], c[1]) for n, c in CASES.items()}
    batches = {n: _batch(c[3], seed=i) for i, (n, c) in
               enumerate(CASES.items())}
    two = [n for n in CASES if _world(n) == 2]
    four = [n for n in CASES if _world(n) == 4]
    root = tmp_path_factory.mktemp("pp_cli")
    data = str(root / "tokens.json")
    _write_corpus(data)
    d = {k: str(root / k) for k in ("pp1", "pp2", "pp2i")}
    d.update({(s, f): str(root / f"{s}_resumed{len(f)}") for s, f in RESUMES})
    with ThreadPoolExecutor(max_workers=5) as pool:
        g2 = pool.submit(launch.spawn, tp_checks.jobs, 2,
                         [_job(n, trees[n], batches[n]) for n in two])
        g4 = pool.submit(launch.spawn, tp_checks.jobs, 4,
                         [_job(n, trees[n], batches[n]) for n in four])
        cli = {k: pool.submit(_cli, data, d[k], "--max_steps", "4", *f)
               for k, f in (("pp1", ()), ("pp2", ("--pp_size", "2")),
                            ("pp2i", ("--pp_size", "2", "--pp_schedule",
                                      "interleaved", "--pp_microbatches",
                                      "2")))}
        resumed = {(s, f): pool.submit(_resume, data, d, s, f, cli[s])
                   for s, f in RESUMES}
        # JAX compiles with the GIL released: three at a time
        with ThreadPoolExecutor(max_workers=3) as jpool:
            refs = {n: jpool.submit(_jax_ref, n, trees[n], batches[n])
                    for n in CASES}
            refs = {n: f.result() for n, f in refs.items()}
        res2, res4 = g2.result(), g4.result()
        cli = {k: f.result() for k, f in cli.items()}
        resumed = {k: f.result() for k, f in resumed.items()}
    results = {**{n: [r[i] for r in res2] for i, n in enumerate(two)},
               **{n: [r[i] for r in res4] for i, n in enumerate(four)}}
    return dict(refs=refs, results=results, cli=cli, dirs=d, data=data,
                resumed=resumed)


# ---- (a) ----

@pytest.mark.parametrize("name", list(CASES))
def test_pp_loss_and_grads_match_jax(runs, name):
    loss, grads = runs["refs"][name]
    axes = CASES[name][2]
    for rank in runs["results"][name]:
        res = rank[0]
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
        c = res["coords"]
        want = shard_params(grads, axes.get("tp", 1), c["tp"],
                            axes.get("ep", 1), c["ep"])
        stage = pipeline.stage_layer_ids(
            CFGS[CASES[name][0]]["num_layers"], axes["pp"], c["pp"],
            CASES[name][4].get("pp_schedule", "gpipe"))
        assert {int(k.split(".")[1]) for k in res["grads"]
                if k.startswith("layers.")} == set(stage)
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {c} {k}")


def test_moe_cases_drop_choices(runs):
    for name in ("moe_pp2", "moe_pp2_ep2"):
        assert runs["results"][name][0][0]["moe"]["dropped_frac"] > 0


# ---- (b) ----

BAD_PP = [(4, 3, 0, "gpipe", 2), (4, 1, 2, "gpipe", 2), (4, 2, 1, "gpipe", 2),
          (4, 2, 0, "1f1b", 2), (4, 1, 0, "interleaved", 2),
          (4, 2, 0, "interleaved", 1), (6, 2, 0, "interleaved", 2),
          (8, 2, 3, "interleaved", 2)]


@pytest.mark.parametrize("args", BAD_PP)
def test_validate_pp_errors_are_jax_strings(args):
    with pytest.raises(ValueError) as theirs:
        jtf.validate_pp(*args)
    with pytest.raises(ValueError) as ours:
        pipeline.validate_pp(*args)
    assert str(ours.value) == str(theirs.value)


def test_mesh_coordinates_follow_the_jax_device_grid_with_pp():
    dp, pp, tp = 2, 2, 2
    jmesh = jmake_mesh(JMeshConfig(dp=dp, pp=pp, tp=tp))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(dp * pp * tp):
        c = coords(r, dp, 1, tp, pp=pp)
        assert ids[c["dp"], c["pp"], 0, 0, c["tp"]] == r
    assert axis_groups("pp", dp, 1, tp, pp=pp) == [[0, 2], [1, 3], [4, 6],
                                                   [5, 7]]
    # the batch axes keep pp out: one group per (pp, tp)
    assert axis_groups("batch", dp, 1, tp, pp=pp) == [[0, 4], [1, 5],
                                                      [2, 6], [3, 7]]


def test_stage_layers_and_canonical_maps():
    assert pipeline.stage_layer_ids(8, 2, 1) == [4, 5, 6, 7]
    # interleaved: blocks v*pp + p of Lv = L / (V*pp) layers
    assert pipeline.stage_layer_ids(8, 2, 1, "interleaved", 2) == [2, 3,
                                                                    6, 7]
    sd = {"layers.0.w": 0, "layers.1.w": 1, "norm.scale": 9}
    canon = pipeline.to_canonical(sd, [2, 6])
    assert canon == {"layers.2.w": 0, "layers.6.w": 1, "norm.scale": 9}
    full = dict(canon, **{"layers.3.w": 3})
    assert pipeline.from_canonical(full, [2, 6]) == sd


# ---- (c) ----

@pytest.mark.parametrize("run", ["pp2", "pp2i"])
def test_pp_cli_trajectory_equals_pp1(runs, run):
    ref, got = runs["cli"]["pp1"], runs["cli"][run]
    assert got["pp"] == 2 and len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    hops = got["ranks"][0]["hops_per_step"]["pp"]
    assert hops["calls"] > 0 and hops["bytes"] > 0 and hops["host_ms"] >= 0
    assert got["ranks"][0]["state_bytes"]["params"] < \
        ref["ranks"][0]["state_bytes"]["params"]


# ---- (d) ----

def test_pp_checkpoint_stamp_is_jaxs_and_jax_reads_it(runs):
    save = runs["dirs"]["pp2"]
    files = sorted(os.listdir(save))
    path = os.path.join(save, [f for f in files if f.endswith(".npz")][-1])
    with np.load(path) as z:
        stamp = str(z["__layout__"])
        layers = z["param/layers/wq/weight"]
    cfg = dict(dataclasses.asdict(model_preset("tiny")), num_layers=4,
               maxlen=64, vocab_size=1024, compute_dtype="float32")
    fields = {f.name for f in dataclasses.fields(JModelConfig)}
    jm = JTransformer(JModelConfig(**{k: v for k, v in cfg.items()
                                      if k in fields}), pp_size=2)
    want = jlayout.make_layout(jmake_mesh(JMeshConfig(pp=2)),
                               jm.canonical_specs())
    assert stamp == want.to_json()
    assert layers.shape[0] == 4          # every stage's layers, in order
    template = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    params, opt, step = jckpt.load_checkpoint(save, 4, template,
                                              jm.canonical_specs(),
                                              with_opt=True)
    assert step == 4 and opt is not None
    np.testing.assert_array_equal(params["layers"]["wq"]["weight"], layers)


def test_pp_checkpoint_resumes_across_pp(runs):
    """The pp 2 checkpoint resumed at pp 1 and the pp 1 one at pp 2 (both
    through the planner) continue as the pp 1 one resumed at pp 1."""
    for (src, flags), (out, events) in runs["resumed"].items():
        assert out["start_step"] == 4 and len(out["losses"]) == 2
        if (src == "pp1") == (not flags):
            assert out["reshard"] is None and not events  # the same layout
            continue
        assert out["reshard"]["bytes_moved"] == 0
        assert out["reshard"]["peak_host_bytes"] <= \
            out["reshard"]["max_leaf_bytes"]
        assert len(events) == 1 and events[0]["step"] == 4
    ref = runs["resumed"]["pp1", ()][0]["losses"]
    for key, (out, _) in runs["resumed"].items():
        np.testing.assert_allclose(out["losses"], ref, rtol=1e-5,
                                   err_msg=str(key))
