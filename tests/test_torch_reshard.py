"""The port's reshard planner and its streamed executors (host numpy, the
CPU) against the JAX package's `reshard`, on checkpoints JAX writes.

(a) for stamped sources at tp 1, 2 and 4, dp 2 at ZeRO 0 to 3 and pp 2,
    and the targets JAX's `tests/test_reshard.py` takes (tp 4 → 2 → 1, the
    ZeRO-3 training set → a tp 2 serving set, ZeRO 2 → 0) and more (pp 2,
    dp 2 x tp 2 at ZeRO 3), the port's `plan_checkpoint` equals JAX's leaf
    for leaf: the op, `moved_bytes` and every fragment;
(b) the port's `reshard_checkpoint` writes JAX's files: the same names,
    members, arrays and stamp string; the host peak stays within the
    largest leaf; a `.pth` rank span reshards through `interop` to JAX's
    files too;
(c) `stream_load` lands a dp 2 x tp 4 ZeRO-3 source (params and moments)
    on a one-rank model bit for bit, within the largest leaf of host
    memory;
(d) an inexpressible target, and a key the source layout does not know,
    raise `ReshardError`;
(e) the offline CLI prints one JSON record with the JAX CLI's keys;
(f) an elastic `train --resume` (tp 2 → dp 2 x tp 1 at ZeRO 2) continues
    within 1e-5 of the same-mesh resume and writes `reshard_event`
    (pp 2 → pp 1 is `tests/test_torch_pipeline.py`'s).
"""

import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu import interop as jinterop
from distributed_pytorch_from_scratch_tpu.config import (
    ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu import reshard as jreshard
from distributed_pytorch_from_scratch_tpu.training import checkpoint as jckpt
from distributed_pytorch_from_scratch_tpu.training.optim import (
    init_adam_state as jinit_adam)
from distributed_pytorch_from_scratch_tpu_torch import reshard
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import ModelConfig
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.reshard import (
    layout, reshard_ckpt)
from _torch_threads import two_torch_threads  # noqa: F401

CFG = dict(attn_dim=32, ffn_dim=64, num_heads=8, num_layers=2,
           vocab_size=64, maxlen=16)
QUIET = dict(echo=lambda *a: None)

# name: (tp, dp, pp, zero) of a source
SOURCES = {"tp1": (1, 1, 1, 0), "tp2": (2, 1, 1, 0), "tp4": (4, 1, 1, 0),
           "dp2_tp2_z1": (2, 2, 1, 1), "dp2_tp2_z2": (2, 2, 1, 2),
           "dp2_tp4_z3": (4, 2, 1, 3), "pp2": (1, 1, 2, 0),
           "pp2_tp2": (2, 1, 2, 0)}
# name: ((axis, size) pairs, zero, pp specs) of a target
TARGETS = {"tp1": ((("tp", 1),), 0, False), "tp2": ((("tp", 2),), 0, False),
           "dp2_tp2_z0": ((("dp", 2), ("tp", 2)), 0, False),
           "dp2_tp2_z3": ((("dp", 2), ("tp", 2)), 3, False),
           "pp2": ((("pp", 2),), 0, True)}
PAIRS = [(s, t) for s in SOURCES for t in TARGETS]


def _save_src(root, name, step=3, seed=0):
    """A stamped JAX source checkpoint with non-trivial moments; returns
    its dir and the JAX model."""
    tp, dp, pp, zero = SOURCES[name]
    d = str(root / f"src_{name}")
    if os.path.isdir(d):
        return d, JTransformer(JModelConfig(**CFG), tp_size=tp, pp_size=pp)
    model = JTransformer(JModelConfig(**CFG), tp_size=tp, pp_size=pp)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(seed)))
    opt = jinit_adam(params)
    opt = opt._replace(mu=jax.tree.map(lambda m: m + 0.25, opt.mu),
                       nu=jax.tree.map(lambda v: v + 0.5, opt.nu))
    jckpt.save_checkpoint(d, step, 1.0, params, model.specs(), tp_size=tp,
                          opt_state=opt, zero_stage=zero,
                          mesh_axes=(("dp", dp), ("pp", pp), ("tp", tp)))
    return d, model


def _targets(name):
    """(JAX Layout, the port's) of a target."""
    axes, zero, pp = TARGETS[name]
    jm = JTransformer(JModelConfig(**CFG), pp_size=2 if pp else 1)
    jl = jreshard.make_layout(axes, jm.canonical_specs(), zero_stage=zero)
    return jl, layout.Layout.from_json(jl.to_json())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("reshard")


# ---- (a) ----

@pytest.mark.parametrize("src,dst", PAIRS)
def test_plan_equals_jaxs_leaf_for_leaf(root, src, dst):
    d, _ = _save_src(root, src)
    jdst, pdst = _targets(dst)
    jplan, jsrc, jlegacy = jreshard.plan_checkpoint(d, 3, jdst, **QUIET)
    plan, psrc, legacy = reshard.plan_checkpoint(d, 3, pdst, **QUIET)
    assert (legacy, psrc.describe()) == (jlegacy, jsrc.describe())
    assert plan.summary() == jplan.summary()
    assert sorted(plan.leaves) == sorted(jplan.leaves)
    for key, jl in jplan.leaves.items():
        lp = plan.leaves[key]
        assert (lp.op, lp.moved_bytes, lp.shape) == (jl.op, jl.moved_bytes,
                                                    jl.shape), key
        assert {q: [tuple(dataclass_items(f)) for f in fl]
                for q, fl in lp.fragments.items()} == \
            {q: [tuple(dataclass_items(f)) for f in fl]
             for q, fl in jl.fragments.items()}, key


def dataclass_items(frag):
    return (frag.src_rank, frag.src_slice, frag.dst_slice, frag.nbytes)


# ---- (b) ----

def _members(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        ma, mb = _members(os.path.join(a, n)), _members(os.path.join(b, n))
        assert list(ma) == list(mb), n
        for k in ma:
            assert ma[k].dtype == mb[k].dtype, (n, k)
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=f"{n} {k}")


@pytest.mark.parametrize("src,dst", [("tp4", "tp2"), ("tp4", "tp1"),
                                     ("dp2_tp4_z3", "tp2"),
                                     ("dp2_tp2_z2", "dp2_tp2_z0"),
                                     ("pp2", "tp2"), ("tp2", "pp2")])
def test_reshard_checkpoint_writes_jaxs_files(root, tmp_path, src, dst):
    d, _ = _save_src(root, src)
    jdst, pdst = _targets(dst)
    jpaths, _, jinfo = jreshard.reshard_checkpoint(
        d, 3, str(tmp_path / "jax"), jdst, **QUIET)
    meter = reshard.HostMeter()
    paths, _, info = reshard.reshard_checkpoint(
        d, 3, str(tmp_path / "port"), pdst, meter=meter, **QUIET)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths]
    assert meter.peak <= info["max_leaf_bytes"] and meter.live == 0
    for k in ("src", "dst", "ops", "bytes_moved", "n_leaves",
              "max_leaf_bytes", "legacy", "peak_host_bytes"):
        assert info[k] == jinfo[k], k


def test_pth_span_reshards_through_interop(tmp_path):
    jm = JTransformer(JModelConfig(**CFG), tp_size=4)
    params = jm.init(jax.random.key(5))
    jinterop.export_reference_checkpoint(params, JModelConfig(**CFG), 4,
                                         str(tmp_path / "pth"), 7, loss=1.0)
    jdst, pdst = _targets("tp2")
    jreshard.reshard_checkpoint(
        str(tmp_path / "pth"), 7, str(tmp_path / "jax"), jdst,
        specs=jm.specs(), ext="pth", cfg=JModelConfig(**CFG), **QUIET)
    notes = []
    _, _, info = reshard.reshard_checkpoint(
        str(tmp_path / "pth"), 7, str(tmp_path / "port"), pdst,
        specs=pdst.specs, ext="pth", cfg=ModelConfig(**CFG),
        echo=lambda *a: notes.append(" ".join(map(str, a))))
    assert info["legacy"] is True
    assert any("not streamable" in n for n in notes)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


# ---- (c) ----

def test_stream_load_is_bit_identical_within_one_leaf(root):
    d, jm = _save_src(root, "dp2_tp4_z3")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    model = Transformer(ModelConfig(**CFG))
    _, dst = _targets("tp1")
    meter = reshard.HostMeter()
    sd, opt, step, info = reshard.stream_load(d, 3, model, dst,
                                              with_opt=True, meter=meter,
                                              **QUIET)
    assert step == 3 and opt is not None
    want = params_from_jax(tree)
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), k)
        assert float(opt.mu[k].min()) == float(opt.mu[k].max()) == 0.25
        assert float(opt.nu[k].min()) == float(opt.nu[k].max()) == 0.5
    assert meter.peak <= info["max_leaf_bytes"] and meter.live == 0
    assert info["ops"] == {"gather": 60}


# ---- (d) ----

def test_inexpressible_layouts_raise_reshard_error(root):
    d, _ = _save_src(root, "tp4")
    jm = JTransformer(JModelConfig(**CFG))
    bad = layout.Layout.from_json(jreshard.make_layout(
        (("tp", 3),), jm.canonical_specs()).to_json())
    with pytest.raises(reshard.ReshardError, match="inexpressible"):
        reshard.plan_checkpoint(d, 3, bad, **QUIET)
    src, _ = layout.resolve_source_layout(d, 3, **QUIET)
    with pytest.raises(reshard.ReshardError, match="no spec"):
        reshard.plan_reshard(["param/nope/weight"], {"param/nope/weight":
                                                     (4,)},
                             {"param/nope/weight": 4}, src, src)


# ---- (e) ----

def _jax_cli():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "scripts", "reshard_ckpt.py")
    spec = importlib.util.spec_from_file_location("jax_reshard_ckpt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan_only", [False, True])
def test_cli_record_has_jaxs_keys(root, tmp_path, capsys, plan_only):
    d, _ = _save_src(root, "pp2_tp2")
    argv = ["--src", d, "--tp", "1"] + (["--plan_only"] if plan_only
                                        else [])
    jrec = _jax_cli().main(argv + ["--dst", str(tmp_path / "jax")])
    rec = reshard_ckpt.main(argv + ["--dst", str(tmp_path / "port")])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == rec
    assert set(rec) == set(jrec)
    for k in ("metric", "value", "unit", "ops", "bytes_moved", "n_leaves",
              "max_leaf_bytes", "src", "dst", "iter"):
        assert rec[k] == jrec[k], k
    if not plan_only:
        _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
        assert rec["peak_host_bytes"] <= rec["max_leaf_bytes"]


# ---- (f) ----

FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
         "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
         "--log_interval", "2", "--device", "cpu", "--dist_backend", "gloo"]


def test_elastic_resume_tp2_to_dp2_zero2(tmp_path):
    rng = np.random.default_rng(0)
    train = [rng.integers(3, 1024, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=40)]
    data = str(tmp_path / "tokens.json")
    with open(data, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": 1024}, f)
    run = lambda d, *fl: train_cli.main(FLAGS + ["--data_path", data,
                                                 "--save_dir", d] + list(fl))
    src = str(tmp_path / "tp2")
    run(src, "--tp_size", "2", "--max_steps", "4")
    same, el = str(tmp_path / "same"), str(tmp_path / "elastic")
    shutil.copytree(src, same)
    shutil.copytree(src, el)
    ref = run(same, "--tp_size", "2", "--max_steps", "6", "--resume")
    out = run(el, "--dp_size", "2", "--zero", "2", "--max_steps", "6",
              "--resume")
    assert ref["reshard"] is None and out["start_step"] == 4
    assert out["reshard"]["src"] == "tp2 zero0"
    assert out["reshard"]["dst"] == "dp2 zero2"
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
    with open(os.path.join(el, "logs", "metrics.jsonl")) as f:
        events = [json.loads(x) for x in f if "reshard_event" in x]
    assert len(events) == 1 and events[0]["step"] == 4
    assert set(events[0]) >= {"src_layout", "dst_layout", "bytes_moved",
                              "plan_ops", "wall_ms", "peak_host_bytes"}
