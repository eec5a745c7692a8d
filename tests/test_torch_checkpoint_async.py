"""The port's checkpoint writer: the asynchronous write and the
`__layout__` stamp, against the JAX package's, at the tiny preset in
float32.

* An asynchronous save writes the members of a synchronous one, array for
  array and dtype for dtype.
* The snapshot is the state at the call: an in-place optimizer step right
  after it does not reach the file.
* The stamp is the string the JAX `make_layout(mesh,
  model.canonical_specs()).to_json()` gives at (dp, cp, tp) in (1,1,1),
  (1,1,2), (2,1,2), (1,2,1) for llama and (1,1,2) for gpt2, the same in
  every rank file; the JAX `read_stamp` + `layouts_equal` accept it, and
  `resolve_source_layout` returns it as no legacy layout.
* The JAX trainer resumes a stamped port checkpoint with no legacy note,
  the port's trainer resumes a stamped JAX one, an unstamped file and a
  pp-stamped one load, and a layout on an axis no mesh has is refused by
  name.
"""

import numpy as np
import pytest
import torch
import jax

from distributed_pytorch_from_scratch_tpu import train as jtrain
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.reshard import layout as jlayout
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import (
    checkpoint as jckpt, optim as joptim)
from distributed_pytorch_from_scratch_tpu_torch import train as train_cli
from distributed_pytorch_from_scratch_tpu_torch.config import (
    ModelConfig, OptimizerConfig, model_preset)
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
    shard_params)
from distributed_pytorch_from_scratch_tpu_torch.reshard import layout
from distributed_pytorch_from_scratch_tpu_torch.training import checkpoint
from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
    AdamState, adam_update)
from _torch_threads import two_torch_threads  # noqa: F401


TINY = {k: getattr(model_preset("tiny"), k)
        for k in ("attn_dim", "ffn_dim", "num_heads", "num_layers",
                  "vocab_size", "maxlen")}
FLAGS = ["--model", "tiny", "--num_kv_heads", "2", "--maxlen", "64",
         "--batch_size", "4", "--warmup_steps", "2", "--lr", "1e-3",
         "--log_interval", "1"]


def _write_corpus(path, docs=40, vocab=1024, seed=0):
    import json
    rng = np.random.default_rng(seed)
    train = [rng.integers(3, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 60, size=docs)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:4],
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


def _state(family="llama", seed=0):
    """A tiny model's state dict and an Adam state with random moments."""
    model = build_model(family, ModelConfig(**TINY)).init_weights(seed)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    moment = lambda: {k: torch.randn(v.shape, generator=g)
                      for k, v in sd.items()}
    return sd, AdamState(step=5, mu=moment(), nu=moment())


def _members(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_async_write_holds_the_sync_members(tmp_path):
    sd, st = _state()
    sync = checkpoint.save_checkpoint(str(tmp_path / "sync"), 5, 2.5, sd, st)
    handle = checkpoint.save_checkpoint(str(tmp_path / "async"), 5, 2.5, sd,
                                        st, async_write=True)
    assert isinstance(handle, checkpoint.AsyncSaveHandle)
    assert handle.step == 5
    paths = handle.join()
    assert [p.split("/")[-1] for p in paths] == [
        p.split("/")[-1] for p in sync]
    a, b = _members(sync[0]), _members(paths[0])
    assert sorted(a) == sorted(b)
    assert layout.LAYOUT_KEY in a
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # no temporary file is left behind
    assert not list((tmp_path / "async").glob("*.tmp"))


def test_snapshot_survives_the_next_step(tmp_path):
    sd, st = _state(seed=1)
    params = {k: v.clone() for k, v in sd.items()}
    mu = {k: v.clone() for k, v in st.mu.items()}
    handle = checkpoint.save_checkpoint(str(tmp_path), 5, 2.5, params, st,
                                        async_write=True)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    st2 = adam_update(OptimizerConfig(lr=1e-2, warmup_steps=1), params,
                      grads, st)          # in place, as the train loop's
    assert not torch.equal(params["embedding.weight"],
                           sd["embedding.weight"])
    assert handle.join()
    got, got_st, step = checkpoint.load_checkpoint(str(tmp_path), 5,
                                                   with_opt=True)
    assert step == 5 and got_st.step == 5
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got_st.mu[k], mu[k]), k
    assert st2.step == 6 and not torch.equal(st.mu["norm.scale"],
                                             mu["norm.scale"])


MESHES = [("llama", 1, 1, 1), ("llama", 1, 1, 2), ("llama", 2, 1, 2),
          ("llama", 1, 2, 1), ("gpt2", 1, 1, 2)]


@pytest.mark.parametrize("family,dp,cp,tp", MESHES)
def test_stamp_is_the_jax_trainers(tmp_path, family, dp, cp, tp):
    sd, st = _state(family)
    axes = (("dp", dp), ("cp", cp), ("tp", tp))
    for r in range(tp):
        checkpoint.save_checkpoint(
            str(tmp_path), 3, 1.5, shard_params(sd, tp, r),
            AdamState(step=3, mu=shard_params(st.mu, tp, r),
                      nu=shard_params(st.nu, tp, r)),
            tp_size=tp, tp_rank=r, mesh_axes=axes)
    stamps = [str(_members(p)[layout.LAYOUT_KEY])
              for p in sorted(map(str, tmp_path.glob("tprank-*.npz")))]
    assert len(stamps) == tp and len(set(stamps)) == 1
    jcls = JGPT2 if family == "gpt2" else JTransformer
    jmodel = jcls(JModelConfig(**TINY), tp_size=tp, cp_size=cp)
    mesh = jmake_mesh(JMeshConfig(dp=dp, cp=cp, tp=tp))
    want = jlayout.make_layout(mesh, jmodel.canonical_specs())
    assert stamps[0] == want.to_json()
    with np.load(str(next(tmp_path.glob("tprank-0_*.npz")))) as z:
        assert jlayout.layouts_equal(jlayout.read_stamp(z), want)
    notes = []
    got, legacy = jlayout.resolve_source_layout(str(tmp_path), 3,
                                                echo=notes.append)
    assert not legacy and not notes and jlayout.layouts_equal(got, want)
    # the port's own reader: the same layout, and the state loads
    assert layout.Layout.from_json(stamps[0]).signature() == \
        layout.make_layout(axes, layout.canonical_specs(
            {k: v.shape for k, v in sd.items()})).signature()
    back, back_st, _ = checkpoint.load_checkpoint(str(tmp_path), 3,
                                                  with_opt=True)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    assert all(torch.equal(back_st.nu[k], v) for k, v in st.nu.items())


def test_jax_trainer_resumes_a_port_checkpoint(tmp_path, capsys):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    save = str(tmp_path / "ck")
    out = train_cli.main(FLAGS + ["--device", "cpu", "--data_path", data,
                                  "--save_dir", save, "--max_steps", "2"])
    assert out["checkpoints"] and not out["shutdown"]
    capsys.readouterr()
    res = jtrain.train(jtrain.get_train_args(
        FLAGS + ["--data_path", data, "--save_dir", save, "--max_steps", "3",
                 "--resume"]))
    printed = capsys.readouterr().out
    assert "resumed from iter 2" in printed
    assert "legacy" not in printed
    assert res["steps"] == 3


def test_port_resumes_a_stamped_jax_checkpoint(tmp_path, capsys):
    data = str(tmp_path / "tokens.json")
    _write_corpus(data)
    jmodel = JTransformer(JModelConfig(**dict(TINY, num_kv_heads=2,
                                              maxlen=64)), tp_size=1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(5)))
    jst = joptim.init_adam_state(params)
    jst = joptim.AdamState(step=np.int32(3), mu=jst.mu, nu=jst.nu)
    mesh = jmake_mesh(JMeshConfig())
    jckpt.save_checkpoint(str(tmp_path), 3, 6.5, params, jmodel.specs(), 1,
                          jst, mesh_axes=mesh)
    with np.load(str(next(tmp_path.glob("tprank-0_*.npz")))) as z:
        assert jlayout.read_stamp(z) is not None
    out = train_cli.main(FLAGS + ["--device", "cpu", "--data_path", data,
                                  "--save_dir", str(tmp_path), "--max_steps",
                                  "4", "--resume"])
    assert out["start_step"] == 3 and out["steps"] == 4
    assert np.isfinite(out["losses"]).all()


def test_reader_takes_unstamped_and_refuses_other_axes(tmp_path):
    sd, st = _state()
    path = checkpoint.save_checkpoint(str(tmp_path / "old"), 2, 1.0, sd)[0]
    members = _members(path)
    del members[layout.LAYOUT_KEY]            # a file from before the stamp
    np.savez(path, **members)
    back, _, step = checkpoint.load_checkpoint(str(tmp_path / "old"), 2)
    assert step == 2 and all(torch.equal(back[k], v) for k, v in sd.items())
    # a pp-stamped file reads as any other: the files hold every layer
    checkpoint.save_checkpoint(str(tmp_path / "pp"), 2, 1.0, sd,
                               mesh_axes=(("pp", 2), ("tp", 1)))
    back, _, step = checkpoint.load_checkpoint(str(tmp_path / "pp"), 2)
    assert step == 2 and all(torch.equal(back[k], v) for k, v in sd.items())
    stamped = layout.read_stamp(_members(next(
        (tmp_path / "pp").glob("tprank-0_*.npz"))))
    assert stamped.describe() == "pp2 zero0"
    assert stamped.specs["param/layers/wq/weight"][0] == "pp"
    # an axis no mesh has is still refused by name
    bad = layout.Layout(mesh_axes=(("xp", 2),), specs={})
    with pytest.raises(ValueError, match="runs the axes"):
        checkpoint.check_layout(bad, str(tmp_path), 2)
