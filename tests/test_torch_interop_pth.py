"""The port's bridge to the source repo's per-rank `.pth` checkpoints
(`interop.py`) against the JAX package's, on the same state dicts, on the
CPU — the cases of tests/test_interop_ckpt.py, each held against the JAX
function:

(a) `convert_state_dicts` at tp 1, 2 and 4 gives JAX's arrays bit for bit
    (and the ground truth the shards were cut from), the same tree at any
    tp; a padded-vocab import pads as JAX does and loads at tp 4;
(b) `export_state_dicts` inverts the import (at the same and at another
    tp), drops the vocab padding, and equals JAX's export bit for bit;
(c) the refusals — GQA, MoE, a vocab or width the export tp does not
    divide, understated or overstated flags, a missing rank file — raise
    JAX's messages;
(d) both CLI directions round-trip, and each package reads what the
    other's CLI wrote;
(e) an imported checkpoint drives the port's model to the JAX model's
    logits within 1e-5 (f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu import interop as jinterop
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import (
    checkpoint as jcheckpoint)
from distributed_pytorch_from_scratch_tpu_torch import interop
from distributed_pytorch_from_scratch_tpu_torch.config import ModelConfig
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
    load_checkpoint, save_checkpoint)
from _torch_threads import two_torch_threads  # noqa: F401


SHAPE = dict(attn_dim=32, ffn_dim=64, num_heads=4, num_layers=2,
             vocab_size=96, maxlen=64)
CFG = ModelConfig(**SHAPE)
JCFG = JModelConfig(**SHAPE)
FLAGS = ["--attn_dim", "32", "--ffn_dim", "64", "--num_heads", "4",
         "--num_layers", "2", "--vocab_size", "96", "--maxlen", "64"]


def full_tensors(cfg, seed):
    """Global tensors under the source repo's key names, torch layout."""
    rng = np.random.default_rng(seed)
    d, f, V = cfg.attn_dim, cfg.ffn_dim, cfg.vocab_size
    t = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    full = {"embedding.weight": t(V, d), "norm.scale": t(d),
            "lm_head.weight": t(V, d), "lm_head.bias": t(V)}
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        for name in ("wq", "wk", "wv", "wo"):
            full[f"{p}.attn.{name}.weight"] = t(d, d)
            full[f"{p}.attn.{name}.bias"] = t(d)
        for name in ("gate_proj", "up_proj"):
            full[f"{p}.ffn.{name}.weight"] = t(f, d)
            full[f"{p}.ffn.{name}.bias"] = t(f)
        full[f"{p}.ffn.down_proj.weight"] = t(d, f)
        full[f"{p}.ffn.down_proj.bias"] = t(d)
        full[f"{p}.norm1.scale"] = t(d)
        full[f"{p}.norm2.scale"] = t(d)
    return full


def shard_reference(full, tp):
    """Per-rank state dicts as the source repo's parallel layers hold
    them: vocab and column shards on dim 0, row shards on dim 1 (bias
    replicated), norms replicated."""
    shards = []
    for r in range(tp):
        s = {}
        for k, v in full.items():
            if k == "embedding.weight" or k.startswith("lm_head"):
                s[k] = np.split(v, tp, axis=0)[r]
            elif k.endswith("scale"):
                s[k] = v
            elif ".wo." in k or ".down_proj." in k:
                s[k] = np.split(v, tp, axis=1)[r] if k.endswith("weight") else v
            else:
                s[k] = np.split(v, tp, axis=0)[r]
        shards.append(s)
    return shards


def _leaves(tree):
    return [(p, np.asarray(a)) for p, a in interop._walk(tree)]


def assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


def _save_pth(shards, directory, step=500, loss="3.1400"):
    directory.mkdir(parents=True, exist_ok=True)
    for r, sd in enumerate(shards):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   directory / f"tprank-{r}_iter-{step}_loss-{loss}.pth")


# -- (a) import ---------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4])
def test_convert_equals_jax_bit_for_bit(tp):
    full = full_tensors(CFG, tp)
    shards = shard_reference(full, tp)
    ours = interop.convert_state_dicts(shards, CFG)
    assert_trees_equal(ours, jinterop.convert_state_dicts(shards, JCFG))
    np.testing.assert_array_equal(ours["embedding"]["weight"],
                                  full["embedding.weight"])
    np.testing.assert_array_equal(ours["lm_head"]["weight"],
                                  full["lm_head.weight"].T)
    for i in range(CFG.num_layers):
        np.testing.assert_array_equal(ours["layers"]["wq"]["weight"][i],
                                      full[f"layers.{i}.attn.wq.weight"].T)
        np.testing.assert_array_equal(
            ours["layers"]["down_proj"]["weight"][i],
            full[f"layers.{i}.ffn.down_proj.weight"].T)
    # the same tree from any tp
    assert_trees_equal(ours, interop.convert_state_dicts(
        shard_reference(full, 1), CFG))


def test_padded_vocab_import(tmp_path):
    """vocab 90 padded to a multiple of 4 (92 rows, 2 of them zero), as
    JAX pads, and the checkpoint the CLI writes loads at tp 4 and tp 2."""
    cfg = dataclasses.replace(CFG, vocab_size=90, num_layers=1)
    jcfg = dataclasses.replace(JCFG, vocab_size=90, num_layers=1)
    full = full_tensors(cfg, 2)
    shards = shard_reference(full, 2)
    ours = interop.convert_state_dicts(shards, cfg, pad_vocab_multiple=4)
    assert_trees_equal(ours, jinterop.convert_state_dicts(
        shards, jcfg, pad_vocab_multiple=4))
    assert ours["embedding"]["weight"].shape == (92, 32)
    assert ours["lm_head"]["weight"].shape == (32, 92)
    assert (ours["embedding"]["weight"][90:] == 0).all()
    assert (ours["lm_head"]["bias"][90:] == 0).all()

    _save_pth(shards, tmp_path / "ref")
    interop.main(["--ref_ckpt_dir", str(tmp_path / "ref"), "--out_dir",
                  str(tmp_path / "ours"), "--attn_dim", "32", "--ffn_dim",
                  "64", "--num_heads", "4", "--num_layers", "1",
                  "--vocab_size", "90", "--maxlen", "64",
                  "--pad_vocab_multiple", "4"])
    for tp in (4, 2):
        parts = [load_checkpoint(str(tmp_path / "ours"), 500, tp_size=tp,
                                 tp_rank=r)[0] for r in range(tp)]
        assert parts[0]["embedding.weight"].shape == (92 // tp, 32)
        emb = torch.cat([p["embedding.weight"] for p in parts]).numpy()
        np.testing.assert_array_equal(emb, ours["embedding"]["weight"])


# -- (b) export ---------------------------------------------------------------

@pytest.mark.parametrize("tp_in,tp_out", [(2, 2), (2, 4), (4, 1)])
def test_export_inverts_import_and_equals_jax(tp_in, tp_out):
    full = full_tensors(CFG, 6)
    orig = shard_reference(full, tp_in)
    params = interop.convert_state_dicts(orig, CFG)
    again = interop.export_state_dicts(params, CFG, tp_out)
    theirs = jinterop.export_state_dicts(params, JCFG, tp_out)
    want = shard_reference(full, tp_out)
    assert [set(s) for s in again] == [set(s) for s in want]
    for a, t, w in zip(again, theirs, want):
        for k in w:
            np.testing.assert_array_equal(a[k], t[k], err_msg=k)
            np.testing.assert_array_equal(a[k], w[k], err_msg=k)


def test_export_drops_vocab_padding():
    cfg = dataclasses.replace(CFG, vocab_size=90, num_layers=1)
    jcfg = dataclasses.replace(JCFG, vocab_size=90, num_layers=1)
    full = full_tensors(cfg, 7)
    params = interop.convert_state_dicts(shard_reference(full, 2), cfg,
                                         pad_vocab_multiple=4)
    out = interop.export_state_dicts(params, cfg, 1)[0]
    theirs = jinterop.export_state_dicts(params, jcfg, 1)[0]
    assert out["embedding.weight"].shape == (90, 32)
    assert out["lm_head.bias"].shape == (90,)
    for k in out:
        np.testing.assert_array_equal(out[k], theirs[k], err_msg=k)
    np.testing.assert_array_equal(out["lm_head.weight"],
                                  full["lm_head.weight"])


# -- (c) refusals --------------------------------------------------------------

def _same_refusal(ours_fn, theirs_fn, match):
    with pytest.raises(ValueError, match=match) as ours:
        ours_fn()
    with pytest.raises(ValueError) as theirs:
        theirs_fn()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["moe", "gqa", "vocab_tp", "heads_tp",
                                  "tp0"])
def test_export_refusals_match_jax(case):
    params = interop.convert_state_dicts(
        shard_reference(full_tensors(CFG, 8), 1), CFG)
    kw, tp, match = {
        "moe": (dict(num_experts=4), 1, "MoE"),
        "gqa": (dict(num_kv_heads=2), 1, "GQA"),
        "vocab_tp": (dict(vocab_size=90), 4, "vocab_size"),
        "heads_tp": (dict(), 8, "must divide"),
        "tp0": (dict(), 0, ">= 1"),
    }[case]
    _same_refusal(
        lambda: interop.export_state_dicts(
            params, dataclasses.replace(CFG, **kw), tp),
        lambda: jinterop.export_state_dicts(
            params, dataclasses.replace(JCFG, **kw), tp), match)


@pytest.mark.parametrize("case", ["small_vocab", "big_vocab", "few_layers"])
def test_export_refuses_understated_flags_as_jax(case):
    params = interop.convert_state_dicts(
        shard_reference(full_tensors(CFG, 9), 1), CFG)
    kw, match = {"small_vocab": (dict(vocab_size=32), "drop"),
                 "big_vocab": (dict(vocab_size=128), "overstates"),
                 "few_layers": (dict(num_layers=1), "does not match")}[case]
    _same_refusal(
        lambda: interop.export_state_dicts(
            params, dataclasses.replace(CFG, **kw), 1),
        lambda: jinterop.export_state_dicts(
            params, dataclasses.replace(JCFG, **kw), 1), match)


@pytest.mark.parametrize("vocab", [128, 64])
def test_import_refuses_mismatched_vocab_as_jax(vocab):
    shards = shard_reference(full_tensors(CFG, 10), 2)
    _same_refusal(
        lambda: interop.convert_state_dicts(
            shards, dataclasses.replace(CFG, vocab_size=vocab)),
        lambda: jinterop.convert_state_dicts(
            shards, dataclasses.replace(JCFG, vocab_size=vocab)),
        "flags match")


def test_missing_rank_file_refused_as_jax(tmp_path):
    _save_pth(shard_reference(full_tensors(CFG, 11), 4), tmp_path)
    (tmp_path / "tprank-1_iter-500_loss-3.1400.pth").unlink()
    with pytest.raises(FileNotFoundError, match=r"rank\(s\) \[1\]") as ours:
        interop.find_reference_shards(str(tmp_path), 500)
    with pytest.raises(FileNotFoundError) as theirs:
        jinterop.find_reference_shards(str(tmp_path), 500)
    assert str(ours.value) == str(theirs.value)
    assert interop.reference_iters(str(tmp_path)) == \
        jinterop.reference_iters(str(tmp_path)) == [500]


# -- (d) the CLI, both directions -----------------------------------------------

def test_cli_import_roundtrip(tmp_path):
    """.pth rank files -> the port's CLI -> an npz checkpoint that the JAX
    loader and the port's loader read as the direct conversion."""
    full = full_tensors(CFG, 4)
    _save_pth(shard_reference(full, 2), tmp_path / "ref")
    interop.main(["--ref_ckpt_dir", str(tmp_path / "ref"), "--out_dir",
                  str(tmp_path / "ours")] + FLAGS)
    direct = jinterop.load_reference_checkpoint(str(tmp_path / "ref"), 500,
                                                JCFG)
    assert_trees_equal(interop.load_reference_checkpoint(
        str(tmp_path / "ref"), 500, CFG), direct)
    jmodel = JTransformer(JCFG)
    loaded, _, step = jcheckpoint.load_checkpoint(
        str(tmp_path / "ours"), 500, jmodel.init(jax.random.key(0)),
        jmodel.specs())
    assert step == 500
    assert_trees_equal(jax.tree.map(np.asarray, loaded), direct)
    state, _, _ = load_checkpoint(str(tmp_path / "ours"), 500)
    assert_trees_equal(interop.params_to_jax(state), direct)


def test_cli_export_roundtrip(tmp_path):
    """A checkpoint the port trained (its save_checkpoint) -> the port's
    CLI at --export_tp 2 -> .pth files the JAX importer reads back to the
    same tree; the loss in the file name carries over."""
    model = Transformer(CFG).init_weights(3)
    save_checkpoint(str(tmp_path / "ours"), 7, 1.23, model.state_dict())
    interop.main(["--direction", "export", "--our_ckpt_dir",
                  str(tmp_path / "ours"), "--out_dir", str(tmp_path / "ref"),
                  "--export_tp", "2"] + FLAGS)
    pths = sorted((tmp_path / "ref").glob("tprank-*_iter-7_loss-*.pth"))
    assert len(pths) == 2 and all("loss-1.2300" in p.name for p in pths)
    back = jinterop.load_reference_checkpoint(str(tmp_path / "ref"), 7, JCFG)
    assert_trees_equal(back, interop.params_to_jax(model.state_dict()))
    # the JAX CLI exports the same files from the same checkpoint
    jinterop.main(["--direction", "export", "--our_ckpt_dir",
                   str(tmp_path / "ours"), "--out_dir",
                   str(tmp_path / "jref"), "--export_tp", "2"] + FLAGS)
    for p in pths:
        a = torch.load(p, weights_only=True)
        b = torch.load(tmp_path / "jref" / p.name, weights_only=True)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


# -- (e) the imported weights drive the model -----------------------------------

def test_imported_pth_drives_the_model_like_jax(tmp_path):
    full = full_tensors(CFG, 12)
    # keep the logits in a range where 1e-5 is meaningful
    full = {k: v * (0.2 if k.endswith("weight") else 1.0)
            for k, v in full.items()}
    _save_pth(shard_reference(full, 2), tmp_path / "ref")
    interop.main(["--ref_ckpt_dir", str(tmp_path / "ref"), "--out_dir",
                  str(tmp_path / "ours")] + FLAGS)
    state, _, _ = load_checkpoint(str(tmp_path / "ours"), 500)
    model = Transformer(CFG)
    model.load_state_dict(state)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG.vocab_size, size=(2, 16))
    pos = np.tile(np.arange(16), (2, 1))
    with torch.no_grad():
        ours = model.forward(torch.from_numpy(ids),
                             torch.from_numpy(pos)).numpy()
    tree = jinterop.load_reference_checkpoint(str(tmp_path / "ref"), 500,
                                              JCFG)
    jmodel = JTransformer(JCFG)
    theirs = np.asarray(jmodel.make_forward(jmake_mesh(JMeshConfig()))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(pos)))
    assert ours.shape == theirs.shape == (2, 16, 96)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(theirs).max()))
