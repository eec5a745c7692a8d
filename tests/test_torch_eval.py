"""The port's evaluation slice — `Transformer.doc_loss`, `evaluate.py`,
`generate.py`, `training/metrics.MetricsWriter` and the trainer's scalars
— against the JAX package on the same inputs and files, on the CPU, at
the tiny preset (d 128, 4 heads, 2 layers, the shipped tokenizer's vocab
1024) in float32.

(a) `doc_loss` within 1e-5 of JAX's `make_doc_loss` at (dp, cp, tp) in
    (1,1,1), (1,1,2), (2,1,1) and (1,2,1), contiguous and zig-zag, on a
    batch with ragged documents and an all-padding row (mask False);
(b) `evaluate.main` on two checkpoints (written by the port, read by
    both) against JAX `evaluate.main` on copies of the same files: val
    losses within 1e-5, the decoded pairs identical with the KV and the
    `--no_kv_cache` decoders, the same `val.txt` lines and `val/loss`
    scalars; the port at tp 2 (gloo ranks), at dp 2 and at cp 2
    (zig-zag) gives tp 1's losses and tokens;
(c) `generate.main` strings equal JAX's, at tp 1 and tp 2;
(d) each refusal raises and names its ROADMAP item (the JAX CLI's own
    refusals keep its messages); without `--device cpu` and with no card
    both CLIs exit non-zero;
(e) `MetricsWriter` records equal JAX's for the same calls (wall-time
    fields aside), rotation included;
(f) the port's train.py writes `train/ce_loss` and `train/lr` at every
    log step (one file per tp rank at tp 2).

The spawned groups (the port's tp 2 / dp 2 / cp 2 runs and the doc_loss
meshes) run in the background while JAX computes its references.
"""

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu import evaluate as jevaluate
from distributed_pytorch_from_scratch_tpu import generate as jgenerate
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training.metrics import (
    MetricsWriter as JMetricsWriter)
from distributed_pytorch_from_scratch_tpu_torch import (evaluate, generate,
                                                        train)
from distributed_pytorch_from_scratch_tpu_torch.config import ModelConfig
from distributed_pytorch_from_scratch_tpu_torch.interop import (
    params_from_jax)
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.runtime import (
    launch, tp_checks)
from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
    save_checkpoint)
from distributed_pytorch_from_scratch_tpu_torch.training.metrics import (
    MetricsWriter)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "tokenizer", "tokenizer.json")
TINY = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
            vocab_size=1024, maxlen=64)
MODEL = ["--model", "tiny", "--maxlen", "64", "--no-bf16"]
ITERS = (10, 20)
# 11 validation documents in batches of 4: the last batch is ragged
EVAL = ["--tokenizer_path", SHIPPED, "--batch_size", "4",
        "--max_decode_len", "32"] + MODEL
PROMPTS = ["Nice to meet you", "The brave man", "hello world"]

# doc_loss meshes: (dp, cp, tp), layout
MESHES = [((1, 1, 1), "contiguous"), ((1, 1, 2), "contiguous"),
          ((2, 1, 1), "contiguous"), ((1, 2, 1), "contiguous"),
          ((1, 2, 1), "zigzag"), ((1, 1, 1), "zigzag")]


def _tree(seed):
    jmodel = JTransformer(JModelConfig(**TINY))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))


def _doc_batch(seed=0, b=4, t=16):
    """(ids, targets, positions): ragged documents, the last row all
    padding (IGNORE_INDEX targets, zero ids)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1024, size=(b, t)).astype(np.int32)
    tgt = rng.integers(3, 1024, size=(b, t)).astype(np.int32)
    lens = [t, 5, 11, 0]
    for r, n in enumerate(lens):
        tgt[r, n:] = -1
    ids[3] = 0
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    return ids, tgt, pos


def _corpus(d):
    from tokenizers import Tokenizer
    tok = Tokenizer.from_file(SHIPPED)
    rng = np.random.default_rng(0)
    words = ("the king rode out at dawn with his men a quiet morning on "
             "the river bank Nice to meet you it's Great empire").split()
    texts = [" ".join(rng.choice(words, size=rng.integers(3, 20)))
             for _ in range(27)]
    path = d / "tokens.json"
    path.write_text(json.dumps({
        "train": [tok.encode(t).ids for t in texts[:16]],
        "validation": [tok.encode(t).ids for t in texts[16:]],
        "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
        "vocab_size": 1024}))
    return str(path)


def _ckpts(d):
    """Two checkpoints of random tiny models, in the port's writer."""
    src = d / "ckpt"
    for it, seed in zip(ITERS, (1, 2)):
        save_checkpoint(str(src), it, 5.0 + it / 100,
                        params_from_jax(_tree(seed)))
    return src


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _eval_port(args):
    return evaluate.evaluate(evaluate.get_eval_args(args))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    data = _corpus(d)
    src = _ckpts(d)
    base = lambda name: ["--data_path", data, "--ckpt_dir",
                         _copy(src, d / name)] + EVAL
    tree = _tree(0)
    batch = _doc_batch()
    todo = [("doc_losses", dict(zip(("dp", "cp", "tp"), axes)),
             dict(cfg=TINY, tree=tree, runs=[dict(layout=layout,
                                                  batch=batch)]))
            for axes, layout in MESHES if np.prod(axes) == 2]
    pool = ThreadPoolExecutor(max_workers=2)
    # the spawned groups start now and run while JAX computes
    bg = {
        "doc": pool.submit(launch.spawn, tp_checks.jobs, 2, todo),
        "tp2": pool.submit(_eval_port, base("port_tp2") + [
            "--device", "cpu", "--tp_size", "2", "--dist_backend", "gloo"]),
    }
    runs = {"data": data, "src": src, "dir": d, "tree": tree,
            "batch": batch, "todo": todo}
    for name, extra in (("kv", []), ("nokv", ["--no_kv_cache"])):
        runs[f"jax_{name}"] = jevaluate.evaluate(jevaluate.get_eval_args(
            base(f"jax_{name}") + extra))
        runs[f"port_{name}"] = _eval_port(base(f"port_{name}")
                                          + ["--device", "cpu"] + extra)
    bg["dp2"] = pool.submit(_eval_port, base("port_dp2") + [
        "--device", "cpu", "--dp_size", "2"])
    bg["cp2"] = pool.submit(_eval_port, base("port_cp2") + [
        "--device", "cpu", "--cp_size", "2", "--cp_layout", "zigzag"])
    runs["bg"] = bg
    yield runs
    pool.shutdown(wait=True)


# -- (a) doc_loss ----------------------------------------------------------

def _jax_doc_loss(tree, axes, layout, batch):
    dp, cp, tp = axes
    jmodel = JTransformer(JModelConfig(**TINY), tp_size=tp, cp_size=cp,
                          cp_layout=layout)
    mesh = jmake_mesh(JMeshConfig(dp=dp, cp=cp, tp=tp))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jmodel.shardings(mesh))
    means, real = jmodel.make_doc_loss(mesh)(
        params, *(jnp.asarray(x) for x in batch))
    return np.asarray(means), np.asarray(real)


@pytest.mark.parametrize("axes,layout", MESHES)
def test_doc_loss_matches_jax(setup, axes, layout):
    want_means, want_real = _jax_doc_loss(setup["tree"], axes, layout,
                                          setup["batch"])
    assert want_real.tolist() == [True, True, True, False]
    if np.prod(axes) == 1:
        import torch
        model = Transformer(ModelConfig(**TINY))
        model.load_state_dict(params_from_jax(setup["tree"]))
        means, real = model.doc_loss(*(torch.from_numpy(x).long()
                                       for x in setup["batch"]))
        got = [(means.numpy(), real.numpy())]
    else:
        i = [m for m in MESHES if np.prod(m[0]) == 2].index((axes, layout))
        ranks = setup["bg"]["doc"].result()
        res = [r[i][0] for r in ranks]
        # every rank returns its dp rows; concatenate dp in order, one
        # rank per dp index
        by_dp = {}
        for r in res:
            by_dp.setdefault(r["coords"]["dp"], []).append(r)
        for group in by_dp.values():   # every cp/tp rank agrees
            for r in group[1:]:
                np.testing.assert_allclose(r["means"], group[0]["means"],
                                           rtol=0, atol=1e-6)
        got = [(np.concatenate([by_dp[k][0]["means"] for k in sorted(by_dp)]),
                np.concatenate([by_dp[k][0]["real"] for k in sorted(by_dp)]))]
    for means, real in got:
        assert real.tolist() == want_real.tolist()
        assert means[3] == 0.0
        np.testing.assert_allclose(means, want_means, rtol=0, atol=1e-5)


# -- (b) evaluate.main -----------------------------------------------------

def _val_lines(run_dir):
    with open(os.path.join(run_dir, "val", "val.txt")) as f:
        return [ln.replace(run_dir, "<ckpt>") for ln in f.read().splitlines()]


def _scalars(run_dir):
    with open(os.path.join(run_dir, "val", "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"])
                for r in map(json.loads, f)]


@pytest.mark.parametrize("decoder", ["kv", "nokv"])
def test_evaluate_matches_jax(setup, decoder):
    ours, theirs = setup[f"port_{decoder}"], setup[f"jax_{decoder}"]
    assert sorted(ours["val_losses"]) == sorted(theirs["val_losses"]) \
        == list(ITERS)
    for it in ITERS:
        assert abs(ours["val_losses"][it] - theirs["val_losses"][it]) < 1e-5
    assert ours["decoded"] == [tuple(p) for p in theirs["decoded"]]
    assert any(c.strip() for _, c in ours["decoded"])
    d = str(setup["dir"])
    assert _val_lines(f"{d}/port_{decoder}") == \
        _val_lines(f"{d}/jax_{decoder}")
    for (t1, s1, v1), (t2, s2, v2) in zip(_scalars(f"{d}/port_{decoder}"),
                                          _scalars(f"{d}/jax_{decoder}")):
        assert (t1, s1) == (t2, s2) == ("val/loss", s1)
        assert abs(v1 - v2) < 1e-5


def test_kv_and_full_recompute_decoders_agree(setup):
    kv, nokv = setup["port_kv"], setup["port_nokv"]
    assert kv["decoded"] == nokv["decoded"]
    assert kv["generated_ids"] == nokv["generated_ids"]
    assert nokv["forwards"] >= sum(map(len, nokv["generated_ids"]))
    assert kv["prefill_dispatches"] >= 1


@pytest.mark.parametrize("mesh", ["tp2", "dp2", "cp2"])
def test_evaluate_on_a_mesh_gives_tp1(setup, mesh):
    out = setup["bg"][mesh].result()
    ref = setup["port_kv"]
    for it in ITERS:
        assert abs(out["val_losses"][it] - ref["val_losses"][it]) < 1e-5
    assert out["decoded"] == ref["decoded"]
    assert out["generated_ids"] == ref["generated_ids"]
    assert len(out["ranks"]) == 2


# -- (c) generate.main -----------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2])
def test_generate_matches_jax(setup, tp):
    args = ["--ckpt_dir", str(setup["src"]), "-t", SHIPPED,
            "--max_new_tokens", "12"] + MODEL
    for p in PROMPTS:
        args += ["--prompt", p]
    theirs = jgenerate.main(args)
    ours = generate.main(args + ["--device", "cpu", "--tp_size", str(tp)])
    assert ours == theirs
    assert all(o.startswith(p) for o, p in zip(ours, PROMPTS))


# -- (d) refusals ----------------------------------------------------------

@pytest.mark.parametrize("extra,item", [
    (["--num_experts", "4"], "item 7"),
    (["--num_processes", "2"], "item 2"),
    (["--cp_size", "2"], "item 6"),
    (["--coordinator", "host:1234"], "item 2"),
])
def test_evaluate_refusals_name_their_item(setup, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        _eval_port(["--data_path", setup["data"], "--ckpt_dir",
                    str(setup["src"]), "--device", "cpu"] + EVAL + extra)


def test_evaluate_keeps_jax_refusals(setup):
    base = ["--data_path", setup["data"], "--ckpt_dir", str(setup["src"])]
    args = base + EVAL + ["--cp_size", "2", "--cp_impl", "ulysses"]
    with pytest.raises(SystemExit) as ours:
        _eval_port(args + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jevaluate.evaluate(jevaluate.get_eval_args(args))
    assert str(ours.value) == str(theirs.value)
    for bad in (["--temperature", "0.5", "--no_kv_cache"],
                ["--decode_top_k", "5"], ["--decode_top_p", "2"]):
        with pytest.raises(SystemExit):
            evaluate.get_eval_args(base + EVAL + bad)


@pytest.mark.parametrize("extra,item", [
    (["--cp_size", "2"], "item 6"),
    (["--num_experts", "4"], "item 7"),
    (["--family", "gpt2", "--num_experts", "4"], "item 7"),
])
def test_generate_refusals_name_their_item(setup, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        generate.main(["--ckpt_dir", str(setup["src"]), "-t", SHIPPED,
                       "--prompt", "hi", "--device", "cpu"] + MODEL + extra)


def test_clis_without_a_card_exit_nonzero(setup):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="no CUDA card"):
        _eval_port(["--data_path", setup["data"], "--ckpt_dir",
                    str(setup["src"])] + EVAL)
    with pytest.raises(SystemExit, match="no CUDA card"):
        generate.main(["--ckpt_dir", str(setup["src"]), "-t", SHIPPED,
                       "--prompt", "hi"] + MODEL)


# -- (e) MetricsWriter -----------------------------------------------------

def _records(log_dir):
    out = {}
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(log_dir, name)) as f:
                out[name] = [{k: v for k, v in json.loads(ln).items()
                              if k != "ts"} for ln in f]
    return out


@pytest.mark.parametrize("process_index,max_bytes", [(0, 0), (3, 200)])
def test_metrics_writer_records_equal_jax(tmp_path, process_index,
                                          max_bytes):
    def calls(w):
        for step in range(6):
            w.scalar("train/ce_loss", 5.0 - step * 0.25, step)
            w.scalar("train/lr", 1e-3 * step, step)
        w.text("note", "hello", 2)
        w.event("goodput", step=5, useful=0.5, buckets={"a": 1})
        w.event("plain")
        w.close()
        w.scalar("after/close", 1.0, 9)   # dropped after close

    with MetricsWriter(str(tmp_path / "ours"), process_index, max_bytes) as w:
        calls(w)
    with JMetricsWriter(str(tmp_path / "theirs"), process_index,
                        max_bytes) as w:
        calls(w)
    ours, theirs = _records(tmp_path / "ours"), _records(tmp_path / "theirs")
    assert ours == theirs
    first = ("metrics.jsonl" if process_index == 0
             else f"metrics.proc{process_index}.jsonl")
    assert first in ours
    assert (len(ours) > 1) == bool(max_bytes)


# -- (f) the trainer's scalars ---------------------------------------------

@pytest.mark.parametrize("tp", [1, 2])
def test_train_writes_scalars_every_log_step(setup, tmp_path, tp):
    save = tmp_path / "ck"
    out = train.train(train.get_train_args(
        ["--device", "cpu", "--batch_size", "4", "--max_steps", "6",
         "--log_interval", "2", "--save_interval", "100", "--warmup_steps",
         "2", "--data_path", setup["data"], "--save_dir", str(save),
         "--tp_size", str(tp), "--model", "tiny", "--maxlen", "64"]))
    files = sorted(os.listdir(save / "logs"))
    assert [f for f in files if f.endswith(".jsonl")] == (
        ["metrics.jsonl"] if tp == 1 else
        ["metrics.jsonl", "metrics.proc1.jsonl"])
    recs = _records(save / "logs")["metrics.jsonl"]
    for tag in ("train/ce_loss", "train/lr", "train/tokens_per_sec",
                "train/useful_token_frac", "train/grad_norm"):
        assert [r["step"] for r in recs if r["tag"] == tag] == [2, 4, 6], tag
    ce = [r["value"] for r in recs if r["tag"] == "train/ce_loss"]
    losses = out["losses"]
    for r, step in zip(ce, (2, 4, 6)):
        assert abs(r - sum(losses[:step]) / step) < 1e-5
    # no card: no MFU or memory scalar (no fake number)
    assert not [r for r in recs if r["tag"] in ("train/mfu",
                                                "device_memory_gib")]
