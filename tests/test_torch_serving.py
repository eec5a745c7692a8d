"""The port's slot-engine serving path (PyTorch) against the JAX package's.

* The same `synthetic_requests(seed)` through the JAX
  `ContinuousBatchingEngine` and the port's, on the same weights (f32,
  CPU), give identical greedy tokens per request and identical stats.
* The port engine with 1 slot equals the port engine with 4 slots.
* `serve.main` runs on the CPU only when asked (`--device cpu`); without a
  card and without that flag it exits non-zero with a message.
* A tp=1 checkpoint written by the JAX trainer serves through the port's
  CLI with the JAX engine's tokens; a tp=2 checkpoint is refused.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving.engine import (
    ContinuousBatchingEngine as JEngine)
from distributed_pytorch_from_scratch_tpu.serving.loadgen import (
    synthetic_requests as jsynthetic_requests)
from distributed_pytorch_from_scratch_tpu.training.checkpoint import (
    save_checkpoint)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd)
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, decode_prompts)
from distributed_pytorch_from_scratch_tpu_torch.serving.loadgen import (
    synthetic_requests)
from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
    load_params)

SHAPE = dict(attn_dim=64, ffn_dim=128, num_heads=4, num_kv_heads=2,
             num_layers=2, vocab_size=96, maxlen=64)
BUF, EOS, SEED = 32, 1, 3
LOAD = dict(num=6, prompt_len_min=4, prompt_len_max=12, max_new=8,
            vocab_size=96, seed=SEED, arrival="burst")
ENGINE = dict(num_slots=3, buf_len=BUF, eos_id=EOS, prefill_bucket=8,
              max_prefill_batch=2)
SHAPE_FLAGS = ["--attn_dim", "64", "--ffn_dim", "128", "--num_heads", "4",
               "--num_kv_heads", "2", "--num_layers", "2", "--maxlen", "64",
               "--vocab_size", "96", "--no-bf16"]


@pytest.fixture(scope="module")
def jax_run():
    """JAX params (numpy tree) and the JAX engine's tokens/stats."""
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1)
    mesh = jmake_mesh(JMeshConfig(tp=1))
    params = jmodel.init(jax.random.key(11))
    eng = JEngine(jmodel, mesh, jax.device_put(params, jmodel.shardings(mesh)),
                  **ENGINE)
    for r in jsynthetic_requests(**LOAD):
        eng.submit(r)
    eng.run_to_completion()
    tree = jax.tree.map(np.asarray, params)
    return jmodel, tree, {r.rid: r.tokens for r in eng.completed}, eng.stats()


def _port_engine(tree, **kw):
    model = Transformer(ModelConfig(**SHAPE))
    model.load_state_dict(params_from_jax(tree))
    mesh = make_mesh(MeshConfig(), device="cpu")
    return ContinuousBatchingEngine(model, mesh, **{**ENGINE, **kw})


def _run(engine, requests):
    for r in requests:
        engine.submit(r)
    engine.run_to_completion()
    return {r.rid: r.tokens for r in engine.completed}


def test_synthetic_requests_match_jax():
    for arrival in ("burst", "poisson"):
        kw = {**LOAD, "arrival": arrival, "num": 9}
        a, b = synthetic_requests(**kw), jsynthetic_requests(**kw)
        assert [(r.rid, r.prompt, r.max_new, r.seed, r.arrival) for r in a] \
            == [(r.rid, r.prompt, r.max_new, r.seed, r.arrival) for r in b]


def test_engine_tokens_and_stats_match_jax(jax_run):
    _, tree, ref, ref_stats = jax_run
    eng = _port_engine(tree)
    got = _run(eng, synthetic_requests(**LOAD))
    assert sorted(got) == sorted(ref) == list(range(LOAD["num"]))
    for rid in ref:
        assert got[rid] == ref[rid], (rid, got[rid], ref[rid])
    assert sum(len(t) for t in ref.values()) > LOAD["num"]   # real decoding
    assert eng.stats() == ref_stats
    assert flash_attention_fwd.launches == 0    # CPU: the plain path only


def test_one_slot_equals_four_slots(jax_run):
    _, tree, ref, _ = jax_run
    one = _run(_port_engine(tree, num_slots=1, max_prefill_batch=1),
               synthetic_requests(**LOAD))
    four = _run(_port_engine(tree, num_slots=4), synthetic_requests(**LOAD))
    assert one == four
    # decode_prompts: the batch-CLI convenience, outputs in prompt order
    prompts = [r.prompt for r in synthetic_requests(**LOAD)]
    assert decode_prompts(_port_engine(tree), prompts, LOAD["max_new"]) \
        == [ref[i] for i in range(LOAD["num"])]


def test_serve_dry_run_and_tiny_cpu(capsys):
    out = serve.main(["--dry_run", "--device", "cpu"])
    assert out["completed"] == out["requests"] == 6
    assert out["device"] == "cpu"
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["completed"] == rec["requests"] == 6
    assert rec["device"] == "cpu"
    for key in ("metric", "value", "unit", "ttft_ms_p50", "tpot_ms_p95",
                "queue_wait_ms_p95", "prefill_pad_waste_eliminated"):
        assert key in rec
    out = serve.main(["--device", "cpu", "--random_init", *SHAPE_FLAGS,
                      "--num_requests", "5", "--arrival", "burst",
                      "--prompt_len_min", "4", "--prompt_len_max", "20",
                      "--max_new_tokens", "6", "--slots", "2",
                      "--prefill_bucket", "8"])
    assert out["completed"] == out["requests"] == 5
    assert out["prefill_dispatches"] >= 1
    assert all(0 <= t < 96 for toks in out["outputs"].values() for t in toks)


def test_serve_refuses_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        serve.main(["--dry_run"])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)
    for flag in (["--speculate", "2"], ["--tp_size", "2"],
                 ["--temperature", "0.5"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--dry_run", "--device", "cpu", *flag])
        assert e.value.code == 2


def test_serve_jax_checkpoint(jax_run, tmp_path):
    jmodel, tree, ref, _ = jax_run
    save_checkpoint(str(tmp_path / "tp1"), 5, 1.25, tree, jmodel.specs(), 1)
    out = serve.main(["--device", "cpu", "--ckpt_dir", str(tmp_path / "tp1"),
                      *SHAPE_FLAGS, "--num_requests", str(LOAD["num"]),
                      "--arrival", "burst", "--prompt_len_min", "4",
                      "--prompt_len_max", "12", "--max_new_tokens", "8",
                      "--seed", str(SEED), "--slots", "3", "--buf_len",
                      str(BUF), "--prefill_bucket", "8",
                      "--max_prefill_batch", "2"])
    assert out["outputs"] == ref
    save_checkpoint(str(tmp_path / "tp2"), 5, 1.25, tree, jmodel.specs(), 2)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        load_params(str(tmp_path / "tp2"), 5)
