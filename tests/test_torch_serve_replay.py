"""The port's serve CLI with a real vocabulary and a captured trace, on the
CPU, against the JAX package's parse of the same inputs.

* `replay_requests` reads a jsonl trace into the JAX function's requests
  (rid, prompt, max_new, seed, arrival; its defaults for missing fields),
  sorted by arrival.
* `serve --tokenizer_path tokenizer/tokenizer.json --arrival replay
  --replay trace.jsonl` takes the vocab size and the EOS id from the
  tokenizer (HF `tokenizers`' reading of the file, as the JAX CLI's), and
  submits the trace in arrival order: every request is served, a prompt
  longer than the buffer is counted invalid, not fatal.
* Both CLIs refuse `--arrival replay` without `--replay`, and a tokenizer
  without the BOS/EOS specials is refused with the JAX message.
"""

import json
import os

import pytest

from distributed_pytorch_from_scratch_tpu.serving import serve as jserve
from distributed_pytorch_from_scratch_tpu.serving.loadgen import (
    replay_requests as jreplay_requests)
from distributed_pytorch_from_scratch_tpu_torch.serving import serve
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine)
from distributed_pytorch_from_scratch_tpu_torch.serving.loadgen import (
    replay_requests)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(ROOT, "tokenizer", "tokenizer.json")
SHAPE = ["--attn_dim", "64", "--ffn_dim", "128", "--num_heads", "2",
         "--num_layers", "2", "--maxlen", "64", "--no-bf16"]
# unsorted arrivals, missing fields, a blank line, one over-long prompt
TRACE = [{"rid": 7, "prompt": [5, 9, 11, 300], "max_new": 5, "seed": 3,
          "arrival": 0.03},
         {"prompt": [4, 4, 8], "arrival": 0.0},
         None,
         {"rid": 2, "prompt": [700, 12, 13, 14, 15, 16], "max_new": 3,
          "arrival": 0.01},
         {"rid": 9, "prompt": list(range(3, 60)), "max_new": 4,
          "arrival": 0.02}]


def _write_trace(path):
    with open(path, "w") as f:
        for rec in TRACE:
            f.write("\n" if rec is None else json.dumps(rec) + "\n")
    return str(path)


def _fields(reqs):
    return [(r.rid, r.prompt, r.max_new, r.seed, r.arrival) for r in reqs]


def test_replay_requests_match_jax(tmp_path):
    path = _write_trace(tmp_path / "trace.jsonl")
    ours = replay_requests(path)
    assert _fields(ours) == _fields(jreplay_requests(path))
    assert [r.arrival for r in ours] == sorted(r.arrival for r in ours)
    assert ours[0].rid == 1 and ours[0].max_new == 64 and ours[0].seed == 1


def test_tokenizer_and_replay_cli(tmp_path, monkeypatch):
    path = _write_trace(tmp_path / "trace.jsonl")
    argv = ["--device", "cpu", "--random_init", *SHAPE, "--tokenizer_path",
            TOKENIZER, "--vocab_size", "96", "--arrival", "replay",
            "--replay", path, "--buf_len", "40", "--slots", "2",
            "--prefill_bucket", "8"]
    args = serve.get_serve_args(argv)
    jargs = jserve.get_serve_args(argv[2:])   # no --device in the JAX CLI
    assert (args.arrival, args.replay) == (jargs.arrival, jargs.replay)
    from tokenizers import Tokenizer
    hf = Tokenizer.from_file(TOKENIZER)
    serve._model_config(args)
    assert args.vocab_size == hf.get_vocab_size() == 1024
    assert args.eos_id == hf.token_to_id("<EOS>")
    order = []
    submit = ContinuousBatchingEngine.submit

    def seen(self, req):
        order.append(req.rid)
        return submit(self, req)

    monkeypatch.setattr(ContinuousBatchingEngine, "submit", seen)
    out = serve.main(argv)
    want = [r.rid for r in jreplay_requests(path)]
    assert order == want
    # the 57-token prompt does not fit the 40-position buffer
    assert out["invalid"] == 1 and out["completed"] == 3
    assert sorted(out["outputs"]) == sorted(set(want) - {9})
    assert all(0 <= t < 1024 for ts in out["outputs"].values() for t in ts)


def test_replay_and_tokenizer_refusals(tmp_path):
    for parse in (serve.get_serve_args, jserve.get_serve_args):
        with pytest.raises(SystemExit) as e:
            parse(["--random_init", "--arrival", "replay"])
        assert e.value.code == 2
    spec = json.load(open(TOKENIZER))
    for tok in spec["added_tokens"]:
        if tok["content"] == "<BOS>":
            tok["content"] = "<PAD>"
    spec["model"]["vocab"]["<PAD>"] = spec["model"]["vocab"].pop("<BOS>")
    bad = tmp_path / "no_bos.json"
    bad.write_text(json.dumps(spec))
    with pytest.raises(SystemExit, match="lacks the <BOS>/<EOS> specials"):
        serve.main(["--device", "cpu", "--dry_run", "--tokenizer_path",
                    str(bad)])
