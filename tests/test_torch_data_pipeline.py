"""The port's data pipeline (`data/preprocess.py`, `data/tokenizer.py`,
`data/native.py`, the native backend of `data/dataset.py`) against the
JAX package's, on the same files, on the CPU.

(a) `preprocess` on a seeded parquet writes a file byte-identical to JAX's;
(b) `train_bpe` writes JAX's tokenizer file and encodes alike;
(c) `pre_tokenize` writes JAX's token JSON byte for byte under the hf and
    native backends, and routes a corpus holding a literal added-token
    string to HF under auto (native refuses it), as JAX does;
(d) `NativeBPE` encodes like HF on the shipped tokenizer, and its
    byte-level decode equals HF's decode on the eight decode prompts and on
    seeded random id lists; `load_tokenizer` takes each backend;
(e) `native_collate` and `native_collate_indexed` give the numpy collate's
    batches and JAX's native ones; the loader with backend='native' gives
    the numpy backend's batches (truncated rows, dynamic width), and an
    undersized pad raises on both;
(f) the shipped tokenizer's specials, and the port's trainer on a token
    JSON of the source repo's schema (the cases of
    tests/test_reference_interop.py).
"""

import json
import os
import random

import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu.data import native as jnative
from distributed_pytorch_from_scratch_tpu.data import preprocess as jpre
from distributed_pytorch_from_scratch_tpu.data import tokenizer as jtok
from distributed_pytorch_from_scratch_tpu.data.dataset import (
    collate as jcollate)
from distributed_pytorch_from_scratch_tpu_torch import train as train_mod
from distributed_pytorch_from_scratch_tpu_torch.config import (
    BOS_TOKEN, EOS_TOKEN, UNK_TOKEN)
from distributed_pytorch_from_scratch_tpu_torch.data import native, tokenizer
from distributed_pytorch_from_scratch_tpu_torch.data.dataset import (
    DataLoader, TokenDataset, collate, get_dataloader)
from distributed_pytorch_from_scratch_tpu_torch.data.preprocess import (
    preprocess)
from distributed_pytorch_from_scratch_tpu_torch.evaluate import (
    DECODE_PROMPTS)
from _torch_threads import two_torch_threads  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "tokenizer", "tokenizer.json")
WORDS = ("the king rode out at dawn with his men a quiet morning on the "
         "river bank she sold sea shells by the shore Nice to meet you it's "
         "Great empire never falls Your majesty I shall be glad What glory "
         "Shame for weak The brave man ne Poor old hello world good test "
         "café naïve буквы 123 45.67 (punct)!? don't we've").split()


def _texts(n, seed, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(lo, hi)))
            for _ in range(n)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def hf():
    from tokenizers import Tokenizer
    return Tokenizer.from_file(SHIPPED)


@pytest.fixture(scope="module")
def bpe():
    return native.NativeBPE(SHIPPED)


# -- (a) preprocess ----------------------------------------------------------

@pytest.mark.parametrize("max_chars,val_ratio,seed",
                         [(2000, 0.01, 0), (120, 0.1, 3)])
def test_preprocess_byte_identical_to_jax(tmp_path, max_chars, val_ratio,
                                          seed):
    import pandas as pd
    texts = _texts(300, seed, hi=60)
    pq = tmp_path / "shard.parquet"
    pd.DataFrame({"text": texts, "id": np.arange(len(texts))}).to_parquet(pq)
    ours = preprocess(str(pq), str(tmp_path / "ours.json"), max_chars,
                      val_ratio, seed)
    theirs = jpre.preprocess(str(pq), str(tmp_path / "theirs.json"),
                             max_chars, val_ratio, seed)
    assert ours == theirs
    assert _bytes(tmp_path / "ours.json") == _bytes(tmp_path / "theirs.json")
    assert all(len(t) <= max_chars for t in ours["train"])


def test_preprocess_cli(tmp_path):
    import pandas as pd
    pq = tmp_path / "shard.parquet"
    pd.DataFrame({"text": _texts(50, 1)}).to_parquet(pq)
    from distributed_pytorch_from_scratch_tpu_torch.data.preprocess import (
        main)
    main(["-i", str(pq), "-o", str(tmp_path / "a.json"), "--seed", "2"])
    jpre.main(["-i", str(pq), "-o", str(tmp_path / "b.json"), "--seed", "2"])
    assert _bytes(tmp_path / "a.json") == _bytes(tmp_path / "b.json")


# -- (b) train_bpe -----------------------------------------------------------

def test_train_bpe_matches_jax(tmp_path):
    texts = _texts(200, 5) + ["hello world", "good morning",
                              "this is a test"]
    inp = tmp_path / "texts.json"
    inp.write_text(json.dumps({"train": texts, "validation": texts[:5]}))
    ours = tokenizer.train_bpe(str(inp), str(tmp_path / "ours.json"), 300)
    theirs = jtok.train_bpe(str(inp), str(tmp_path / "theirs.json"), 300)
    assert _bytes(tmp_path / "ours.json") == _bytes(tmp_path / "theirs.json")
    for t in texts[:50] + DECODE_PROMPTS:
        assert ours.encode(t).ids == theirs.encode(t).ids


# -- (c) pre_tokenize --------------------------------------------------------

@pytest.mark.parametrize("backend", ["hf", "native", "auto"])
def test_pre_tokenize_byte_identical_to_jax(tmp_path, backend):
    data = {"train": _texts(60, 7) + [" leading  and trailing ",
                                      "tabs\tand\nnewlines"],
            "validation": _texts(10, 8)}
    inp = tmp_path / "texts.json"
    inp.write_text(json.dumps(data, ensure_ascii=False))
    ours = tokenizer.pre_tokenize(str(inp), str(tmp_path / "o.json"),
                                  SHIPPED, backend=backend)
    theirs = jtok.pre_tokenize(str(inp), str(tmp_path / "t.json"), SHIPPED,
                               backend=backend)
    assert ours == theirs
    assert _bytes(tmp_path / "o.json") == _bytes(tmp_path / "t.json")
    # and the two backends agree with each other
    hf_out = jtok.pre_tokenize(str(inp), str(tmp_path / "h.json"), SHIPPED,
                               backend="hf")
    assert ours == hf_out


def test_pre_tokenize_added_token_routing_matches_jax(tmp_path):
    """A literal '<EOS>' past the first 64 texts: auto routes to HF (which
    emits its id), native refuses, in both packages."""
    filler = [f"plain text number {i}" for i in range(80)]
    data = {"train": filler + ["sneaky <EOS> in late text"],
            "validation": ["good morning"]}
    inp = tmp_path / "texts.json"
    inp.write_text(json.dumps(data))
    ours = tokenizer.pre_tokenize(str(inp), str(tmp_path / "a.json"),
                                  SHIPPED, backend="auto")
    theirs = jtok.pre_tokenize(str(inp), str(tmp_path / "b.json"), SHIPPED,
                               backend="auto")
    assert _bytes(tmp_path / "a.json") == _bytes(tmp_path / "b.json")
    assert 1 in ours["train"][80]
    for mod in (tokenizer, jtok):
        with pytest.raises(ValueError, match="added-token"):
            mod.pre_tokenize(str(inp), str(tmp_path / "n.json"), SHIPPED,
                             backend="native")


def test_tokenizer_cli_matches_jax(tmp_path):
    inp = tmp_path / "texts.json"
    inp.write_text(json.dumps({"train": _texts(20, 9),
                               "validation": _texts(4, 10)}))
    tokenizer.main(["encode", "-i", str(inp), "-o", str(tmp_path / "a.json"),
                    "-t", SHIPPED])
    jtok.main(["encode", "-i", str(inp), "-o", str(tmp_path / "b.json"),
               "-t", SHIPPED])
    assert _bytes(tmp_path / "a.json") == _bytes(tmp_path / "b.json")


# -- (d) NativeBPE and the shared loader --------------------------------------

def test_native_encodes_like_hf(bpe, hf):
    rng = random.Random(0)
    alphabet = "abcXYZ 019 \n\t.,!?'\"-éü€😀"
    texts = (list(native.PROBE_TEXTS) + DECODE_PROMPTS
             + ["".join(rng.choice(alphabet) for _ in range(rng.randrange(60)))
                for _ in range(200)])
    for t in texts:
        assert bpe.encode(t) == hf.encode(t).ids, repr(t)
    assert bpe.verified
    # the JAX package's encoder, over its own build of the same source
    jbpe = jnative.NativeBPE(SHIPPED)
    assert [bpe.encode(t) for t in texts] == [jbpe.encode(t) for t in texts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_byte_level_decode_equals_hf(bpe, hf, seed):
    rng = np.random.default_rng(seed)
    lists = [rng.integers(0, 1024, size=rng.integers(0, 48)).tolist()
             for _ in range(400)]
    lists += [hf.encode(p).ids for p in DECODE_PROMPTS]
    lists += [[0] + hf.encode(p).ids + [1, 2] for p in DECODE_PROMPTS]
    for ids in lists:
        assert bpe.decode(ids) == hf.decode(ids), ids


@pytest.mark.parametrize("backend", ["hf", "native", "auto"])
def test_load_tokenizer_backends(backend, hf, capsys):
    tok = tokenizer.load_tokenizer(SHIPPED, backend)
    said = capsys.readouterr().out
    assert tok.backend == ("hf" if backend == "hf" else "native")
    assert "tokenizer:" in said
    for p in DECODE_PROMPTS:
        ids = tok.encode(p)
        assert ids == hf.encode(p).ids
        assert tok.decode(ids) == hf.decode(ids)
    for name, want in ((BOS_TOKEN, 0), (EOS_TOKEN, 1), (UNK_TOKEN, 2)):
        assert tok.token_to_id(name) == want
    assert tok.get_vocab_size() == hf.get_vocab_size() == 1024
    if backend != "hf":
        with pytest.raises(ValueError, match="added-token"):
            tok.encode("a literal <EOS> here")
    with pytest.raises(ValueError, match="backend"):
        tokenizer.load_tokenizer(SHIPPED, "sentencepiece")


def test_native_library_builds_in_its_own_directory():
    lib = native.get_lib()
    assert lib is not None
    built = list(native.BUILD_DIR.glob("libdistdata-*.so"))
    assert native._target() in built
    assert not list(native.BUILD_DIR.glob(f"*.tmp{os.getpid()}.so"))


# -- (e) collate and the loader ----------------------------------------------

def _rows(seed, n=32, lo=1, hi=30):
    rng = random.Random(seed)
    return [[rng.randrange(3, 1000) for _ in range(rng.randrange(lo, hi))]
            for _ in range(n)]


@pytest.mark.parametrize("width", [None, 40])
def test_native_collate_equals_numpy_and_jax(width):
    batch = _rows(1)
    ours = native.native_collate(batch, 0, 1, -1, width)
    plain = collate(batch, 0, 1, -1, width)
    theirs = jnative.native_collate(batch, 0, 1, -1, width)
    jplain = jcollate(batch, 0, 1, -1, width)
    for k in ("input_ids", "target_ids", "position_ids"):
        for other in (plain, theirs, jplain):
            assert ours[k].dtype == other[k].dtype
            np.testing.assert_array_equal(ours[k], other[k], err_msg=k)
    with pytest.raises(ValueError, match="pad width"):
        native.native_collate([[5] * 40], 0, 1, -1, width=16)


def test_native_collate_indexed_equals_numpy_and_jax():
    seqs = _rows(2, n=40, hi=60)
    lens = np.array([len(s) for s in seqs], np.int64)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    packed = np.concatenate([np.asarray(s, np.int32) for s in seqs])
    idxs = np.random.default_rng(3).permutation(len(seqs))[:8]
    cap, width = 31, 32
    ours = native.native_collate_indexed(packed, offsets, idxs, cap, width,
                                         0, 1, -1)
    theirs = jnative.native_collate_indexed(packed, offsets, idxs, cap,
                                            width, 0, 1, -1)
    plain = collate([seqs[i][:cap] for i in idxs], 0, 1, -1, width)
    for k in ("input_ids", "target_ids", "position_ids"):
        np.testing.assert_array_equal(ours[k], plain[k], err_msg=k)
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    with pytest.raises(ValueError, match="pad width"):
        native.native_collate_indexed(packed, offsets, idxs, 59, 16, 0, 1, -1)


def _token_json(path, seqs):
    path.write_text(json.dumps({
        "train": seqs, "validation": seqs[:5],
        "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
        "vocab_size": 1024}))


@pytest.mark.parametrize("pad_to", [None, 16])
def test_loader_native_backend_equals_numpy(tmp_path, pad_to):
    """Rows straddle the maxlen-1 cap (truncation in C++), and pad_to=None
    takes the dynamic width."""
    p = tmp_path / "tokens.json"
    _token_json(p, _rows(3, n=24, hi=41))

    def mk(backend):
        return DataLoader(TokenDataset(str(p), "train", maxlen=16),
                          batch_size=4, shuffle=True, seed=5, pad_to=pad_to,
                          backend=backend)

    pairs = list(zip(mk("native").epoch(0), mk("numpy").epoch(0)))
    assert len(pairs) == 6
    truncated = False
    for a, b in pairs:
        for k in ("input_ids", "target_ids", "position_ids"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        truncated |= bool((np.sum(a["target_ids"] != -1, axis=1) == 16).any())
    assert truncated
    assert mk("auto")._use_native


def test_loader_native_undersized_pad_raises(tmp_path):
    p = tmp_path / "tokens.json"
    _token_json(p, [[5] * 20 for _ in range(8)])
    for backend in ("native", "numpy"):
        dl = DataLoader(TokenDataset(str(p), "train", maxlen=64),
                        batch_size=4, shuffle=False, pad_to=10,
                        backend=backend)
        with pytest.raises(ValueError, match="pad"):
            next(iter(dl.epoch(0)))
    with pytest.raises(ValueError, match="backend"):
        get_dataloader(str(p), batch_size=4, maxlen=64, backend="rust")


# -- (f) the shipped tokenizer and the source repo's schema ------------------

def test_shipped_tokenizer_specials(hf, bpe):
    assert hf.get_vocab_size() == 1024
    for tok, want in ((BOS_TOKEN, 0), (EOS_TOKEN, 1), (UNK_TOKEN, 2)):
        assert hf.token_to_id(tok) == want
        assert bpe.token_to_id(tok) == want


def test_train_from_reference_schema_token_json(tmp_path, hf):
    """A token JSON of the source repo's schema, built with the shipped
    tokenizer, drives the port's trainer: finite, falling losses."""
    texts = ["First Citizen:\nBefore we proceed any further, hear me speak.",
             "Nice to meet you, it's a test",
             "the quick brown fox jumps over the lazy dog 0123456789",
             "O Romeo, Romeo! wherefore art thou Romeo?"] * 8
    p = tmp_path / "tokens.json"
    p.write_text(json.dumps({
        "train": [hf.encode(t).ids for t in texts],
        "validation": [hf.encode(t).ids for t in texts[:4]],
        "special_ids": {BOS_TOKEN: 0, EOS_TOKEN: 1, UNK_TOKEN: 2},
        "vocab_size": hf.get_vocab_size()}))
    out = train_mod.train(train_mod.get_train_args([
        "--device", "cpu", "--model", "tiny", "--maxlen", "64",
        "--batch_size", "4", "--max_steps", "8", "--lr", "1e-3",
        "--warmup_steps", "2", "--log_interval", "4", "--save_interval",
        "100", "--data_path", str(p), "--save_dir", str(tmp_path / "ck")]))
    losses = out["losses"]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
