"""Byte-level BPE tokenizer: training, offline pre-tokenization, and the
loader the evaluation and generation CLIs share — the port's copy of the
JAX `data/tokenizer.py`.

The HF `tokenizers` Rust library trains the tokenizer (host-side, as in
the source repo's `train_tokenizer.py`), so the shipped
`tokenizer/tokenizer.json` loads unchanged in either package. The output
token JSON (`pre_tokenize`) is byte-identical to the JAX package's and to
the source repo's `pre_tokenize.py`:

    {"train": [[int]], "validation": [[int]],
     "special_ids": {"<BOS>": id, "<EOS>": id, "<UNK>": id},
     "vocab_size": int}

Encoding has two backends: 'native', the C++ BPE of the repo's
`csrc/dataloader.cpp` (`data/native.py`), and 'hf', the `tokenizers`
library; 'auto' takes native when it builds and passes its parity check
against HF, else hf. `load_tokenizer` gives evaluate.py and generate.py
one object over either backend (`encode`, `decode`, `token_to_id`,
`get_vocab_size`); its native decode is the byte-level decode of the
shipped tokenizer's `ByteLevel` decoder, so a machine without
`tokenizers` still evaluates and generates.

    python -m distributed_pytorch_from_scratch_tpu_torch.data.tokenizer \\
        train -d texts.json -v 1024 -o tokenizer.json
    python -m distributed_pytorch_from_scratch_tpu_torch.data.tokenizer \\
        encode -i texts.json -o tokens.json -t tokenizer.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterable, List, Optional

from ..config import BOS_TOKEN, EOS_TOKEN, UNK_TOKEN

BACKENDS = ("auto", "native", "hf")


def train_bpe(data_path: str, output_path: str, vocab_size: int = 30000,
              split: str = "train"):
    """Train a byte-level BPE tokenizer with BOS/EOS/UNK specials and save
    `tokenizer.json` (the source repo's `train_tokenizer.py`)."""
    from tokenizers import Tokenizer
    from tokenizers.decoders import ByteLevel as ByteLevelDecoder
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel as ByteLevelPreTokenizer
    from tokenizers.trainers import BpeTrainer

    with open(data_path) as f:
        texts: List[str] = json.load(f)[split]

    tokenizer = Tokenizer(BPE(unk_token=UNK_TOKEN))
    tokenizer.pre_tokenizer = ByteLevelPreTokenizer()
    tokenizer.decoder = ByteLevelDecoder()
    trainer = BpeTrainer(vocab_size=vocab_size,
                         special_tokens=[BOS_TOKEN, EOS_TOKEN, UNK_TOKEN])
    tokenizer.train_from_iterator(iter(texts), trainer=trainer)

    out_dir = os.path.dirname(os.path.abspath(output_path))
    os.makedirs(out_dir, exist_ok=True)
    tokenizer.save(output_path)
    print(f"tokenizer: vocab={tokenizer.get_vocab_size()} "
          f"BOS={tokenizer.token_to_id(BOS_TOKEN)} "
          f"EOS={tokenizer.token_to_id(EOS_TOKEN)} "
          f"UNK={tokenizer.token_to_id(UNK_TOKEN)} -> {output_path}")

    # round-trip self-check (the source repo's train_tokenizer.py)
    for t in ["good morning", "hello world", "this is a test"]:
        ids = tokenizer.encode(t).ids
        decoded = tokenizer.decode(ids).strip()
        if decoded != t:
            raise AssertionError(f"round-trip failed: {t!r} -> {decoded!r}")
    return tokenizer


def pre_tokenize(input_file: str, output_file: str, tokenizer_file: str,
                 splits: Iterable[str] = ("train", "validation"),
                 backend: str = "auto") -> Dict:
    """Apply a saved tokenizer to each split; write the token-id JSON.

    backend: 'native' (the C++ BPE), 'hf' (the HF tokenizers library), or
    'auto' — native when it builds AND passes its parity self-check, else
    hf. A corpus that holds a literal added-token string (e.g. "<EOS>")
    goes to HF, which matches such strings inside raw text (the native
    scanner does not); 'native' refuses it. HF is imported only when it
    encodes, so 'native' runs without it.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    splits = list(splits)
    with open(input_file) as f:
        data = json.load(f)

    native = None
    if backend in ("auto", "native"):
        try:
            from .native import NativeBPE
            native = NativeBPE(tokenizer_file,
                               extra_probes=[t for split in splits
                                             for t in data[split][:64]])
            print("pre_tokenize: using native C++ BPE encoder")
        except Exception as e:
            if backend == "native":
                raise
            print(f"pre_tokenize: native encoder unavailable ({e}); "
                  f"falling back to HF tokenizers")
    if native is not None and native.added_tokens:
        # scan the WHOLE corpus: one occurrence anywhere would diverge
        hit = next((s for split in splits for t in data[split]
                    for s in native.added_tokens if s in t), None)
        if hit is not None:
            if backend == "native":
                raise ValueError(
                    f"corpus contains the added-token string {hit!r}, which "
                    f"the native encoder cannot match; use backend='hf'")
            print(f"pre_tokenize: corpus contains added-token string "
                  f"{hit!r}; using HF tokenizers for exact parity")
            native = None

    if native is not None:
        tokenizer = native
    else:
        from tokenizers import Tokenizer
        tokenizer = Tokenizer.from_file(tokenizer_file)
    out: Dict = {}
    for split in splits:
        if native is not None:
            out[split] = [native.encode(t) for t in data[split]]
        else:
            encoded = tokenizer.encode_batch(data[split])
            out[split] = [e.ids for e in encoded]
        lens = [len(ids) for ids in out[split]] or [0]
        print(f"pre_tokenize: {split}: n={len(out[split])} "
              f"max={max(lens)} avg={sum(lens)/max(len(lens),1):.2f}")
    out["special_ids"] = {
        BOS_TOKEN: tokenizer.token_to_id(BOS_TOKEN),
        EOS_TOKEN: tokenizer.token_to_id(EOS_TOKEN),
        UNK_TOKEN: tokenizer.token_to_id(UNK_TOKEN),
    }
    out["vocab_size"] = tokenizer.get_vocab_size()

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "w") as f:
        json.dump(out, f, ensure_ascii=False)
    return out


class _HFTokenizer:
    """The HF `tokenizers` backend of `load_tokenizer`."""

    backend = "hf"

    def __init__(self, path: str):
        from tokenizers import Tokenizer
        self._tok = Tokenizer.from_file(path)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode([int(i) for i in ids])

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def get_vocab_size(self) -> int:
        return self._tok.get_vocab_size()


class _NativeTokenizer:
    """The native backend of `load_tokenizer`: `NativeBPE` encodes and
    decodes. A text holding a literal added-token string is refused (HF
    would match it as that token; the native scanner cannot)."""

    backend = "native"

    def __init__(self, bpe):
        self._bpe = bpe
        self.verified = bpe.verified

    def encode(self, text: str) -> List[int]:
        hit = next((s for s in self._bpe.added_tokens if s in text), None)
        if hit is not None:
            raise ValueError(
                f"text contains the added-token string {hit!r}, which the "
                f"native encoder cannot match; use the hf tokenizer backend")
        return self._bpe.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._bpe.decode(ids)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._bpe.token_to_id(token)

    def get_vocab_size(self) -> int:
        return self._bpe.get_vocab_size()


def load_tokenizer(path: str, backend: str = "auto",
                   verbose: bool = True):
    """The tokenizer of `path` over one backend: 'hf' (HF `tokenizers`),
    'native' (`data/native.NativeBPE`, checked against HF on its probe
    texts when `tokenizers` imports, unchecked otherwise — it says so), or
    'auto': native when the library builds and passes that check, else
    hf. Prints the backend it took when `verbose`."""
    if backend not in BACKENDS:
        raise ValueError(f"tokenizer backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    say = print if verbose else (lambda *a, **k: None)
    if backend in ("auto", "native"):
        try:
            from .native import NativeBPE
            tok = _NativeTokenizer(NativeBPE(path))
            say("tokenizer: native C++ BPE encoder, byte-level decode"
                + ("" if tok.verified else
                   " (not checked against HF: `tokenizers` is not "
                   "installed)"))
            return tok
        except Exception as e:
            if backend == "native":
                raise
            say(f"tokenizer: native encoder unavailable ({e}); using HF "
                f"tokenizers")
    tok = _HFTokenizer(path)
    say("tokenizer: HF tokenizers")
    return tok


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a BPE tokenizer")
    t.add_argument("--data_path", "-d", required=True)
    t.add_argument("--vocab_size", "-v", type=int, default=30000)
    t.add_argument("--output_path", "-o", required=True)

    e = sub.add_parser("encode", help="pre-tokenize splits to token JSON")
    e.add_argument("--input_file", "-i", required=True)
    e.add_argument("--output_file", "-o", required=True)
    e.add_argument("--tokenizer_file", "-t", required=True)
    e.add_argument("--splits", "-s", nargs="+", default=["train", "validation"])
    e.add_argument("--backend", choices=list(BACKENDS), default="auto")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "train":
        train_bpe(args.data_path, args.output_path, args.vocab_size)
    else:
        pre_tokenize(args.input_file, args.output_file, args.tokenizer_file,
                     args.splits, backend=args.backend)


if __name__ == "__main__":
    main()
