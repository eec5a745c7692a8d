"""Token dataset + batch iterator (host-side, numpy) — the port's copy of
the JAX `data/dataset.py`, numpy backend only.

Collate semantics:

    input_ids  = [BOS] + tokens, padded with EOS
    target_ids = tokens + [EOS], padded with IGNORE_INDEX   (shift-by-one LM)
    position_ids = arange

Every batch is padded to a fixed `pad_to` length (default: model maxlen):
fixed shapes keep the step's kernels and allocations the same from batch
to batch, and the loss is unchanged — padded targets are IGNORE_INDEX and
masked out of the CE mean. Sequences longer than maxlen-1 are truncated
with a warning. The batches are byte-identical to the JAX package's numpy
backend for the same seed (tests/test_torch_training.py).

The collate runs in numpy or in the native C++ library (`data/native.py`,
over the repo's `csrc/dataloader.cpp`): `backend='native'` takes the C++
path, 'numpy' the Python one, and 'auto' the C++ one when the library
builds; both give the same bytes (tests/test_torch_data_pipeline.py).
The train loop collates on a thread of its own (`data/prefetch.py`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import BOS_TOKEN, EOS_TOKEN, IGNORE_INDEX, UNK_TOKEN


class TokenDataset:
    """Loads a token JSON in the schema of the JAX package's
    `data.tokenizer.pre_tokenize`: {"train": [[ids]...], "validation":
    [...], "special_ids": {"<BOS>": id, "<EOS>": id, "<UNK>": id},
    "vocab_size": int}."""

    def __init__(self, data_path: str, split: str, maxlen: int):
        if split not in ("train", "validation"):
            raise ValueError(
                f"expected split 'train' or 'validation', got {split!r}")
        if not os.path.exists(data_path):
            raise FileNotFoundError(f"data file not found: {data_path}")
        with open(data_path) as f:
            self.data = json.load(f)
        if split not in self.data:
            raise ValueError(
                f"split {split!r} not in {data_path}; available: "
                f"{list(self.data.keys())}")
        self.split = split
        self.maxlen = maxlen
        self.bos: int = self.data["special_ids"][BOS_TOKEN]
        self.eos: int = self.data["special_ids"][EOS_TOKEN]
        self.unk: int = self.data["special_ids"][UNK_TOKEN]
        self.vocab_size: int = self.data["vocab_size"]
        self._warned = False

    def __len__(self) -> int:
        return len(self.data[self.split])

    def __getitem__(self, idx: int) -> List[int]:
        tokens = self.data[self.split][idx]
        if len(tokens) > self.maxlen - 1:  # reserve one slot for BOS/EOS shift
            if not self._warned:
                print(f"Warning: sequence longer than maxlen-1 "
                      f"({len(tokens)} > {self.maxlen - 1}); truncating "
                      f"(further warnings suppressed)")
                self._warned = True
            tokens = tokens[: self.maxlen - 1]
        return tokens

    def packed(self):
        """(packed int32, offsets int64): the whole split concatenated, for
        the native indexed collate (it gathers rows straight from this
        buffer and truncates to maxlen-1 in C++). Built once, cached."""
        if not hasattr(self, "_packed"):
            seqs = self.data[self.split]
            lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
            offsets = np.zeros(len(seqs) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            packed = np.empty(int(offsets[-1]), np.int32)
            for i, s in enumerate(seqs):
                packed[offsets[i]:offsets[i + 1]] = s
            self._packed = (packed, offsets)
        return self._packed


def collate(batch: List[List[int]], bos: int, eos: int, ignore_idx: int,
            pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Shift-by-one LM collate with fixed-shape padding to `pad_to`."""
    max_len = max(len(x) for x in batch)
    width = (pad_to if pad_to is not None else max_len + 1)
    if width < max_len + 1:
        raise ValueError(f"pad_to {width} < longest sequence + 1")
    n = len(batch)
    input_ids = np.full((n, width), eos, dtype=np.int32)
    target_ids = np.full((n, width), ignore_idx, dtype=np.int32)
    for i, toks in enumerate(batch):
        L = len(toks)
        input_ids[i, 0] = bos
        input_ids[i, 1 : L + 1] = toks
        target_ids[i, :L] = toks
        target_ids[i, L] = eos
    position_ids = np.tile(np.arange(width, dtype=np.int32)[None, :], (n, 1))
    return {"input_ids": input_ids, "target_ids": target_ids,
            "position_ids": position_ids}


@dataclass
class DataLoader:
    """Epoch-aware shuffling batch iterator.

    Order per epoch: `np.random.RandomState(seed + epoch).permutation`.
    `drop_last=True` for training keeps every batch the same shape.
    `backend`: 'native' (the C++ collate), 'numpy', or 'auto' (native
    when the library builds); the same batches either way.
    """

    dataset: TokenDataset
    batch_size: int
    ignore_idx: int = IGNORE_INDEX
    shuffle: bool = True
    seed: int = 0
    pad_to: Optional[int] = None
    drop_last: bool = True
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ("auto", "native", "numpy"):
            raise ValueError(f"backend must be auto|native|numpy, "
                             f"got {self.backend!r}")
        use_native = False
        if self.backend in ("auto", "native"):
            from .native import native_available
            use_native = native_available()
            if self.backend == "native" and not use_native:
                raise RuntimeError("native collate requested but the C++ "
                                   "library is unavailable")
        self._use_native = use_native

    def _collate(self, batch: List[List[int]]) -> Dict[str, np.ndarray]:
        ds = self.dataset
        if self._use_native:
            from .native import native_collate
            return native_collate(batch, ds.bos, ds.eos, self.ignore_idx,
                                  self.pad_to)
        return collate(batch, ds.bos, ds.eos, self.ignore_idx, self.pad_to)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(n)
        bs = self.batch_size
        end = n - n % bs if self.drop_last else n
        if self._use_native:
            # one GIL-released C++ call gathers each batch's rows from the
            # packed split, truncates and collates them
            from .native import native_collate_indexed
            ds = self.dataset
            packed, offsets = ds.packed()
            cap = ds.maxlen - 1
            for st in range(0, end, bs):
                idxs = order[st : st + bs]
                if self.pad_to is None:
                    lens = offsets[idxs + 1] - offsets[idxs]
                    width = int(min(lens.max(), cap)) + 1
                else:
                    width = self.pad_to
                yield native_collate_indexed(packed, offsets, idxs, cap,
                                             width, ds.bos, ds.eos,
                                             self.ignore_idx)
            return
        for st in range(0, end, bs):
            idxs = order[st : st + bs]
            batch = [self.dataset[int(i)] for i in idxs]
            yield self._collate(batch)

    def __iter__(self):
        return self.epoch(0)


@dataclass
class PackedDataLoader:
    """Classic packed-stream LM loader — zero padding compute.

    Per epoch: shuffle the documents, frame each as [BOS] + tokens + [EOS],
    concatenate into one stream, and cut fixed (batch, maxlen) chunks with
    the shift-by-one target (`target[t] = input[t+1]`; the last target of a
    row is the next row's first token). Every batch is identical shape with
    no IGNORE_INDEX padding, so with avg document length << maxlen the
    per-step useful-token fraction goes from ~avg_len/maxlen to 1.0.

    Semantics deviations from the docs-mode loader, both standard for GPT
    training and documented here: (a) documents can span chunk boundaries,
    and attention may cross document boundaries within a row (EOS/BOS
    separators mark them); (b) position_ids restart per ROW, not per
    document; (c) no truncation — long documents simply span chunks.
    Exposes the same interface the train loop consumes (`dataset`,
    `__len__`, `epoch`).
    """

    dataset: TokenDataset
    batch_size: int
    maxlen: int
    shuffle: bool = True
    seed: int = 0

    def __post_init__(self):
        ds = self.dataset
        seqs = ds.data[ds.split]
        # Frame every document ONCE into a cached [BOS]+doc+[EOS] buffer;
        # each epoch is then a pure gather of shuffled spans.
        lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
        self._offsets = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(lens + 2, out=self._offsets[1:])
        self._total = int(self._offsets[-1])
        if self._total - 1 < self.batch_size * self.maxlen:
            raise ValueError(
                f"packed mode needs at least batch_size*maxlen+1 = "
                f"{self.batch_size * self.maxlen + 1} framed tokens, "
                f"corpus has {self._total}")
        self._framed = np.empty(self._total, np.int32)
        for i, s in enumerate(seqs):
            o = int(self._offsets[i])
            self._framed[o] = ds.bos
            self._framed[o + 1 : o + 1 + len(s)] = s
            self._framed[o + 1 + len(s)] = ds.eos

    def __len__(self) -> int:
        return (self._total - 1) // (self.batch_size * self.maxlen)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n_docs = len(self._offsets) - 1
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(
                n_docs)
            stream = np.concatenate(
                [self._framed[self._offsets[i]:self._offsets[i + 1]]
                 for i in order])
        else:
            stream = self._framed
        bs, T = self.batch_size, self.maxlen
        span = bs * T
        pos = np.tile(np.arange(T, dtype=np.int32)[None, :], (bs, 1))
        for st in range(0, self._total - 1 - span + 1, span):
            seg = stream[st : st + span + 1]
            yield {"input_ids": seg[:-1].reshape(bs, T),
                   "target_ids": seg[1:].reshape(bs, T),
                   "position_ids": pos}

    def __iter__(self):
        return self.epoch(0)


def get_dataloader(data_path: str, batch_size: int,
                   ignore_idx: int = IGNORE_INDEX, split: str = "train",
                   maxlen: int = 1000, shuffle: bool = True, seed: int = 0,
                   pad_to: Optional[int] = None,
                   drop_last: Optional[bool] = None,
                   backend: str = "auto",
                   data_mode: str = "docs") -> "DataLoader | PackedDataLoader":
    """The loader the train CLI uses. `data_mode='packed'` returns the
    zero-padding packed-stream loader instead (training only; see
    PackedDataLoader)."""
    ds = TokenDataset(data_path, split, maxlen)
    if data_mode == "packed":
        # training-only mode; the docs-path knobs cannot take effect — an
        # explicit non-default request must fail loudly, not silently
        if split != "train":
            raise ValueError("data_mode='packed' is a TRAINING data mode; "
                             "evaluation is per-document (split='validation' "
                             "uses data_mode='docs')")
        bad = [name for name, val, dflt in [
            ("pad_to", pad_to, None), ("drop_last", drop_last, None),
            ("backend", backend, "auto"),
            ("ignore_idx", ignore_idx, IGNORE_INDEX)] if val != dflt]
        if bad:
            raise ValueError(f"data_mode='packed' ignores {bad}; remove "
                             f"them (chunks are always fixed-shape)")
        return PackedDataLoader(ds, batch_size, maxlen, shuffle, seed)
    if data_mode != "docs":
        raise ValueError(f"data_mode must be 'docs' or 'packed', "
                         f"got {data_mode!r}")
    if pad_to is None:
        pad_to = maxlen
    if drop_last is None:
        drop_last = split == "train"
    return DataLoader(ds, batch_size, ignore_idx, shuffle, seed, pad_to,
                      drop_last, backend)


def dp_rows(x: np.ndarray, dp: int, dp_rank: int) -> np.ndarray:
    """Data-parallel rank dp_rank's rows of a batch array (..., b, t): rows
    [dp_rank * b/dp, (dp_rank + 1) * b/dp) of the one seeded batch every
    rank draws — the JAX `batch_feeder`'s P(('dp', 'ep'), 'cp') split of
    the batch dim, when `dp` is dp * ep and `dp_rank` dp_rank * ep +
    ep_rank (`runtime.mesh.Mesh.row_shard`)."""
    b = x.shape[-2]
    if b % dp:
        raise ValueError(f"batch size {b} is not divisible by dp_size {dp} "
                         f"(each dp rank takes b/dp rows of the batch)")
    n = b // dp
    return x[..., dp_rank * n:(dp_rank + 1) * n, :]

