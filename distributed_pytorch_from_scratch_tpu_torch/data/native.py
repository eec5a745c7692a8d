"""ctypes binding for the native C++ data-path library — the port's copy of
the JAX `data/native.py`, over the same source, the repo's root
`csrc/dataloader.cpp` (a byte-level BPE encoder and the shift-by-one
collate).

Build model: the shared library is compiled on first use with g++ into
`build/` beside this file (git-ignored), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
The compiler writes a name of its own process's and the result is moved
into place with `os.replace`, so processes that build at the same moment
(the JAX package builds the same source, into its own file) never load a
half-written library. The C ABI + ctypes is the binding (no pybind11). If
no compiler is available, `get_lib` returns None and the callers that
allow it (`backend='auto'`) use the HF tokenizer / numpy collate paths.

`NativeBPE` self-verifies on construction when the HF `tokenizers`
library imports: it encodes a battery of probe texts with both encoders
and refuses to load (raises) on any mismatch. Without `tokenizers` it
says so and loads unverified; `decode` is the byte-level decode of the
shipped tokenizer's `ByteLevel` decoder, in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).parent / "build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_err: Optional[str] = None

PROBE_TEXTS = [
    "Nice to meet you, it's a test",
    "hello   world\n\nnew  paragraph",
    "don't you'll we've I'm he'd they're",
    "numbers 123 45.67 8,900 and (punct)!?;:--\"quotes\"",
    " leading and trailing  ",
    "tabs\tand\nnewlines \n mixed",
    "CamelCase ALLCAPS mIxEd",
    "unicode: café naïve über буквы",
    "",
    "a",
]


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libdistdata-{h.hexdigest()[:16]}.so"


def _build() -> tuple:
    """(library path, None) once it is built, else (None, the error)."""
    if not _SRC.is_file():
        return None, f"source {_SRC} not found"
    out = _target()
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
        return out, None
    except FileNotFoundError:
        return None, "g++ not found"
    except subprocess.CalledProcessError as e:
        return None, f"g++ failed: {e.stderr[:500]}"
    except subprocess.TimeoutExpired:
        return None, "g++ timed out"
    finally:
        if tmp.exists():
            tmp.unlink()


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    path, _lib_err = _build()
    if _lib_err is not None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.tok_create.restype = ctypes.c_void_p
    lib.tok_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32]
    lib.tok_encode.restype = ctypes.c_int32
    lib.tok_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char), ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.tok_free.argtypes = [ctypes.c_void_p]
    lib.collate_batch.argtypes = [ctypes.POINTER(ctypes.c_int32)] * 2 + \
        [ctypes.c_int32] * 5 + [ctypes.POINTER(ctypes.c_int32)] * 3
    lib.collate_indexed.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)] + [ctypes.c_int32] * 6 + \
        [ctypes.POINTER(ctypes.c_int32)] * 3
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _byte_decoder() -> dict:
    """The GPT-2 byte-level table inverted: each of the 256 printable
    stand-in characters -> the byte it stands for."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_DECODER = _byte_decoder()


class NativeBPE:
    """Byte-level BPE encoder backed by the C++ library, loaded from a HF
    `tokenizer.json`. Construction verifies parity against the HF encoder
    on PROBE_TEXTS (+ optional caller-provided samples) and raises on
    mismatch; without `tokenizers` installed it skips the check and says
    so on stderr."""

    def __init__(self, tokenizer_json: str, verify_against_hf: bool = True,
                 extra_probes: Optional[List[str]] = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_lib_err}")
        self._lib = lib
        with open(tokenizer_json) as f:
            spec = json.load(f)
        if spec["model"]["type"] != "BPE":
            raise ValueError(f"unsupported model type {spec['model']['type']}")
        pre = spec.get("pre_tokenizer") or {}
        self.add_prefix_space = bool(pre.get("add_prefix_space", False))

        vocab = spec["model"]["vocab"]
        # Added tokens (BOS/EOS/UNK) participate only as whole strings; the
        # encode path never produces them from text (specials come from the
        # collate, not the tokenizer). HF *does* match a literal
        # added-token string inside raw text, so callers route such texts
        # to the HF path; `added_tokens` is exposed for that scan.
        added = spec.get("added_tokens", [])
        self.added_tokens = [at["content"] for at in added]
        self._special = {at["id"] for at in added if at.get("special")}
        self._id_to_token = {i: t for t, i in vocab.items()}
        self._id_to_token.update({at["id"]: at["content"] for at in added})
        self._token_to_id = {t: i for i, t in self._id_to_token.items()}
        toks = list(vocab.keys())
        ids = [vocab[t] for t in toks]
        merges = spec["model"]["merges"]
        ml = [(m[0] if isinstance(m, (list, tuple)) else m.split(" ")[0])
              for m in merges]
        mr = [(m[1] if isinstance(m, (list, tuple)) else m.split(" ")[1])
              for m in merges]

        tok_arr = (ctypes.c_char_p * len(toks))(
            *[t.encode("utf-8") for t in toks])
        id_arr = (ctypes.c_int32 * len(ids))(*ids)
        ml_arr = (ctypes.c_char_p * len(ml))(*[x.encode("utf-8") for x in ml])
        mr_arr = (ctypes.c_char_p * len(mr))(*[x.encode("utf-8") for x in mr])
        unk_token = spec["model"].get("unk_token")
        unk_id = -1
        if unk_token is not None:
            unk_id = vocab.get(unk_token, -1)
            if unk_id < 0:
                for at in added:
                    if at["content"] == unk_token:
                        unk_id = at["id"]
        self._tok = lib.tok_create(tok_arr, id_arr, len(toks),
                                   ml_arr, mr_arr, len(ml), unk_id)
        self._buf = (ctypes.c_int32 * (1 << 16))()
        self.verified = False

        if verify_against_hf:
            self._verify(tokenizer_json, (extra_probes or []) + PROBE_TEXTS)

    def _verify(self, tokenizer_json: str, probes: List[str]) -> None:
        try:
            from tokenizers import Tokenizer as HFTokenizer
        except ImportError:
            print("NativeBPE: the HF `tokenizers` library is not installed; "
                  "skipping the parity self-check", file=sys.stderr)
            return
        hf = HFTokenizer.from_file(tokenizer_json)
        for text in probes:
            if self.encode(text) != hf.encode(text).ids:
                raise RuntimeError(
                    f"native BPE disagrees with HF tokenizers on {text!r}; "
                    f"use the HF path for this corpus")
        self.verified = True

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        # explicit byte length: embedded NULs must not truncate (c_char_p
        # marshalling would stop at the first NUL)
        aps = 1 if self.add_prefix_space else 0
        n = self._lib.tok_encode(self._tok, data, len(data), aps,
                                 self._buf, len(self._buf))
        while n > len(self._buf):  # buffer too small: grow and re-encode
            self._buf = (ctypes.c_int32 * (2 * n))()
            n = self._lib.tok_encode(self._tok, data, len(data), aps,
                                     self._buf, len(self._buf))
        return list(self._buf[:n])

    def decode(self, ids: List[int]) -> str:
        """HF `Tokenizer.decode(ids)` for a ByteLevel decoder: special
        tokens and unknown ids skipped, each token's characters mapped back
        through the byte table (a token with a character outside it
        contributes its own UTF-8 bytes), the bytes decoded as UTF-8 with
        invalid sequences replaced."""
        out = bytearray()
        for i in ids:
            i = int(i)
            tok = self._id_to_token.get(i)
            if tok is None or i in self._special:
                continue
            try:
                out.extend(_BYTE_DECODER[c] for c in tok)
            except KeyError:
                out.extend(tok.encode("utf-8"))
        return out.decode("utf-8", errors="replace")

    def token_to_id(self, token: str) -> Optional[int]:
        return self._token_to_id.get(token)

    def get_vocab_size(self) -> int:
        return len(self._id_to_token)

    def __del__(self):
        if getattr(self, "_tok", None) and getattr(self, "_lib", None):
            self._lib.tok_free(self._tok)


def native_collate(batch: List[List[int]], bos: int, eos: int,
                   ignore_idx: int, width: Optional[int] = None) -> dict:
    """C++ collate with the source repo's semantics; the same output dict
    as data.dataset.collate. `width=None` pads to the longest row + 1, the
    same default rule as `collate(pad_to=None)`."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    n = len(batch)
    lens_py = list(map(len, batch))
    longest = max(lens_py, default=0)
    if width is None:
        width = longest + 1
    if width < longest + 1:
        raise ValueError(
            f"pad width {width} < longest sequence + 1 ({longest + 1}); "
            f"callers must truncate to width-1 first (dataset.TokenDataset "
            f"does)")
    flat = np.fromiter(itertools.chain.from_iterable(batch), np.int32,
                       sum(lens_py))
    lens = np.asarray(lens_py, np.int32)
    input_ids = np.empty((n, width), np.int32)
    target_ids = np.empty((n, width), np.int32)
    position_ids = np.empty((n, width), np.int32)
    as_p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.collate_batch(as_p(flat), as_p(lens), n, width, bos, eos, ignore_idx,
                      as_p(input_ids), as_p(target_ids), as_p(position_ids))
    return {"input_ids": input_ids, "target_ids": target_ids,
            "position_ids": position_ids}


def native_collate_indexed(packed: np.ndarray, offsets: np.ndarray,
                           idxs: np.ndarray, cap: int, width: int,
                           bos: int, eos: int, ignore_idx: int) -> dict:
    """Whole-batch gather + truncate + collate in ONE C++ call over the
    packed corpus (`collate_indexed` in csrc/dataloader.cpp). `cap` is the
    maxlen-1 truncation limit TokenDataset applies; `width` the fixed pad
    length. ctypes releases the GIL for the call's duration."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    if packed.dtype != np.int32 or offsets.dtype != np.int64:
        raise TypeError(f"packed must be int32 and offsets int64, got "
                        f"{packed.dtype} and {offsets.dtype}")
    n = len(idxs)
    idxs = np.ascontiguousarray(idxs, np.int32)
    # the C++ side clamps rows to width-1 defensively; an undersized width
    # must raise as the numpy path does, not truncate silently
    if n:
        idx64 = idxs.astype(np.int64)
        longest = int(min((offsets[idx64 + 1] - offsets[idx64]).max(), cap))
        if width < longest + 1:
            raise ValueError(
                f"pad width {width} < longest selected row + 1 "
                f"({longest + 1}) after cap {cap}")
    input_ids = np.empty((n, width), np.int32)
    target_ids = np.empty((n, width), np.int32)
    position_ids = np.empty((n, width), np.int32)
    as_p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.collate_indexed(
        as_p(packed), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        as_p(idxs), n, cap, width, bos, eos, ignore_idx,
        as_p(input_ids), as_p(target_ids), as_p(position_ids))
    return {"input_ids": input_ids, "target_ids": target_ids,
            "position_ids": position_ids}
