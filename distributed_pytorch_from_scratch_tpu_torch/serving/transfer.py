"""KV page streaming for disaggregated prefill -> decode (the port's copy of
the JAX `serving/transfer.py`).

A prefill-only engine finishes a request's chunked prefill into its own
page pool, then ships the request — its fields, its first sampled token
and the KV pages backing its prompt — to a decode engine over a
length-prefixed socket stream. The decode side leases pages from its own
pool (`PagedEngine.admit_prefilled` -> `PagedKVPool.import_pages`) and the
request goes on through the unchanged decode loop, token for token as it
would have colocated.

The wire format is the JAX package's, byte for byte, so either side may be
either package: one frame per handoff,

    magic  b"KVPG"
    u32    header length (big-endian)
    bytes  header: UTF-8 JSON — the request's fields, the first sampled
           token, the kv kind ('native' | 'int8'), page_size, n_tokens,
           trace_ctx (the prefill side's `RequestTracer.export_context`,
           null when tracing is off: the decode engine continues the trace
           from it, so the `handoff` span closes the prefill side's
           record and `kv_import` opens the decode side's), t_send, and
           per blob {dtype, shape}
    per blob: u64 length (big-endian) + its raw C-order bytes

The blobs are the `export_pages` payload in tree order: native pools send
[k, v], int8 pools [k_codes, k_scales, v_codes, v_scales]. Dtypes travel by
name (`bfloat16`, `float32`, `int8`, ...): a bf16 blob is the tensor's raw
bytes and is read back with `torch.frombuffer`, so no numpy bf16 type is
needed on either end.

`run_disaggregated` is the in-process driver: a prefill thread stepping the
prefill engine and sending its handoffs, a receiver thread reading frames
into an inbox, and the caller's thread admitting them into the decode
engine and decoding, over a `socket.socketpair()`.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from .engine import PagedEngine, Request
from .kv_manager import PoolExhausted, kv_leaves
from .loadgen import nearest_rank

MAGIC = b"KVPG"
POLL_S = 0.0005      # the decode loop's nap when it could do nothing

# wire name (numpy's `dtype.name`, the JAX side's) <-> torch dtype
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Exactly n bytes; None on a clean EOF at a frame boundary (nothing
    read yet). An EOF inside a frame is a protocol error."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            if not buf:
                return None
            raise ConnectionError(
                f"page stream truncated mid-frame: wanted {n} bytes, "
                f"got {len(buf)}")
        buf.extend(chunk)
    return buf


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's C-order bytes (as uint8), whatever its dtype."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def send_frame(sock: socket.socket, header: dict,
               blobs: List[torch.Tensor]) -> int:
    """One length-prefixed frame; returns the bytes put on the wire."""
    hdr = json.dumps(header).encode("utf-8")
    parts = [MAGIC, struct.pack(">I", len(hdr)), hdr]
    for b in blobs:
        raw = _raw(b)
        parts.append(struct.pack(">Q", raw.nbytes))
        parts.append(raw)
    payload = b"".join(parts)
    sock.sendall(payload)
    return len(payload)


def recv_frame(sock: socket.socket
               ) -> Optional[Tuple[dict, List[torch.Tensor]]]:
    """The inverse of send_frame: (header, CPU tensors); None on a clean
    EOF (the sender shut down)."""
    magic = _recv_exact(sock, 4)
    if magic is None:
        return None
    if magic != MAGIC:
        raise ConnectionError(f"bad page-stream magic {bytes(magic)!r} "
                              f"(framing desync)")
    (hlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    blobs = []
    for meta in header.get("blobs", []):
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"page-stream blob dtype {meta['dtype']!r} is "
                             f"not one of {sorted(_DTYPES)}")
        dtype = _DTYPES[meta["dtype"]]
        (blen,) = struct.unpack(">Q", _recv_exact(sock, 8))
        raw = _recv_exact(sock, blen) if blen else None
        t = (torch.frombuffer(raw, dtype=dtype) if raw is not None
             else torch.empty(0, dtype=dtype))
        blobs.append(t.reshape(meta["shape"]))
    return header, blobs


def _unflatten_kv(kind: str, blobs: list):
    if kind == "int8":
        return (blobs[0], blobs[1]), (blobs[2], blobs[3])
    return blobs[0], blobs[1]


def send_handoff(sock: socket.socket, h: dict, k, v, kv_dtype,
                 page_size: int, ctx=None) -> int:
    """Ship one staged `PagedEngine` handoff (its `export_handoff` payload)
    as a frame; returns the bytes sent. `ctx`: the prefill side's
    `RequestTracer.export_context`. submit_t / first_token_t ride along
    for a receiver in this process (the same clock: TTFT spans the whole
    disaggregated path); a receiver on another host must drop them."""
    req = h["req"]
    blobs = kv_leaves(k, v)
    header = {
        "rid": req.rid, "prompt": list(req.prompt),
        "tokens": list(req.tokens), "max_new": req.max_new,
        "seed": req.seed, "tenant": req.tenant,
        "slo_class": req.slo_class, "arrival": req.arrival,
        "submit_t": req.submit_t, "first_token_t": req.first_token_t,
        "first": int(h["first"]), "n_tokens": int(h["n_tokens"]),
        "pages": len(h["pages"]), "page_size": int(page_size),
        "kv": kv_dtype or "native",
        "trace_ctx": ctx.to_wire() if ctx is not None else None,
        "t_send": time.monotonic(),
        "blobs": [{"dtype": _NAMES[b.dtype], "shape": list(b.shape)}
                  for b in blobs],
    }
    return send_frame(sock, header, blobs)


def recv_handoff(sock: socket.socket):
    """One handoff: (req, first, k, v, header) with a fresh Request carrying
    the frame's trace context, or None on a clean EOF."""
    got = recv_frame(sock)
    if got is None:
        return None
    header, blobs = got
    req = Request(rid=int(header["rid"]), prompt=list(header["prompt"]),
                  max_new=int(header["max_new"]),
                  seed=int(header["seed"]), arrival=header["arrival"],
                  tenant=header["tenant"], slo_class=header["slo_class"],
                  trace_ctx=header.get("trace_ctx"))
    req.tokens = list(header.get("tokens", ()))
    req.submit_t = header.get("submit_t")
    req.first_token_t = header.get("first_token_t")
    k, v = _unflatten_kv(header["kv"], blobs)
    return req, int(header["first"]), k, v, header


def run_disaggregated(prefill: PagedEngine, decode: PagedEngine,
                      requests: List[Request]) -> dict:
    """Drive a prefill_only engine and a decode engine joined by a
    socketpair page stream until every request completes: the prefill
    thread steps its engine and streams each staged handoff, a receiver
    thread drains frames into an inbox, and the caller's thread admits and
    decodes (no free slot or a dry pool just parks a handoff until decoding
    retires something). Both engines may launch kernels on one card: the
    decode engine captured its decode step before the threads start, and
    every kernel launches on the calling thread's current stream.

    Returns {completed, transfers, wall_s, transferred_pages,
    transferred_bytes, bytes_per_request, transfer_ms_p50/p95}:
    `transfers` holds one {rid, pages, bytes, send_ms, transfer_ms} per
    handoff, transfer_ms from the send's start to the decode side's admit
    on the shared clock."""
    if prefill.pool.kv_dtype != decode.pool.kv_dtype:
        raise ValueError(
            f"kv_dtype mismatch across the stream: prefill side "
            f"{prefill.pool.kv_dtype or 'native'}, decode side "
            f"{decode.pool.kv_dtype or 'native'}")
    if prefill.page_size != decode.page_size:
        raise ValueError(
            f"page_size mismatch across the stream: {prefill.page_size} "
            f"vs {decode.page_size} (pages are the transfer unit)")
    a, b = socket.socketpair()
    transfers: List[dict] = []
    inbox: deque = deque()
    eof = threading.Event()
    errors: List[BaseException] = []
    t0 = time.monotonic()

    def prefill_side():
        try:
            for req in sorted(requests, key=lambda r: r.arrival):
                prefill.submit(req)
            while prefill.has_work() or prefill.handoffs:
                prefill.step()
                while prefill.handoffs:
                    h = prefill.handoffs.popleft()
                    k, v = prefill.export_handoff(h)
                    ctx = (prefill.rt.export_context(h["req"], "handoff")
                           if prefill.rt is not None else None)
                    ts = time.monotonic()
                    nbytes = send_handoff(a, h, k, v, prefill.pool.kv_dtype,
                                          prefill.page_size, ctx=ctx)
                    transfers.append({"rid": h["req"].rid,
                                      "pages": len(h["pages"]),
                                      "bytes": nbytes,
                                      "send_ms": (time.monotonic() - ts)
                                      * 1e3})
                    prefill.finish_handoff(h)
        except BaseException as e:          # raised again by the caller
            errors.append(e)
        finally:
            try:
                a.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def recv_side():
        try:
            while True:
                item = recv_handoff(b)
                if item is None:
                    break
                inbox.append(item)
        except BaseException as e:
            errors.append(e)
        finally:
            eof.set()

    threads = [threading.Thread(target=prefill_side, daemon=True),
               threading.Thread(target=recv_side, daemon=True)]
    for t in threads:
        t.start()
    pending: deque = deque()
    completed: List[Request] = []
    arrived_ms = {}                          # rid -> send start -> admit
    try:
        while not eof.is_set() or inbox or pending or decode.has_work():
            if errors:
                break
            while inbox:
                pending.append(inbox.popleft())
            progressed = False
            while pending:
                req, first, k, v, header = pending[0]
                try:
                    decode.admit_prefilled(req, k, v, first)
                except (RuntimeError, PoolExhausted):
                    break                    # backpressure: decode first
                pending.popleft()
                progressed = True
                if header.get("t_send") is not None:
                    arrived_ms[req.rid] = (time.monotonic()
                                           - header["t_send"]) * 1e3
                if req.finish_t is not None:  # completed at admission
                    completed.append(req)
            if decode.has_work():
                completed.extend(decode.step())
                progressed = True
            if not progressed:
                time.sleep(POLL_S)
    finally:
        # unblock the threads on an early exit before joining them
        for s in (a, b):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in threads:
            t.join(timeout=30)
        a.close()
        b.close()
    if errors:
        raise errors[0]
    for rec in transfers:
        if rec["rid"] in arrived_ms:
            rec["transfer_ms"] = arrived_ms[rec["rid"]]
    # max_new == 0 requests complete on the prefill side, with no handoff
    completed.extend(prefill.completed)
    wall = time.monotonic() - t0
    byt = [t["bytes"] for t in transfers]
    tms = sorted(t.get("transfer_ms", t["send_ms"]) for t in transfers)
    return {
        "completed": completed,
        "transfers": transfers,
        "wall_s": wall,
        "transferred_pages": sum(t["pages"] for t in transfers),
        "transferred_bytes": sum(byt),
        "bytes_per_request": (sum(byt) / len(byt)) if byt else 0.0,
        "transfer_ms_p50": round(nearest_rank(tms, 0.50), 3),
        "transfer_ms_p95": round(nearest_rank(tms, 0.95), 3),
    }
