"""The port's serving fleet (PyTorch) against the JAX package's.

The shapes of tests/test_fleet.py: d 32, 8 heads, 2 layers, vocab 96,
buffer 32, pages of 8, six prompts behind one full shared page, f32, tp 1,
one exported init (`interop.params_from_jax`). Every JAX run is built once
for the module (`jref`).

* `PagedKVPool.export_pages` / `import_pages`: import -> export bitwise on
  native and int8 pools, and the port's export equal to JAX's of the same
  pages written from the same numpy arrays; a rollback on PoolExhausted and
  JAX's four refusals, with JAX's messages; tp / cp > 1 refused.
* `FleetRouter`: the shadow's predicted hits equal the replicas' actual
  `prefix_hit_tokens` on the shared-prefix burst; picks and predicted hits
  equal JAX's router's on the same stream (`run_fleet_loadgen`), and the
  fleet's tokens equal JAX's fleet and the port's single engine; the
  least-loaded tiebreak; session affinity with a loud `session_spill`.
* `run_disaggregated`: tokens equal the port's colocated engine and JAX's
  `run_disaggregated`, native and int8 pages, with the transfer accounting;
  sampled (port only: the draws are the port's hash) and the gpt2 family
  (port only) equal their colocated runs; mismatched wires refused.
* The wire both ways: JAX's frames decoded by the port and decoded on to
  JAX's colocated tokens, the port's frames read by JAX's `recv_handoff`,
  and bf16 blobs bit for bit in both directions.
* `serve_fleet --dry_run` (fleet and `--disagg`): JAX's summary keys, less
  `transfer_pricing`; its refusals.
* `ops/cuda/build.load` builds a source once when two threads ask at once.
"""

import ctypes
import ctypes.util
import json
import threading
import time
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving import (
    kv_manager as jkv_manager)
from distributed_pytorch_from_scratch_tpu.serving import loadgen as jloadgen
from distributed_pytorch_from_scratch_tpu.serving import router as jrouter
from distributed_pytorch_from_scratch_tpu.serving import (
    transfer as jtransfer)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import build
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import (
    serve_fleet, transfer)
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
    PagedKVPool, PoolExhausted)
from distributed_pytorch_from_scratch_tpu_torch.serving.loadgen import (
    run_fleet_loadgen)
from distributed_pytorch_from_scratch_tpu_torch.serving.router import (
    FleetRouter)
from distributed_pytorch_from_scratch_tpu_torch.serving.scheduler import (
    QueueFull)
from distributed_pytorch_from_scratch_tpu_torch.training.metrics import (
    MetricsWriter)
from _torch_threads import two_torch_threads  # noqa: F401


SHAPE = dict(attn_dim=32, ffn_dim=64, num_heads=8, num_layers=2,
             vocab_size=96, maxlen=64)
BUF, EOS, PS = 32, 1, 8
# one full shared page (PS tokens) + distinct tails
_BASE = [0, 5, 17, 33, 60, 2, 4, 6]
PROMPTS = [_BASE + [7], _BASE + [9, 11], _BASE + [3, 5, 7, 11],
           _BASE + [13], _BASE + [21, 23], _BASE + [25]]
MAX_NEW = 8
CPU = make_mesh(MeshConfig(), device="cpu")
# the keys scripts/serve_fleet.py adds to run_disaggregated's summary
# (`transfer_pricing` prices a TPU's interconnect: not in the port)
JAX_DISAGG_CLI_KEYS = {"mode", "prefill_tp", "decode_tp", "completed",
                       "generated_tokens", "page_bytes", "transfer_pricing"}


def _reqs(cls, max_new=MAX_NEW, rid0=0, **kw):
    return [cls(rid=rid0 + i, prompt=list(p), max_new=max_new, seed=i, **kw)
            for i, p in enumerate(PROMPTS)]


def _tokens(reqs):
    return {r.rid: list(r.tokens) for r in reqs}


@pytest.fixture(scope="module")
def tree():
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1)
    return jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))


def _model(tree):
    model = build_model("llama", ModelConfig(**SHAPE))
    model.load_state_dict(params_from_jax(tree))
    return model


def _engine(model, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", PS)
    kw.setdefault("prefill_chunk", kw["page_size"])
    return PagedEngine(model, CPU, buf_len=BUF, eos_id=EOS, **kw)


def _jengine(tree, **kw):
    jmodel = JTransformer(JModelConfig(**SHAPE), tp_size=1)
    mesh = jmake_mesh(JMeshConfig(tp=1))
    kw.setdefault("num_slots", 4)
    return jengine.PagedEngine(
        jmodel, mesh, jax.device_put(tree, jmodel.shardings(mesh)),
        buf_len=BUF, eos_id=EOS, page_size=PS, prefill_chunk=PS, **kw)


def _assert_drained(eng):
    assert eng.pool.free_pages == eng.pool.num_pages, (
        eng.pool.free_pages, eng.pool.num_pages)
    assert (eng.pool.refcount == 0).all()
    assert not eng.pool._children and not eng.pool._page_keys


class _Tape:
    """A socket stand-in: `sendall` appends, `recv` reads back in order."""

    def __init__(self, data=b""):
        self.buf, self.pos = bytearray(data), 0

    def sendall(self, b):
        self.buf.extend(bytes(b))

    def recv(self, n):
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += len(out)
        return out


@pytest.fixture(scope="module")
def jref(tree):
    """Every JAX run the tests compare with, once: the colocated engine's
    tokens, the 2-replica fleet (picks, predicted hits, tokens, summary
    keys), and `run_disaggregated` native and int8 (tokens, summary keys,
    the native run's frames as sent)."""
    out = {}
    # one engine serves the colocated run, then as the fleet's first
    # replica, then as the native stream's decode side: drained between
    # runs, it compiles its programs once
    single = _jengine(tree)
    for r in _reqs(jengine.Request):
        single.submit(r)
    single.run_to_completion()
    out["coloc"] = _tokens(single.completed)
    router = jrouter.FleetRouter([single, _jengine(tree)],
                                 prefix_weight=0.5)
    reqs = _reqs(jengine.Request)
    summary = jloadgen.run_fleet_loadgen(router, reqs,
                                         session_key=lambda r: None)
    out["fleet"] = {
        "predicted": dict(router.predicted), "keys": set(summary),
        "per_replica_keys": set(summary["per_replica"]["r0"]),
        "tokens": _tokens(reqs)}
    frames = []
    send = jtransfer.send_handoff

    def taped(sock, *a, **kw):
        tape = _Tape()
        n = send(tape, *a, **kw)
        frames.append(bytes(tape.buf))
        sock.sendall(tape.buf)
        return n

    jtransfer.send_handoff = taped
    try:
        for kv in (None, "int8"):
            res = jtransfer.run_disaggregated(
                _jengine(tree, kv_dtype=kv, prefill_only=True),
                _jengine(tree, kv_dtype=kv) if kv else single,
                _reqs(jengine.Request))
            out[("disagg", kv)] = _tokens(res["completed"])
            out["disagg_keys"] = set(res)
            if kv is None:
                out["frames"] = list(frames)
    finally:
        jtransfer.send_handoff = send
    return out


# --------------------------------------------- page export / import ---

def _pools(kv_dtype, num_pages=8, dtype="float32"):
    """(port pool, JAX pool) of one shape, both empty."""
    cfg = dict(SHAPE, compute_dtype=dtype)
    port = PagedKVPool(
        SimpleNamespace(cfg=ModelConfig(**cfg), cp_size=1,
                        num_local_kv_heads=SHAPE["num_heads"]), CPU,
        num_pages, PS, kv_dtype=kv_dtype)
    jax_pool = jkv_manager.PagedKVPool(
        SimpleNamespace(cfg=JModelConfig(**cfg), cp_size=1),
        jmake_mesh(JMeshConfig(tp=1)), num_pages, PS, kv_dtype=kv_dtype)
    return port, jax_pool


def _payload(pool, n, rng):
    """Random numpy arrays shaped as `n` pages of the JAX pool's tensors."""
    def one(a):
        shape = (a.shape[0], n) + tuple(a.shape[2:])
        if np.issubdtype(np.dtype(a.dtype), np.integer):
            return rng.integers(-100, 100, shape).astype(a.dtype)
        return rng.standard_normal(shape).astype(a.dtype)
    return tuple(jax.tree.map(one, x) for x in (pool.ks, pool.vs))


def _flat(kv):
    return [np.asarray(a) for x in kv for a in
            (x if isinstance(x, tuple) else (x,))]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_export_import_roundtrip_matches_jax(kv_dtype):
    """Written from the same numpy arrays, the port's pool exports them
    back bit for bit, leases the same page ids as JAX's and exports what
    JAX's exports; a second pool takes the payload on unchanged."""
    rng = np.random.default_rng(3)
    port, jpool = _pools(kv_dtype)
    k, v = _payload(jpool, 3, rng)
    pages = port.import_pages(k, v)
    assert pages == jpool.import_pages(k, v) == [0, 1, 2]
    assert port.free_pages == port.num_pages - 3
    got = port.export_pages([2, 0])
    want = jpool.export_pages([2, 0])
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    k1, v1 = port.export_pages(pages)
    for a, b in zip(_flat((k1, v1)), _flat((k, v))):
        assert np.array_equal(a, b)
    second, _ = _pools(kv_dtype)
    for a, b in zip(_flat(second.export_pages(second.import_pages(k1, v1))),
                    _flat((k, v))):
        assert np.array_equal(a, b)
    assert (port.refcount[pages] == 1).all()          # export leases nothing
    for p in pages:
        port.unref(p)
    assert port.free_pages == port.num_pages


def test_import_rollback_and_refusals_match_jax():
    """A pool too dry for the payload returns every page it leased before
    PoolExhausted; the four refusals raise JAX's errors; a pool sharded
    over tp or cp refuses both methods (ROADMAP item 6)."""
    rng = np.random.default_rng(4)
    port, jpool = _pools(None)
    held = port.import_pages(*_payload(jpool, 3, rng))
    with pytest.raises(PoolExhausted):
        port.import_pages(*_payload(jpool, 6, rng))   # 6 > 5 free
    assert port.free_pages == port.num_pages - 3
    port8, jpool8 = _pools("int8")
    ps16, jps16 = _pools(None)
    cases = [
        ((port, jpool), _payload(jpool8, 1, rng), {}),            # int8 in
        ((port8, jpool8), _payload(jpool, 1, rng), {}),           # native in
        ((port, jpool), tuple(a[:, :, :, :4] for a in
                              _payload(jpool, 1, rng)), {}),      # page 4
        ((port, jpool), tuple(a[..., :2] for a in
                              _payload(jpool, 1, rng)), {}),      # head_dim
        ((port, jpool), _payload(jpool, 2, rng), {"owners": [0]}),
    ]
    for (p, j), (k, v), kw in cases:
        with pytest.raises(ValueError) as want:
            j.import_pages(k, v, **kw)
        with pytest.raises(ValueError) as got:
            p.import_pages(k, v, **kw)
        assert str(got.value) == str(want.value)
    assert port.free_pages == port.num_pages - 3
    for p in held:
        port.unref(p)
    wide = PagedKVPool(SimpleNamespace(cfg=ModelConfig(**SHAPE), cp_size=1,
                                       num_local_kv_heads=4),
                       SimpleNamespace(device=torch.device("cpu"), tp=2),
                       8, PS)
    for call in (lambda: wide.export_pages([0]),
                 lambda: wide.import_pages(*_payload(jpool, 1, rng))):
        with pytest.raises(NotImplementedError, match="item 6"):
            call()


# ------------------------------------------------------ the router ---

def test_shadow_prediction_equals_actual_prefix_hits(tree):
    """On the shared-prefix burst (slots >= burst: every donor live) the
    shadow predicts each replica's prefix_hit_tokens exactly."""
    router = FleetRouter([_engine(_model(tree), num_slots=8),
                          _engine(_model(tree), num_slots=8)])
    for r in _reqs(Request):
        router.submit(r)
    router.run_to_completion()
    predicted = {}
    for name, hit in router.predicted.values():
        predicted[name] = predicted.get(name, 0) + hit
    for name, eng in router.replicas:
        assert predicted.get(name, 0) == eng.prefix_hit_tokens, (
            name, predicted, eng.prefix_hit_tokens)
        _assert_drained(eng)
    assert sum(predicted.values()) >= PS
    assert router.stats()["dispatch_ms_p50"] < 1.0


def test_fleet_matches_jax_router_and_single_engine(tree, jref):
    """The same stream through `run_fleet_loadgen` (the single engine,
    drained, as the first replica, as in `jref`): every pick and predicted
    hit equals JAX's router's, the tokens equal JAX's fleet and the port's
    single engine, the summary has JAX's keys."""
    model = _model(tree)
    single = _engine(model)
    for r in _reqs(Request):
        single.submit(r)
    single.run_to_completion()
    assert _tokens(single.completed) == jref["coloc"]
    router = FleetRouter([single, _engine(model)], prefix_weight=0.5)
    reqs = _reqs(Request)
    summary = run_fleet_loadgen(router, reqs, session_key=lambda r: None)
    assert router.predicted == jref["fleet"]["predicted"]
    assert min(router.dispatched.values()) >= 1, router.dispatched
    assert _tokens(reqs) == jref["fleet"]["tokens"] == jref["coloc"]
    assert set(summary) == jref["fleet"]["keys"]
    assert set(summary["per_replica"]["r0"]) == jref["fleet"][
        "per_replica_keys"]
    assert summary["completed"] == len(PROMPTS)
    # the live counters hold the first replica's colocated run too
    assert sum(c["completed"] for c in
               summary["fleet_slo_attainment"].values()) == 2 * len(PROMPTS)
    for _, e in router.replicas:
        _assert_drained(e)


def test_router_least_loaded_tiebreak(tree):
    """No prefix signal: equal scores break by replica order, then a
    queued request tips the load term toward the idle replica."""
    router = FleetRouter([_engine(_model(tree), num_slots=2),
                          _engine(_model(tree), num_slots=2)])
    assert router.submit(Request(rid=0, prompt=[2, 9, 21], max_new=2)) == "r0"
    assert router.submit(Request(rid=1, prompt=[5, 13, 37], max_new=2)) == "r1"
    router.run_to_completion()
    for _, e in router.replicas:
        _assert_drained(e)


def test_replace_replica_resets_its_shadow(tree, jref, tmp_path):
    """A restarted replica starts with an empty shadow under its old name,
    sessions keep their pin, a `replica_restart` event is written, and
    the next batch still gets the single engine's tokens."""
    w = MetricsWriter(str(tmp_path), process_index=0)
    model = _model(tree)
    router = FleetRouter([_engine(model), _engine(model)], writer=w)
    for r in _reqs(Request):
        router.submit(r, session="s")
    router.run_to_completion()
    pinned = router._sessions["s"]
    # one more request of the session: its prompt registers in the shadow
    router.submit(Request(rid=50, prompt=PROMPTS[0], max_new=1),
                  session="s")
    assert router.predict(pinned, PROMPTS[0]) > 0
    router.replace_replica(pinned, _engine(model))
    assert router.predict(pinned, PROMPTS[0]) == 0
    assert router._sessions["s"] == pinned
    reqs = _reqs(Request, rid0=100)
    for r in reqs:
        router.submit(r, session="s")
    router.run_to_completion()
    assert {r.rid - 100: list(r.tokens) for r in reqs} == jref["coloc"]
    w.close()
    evs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [e["replica"] for e in evs if e["tag"] == "replica_restart"] == [
        pinned]


def test_session_affinity_and_loud_spill(tree, tmp_path):
    """A session sticks to its replica; a full one spills the request to
    the next best with a `session_spill` event; only a fleet-wide refusal
    reaches the caller."""
    w = MetricsWriter(str(tmp_path), process_index=0)
    model = _model(tree)
    router = FleetRouter([_engine(model, num_slots=1, max_queue=1),
                          _engine(model, num_slots=1, max_queue=1)],
                         writer=w)
    first = router.submit(Request(rid=0, prompt=[0, 9, 21], max_new=2),
                          session="s1")
    spilled = router.submit(Request(rid=1, prompt=[0, 13, 37], max_new=2),
                            session="s1")
    assert spilled != first and router.spills == 1
    with pytest.raises(QueueFull):
        router.submit(Request(rid=2, prompt=[0, 2, 4], max_new=2))
    assert router.rejected == 1
    router.run_to_completion()
    w.close()
    evs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    spill = [e for e in evs if e.get("tag") == "session_spill"]
    assert len(spill) == 1
    assert spill[0]["session"] == "s1" and spill[0]["pinned"] == first
    with pytest.raises(NotImplementedError, match="item 8"):
        FleetRouter([router.replicas[0][1]], telemetry=object())


# ------------------------------------- disaggregated prefill/decode ---

def _disagg(model, kv_dtype=None, reqs=None, **kw):
    pre = _engine(model, kv_dtype=kv_dtype, prefill_only=True, **kw)
    dec = _engine(model, kv_dtype=kv_dtype, **kw)
    out = transfer.run_disaggregated(pre, dec, reqs or _reqs(Request))
    return pre, dec, out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disagg_matches_colocated_and_jax(tree, jref, kv_dtype):
    model = _model(tree)
    coloc = _engine(model, kv_dtype=kv_dtype)
    for r in _reqs(Request):
        coloc.submit(r)
    coloc.run_to_completion()
    pre, dec, out = _disagg(model, kv_dtype)
    got = _tokens(out["completed"])
    assert got == _tokens(coloc.completed) == jref[("disagg", kv_dtype)]
    if kv_dtype is None:
        assert got == jref["coloc"]
    assert set(out) == jref["disagg_keys"]
    assert len(out["transfers"]) == len(PROMPTS)
    assert out["transferred_pages"] == sum(
        -(-len(p) // PS) for p in PROMPTS)
    assert pre.pages_exported == dec.pages_imported == out[
        "transferred_pages"]
    assert pre.handoffs_staged == len(PROMPTS)
    assert not pre.decode_steps and pre._decode_graph is None
    for t in out["transfers"]:
        assert t["transfer_ms"] >= 0
    for eng in (pre, dec, coloc):
        _assert_drained(eng)


def test_disagg_sampled_and_gpt2_match_colocated(tree):
    """Port only: sampled draws hash (seed, position), so a handoff keeps
    them; and the gpt2 family hands off as llama does."""
    gpt2 = build_model("gpt2", ModelConfig(**SHAPE)).init_weights(5)
    for model, kw in ((_model(tree), dict(temperature=0.9, top_p=0.9)),
                      (gpt2, {})):
        coloc = _engine(model, **kw)
        for r in _reqs(Request):
            coloc.submit(r)
        coloc.run_to_completion()
        pre, dec, out = _disagg(model, **kw)
        assert _tokens(out["completed"]) == _tokens(coloc.completed)
        assert any(_tokens(coloc.completed).values())
        for eng in (pre, dec):
            _assert_drained(eng)


def test_disagg_prefill_pool_smaller_than_the_burst(tree, jref):
    """A prefill-only engine hands each prefill off as it finishes, so a
    burst whose prompts together outgrow its pool still streams through
    (staged handoffs hold their pages until they are sent)."""
    model = _model(tree)
    pre = _engine(model, prefill_only=True, num_pages=3)
    dec = _engine(model)
    out = transfer.run_disaggregated(pre, dec, _reqs(Request))
    assert _tokens(out["completed"]) == jref["coloc"]
    for eng in (pre, dec):
        _assert_drained(eng)


def test_disagg_refuses_mismatched_wire(tree):
    model = _model(tree)
    pre = _engine(model, prefill_only=True)
    with pytest.raises(ValueError, match="kv_dtype mismatch"):
        transfer.run_disaggregated(pre, _engine(model, kv_dtype="int8"),
                                   _reqs(Request))
    with pytest.raises(ValueError, match="page_size mismatch"):
        transfer.run_disaggregated(pre, _engine(model, page_size=16),
                                   _reqs(Request))


# ------------------------------------------------------- the wire ---

def _admit_all(eng, items):
    """Admit (req, first, k, v) handoffs, decoding whenever the engine
    pushes back, until everything completes."""
    pending = list(items)
    while pending or eng.has_work():
        while pending:
            req, first, k, v = pending[0]
            try:
                eng.admit_prefilled(req, k, v, first)
            except (RuntimeError, PoolExhausted):
                break
            pending.pop(0)
        eng.step()
    return _tokens(eng.completed)


def test_wire_jax_frames_decode_in_the_port(tree, jref):
    """JAX's frames, as its run_disaggregated sent them, read by the port
    and decoded on to JAX's colocated tokens."""
    tape = _Tape(b"".join(jref["frames"]))
    items = []
    while (got := transfer.recv_handoff(tape)) is not None:
        req, first, k, v, header = got
        assert header["kv"] == "native" and k.dtype == torch.float32
        items.append((req, first, k, v))
    assert len(items) == len(PROMPTS)
    dec = _engine(_model(tree))
    assert _admit_all(dec, items) == jref["coloc"]
    _assert_drained(dec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_port_frames_read_by_jax(dtype):
    """A port frame read by JAX's recv_handoff (bf16 through ml_dtypes),
    and a JAX bf16/f32 frame read by the port: the same bits."""
    rng = np.random.default_rng(5)
    port, jpool = _pools(None, dtype=dtype)
    k, v = (torch.from_numpy(a).to(port.dtype)
            for a in _payload(_pools(None)[1], 2, rng))
    pages = port.import_pages(k, v)
    req = Request(rid=9, prompt=list(range(3, 3 + PS + 4)), max_new=5,
                  seed=11, tenant="t1", slo_class="batch")
    h = {"req": req, "pages": pages, "first": 42, "n_tokens": PS + 4}
    tape = _Tape()
    ek, ev = port.export_pages(pages)
    transfer.send_handoff(tape, h, ek, ev, None, PS)
    jreq, first, jk, jv, header = jtransfer.recv_handoff(tape)
    assert (jreq.rid, jreq.prompt, jreq.max_new, jreq.seed, jreq.tenant,
            jreq.slo_class, first) == (9, req.prompt, 5, 11, "t1", "batch",
                                       42)
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16
                            else torch.int32).numpy()
    jbits = lambda a: a.view(np.int16 if a.dtype == ml_dtypes.bfloat16
                             else np.int32)
    assert header["blobs"][0]["dtype"] == dtype
    for a, b in ((ek, jk), (ev, jv)):
        assert np.array_equal(bits(a), jbits(np.asarray(b)))
    # and back: JAX's send_frame of the arrays JAX read, read by the port
    tape = _Tape()
    jtransfer.send_frame(tape, {"blobs": [
        {"dtype": np.asarray(b).dtype.name, "shape": list(b.shape)}
        for b in (jk, jv)]}, [jk, jv])
    _, blobs = transfer.recv_frame(tape)
    for a, b in zip(blobs, (ek, ev)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------- the CLI ---

def test_serve_fleet_dry_runs_give_jax_keys(jref, tmp_path, capsys):
    fleet = serve_fleet.main(["--dry_run", "--device", "cpu", "--log_dir",
                              str(tmp_path)])
    assert set(fleet) - {"device"} == jref["fleet"]["keys"] | {"mode"}
    assert fleet["completed"] == fleet["requests"] == 8
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "serve_fleet x2" and rec["device"] == "cpu"
    dis = serve_fleet.main(["--dry_run", "--device", "cpu", "--disagg",
                            "--log_dir", str(tmp_path)])
    extras = {"device", "ttft_ms_p50", "ttft_ms_p95", "tpot_ms_p50",
              "tpot_ms_p95"}
    assert set(dis) - extras == (jref["disagg_keys"] | JAX_DISAGG_CLI_KEYS
                                 ) - {"transfer_pricing"}
    assert dis["completed"] == 8
    assert dis["transferred_bytes"] > dis["transferred_pages"] * dis[
        "page_bytes"]


@pytest.mark.parametrize("flags,tag", [
    (["--tp_size", "2"], "item 6"), (["--prefill_tp", "2", "--disagg"],
                                     "item 6"),
    (["--restart_tp", "2"], "item 6"), (["--trace_requests"], "item 8")])
def test_serve_fleet_refusals(flags, tag, capsys):
    with pytest.raises(SystemExit):
        serve_fleet.parse_args(["--dry_run", "--device", "cpu"] + flags)
    assert tag in capsys.readouterr().err


# ------------------------------------------- thread-safe kernel load ---

def test_kernel_load_builds_once_from_two_threads(monkeypatch):
    """Two threads loading one source at once: one build, one library."""
    calls = []
    libc = ctypes.util.find_library("c") or "libc.so.6"

    def slow_build(names):
        calls.append(list(names))
        time.sleep(0.05)
        return [build.BuildResult(names[0], libc, 0.0, "")]

    monkeypatch.setattr(build, "build", slow_build)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.load("stub")))
               for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        build._LOADED.pop("stub", None)
    assert not any(t.is_alive() for t in threads)
    assert calls == [["stub"]]
    assert len(got) == 2 and got[0] is got[1]
    assert isinstance(got[0], ctypes.CDLL)
