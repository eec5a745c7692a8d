"""The port's serving observability and control plane (`obs/`,
`serving/controller.py`, the engines' hooks, `serve.py`'s flags) against
the JAX package's, at the tiny preset (d 128, 4 heads, 2 layers, vocab
1024) in float32.

Engine runs go under one scripted counting clock per side (the engine,
its scheduler, the request tracer, the flight recorder and the exporter
all read it), so a port run and a JAX run that call it at the same sites
see the same times, and the records compare exactly.

(e) request timelines: the paged engine through preemption and
    copy-on-write, the slot engine and the speculative engine give, per
    request, the JAX engine's `request_trace` record (span names, counts,
    durations, page counters) exactly, and the span sum equals the wall;
(f) every line the port writes (the engines' streams, `serve` with every
    obs flag, `serve_fleet --trace_requests` at tp 2, the rotation chain)
    passes JAX's `obs/schema.validate_jsonl`;
(g) `merge_traces` equals JAX's on the same records: the skewed three-hop
    pin, and the port's real router -> prefill -> decode path;
(h) the flight ring's record kinds equal JAX's through the preemption
    run; the dump fires on a PoolExhausted preemption and, once, on an
    SLO collapse, as JAX's;
(i) telemetry: the endpoint on port 0, scraped mid-run from another
    thread, answers JSON and Prometheus text; the final gauges and
    counters equal JAX's (the device-memory plane unavailable on the
    CPU, as JAX's is); the metrics stream rotates through schema-valid
    `rotated` events that JAX's tailer follows;
(j) `SLOController` against JAX's on one fake engine and clock: the same
    decisions (knob, trigger, old, new, applied, snapshot_seq); advise
    never mutates; a speculative engine's k follows an act decision;
(k) at tp 2 (two gloo ranks) a paged run with every obs flag and
    `--control act` gives the tokens of the run with obs off;
(l) off costs nothing: no file, no event, no record field.
"""

import glob
import itertools
import json
import os
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu import obs as jobs_
from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.obs.collector import JsonlTailer
from distributed_pytorch_from_scratch_tpu.obs.schema import (
    validate_jsonl as jvalidate_jsonl)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving import (
    controller as jcontroller)
from distributed_pytorch_from_scratch_tpu.serving import (
    speculative as jspeculative)
from distributed_pytorch_from_scratch_tpu.training.metrics import (
    MetricsWriter as JMetricsWriter)
from distributed_pytorch_from_scratch_tpu_torch import obs
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import (
    controller, serve, serve_fleet)
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
    SpeculativeEngine)
from distributed_pytorch_from_scratch_tpu_torch.serving.transfer import (
    run_disaggregated)
from distributed_pytorch_from_scratch_tpu_torch.training.metrics import (
    MetricsWriter)
from _torch_threads import two_torch_threads  # noqa: F401


TINY = dict(attn_dim=128, ffn_dim=512, num_heads=4, num_layers=2,
            vocab_size=1024, maxlen=256)
DRAFTER = dict(attn_dim=32, ffn_dim=64, num_heads=1, num_layers=1,
               vocab_size=1024, maxlen=256)
BUF, EOS, TICK = 32, 1, 0.02
CPU = make_mesh(MeshConfig(), device="cpu")
SHARED = [0, 5, 9, 60]
# the JAX preempt-resume recipe: a pool too small for combined growth
PREEMPT = dict(num_slots=3, buf_len=BUF, eos_id=EOS, page_size=8,
               num_pages=4, prefill_chunk=8)
PREEMPT_PROMPTS = [SHARED + [2, 8, 33], SHARED + [4, 7, 21],
                   SHARED + [17, 8, 52]]
SLOT = dict(num_slots=2, buf_len=BUF, eos_id=EOS, prefill_bucket=8)
SLOT_PROMPTS = [[0, 5, 17, 33], [0, 9, 11], [0, 3, 5, 7, 11]]
SPEC = dict(num_slots=2, buf_len=BUF, eos_id=EOS, speculate_k=2,
            page_size=8, prefill_chunk=8)
SPEC_PROMPTS = [[0, 5, 17, 33, 60], [0, 9, 11, 4]]
# an impossible deadline: the class collapses after 4 completions
COLLAPSE = dict(num_slots=3, buf_len=BUF, eos_id=EOS, page_size=8,
                prefill_chunk=8, default_class="interactive",
                slo_classes={"interactive": 1e-9, "batch": 60.0})
COLLAPSE_PROMPTS = [[0, 3 + i, 7, 11, 4 + i] for i in range(6)]
DRY_PAGED = ["--dry_run", "--device", "cpu", "--paged"]
OBS_FLAGS = ["--trace_requests", "--flight_records", "--metrics_port", "0",
             "--control", "act", "--control_interval", "2"]
TP2 = ["--tp_size", "2", "--dist_backend", "gloo"]
WALL = lambda: 1000.0                              # noqa: E731


def counting(tick=TICK):
    """0, tick, 2 tick, ...: one step per call."""
    count = itertools.count()
    return lambda: next(count) * tick


def _kit(pkg, log_dir, clock):
    """One side's obs objects on one clock: writer, request tracer, flight
    recorder, headless exporter (its rate clock a counter of its own)."""
    Writer = JMetricsWriter if pkg is jobs_ else MetricsWriter
    w = Writer(log_dir, process_index=0)
    fl = pkg.FlightRecorder(log_dir, maxlen=256, clock=clock)
    rt = pkg.RequestTracer(writer=w, flight=fl, clock=clock, wall=WALL)
    tel = pkg.TelemetryExporter(writer=w, clock=counting(), wall=WALL)
    return dict(writer=w, request_tracer=rt, flight=fl, telemetry=tel)


def _reqs(cls, prompts, max_new, **kw):
    return [cls(rid=i, prompt=list(p), max_new=max_new, **kw)
            for i, p in enumerate(prompts)]


def _close(kit):
    kit["telemetry"].close()
    kit["writer"].close()


def _run(eng, reqs, kit):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    _close(kit)
    return {r.rid: kit["request_tracer"].timeline(r.rid) for r in reqs}


def _dumps(log_dir):
    return [json.load(open(p)) for p in
            sorted(glob.glob(os.path.join(log_dir, "flightdump_*.json")))]


def _jax_side(jparams, jdparams, root):
    """JAX's runs, one per case: {case: (records, the exporter's final
    registry, the flight dumps, the ring's kinds)}."""
    out = {}
    jm = JTransformer(JModelConfig(**TINY), tp_size=1)
    mesh = jmake_mesh(JMeshConfig(tp=1))
    params = jax.device_put(jparams, jm.shardings(mesh))
    for case in ("preempt", "slot", "spec", "collapse"):
        d = os.path.join(root, "jax", case)
        clock = counting()
        kit = _kit(jobs_, d, clock)
        if case == "slot":
            eng = jengine.ContinuousBatchingEngine(
                jm, mesh, params, clock=clock, **SLOT, **kit)
            reqs = _reqs(jengine.Request, SLOT_PROMPTS, 6)
        elif case == "spec":
            dm = JTransformer(JModelConfig(**DRAFTER), tp_size=1)
            eng = jspeculative.SpeculativeEngine(
                jm, mesh, params, dm, jax.device_put(jdparams,
                                                     dm.shardings(mesh)),
                clock=clock, paged_attn_impl="gather", **SPEC, **kit)
            reqs = _reqs(jengine.Request, SPEC_PROMPTS, 8)
        else:
            kw = PREEMPT if case == "preempt" else COLLAPSE
            eng = jengine.PagedEngine(jm, mesh, params, clock=clock,
                                      paged_attn_impl="gather", **kw, **kit)
            prompts = (PREEMPT_PROMPTS if case == "preempt"
                       else COLLAPSE_PROMPTS)
            reqs = _reqs(jengine.Request, prompts, 12 if case == "preempt"
                         else 6)
        recs = _run(eng, reqs, kit)
        out[case] = (recs, kit["telemetry"].snapshot(), _dumps(d),
                     [e["kind"] for e in kit["flight"].snapshot()])
    return out


def _port_side(tree, dtree, root, case):
    model = build_model("llama", ModelConfig(**TINY))
    model.load_state_dict(params_from_jax(tree))
    d = os.path.join(root, "port", case)
    clock = counting()
    kit = _kit(obs, d, clock)
    if case == "slot":
        eng = ContinuousBatchingEngine(model, CPU, clock=clock, **SLOT,
                                       **kit)
        reqs = _reqs(Request, SLOT_PROMPTS, 6)
    elif case == "spec":
        dm = build_model("llama", ModelConfig(**DRAFTER))
        dm.load_state_dict(params_from_jax(dtree))
        eng = SpeculativeEngine(model, CPU, dm, clock=clock, **SPEC, **kit)
        reqs = _reqs(Request, SPEC_PROMPTS, 8)
    else:
        kw = PREEMPT if case == "preempt" else COLLAPSE
        eng = PagedEngine(model, CPU, clock=clock, **kw, **kit)
        reqs = _reqs(Request, PREEMPT_PROMPTS if case == "preempt"
                     else COLLAPSE_PROMPTS, 12 if case == "preempt" else 6)
    return eng, reqs, kit, d


def _scrape(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obs"))
    jparams = JTransformer(JModelConfig(**TINY), tp_size=1).init(
        jax.random.key(3))
    jdparams = JTransformer(JModelConfig(**DRAFTER), tp_size=1).init(
        jax.random.key(9))
    tree = jax.tree.map(np.asarray, jparams)
    dtree = jax.tree.map(np.asarray, jdparams)
    cli_dir = os.path.join(root, "cli")
    with ThreadPoolExecutor(max_workers=2) as pool:
        tp2 = pool.submit(lambda: {
            "off": serve.main(DRY_PAGED + TP2 + ["--log_dir",
                                                 os.path.join(root, "off")]),
            "on": serve.main(DRY_PAGED + TP2 + OBS_FLAGS + [
                "--log_dir", os.path.join(cli_dir, "tp2")])})
        fleet = pool.submit(serve_fleet.main, [
            "--dry_run", "--device", "cpu", "--dist_backend", "gloo",
            "--tp_size", "2", "--disagg", "--trace_requests", "--log_dir",
            os.path.join(cli_dir, "fleet")])
        jax_out = _jax_side(jparams, jdparams, root)
        port = {}
        for case in ("preempt", "slot", "spec", "collapse"):
            eng, reqs, kit, d = _port_side(tree, dtree, root, case)
            scraped = {}
            if case == "preempt":
                port_n = kit["telemetry"].start(0)

                def scrape():
                    scraped["json"] = json.loads(_scrape(port_n,
                                                         "/metrics.json"))
                    scraped["prom"] = _scrape(port_n, "/metrics")

                for r in reqs:
                    eng.submit(r)
                while eng.has_work():
                    eng.step()
                    if not scraped and eng.decode_steps >= 2:
                        t = threading.Thread(target=scrape)
                        t.start()
                        t.join(timeout=30)
                _close(kit)
                recs = {r.rid: kit["request_tracer"].timeline(r.rid)
                        for r in reqs}
            else:
                recs = _run(eng, reqs, kit)
            port[case] = dict(recs=recs, eng=eng, reqs=reqs, dir=d,
                              snap=kit["telemetry"].snapshot(),
                              dumps=_dumps(d), scraped=scraped,
                              kinds=[e["kind"]
                                     for e in kit["flight"].snapshot()])
        cli = {"tp2": tp2.result(), "fleet": fleet.result()}
    return dict(root=root, jax=jax_out, port=port, cli=cli, tree=tree,
                cli_dir=cli_dir)


# ---- (e) ----

def _assert_contiguous(rec, req):
    cursor = 0.0
    for s in rec["spans"]:
        assert abs(s["start_ms"] - cursor) <= 0.01, (s, cursor)
        cursor = s["start_ms"] + s["dur_ms"]
    assert abs(cursor - rec["total_ms"]) <= 0.01
    assert abs(rec["total_ms"] - (req.finish_t - req.submit_t) * 1e3) <= 0.01


@pytest.mark.parametrize("case", ["preempt", "slot", "spec"])
def test_request_timelines_equal_jax(runs, case):
    got, want = runs["port"][case], runs["jax"][case][0]
    assert set(got["recs"]) == set(want)
    for rid, rec in got["recs"].items():
        assert rec == want[rid], (case, rid)
        req = next(r for r in got["reqs"] if r.rid == rid)
        _assert_contiguous(rec, req)
        names = [s["name"] for s in rec["spans"]]
        assert names[0] == "queued"
    names = {s["name"] for r in got["recs"].values() for s in r["spans"]}
    if case == "preempt":
        assert got["eng"].preemptions >= 1 and "preempted" in names
        assert got["eng"].pool.cow_copies >= 1
        assert any(r.get("cow_copies") for r in got["recs"].values())
    if case == "spec":
        assert {"spec_round", "drafter_prefill"} <= names
    assert got["eng"].rt.live == 0


# ---- (f) ----

def test_every_line_the_port_writes_validates_under_jax_schema(runs):
    paths = glob.glob(os.path.join(runs["root"], "port", "**",
                                   "metrics*.jsonl"), recursive=True)
    paths += glob.glob(os.path.join(runs["cli_dir"], "**",
                                    "metrics*.jsonl"), recursive=True)
    tags = set()
    for p in paths:
        assert jvalidate_jsonl(p) == [], p
        tags |= {json.loads(line)["tag"] for line in open(p)}
    assert {"request_trace", "serve_request", "telemetry_snapshot",
            "serving_summary", "request_exemplars", "hbm_watermark"} <= tags
    assert len(glob.glob(os.path.join(runs["cli_dir"], "fleet",
                                      "metrics*.jsonl"))) == 2


# ---- (g) ----

class _FakeReq:
    def __init__(self, rid):
        self.rid, self.trace_id, self.prompt = rid, None, [3, 4, 5]
        self.prompt_len, self.tokens = 3, []
        self.submit_t = self.first_token_t = self.finish_t = None
        self.ttft_s = self.tpot_s = None
        self.preemptions, self.tenant, self.slo_class = 0, "t0", None


def _three_hops(pkg):
    """The JAX three-hop pin (router +0 s, prefill +500 s, decode -312 s)
    with one package's tracers: the three records."""
    c = [[0.0], [0.0], [0.0]]
    skews = (0.0, 500.0, -312.0)
    rts = [pkg.RequestTracer(clock=lambda i=i: c[i][0],
                             wall=lambda i=i: 1000.0 + skews[i] + c[i][0],
                             process_index=i) for i in range(3)]
    r0 = _FakeReq(9)
    r0.submit_t = 0.0
    rts[0].begin(r0)
    c[0][0] = 0.010
    ctx = rts[0].export_context(r0, "route")
    recs = [rts[0].retire(r0, t=c[0][0])]
    r1 = _FakeReq(9)
    rts[1].begin(r1, ctx=pkg.TraceContext.from_wire(
        json.loads(json.dumps(ctx.to_wire()))))
    c[1][0] = 0.030
    rts[1].mark(r1, "prefill_chunk", positions=3)
    ctx = rts[1].export_context(r1, "handoff")
    recs.append(rts[1].retire(r1, t=c[1][0]))
    r2 = _FakeReq(9)
    rts[2].begin(r2, ctx=pkg.TraceContext.from_wire(ctx.to_wire()))
    c[2][0] = 0.040
    rts[2].mark(r2, "decode")
    r2.finish_t, r2.tokens = 0.040, [7, 8]
    recs.append(rts[2].retire(r2))
    return recs


def _contiguous(m):
    cursor = 0.0
    for s in m["spans"]:
        assert s["start_ms"] == pytest.approx(cursor, abs=0.01)
        cursor += s["dur_ms"]
    assert cursor == pytest.approx(m["total_ms"], abs=0.01)


def test_merge_traces_equals_jax_on_the_skewed_three_hops():
    port, want = _three_hops(obs), _three_hops(jobs_)
    assert port == want
    m = obs.merge_traces(port)
    assert m == jobs_.merge_traces(want)
    _contiguous(m)
    assert m["total_ms"] == pytest.approx(80.0, abs=0.5)
    assert {"route", "handoff", "prefill_chunk", "decode"} <= {
        s["name"] for s in m["spans"]}


def test_merge_traces_on_the_ports_router_prefill_decode_path(runs):
    model = build_model("llama", ModelConfig(**TINY))
    model.load_state_dict(params_from_jax(runs["tree"]))
    rts = [obs.RequestTracer(process_index=i) for i in range(3)]
    kw = dict(num_slots=4, buf_len=BUF, eos_id=EOS, page_size=8,
              prefill_chunk=8)
    pre = PagedEngine(model, CPU, prefill_only=True, request_tracer=rts[1],
                      **kw)
    dec = PagedEngine(model, CPU, request_tracer=rts[2], **kw)
    reqs = _reqs(Request, PREEMPT_PROMPTS, 4)
    for r in reqs:
        rts[0].begin(r)
        r.trace_ctx = rts[0].export_context(r, "route").to_wire()
        rts[0].retire(r)
    out = run_disaggregated(pre, dec, reqs)
    assert len(out["completed"]) == len(reqs)
    for r in reqs:
        recs = [rt.timeline(r.rid) for rt in rts]
        assert {rec["trace_id"] for rec in recs} == {r.trace_id}
        m = obs.merge_traces(recs)
        assert m == jobs_.merge_traces(recs)
        assert m["processes"] == [0, 1, 2]
        _contiguous(m)
        names = [s["name"] for s in m["spans"]]
        assert {"route", "handoff", "kv_import", "decode"} <= set(names)


# ---- (h) ----

def test_flight_ring_kinds_and_dumps_equal_jax(runs):
    for case in ("preempt", "collapse"):
        got = runs["port"][case]
        _, _, want_dumps, want_kinds = runs["jax"][case]
        assert got["kinds"] == want_kinds, case
        assert [d["tag"] for d in got["dumps"]] == [
            d["tag"] for d in want_dumps]
        for a, b in zip(got["dumps"], want_dumps):
            assert a["trigger"] == b["trigger"]
            assert [e["kind"] for e in a["ring"]] == [
                e["kind"] for e in b["ring"]]
            assert set(a) == set(b)
    tags = lambda case: [d["tag"] for d in runs["port"][case]["dumps"]]
    assert "pool_exhausted" in tags("preempt")
    assert tags("collapse").count("slo_collapse") == 1
    assert "interactive" in runs["port"]["collapse"]["eng"].slo_collapsed


# ---- (i) ----

def test_telemetry_endpoint_and_final_registry_equal_jax(runs):
    got = runs["port"]["preempt"]
    mid = got["scraped"]["json"]
    assert mid["gauges"]["serve/live"] >= 1
    assert mid["counters"]["serve/decode_steps"] >= 2
    assert "# TYPE serve_live gauge" in got["scraped"]["prom"]
    want = runs["jax"]["preempt"][1]
    for part in ("gauges", "counters"):
        assert got["snap"][part] == want[part], part
    assert got["snap"]["gauges"]["hbm/available"] == 0.0
    assert not any(k.startswith("hbm/bytes") for k in got["snap"]["gauges"])
    assert obs.prometheus_name("serve/tokens_per_sec") == \
        jobs_.telemetry.prometheus_name("serve/tokens_per_sec")


def test_metrics_rotation_chain_validates_and_jax_tailer_follows(tmp_path):
    with MetricsWriter(str(tmp_path), process_index=0, max_bytes=512) as w:
        for i in range(40):
            w.event("serve_request", rid=i, generated=2)
    gens = sorted(glob.glob(str(tmp_path / "metrics*.jsonl")))
    assert len(gens) > 2, gens
    for g in gens:
        assert jvalidate_jsonl(g) == [], g
    t = JsonlTailer(str(tmp_path / "metrics.jsonl"))
    assert [r["rid"] for r in t.poll()] == list(range(40))
    assert t.rotations == len(gens) - 1


# ---- (j) ----

class _Req:
    def __init__(self, ttft_s, finish_t, slo_class="interactive", ntok=8):
        self.slo_class, self.ttft_s, self.tpot_s = slo_class, ttft_s, 0.01
        self.finish_t, self.tokens = finish_t, [0] * ntok


class _Sched:
    def __init__(self, max_queue):
        self.classes = {"interactive": 0.05}
        self.max_queue, self.pending = max_queue, 0


class _Engine:
    def __init__(self, max_queue=16):
        self.scheduler = _Sched(max_queue)
        self.completed, self._slot_req = [], {}
        self.prefill_chunk = 32

    def stats(self):
        return {}


@obs.control_safe_point
def _actuate(ctl):
    """The tests' registered safe point (the repo's lint allows knob
    actuation only inside one)."""
    return ctl.apply_decisions()


def _shift(pkg_controller, Writer, Tel, log_dir, mode):
    """The JAX traffic-shift script: a collapse with a deep queue, then a
    collapse with a shallow one, then recovery."""
    t = {"now": 0.0}
    eng = _Engine(max_queue=16)
    with Writer(log_dir, process_index=0) as w:
        tel = Tel(writer=w, wall=WALL)
        ctl = pkg_controller.SLOController(eng, mode, writer=w,
                                           telemetry=tel, interval=8,
                                           cooldown=1,
                                           clock=lambda: t["now"])
        steps = [(1.0, 0.2, 20), (2.0, 0.2, 1), (3.0, 0.01, 1),
                 (4.0, 0.01, 1)]
        for i, (now, ttft, pending) in enumerate(steps):
            t["now"] = now
            eng.completed += [_Req(ttft, finish_t=now - 0.5 + 0.05 * j)
                              for j in range(6)]
            eng.scheduler.pending, eng._slot_req = pending, {0: 1, 1: 1}
            ctl.tick(8 * (i + 1))
            _actuate(ctl)
        ctl.close()
        tel.close()
    keys = ("knob", "trigger", "old", "new", "applied", "snapshot_seq",
            "mode", "seq", "t", "evidence")
    return ([{k: d[k] for k in keys} for d in ctl.decisions],
            (eng.scheduler.max_queue, eng.prefill_chunk), ctl.summary())


@pytest.mark.parametrize("mode", ["advise", "act"])
def test_slo_controller_decisions_equal_jax(tmp_path, mode):
    got = _shift(controller, MetricsWriter, obs.TelemetryExporter,
                 str(tmp_path / "port"), mode)
    want = _shift(jcontroller, JMetricsWriter,
                  jobs_.TelemetryExporter, str(tmp_path / "jax"), mode)
    assert got == want
    decisions, knobs, _ = got
    assert decisions, "the shift moved nothing"
    if mode == "advise":
        assert knobs == (16, 32)                  # advise never mutates
        assert not any(d["applied"] for d in decisions)
    else:
        assert any(d["applied"] for d in decisions)
    for p in glob.glob(str(tmp_path / "port" / "metrics*.jsonl")):
        assert jvalidate_jsonl(p) == []


def test_speculative_k_follows_an_act_decision(runs):
    """The speculation knob: the engine's k moves at the safe point and
    the next rounds draft at the new width; out of range is refused."""
    model = build_model("llama", ModelConfig(**TINY))
    model.load_state_dict(params_from_jax(runs["tree"]))
    dm = build_model("llama", ModelConfig(**DRAFTER)).init_weights(1)
    eng = SpeculativeEngine(model, CPU, dm, **dict(SPEC, speculate_k=3))
    ctl = controller.SLOController(eng, "act", interval=1)
    eng.controller = ctl
    for r in _reqs(Request, SPEC_PROMPTS, 8):
        eng.submit(r)
    eng.run_to_completion()
    ks = [d["new"] for d in ctl.decisions if d["knob"] == "speculate_k"]
    assert ks and eng.k == ks[-1] != 3           # random drafter: k fell
    assert eng.stats()["speculate_k"] == eng.k
    verify = [s for (kind, s), n in eng.dispatch.shapes.items()
              if kind == "spec_verify"]
    assert {s[0] for s in verify} == {3} | set(ks)
    with pytest.raises(ValueError, match="outside"):
        eng.k = eng.k_max + 1


# ---- (k) ----

def test_tp2_obs_and_act_runs_give_the_tokens_of_obs_off(runs):
    off, on = runs["cli"]["tp2"]["off"], runs["cli"]["tp2"]["on"]
    assert on["outputs"] == off["outputs"]
    assert any(on["outputs"].values())
    assert on["trace_requests"] is True and on["control"] == "act"
    assert on["metrics_port"] > 0
    d = os.path.join(runs["cli_dir"], "tp2")
    files = {f for f in os.listdir(d) if "tfevents" not in f}
    assert files == {"metrics.jsonl", "trace.json", "trace.jsonl"} | {
        os.path.basename(p) for p in on["flight_dumps"]}


# ---- (l) ----

def test_off_costs_nothing(runs):
    off = runs["cli"]["tp2"]["off"]
    assert not os.path.exists(os.path.join(runs["root"], "off"))
    for field in ("trace_requests", "metrics_port", "telemetry_snapshots",
                  "control", "controller", "flight_dumps",
                  "worst_ttft_rids"):
        assert field not in off, field
    model = build_model("llama", ModelConfig(**TINY)).init_weights(0)
    eng = PagedEngine(model, CPU, **PREEMPT)
    assert (eng.tracer, eng.writer, eng.rt, eng.flight, eng.telemetry,
            eng.controller, eng.pool.flight, eng.scheduler.flight) == (
        None,) * 8


def test_serve_refuses_an_unwritable_obs_dir(tmp_path):
    """JAX's loud refusal, in its words, before any engine work: a log dir
    under a file cannot take the traces."""
    blocker = tmp_path / "blocker"
    blocker.write_text("a file")
    with pytest.raises(SystemExit, match="not writable"):
        serve.main(DRY_PAGED + ["--trace_requests", "--log_dir",
                                str(blocker / "logs")])
