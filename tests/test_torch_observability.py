"""The port's observability substrate against the JAX package's, on the CPU.

`paddle_tpu_torch.observability` copies the JAX package's stdlib-only
modules (the port may not import `paddle_tpu`). One test body serves both
packages where it can (parametrised over the module pair, after
`tests/test_observability.py` and `tests/test_faults.py`), and the pair
is held to equal results on the same calls:

  * metrics: equal snapshots modulo `ts`/`pid`, equal Prometheus text and
    flattened keys, the same errors; snapshots validate under
    `tools/metrics_report.py`;
  * faults: the same seeded probability stream of `FaultSpec`, the same
    nth/max-fires triggers, `PTN_FAULTS` parsing, mode precedence;
  * decisions: the same `replay_*` verdicts over a table of inputs and
    the same `validate_records` findings;
  * reqtimeline: the same `PhaseTrail` sums, records and TTFT breakdowns;
  * tracecontext: the same wire bytes;
  * isolation: with both packages loaded, a port counter is absent from
    the JAX snapshot, a port fault does not arm the JAX site, and a port
    fault span lands in the port's tracer and flight-recorder ring only;
  * the `PTN_FAULTS` environment path in a subprocess that imports no JAX;
  * the port's profiler: spans nest per thread, export as chrome traces
    that merge, and `RecordEvent` shows in a torch profiler's table only
    while one records.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu  # noqa: F401
from paddle_tpu import profiler as jprofiler
from paddle_tpu.observability import decisions as jdec
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import reqtimeline as jrt
from paddle_tpu.observability import tracecontext as jtc
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.observability import decisions as tdec
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import reqtimeline as trt
from paddle_tpu_torch.observability import tracecontext as ttc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import metrics_report  # noqa: E402

BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])
MODS = {"jax": dict(metrics=jmetrics, faults=jfaults, dec=jdec, rt=jrt,
                    tc=jtc),
        "port": dict(metrics=tmetrics, faults=tfaults, dec=tdec, rt=trt,
                     tc=ttc)}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.disarm_all()
    tfaults.disarm_all()
    yield
    jfaults.disarm_all()
    tfaults.disarm_all()


def _drop_stamp(snap):
    return {k: v for k, v in snap.items() if k not in ("ts", "pid")}


# ----------------------------------------------------------------- metrics
def _fill(metrics):
    reg = metrics.MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("status",))
    c.labels(status="ok").inc()
    c.labels(status="ok").inc(2)
    c.labels(status="err").inc()
    g = reg.gauge("depth")
    g.set(7)
    g.dec(2)
    g.set_to_max(3)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 1.0))
    for v in (0.001, 0.5, 99.0):
        h.observe(v)
    reg.histogram("wait_seconds", labelnames=("q",)).labels(q="a") \
        .observe(0.02)
    return reg, c


@BOTH
def test_registry_semantics(pkg):
    metrics = MODS[pkg]["metrics"]
    reg, c = _fill(metrics)
    flat = metrics.flatten_snapshot(reg.snapshot())
    assert flat["req_total{status=ok}"] == 3
    assert flat["req_total{status=err}"] == 1
    assert flat["depth"] == 5
    hist = [m for m in reg.snapshot()["metrics"]
            if m["name"] == "lat_seconds"][0]["samples"][0]
    assert hist["count"] == 3 and hist["buckets"]["+Inf"] == 3
    assert hist["buckets"]["0.01"] == 1 and hist["buckets"]["1.0"] == 2
    assert reg.counter("req_total", labelnames=("status",)) is c
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("req_total")
    with pytest.raises(ValueError, match="labels"):
        reg.counter("req_total", labelnames=("other",))
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad.name")
    with pytest.raises(ValueError, match="only go up"):
        c.labels(status="ok").inc(-1)
    reg.disable()
    c.labels(status="ok").inc(100)
    reg.enable()
    assert metrics.flatten_snapshot(reg.snapshot())[
        "req_total{status=ok}"] == 3
    calls = []
    reg.register_collector(lambda r: calls.append(r.gauge("pulled").set(1)))
    reg.register_collector(lambda r: 1 / 0)   # never takes a snapshot down
    assert metrics.flatten_snapshot(reg.snapshot())["pulled"] == 1
    reg.reset()
    assert metrics.flatten_snapshot(reg.snapshot())[
        "req_total{status=ok}"] == 0


def test_snapshots_and_exposition_equal_jax(tmp_path):
    jreg, _ = _fill(jmetrics)
    treg, _ = _fill(tmetrics)
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    assert tsnap["schema"] == jsnap["schema"] == "paddle_tpu.metrics.v1"
    assert _drop_stamp(tsnap) == _drop_stamp(jsnap)
    assert treg.dump_prometheus() == jreg.dump_prometheus()
    assert tmetrics.flatten_snapshot(tsnap) == \
        jmetrics.flatten_snapshot(jsnap)
    assert tmetrics.prometheus_from_snapshot(jsnap) == \
        jmetrics.prometheus_from_snapshot(jsnap)
    path = str(tmp_path / "port.jsonl")
    treg.write_snapshot(path)
    treg.write_snapshot(path)
    recs = metrics_report.load_snapshots(path)
    assert len(recs) == 2
    assert metrics_report.validate_prometheus(treg.dump_prometheus()) == []


# ------------------------------------------------------------------ faults
def test_fault_probability_stream_equals_jax():
    for seed, p in ((5, 0.3), (7, 0.05), (11, 0.9)):
        a = jfaults.FaultSpec("x.site", "delay", p=p, seed=seed)
        b = tfaults.FaultSpec("x.site", "delay", p=p, seed=seed)
        seq = [a._should_fire() for _ in range(300)]
        assert [b._should_fire() for _ in range(300)] == seq
        assert any(seq) and not all(seq)
        ja, tb = (jfaults.FaultSpec("y", "slow", delay_s=0.2, seed=seed),
                  tfaults.FaultSpec("y", "slow", delay_s=0.2, seed=seed))
        assert [tb._jitter_s() for _ in range(20)] == \
            [ja._jitter_s() for _ in range(20)]
    assert tfaults.SITES == jfaults.SITES and tfaults.MODES == jfaults.MODES
    assert tfaults.ENV_VAR == jfaults.ENV_VAR == "PTN_FAULTS"


@BOTH
def test_fault_triggers_and_modes(pkg):
    faults = MODS[pkg]["faults"]
    faults.arm("t.nth", "raise", nth=3)
    fired = []
    for _ in range(9):
        try:
            faults.fire("t.nth")
            fired.append(False)
        except faults.FaultInjected:
            fired.append(True)
    assert [i + 1 for i, f in enumerate(fired) if f] == [3, 6, 9]
    faults.disarm_all()
    faults.arm("t.max", "raise", nth=2, max_fires=1)
    hits = 0
    for _ in range(8):
        try:
            faults.fire("t.max")
        except faults.FaultInjected:
            hits += 1
    assert hits == 1
    assert faults.fire("never.armed") is None
    faults.arm("t.combo", "delay", delay_s=0.0)
    faults.arm("t.combo", "truncate")
    assert faults.fire("t.combo").mode == "truncate"
    faults.arm("t.drop", "drop")
    with pytest.raises(ConnectionResetError):
        faults.fire("t.drop")
    faults.arm("t.exc", "raise", exc=KeyError)
    with pytest.raises(KeyError):
        faults.fire("t.exc")
    faults.arm("t.scoped", "raise", target="a:1")
    assert faults.fire("t.scoped", key="b:2") is None
    with pytest.raises(faults.FaultInjected):
        faults.fire("t.scoped", key="a:1")
    with pytest.raises(ValueError, match="unknown fault mode"):
        faults.arm("t.bad", "explode")


@BOTH
def test_env_parsing_and_stacking(pkg):
    faults = MODS[pkg]["faults"]
    specs = faults.load_env(
        "serving.decode_step=raise:nth=3:max=1;serving.decode_step=delay:"
        "delay=0.01;serving.kv_restore=truncate:p=0.25:seed=7:target=x")
    assert len(specs) == 3
    dec = faults.armed("serving.decode_step")
    assert [s.mode for s in dec] == ["raise", "delay"]
    assert (dec[0].nth, dec[0].max_fires, dec[1].delay_s) == (3, 1, 0.01)
    kr = faults.armed("serving.kv_restore")[0]
    assert (kr.mode, kr.p, kr.seed, kr.target) == ("truncate", 0.25, 7, "x")
    with pytest.raises(ValueError):
        faults.load_env("justasite")
    with pytest.raises(ValueError):
        faults.load_env("a.site=raise:bogus=1")


def test_fired_fault_counts_in_the_port_registry_only():
    def value(metrics):
        flat = metrics.flatten_snapshot(metrics.registry().snapshot(),
                                        kinds=("counter",))
        return flat.get("faults_injected_total{mode=raise,site=t.iso}", 0.0)
    j0, t0 = value(jmetrics), value(tmetrics)
    tfaults.arm("t.iso", "raise", max_fires=2)
    for _ in range(3):
        try:
            tfaults.fire("t.iso")
        except tfaults.FaultInjected:
            pass
    assert value(tmetrics) == t0 + 2
    assert value(jmetrics) == j0
    # and the JAX site stays quiet: arming is per package
    assert jfaults.armed("t.iso") == [] and jfaults.fire("t.iso") is None


def test_port_counter_absent_from_the_jax_snapshot():
    tmetrics.counter("port_only_probe_total", "isolation probe").inc()
    assert "port_only_probe_total" in tmetrics.flatten_snapshot(
        tmetrics.registry().snapshot())
    assert "port_only_probe_total" not in jmetrics.flatten_snapshot(
        jmetrics.registry().snapshot())
    assert tmetrics.registry() is not jmetrics.registry()
    # the port's producers reported to the port's registry
    names = {m["name"] for m in tmetrics.registry().snapshot()["metrics"]}
    assert {"serving_requests_total", "serving_decode_failures_total",
            "serving_block_pool_blocks_in_use",
            "serving_prefix_cache_hits_total", "faults_injected_total",
            "serving_kv_tier_corrupt_total"} <= names


def test_port_fault_span_lands_in_the_port_tracer_only(tmp_path):
    jring = jfr.FlightRecorder(capacity=16, dir=str(tmp_path / "j"))
    tring = tfr.FlightRecorder(capacity=16, dir=str(tmp_path / "t"))
    jprev, tprev = jprofiler._tracer.ring, tprofiler._tracer.ring
    jring.enable()
    tring.enable()
    try:
        assert tprofiler._tracer.ring is tring
        assert jprofiler._tracer.ring is jring
        tfaults.arm("t.span", "delay", delay_s=0.0)
        tfaults.fire("t.span")
        assert [s["name"] for s in tring.spans()] == ["fault::t.span"]
        assert tring.spans()[0]["attrs"]["mode"] == "delay"
        assert jring.spans() == []
        jfaults.arm("t.span", "delay", delay_s=0.0)
        jfaults.fire("t.span")
        assert [s["name"] for s in jring.spans()] == ["fault::t.span"]
        assert len(tring.spans()) == 1
        # the port's postmortem carries the port's registry
        path = tring.dump("isolation check")
        with open(path) as f:
            doc = json.load(f)
        assert doc["schema"] == "paddle_tpu.postmortem.v1"
        assert [s["name"] for s in doc["spans"]] == ["fault::t.span"]
        assert doc["metric_deltas"][
            "faults_injected_total{mode=delay,site=t.span}"] == 1
    finally:
        jring.disable()
        tring.disable()
        jprofiler._tracer.ring, tprofiler._tracer.ring = jprev, tprev


def test_ptn_faults_env_arms_the_port_in_a_subprocess():
    code = ("import sys\n"
            "from paddle_tpu_torch.observability import faults\n"
            "specs = faults.armed('serving.decode_step')\n"
            "assert [(s.mode, s.nth, s.max_fires) for s in specs] == "
            "[('raise', 2, 1)], specs\n"
            "assert faults.armed('serving.kv_quant')[0].mode == 'truncate'\n"
            "assert faults.fire('serving.decode_step') is None\n"
            "try:\n"
            "    faults.fire('serving.decode_step')\n"
            "except faults.FaultInjected:\n"
            "    pass\n"
            "else:\n"
            "    raise SystemExit('the second call did not fire')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PTN_FAULTS"] = ("serving.decode_step=raise:nth=2:max=1;"
                         "serving.kv_quant=truncate")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# --------------------------------------------------------------- decisions
_SHED_TABLE = [
    dict(priority=2, shed_priority=2, queue_depth=3, shed_watermark=3,
         pool_free_fraction=None, shed_pool_free=None),
    dict(priority=1, shed_priority=2, queue_depth=9, shed_watermark=3,
         pool_free_fraction=0.0, shed_pool_free=0.5),
    dict(priority=2, shed_priority=2, queue_depth=1, shed_watermark=3,
         pool_free_fraction=0.125, shed_pool_free=0.25),
    dict(priority=2, shed_priority=1, queue_depth=0, shed_watermark=None,
         pool_free_fraction=0.9, shed_pool_free=0.25),
]
_CANDS = [
    {"slot": 0, "request_id": 3, "tenant": "a", "priority": 1,
     "deadline_slack_s": 2.5},
    {"slot": 1, "request_id": 4, "tenant": "b", "priority": 2,
     "deadline_slack_s": None},
    {"slot": 2, "request_id": 5, "tenant": "a", "priority": 2,
     "deadline_slack_s": 9.0},
    {"slot": 3, "request_id": 6, "tenant": "c", "priority": 0,
     "deadline_slack_s": -1.0},
]


def test_replay_verdicts_equal_jax():
    for inputs in _SHED_TABLE:
        assert tdec.replay_shed(inputs) == jdec.replay_shed(inputs)
    assert [tdec.replay_shed(i) is None for i in _SHED_TABLE] == \
        [False, True, False, True]
    for worse in (None, -1, 0, 1, 2):
        for cands in (_CANDS, _CANDS[::-1], _CANDS[:1], []):
            assert tdec.replay_victim(cands, worse_than=worse) == \
                jdec.replay_victim(cands, worse_than=worse)
    assert tdec.replay_victim(_CANDS)["slot"] == 1
    for inputs in ({"loads": {"0": 2, "1": 1, "2": 1}}, {"loads": {}},
                   {"loads": {"0": 0, "1": 5}, "matches": {"1": 32},
                    "min_match": 16, "load_slack": 4}):
        assert tdec.replay_place(inputs) == jdec.replay_place(inputs)
        assert tdec.replay_affinity_place(inputs) == \
            jdec.replay_affinity_place(inputs)
    for inputs in ({"tenant": "a", "cost": 10, "tokens_available": 4,
                    "rate_per_s": 1, "burst": 8},
                   {"tenant": "a", "cost": 3, "tokens_available": 4}):
        assert tdec.replay_rate_limit(inputs) == \
            jdec.replay_rate_limit(inputs)
    for s in (0.1, 1.5, 9.0):
        h = {"suspicion": s, "suspect_threshold": 1.0, "dark_threshold": 5.0}
        assert tdec.replay_health(h) == jdec.replay_health(h)
    assert tdec.ACTIONS == jdec.ACTIONS and tdec.SCHEMA == jdec.SCHEMA


def test_build_and_validate_records_equal_jax():
    recs = []
    for mod in (jdec, tdec):
        shed = dict(_SHED_TABLE[0])
        recs.append([
            mod.build_record("shed", shed, {"reason": mod.replay_shed(shed)},
                             "scheduler", 1.5, request_id=3, tenant="t",
                             cohort="c", trace_id="ab"),
            mod.build_record("preempt", {"candidates": _CANDS,
                                         "worse_than": None},
                             {"victim_slot": 1}, "scheduler", 2.0),
            # a record whose outcome its inputs do not reproduce
            mod.build_record("preempt", {"candidates": _CANDS,
                                         "worse_than": None},
                             {"victim_slot": 0}, "scheduler", 2.0),
            mod.build_record("shed", _SHED_TABLE[1], {"reason": "x"},
                             "router", 3.0),
            {"kind": "decision", "schema": "nope", "action": "admit",
             "t": "later", "tenant": "", "emitter": "me"},
        ])
        with pytest.raises(ValueError, match="unknown decision action"):
            mod.build_record("explode", {}, {}, "scheduler", 0.0)
    assert recs[0] == recs[1]
    errs = tdec.validate_records(recs[1])
    assert errs == jdec.validate_records(recs[0])
    assert not any(e.startswith("record 0") or e.startswith("record 1")
                   for e in errs)
    assert any(e.startswith("record 2") for e in errs)
    assert tdec.by_tenant(recs[1]) == jdec.by_tenant(recs[0])


# ------------------------------------------------------------- reqtimeline
def _trail(rt):
    trail = rt.PhaseTrail()
    for phase, t in ((rt.PH_QUEUE, 10.0), (rt.PH_KV_RESTORE, 10.25),
                     (rt.PH_PREFILL, 10.5), (rt.PH_DECODE, 11.0),
                     (rt.PH_QUEUE, 12.125), (rt.PH_PREFILL, 13.0),
                     (rt.PH_DECODE, 13.5)):
        trail.begin(phase, t)
    trail.close(15.0)
    return trail


def test_phase_trail_and_records_equal_jax():
    for mod in (jrt, trt):
        trail = _trail(mod)
        assert sum(t1 - t0 for _, t0, t1 in trail.segments) == 5.0
    jt, tt = _trail(jrt), _trail(trt)
    assert tt.segments == jt.segments
    assert tt.rel(10.0) == jt.rel(10.0)
    kw = dict(request_id=4, tokens=9, ttft_s=1.0, priority=0, preempted=1,
              adopted=False, trace_id="cd", tenant="t", cohort="c")
    jrec = jrt.build_record("DONE", 10.0, 15.0, jt.rel(10.0), **kw)
    trec = trt.build_record("DONE", 10.0, 15.0, tt.rel(10.0), **kw)
    assert trec == jrec
    assert sum(p["dur_s"] for p in trec["phases"]) == trec["e2e_s"]
    assert trt.ttft_breakdown(trec) == jrt.ttft_breakdown(jrec)
    assert trt.ttft_breakdown(dict(trec, ttft_s=None)) is None
    assert trt.PHASES == jrt.PHASES and trt.SCHEMA == jrt.SCHEMA


# ------------------------------------------------------------ tracecontext
def test_trace_context_wire_equals_jax():
    tid, sid = ttc.new_trace_id(), ttc.new_span_id()
    raw = ttc.pack_ctx(tid, sid)
    assert raw == jtc.pack_ctx(tid, sid)
    assert len(raw) == ttc.CTX_WIRE_BYTES == jtc.CTX_WIRE_BYTES == 24
    assert jtc.unpack_ctx(raw) == ttc.unpack_ctx(raw) == (tid, sid)
    assert ttc.WIRE_FLAG == jtc.WIRE_FLAG
    with ttc.trace_scope() as scoped:
        assert ttc.current_trace_id() == scoped
        assert jtc.current_trace_id() != scoped       # separate state
    assert ttc.current_trace_id() == ttc.process_trace_id()


# ---------------------------------------------------------------- profiler
def test_host_tracer_spans_nest_and_export(tmp_path):
    tr = tprofiler._tracer
    tr.drain()
    tr.enabled = True
    try:
        with ttc.trace_scope() as trace:
            with tprofiler.RecordEvent("outer", attrs={"n": 1}):
                with tprofiler.RecordEvent(
                        "inner", tprofiler.TracerEventType.UserDefined):
                    pass
        events = tr.drain()
    finally:
        tr.enabled = False
    inner, outer = events
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["span_id"] and outer["parent"] is None
    assert inner["depth"] == 1 and inner["trace"] == outer["trace"] == trace
    assert outer["attrs"] == {"n": 1}
    # a closed tracer with no ring records nothing
    with tprofiler.RecordEvent("quiet"):
        pass
    assert tr.drain() == []
    paths = [tprofiler.export_chrome_tracing(str(tmp_path), f"w{i}")(events)
             for i in range(2)]
    doc = tobs.merge_chrome_traces(paths)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert sorted(e["name"] for e in xs) == ["inner", "inner", "outer",
                                             "outer"]
    assert all(e["args"]["trace_id"] == trace for e in xs)


def test_record_event_opens_a_torch_range_only_while_profiling():
    ev = tprofiler.RecordEvent("serving::probe_span")
    with ev:
        assert ev._ann is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprofiler.RecordEvent("serving::probe_span"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "serving::probe_span" in names
