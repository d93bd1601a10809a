"""The port's scheduler SLO machinery against the JAX `Scheduler`, on the CPU.

The JAX tiny GPT (hidden 128, 2 layers, 4 heads, vocab 1024) is built from
a fixed seed and its weights are carried into the port with
`load_jax_params`; the JAX engines run the gather path, the port its
default kernel path (the kernel's plain version on the CPU). Both
schedulers read one manual clock that moves only between steps, and each
package's request ids start from 0, so every decision and timeline
record is comparable field for field. Then:

  * one scripted scenario through both schedulers: priority classes, a
    shed past the queue watermark, a queued and a running deadline, a
    cancel, one decode-step fault, one prefill failure (the
    `serving.block_alloc` site), a failed swap (`serving.weight_swap`),
    an adoption beside a handoff whose bundle the `serving.kv_handoff`
    site refused, and a staged prefix restore refused by
    `serving.kv_restore`. Equal: statuses, tokens, `counts`, the
    reference keys of `metrics()`, the registry's counter deltas, the
    decision records except `t` and `trace_id`, the timeline records
    except `trace_id`, and the serving JSONL record for record, the KV
    ledger's events included, but for its clock stamps.
    `tools/serve_report.py` and
    `tools/metrics_report.py`, unedited, accept the port's JSONL and
    snapshot, and `--compare` finds no counter regression between the
    two packages' snapshots in either direction;
  * the speculative engine: a cancel and a decode-step fault under the
    scheduler keep every stream, the probe slot's included, token-exact
    against the JAX speculative engine's; a cancelled slot's draft
    position rewinds;
  * the fault sites on the engine: `serving.decode_step` and
    `serving.weight_swap` leave every engine tensor and host input as it
    was; `serving.kv_quant` truncate multiplies one block's layer-0 scale
    rows by 64 in place (same `data_ptr()`) and moves the next decode's
    logits; `serving.kv_restore` restores nothing and ticks the corrupt
    counter; a prefill the `serving.block_alloc` site fails gives back
    its matched prefix references.

Metric values are read as deltas: registries are process-global.
"""
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import PagedGenerationEngine as JPagedEngine
from paddle_tpu.serving import SpeculativeEngine as JSpeculativeEngine
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.distributed import kv_handoff as jkvh
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.serving import PagedGenerationEngine, SpeculativeEngine
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving.distributed import kv_handoff as tkvh
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(slots=2, max_len=64, block_size=8)
# the reference keys of Scheduler.metrics() compared across the packages
METRIC_KEYS = ("steps", "queue_depth", "slot_occupancy", "tokens_generated",
               "decode_tokens_per_s", "ttft_s_mean", "requests",
               "spec_proposed", "spec_accepted", "spec_acceptance_rate",
               "blocks_in_use", "blocks_total", "prefix_cache_blocks")
PKG = {
    "jax": dict(sched=jsched, faults=jfaults, metrics=jmetrics, kvh=jkvh),
    "port": dict(sched=tsched, faults=tfaults, metrics=tmetrics, kvh=tkvh),
}


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.disarm_all()
    tfaults.disarm_all()
    yield
    jfaults.disarm_all()
    tfaults.disarm_all()


@pytest.fixture
def zeroed_gauges():
    """Every gauge of both registries reads 0 for the test and gets its
    value back after it: other tests in the worker leave gauges behind
    (the fleet's `serving_slo_degraded`, the numerics tests' finite
    fractions), and the scenario's snapshots read every gauge."""
    saved = [(c, c.value)
             for reg in (jmetrics.registry(), tmetrics.registry())
             for m in list(reg._metrics.values()) if m.kind == "gauge"
             for c in list(m._children.values())]
    for c, _ in saved:
        c.value = 0.0
    yield
    for c, v in saved:
        c.value = v


class Clock:
    """A clock that moves only when the script says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 1000, n)]


def _engine(pkg, models, spec=False, **kw):
    jm, tm = models
    cfg = dict(ENGINE, **kw)
    if pkg == "jax":
        cls = JSpeculativeEngine if spec else JPagedEngine
        return cls(jm, attention_impl="gather", **cfg)
    cls = SpeculativeEngine if spec else PagedGenerationEngine
    return cls(tm, device="cpu", **cfg)


def _scheduler(pkg, eng, clock, **kw):
    mod = PKG[pkg]["sched"]
    if pkg == "port":
        kw["device"] = "cpu"
    return mod.Scheduler(eng, clock=clock, **kw)


def _flat_counters(snap):
    """The series of a delta snapshot that moved (a series another test
    created in one registry reads 0 here)."""
    out = {}
    for m in snap["metrics"]:
        for s in m["samples"]:
            key = m["name"] + json.dumps(s["labels"], sort_keys=True)
            if m["type"] == "counter" and s["value"]:
                out[key] = s["value"]
            elif m["type"] == "histogram" and s["count"]:
                out[key + ":count"] = s["count"]
    return out


def _delta_snapshot(before, after, names):
    """A metrics.v1 snapshot of what moved between two snapshots of one
    registry, over the families in `names`: counters and histograms as
    differences, gauges as read after."""
    prev = {m["name"]: {json.dumps(s["labels"], sort_keys=True): s
                        for s in m["samples"]} for m in before["metrics"]}
    out = []
    for m in after["metrics"]:
        if m["name"] not in names:
            continue
        old = prev.get(m["name"], {})
        samples = []
        for s in m["samples"]:
            o = old.get(json.dumps(s["labels"], sort_keys=True))
            if m["type"] == "counter":
                s = dict(s, value=s["value"] - (o["value"] if o else 0.0))
            elif m["type"] == "histogram":
                s = dict(s, sum=s["sum"] - (o["sum"] if o else 0.0),
                         count=s["count"] - (o["count"] if o else 0),
                         buckets={b: c - (o["buckets"][b] if o else 0)
                                  for b, c in s["buckets"].items()})
            samples.append(s)
        out.append(dict(m, samples=samples))
    return dict(after, metrics=out)


def _staged_bundles(pkg, models):
    """From a source engine of `pkg`: a KV bundle for prompt 30 that
    crosses the wire, a bundle for prompt 31 whose pack the
    `serving.kv_handoff` site refuses (None: the caller falls back to a
    local prefill), and the prefix chain of prompt 32."""
    kvh, faults = PKG[pkg]["kvh"], PKG[pkg]["faults"]
    src = _engine(pkg, models)
    out = []
    for seed, n in ((30, 11), (31, 13)):
        first = src.prefill(0, _prompt(seed, n))
        ks, vs, plen = src.extract_kv(0)
        src.reset_slot(0)
        if seed == 31:
            faults.arm("serving.kv_handoff", "raise", max_fires=1)
        try:
            ks, vs, meta = kvh.unpack_kv_bundle(kvh.pack_kv_bundle(
                ks, vs, meta={"plen": plen, "first": first}))
        except faults.FaultInjected:
            out.append(None)
            continue
        finally:
            faults.disarm_all()
        out.append((ks, vs, meta["plen"], meta["first"]))
    src.prefill(1, _prompt(32, 26))
    out.append(src.extract_prefix_kv(_prompt(32, 26)))
    return out


def _scenario(pkg, models, tmp_path, monkeypatch):
    """The scripted run. Returns (handles by label, scheduler, engine,
    registry delta snapshot, the labels that raised at submit)."""
    mod, faults = PKG[pkg]["sched"], PKG[pkg]["faults"]
    staged, refused, chain = _staged_bundles(pkg, models)
    monkeypatch.setattr(mod.Request, "_ids", itertools.count())
    reg = PKG[pkg]["metrics"].registry()
    before = reg.snapshot()
    clock = Clock()
    eng = _engine(pkg, models)
    path = str(tmp_path / f"{pkg}_serve.jsonl")
    sched = _scheduler(pkg, eng, clock, max_queue=16, shed_watermark=3,
                       metrics_path=path)
    h, raised = {}, []

    def submit(label, seed, n, max_new, **kw):
        try:
            h[label] = sched.submit(_prompt(seed, n), max_new_tokens=max_new,
                                    **kw)
        except mod.QueueFullError as e:
            raised.append((label, type(e).__name__))

    def step(n=1):
        for _ in range(n):
            clock.t += 1.0
            sched.step()

    # priorities and shedding: the interactive pair overtakes queued work,
    # a batch request past the watermark is shed, an interactive one not
    submit("std", 1, 9, 6)
    submit("batch", 2, 12, 6, priority="batch")
    submit("int_a", 3, 5, 4, priority="interactive", tenant="t1",
           cohort="chat")
    submit("shed", 4, 6, 4, priority="batch")
    submit("int_b", 5, 7, 3, priority="interactive")
    # a deadline that passes while queued: TIMEOUT with no tokens
    submit("queued_deadline", 6, 8, 4, timeout_s=0.5)
    step()
    # a deadline that passes mid-decode: TIMEOUT, partial stream kept
    submit("run_deadline", 7, 10, 30, priority="interactive",
           timeout_s=3.5)
    step(4)
    # a cancel of the running standard request: its blocks go back
    sched.cancel(h["std"])
    step()
    # a decode-step fault: the requests in flight fail, one probe slot
    faults.arm("serving.decode_step", "raise", max_fires=1)
    step()
    faults.disarm_all()
    step(2)
    # a failed swap between steps: the old weights keep serving
    faults.arm("serving.weight_swap", "raise", max_fires=1)
    ev = sched.schedule_weight_swap(dict(eng._params), version=2)
    step()
    faults.disarm_all()
    assert ev.is_set() and not ev.swap_result["ok"]
    # the handed-off KV: one bundle adopted, one refused on the wire and
    # recomputed locally
    submit("adopted", 30, 11, 5, staged_kv=staged)
    submit("handoff_refused", 31, 13, 5, staged_kv=refused)
    while not (h["adopted"].done() and h["handoff_refused"].done()):
        step()
    # a prefill the block pool fails: that request alone errors
    submit("prefill_fail", 40, 9, 4)
    faults.arm("serving.block_alloc", "raise", max_fires=1)
    step()
    faults.disarm_all()
    # a staged prefix chain whose restore the fault site refuses
    faults.arm("serving.kv_restore", "raise", max_fires=1)
    submit("restore_refused", 32, 26, 4, staged_prefix=(*chain, None))
    step(2)
    faults.disarm_all()
    submit("late", 41, 6, 5, priority="batch")
    while sched.step():
        clock.t += 1.0
    sched.close()
    after = reg.snapshot()
    names = {m["name"] for m in tmetrics.registry().snapshot()["metrics"]}
    return h, sched, eng, _delta_snapshot(before, after, names), raised


def _drop(rec, *keys):
    return {k: v for k, v in rec.items() if k not in keys}


def test_slo_scenario_matches_jax(models, tmp_path, monkeypatch,
                                  zeroed_gauges):
    runs = {pkg: _scenario(pkg, models, tmp_path, monkeypatch)
            for pkg in ("jax", "port")}
    (jh, js, _, jdelta, jraised) = runs["jax"]
    (th, ts, teng, tdelta, traised) = runs["port"]
    assert jraised == traised == [("shed", "LoadShedError")]
    assert set(jh) == set(th)
    got = {k: (th[k].status, th[k].tokens) for k in th}
    want = {k: (jh[k].status, jh[k].tokens) for k in jh}
    assert got == want
    # the script reached every path it names
    st = {k: v[0] for k, v in got.items()}
    assert st["queued_deadline"] == "TIMEOUT" and not got["queued_deadline"][1]
    assert st["run_deadline"] == "TIMEOUT" and got["run_deadline"][1]
    assert st["std"] == "SHED" and got["std"][1]            # the cancel
    assert "ERROR" in {st[k] for k in ("int_a", "int_b", "batch",
                                       "run_deadline")}
    assert st["prefill_fail"] == "ERROR"
    assert th["adopted"].adopted and not th["handoff_refused"].adopted
    assert th["restore_refused"].kv_restored_tokens == 0
    for k in ("adopted", "handoff_refused", "restore_refused", "late"):
        assert st[k] == "DONE", k
    assert ts.counts == js.counts
    tm, jm = ts.metrics(), js.metrics()
    assert {k: tm.get(k) for k in METRIC_KEYS} == \
        {k: jm.get(k) for k in METRIC_KEYS}
    assert teng.block_pool.in_use == len(teng.prefix_cache)   # no leak
    # the registries moved alike
    assert _flat_counters(tdelta) == _flat_counters(jdelta)
    flat = _flat_counters(tdelta)
    assert flat['serving_decode_failures_total{}'] == 2
    assert flat['serving_kv_tier_corrupt_total{}'] == 1
    assert flat['serving_weight_swaps_total{"status": "failed"}'] == 1
    # decision and timeline records, field for field
    jdec = [_drop(r, "t", "trace_id") for r in js.decision_records()]
    tdec = [_drop(r, "t", "trace_id") for r in ts.decision_records()]
    assert tdec == jdec
    assert {r["action"] for r in tdec} >= {"admit", "shed", "place",
                                           "quarantine", "swap"}
    assert [_drop(r, "trace_id") for r in ts.timeline_records()] == \
        [_drop(r, "trace_id") for r in js.timeline_records()]
    # the JSONL streams agree record for record, the KV ledger's events
    # included, but for the clock stamps
    recs = {}
    for pkg in ("jax", "port"):
        with open(tmp_path / f"{pkg}_serve.jsonl") as f:
            recs[pkg] = [_drop(json.loads(line), "t", "trace_id")
                         for line in f]
    assert any(r["kind"] == "kvledger" for r in recs["port"])
    assert recs["port"] == recs["jax"]
    # the repo's tools grade the port's artifacts unchanged
    snaps = {}
    for pkg, delta in (("jax", jdelta), ("port", tdelta)):
        snaps[pkg] = str(tmp_path / f"{pkg}_metrics.jsonl")
        with open(snaps[pkg], "w") as f:
            f.write(json.dumps(delta) + "\n")
    tools = os.path.join(ROOT, "tools")
    for argv in ([os.path.join(tools, "serve_report.py"),
                  str(tmp_path / "port_serve.jsonl")],
                 [os.path.join(tools, "metrics_report.py"), snaps["port"]],
                 [os.path.join(tools, "metrics_report.py"), "--compare",
                  snaps["jax"], snaps["port"]],
                 [os.path.join(tools, "metrics_report.py"), "--compare",
                  snaps["port"], snaps["jax"]]):
        r = subprocess.run([sys.executable] + argv, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, (argv, r.stdout[-2000:], r.stderr[-2000:])
    assert "no counter regressions" in r.stdout


def _pressure_scenario(pkg, models, monkeypatch):
    """test_serving_paged.py's natural-pressure preemption, with deadlines
    so the victims' slack decides: a pool of 7 blocks for 3 slots."""
    mod = PKG[pkg]["sched"]
    monkeypatch.setattr(mod.Request, "_ids", itertools.count())
    clock = Clock()
    eng = _engine(pkg, models, slots=3, max_len=32, block_size=4,
                  num_blocks=8, enable_prefix_cache=False)
    sched = _scheduler(pkg, eng, clock, max_queue=16)
    hs = [sched.submit(_prompt(80 + i, 6), max_new_tokens=6,
                       priority=("standard", "batch")[i % 2],
                       timeout_s=(None, 40.0, 30.0, None, 50.0)[i])
          for i in range(5)]
    while sched.step():
        clock.t += 1.0
    return [(h.status, h.tokens, h.preempted) for h in hs], sched


def test_preemption_under_pressure_matches_jax(models, monkeypatch):
    want, js = _pressure_scenario("jax", models, monkeypatch)
    got, ts = _pressure_scenario("port", models, monkeypatch)
    assert got == want
    assert all(s == "DONE" for s, _, _ in got)
    assert ts.counts == js.counts and ts.counts["serving.preempted"] > 0
    tdec = [_drop(r, "t", "trace_id") for r in ts.decision_records()]
    assert tdec == [_drop(r, "t", "trace_id")
                    for r in js.decision_records()]
    preempts = [r for r in tdec if r["action"] == "preempt"]
    assert preempts and any(c["deadline_slack_s"] is not None
                            for r in preempts
                            for c in r["inputs"]["candidates"])
    assert ts.engine.block_pool.in_use == 0


class Tick:
    """A clock that moves 1.0 at every read: each decode step's timed
    window (one read before `engine.decode()`, one after) lasts 1.0."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_decode_tokens_per_s_is_the_reference_rate(models, monkeypatch):
    """`metrics()["decode_tokens_per_s"]` is the reference's rate: every
    delivered token, prefill's first included, over decode time. Under a
    clock that gives each decode step 1.0 s, both schedulers read the
    same rate, and the port's equals its delivered tokens over its
    decode steps."""
    out = {}
    for pkg in PKG:
        monkeypatch.setattr(PKG[pkg]["sched"].Request, "_ids",
                            itertools.count())
        sched = _scheduler(pkg, _engine(pkg, models), Tick())
        hs = [sched.submit(_prompt(90 + i, 5 + 2 * i), max_new_tokens=6)
              for i in range(3)]
        while sched.step():
            pass
        assert all(h.status == "DONE" for h in hs)
        out[pkg] = sched.metrics()
    port = out["port"]
    assert port["decode_tokens_per_s"] == out["jax"]["decode_tokens_per_s"]
    assert port["decode_tokens_per_s"] == \
        port["tokens_generated"] / port["decode_steps"]
    assert port["tokens_generated"] > port["decode_tokens"]


def _spec_scenario(pkg, models, monkeypatch):
    mod, faults = PKG[pkg]["sched"], PKG[pkg]["faults"]
    monkeypatch.setattr(mod.Request, "_ids", itertools.count())
    clock = Clock()
    eng = _engine(pkg, models, spec=True, gamma=3, draft_layers=1)
    sched = _scheduler(pkg, eng, clock)
    hs = [sched.submit(_prompt(50 + i, 6 + 3 * i), max_new_tokens=10)
          for i in range(4)]
    clock.t += 1.0
    sched.step()
    clock.t += 1.0
    sched.step()
    sched.cancel(hs[0])
    if pkg == "port":
        assert eng._draft_pos[0] == 0 and eng.slot_positions()[0] == 0
    faults.arm("serving.decode_step", "raise", max_fires=1)
    clock.t += 1.0
    sched.step()
    faults.disarm_all()
    late = sched.submit(_prompt(60, 9), max_new_tokens=12)
    while sched.step():
        clock.t += 1.0
    return [(h.status, h.tokens) for h in hs + [late]], sched


def test_spec_cancel_and_decode_fault_match_jax(models, monkeypatch):
    want, js = _spec_scenario("jax", models, monkeypatch)
    got, ts = _spec_scenario("port", models, monkeypatch)
    assert got == want
    statuses = [s for s, _ in got]
    assert statuses[0] == "SHED" and "ERROR" in statuses
    assert statuses[-1] == "DONE"
    assert ts.counts == js.counts
    tm, jm = ts.metrics(), js.metrics()
    assert {k: tm.get(k) for k in METRIC_KEYS} == \
        {k: jm.get(k) for k in METRIC_KEYS}
    assert [_drop(r, "t", "trace_id") for r in ts.decision_records()] == \
        [_drop(r, "t", "trace_id") for r in js.decision_records()]


# ----------------------------------------------------- engine fault sites
def _state(eng):
    """Copies of every tensor and host input a fault must leave alone."""
    out = {"pos": eng._pos.copy(), "tables": eng._tables.copy(),
           "tokens": eng._last_tokens.copy(),
           "refs": eng.block_pool._refs.copy()}
    for i, layer in enumerate(eng._pool):
        for name, t in layer._asdict().items():
            out[f"pool{i}.{name}"] = t.clone()
    for name, t in eng._params.items():
        out[f"param.{name}"] = t.clone()
    for name, v in eng._decode_params.items():
        if isinstance(v, dict):
            out[f"q.{name}"] = v["q"].clone()
            out[f"s.{name}"] = v["scale"].clone()
    return out


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
def test_decode_and_swap_faults_leave_the_engine_as_it_was(models,
                                                           weight_dtype):
    _, tm = models
    eng = _engine("port", models, weight_dtype=weight_dtype)
    eng.prefill(0, _prompt(70, 9))
    eng.prefill(1, _prompt(71, 16))
    eng.decode()
    before = _state(eng)
    tfaults.arm("serving.decode_step", "raise", max_fires=1)
    with pytest.raises(tfaults.FaultInjected):
        eng.decode()
    _assert_same_state(before, _state(eng))
    other = {n: p.detach() * 0.5 for n, p in tm.named_parameters()}
    tfaults.arm("serving.weight_swap", "raise", max_fires=1)
    with pytest.raises(tfaults.FaultInjected):
        eng.swap_params(other)
    _assert_same_state(before, _state(eng))
    # disarmed, the same decode and swap go through
    eng.decode()
    assert eng.swap_params(other) == len(other)


def test_kv_quant_truncate_scales_in_place(models):
    kw = dict(kv_dtype="int8", capture_logits=True)
    eng, twin = _engine("port", models, **kw), _engine("port", models, **kw)
    for e in (eng, twin):
        e.prefill(0, _prompt(72, 12))
        e.decode()
    layer, tlayer = eng._pool[0], twin._pool[0]
    ptrs = (layer.k_scale.data_ptr(), layer.v_scale.data_ptr())
    # the victim is the first in-use block: the prompt's first, full block,
    # which the next step does not write
    victim = next(b for b in range(1, eng.block_pool.num_blocks)
                  if eng.block_pool.refcount(b) > 0)
    assert victim == int(eng._tables[0, 0])
    tfaults.arm("serving.kv_quant", "truncate", max_fires=1)
    eng.decode()
    twin.decode()
    assert tfaults.armed("serving.kv_quant")[0].fires == 1
    assert (layer.k_scale.data_ptr(), layer.v_scale.data_ptr()) == ptrs
    others = [b for b in range(layer.k_scale.shape[0]) if b != victim]
    for name in ("k_scale", "v_scale"):
        got, want = getattr(layer, name), getattr(tlayer, name)
        assert torch.equal(got[victim], want[victim] * 64.0)
        assert torch.equal(got[others], want[others])
    for a, b in zip(eng._pool[1:], twin._pool[1:]):
        assert torch.equal(a.k_scale, b.k_scale)
    # the decode read the corrupted storage
    assert not np.array_equal(eng.last_logits[0], twin.last_logits[0])


@pytest.mark.parametrize("mode", ["raise", "truncate"])
def test_kv_restore_fault_restores_nothing(models, mode):
    src = _engine("port", models)
    prompt = _prompt(73, 26)
    src.prefill(0, prompt)
    ks, vs, n = src.extract_prefix_kv(prompt)
    eng = _engine("port", models)
    counter = tmetrics.registry().counter("serving_kv_tier_corrupt_total")
    c0 = counter.value
    tfaults.arm("serving.kv_restore", mode, max_fires=1)
    assert eng.restore_prefix(prompt, ks, vs, n) == 0
    assert counter.value == c0 + 1
    assert len(eng.prefix_cache) == 0 and eng.block_pool.in_use == 0
    assert eng.restore_prefix(prompt, ks, vs, n) == 24


def test_failed_prefill_gives_back_its_prefix_refs(models):
    eng = _engine("port", models)
    shared = _prompt(74, 16)
    eng.prefill(0, shared + [1, 2])
    in_use = eng.block_pool.in_use
    refs = eng.block_pool._refs.copy()
    tfaults.arm("serving.block_alloc", "raise", max_fires=1)
    with pytest.raises(tfaults.FaultInjected):
        eng.prefill(1, shared + [3, 4, 5])
    assert eng.block_pool.in_use == in_use
    np.testing.assert_array_equal(eng.block_pool._refs, refs)


@pytest.mark.parametrize("end", ["pack", "unpack"])
def test_kv_handoff_site_fires_at_both_ends(end):
    ks = [np.zeros((3, 2, 4), np.float32)]
    buf = tkvh.pack_kv_bundle(ks, ks)
    tfaults.arm("serving.kv_handoff", "raise", max_fires=1)
    with pytest.raises(tfaults.FaultInjected):
        if end == "pack":
            tkvh.pack_kv_bundle(ks, ks)
        else:
            tkvh.unpack_kv_bundle(buf)
    assert tkvh.unpack_kv_bundle(buf)[2] == jkvh.unpack_kv_bundle(buf)[2]


def test_cancel_queued_and_draining(models):
    eng = _engine("port", models, slots=1)
    sched = _scheduler("port", eng, Clock())
    run = sched.submit(_prompt(75, 5), max_new_tokens=4)
    queued = sched.submit(_prompt(76, 5), max_new_tokens=4)
    sched.step()
    assert sched.cancel(queued, status="TIMEOUT")
    assert queued.status == "TIMEOUT" and not queued.tokens
    assert not sched.cancel(queued)
    sched.set_draining()
    assert sched.draining
    with pytest.raises(tsched.QueueFullError, match="draining"):
        sched.submit(_prompt(77, 5))
    sched.run_until_idle()
    assert run.status == "DONE" and len(run.tokens) == 4
    assert sched.counts["serving.timeout"] == 1
    assert sched.counts["serving.rejected"] == 1
    assert eng.block_pool.in_use == len(eng.prefix_cache)
