"""The port's fleet plane and committed checkpoints, on the CPU.

`paddle_tpu_torch.observability.fleet` copies `paddle_tpu/observability/
fleet.py`; `framework/ckpt_commit.py` and `distributed/checkpoint.py`
copy the commit protocol and the state-dict layout. Here:

  * the non-slow tests of `tests/test_fleet.py` (federation, the burn-rate
    watchdog, phase trails and timelines, label-aware comparison, the
    plane over a stub frontend) run on the port's modules, graded by the
    repo's `tools/metrics_report.py` and `tools/serve_report.py`;
  * the same member snapshots merge to equal fleet snapshots in both
    packages, and both watchdogs read equal burns from them;
  * checkpoints: the port's `save_state_dict` loads in the JAX
    `load_state_dict(return_numpy=True)` and the reverse, bit for bit
    (bfloat16 included), and a torn checkpoint falls back to the newest
    valid sibling in both directions;
  * the worker verbs in-process: STAT is a projection of the same
    registry snapshot METRICS ships, the terminal POLL carries the
    worker's phase trail, DUMP round-trips a postmortem.

Metric values are read as deltas: registries are process-global.
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.framework import ckpt_commit as jcommit
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.framework import ckpt_commit as tcommit
from paddle_tpu_torch.observability import fleet, flight_recorder, metrics
from paddle_tpu_torch.observability import reqtimeline as rt
from paddle_tpu_torch.serving import PagedEngineConfig, PagedGenerationEngine
from paddle_tpu_torch.serving.distributed import DistFrontend, ServingWorker
from paddle_tpu_torch.text.models import gpt_tiny

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_ROOT, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import metrics_report  # noqa: E402
import serve_report  # noqa: E402

VOCAB = 1024


# ---------------------------------------------------------- synth helpers

def _snap(metrics_list, ts=1.0, pid=7):
    return {"schema": "paddle_tpu.metrics.v1", "ts": ts, "pid": pid,
            "metrics": metrics_list}


def _counter(name, value, labels=None):
    return {"name": name, "type": "counter", "help": "h",
            "labelnames": sorted(labels or {}),
            "samples": [{"labels": dict(labels or {}), "value": value}]}


def _gauge(name, value, labels=None):
    return {"name": name, "type": "gauge", "help": "h",
            "labelnames": sorted(labels or {}),
            "samples": [{"labels": dict(labels or {}), "value": value}]}


def _hist(name, buckets, total, count, labels=None):
    return {"name": name, "type": "histogram", "help": "h",
            "labelnames": sorted(labels or {}),
            "samples": [{"labels": dict(labels or {}),
                         "buckets": dict(buckets), "sum": total,
                         "count": count}]}


def _flat(snap, kinds=("counter", "gauge")):
    return metrics.flatten_snapshot(snap, kinds=kinds)


def _members(*snaps):
    return [{"worker_id": f"decode{i}", "role": "decode", "snapshot": s}
            for i, s in enumerate(snaps)]


# ------------------------------------------------------------- federation

def test_merge_labels_counters_and_gauges():
    a = _snap([_counter("serving_tokens_total", 10),
               _gauge("serving_queue_depth", 3)])
    b = _snap([_counter("serving_tokens_total", 5),
               _gauge("serving_queue_depth", 1)])
    merged = fleet.merge_snapshots(_members(a, b))
    assert metrics_report.validate_snapshot(merged) == []
    flat = _flat(merged)
    assert flat["serving_tokens_total{role=decode,worker_id=decode0}"] == 10
    assert flat["serving_tokens_total{role=decode,worker_id=decode1}"] == 5
    # counters aggregate into a _fleet row; gauges stay per-worker only
    assert flat["serving_tokens_total{role=_fleet,worker_id=_fleet}"] == 15
    assert "serving_queue_depth{role=_fleet,worker_id=_fleet}" not in flat
    assert flat["serving_queue_depth{role=decode,worker_id=decode0}"] == 3


def test_merge_histograms_bucketwise():
    a = _snap([_hist("serving_ttft_seconds",
                     {"0.1": 2, "1.0": 4, "+Inf": 5}, 3.0, 5)])
    b = _snap([_hist("serving_ttft_seconds",
                     {"0.1": 1, "1.0": 1, "+Inf": 3}, 5.0, 3)])
    merged = fleet.merge_snapshots(_members(a, b))
    assert metrics_report.validate_snapshot(merged) == []
    fam = [m for m in merged["metrics"]
           if m["name"] == "serving_ttft_seconds"][0]
    agg = [s for s in fam["samples"]
           if s["labels"]["worker_id"] == fleet.FLEET_LABEL]
    assert len(agg) == 1
    # bucket-wise: cumulative counts sum per edge, +Inf == count
    assert agg[0]["buckets"] == {"0.1": 3, "1.0": 5, "+Inf": 8}
    assert agg[0]["count"] == 8 and agg[0]["sum"] == 8.0
    per_worker = [s for s in fam["samples"]
                  if s["labels"]["worker_id"] != fleet.FLEET_LABEL]
    assert len(per_worker) == 2


def test_merge_mismatched_bucket_edges_drop_only_the_aggregate():
    a = _snap([_hist("h", {"0.1": 1, "+Inf": 2}, 1.0, 2)])
    b = _snap([_hist("h", {"0.5": 1, "+Inf": 1}, 0.5, 1)])
    merged = fleet.merge_snapshots(_members(a, b))
    fam = [m for m in merged["metrics"] if m["name"] == "h"][0]
    workers = {s["labels"]["worker_id"] for s in fam["samples"]}
    assert workers == {"decode0", "decode1"}   # no _fleet aggregate
    assert metrics_report.validate_snapshot(merged) == []


def test_merged_prometheus_renders_and_lints():
    merged = fleet.merge_snapshots(_members(
        _snap([_counter("serving_tokens_total", 10),
               _hist("serving_ttft_seconds",
                     {"0.1": 1, "+Inf": 2}, 1.0, 2)]),
        _snap([_counter("serving_tokens_total", 4)])))
    text = metrics.prometheus_from_snapshot(merged)
    assert metrics_report.validate_prometheus(text) == []
    assert 'worker_id="decode1"' in text
    assert 'worker_id="_fleet"' in text


# ---------------------------------------------------------- the watchdog

def _ttft_snap(slow_count, count):
    """A merged-shape snapshot whose TTFT histogram holds `count`
    observations, `slow_count` of them over the 1.0s threshold."""
    fast = count - slow_count
    return fleet.merge_snapshots(_members(_snap([_hist(
        "serving_ttft_seconds",
        {"1.0": fast, "+Inf": count}, float(count), count)])))


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_watchdog_latency_burn_and_sustained_breach():
    clock = _FakeClock()
    fired = []
    wd = fleet.BurnRateWatchdog(
        slos=[fleet.SLO("ttft", hist="serving_ttft_seconds",
                        threshold_s=1.0, objective=0.99)],
        fast_window_s=10.0, slow_window_s=60.0, burn_threshold=1.0,
        sustain=2, clock=clock, on_breach=fired.append)
    wd.observe(_ttft_snap(0, 100))          # baseline: all fast
    assert wd.last_burn["ttft"]["fast"] == 0.0 and not wd.degraded
    clock.t += 5
    # 50 new observations, every one slow: bad fraction 1.0 / budget
    # 0.01 = burn 100 on both windows -> candidate #1
    wd.observe(_ttft_snap(50, 150))
    assert wd.last_burn["ttft"]["fast"] == pytest.approx(100.0)
    assert not wd.degraded and not fired    # sustain=2: not yet
    clock.t += 5
    wd.observe(_ttft_snap(60, 160))         # candidate #2 -> degraded
    assert wd.degraded and len(fired) == 1
    clock.t += 5
    wd.observe(_ttft_snap(70, 170))         # still burning: latched
    assert wd.degraded and len(fired) == 1  # one breach per episode
    # recovery: the slow window still sees the bad stretch, so jump past
    # it before the all-fast sample
    clock.t += 120
    wd.observe(_ttft_snap(70, 400))
    assert not wd.degraded
    g = _flat(metrics.registry().snapshot())
    assert "serving_slo_burn{slo=ttft,tenant=_all,window=fast}" in g
    assert g["serving_slo_degraded"] == 0.0


def test_watchdog_failure_ratio_slo():
    clock = _FakeClock()
    wd = fleet.BurnRateWatchdog(
        slos=[fleet.SLO("failures", kind="failure", objective=0.999,
                        bad=(r"^serving_failover_total",),
                        total=(r"^serving_requests_total\{.*"
                               r"status=admitted",))],
        fast_window_s=10.0, slow_window_s=60.0, burn_threshold=1.0,
        sustain=1, clock=clock)

    def snap(failovers, admitted):
        return fleet.merge_snapshots(_members(_snap([
            _counter("serving_failover_total", failovers),
            _counter("serving_requests_total", admitted,
                     {"status": "admitted"})])))

    wd.observe(snap(0, 10))
    assert not wd.degraded
    clock.t += 5
    wd.observe(snap(2, 14))                 # 2 bad / 4 total / 0.001
    assert wd.degraded
    assert wd.last_burn["failures"]["fast"] == pytest.approx(500.0)


# ----------------------------------------------------- trails & timelines

def test_phase_trail_sums_exactly_and_rel():
    tr = rt.PhaseTrail()
    tr.begin(rt.PH_QUEUE, 10.0)
    tr.close(10.5)                          # seal queue at prefill start
    tr.append(rt.PH_PREFILL, 10.5, 11.0)    # measured closed intervals,
    tr.append(rt.PH_KV_HANDOFF, 11.0, 11.25)  # router-style
    tr.begin(rt.PH_DECODE, 11.25)           # nothing open: plain open
    tr.close(12.0)
    rel = tr.rel(10.0)
    assert [s["phase"] for s in rel] == ["queue", "prefill",
                                         "kv_handoff", "decode"]
    assert sum(s["dur_s"] for s in rel) == pytest.approx(2.0, abs=1e-9)
    assert rel[0] == {"phase": "queue", "t0": 0.0, "dur_s": 0.5}
    # begin/close share boundary timestamps: contiguity is structural
    for a, b in zip(rel, rel[1:]):
        assert a["t0"] + a["dur_s"] == pytest.approx(b["t0"])


def test_ttft_breakdown_clips_to_first_token():
    rec = rt.build_record(
        "DONE", 0.0, 2.0, [
            {"phase": "queue", "t0": 0.0, "dur_s": 0.2},
            {"phase": "prefill", "t0": 0.2, "dur_s": 0.3},
            {"phase": "decode", "t0": 0.5, "dur_s": 1.5}],
        tokens=4, ttft_s=0.6)
    parts = rt.ttft_breakdown(rec)
    assert parts == {"queue": pytest.approx(0.2),
                     "prefill": pytest.approx(0.3),
                     "first_decode": pytest.approx(0.1)}
    assert rt.ttft_breakdown(rt.build_record(
        "TIMEOUT", 0.0, 1.0, [], ttft_s=None)) is None


def test_timeline_validation_catches_bad_records():
    good = rt.build_record(
        "DONE", 0.0, 1.0, [{"phase": "queue", "t0": 0.0, "dur_s": 0.4},
                           {"phase": "decode", "t0": 0.4, "dur_s": 0.6}],
        tokens=3, ttft_s=0.5, failovers=1)
    assert serve_report.validate_records([good]) == []
    drifted = json.loads(json.dumps(good))
    drifted["phases"][1]["dur_s"] = 0.2     # sums to 0.6 vs e2e 1.0
    assert any("sum" in e for e in serve_report.validate_records([drifted]))
    alien = json.loads(json.dumps(good))
    alien["phases"][0]["phase"] = "warp"
    assert any("unknown phase" in e
               for e in serve_report.validate_records([alien]))


def test_tail_attribution_names_the_dominant_phase():
    def rec(queue, decode):
        return rt.build_record(
            "DONE", 0.0, queue + decode,
            [{"phase": "queue", "t0": 0.0, "dur_s": queue},
             {"phase": "decode", "t0": queue, "dur_s": decode}],
            tokens=2, ttft_s=queue)
    tls = [rec(0.01, 0.1)] * 9 + [rec(5.0, 0.1)]
    tail = serve_report.tail_attribution(tls, q=0.99)
    assert tail["dominant"] == "queue"
    assert tail["share"]["queue"] > 0.9
    means = serve_report.timeline_phase_means(tls)
    assert set(means) == {"queue", "decode"}


# ------------------------------------------------- label-aware comparison

def test_compare_skips_members_absent_from_one_side():
    a = fleet.merge_snapshots(_members(
        _snap([_counter("serving_tokens_total", 100)]),
        _snap([_counter("serving_tokens_total", 100)])))
    b = fleet.merge_snapshots(_members(
        _snap([_counter("serving_tokens_total", 180)])))
    # decode1 died before run B: its work series must not read as
    # "shrank to zero"; the _fleet aggregate still compares
    regs = metrics_report.compare_counters(a, b)
    assert not [r for r in regs if "decode1" in r[0]], regs


def test_compare_flags_burn_growth_and_degraded_flip():
    a = fleet.merge_snapshots(_members(_snap([
        _gauge("serving_slo_degraded", 0.0),
        _gauge("serving_slo_burn", 0.0, {"slo": "ttft",
                                         "window": "fast"})])))
    b = fleet.merge_snapshots(_members(_snap([
        _gauge("serving_slo_degraded", 1.0),
        _gauge("serving_slo_burn", 40.0, {"slo": "ttft",
                                          "window": "fast"})])))
    regs = metrics_report.compare_counters(a, b)
    why = {r[0].split("{")[0]: r[4] for r in regs}
    assert "serving_slo_degraded" in why
    assert "serving_slo_burn" in why


# ------------------------------------------------- the plane (stub fleet)

class _StubClient:
    """Duck-typed ServingShardClient: canned OP_METRICS/OP_DUMP replies,
    with per-index failure injection (a dark host raises)."""

    def __init__(self, snaps, dark=()):
        self.endpoints = [f"stub:{i}" for i in range(len(snaps))]
        self.snaps = snaps
        self.dark = set(dark)
        self.dump_calls = []

    def metrics(self, i):
        if i in self.dark:
            raise ConnectionError("dark host")
        return {"role": "decode", "snapshot": self.snaps[i]}

    def dump(self, i, reason=""):
        self.dump_calls.append((i, reason))
        if i in self.dark:
            raise ConnectionError("dark host")
        return {"role": "decode", "path": f"/remote/{i}.json",
                "postmortem": {"schema": "paddle_tpu.postmortem.v1",
                               "reason": reason, "worker": i}}


class _StubFrontend:
    def __init__(self, client):
        self.decode = client
        self.prefill = None
        self.fleet_plane = None

    def live_decode_workers(self):
        return list(range(len(self.decode.endpoints)))


def test_plane_polls_merges_and_streams(tmp_path):
    snaps = [_snap([_counter("serving_tokens_total", 7)]),
             _snap([_counter("serving_tokens_total", 9)])]
    fe = _StubFrontend(_StubClient(snaps, dark={1}))
    plane = fleet.FleetPlane(
        fe, jsonl_path=str(tmp_path / "fleet.jsonl"),
        poll_interval_s=0.0)
    assert fe.fleet_plane is plane          # pump() hook attached
    merged = plane.poll_now()
    flat = _flat(merged)
    # the dark member is skipped, not fatal; the router's own registry
    # federates as member "router"
    assert flat["serving_tokens_total{role=decode,worker_id=decode0}"] == 7
    assert "serving_tokens_total{role=decode,worker_id=decode1}" not in flat
    assert any(k.endswith("worker_id=router}") for k in flat)
    recs = metrics_report.load_snapshots(str(tmp_path / "fleet.jsonl"))
    assert len(recs) == 1
    assert metrics_report.validate_prometheus(plane.prometheus()) == []


def test_plane_breach_annotates_and_bundles(tmp_path):
    """A sustained burn drives on_breach: flight-recorder annotation +
    a fleet postmortem bundle holding every reachable worker's dump and
    RECORDING the unreachable one."""
    failovers = {"n": 0}

    class _Client(_StubClient):
        def metrics(self, i):
            if i in self.dark:
                raise ConnectionError("dark host")
            return {"role": "decode", "snapshot": _snap([
                _counter("serving_failover_total", failovers["n"]),
                _counter("serving_requests_total",
                         10 + 2 * failovers["n"],
                         {"status": "admitted"})])}

    fe = _StubFrontend(_Client([None, None], dark={1}))
    clock = _FakeClock()
    wd = fleet.BurnRateWatchdog(
        slos=[fleet.SLO("failures", kind="failure", objective=0.999,
                        bad=(r"^serving_failover_total",),
                        total=(r"^serving_requests_total\{.*"
                               r"status=admitted",))],
        fast_window_s=10.0, slow_window_s=60.0, sustain=1, clock=clock)
    rec = flight_recorder.get()
    rec.annotations.pop("fleet.slo_breach", None)
    plane = fleet.FleetPlane(fe, watchdog=wd, clock=clock,
                             postmortem_dir=str(tmp_path / "pm"),
                             include_router=False)
    plane.poll_now()                        # baseline
    assert plane.last_bundle is None
    failovers["n"] = 4                      # the incident
    clock.t += 5
    plane.poll_now()
    assert wd.degraded
    bundle = plane.last_bundle
    assert bundle and os.path.isdir(bundle)
    doc = json.load(open(os.path.join(bundle, "bundle.json")))
    assert doc["schema"] == fleet.BUNDLE_SCHEMA
    assert doc["degraded"] is True
    assert "fleet.slo_breach" in doc["router_annotations"]
    by_id = {m["worker_id"]: m for m in doc["members"]}
    assert by_id["decode0"]["ok"] is True
    assert by_id["decode1"]["ok"] is False and by_id["decode1"]["error"]
    member = json.load(open(os.path.join(bundle, "decode0.json")))
    assert member["schema"] == "paddle_tpu.postmortem.v1"
    assert not os.path.exists(os.path.join(bundle, "decode1.json"))


# ------------------------------------------ the two packages, same inputs

def _mixed_members():
    a = _snap([_counter("serving_tokens_total", 10, {"tenant": "t0"}),
               _counter("serving_failover_total", 1),
               _gauge("serving_queue_depth", 3),
               _hist("serving_ttft_seconds",
                     {"0.1": 2, "1.0": 4, "+Inf": 5}, 3.0, 5)])
    b = _snap([_counter("serving_tokens_total", 5, {"tenant": "t0"}),
               _counter("serving_requests_total", 7,
                        {"status": "admitted", "tenant": "t0"}),
               _gauge("serving_queue_depth", 1),
               _hist("serving_ttft_seconds",
                     {"0.1": 1, "1.0": 1, "+Inf": 3}, 5.0, 3)])
    c = _snap([_hist("serving_ttft_seconds",
                     {"0.5": 1, "+Inf": 1}, 0.5, 1)])
    return [{"worker_id": "prefill0", "role": "prefill", "snapshot": a},
            {"worker_id": "decode0", "role": "decode", "snapshot": b},
            {"worker_id": "decode1", "role": "decode", "snapshot": c}]


def test_merge_equals_the_jax_merge():
    members = _mixed_members()
    port = fleet.merge_snapshots(json.loads(json.dumps(members)), ts=5.0,
                                 pid=11)
    ref = jfleet.merge_snapshots(json.loads(json.dumps(members)), ts=5.0,
                                 pid=11)
    assert port == ref
    assert metrics.prometheus_from_snapshot(port) == \
        jmetrics.prometheus_from_snapshot(ref)
    assert metrics_report.validate_snapshot(port) == []


def test_watchdogs_read_equal_burns():
    clocks = [_FakeClock(), _FakeClock()]
    dogs = [mod.BurnRateWatchdog(
        slos=[mod.SLO("ttft", hist="serving_ttft_seconds",
                      threshold_s=1.0, objective=0.99),
              mod.SLO("failures", kind="failure", objective=0.999,
                      bad=(r"^serving_failover_total",),
                      total=(r"^serving_requests_total\{.*"
                             r"status=admitted",))],
        fast_window_s=10.0, slow_window_s=60.0, sustain=2,
        clock=clock) for mod, clock in ((fleet, clocks[0]),
                                        (jfleet, clocks[1]))]
    for step, (slow, count, fo, adm) in enumerate(
            [(0, 100, 0, 10), (50, 150, 2, 14), (60, 160, 3, 20),
             (60, 400, 3, 90)]):
        members = _members(_snap([
            _hist("serving_ttft_seconds",
                  {"1.0": count - slow, "+Inf": count}, float(count),
                  count),
            _counter("serving_failover_total", fo),
            _counter("serving_requests_total", adm,
                     {"status": "admitted"})]))
        for clock in clocks:
            clock.t += 5 if step < 3 else 120
        burns = [d.observe(fleet.merge_snapshots(
            json.loads(json.dumps(members)), ts=1.0, pid=1)) for d in dogs]
        assert burns[0] == burns[1]
        assert dogs[0].degraded == dogs[1].degraded
        if step == 2:
            assert dogs[0].degraded
            assert dogs[0].last_burn["failures"]["slow"] > 1.0
    assert not dogs[0].degraded


# ------------------------------------------------------------ checkpoints

def _bits(arr):
    """Raw bytes of an array, bfloat16 (torch or ml_dtypes) as its 16-bit
    patterns."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).numpy().tobytes()
        return arr.numpy().tobytes()
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16).tobytes()
    return arr.tobytes()


def _state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 3, generator=g),
            "blocks.0.attn.qkv.weight": torch.randn(3, 9, generator=g),
            "emb": torch.randn(5, 2, generator=g).to(torch.bfloat16),
            "step": torch.tensor([7, 8], dtype=torch.int32),
            "codes": torch.tensor([-3, 5, 127], dtype=torch.int8)}


def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    state = _state()
    path = str(tmp_path / "ckpt" / "step-0001")
    tckpt.save_state_dict(state, path)
    assert tcommit.verify_dir(path) is not None
    assert jcommit.verify_dir(path) is not None
    got = jckpt.load_state_dict(path, return_numpy=True)
    assert set(got) == set(state)
    for name, t in state.items():
        assert _bits(got[name]) == _bits(t), name
        assert tuple(np.shape(got[name])) == tuple(t.shape)
    assert np.asarray(got["emb"]).dtype.name == "bfloat16"
    # and the port reads its own checkpoint back the same
    back = tckpt.load_state_dict(str(tmp_path / "ckpt"), device="cpu")
    for name, t in state.items():
        assert back[name].dtype == t.dtype
        assert _bits(back[name]) == _bits(t), name


def test_jax_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    import jax.numpy as jnp
    state = _state()
    jstate = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                  if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
              for k, v in state.items()}
    path = str(tmp_path / "ckpt" / "step-0001")
    jckpt.save_state_dict(jstate, path)
    got = tckpt.load_state_dict(path, device="cpu")
    for name, t in state.items():
        assert got[name].dtype == t.dtype, name
        assert _bits(got[name]) == _bits(t), name
    host = tckpt.load_state_dict(path, return_numpy=True)
    assert host["emb"].dtype == np.float32
    np.testing.assert_array_equal(host["emb"], state["emb"].float().numpy())


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_torn_checkpoint_falls_back_to_the_newest_valid_sibling(
        tmp_path, writer, reader):
    import jax.numpy as jnp
    root = tmp_path / "ckpt"
    for step, scale in ((1, 1.0), (2, 2.0)):
        state = {"w": torch.full((3, 2), scale)}
        if writer == "port":
            tckpt.save_state_dict(state, str(root / f"step-000{step}"))
        else:
            jckpt.save_state_dict({"w": jnp.full((3, 2), scale)},
                                  str(root / f"step-000{step}"))
    assert (root / "LATEST").read_text().strip() == "step-0002"
    data = root / "step-0002" / "w.0.npy"
    raw = bytearray(data.read_bytes())
    raw[-1] ^= 0xFF                                 # bit rot in the payload
    data.write_bytes(bytes(raw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if reader == "jax":
            got = np.asarray(jckpt.load_state_dict(
                str(root), return_numpy=True)["w"])
        else:
            got = tckpt.load_state_dict(str(root), return_numpy=True)["w"]
    np.testing.assert_array_equal(got, np.full((3, 2), 1.0, np.float32))
    assert any("falling back" in str(w.message) for w in caught)
    # the torn one named directly falls back within its lineage too
    load = (lambda p: jckpt.load_state_dict(p, return_numpy=True)) \
        if reader == "jax" else \
        (lambda p: tckpt.load_state_dict(p, return_numpy=True))
    with pytest.warns(RuntimeWarning, match="falling back"):
        direct = np.asarray(load(str(root / "step-0002"))["w"])
    np.testing.assert_array_equal(direct, got)
    # nothing valid left: loud, never a silent fresh start
    (root / "step-0001" / "w.0.npy").write_bytes(b"torn")
    err = jcommit.CheckpointCorruptError if reader == "jax" \
        else tcommit.CheckpointCorruptError
    with pytest.raises(err):
        load(str(root))


def test_commit_protocol_gc_and_stale_tmp_sweep(tmp_path):
    root = tmp_path / "ckpt"
    for step in range(1, 5):
        tckpt.save_state_dict({"w": torch.full((2,), float(step))},
                              str(root / f"step-000{step}"), keep=2)
    names = sorted(p.name for p in root.iterdir() if p.is_dir())
    assert names == ["step-0003", "step-0004"]
    stale = root / ".step-0009.tmp.999999999"
    stale.mkdir()
    tcommit.sweep_stale_tmp(str(root))
    assert not stale.exists()
    assert tcommit.resolve_valid(str(root)) == (str(root / "step-0004"),
                                                "step-0004")


# --------------------------------------------- the wire layer, in-process

@pytest.fixture(scope="module")
def fleet_worker():
    m = gpt_tiny(device="cpu", seed=5)
    engine = PagedGenerationEngine(m, PagedEngineConfig(
        slots=2, max_len=64, block_size=8), device="cpu")
    w = ServingWorker(m, engine, role="decode")
    fe = DistFrontend([w.endpoint])
    yield w, fe
    fe.stop_workers()
    fe.close()
    w.shutdown()


def test_worker_verbs_stat_projects_the_snapshot(fleet_worker):
    w, fe = fleet_worker
    prompt = np.random.RandomState(3).randint(0, VOCAB, 6).tolist()
    req = fe.submit(prompt, max_new=3)
    fe.run(timeout_s=60)
    assert req.status == "DONE"
    reply = fe.decode.metrics(0)
    assert reply["role"] == "decode"
    snap = reply["snapshot"]
    assert metrics_report.validate_snapshot(snap) == []
    flat = metrics.flatten_snapshot(snap)
    stat = fe.decode.stat(0)
    # STAT is a projection of the same registry snapshot: no second
    # bookkeeping to drift; tenant slices sum
    assert stat["tokens_generated"] == sum(
        v for k, v in flat.items()
        if k.startswith("serving_tokens_total"))
    assert stat["handoff_bytes"] == flat.get(
        "serving_kv_handoff_bytes_total", 0)
    assert stat["requests"]["serving.completed"] == sum(
        v for k, v in flat.items()
        if k.startswith("serving_requests_total{status=completed"))
    assert stat["trace_counts"] == {}           # eager on the CPU
    assert stat["parallel"] == {"tp": 1, "pp": 1,
                                "devices": {"engine": "cpu"}}
    # the terminal POLL carried the worker's own phase trail, joined
    # into the router record as worker_phases
    rec = fe.timeline_records()[-1]
    assert serve_report.validate_records([rec]) == []
    assert [s["phase"] for s in rec["worker_phases"]][0] == "queue"
    assert "decode" in {s["phase"] for s in rec["worker_phases"]}
    assert sum(s["dur_s"] for s in rec["phases"]) == pytest.approx(
        rec["e2e_s"], rel=0.05, abs=1e-3)


def test_worker_verbs_dump_roundtrip(fleet_worker, tmp_path):
    w, fe = fleet_worker
    rec = flight_recorder.get()
    old_dir = rec.dir
    rec.dir = str(tmp_path)
    try:
        reply = fe.decode.dump(0, "fleet test")
        assert reply["postmortem"]["schema"] == "paddle_tpu.postmortem.v1"
        assert reply["postmortem"]["reason"] == "fleet test"
        assert os.path.isfile(reply["path"])
    finally:
        rec.dir = old_dir


def test_plane_over_a_live_worker_federates_it(fleet_worker, tmp_path):
    w, fe = fleet_worker
    plane = fleet.FleetPlane(fe, jsonl_path=str(tmp_path / "fleet.jsonl"),
                             poll_interval_s=0.0)
    try:
        req = fe.submit(np.random.RandomState(4).randint(
            0, VOCAB, 5).tolist(), max_new=2)
        fe.run(timeout_s=60)
        assert req.status == "DONE"
        merged = plane.poll_now()
        assert metrics_report.validate_snapshot(merged) == []
        flat = metrics.flatten_snapshot(merged)
        done = flat.get("serving_requests_total{role=_fleet,status=completed,"
                        "tenant=default,worker_id=_fleet}", 0)
        assert done >= 1
        assert {m["worker_id"] for m in plane.last_members} >= {"decode0",
                                                                "router"}
    finally:
        fe.fleet_plane = None
