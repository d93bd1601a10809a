"""The port's Profiler and statistics against the JAX package's, on the CPU.

`paddle_tpu_torch/profiler/` ports the reference's `Profiler` surface and
`profiler/statistic.py`; a record window's device side is one
torch.profiler session whose top-level aten ops become its Operator
spans. Held here:

  * `make_scheduler` windows and the interval helpers (`_intervals`,
    `_merge`, `_union_ns`, `_intersect_ns`, `phase_durations_ms`,
    `op_digest`, `build_summary`) equal the JAX ones on the same inputs;
  * windows record nothing while closed; `step_info` units;
  * the summary views render (OverView, OperatorView, DistributedView,
    MemoryView);
  * `analyze` prices the recorded `aten::mm` rows (fake tensors of the
    recorded shapes) with coverage above 0, on the CPU's roofline, or
    `PADDLE_TPU_DEVICE_SPEC`'s;
  * the timeline JSONL loads through `tools/perf_report.py`
    `load_timeline`, as `tests/test_profiler_statistic.py:290-292` holds
    the JAX one;
  * `export_chrome_tracing` takes the Profiler (its last window) and
    a list of spans; one torch profiler session at a time.
"""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu.profiler import statistic as jstat
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.observability import deviceprof as tdp
from paddle_tpu_torch.profiler import (Profiler, ProfilerState, RecordEvent,
                                       SummaryView, TracerEventType,
                                       export_chrome_tracing,
                                       load_profiler_result, make_scheduler)
from paddle_tpu_torch.profiler import statistic as tstat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import perf_report  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(), dict(closed=1, record=1, repeat=2),
    dict(closed=1, record=2, skip_first=3), dict(record=1, repeat=3),
    dict(closed=2, ready=1, record=3), dict(ready=2, record=2, repeat=1,
                                            skip_first=1),
])
def test_make_scheduler_equals_jax(kw):
    t, j = make_scheduler(**kw), jprofiler.make_scheduler(**kw)
    assert [t(i) for i in range(24)] == [j(i) for i in range(24)]
    assert ProfilerState.RECORD_AND_RETURN == \
        jprofiler.ProfilerState.RECORD_AND_RETURN


def _events(seed, n=40):
    """Synthetic spans as both tracers record them."""
    rng = np.random.RandomState(seed)
    kinds = ("Forward", "Backward", "Optimization", "Operator",
             "Communication", "ProfileStep", "UserDefined", "Dataloader")
    out = []
    for i in range(n):
        ts = int(rng.randint(0, 10_000))
        dur = None if i % 17 == 5 else int(rng.randint(0, 3_000))
        e = {"name": f"op{rng.randint(0, 5)}", "type": kinds[i % len(kinds)],
             "ts": ts, "dur": dur, "tid": 1, "depth": 0}
        if i % 3 == 0:
            e["attrs"] = {"input_shapes": [(4, 8), (8,)],
                          "payload_bytes": 1024}
        if i % 4 == 0:
            e["mem0"], e["mem1"] = int(rng.randint(0, 1e6)), \
                int(rng.randint(0, 1e6))
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_helpers_and_views_equal_jax(seed):
    ev = _events(seed)
    ivs = [(s, s + d) for s, d in np.random.RandomState(seed).randint(
        0, 500, (12, 2)).tolist()]
    assert tstat._merge(ivs) == jstat._merge(ivs)
    assert tstat._union_ns(ivs) == jstat._union_ns(ivs)
    assert tstat._intersect_ns(ivs, ivs[3:]) == \
        jstat._intersect_ns(ivs, ivs[3:])
    for types in (("Operator",), ("Forward", "Backward")):
        assert tstat._intervals(ev, types) == jstat._intervals(ev, types)
    assert tstat.phase_durations_ms(ev) == jstat.phase_durations_ms(ev)
    assert tstat.op_digest(ev) == jstat.op_digest(ev)
    for views in (None, SummaryView.OverView, [SummaryView.MemoryView,
                                               SummaryView.DistributedView]):
        for sorted_by in (None, 1, 3):
            assert tstat.build_summary(ev, sorted_by, views, "us") == \
                jstat.build_summary(ev, sorted_by, views, "us")


def test_interval_union_and_intersection():
    a = [(0, 10), (5, 15), (20, 30)]
    assert tstat._union_ns(a) == 25
    assert tstat._intersect_ns(a, [(8, 22)]) == 9
    assert tstat._intersect_ns([], [(8, 22)]) == 0


def _mm_steps(prof, n, size=16):
    x = torch.ones((size, size))
    for _ in range(n):
        with RecordEvent("train::forward", TracerEventType.Forward):
            torch.tanh(torch.mm(x, x)).sum()
        prof.step()


def test_closed_windows_record_nothing(tmp_path):
    tr = tprofiler._tracer
    before = len(tr.events)
    with RecordEvent("outside", TracerEventType.UserDefined):
        pass
    assert len(tr.events) == before and not tr.enabled
    prof = Profiler(scheduler=(1, 2), log_dir=str(tmp_path), device="cpu")
    with prof:
        _mm_steps(prof, 3)
    assert not tr.enabled and not torch.autograd._profiler_enabled()
    names = {e["name"] for e in prof._events}
    # step 0 is closed: its span, its forward and its ops are not kept
    assert "ProfileStep#0" not in names and "ProfileStep#1" in names
    steps = [e for e in prof._events if e["type"] == "ProfileStep"]
    first = min(e["ts"] for e in steps)
    assert all(e["ts"] >= first for e in prof._events)
    assert "aten::mm" in names
    assert prof.last_trace and prof.last_trace.startswith(str(tmp_path))


def test_step_info_units():
    prof = Profiler(timer_only=True, device="cpu")
    assert prof.step_info() == ""
    prof.start()
    prof.step(num_samples=32)
    prof.step(num_samples=32)
    prof.stop()
    assert "images/s" in prof.step_info(unit="images")
    assert prof.step_info().endswith("steps/s")
    plain = Profiler(timer_only=True, device="cpu")
    with plain:
        plain.step()
    assert "images" not in plain.step_info(unit="images")


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """A CPU profiler over steps 1-2 of four, shapes recorded, memory
    sampled, a timeline: (profiler, timeline path)."""
    d = tmp_path_factory.mktemp("prof")
    tl = str(d / "timeline.jsonl")
    prof = Profiler(scheduler=(1, 3), timeline=tl, record_shapes=True,
                    profile_memory=True, log_dir=str(d), device="cpu")
    with prof:
        _mm_steps(prof, 4)
    return prof, tl


def test_summary_views_render(window):
    prof, _ = window
    out = io.StringIO()
    with redirect_stdout(out):
        prof.summary(sorted_by=1, time_unit="us")
    text = out.getvalue()
    assert "Overview Summary" in text and "Operator Summary" in text
    assert "Forward" in text and "aten::mm" in text
    assert "(16, 16)x(16, 16)" in text
    assert "avg step" in text
    rows = prof.statistics()
    assert rows and rows[0]["total_ms"] >= rows[-1]["total_ms"]
    mem = _events(0)
    assert "Memory Summary" in tstat.build_summary(
        mem, views=SummaryView.MemoryView)
    assert "Distributed Summary" in tstat.build_summary(
        mem, views=[SummaryView.DistributedView])


def test_analyze_prices_mm_rows(window, monkeypatch):
    prof, _ = window
    monkeypatch.delenv("PADDLE_TPU_DEVICE_SPEC", raising=False)
    rep = prof.analyze()
    assert rep.device.name == "cpu"
    assert rep.coverage > 0
    mm = [r for r in rep.rows if r["name"] == "aten::mm"]
    assert mm and mm[0]["flops"] == mm[0]["calls"] * 2 * 16 ** 3
    assert mm[0]["roofline_ms"] > 0 and mm[0]["efficiency"] > 0
    assert "roofline coverage" in rep.render()
    assert rep.to_dict()["device"] == "cpu"
    monkeypatch.setenv("PADDLE_TPU_DEVICE_SPEC", "h100-sxm-fp32")
    assert prof.analyze().device.name == "h100-sxm-fp32"
    assert prof.analyze(device="h100-sxm").device.name == "h100-sxm"


def test_resolve_device(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DEVICE_SPEC", raising=False)
    assert tstat._resolve_device(torch.device("cpu")).name == "cpu"
    assert tstat._resolve_device("cuda:0").name == "h100-sxm"
    assert tstat._resolve_device(None).name == "h100-sxm"
    spec = tstat._resolve_device("h100-sxm-fp32")
    assert tstat._resolve_device(spec) is spec


@pytest.mark.parametrize("name,dims,kinds,concrete,flops", [
    ("aten::mm", [[4, 8], [8, 3]], ["float", "float"], ["", ""],
     2 * 4 * 8 * 3),
    ("aten::addmm", [[3], [4, 8], [8, 3], [], []],
     ["float", "float", "float", "Scalar", "Scalar"], ["", "", "", "1", "1"],
     2 * 4 * 8 * 3),
    ("aten::sum", [[4, 8], [], [], []],
     ["c10::BFloat16", "ScalarList", "Scalar", ""], ["", "[1]", "False", ""],
     32),
    ("aten::tanh", [[5, 5]], ["float"], [""], 8 * 25),
])
def test_estimate_ref_redispatches_recorded_ops(name, dims, kinds, concrete,
                                                flops):
    from paddle_tpu_torch.cost_model import DEVICES
    strides = [None] * len(dims)
    est = tstat._estimate_ref((name, dims, kinds, strides, concrete),
                              DEVICES["cpu"])
    assert est is not None and est[0] == flops and est[1] > 0
    assert tstat._estimate_ref(("prim::Thing", [], [], [], []),
                               DEVICES["cpu"]) is None
    assert tstat._estimate_ref(("aten::mm", [[4, 8]], ["float"], [None],
                                [""]), DEVICES["cpu"]) is None


def test_timeline_loads_through_perf_report(window):
    _, tl = window
    records = perf_report.load_timeline(tl)
    assert [r["step"] for r in records] == [1, 2]
    assert all(perf_report.validate_record(r) == [] for r in records)
    for r in records:
        assert r["step_ms"] > 0
        assert "Forward" in r["phases"]
        assert any(op["name"] == "aten::mm" for op in r["ops"])
        assert r["mem_peak_bytes"] is None      # no allocator on the CPU


def test_export_chrome_tracing_takes_the_profiler_and_lists(window,
                                                            tmp_path):
    prof, _ = window
    path = export_chrome_tracing(str(tmp_path), "w0")(prof)
    assert prof._exported_path == path
    data = load_profiler_result(path)
    names = {e["name"] for e in data["traceEvents"] if e["ph"] == "X"}
    assert "ProfileStep#1" in names and "aten::mm" in names
    spans = [e for e in prof._window_events if e["type"] != "Operator"]
    path2 = export_chrome_tracing(str(tmp_path), "w1")(spans)
    got = json.load(open(path2))["traceEvents"]
    assert len([e for e in got if e["ph"] == "X"]) == len(spans)
    assert tprofiler.export_protobuf(str(tmp_path))(spans).endswith(
        ".paddle_trace.json")


def test_on_trace_ready_gets_the_profiler(tmp_path):
    seen = []
    prof = Profiler(scheduler=make_scheduler(closed=1, record=1, repeat=2),
                    on_trace_ready=seen.append, log_dir=str(tmp_path),
                    device="cpu")
    with prof:
        _mm_steps(prof, 4)
    assert seen == [prof, prof]
    assert len(os.listdir(tmp_path)) == 2         # one trace a window


def test_one_session_at_a_time(tmp_path):
    """A window opened while a capture records keeps its host spans and
    says why it has no device side."""
    prof = Profiler(log_dir=str(tmp_path / "p"), device="cpu")
    with tdp.DeviceProfiler(str(tmp_path / "d"), device="cpu"):
        with prof:
            _mm_steps(prof, 1)
    assert "one at a time" in prof.device_error
    assert prof.last_trace is None
    assert any(e["type"] == "Forward" for e in prof._events)


def test_profiler_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Profiler()
