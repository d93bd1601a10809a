"""The port's device profile against the JAX package's, on the CPU.

`paddle_tpu_torch/observability/deviceprof.py` is the counterpart of
`paddle_tpu/observability/deviceprof.py` over torch.profiler chrome traces
(`observability/kineto.py`, the counterpart of `xplane.py`):

  * a real CPU capture of `tanh(x @ w).sum()` (three calls) through the
    port's `capture(device="cpu")`: the operator lane of the calling
    thread, `aten::mm` with its three calls, fractions summing to 1, and
    a record that the port's and the JAX `validate_record` and
    `tools/perf_report.py` all accept;
  * `join_cost_model`, `validate_record` and `render_record` give the
    JAX functions' outputs on the same synthetic inputs, exactly, and
    `_self_times` the JAX self times for the same intervals, each side in
    its own event type (the reference's `test_self_time_unnests_containers`
    intervals among them);
  * kernel names as the card records them (`kernel_base_name`), the op a
    kernel serves (the port's kernels by name, a launch's aten op, the
    gemm table for graph replays), and the lanes `pick_lines` keeps
    (never `gpu_user_annotation`, never `cuda_runtime`) — on synthetic
    CUDA traces, since no card is here; a CUDA capture without kernels
    raises and is never read from its host lane;
  * the CLI (`python -m paddle_tpu_torch.observability.deviceprof`) over
    a capture and over an empty directory; the reader loads by file path
    without torch;
  * `Scheduler.capture_decode_steps` over a 2-layer GPT on the CPU,
    after `tests/test_deviceprof.py:398-480`: reported after a warm-up
    step, the armed and mid-window aborts, no gauges from a sick window;
    and the one-session rule, and `start_session` opening its window
    only after the session is prepared.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.observability import deviceprof as jdp
from paddle_tpu_torch.observability import deviceprof as tdp
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import kineto
from paddle_tpu_torch.observability import metrics as tmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import perf_report  # noqa: E402


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """One real CPU capture of three calls of a tiny step: (record,
    out_dir)."""
    out = str(tmp_path_factory.mktemp("trace"))
    x = torch.ones((16, 16))
    w = torch.ones((16, 16))

    def step():
        return torch.tanh(x @ w).sum()
    step()
    _, rec = tdp.capture(step, out, iters=3, device="cpu")
    return rec, out


# ------------------------------------------------------- capture + parse

def test_capture_parses_real_cpu_ops(capture):
    rec, out = capture
    assert rec["schema"] == tdp.SCHEMA == jdp.SCHEMA
    assert rec["decoder"] == "kineto-json"
    assert rec["xplane"].endswith(".pt.trace.json")
    assert os.path.dirname(rec["xplane"]) == out
    assert rec["line_rule"] == "cpu_ops"
    assert rec["plane"] == "/host:CPU"
    assert rec["line"] == f"thread {__import__('threading').get_native_id()}"
    ops = {o["op"]: o for o in rec["ops"]}
    assert ops["aten::mm"]["calls"] >= 3
    assert ops["aten::mm"]["prim"] == "aten::mm"
    assert ops["aten::mm"]["device_ms"] > 0
    assert "aten::tanh" in ops
    assert abs(sum(o["frac"] for o in rec["ops"]) - 1.0) < 1e-3
    assert rec["host_window_ms"] > 0


def test_record_passes_both_validators(capture, tmp_path):
    rec, _ = capture
    assert tdp.validate_record(rec) == []
    assert jdp.validate_record(rec) == []
    path = str(tmp_path / "deviceprof.jsonl")
    tdp.write_record(rec, path)
    assert jdp.load_records(path)[0] == json.loads(json.dumps(rec))
    recs = perf_report.load_deviceprof(path)
    assert perf_report.validate_deviceprof_record(recs[-1]) == []
    md = perf_report.render_deviceprof(recs)
    assert "aten::mm" in md and "device profile" in md


def test_capture_join_reconciles_with_the_cost_model(capture):
    from paddle_tpu_torch.cost_model import estimate
    rec = copy.deepcopy(capture[0])
    x = torch.ones((16, 16))
    rep = estimate(lambda a, b: torch.tanh(a @ b).sum(), x, x, device="cpu")
    per_op = {k: 1e3 * rep.device.roofline_s(c.flops, c.bytes)
              for k, c in rep.by_op.items()}
    tdp.join_cost_model(rec, per_op, steps=3)
    join = rec["join"]
    assert join["steps"] == 3 and join["reconciles"], join
    mm = next(r for r in join["per_op"] if r["op"] == "aten::mm")
    assert mm["predicted_ms"] == pytest.approx(per_op["aten::mm"], rel=1e-3)
    assert mm["efficiency"] > 0
    assert 0 < join["coverage"] <= 1.0
    assert jdp.validate_record(rec) == []


# ---------------------------------------------- parity with the JAX module

def _synthetic_record():
    ops = [{"op": "aten::mm", "prim": "aten::mm", "calls": 6,
            "device_ms": 3.0, "frac": 0.5, "hlo_module": "train::forward"},
           {"op": "vectorized_elementwise_kernel", "prim": "aten::add",
            "calls": 9, "device_ms": 1.5, "frac": 0.25, "hlo_module": None},
           {"op": "reduce", "prim": "reduce", "calls": 3, "device_ms": 0.9,
            "frac": 0.15, "hlo_module": None},
           {"op": "paged_decode_kernel", "prim": "paged_attention",
            "calls": 12, "device_ms": 0.6, "frac": 0.1,
            "hlo_module": "decode"}]
    return {"schema": tdp.SCHEMA, "ts": 1.0, "pid": 7,
            "xplane": "/t/x.pt.trace.json", "decoder": "kineto-json",
            "plane": "/device:GPU:0", "line": "stream 7",
            "line_rule": "device_kernels", "planes": [],
            "total_device_ms": 6.0, "n_events": 30, "modules": {},
            "ops": ops, "host_window_ms": 9.0}


@pytest.mark.parametrize("per_op,kw", [
    (None, {}),
    ({"aten::mm": 1.2, "aten::add": {"predicted_ms": 0.3},
      "reduce_sum": 0.1, "reduce_max": 0.05}, {"steps": 3}),
    ({"aten::mm": 4.0}, {"steps": 2, "wall_step_ms": 2.5}),
    ({"aten::add": 0.0}, {"steps": 1, "host_window_ms": 1.0}),
])
def test_join_validate_render_equal_jax(per_op, kw):
    a = tdp.join_cost_model(_synthetic_record(), copy.deepcopy(per_op),
                            **kw)
    b = jdp.join_cost_model(_synthetic_record(), copy.deepcopy(per_op),
                            **kw)
    assert a == b
    assert tdp.validate_record(a) == jdp.validate_record(b) == []
    for top in (2, 20):
        assert tdp.render_record(a, top=top) == jdp.render_record(b, top=top)


@pytest.mark.parametrize("mutate", [
    lambda r: r.update(schema="other.v9"),
    lambda r: r.update(ops=[]),
    lambda r: r.update(ops=[{"op": "aten::mm"}]),
    lambda r: r.update(total_device_ms=-1),
    lambda r: r.update(line=""),
    lambda r: r["ops"][0].update(frac=1.5),
    lambda r: r.update(join={"steps": "3"}),
    lambda r: r.update(join={"steps": 1, "device_ms_per_step": 1.0,
                             "reconciles": True, "coverage": 0.0,
                             "per_op": [{"op": "x"}]}),
])
def test_validate_record_equal_jax_on_rot(mutate):
    rec = _synthetic_record()
    mutate(rec)
    errs = tdp.validate_record(rec)
    assert errs and errs == jdp.validate_record(rec)


def _jax_ev(name, start, dur):
    class _E:
        pass
    e = _E()
    e.name, e.offset_ns, e.duration_ns = name, start, dur
    e.occurrences, e.stats = 1, {"hlo_op": name}
    return e


INTERVALS = [
    # the reference's container case: while.1 encloses dot.1 and add.1
    [("while.1", 0, 1000), ("dot.1", 100, 600), ("add.1", 700, 200),
     ("dot.2", 1200, 300)],
    # aten::matmul around aten::mm around resolve_conj, then siblings
    [("matmul", 0, 500), ("mm", 10, 480), ("conj", 20, 5), ("conj2", 30, 5),
     ("tanh", 600, 100), ("sum", 800, 50), ("sum_inner", 805, 40)],
    # a straddling event, nested twice, touching ends
    [("a", 0, 100), ("b", 50, 100), ("c", 150, 10), ("d", 160, 0),
     ("e", 160, 20)],
    # one start: raw durations
    [("x", 5, 10), ("y", 5, 20)],
]


@pytest.mark.parametrize("intervals", INTERVALS)
def test_self_times_equal_jax(intervals):
    jevs = [_jax_ev(n, s, d) for n, s, d in intervals]
    tevs = [kineto.Event(n, "cpu_op", s, d, 1, 1, {})
            for n, s, d in intervals]
    want = [(e.name, ns) for e, ns in jdp._self_times(jevs)]
    got = [(e.name, ns) for e, ns in tdp._self_times(tevs)]
    assert got == want


def test_self_times_unnest_containers_as_the_reference():
    tevs = [kineto.Event(n, "cpu_op", s, d, 1, 1, {})
            for n, s, d in INTERVALS[0]]
    self_ns = dict((e.name, ns) for e, ns in tdp._self_times(tevs))
    assert self_ns == {"while.1": 200, "dot.1": 600, "add.1": 200,
                       "dot.2": 300}


# ------------------------------------------ kernel names and attribution

KERNELS = [
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel", None),
    ("void paged_decode_kernel<float, float>(float const*, float const*, "
     "float const*, float const*, float const*, int const*, int const*, "
     "float*, int, int, int, float)", "paged_decode_kernel",
     "paged_attention"),
    ("void paged_window_kernel<float, float, 5>(float const*)",
     "paged_window_kernel", "paged_attention"),
    ("void paged_tile_kernel<float, float>(float const*)",
     "paged_tile_kernel", "paged_attention"),
    ("void flash_fwd_wgmma_kernel<64, false>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, Params)", "flash_fwd_wgmma_kernel",
     "flash_attention_fwd"),
    ("void flash_fwd_kernel<float, 64, true>(Params)", "flash_fwd_kernel",
     "flash_attention_fwd"),
    ("void flash_dq_wgmma_kernel<64, false>(CUtensorMap const, Params)",
     "flash_dq_wgmma_kernel", "flash_attention_dq"),
    ("void flash_dkv_kernel<float, 128, false>(Params)", "flash_dkv_kernel",
     "flash_attention_dkv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "aten::mm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN",
     "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN", "aten::mm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>("
     "cutlass_80_simt_sgemm_128x32_8x5_nn_align1::Params)",
     "cutlass_80_simt_sgemm_128x32_8x5_nn_align1", "aten::mm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, "
     "4, 4, false, false, cublasGemvParamsEx<int, cublasGemvTensorStrided"
     "Batched<float const>, cublasGemvTensorStridedBatched<float const>, "
     "cublasGemvTensorStridedBatched<float>, float> >(float, float)",
     "gemv2T_kernel_val", "aten::mm"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, "
     "float, float, at::native::(anonymous namespace)::SoftMaxForward"
     "Epilogue>(float*, float const*, int)", "cunn_SoftMaxForward", None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
     "#1}>, unsigned int, float, 4> >(at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
     "#1}>, unsigned int, float, 4>)", "reduce_kernel", None),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD", None),
    ("Memset (Device)", "Memset", None),
]


@pytest.mark.parametrize("name,base,prim", KERNELS)
def test_kernel_names_and_the_prim_table(name, base, prim):
    assert tdp.kernel_base_name(name) == base
    assert tdp.kernel_prim(base, name) == prim
    # an eager launch's aten op wins over the gemm table, never over the
    # port's own kernels
    want = prim if prim and not prim.startswith("aten::") else "aten::addmm"
    assert tdp.kernel_prim(base, name, op="aten::addmm") == want


def _x(cat, name, ts, dur, pid, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _cuda_trace(kernels=True):
    """A two-step CUDA trace as Kineto writes one: an eager addmm launch,
    a CUDA graph replay (decode) of a gemm and the paged kernel, device
    ranges of the spans on the same stream, a memcpy, a flow event."""
    host, dev = 100, 0
    ev = [
        {"ph": "M", "name": "process_name", "pid": host, "tid": 0,
         "args": {"name": "python"}},
        _x("user_annotation", "serving::decode_step", 0.0, 100.0, host, 1),
        _x("user_annotation", "graph::decode", 10.0, 20.0, host, 1),
        _x("cuda_runtime", "cudaGraphLaunch", 12.0, 5.0, host, 1,
           correlation=7),
        _x("cpu_op", "aten::linear", 40.0, 30.0, host, 1),
        _x("cpu_op", "aten::addmm", 45.0, 20.0, host, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 50.0, 4.0, host, 1,
           correlation=9),
        _x("cuda_runtime", "cudaMemcpyAsync", 80.0, 3.0, host, 1,
           correlation=11),
        _x("gpu_user_annotation", "serving::decode_step", 20.0, 80.0, dev, 7,
           device=0, stream=7),
        _x("gpu_user_annotation", "graph::decode", 20.0, 12.0, dev, 7,
           device=0, stream=7),
        {"ph": "s", "id": 7, "pid": host, "tid": 1, "ts": 12.0,
         "cat": "ac2g", "name": "ac2g"},
    ]
    if kernels:
        ev += [
            _x("kernel", "void gemv2T_kernel_val<float>(float)", 20.0, 6.0,
               dev, 7, device=0, stream=7, correlation=7),
            _x("kernel", "void paged_decode_kernel<float, float>(float "
               "const*)", 26.0, 2.0, dev, 7, device=0, stream=7,
               correlation=7),
            _x("kernel", "sm90_xmma_gemm_f32f32_tn_n_kernel", 60.0, 10.0,
               dev, 7, device=0, stream=7, correlation=9),
            _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 85.0, 1.0,
               dev, 7, device=0, stream=7, correlation=11),
        ]
    return {"schemaVersion": 1, "deviceProperties": [{"id": 0,
                                                      "name": "H100"}],
            "traceEvents": ev, "baseTimeNanoseconds": 10**18}


def test_parse_synthetic_cuda_trace(tmp_path):
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps(_cuda_trace()))
    rec = tdp.parse(str(path))
    assert jdp.validate_record(rec) == []
    assert rec["plane"] == "/device:GPU:0" and rec["line"] == "stream 7"
    assert rec["line_rule"] == "device_kernels"
    rows = {(o["op"], o["prim"]): o for o in rec["ops"]}
    assert set(rows) == {("gemv2T_kernel_val", "aten::mm"),
                         ("paged_decode_kernel", "paged_attention"),
                         ("sm90_xmma_gemm_f32f32_tn_n_kernel",
                          "aten::addmm"),
                         ("Memcpy DtoH", None)}
    assert rows[("paged_decode_kernel", "paged_attention")]["hlo_module"] \
        == "decode"
    assert rows[("sm90_xmma_gemm_f32f32_tn_n_kernel", "aten::addmm")][
        "hlo_module"] == "serving::decode_step"
    # the device ranges of the spans never count: 6 + 2 + 10 + 1 µs
    assert rec["total_device_ms"] == pytest.approx(0.019)
    assert rec["n_events"] == 4
    assert rec["modules"] == {"serving::decode_step": 0.011, "decode": 0.008}


def test_a_cuda_capture_without_kernels_raises(tmp_path):
    """Only device ranges and host events: never read from the host
    lane, although it holds cpu_op events."""
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps(_cuda_trace(kernels=False)))
    with pytest.raises(tdp.CaptureError, match="never read from its host"):
        tdp.parse(str(path))


def test_pick_lines_skips_annotations_and_runtime_events():
    ann = kineto.Line("stream 9", [kineto.Event(
        "serving::decode_step", "gpu_user_annotation", 0, 100, 0, 9, {})])
    mixed = kineto.Line("stream 7", [
        kineto.Event("graph::decode", "gpu_user_annotation", 0, 100, 0, 7,
                     {}),
        kineto.Event("k", "kernel", 10, 5, 0, 7, {})])
    gpu = kineto.Plane("/device:GPU:0", [ann, mixed], 0)
    assert [(ln.name, rule) for ln, rule in tdp.pick_lines(gpu)] == \
        [("stream 7", "device_kernels")]
    runtime = kineto.Line("thread 2", [kineto.Event(
        "cudaLaunchKernel", "cuda_runtime", 0, 50, 1, 2, {})])
    ops = kineto.Line("thread 3", [kineto.Event(
        "aten::mm", "cpu_op", 0, 5, 1, 3, {})])
    host = kineto.Plane("/host:CPU", [runtime, ops], None)
    assert [(ln.name, rule) for ln, rule in tdp.pick_lines(host)] == \
        [("thread 3", "cpu_ops")]
    assert tdp.pick_lines(host, thread=2) == []
    assert tdp.device_planes([host, gpu]) == [gpu]
    assert tdp.pick_lines(kineto.Plane("/device:GPU:1", [ann], 1)) == []


@pytest.mark.parametrize("data,match", [
    (b"", "empty trace"),
    (b'{"traceEvents": [{"ph": "X", "ts": 1', "not JSON"),
    (b'{"events": []}', "no traceEvents"),
    (b'[1, 2]', "not an object"),
    (b'{"traceEvents": [1]}', "event 0 is int"),
    (b'{"traceEvents": [{"ph": "X", "ts": "a", "dur": 1}]}',
     "is not a number"),
])
def test_malformed_traces_raise(tmp_path, data, match):
    with pytest.raises(kineto.DecodeError, match=match):
        kineto.Trace.from_bytes(data)
    path = tmp_path / "bad.pt.trace.json"
    path.write_bytes(data)
    with pytest.raises(tdp.CaptureError, match="not a parseable"):
        tdp.parse(str(path))


def test_reader_loads_by_file_path_without_torch(tmp_path):
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps(_cuda_trace()))
    code = (
        "import importlib.util, sys\n"
        "def load(name, rel):\n"
        "    spec = importlib.util.spec_from_file_location(name, rel)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "k = load('k', 'paddle_tpu_torch/observability/kineto.py')\n"
        "d = load('d', 'paddle_tpu_torch/observability/deviceprof.py')\n"
        f"t = k.Trace.from_file({str(path)!r})\n"
        f"rec = d.parse({str(path)!r})\n"
        "assert [p.name for p in t.planes] == ['/device:GPU:0', "
        "'/host:CPU'], t\n"
        "assert rec['n_events'] == 4\n"
        "assert 'torch' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


# -------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.observability.deviceprof",
         *args], capture_output=True, text=True, timeout=120, cwd=ROOT)


def test_cli_over_a_capture_and_an_empty_dir(capture, tmp_path):
    _, out = capture
    jsonl = str(tmp_path / "cli.jsonl")
    proc = _cli(out, "5", "--jsonl", jsonl, "--join-steps", "3")
    assert proc.returncode == 0, proc.stderr
    assert "| aten::mm | aten::mm |" in proc.stdout
    assert "device profile" in proc.stdout and "### join" in proc.stdout
    perf_report.load_deviceprof(jsonl)
    empty = tmp_path / "empty"
    empty.mkdir()
    proc = _cli(str(empty))
    assert proc.returncode == 1
    assert "FAILED" in proc.stderr and ".pt.trace.json" in proc.stderr


# ---------------------------------------------------- the one-session rule

def test_one_profiler_session_at_a_time(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(tdp.CaptureError, match="one at a time"):
            with tdp.DeviceProfiler(str(tmp_path), device="cpu"):
                pass
        ctrl = tdp.OneShotCapture(str(tmp_path / "b"), label="t1",
                                  device="cpu")
        assert ctrl.start() is False
        assert ctrl.state == "failed" and "one at a time" in ctrl.error


def test_start_session_opens_the_window_after_prepare():
    """`start_session` prepares a session and only then opens its
    window: what runs in between (on the card, the warm-up launches)
    stays out of the record; what runs after is in it."""
    calls = []

    class Session:
        def prepare_trace(self):
            calls.append("prepare")

        def start_trace(self):
            calls.append("start")
    tdp.start_session(Session())
    assert calls == ["prepare", "start"]
    acts = [torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=acts)
    prof.prepare_trace()
    torch.ones(4).exp()
    prof.start_trace()
    torch.ones(4).tanh()
    prof.stop()
    names = {e.name for e in prof.events()}
    assert "aten::tanh" in names and "aten::exp" not in names
    prof = torch.profiler.profile(activities=acts)
    tdp.start_session(prof)
    torch.ones(4).tanh()
    prof.stop()
    assert "aten::tanh" in {e.name for e in prof.events()}


def test_capture_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdp.DeviceProfiler(str(tmp_path))


# ------------------------------------- serving capture-N-decode-steps hook

@pytest.fixture(scope="module")
def tiny():
    from paddle_tpu_torch.text.models import gpt_tiny
    m = gpt_tiny(device="cpu")
    m.eval()
    return m


def test_scheduler_capture_decode_steps(tmp_path, tiny):
    from paddle_tpu_torch.serving import GenerationEngine, Scheduler
    eng = GenerationEngine(tiny, slots=2, max_len=48, device="cpu")
    sched = Scheduler(eng, device="cpu", max_queue=8)
    out = str(tmp_path / "serving_trace")
    ctrl = sched.capture_decode_steps(steps=2, out_dir=out)
    rng = np.random.RandomState(0)
    for i in range(2):
        sched.submit(rng.randint(0, tiny.cfg.vocab_size, 4 + i),
                     max_new_tokens=8)
    sched.step()                    # the first decode step: never captured
    assert ctrl.armed
    sched.run_until_idle()
    assert ctrl.state == "reported", (ctrl.state, ctrl.error)
    block = sched.last_capture
    assert block["state"] == "reported"
    records = tdp.load_records(block["jsonl"])
    assert jdp.validate_record(records[-1]) == []
    join = records[-1]["join"]
    assert join["steps"] == 2
    assert join["device_ms_per_step"] > 0 and join["wall_ms_per_step"] > 0
    assert join["reconciles"], join
    assert "serving::decode_step" in records[-1]["modules"]
    assert "### join" in open(block["report"]).read()
    note = tfr.get().annotations.get("deviceprof.serving")
    assert note and note["state"] == "reported"


def test_scheduler_capture_abort_is_never_silent(tmp_path, tiny,
                                                 monkeypatch):
    from paddle_tpu_torch.serving import GenerationEngine, Scheduler

    # armed: the first active step fails before any healthy step
    eng = GenerationEngine(tiny, slots=1, max_len=32, device="cpu")
    sched = Scheduler(eng, device="cpu", max_queue=4)
    ctrl = sched.capture_decode_steps(steps=2,
                                      out_dir=str(tmp_path / "armed"))
    monkeypatch.setattr(eng, "decode",
                        lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    sched.submit([1, 2, 3], max_new_tokens=4)
    sched.step()
    assert ctrl.state == "failed", ctrl.state
    assert sched.last_capture["state"] == "failed"
    assert "boom" in sched.last_capture["aborted_by"]
    assert tfr.get().annotations["deviceprof.serving"]["state"] == "failed"

    # mid-window: one healthy captured step, then a failure
    eng2 = GenerationEngine(tiny, slots=1, max_len=32, device="cpu")
    sched2 = Scheduler(eng2, device="cpu", max_queue=4)
    ctrl2 = sched2.capture_decode_steps(steps=10,
                                        out_dir=str(tmp_path / "mid"))
    sched2.submit([4, 5, 6], max_new_tokens=8)
    sched2.step()                       # warm-up (uncaptured)
    sched2.step()                       # captured step 1 of 10
    assert ctrl2.state == "capturing"
    tmetrics.registry().reset()         # a clean slate for the gauges
    real_decode = eng2.decode
    monkeypatch.setattr(eng2, "decode",
                        lambda: (_ for _ in ()).throw(RuntimeError("sick")))
    sched2.step()
    monkeypatch.setattr(eng2, "decode", real_decode)
    block = sched2.last_capture
    assert block["state"] == "reported"
    assert "sick" in block["aborted_by"]
    rec = tdp.load_records(block["jsonl"])[-1]
    assert "sick" in rec["aborted_by"]
    assert rec["join"]["steps"] == 1
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot())
    assert flat.get("deviceprof_total_device_ms_per_step", 0.0) == 0.0
    # the torch profiler is closed again: a new capture can start
    assert not torch.autograd._profiler_enabled()


def test_gauges_land_in_the_port_registry(capture):
    from paddle_tpu.observability import metrics as jmetrics
    rec = copy.deepcopy(capture[0])
    tdp.join_cost_model(rec, {"aten::mm": 1e-3}, steps=3)
    jbefore = jmetrics.flatten_snapshot(jmetrics.registry().snapshot())
    tdp.export_gauges(rec)
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot())
    assert flat["deviceprof_total_device_ms_per_step"] > 0
    assert flat["deviceprof_min_op_efficiency"] > 0
    assert any(k.startswith("deviceprof_op_efficiency{op=aten::mm")
               for k in flat), sorted(flat)
    jafter = jmetrics.flatten_snapshot(jmetrics.registry().snapshot())
    assert {k: v for k, v in jafter.items() if k.startswith("deviceprof")} \
        == {k: v for k, v in jbefore.items() if k.startswith("deviceprof")}
