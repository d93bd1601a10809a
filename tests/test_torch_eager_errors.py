"""Errors of the eager surface: FLAGS_check_nan_inf, the op context note,
argument checks that raise the JAX package's messages, and the Operator
spans apply_op records for the profiler (CPU).

Oracles: `tests/test_nan_check.py` and `test_error_messages.py` of the
JAX package (their nn cases wait for ROADMAP 13b), and the argument
checks of `test_op_semantics_r4b.py`."""
import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework import flags as jflags
from paddle_tpu_torch.framework import flags as tflags


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield


@pytest.fixture
def nan_flag():
    old = (jflags.get_flags("FLAGS_check_nan_inf"),
           tflags.get_flags("FLAGS_check_nan_inf"))
    jflags.set_flags({"FLAGS_check_nan_inf": True})
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    yield
    jflags.set_flags(old[0])
    tflags.set_flags(old[1])


# ------------------------------------------------------ FLAGS_check_nan_inf
@pytest.mark.parametrize("what,fn,op", [
    ("log of -1", lambda P: P.log(P.to_tensor(
        np.array([1.0, -1.0], np.float32))), "log"),
    ("1 / 0", lambda P: P.to_tensor(np.ones(2, np.float32))
     / P.to_tensor(np.array([0.0, 2.0], np.float32)), "divide"),
    ("sqrt of -4", lambda P: P.sqrt(P.to_tensor(
        np.array([-4.0], np.float32))), "sqrt"),
    ("exp overflow", lambda P: P.exp(P.to_tensor(
        np.array([1000.0], np.float32))), "exp"),
    ("matmul of inf", lambda P: P.matmul(P.to_tensor(
        np.array([[np.inf, 1.0]], np.float32)), P.to_tensor(
        np.array([[0.0], [1.0]], np.float32))), "matmul"),
])
def test_nan_check_raises_naming_the_op(nan_flag, what, fn, op):
    with pytest.raises(RuntimeError, match="FLAGS_check_nan_inf"):
        fn(pj)
    with pytest.raises(RuntimeError, match=f"FLAGS_check_nan_inf: op "
                                           f"'{op}' produced NaN/Inf"):
        fn(pt)


def test_nan_check_catches_nan_in_backward_ops(nan_flag):
    x = pt.to_tensor(np.array([0.0, 1.0], np.float32), stop_gradient=False)
    y = pt.sqrt(x)                      # finite forward, inf gradient
    loss = (y * 2.0).sum()
    loss.backward()                     # torch's backward is not an op
    assert np.isinf(x.grad.numpy()[0])
    with pytest.raises(RuntimeError, match="'multiply'"):
        x.grad * 1.0


def test_clean_ops_pass_and_flag_off_is_silent():
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = pt.to_tensor(np.array([1.0, 2.0], np.float32))
        assert float((x * x).sum()) == 5.0
        assert pt.argmax(x).item() == 1          # integer outputs skipped
    finally:
        tflags.set_flags({"FLAGS_check_nan_inf": False})
    out = pt.log(pt.to_tensor(np.array([-1.0], np.float32)))
    assert np.isnan(out.numpy()).all()


def test_nan_flag_is_read_from_the_environment(tmp_path):
    import os
    import subprocess
    import sys
    code = ("import numpy as np, paddle_tpu_torch as pt\n"
            "pt.set_device('cpu')\n"
            "try:\n"
            "    pt.log(pt.to_tensor(np.array([-1.0], np.float32)))\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', 'log' in str(e))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["FLAGS_check_nan_inf"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert "RAISED True" in r.stdout, r.stderr


# ------------------------------------------------------- op context notes
def test_op_error_context_note():
    for P in (pj, pt):
        a = P.to_tensor(np.ones((2, 3), "float32"))
        b = P.to_tensor(np.ones((4, 5), "float32"))
        with pytest.raises(Exception) as info:
            a @ b
        notes = "\n".join(getattr(info.value, "__notes__", []))
        assert "[operator <" in notes and "Tensor(2, 3)" in notes, notes
    with pytest.raises(RuntimeError) as info:
        pt.reshape(pt.ones([2, 3]), [4, 4])
    notes = "\n".join(info.value.__notes__)
    assert "[operator < reshape > error]" in notes
    assert "Tensor(2, 3):float32" in notes


# --------------------------------------------------------- argument checks
@pytest.mark.parametrize("what,fn,exc,match", [
    ("take out of range", lambda P: P.take(
        P.to_tensor(np.arange(6.0)), P.to_tensor(np.array([6]))),
     ValueError, r"\(InvalidArgument\) take: index out of range"),
    ("take bad mode", lambda P: P.take(
        P.to_tensor(np.arange(6.0)), P.to_tensor(np.array([1])), "foo"),
     ValueError, "'mode' in 'take'"),
    ("quantile q range", lambda P: P.quantile(
        P.to_tensor(np.arange(4.0)), 1.5), ValueError, r"range \[0, 1\]"),
    ("quantile empty q", lambda P: P.quantile(
        P.to_tensor(np.arange(4.0)), []), ValueError, "q should not be empty"),
    ("median axis type", lambda P: P.median(
        P.to_tensor(np.zeros((2, 3), np.float32)), axis=[0]),
     ValueError, "axis should be none or an integer"),
    ("median axis range", lambda P: P.median(
        P.to_tensor(np.zeros((2, 3), np.float32)), axis=2),
     ValueError, "axis should be none or an integer"),
    ("median of a 0-d tensor on axis 0", lambda P: P.median(
        P.to_tensor(np.float32(3.0)), axis=0),
     ValueError, "axis should be none or an integer"),
    ("nanquantile q range", lambda P: P.nanquantile(
        P.to_tensor(np.ones(3, np.float32)), [-0.2, 0.5]),
     ValueError, "range"),
    ("nanmedian empty axis", lambda P: P.nanmedian(
        P.to_tensor(np.zeros((2, 3), np.float32)), axis=[]),
     ValueError, "Axis list should not be empty"),
    ("split not divisible", lambda P: P.split(
        P.to_tensor(np.zeros((2, 5), np.float32)), 2, axis=1),
     ValueError, "not divisible"),
    ("arange tensor bounds", lambda P: P.arange(P.to_tensor(3)),
     TypeError, "arange over Tensor bounds"),
    ("fill_diagonal_ wrap", lambda P: P.zeros([3, 3]).fill_diagonal_(
        1.0, wrap=True), NotImplementedError, "wrap=True"),
    ("unknown dtype", lambda P: P.to_tensor([1.0], dtype="float7"),
     ValueError, "Unknown dtype"),
    ("hook on a constant", lambda P: P.ones([2]).register_hook(
        lambda g: g), RuntimeError, "stop_gradient=True"),
])
def test_argument_checks_match_jax(what, fn, exc, match):
    for P in (pj, pt):
        with pytest.raises(exc, match=match):
            fn(P)


# --------------------------------------------------------- profiler spans
def test_apply_op_records_operator_spans_while_profiling():
    from paddle_tpu_torch import profiler
    tracer = profiler._tracer
    x = pt.to_tensor(np.ones((2, 3), np.float32))
    assert not tracer.enabled
    before = len(tracer.events)
    pt.exp(x)
    assert len(tracer.events) == before          # closed: nothing recorded
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU],
                             timer_only=True, device="cpu")
    prof.start()
    y = pt.matmul(x, pt.transpose(x, [1, 0]))
    pt.tanh(y).sum()
    prof.stop()
    ops = [e for e in prof._events if e["type"] == "Operator"]
    names = [e["name"] for e in ops]
    assert names[:4] == ["transpose", "matmul", "tanh", "sum"], names
    assert ops[1]["attrs"]["input_shapes"] == [(2, 3), (3, 2)]
    assert ops[1]["attrs"]["input_dtypes"] == ["float32", "float32"]
    assert not tracer.enabled


def test_apply_op_opens_record_function_under_torch_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import profiler
    x = pt.to_tensor(np.ones((4, 4), np.float32))
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU],
                             timer_only=True, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        prof.start()
        pt.matmul(x, x)
        prof.stop()
    keys = {e.key for e in tp.key_averages()}
    assert "matmul" in keys, sorted(keys)[:20]
    assert torch.is_grad_enabled()
