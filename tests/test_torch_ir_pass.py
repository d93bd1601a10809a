"""The port's program passes (`paddle_tpu_torch/static/ir_pass.py`,
`distributed/passes.py`) against the JAX package's, on the CPU: the
counterparts of `tests/test_ir_pass.py`.

Both packages capture the same function over the same seeded weights
(`static.Program.capture`); outputs before and after a pass are held to
each other (1e-5 in float32; 5e-2 after the bf16 `amp` pass, as the
oracle) and the oracle's IR assertions hold in both, through one table of
names: a jaxpr prints `dot_general`, `convert_element_type`, `remat`,
`while`, and the port's fx graph `mm`, `_to_copy`, `recompute`,
`while_loop` (ROADMAP C.18). User rules are written once per package
(jnp in one, torch in the other).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.distributed import passes as jpasses
from paddle_tpu.static.ir_pass import register_pass as jregister
from paddle_tpu_torch.distributed import passes as tpasses
from paddle_tpu_torch.jit.dy2static import (traced_cond, traced_scan,
                                            traced_while)
from paddle_tpu_torch.static.ir_pass import register_pass as tregister

# reference IR word -> the port's
NAMES = {"dot_general": "mm", "convert_element_type": "_to_copy",
         "bf16": "bf16", "remat": "recompute", "scan": "scan",
         "while": "while_loop", "cond": "cond", "tanh": "tanh",
         "clip": "clamp", "neg": "neg", "mul": "mul", "round": "round"}

PKGS = ((pj, jpasses, jregister, "jax"), (pt, tpasses, tregister, "port"))


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _word(w, side):
    return w if side == "jax" else NAMES[w]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _mlp_program(P):
    w1 = P.to_tensor(np.random.RandomState(0).randn(8, 16).astype("float32"))
    w2 = P.to_tensor(np.random.RandomState(1).randn(16, 4).astype("float32"))

    def fn(x):
        h = P.nn.functional.relu(P.matmul(x, w1))
        return P.matmul(h, w2)

    return P.static.Program.capture(
        fn, P.static.InputSpec((2, 8), "float32", "x"))


def _both(make):
    return [(make(P), passes, side) for P, passes, _, side in PKGS]


def test_amp_pass_inserts_casts_and_preserves_semantics():
    x = np.random.RandomState(2).randn(2, 8).astype("float32")
    outs = []
    for prog, passes, side in _both(_mlp_program):
        before = prog.to_string()
        assert "bf16" not in before
        golden = _np(prog.run_captured(x)[0])
        out_prog = passes.new_pass("amp").apply(prog)
        after = out_prog.to_string()
        assert after != before
        assert "bf16" in after                      # casts now in the IR
        assert _word("convert_element_type", side) in after
        got = _np(out_prog.run_captured(x)[0])
        assert got.dtype == np.float32              # output dtype restored
        np.testing.assert_allclose(got, golden, rtol=5e-2, atol=5e-2)
        outs.append((golden, got))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=5e-2, atol=5e-2)


def test_recompute_pass_tags_matmuls():
    x = np.random.RandomState(3).randn(2, 8).astype("float32")
    for prog, passes, side in _both(_mlp_program):
        tag = _word("remat", side)
        before = prog.to_string()
        assert tag not in before
        golden = _np(prog.run_captured(x)[0])
        passes.new_pass("recompute").apply(prog)
        after = prog.to_string()
        assert tag in after                         # checkpoint tags
        got = _np(prog.run_captured(x)[0])
        np.testing.assert_allclose(got, golden, rtol=1e-6)
    tagged = [n for n in prog.graph_module.graph.nodes
              if n.op == "call_function" and "recompute" in n.meta]
    assert [str(n.target) for n in tagged] == ["aten.mm.default"] * 2


def _hard_tanh_rule(side):
    def rule(op, attrs):
        if op.name != "tanh":
            return None
        if side == "jax":
            return [jnp.clip(op.inputs[0], -1.0, 1.0)]
        return [torch.clamp(op.inputs[0], -1.0, 1.0)]
    return rule


def test_custom_user_pass_in_a_few_lines():
    x = np.array([-1.0, -0.1, 0.1, 1.0], "float32")
    for P, passes, register, side in PKGS:
        register("hard_tanh")(_hard_tanh_rule(side))

        def fn(v):
            return P.tanh(v * 3.0)

        prog = P.static.Program.capture(
            fn, P.static.InputSpec((4,), "float32"))
        assert _word("tanh", side) in prog.to_string()
        passes.new_pass("hard_tanh").apply(prog)
        s = prog.to_string()
        assert _word("tanh", side) not in s and _word("clip", side) in s
        np.testing.assert_allclose(_np(prog.run_captured(x)[0]),
                                   np.clip(3 * x, -1, 1), rtol=1e-6)


def test_delete_op_by_forwarding_inputs():
    x = np.ones((3,), "float32")
    for P, passes, register, side in PKGS:
        def drop_neg(op, attrs):
            return [op.inputs[0]] if op.name == "neg" else None

        def fn(v):
            return -(v * 2.0)

        prog = P.static.Program.capture(
            fn, P.static.InputSpec((3,), "float32"))
        assert _word("neg", side) in prog.to_string()
        prog.apply_pass(drop_neg)
        assert _word("neg", side) not in prog.to_string()
        np.testing.assert_allclose(_np(prog.run_captured(x)[0]), 2 * x)


def test_orphaned_input_keeps_calling_convention():
    x = np.ones((3,), "float32")
    y = 5 * np.ones((3,), "float32")
    for P, passes, register, side in PKGS:
        def zero_mul(op, attrs):
            if op.name != "mul":
                return None
            a = op.out_avals[0]
            if side == "jax":
                return [jnp.zeros(a.shape, a.dtype)]
            return [torch.zeros(a.shape, dtype=a.dtype)]

        def fn(a, b):
            return P.add(P.multiply(b, b), a)

        prog = P.static.Program.capture(
            fn, P.static.InputSpec((3,), "float32"),
            P.static.InputSpec((3,), "float32"))
        prog.apply_pass(zero_mul)
        # y is now dead, but run_captured still takes both args
        np.testing.assert_allclose(_np(prog.run_captured(x, y)[0]), x)


def test_pass_manager_composes_and_records_context():
    for prog, passes, side in _both(_mlp_program):
        pm = passes.PassManager([passes.new_pass("recompute"),
                                 passes.new_pass("amp")])
        pm.apply(prog)
        s = prog.to_string()
        assert _word("remat", side) in s and "bf16" in s
        assert pm.context.get_attr("amp") is True
        assert pm.names == ["recompute", "amp"]


def test_quantization_pass_fake_quants_matmuls():
    """QAT pass: matmul inputs get abs-max fake-quant; output stays close
    to golden (and to the JAX package's quantized output); the STE keeps
    the program differentiable."""
    x = np.random.RandomState(5).randn(2, 8).astype("float32")
    outs = []
    for prog, passes, side in _both(_mlp_program):
        golden = _np(prog.run_captured(x)[0])
        before = prog.to_string()
        passes.new_pass("quantization", {"weight_bits": 8,
                                         "activation_bits": 8}).apply(prog)
        after = prog.to_string()
        assert after != before and _word("round", side) in after
        got = _np(prog.run_captured(x)[0])
        assert np.abs(got - golden).max() < 0.15 * (np.abs(golden).max() + 1)
        assert not np.allclose(got, golden)       # the quant really applied
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)

    # the port's program is still trainable: grads flow through the STE
    xt = torch.tensor(x, requires_grad=True)
    out = prog.graph_module(xt)
    sum(o.sum() for o in out).backward()
    assert bool(torch.isfinite(xt.grad).all()) and \
        float(xt.grad.abs().max()) > 0
    jcj = _both(_mlp_program)[0][0]
    jpasses.new_pass("quantization").apply(jcj)
    g = jax.grad(lambda xx: sum(jnp.sum(o) for o in jax.core.eval_jaxpr(
        jcj._jaxpr.jaxpr, jcj._jaxpr.consts, xx)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-4,
                               atol=1e-4)


def test_unknown_pass_still_raises():
    for _, passes, _, _ in PKGS:
        with pytest.raises(ValueError):
            passes.new_pass("definitely_not_a_pass").apply(object())


W_SCAN = np.random.RandomState(0).randn(4, 8, 8).astype("float32") * 0.3


def _scan_cond_program(P, side):
    """Layers stacked in a scan, then a cond on the result."""
    if side == "jax":
        def fn(x):
            def body(h, wi):
                return jnp.tanh(h @ wi), ()
            h, _ = jax.lax.scan(body, x._data, jnp.asarray(W_SCAN))
            out = jax.lax.cond(jnp.sum(h) > 0,
                               lambda v: v @ jnp.ones((8, 8), "float32"),
                               lambda v: v, h)
            return pj.Tensor(out)
    else:
        def fn(x):
            def body(h, wi):
                h = torch.tanh(h @ wi)
                return h, h.sum()
            h, _ = traced_scan(body, (x._data,), (torch.tensor(W_SCAN),))
            (out,) = traced_cond(h.sum() > 0,
                                 lambda v: (v @ torch.ones(8, 8),),
                                 lambda v: (v,), (h,))
            return pt.Tensor(out)
    return P.static.Program.capture(fn, P.static.InputSpec((2, 8),
                                                           "float32"))


def test_passes_see_inside_scan_and_cond():
    """Captured models stack layers in a scan; the amp pass must rewrite
    the products INSIDE the scan body (and cond branches) or it misses
    most of the model."""
    x = np.random.RandomState(1).randn(2, 8).astype("float32")
    res = []
    for P, passes, register, side in PKGS:
        prog = _scan_cond_program(P, side)
        golden = _np(prog.run_captured(x)[0])
        before = prog.to_string()
        assert _word("scan", side) in before and "bf16" not in before
        amp_prog = copy.copy(prog)
        passes.new_pass("amp").apply(amp_prog)
        assert "bf16" in amp_prog.to_string()
        register(f"scan_hard_tanh_{side}")(_hard_tanh_rule(side))
        passes.new_pass(f"scan_hard_tanh_{side}").apply(prog)
        assert _word("tanh", side) not in prog.to_string()
        got = _np(prog.run_captured(x)[0])
        assert not np.allclose(got, golden)        # rewrite really applied
        np.testing.assert_allclose(got, golden, atol=0.6)   # same ballpark
        res.append((golden, got))
    for a, b in zip(res[0], res[1]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    # the port runs its bf16 products inside the scan too
    np.testing.assert_allclose(_np(amp_prog.run_captured(x)[0]), res[1][0],
                               rtol=5e-2, atol=5e-2)


def test_passes_see_inside_while_loop():
    x = np.array([-2.0, -0.1, 0.1, 2.0], "float32")
    expect = x
    for _ in range(3):
        expect = np.clip(expect * 2.0, -1.0, 1.0)
    for P, passes, register, side in PKGS:
        if side == "jax":
            def fn(v):
                def cond(c):
                    return c[0] < 3

                def body(c):
                    return c[0] + 1, jnp.tanh(c[1] * 2.0)

                _, h = jax.lax.while_loop(cond, body, (jnp.int32(0), v._data))
                return pj.Tensor(h)
        else:
            def fn(v):
                _, h = traced_while(lambda i, h: i < 3,
                                    lambda i, h: (i + 1, torch.tanh(h * 2.0)),
                                    (torch.tensor(0), v._data))
                return pt.Tensor(h)
        prog = P.static.Program.capture(fn, P.static.InputSpec((4,),
                                                               "float32"))
        assert _word("while", side) in prog.to_string()
        golden = _np(prog.run_captured(x)[0])
        register(f"while_hard_tanh_{side}")(_hard_tanh_rule(side))
        passes.new_pass(f"while_hard_tanh_{side}").apply(prog)
        assert _word("tanh", side) not in prog.to_string()
        got = _np(prog.run_captured(x)[0])
        # hard-tanh(3 iters): values clamp to exactly ±1
        np.testing.assert_allclose(got, expect, rtol=1e-6)
        assert not np.allclose(got, golden)


def test_executor_runs_captured_and_rewritten_program():
    """Reference UX: exe.run(program, feed={...}) over a captured (and
    pass-rewritten) Program."""
    x = np.random.RandomState(7).randn(2, 8).astype("float32")
    got = []
    for prog, passes, side in _both(_mlp_program):
        P = pj if side == "jax" else pt
        exe = P.static.Executor()
        golden = exe.run(prog, feed={"x": x})[0]
        passes.new_pass("amp").apply(prog)
        amp = exe.run(prog, feed={"x": x})[0]
        np.testing.assert_allclose(amp, golden, rtol=5e-2, atol=5e-2)
        with pytest.raises(KeyError):
            exe.run(prog, feed={})
        got.append(golden)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-5)


def test_apply_pass_requires_captured_ir():
    for P, _, _, _ in PKGS:
        with pytest.raises(ValueError):
            P.static.Program().apply_pass(lambda op, attrs: None)


def test_amp_pass_keeps_the_flash_node(monkeypatch):
    """An attention Layer's program on the kernel route: the amp pass
    casts the projections' products to bf16 and leaves the flash op (one
    node, f32) in place; the output stays within bf16 rounding."""
    import paddle_tpu_torch.nn.functional.attention as A
    monkeypatch.setattr(A, "sdpa_route", lambda q, k, d: "kernel")
    pt.seed(0)
    layer = pt.nn.TransformerEncoderLayer(128, 2, 256, dropout=0.0)
    layer.eval()

    def fn(x):
        return layer(x)

    prog = pt.static.Program.capture(fn, pt.static.InputSpec((2, 128, 128)))
    x = np.random.RandomState(0).randn(2, 128, 128).astype("float32")
    golden = _np(prog.run_captured(x)[0])
    np.testing.assert_allclose(golden, layer(pt.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    tpasses.new_pass("amp").apply(prog)
    s = prog.to_string()
    assert "bf16" in s
    assert [o.type() for o in prog.ops()].count("flash_fwd") == 1
    np.testing.assert_allclose(_np(prog.run_captured(x)[0]), golden,
                               rtol=5e-2, atol=5e-2)
