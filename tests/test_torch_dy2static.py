"""The port's dy2static (`paddle_tpu_torch/jit/dy2static.py`) against the
JAX package's, on the CPU: the counterparts of `tests/test_dy2static.py`.

Each function is written once over a package `P` (`make(P)` returns it)
and runs through both packages' `to_static` (or `convert_to_static`) on
the same numpy inputs. Outputs are held to each other at 1e-5 (float32)
and exactly for integers, and to the oracle's expected values; the raise
cases raise each package's `Dy2StaticError`. Under a trace the port
lowers a tensor-dependent `if` to the `cond` HOP, `while` to
`while_loop`, a `for` over a traced range to `while_loop` over a counter
and a `for` over a tensor's rows to `scan` (the reference: `lax.cond`,
`while_loop`, `fori_loop`, `scan`).
"""
import gc
import weakref

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.jit import dy2static as jd
from paddle_tpu_torch.jit import dy2static as td

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _run(make, *inputs, convert=False, **kw):
    """make(P)'s function through both packages; returns (jax, port)
    outputs as numpy."""
    outs = []
    for P, D in ((pj, jd), (pt, td)):
        fn = make(P)
        st = D.convert_to_static(fn) if convert else P.jit.to_static(fn)
        args = [P.to_tensor(a) if isinstance(a, np.ndarray) else a
                for a in inputs]
        out = st(*args, **kw)
        outs.append(np.asarray(out.numpy()) if hasattr(out, "numpy")
                    else out)
    return outs


def _same(make, *inputs, want=None, **kw):
    j, t = _run(make, *inputs, **kw)
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    if want is not None:
        np.testing.assert_allclose(t, want, rtol=TOL, atol=TOL)
    return t


def _raises(make, *inputs, match=None):
    for P, D in ((pj, jd), (pt, td)):
        st = P.jit.to_static(make(P))
        with pytest.raises(D.Dy2StaticError, match=match):
            st(*[P.to_tensor(a) for a in inputs])


def f32(*a):
    return np.asarray(a, np.float32)


# ------------------------------------------------------------------ if/else
def _if_else(P):
    def fn(x):
        if x.mean() > 0:
            y = x + 1
        else:
            y = x - 1
        return y
    return fn


@pytest.mark.parametrize("x,want", [((1.0, 2.0), (2.0, 3.0)),
                                    ((-1.0, -2.0), (-2.0, -3.0))])
def test_tensor_if_else(x, want):
    _same(_if_else, f32(*x), want=f32(*want))


def test_tensor_if_no_else():
    def make(P):
        def fn(x):
            y = x * 2
            if x.sum() > 100:
                y = y + 100
            return y
        return fn
    _same(make, f32(1.0, 2.0), want=f32(2.0, 4.0))
    _same(make, f32(200.0, 1.0), want=f32(500.0, 102.0))


def test_nested_tensor_if():
    def make(P):
        def fn(x):
            if x.mean() > 0:
                if x.max() > 10:
                    y = x * 3
                else:
                    y = x * 2
            else:
                y = -x
            return y
        return fn
    for x, w in ((20.0, 60.0), (1.0, 2.0), (-3.0, 3.0)):
        _same(make, f32(x), want=f32(w))


def test_if_both_branches_return():
    def make(P):
        def fn(x):
            if x.sum() > 0:
                return x * 10
            else:
                return x * -1
        return fn
    _same(make, f32(2.0), want=f32(20.0))
    _same(make, f32(-2.0), want=f32(2.0))


def test_if_branch_mismatch_raises():
    def make(P):
        def fn(x):
            if x.sum() > 0:
                y = x + 1          # y undefined on the false path
            return y
        return fn
    _raises(make, f32(1.0))


def test_python_bool_if_stays_eager():
    for P, D in ((pj, jd), (pt, td)):
        calls = []

        def fn(x, flag=True):
            if flag:                    # python bool: plain python branch
                calls.append("t")
                y = x + 1
            else:
                calls.append("f")
                y = x - 1
            return y

        out = D.convert_to_static(fn)(P.to_tensor(f32(1.0)))
        np.testing.assert_allclose(out.numpy(), [2.0])
        assert calls == ["t"]           # false branch never executed


# ------------------------------------------------------------------ logical
def test_logical_and_or_not():
    def make(P):
        def fn(x):
            if x.mean() > 0 and x.max() < 10:
                y = x + 1
            elif not (x.min() > -5):
                y = x - 1
            else:
                y = x * 0
            return y
        return fn
    for x, w in ((1.0, 2.0), (-9.0, -10.0), (-1.0, 0.0)):
        _same(make, f32(x), want=f32(w))


def test_short_circuit_preserved_for_python_values():
    def make(P):
        def fn(x, lst=None):
            if lst is not None and len(lst) > 0:
                return x + 1
            return x
        return fn
    # lst is None: the rhs (len(None)) must never evaluate
    _same(make, f32(1.0), want=f32(1.0), convert=True)


# ------------------------------------------------------------------- while
def test_tensor_while():
    def make(P):
        def fn(x):
            while x.sum() < 100:
                x = x * 2
            return x
        return fn
    _same(make, f32(3.0), want=f32(192.0))


def test_while_multi_carry():
    def make(P):
        def fn(x):
            i = P.to_tensor(np.int32(0))
            s = P.zeros_like(x)
            while i < 5:
                s = s + x * i.astype("float32")
                i = i + 1
            return s
        return fn
    _same(make, f32(1.0, 2.0), want=f32(10.0, 20.0))   # (0+1+2+3+4)


def test_while_with_break():
    def make(P):
        def fn(x):
            i = P.to_tensor(np.int32(0))
            while i < 100:
                x = x + 1
                if x.sum() > 10:
                    break
                i = i + 1
            return x
        return fn
    _same(make, f32(0.0), want=f32(11.0))


def test_while_shape_change_raises():
    def make(P):
        def fn(x):
            while x.sum() < 100:
                x = P.concat([x, x])
            return x
        return fn
    _raises(make, f32(3.0))


# --------------------------------------------------------------------- for
def test_for_python_range_unrolls():
    def make(P):
        def fn(x):
            s = P.zeros_like(x)
            for i in range(4):
                s = s + x * float(i)
            return s
        return fn
    _same(make, f32(1.0), want=f32(6.0))


def test_for_traced_range():
    def make(P):
        def fn(x, n):
            s = P.zeros_like(x)
            for i in range(n):
                s = s + x + i.astype("float32")
            return s
        return fn
    _same(make, f32(10.0), np.asarray(3, np.int32),
          want=f32(33.0))    # 3*10 + (0+1+2)


def test_for_over_tensor_rows():
    def make(P):
        def fn(xs):
            s = P.zeros([2])
            for row in xs:
                s = s + row
            return s
        return fn
    _same(make, f32([1.0, 2.0], [3.0, 4.0], [5.0, 6.0]),
          want=f32(9.0, 12.0))


def test_for_with_continue():
    def make(P):
        def fn(xs):
            s = P.zeros([])
            for row in xs:
                if row.sum() < 0:
                    continue
                s = s + row.sum()
            return s
        return fn
    _same(make, f32([1.0], [-5.0], [3.0]), want=np.float32(4.0))


def test_for_with_break():
    def make(P):
        def fn(xs):
            s = P.zeros([])
            for row in xs:
                if s > 3:
                    break
                s = s + row.sum()
            return s
        return fn
    _same(make, f32([1.0], [3.0], [100.0]), want=np.float32(4.0))


# ------------------------------------------------------------ early returns
def test_early_return_in_if():
    def make(P):
        def fn(x):
            if x.sum() > 0:
                return x * 10
            return x - 1
        return fn
    _same(make, f32(2.0), want=f32(20.0))
    _same(make, f32(-2.0), want=f32(-3.0))


def test_early_return_in_while_loop():
    def make(P):
        def fn(x):
            while x.sum() < 100:
                x = x * 2
                if x.sum() > 50:
                    return x
            return x
        return fn
    # 3 -> 6 -> 12 -> 24 -> 48 -> 96: the in-loop return fires at 96
    _same(make, f32(3.0), want=f32(96.0))
    # 60: one doubling then the return path
    _same(make, f32(60.0), want=f32(120.0))


def test_early_return_in_for_loop():
    def make(P):
        def fn(x):
            s = x * 0
            for _ in range(10):
                s = s + x
                if s.sum() > 5:
                    return s
            return s - 1
        return fn
    _same(make, f32(2.0), want=f32(6.0))
    # never crosses the threshold: falls through to the trailing return
    _same(make, f32(0.1), want=f32(0.0))


def test_early_return_statements_after_skipped():
    def make(P):
        def fn(x):
            if x.sum() > 0:
                return x + 100
            x = x * 2          # must not run on the returning path
            return x
        return fn
    _same(make, f32(1.0), want=f32(101.0))
    _same(make, f32(-1.0), want=f32(-2.0))


# --------------------------------------------------- clear unsupported errors
def test_list_append_in_traced_loop_clear_error():
    def make(P):
        def fn(x):
            out = []
            while x.sum() < 100:
                x = x * 2
                out.append(x)
            return x
        return fn
    _raises(make, f32(3.0), match="list mutation")


def test_list_append_in_unrolled_loop_still_works():
    def make(P):
        def fn(x):
            out = []
            for i in range(3):
                out.append(x * i)
            return out[0] + out[1] + out[2]
        return fn
    _same(make, f32(1.0), want=f32(3.0))


# ------------------------------------------------------------- convert_call
def test_helper_function_transformed_recursively():
    def make(P):
        def helper(v):
            if v.mean() > 0:
                return v * 2
            else:
                return v * -3

        def fn(x):
            return helper(x) + 1
        return fn
    _same(make, f32(1.0), want=f32(3.0))
    _same(make, f32(-1.0), want=f32(4.0))


# ---------------------------------------------------------- Layer + jit.save
def _gated_net(P):
    class GatedNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        @P.jit.to_static
        def forward(self, x):
            h = self.fc(x)
            if h.mean() > 0:
                out = P.nn.functional.relu(h)
            else:
                out = h * 0.1
            return out
    return GatedNet()


def _gated_pair():
    """(JAX net, port net with the JAX weights)."""
    pj.seed(3)
    jn, tn = _gated_net(pj), _gated_net(pt)
    tn.set_state_dict({k: v.numpy() for k, v in jn.state_dict().items()})
    return jn, tn


@pytest.mark.parametrize("seed", [0, 2])
def test_layer_forward_with_tensor_if(seed):
    jn, tn = _gated_pair()
    x = np.random.RandomState(seed).randn(2, 4).astype(np.float32)
    got = tn(pt.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, jn(pj.to_tensor(x)).numpy(), rtol=TOL,
                               atol=TOL)
    h = tn.fc(pt.to_tensor(x)).numpy()
    want = np.maximum(h, 0) if h.mean() > 0 else h * 0.1
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_jit_save_load_dy2static_model(tmp_path):
    jn, tn = _gated_pair()
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    for P, net in ((pj, jn), (pt, tn)):
        net.eval()
        path = str(tmp_path / f"gated_{P.__name__}")
        P.jit.save(net, path,
                   input_spec=[P.static.InputSpec([None, 4], "float32")])
        got = P.jit.load(path)(P.to_tensor(x)).numpy()
        np.testing.assert_allclose(got, net(P.to_tensor(x)).numpy(),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        pt.jit.load(str(tmp_path / "gated_paddle_tpu_torch"))(
            pt.to_tensor(x)).numpy(),
        pj.jit.load(str(tmp_path / "gated_paddle_tpu"))(
            pj.to_tensor(x)).numpy(), rtol=TOL, atol=TOL)


# ------------------------------------------------- review-finding regressions
def test_python_container_truthiness():
    def make(P):
        def fn(x, opts=None, idx=None):
            opts = opts or {"scale": 2.0}
            if not idx:
                x = x * opts["scale"]
            if idx and x.sum() > 0:
                x = x + 1
            return x
        return fn
    _same(make, f32(3.0), want=f32(6.0), convert=True)
    _same(make, f32(3.0), want=f32(4.0), convert=True, idx=[1])


def test_bool_tensor_int_arithmetic():
    for P in (pj, pt):
        x = P.to_tensor(f32(1.0, -1.0))
        np.testing.assert_allclose(((x > 0) * 3).numpy(), [3.0, 0.0])
        np.testing.assert_allclose(((x > 0) + 1).numpy(), [2.0, 1.0])


def test_int_scalar_keeps_int_dtype():
    for P in (pj, pt):
        i = P.to_tensor(np.int32(5))
        assert "int32" in str((i + 1).dtype)
        assert "float32" in str((i + 1.5).dtype)


def test_concrete_cond_traced_carry_unrolls():
    def make(P):
        def fn(x):
            i = 0
            while i < 3:               # python cond: unrolled, shape may change
                x = P.concat([x, x])
                i = i + 1
            return x
        return fn
    got = _same(make, f32(1.0))
    assert got.shape[0] == 8


def test_static_method_bound_once():
    for P in (pj, pt):
        net = _gated_net(P)
        assert net.forward is net.forward     # cached in instance dict


def test_not_to_static_factory_form():
    for P in (pj, pt):
        @P.jit.not_to_static()
        def f(x):
            return x + 1

        assert f(1) == 2
        assert f.__dy2static_transformed__


def test_carry_dtype_promotion():
    def make(P):
        def fn(x):
            s = 0
            while x.sum() < 3:
                s = s + x.mean()
                x = x + 1
            return s
        return fn
    # eager: 0 + 0.5 (x->1.5) + 1.5 (x->2.5) + 2.5 (x->3.5) = 4.5
    _same(make, f32(0.5), want=np.float32(4.5))


def test_subscript_store_in_branch_carried():
    def make(P):
        def fn(x):
            if x.sum() > 100:
                x[0] = 0.0
            return x * 1.0
        return fn
    _same(make, f32(1.0, 2.0), want=f32(1.0, 2.0))
    _same(make, f32(200.0, 2.0), want=f32(0.0, 2.0))


def test_attr_store_in_branch_clear_error():
    for P, D in ((pj, jd), (pt, td)):
        class Box:
            pass

        b = Box()

        def fn(x):
            if x.sum() > 0:
                b.hits = 1
            return x

        D.convert_to_static(fn)(P.to_tensor(f32(1.0)))   # eager: python
        assert b.hits == 1
        with pytest.raises(D.Dy2StaticError, match="attribute"):
            P.jit.to_static(fn)(P.to_tensor(f32(1.0)))   # traced: named


def test_for_else_with_break_semantics():
    for D in (jd, td):
        hits = []

        def fn(vals):
            for v in vals:
                if v == 2:
                    break
            else:
                hits.append("else")
            return vals

        st = D.convert_to_static(fn)
        st([1, 2, 3])
        assert hits == []          # break taken: else must NOT run
        st([5, 6])
        assert hits == ["else"]    # exhausted: else runs


def test_loop_target_leaks_after_for():
    def make(P):
        def fn(x):
            for i in range(3):
                x = x + i
            return x * i            # python: i leaks as 2
        return fn
    _same(make, f32(1.0), want=f32(8.0))   # (1+0+1+2)*2


def test_loop_target_leaks_traced_iterable():
    def make(P):
        def fn(xs):
            s = P.zeros([2])
            for row in xs:
                s = s + row
            return s + row          # last row leaks
        return fn
    _same(make, f32([1.0, 2.0], [3.0, 4.0]), want=f32(7.0, 10.0))


def test_loop_target_body_reassignment_leaks():
    def make(P):
        def fn(x):
            for i in range(3):
                i = i * 10
                x = x + i
            return x * i            # python: i leaks as 20
        return fn
    # x = 1 + 0 + 10 + 20 = 31; * 20 = 620
    _same(make, f32(1.0), want=f32(620.0))


def test_convert_call_cache_not_pinning():
    for D in (jd, td):
        def make():
            def inner(v):
                if v.mean() > 0:
                    return v
                else:
                    return -v
            return inner

        f = make()
        D.convert_call(f)
        ref = weakref.ref(f)
        del f
        gc.collect()
        assert ref() is None        # cache must not keep the function alive


def test_elif_chain_all_return():
    def make(P):
        def fn(x):
            if x.mean() > 1:
                return x + 1
            elif x.mean() > 0:
                return x + 2
            else:
                return x - 1
        return fn
    for x, w in ((3.0, 4.0), (0.5, 2.5), (-1.0, -2.0)):
        _same(make, f32(x), want=f32(w))


def test_monkeypatched_global_seen():
    import tests_dy2s_helper_mod as helper_mod
    for P, D in ((pj, jd), (pt, td)):
        st = D.convert_to_static(helper_mod.entry)
        assert float(st(P.to_tensor(f32(1.0)))[0]) == 2.0
        orig = helper_mod.helper
        try:
            helper_mod.helper = lambda v: v * 10
            assert float(st(P.to_tensor(f32(1.0)))[0]) == 10.0
        finally:
            helper_mod.helper = orig


# -------------------------------------------------------- translator switch
def test_program_translator_disable():
    for P in (pj, pt):
        P.jit.ProgramTranslator.get_instance().enable(False)
        try:
            def fn(x):
                if x.mean() > 0:
                    return x + 1
                else:
                    return x - 1
            st = P.jit.to_static(fn)
            with pytest.raises(Exception):
                st(P.to_tensor(f32(1.0)))   # plain tracing: data-dependent
        finally:
            P.jit.ProgramTranslator.get_instance().enable(True)


# ------------------------------------------------- undefined-local equality
def test_undefined_local_eq_hash_curated_error():
    def make(P):
        def fn(x):
            if x.sum() > 0:
                y = x + 1
            else:
                if y == 3:                  # y compared before any assignment
                    y = x
                y = x - 1
            return y
        return fn
    _raises(make, f32(1.0), match="read before assignment")
    for D in (jd, td):
        U = D.UNDEF
        for bad in (lambda: U == 3, lambda: U != 3, lambda: hash(U),
                    lambda: U in {1: "a"}, lambda: 3 == U):
            with pytest.raises(D.Dy2StaticError,
                               match="read before assignment"):
                bad()


# ------------------------------------------------------ the port's lowering
def _three_constructs(P):
    def fn(x):
        if x.mean() > 0:
            y = x + 1
        else:
            y = x - 1
        while y.abs().sum() < 100:
            y = y * 2
        s = P.zeros([2])
        for row in y.reshape([-1, 2]):
            s = s + row
        return s
    return fn


def test_traced_constructs_lower_to_the_hops():
    """What the program holds: an `if` on a traced value is a `cond`, a
    `while` a `while_loop`, a `for` over rows a `scan`; one program
    serves both paths of the `if`."""
    from paddle_tpu_torch.static import op_type

    st = pt.jit.to_static(_three_constructs(pt))
    jst = pj.jit.to_static(_three_constructs(pj))
    for x in (f32(1.0, 2.0, 3.0, 4.0), f32(-1.0, -2.0, -3.0, -4.0)):
        np.testing.assert_allclose(st(pt.to_tensor(x)).numpy(),
                                   jst(pj.to_tensor(x)).numpy(),
                                   rtol=TOL, atol=TOL)
    (prog,) = st.concrete_programs.values()
    kinds = {op_type(n.target) for n in prog.graph.nodes
             if n.op == "call_function"}
    assert {"cond", "while_loop", "scan"} <= kinds, kinds
