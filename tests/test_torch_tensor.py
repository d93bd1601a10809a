"""The port's eager Tensor (`paddle_tpu_torch.core`) against the JAX
package's on the CPU: places, dtypes and the width map, value semantics,
scalar promotion, conversions, item assignment, and the random contract.

Oracles: `tests/test_tensor_ops.py` (creation, dtypes, indexing, random)
and `test_inplace_ops.py` of the JAX package, ported case by case."""
import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as tdevice


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield


def width_map(name):
    return {"int64": "int32", "float64": "float32",
            "complex128": "complex64"}.get(name, name)


def dname(t):
    return str(t.dtype).replace("torch.", "")


def same(a, b, rtol=1e-6):
    """Port Tensor a against JAX Tensor b: dtype through the width map,
    shape, values."""
    assert width_map(dname(a)) == dname(b), (dname(a), dname(b))
    assert a.shape == b.shape
    np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()), rtol=rtol,
                               atol=rtol)


# ------------------------------------------------------------------ places
def test_default_place_is_the_gpu_and_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(tdevice, "_current_place", tdevice.Place("gpu", 0))
    monkeypatch.setattr(tdevice, "_current_device", None)
    assert pt.get_device() == "gpu:0"
    if torch.cuda.is_available():
        assert pt.to_tensor([1.0]).place == pt.CUDAPlace(0)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.zeros([2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.set_device("gpu")
    t = pt.to_tensor([1.0], place="cpu")          # asked for the host
    assert t.place == pt.CPUPlace()
    assert pt.to_tensor([1.0], place=pt.CPUPlace()).place.kind == "cpu"


def test_set_device_and_place_queries():
    assert pt.get_device() == "cpu:0"
    assert pt.set_device("cpu") == pt.CPUPlace()
    with pytest.raises(ValueError, match="Unsupported device"):
        pt.set_device("tpu")
    x = pt.ones([2])
    assert x.place == pt.CPUPlace() and x.place.kind == "cpu"
    assert pt.core.device_count("cpu") == 1
    assert pt.device.get_all_device_type()[0] == "cpu"
    assert pt.device.op_cache_stats()["size"] == 0
    pt.device.reset_op_cache_stats()
    pt.device.clear_op_cache()
    assert not pt.core.is_compiled_with_tpu()


# ------------------------------------------------------------------ dtypes
@pytest.mark.parametrize("alias,want", [
    ("float32", "float32"), ("fp16", "float16"), ("bf16", "bfloat16"),
    ("double", "float64"), ("int64", "int64"), ("bool", "bool"),
    ("uint8", "uint8"), ("complex64", "complex64"), (np.float32, "float32"),
    (np.dtype("int32"), "int32"), (float, "float64"), (bool, "bool")])
def test_convert_dtype_aliases(alias, want):
    assert str(pt.core.convert_dtype(alias)).replace("torch.", "") == want
    assert width_map(want) == pj.core.dtype.dtype_name(
        pj.core.dtype.canonical(alias if alias not in (float, bool)
                                else {float: "float64",
                                      bool: "bool"}[alias]))


def test_convert_dtype_rejects_unknown():
    with pytest.raises(ValueError, match="Unknown dtype"):
        pt.core.convert_dtype("float128x")


@pytest.mark.parametrize("data,dtype", [
    ([1, 2, 3], None), ([1.0, 2.0], None), (np.arange(4.0), None),
    (np.arange(4), None), ([True, False], None), (3, None), (2.5, None),
    ([1, 2], "float32"), ([1.5, 2.5], "int64"), ([1.0, 2.0], "float64"),
    ([1.0, 2.0], "bfloat16"), ([1, 2], "int32")])
def test_to_tensor_dtypes_through_the_width_map(data, dtype):
    same(pt.to_tensor(data, dtype=dtype), pj.to_tensor(data, dtype=dtype))


def test_default_dtype_round_trip():
    assert pt.get_default_dtype() == pt.float32
    pt.set_default_dtype("float64")
    try:
        assert pt.to_tensor(np.arange(3.0)).dtype == pt.float64
        assert pt.zeros([2]).dtype == pt.float64
    finally:
        pt.set_default_dtype("float32")
    assert pt.zeros([2]).dtype == pt.float32


def test_numpy_of_bf16_is_exact_float32():
    vals = np.array([1.0, 0.1, -3.140625, 65280.0], np.float32)
    t = pt.to_tensor(vals, dtype="bfloat16")
    a = t.numpy()
    assert a.dtype == np.float32
    want = np.asarray(pj.to_tensor(vals, dtype="bfloat16").numpy(),
                      np.float32)
    np.testing.assert_array_equal(a, want)
    assert t.dtype == pt.bfloat16


def test_numpy_force_int64_and_flag():
    t = pt.to_tensor([1, 2], dtype="int32")
    assert t.numpy().dtype == np.int32
    assert t.numpy(force_int64=True).dtype == np.int64
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    old = get_flags("FLAGS_int64_numpy_boundary")
    set_flags({"FLAGS_int64_numpy_boundary": True})
    try:
        assert t.numpy().dtype == np.int64
    finally:
        set_flags(old)


# ----------------------------------------------------------- value semantics
def _both(fn):
    """Run fn(P) in both packages; returns (port result, JAX result)."""
    return fn(pt), fn(pj)


def test_view_from_indexing_survives_item_assignment():
    def fn(P):
        x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        y = x[0]
        x[0] = 5.0
        return y, x
    (ty, tx), (jy, jx) = _both(fn)
    same(ty, jy)
    same(tx, jx)
    np.testing.assert_array_equal(ty.numpy(), [0.0, 1.0, 2.0])


def test_reshape_and_transpose_views_survive_inplace_add():
    def fn(P):
        x = P.to_tensor(np.arange(6, dtype=np.float32))
        y = x.reshape([2, 3])
        z = P.transpose(y, [1, 0])
        d = x.detach()
        x.add_(P.to_tensor(np.ones(6, np.float32)))
        x.scale_(2.0)
        return y, z, d, x
    got, want = _both(fn)
    for a, b in zip(got, want):
        same(a, b)
    np.testing.assert_array_equal(got[0].numpy().reshape(-1), np.arange(6))


def test_handed_out_grad_survives_the_next_backward():
    def fn(P):
        x = P.to_tensor(np.ones(3, np.float32), stop_gradient=False)
        (x * 2.0).sum().backward()
        g = x.grad
        (x * 3.0).sum().backward()
        return g, x.grad
    (tg, tg2), (jg, jg2) = _both(fn)
    same(tg, jg)
    same(tg2, jg2)
    np.testing.assert_array_equal(tg.numpy(), [2.0] * 3)
    np.testing.assert_array_equal(tg2.numpy(), [5.0] * 3)


def test_numpy_and_to_tensor_copy():
    a = np.arange(4, dtype=np.float32)
    t = pt.to_tensor(a)
    a[0] = 99.0
    assert float(t[0]) == 0.0
    h = t.numpy()
    t.fill_(7.0)
    assert h[0] == 0.0 and float(t[0]) == 7.0
    import torch
    src = torch.zeros(2)
    u = pt.to_tensor(src)
    src.add_(1.0)
    assert u.numpy().tolist() == [0.0, 0.0]


@pytest.mark.parametrize("method,args", [
    ("set_value", (np.full((2, 3), 4.0, np.float32),)), ("fill_", (2.5,)),
    ("zero_", ()), ("scale_", (3.0,)), ("add_", (1.5,)),
    ("subtract_", (0.5,)), ("multiply_", (-2.0,)),
    ("copy_", (np.ones((2, 3), np.float32),))])
def test_raw_inplace_methods_match_jax(method, args):
    def fn(P):
        x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        v = x.reshape([6])
        out = getattr(x, method)(*args)
        assert out is x
        return x, v
    got, want = _both(fn)
    for a, b in zip(got, want):
        same(a, b)


@pytest.mark.parametrize("idx,value", [
    ((0, 1), 9.0), (slice(0, 2), 3.0), ((Ellipsis, 0), -1.0),
    (1, np.array([7.0, 8.0, 9.0], np.float32)), ("tensor_index", 4.0),
    ("mask", 0.0), ((0,), "tensor_value")])
def test_setitem_forms_match_jax(idx, value):
    def fn(P):
        x = P.to_tensor(np.arange(12, dtype=np.float32).reshape(4, 3))
        i = idx
        if idx == "tensor_index":
            i = P.to_tensor(np.array([0, 2]))
        elif idx == "mask":
            i = x > 5.0
        v = P.to_tensor(np.array([1.0, 2.0, 3.0], np.float32)) \
            if isinstance(value, str) else value
        x[i] = v
        return x
    got, want = _both(fn)
    same(got, want)


def test_setitem_records_on_a_differentiable_tensor():
    def fn(P):
        a = P.to_tensor(np.arange(1.0, 5.0, dtype=np.float32),
                        stop_gradient=False)
        v = P.to_tensor(np.array([10.0], np.float32), stop_gradient=False)
        x = a * 2.0
        x[1:2] = v * 3.0
        (x * x).sum().backward()
        return a.grad, v.grad, x
    got, want = _both(fn)
    for a, b in zip(got, want):
        same(a, b)


# -------------------------------------------------------- scalar promotion
PROMOTION = [
    ("int_tensor + int", lambda P, i, f, b: i + 2),
    ("int_tensor * float", lambda P, i, f, b: i * 1.5),
    ("float * int_tensor", lambda P, i, f, b: 1.5 * i),
    ("bool * int", lambda P, i, f, b: b * 3),
    ("bool + int", lambda P, i, f, b: b + 1),
    ("bool * float", lambda P, i, f, b: b * 0.5),
    ("bool & bool", lambda P, i, f, b: P.logical_and(b, True)),
    ("float + int", lambda P, i, f, b: f + 2),
    ("float * bool", lambda P, i, f, b: f * True),
    ("int / int", lambda P, i, f, b: i / 2),
    ("int // int", lambda P, i, f, b: i // 2),
    ("int ** int", lambda P, i, f, b: i ** 2),
    ("int - int_tensor", lambda P, i, f, b: 10 - i),
    ("int_tensor < float", lambda P, i, f, b: i < 2.5),
    ("float == int", lambda P, i, f, b: f == 1),
    ("bf16 * float", lambda P, i, f, b: f.astype("bfloat16") * 0.1),
    ("bf16 + int", lambda P, i, f, b: f.astype("bfloat16") + 3),
    ("f16 * float", lambda P, i, f, b: f.astype("float16") * 2.5),
    ("int32 + int", lambda P, i, f, b: i.astype("int32") + 7),
    ("int32 * float", lambda P, i, f, b: i.astype("int32") * 0.5),
    ("maximum(int, float)", lambda P, i, f, b: P.maximum(i, 1.5)),
    ("add(bool, int)", lambda P, i, f, b: P.add(b, 2)),
    ("where(bool, float, float)", lambda P, i, f, b: P.where(b, f, 0.5)),
    ("numpy scalar", lambda P, i, f, b: f * np.float32(2.0)),
    ("list operand", lambda P, i, f, b: i + [1, 2, 3]),
]


@pytest.mark.parametrize("name,fn", PROMOTION, ids=[p[0] for p in PROMOTION])
def test_scalar_promotion_matches_jax(name, fn):
    def run(P):
        i = P.to_tensor(np.array([1, 2, 3]))
        f = P.to_tensor(np.array([0.5, 1.0, 2.5], np.float32))
        b = P.to_tensor(np.array([True, False, True]))
        return fn(P, i, f, b)
    got, want = _both(run)
    same(got, want, rtol=1e-2 if "bf16" in name or "f16" in name else 1e-6)


# ------------------------------------------------------ attributes, methods
def test_tensor_attributes_match_jax():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t, j = pt.to_tensor(a), pj.to_tensor(a)
    assert t.shape == j.shape == [2, 3, 4]
    assert t.ndim == t.dim == j.ndim == 3
    assert t.size == t.numel() == j.size == 24
    assert len(t) == len(j) == 2
    assert t.is_leaf and t.stop_gradient and j.stop_gradient
    assert t[1, 2, 3].item() == j[1, 2, 3].item() == 23.0
    assert t.tolist() == j.tolist()
    assert [r.shape for r in t] == [r.shape for r in j]
    s = pt.to_tensor(3.5)
    assert float(s) == 3.5 and int(s) == 3 and bool(s)
    np.testing.assert_array_equal(np.asarray(t), a)
    assert np.asarray(t, dtype=np.float64).dtype == np.float64
    with pytest.raises(TypeError, match="0-d"):
        len(pt.to_tensor(1.0))
    assert "stop_gradient=False" in repr(pt.to_tensor([1.0],
                                                      stop_gradient=False))
    assert repr(t).startswith("Tensor(shape=[2, 3, 4], dtype=float32")


def test_parameter_and_stop_gradient_flags():
    p = pt.core.Parameter(np.ones(3, np.float32), name="w")
    jp = pj.core.tensor.Parameter(pj.to_tensor(np.ones(3, np.float32))._data,
                                  name="w")
    assert not p.stop_gradient and p.trainable and p.persistable
    assert p.name == jp.name == "w"
    assert p.optimize_attr == jp.optimize_attr
    assert repr(p).startswith("Parameter containing:")
    p.stop_gradient = True
    assert p.stop_gradient and p.is_leaf
    x = pt.to_tensor([1, 2])
    x.stop_gradient = False                  # an int tensor keeps the flag
    assert not x.stop_gradient
    y = pt.to_tensor([1.0], stop_gradient=False) * 2.0
    assert not y.stop_gradient and not y.is_leaf
    y.stop_gradient = True
    assert y.stop_gradient and y.is_leaf


def test_astype_detach_clone_to_cpu():
    x = pt.to_tensor(np.array([1.7, -2.3], np.float32), stop_gradient=False)
    assert x.astype("int32").numpy().tolist() == [1, -2]
    assert x.astype(pt.bfloat16).dtype == pt.bfloat16
    assert x.cast("float64").dtype == pt.float64
    assert x.to("float16").dtype == pt.float16
    assert x.to("cpu").place == pt.CPUPlace()
    assert x.detach().stop_gradient and not x.clone().stop_gradient
    assert x.cpu().place.kind == "cpu"
    assert x.pin_memory() is x


def test_methods_are_patched_like_the_reference():
    for name in ("sum", "mean", "reshape", "matmul", "topk", "argsort",
                 "clip", "tanh_", "clip_", "scatter_", "index_add_",
                 "abs_", "fill_diagonal_", "cast_", "numel", "unsqueeze"):
        assert hasattr(pt.Tensor, name), name
        assert hasattr(pj.Tensor, name), name
    for name in ("zeros", "arange", "to_tensor", "gaussian", "finfo"):
        assert not hasattr(pt.Tensor, name), name
    assert "linalg" not in pt.tensor.__all__ and "math" not in \
        pt.tensor.__all__


def test_top_level_exports():
    for name in ("Tensor", "to_tensor", "seed", "set_device", "no_grad",
                 "grad", "matmul", "add", "topk", "randn", "tanh_",
                 "float32", "bfloat16", "int64", "CPUPlace", "CUDAPlace",
                 "autograd", "device", "tensor", "enable_grad",
                 "Parameter", "get_rng_state"):
        assert hasattr(pt, name), name
        assert name in pt.__all__, name
    import types
    assert isinstance(pt.text, types.ModuleType)
    assert isinstance(pt.ops, types.ModuleType)


# ----------------------------------------------------------------- random
RANDOM_OPS = [
    ("rand", lambda P: P.rand([3, 4])),
    ("randn", lambda P: P.randn([3, 4])),
    ("standard_normal_f64", lambda P: P.standard_normal([2], "float64")),
    ("normal", lambda P: P.normal(1.0, 2.0, [5])),
    ("normal_tensors", lambda P: P.normal(P.zeros([3]), P.ones([2, 3]))),
    ("uniform", lambda P: P.uniform([4], min=2.0, max=3.0)),
    ("randint", lambda P: P.randint(0, 5, [6])),
    ("randint_one_bound", lambda P: P.randint(4, shape=[2, 2])),
    ("randint_like", lambda P: P.randint_like(P.zeros([2, 3], "int64"), 0, 3)),
    ("randperm", lambda P: P.randperm(10)),
    ("multinomial", lambda P: P.multinomial(P.to_tensor(
        np.array([0.2, 0.3, 0.5], np.float32)), 2)),
    ("bernoulli", lambda P: P.bernoulli(P.full([4], 0.5))),
    ("poisson", lambda P: P.poisson(P.full([4], 3.0))),
    ("gaussian", lambda P: P.gaussian([3], seed=5)),
    ("normal_", lambda P: P.normal_(P.zeros([2, 2]))),
    ("uniform_", lambda P: P.uniform_(P.zeros([3]), 0.0, 1.0)),
    ("exponential_", lambda P: P.exponential_(P.zeros([3]), 2.0)),
]


@pytest.mark.parametrize("name,fn", RANDOM_OPS, ids=[r[0] for r in RANDOM_OPS])
def test_random_op_shapes_dtypes_and_streams(name, fn):
    """Shapes and dtypes match the JAX package's; the same seed gives the
    same stream; a state round-trip replays it."""
    t, j = fn(pt), fn(pj)
    assert t.shape == j.shape
    assert width_map(dname(t)) == dname(j)
    pt.seed(11)
    a = fn(pt).numpy()
    state = pt.get_rng_state()
    b = fn(pt).numpy()
    pt.seed(11)
    np.testing.assert_array_equal(fn(pt).numpy(), a)
    pt.set_rng_state(state)
    np.testing.assert_array_equal(fn(pt).numpy(), b)


def test_random_moments_within_bounds():
    pt.seed(2024)
    n = 200_000
    z = pt.randn([n]).numpy()
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
    u = pt.uniform([n], min=2.0, max=3.0).numpy()
    assert u.min() >= 2.0 and u.max() < 3.0 and abs(u.mean() - 2.5) < 0.01
    r = pt.randint(0, 5, [n]).numpy()
    assert r.min() == 0 and r.max() == 4
    assert np.all(np.abs(np.bincount(r) / n - 0.2) < 0.01)
    assert sorted(pt.randperm(50).numpy().tolist()) == list(range(50))
    m = pt.normal(3.0, 0.5, [n]).numpy()
    assert abs(m.mean() - 3.0) < 0.01 and abs(m.std() - 0.5) < 0.01
    b = pt.bernoulli(pt.full([n], 0.3)).numpy()
    assert abs(b.mean() - 0.3) < 0.01
    p = pt.poisson(pt.full([n], 4.0)).numpy()
    assert abs(p.mean() - 4.0) < 0.03 and abs(p.var() - 4.0) < 0.1
    e = pt.exponential_(pt.zeros([n]), 2.0).numpy()
    assert abs(e.mean() - 0.5) < 0.01
    probs = np.array([0.1, 0.2, 0.7], np.float32)
    draws = pt.multinomial(pt.to_tensor(np.tile(probs, (20000, 1))),
                           1, replacement=True).numpy().reshape(-1)
    assert np.all(np.abs(np.bincount(draws, minlength=3) / 20000 - probs)
                  < 0.02)
    nr = pt.multinomial(pt.to_tensor(probs), 3).numpy()
    assert sorted(nr.tolist()) == [0, 1, 2]      # without replacement


def test_fork_rng_and_gaussian_seed():
    pt.seed(3)
    a = pt.randn([4]).numpy()
    pt.seed(3)
    with pt.core.fork_rng(99):
        inside = pt.randn([4]).numpy()
    np.testing.assert_array_equal(pt.randn([4]).numpy(), a)
    with pt.core.fork_rng(99):
        np.testing.assert_array_equal(pt.randn([4]).numpy(), inside)
    g1 = pt.gaussian(4, seed=123).numpy()
    g2 = pt.gaussian(4, seed=123).numpy()
    np.testing.assert_array_equal(g1, g2)
    assert not np.array_equal(pt.gaussian([4]).numpy(),
                              pt.gaussian([4]).numpy())


# ----------------------------------------------------------- ties, orders
def test_tie_and_order_rules_of_the_reference():
    """The JAX package's rules, which torch's defaults do not give:
    argsort(descending) flips a stable ascending sort (ties last index
    first), topk follows lax.top_k (ties lower index first), mode takes
    the smallest modal value and its last occurrence, median averages
    the two middle values, returns [1] for axis=None and is NaN for a
    NaN or an inf in the slice, argmax takes the first of ties."""
    def run(P):
        t = P.to_tensor(np.array([1.0, 3.0, 3.0, 2.0, 3.0], np.float32))
        m = P.to_tensor(np.array([[2.0, 1.0, 2.0, 1.0, 5.0]], np.float32))
        return {
            "argsort_desc": P.argsort(t, descending=True).numpy().tolist(),
            "topk_idx": P.topk(t, 2)[1].numpy().tolist(),
            "topk_small_idx": P.topk(m, 2, largest=False)[1].numpy()
            .tolist(),
            "mode": [a.numpy().tolist() for a in P.mode(m)],
            "median": P.median(t).numpy().tolist(),
            "median_even": float(P.median(P.to_tensor(
                np.array([1.0, 9.0, 3.0, 7.0], np.float32)), axis=0)),
            "median_inf": bool(np.isnan(P.median(P.to_tensor(np.array(
                [1.0, 2.0, np.inf], np.float32))).numpy()[0])),
            "argmax": int(P.argmax(t)),
        }
    got, want = run(pt), run(pj)
    assert got == want
    assert got["argsort_desc"] == [4, 2, 1, 3, 0]
    assert got["topk_idx"] == [1, 2]
    assert got["topk_small_idx"] == [[1, 3]]
    assert got["mode"] == [[1.0], [3]]
    assert got["median"] == [3.0] and got["median_even"] == 5.0
    assert got["median_inf"] and got["argmax"] == 1
