"""The op table: every public op of the port's `paddle_tpu_torch.tensor`
held against the JAX package's on the same seeded numpy inputs, values
and (for float inputs) gradients, on the CPU.

Tolerances: f32 elementwise 1e-6 relative; reductions, matmul
and linalg 1e-5; bf16 1e-2; integer, bool and index results exact. An
absolute floor equal to the relative tolerance covers values near zero.
Dtypes compare through ROADMAP C.14's width map: the port keeps int64,
float64 and complex128 where the JAX package (x64 off) has int32,
float32 and complex64.

`OP_TABLE` is also run on CUDA against the port on the CPU by
`chip_smoke.py` phase 21 (d); its makers and functions therefore take
the package as an argument and import nothing of JAX.
"""
import zlib

import numpy as np
import pytest

EW, RED, BF16 = 1e-6, 1e-5, 1e-2


class Case:
    """One op call: fn(P, *tensors) -> output(s), on inputs made by
    `makers` (each rng -> numpy array). grad: also compare the gradients
    of the float inputs under a seeded cotangent. post: numpy outputs ->
    what to compare (for results unique only up to order or sign).
    jax_uncached: run the JAX side with its eager op cache off (its jitted
    path cannot trace an op whose output size depends on the data)."""

    def __init__(self, id, fn, makers, grad=True, tol=EW, post=None,
                 jax_uncached=False):
        self.id, self.fn, self.makers = id, fn, makers
        self.grad, self.tol, self.post = grad, tol, post
        self.jax_uncached = jax_uncached

    def inputs(self):
        rng = np.random.RandomState(zlib.crc32(self.id.encode()))
        return [m(rng) for m in self.makers]


def F(*shape, lo=-1.0, hi=1.0):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def Pos(*shape):
    return F(*shape, lo=0.2, hi=2.0)


def I(*shape, lo=0, hi=5):
    return lambda rng: rng.randint(lo, hi, shape).astype(np.int64)


def B(*shape):
    return lambda rng: rng.rand(*shape) > 0.5


def K(value, dtype=None):
    return lambda rng: np.asarray(value, dtype=dtype)


def SPD(n):
    def make(rng):
        a = rng.uniform(-1, 1, (n, n))
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


def WithSpecial():
    return K([1.0, np.nan, -np.inf, 0.5, np.inf, -2.0], np.float32)


def op(name, *args, **kw):
    return lambda P, *ts: getattr(P, name)(*ts, *args, **kw)


def C(id, fn, makers, **kw):
    return Case(id, fn, makers, **kw)


def _unary(names, maker=F(3, 4), tol=EW):
    return [C(n, op(n), [maker], tol=tol) for n in names]


OP_TABLE = (
    # ---------------------------------------------------------- math: unary
    _unary(["exp", "expm1", "square", "sin", "cos", "atan", "sinh", "cosh",
            "tanh", "asinh", "abs", "ceil", "floor", "round", "trunc",
            "sign", "erf", "neg", "frac", "stanh", "rad2deg", "deg2rad"])
    + _unary(["log", "log2", "log10", "log1p", "sqrt", "rsqrt",
              "reciprocal"], Pos(3, 4))
    + _unary(["tan"], F(3, 4, lo=-1.2, hi=1.2))
    + _unary(["asin", "acos", "atanh"], F(3, 4, lo=-0.9, hi=0.9))
    + _unary(["acosh"], F(3, 4, lo=1.1, hi=3.0))
    + _unary(["erfinv"], F(3, 4, lo=-0.9, hi=0.9), tol=RED)
    + _unary(["lgamma", "digamma"], Pos(3, 4), tol=RED)
    + [
        # ------------------------------------------------------ math: binary
        C("add", op("add"), [F(3, 4), F(3, 4)]),
        C("add_broadcast", op("add"), [F(3, 4), F(4)]),
        C("subtract", op("subtract"), [F(2, 1, 4), F(3, 1)]),
        C("multiply", op("multiply"), [F(3, 4), F(3, 4)]),
        C("divide", op("divide"), [F(3, 4), Pos(3, 4)]),
        C("divide_int", op("divide"), [I(3, 4), I(3, 4, lo=1)]),
        C("floor_divide", op("floor_divide"), [F(3, 4, hi=4), Pos(3, 4)],
          grad=False),
        C("floor_divide_int", op("floor_divide"), [I(3, 4, lo=-6, hi=6),
                                                   I(3, 4, lo=1)]),
        C("mod", op("mod"), [F(3, 4, lo=-3, hi=3), Pos(3, 4)], grad=False),
        C("remainder_int", op("remainder"), [I(3, 4, lo=-6, hi=6),
                                             I(3, 4, lo=1)]),
        C("pow", op("pow"), [Pos(3, 4), F(3, 4)]),
        C("pow_scalar", lambda P, x: x ** 2, [F(3, 4)]),
        C("rpow_scalar", lambda P, x: 2.0 ** x, [F(3, 4)]),
        C("maximum", op("maximum"), [F(3, 4), F(3, 4)]),
        C("minimum", op("minimum"), [F(3, 4), F(4)]),
        C("maximum_scalar", lambda P, x: P.maximum(x, 0.0), [F(3, 4)]),
        C("fmax", op("fmax"), [WithSpecial(), F(6)], grad=False),
        C("fmin", op("fmin"), [WithSpecial(), F(6)], grad=False),
        C("atan2", op("atan2"), [F(3, 4), F(3, 4)]),
        C("scale", op("scale", 2.0, 1.0), [F(3, 4)]),
        C("scale_before", op("scale", 2.0, 1.0, False), [F(3, 4)]),
        C("clip", op("clip", -0.5, 0.5), [F(3, 4)]),
        C("clip_max_wins", op("clip", 6.0, 3.0), [K([1.0, 5.0, 9.0],
                                                    np.float32)],
          grad=False),
        C("kron", op("kron"), [F(2, 2), F(2, 3)]),
        C("diff", op("diff"), [F(3, 5)]),
        C("diff_axis0_n2", op("diff", 2, 0), [F(4, 3)]),
        C("angle", op("angle"), [F(3, 4)], grad=False),
        C("real", op("real"), [F(3, 4)]),
        C("imag", op("imag"), [F(3, 4)], grad=False),
        C("conj", op("conj"), [F(3, 4)]),
        C("nan_to_num", op("nan_to_num"), [WithSpecial()], grad=False),
        C("nan_to_num_args", op("nan_to_num", 1.0, 9.0, -9.0),
          [WithSpecial()], grad=False),
        C("lerp", op("lerp", 0.3), [F(3, 4), F(3, 4)]),
        C("lerp_tensor_weight", op("lerp"), [F(4, 5), F(4, 5),
                                             F(5, lo=0, hi=1)]),
        C("inner", op("inner"), [F(3, 4), F(2, 4)], tol=RED),
        C("outer", op("outer"), [F(3), F(2, 2)]),
        C("heaviside", op("heaviside"), [K([-1.0, 0.0, 2.0], np.float32),
                                         K([0.5, 0.5, 0.5], np.float32)],
          grad=False),
        C("gcd", op("gcd"), [I(6, lo=1, hi=30), I(6, lo=1, hi=30)]),
        C("lcm", op("lcm"), [I(6, lo=1, hi=12), I(6, lo=1, hi=12)]),
        C("take_raise", op("take"), [F(3, 4), K([[0, -1], [5, -12]],
                                                np.int64)]),
        C("take_wrap", op("take", "wrap"), [F(6), K([-1, 6, 13], np.int64)]),
        C("take_clip", op("take", "clip"), [F(6), K([-1, 6, 13], np.int64)]),
        C("numel", op("numel"), [F(3, 4)], grad=False),
        C("multiplex", lambda P, i, a, b: P.multiplex([a, b], i),
          [K([[1], [0], [1]], np.int64), F(3, 4), F(3, 4)]),
        C("add_n", lambda P, a, b, c: P.add_n([a, b, c]),
          [F(3, 4), F(3, 4), F(3, 4)]),
        # -------------------------------------------------- math: reductions
        C("sum", op("sum"), [F(3, 4, 5)], tol=RED),
        C("sum_axis", op("sum", 1), [F(3, 4, 5)], tol=RED),
        C("sum_axes_keepdim", op("sum", [0, 2], keepdim=True), [F(3, 4, 5)],
          tol=RED),
        C("sum_bool", op("sum"), [B(3, 4)]),
        C("sum_int_axis", op("sum", 0), [I(3, 4)]),
        C("mean", op("mean"), [F(3, 4, 5)], tol=RED),
        C("mean_axes", op("mean", [0, 2]), [F(3, 4, 5)], tol=RED),
        C("mean_int", op("mean"), [I(3, 4)], tol=RED),
        C("max_axis_keepdim", op("max", -1, True), [F(3, 4, 5)]),
        C("max", op("max"), [F(3, 4)]),
        C("min_axes", op("min", [0, 1]), [F(3, 4, 5)]),
        C("amax", op("amax", 0), [F(3, 4)]),
        C("amin", op("amin", 1, True), [F(3, 4)]),
        C("max_ties", op("max", 1), [K([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]],
                                       np.float32)]),
        C("prod", op("prod"), [Pos(2, 3)], tol=RED),
        C("prod_axis", op("prod", 1), [Pos(3, 4)], tol=RED),
        C("prod_axes_keepdim", op("prod", [0, 2], True), [Pos(2, 3, 2)],
          tol=RED),
        C("logsumexp", op("logsumexp"), [F(3, 4)], tol=RED),
        C("logsumexp_axis", op("logsumexp", 1, True), [F(3, 4)], tol=RED),
        C("cumsum", op("cumsum", 1), [F(3, 4)], tol=RED),
        C("cumsum_flat", op("cumsum"), [F(3, 4)], tol=RED),
        C("cumsum_int", op("cumsum", 0), [I(3, 4)]),
        C("cumprod", op("cumprod", 1), [Pos(3, 4)], tol=RED),
        C("isnan", op("isnan"), [WithSpecial()]),
        C("isinf", op("isinf"), [WithSpecial()]),
        C("isfinite", op("isfinite"), [WithSpecial()]),
        C("all", op("all"), [B(3, 4)]),
        C("all_axis", op("all", 1), [B(3, 4)]),
        C("any_axis_keepdim", op("any", 0, True), [B(3, 4)]),
        C("count_nonzero", op("count_nonzero"), [I(3, 4, hi=3)]),
        C("count_nonzero_axis", op("count_nonzero", 1, True),
          [I(3, 4, hi=3)]),
        # --------------------------------------------------- manipulation
        C("reshape", op("reshape", [3, 8]), [F(2, 3, 4)]),
        C("reshape_infer", op("reshape", [-1, 4]), [F(2, 3, 4)]),
        C("flatten", op("flatten", 1), [F(2, 3, 4)]),
        C("flatten_range", op("flatten", 0, 1), [F(2, 3, 4)]),
        C("squeeze", op("squeeze", 1), [F(2, 1, 3)]),
        C("squeeze_all", op("squeeze"), [F(1, 2, 1, 3)]),
        C("squeeze_not_one", op("squeeze", 0), [F(2, 3)]),
        C("unsqueeze", op("unsqueeze", [0, 2]), [F(2, 3)]),
        C("unsqueeze_neg", op("unsqueeze", -1), [F(2, 3)]),
        C("transpose", op("transpose", [2, 0, 1]), [F(2, 3, 4)]),
        C("t", op("t"), [F(2, 3)]),
        C("moveaxis", op("moveaxis", 0, 2), [F(2, 3, 4)]),
        C("swapaxes", op("swapaxes", 0, 2), [F(2, 3, 4)]),
        C("concat", lambda P, a, b: P.concat([a, b], axis=1),
          [F(2, 3), F(2, 2)]),
        C("stack", lambda P, a, b: P.stack([a, b], axis=1),
          [F(2, 3), F(2, 3)]),
        C("split_num", op("split", 3, 1), [F(2, 6)]),
        C("split_sections", op("split", [3, -1, 2]), [F(10)]),
        C("chunk", op("chunk", 2, 1), [F(2, 4)]),
        C("unbind", op("unbind", 1), [F(2, 3)]),
        C("tile", op("tile", [2, 1, 2]), [F(2, 1, 3)]),
        C("expand", op("expand", [4, -1]), [F(1, 3)]),
        C("expand_as", lambda P, a, b: P.expand_as(a, b), [F(1, 3),
                                                            F(4, 3)]),
        C("broadcast_to", op("broadcast_to", [2, 3, 4]), [F(3, 1)]),
        C("broadcast_tensors", lambda P, a, b: P.broadcast_tensors([a, b]),
          [F(3, 1), F(1, 4)]),
        C("flip", op("flip", [0, 1]), [F(2, 3)]),
        C("roll", op("roll", 1, 1), [F(2, 3)]),
        C("roll_flat", op("roll", 2), [F(2, 3)]),
        C("rot90", op("rot90", 1, [0, 1]), [F(2, 3)]),
        C("gather", op("gather"), [F(4, 3), K([0, 2, 2], np.int64)]),
        C("gather_axis1", op("gather", axis=1), [F(4, 3), K([2, 0],
                                                           np.int64)]),
        C("gather_nd", op("gather_nd"), [F(2, 3, 4),
                                         K([[0, 2], [1, 0]], np.int64)]),
        C("take_along_axis", op("take_along_axis", axis=1),
          [F(3, 4), K([[0, 3], [1, 1], [2, 0]], np.int64)]),
        C("put_along_axis", op("put_along_axis", axis=1),
          [F(2, 3), K([[0], [2]], np.int64), F(2, 1)]),
        C("put_along_axis_add", op("put_along_axis", axis=1, reduce="add"),
          [F(2, 3), K([[0], [2]], np.int64), F(2, 1)]),
        C("put_along_axis_mul", op("put_along_axis", axis=1, reduce="mul"),
          [F(2, 3), K([[0], [2]], np.int64), F(2, 1)], grad=False),
        C("scatter", op("scatter"), [F(4, 3), K([0, 2], np.int64),
                                     F(2, 3)]),
        C("scatter_accumulate", op("scatter", overwrite=False),
          [F(3, 2), K([1, 1], np.int64), F(2, 2)]),
        C("scatter_nd_add", op("scatter_nd_add"),
          [F(5), K([[1], [1], [1], [3]], np.int64), F(4)]),
        C("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [5]),
          [K([[1], [3]], np.int64), F(2)]),
        C("index_select", op("index_select", axis=1),
          [F(3, 4), K([3, 0], np.int64)]),
        C("index_sample", op("index_sample"),
          [F(3, 4), K([[0, 3], [1, 1], [2, 0]], np.int64)]),
        C("masked_select", op("masked_select"), [F(3, 4), B(3, 4)],
          grad=False),
        C("slice", op("slice", [0, 1], [1, 0], [3, -1]), [F(3, 4)]),
        C("strided_slice", op("strided_slice", [1], [0], [4], [2]),
          [F(3, 4)]),
        C("strided_slice_neg", op("strided_slice", [1], [3], [0], [-1]),
          [F(3, 4)]),
        C("unique", op("unique", True, True, True),
          [K([3, 1, 2, 3, 1, 5], np.int64)]),
        C("unique_float", op("unique"), [K([0.5, -1.0, 0.5, 2.0],
                                           np.float32)], grad=False),
        C("unique_nan", op("unique", True, True, True),
          [K([[2.0, np.nan, 0.5], [np.nan, 2.0, -1.0]], np.float32)],
          grad=False),
        C("unique_axis", op("unique", True, True, True, axis=0),
          [K([[3, 1], [1, 2], [3, 1], [0, 5], [1, 2]], np.int64)]),
        C("unique_consecutive", op("unique_consecutive"),
          [K([1, 1, 2, 2, 3, 1, 1], np.int64)]),
        C("unique_consecutive_nan", op("unique_consecutive"),
          [K([[1.0, 1.0, np.nan], [np.nan, 2.0, 2.0]], np.float32)],
          grad=False),
        C("repeat_interleave", op("repeat_interleave", 2, 0), [F(2, 3)]),
        C("repeat_interleave_flat", op("repeat_interleave", 2), [F(2, 3)]),
        C("as_complex_as_real",
          lambda P, a: P.as_real(P.as_complex(a)), [F(3, 2)], grad=False),
        C("tensordot", op("tensordot", 1), [F(2, 3), F(3, 4)], tol=RED),
        C("tensordot_axes", op("tensordot", [[1, 2], [0, 1]]),
          [F(2, 3, 4), F(3, 4, 2)], tol=RED),
        C("shard_index", op("shard_index", 20, 2, 1),
          [K([[1], [12], [19], [3]], np.int64)]),
        # ------------------------------------------------------------ logic
        C("equal", op("equal"), [I(3, 4, hi=3), I(3, 4, hi=3)]),
        C("not_equal", op("not_equal"), [I(3, 4, hi=3), I(3, 4, hi=3)]),
        C("greater_than", op("greater_than"), [F(3, 4), F(3, 4)]),
        C("greater_equal", op("greater_equal"), [I(3, 4), I(4)]),
        C("less_than", op("less_than"), [F(3, 4), F(3, 4)]),
        C("less_equal", op("less_equal"), [I(3, 4), I(3, 4)]),
        C("equal_all", op("equal_all"), [I(3, hi=2), I(3, hi=2)]),
        C("equal_all_same", lambda P, a: P.equal_all(a, a), [F(3)]),
        C("allclose", op("allclose"), [F(3), F(3)]),
        C("isclose", op("isclose", 0.5, 0.1), [F(6), F(6)]),
        C("logical_and", op("logical_and"), [B(3, 4), B(3, 4)]),
        C("logical_or", op("logical_or"), [B(3, 4), B(3, 4)]),
        C("logical_xor", op("logical_xor"), [B(3, 4), B(3, 4)]),
        C("logical_not", op("logical_not"), [B(3, 4)]),
        C("bitwise_and", op("bitwise_and"), [I(6, hi=16), I(6, hi=16)]),
        C("bitwise_or", op("bitwise_or"), [I(6, hi=16), I(6, hi=16)]),
        C("bitwise_xor", op("bitwise_xor"), [I(6, hi=16), I(6, hi=16)]),
        C("bitwise_not", op("bitwise_not"), [I(6, hi=16)]),
        C("is_empty", op("is_empty"), [F(3, 4)]),
        # ----------------------------------------------------------- search
        C("argmax", op("argmax"), [F(3, 4)]),
        C("argmax_axis_keepdim", op("argmax", 1, True), [F(3, 4)]),
        C("argmax_ties", op("argmax"), [K([2.0, 7.0, 7.0, 1.0],
                                          np.float32)]),
        C("argmin_ties", op("argmin", 0), [K([2.0, 0.5, 0.5, 1.0],
                                             np.float32)]),
        C("argsort", op("argsort", 1), [F(3, 5)]),
        C("argsort_desc_ties", op("argsort", -1, True),
          [K([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 1.0, 1.0, 0.0]],
             np.float32)]),
        C("argsort_ties", op("argsort", 0),
          [K([2.0, 1.0, 2.0, 1.0], np.float32)]),
        C("sort", op("sort", 1), [F(3, 5)]),
        C("sort_desc", op("sort", 0, True), [F(4, 3)]),
        C("topk", op("topk", 2, 1), [F(3, 5)]),
        C("topk_ties", op("topk", 3),
          [K([[1.0, 3.0, 3.0, 2.0, 3.0], [5.0, 5.0, 5.0, 5.0, 5.0]],
             np.float32)]),
        C("topk_smallest", op("topk", 2, 0, False), [F(4, 3)]),
        C("topk_smallest_ties", op("topk", 2, largest=False),
          [K([[2.0, 1.0, 1.0, 1.0]], np.float32)]),
        C("where", op("where"), [B(3, 4), F(3, 4), F(3, 4)]),
        C("where_scalar", lambda P, c, x: P.where(c, x, 0.0),
          [B(3, 4), F(3, 4)]),
        C("nonzero", op("nonzero"), [I(3, 4, hi=2)]),
        C("nonzero_tuple", op("nonzero", True), [I(3, 4, hi=2)]),
        C("masked_fill", op("masked_fill", value=2.5), [F(3, 4), B(3, 4)]),
        C("index_put", lambda P, x, i, v: P.index_put(x, (i,), v),
          [F(4, 3), K([0, 2], np.int64), F(2, 3)]),
        C("index_put_accumulate",
          lambda P, x, i, v: P.index_put(x, (i,), v, accumulate=True),
          [F(4, 3), K([1, 1], np.int64), F(2, 3)]),
        C("searchsorted", op("searchsorted"),
          [K([1.0, 2.0, 2.0, 4.0], np.float32), K([0.5, 2.0, 5.0],
                                                  np.float32)]),
        C("searchsorted_right_i32", op("searchsorted", True, True),
          [K([1.0, 2.0, 2.0, 4.0], np.float32), K([0.5, 2.0, 5.0],
                                                  np.float32)]),
        C("kthvalue", op("kthvalue", 2, 1), [F(3, 5)]),
        C("kthvalue_keepdim", op("kthvalue", 1, 0, True), [F(3, 5)]),
        C("mode", op("mode", 1), [lambda rng: rng.randint(0, 3, (4, 7))
                                  .astype(np.float32)]),
        C("mode_axis0_keepdim", op("mode", 0, True),
          [lambda rng: rng.randint(0, 3, (5, 3)).astype(np.float32)]),
        C("median", op("median"), [F(3, 4)], tol=RED),
        C("median_axis", op("median", 1), [F(3, 5)], tol=RED),
        C("median_axis_keepdim", op("median", 0, True), [F(4, 3)],
          tol=RED),
        C("median_keepdim_flat", op("median", keepdim=True), [F(2, 3)],
          tol=RED),
        C("median_int", op("median"), [K([[3, 1, 2, 4]], np.int32)]),
        C("median_poison", op("median", 1),
          [K([[1.0, 2.0, np.inf], [1.0, np.nan, 3.0], [4.0, 1.0, 2.0]],
             np.float32)], grad=False),
        C("nanmedian", op("nanmedian", 1),
          [K([[np.nan, 2.0, 3.0], [0.0, 1.0, 2.0]], np.float32)],
          grad=False),
        C("nanmedian_axes", op("nanmedian", [0, 1]),
          [K([[np.nan, 2.0], [4.0, 1.0]], np.float32)], grad=False),
        C("nanmedian_flat", op("nanmedian", keepdim=False), [F(3, 4)],
          tol=RED),
        C("quantile", op("quantile", 0.3, 1), [F(6, 8)], tol=RED),
        C("quantile_list", op("quantile", [0.3, 0.5], 0), [F(4, 2)],
          tol=RED),
        C("quantile_axes_keepdim", op("quantile", 0.25, [0, 2], True),
          [F(3, 2, 4)], tol=RED),
        C("quantile_one_element_list", op("quantile", [0.5]), [F(5)],
          tol=RED),
        C("quantile_axes_nan_row", op("quantile", 0.8, 1, True),
          [K([[np.nan, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]],
             np.float32)], grad=False),
        C("quantile_all_axes", op("quantile", 0.5, [0, 1]), [F(4, 2)],
          tol=RED),
        C("nanquantile_one_element_list", op("nanquantile", [0.5], 0),
          [F(4, 2)], tol=RED),
        C("nanquantile", op("nanquantile", 0.5, 1),
          [K([[np.nan, 2.0, 3.0, 7.0], [0.0, 1.0, np.nan, 2.0]],
             np.float32)], grad=False),
        # ------------------------------------------------------------- stat
        C("std", op("std"), [F(3, 4)], tol=RED),
        C("std_axis_biased", op("std", 1, False, True), [F(3, 4)], tol=RED),
        C("var", op("var", [0, 1]), [F(3, 4, 2)], tol=RED),
        C("var_int", op("var"), [I(3, 4)], tol=RED),
        C("nanmean", op("nanmean"), [WithSpecial()], grad=False),
        C("nanmean_axis", op("nanmean", 1),
          [K([[1.0, np.nan, 3.0], [np.nan, np.nan, 2.0]], np.float32)],
          grad=False),
        C("nansum", op("nansum", 0),
          [K([[1.0, np.nan], [2.5, 3.0]], np.float32)], grad=False),
        # ----------------------------------------------------------- linalg
        C("matmul", op("matmul"), [F(3, 4), F(4, 2)], tol=RED),
        C("matmul_transpose", op("matmul", transpose_y=True),
          [F(3, 4), F(5, 4)], tol=RED),
        C("matmul_transpose_x", op("matmul", True), [F(4, 3), F(4, 2)],
          tol=RED),
        C("matmul_batched", op("matmul"), [F(2, 3, 4), F(4, 5)], tol=RED),
        C("matmul_vec", op("matmul"), [F(3, 4), F(4)], tol=RED),
        C("mm", op("mm"), [F(3, 4), F(4, 2)], tol=RED),
        C("dot", op("dot"), [F(3, 4), F(3, 4)], tol=RED),
        C("bmm", op("bmm"), [F(2, 3, 4), F(2, 4, 2)], tol=RED),
        C("mv", op("mv"), [F(3, 4), F(4)], tol=RED),
        C("matmul_operator", lambda P, a, b: a @ b, [F(3, 4), F(4, 2)],
          tol=RED),
        C("norm", op("norm"), [F(3, 4)], tol=RED),
        C("norm_axis", op("norm", "fro", 1), [F(3, 4)], tol=RED),
        C("norm_p1", op("norm", 1, 1), [F(3, 4)], tol=RED),
        C("norm_p3", op("norm", 3, 0, True), [F(3, 4)], tol=RED),
        C("norm_inf", op("norm", float("inf"), 1), [F(3, 4)], tol=RED),
        C("norm_p0", op("norm", 0), [K([[0.0, 1.0], [2.0, 0.0]],
                                       np.float32)], grad=False),
        C("dist", op("dist"), [F(3, 4), F(3, 4)], tol=RED),
        C("dist_p1", op("dist", 1), [F(3, 4), F(3, 4)], tol=RED),
        C("cross", op("cross"), [F(4, 3), F(4, 3)], tol=RED),
        C("cholesky", op("cholesky"), [SPD(3)], tol=RED),
        C("cholesky_upper", op("cholesky", True), [SPD(3)], tol=RED),
        C("inverse", op("inverse"), [SPD(3)], tol=RED),
        C("pinv", op("pinv"), [F(4, 3)], tol=RED),
        C("det", op("det"), [SPD(3)], tol=RED),
        C("slogdet", op("slogdet"), [F(3, 3)], tol=RED),
        C("svd_values", lambda P, a: P.svd(a)[1], [F(4, 3)], tol=RED),
        C("svd_reconstruct",
          lambda P, a: (lambda u, s, vh: P.matmul(u * s, vh))(*P.svd(a)),
          [F(4, 3)], tol=RED),
        C("qr_reconstruct", lambda P, a: P.matmul(*P.qr(a)), [F(4, 3)],
          tol=RED),
        C("qr_r_abs", lambda P, a: P.abs(P.qr(a)[1]), [F(4, 3)], tol=RED,
          grad=False),
        C("eigh_values", lambda P, a: P.eigh(a)[0], [SPD(3)], tol=RED),
        C("eigvalsh", op("eigvalsh"), [SPD(3)], tol=RED),
        C("eigvals_sorted", lambda P, a: P.real(P.eigvals(a)), [SPD(3)],
          tol=RED, grad=False, post=lambda outs: [np.sort(outs[0])]),
        C("eig_values_sorted", lambda P, a: P.real(P.eig(a)[0]), [SPD(3)],
          tol=RED, grad=False, post=lambda outs: [np.sort(outs[0])]),
        C("matrix_rank", op("matrix_rank"),
          [K([[1.0, 2.0], [2.0, 4.0]], np.float32)]),
        C("matrix_power", op("matrix_power", 3), [F(3, 3)], tol=RED),
        C("solve", op("solve"), [SPD(3), F(3, 2)], tol=RED),
        C("triangular_solve", lambda P, a, b: P.triangular_solve(
            P.triu(a), b), [SPD(3), F(3, 2)], tol=RED),
        C("triangular_solve_lower_t", lambda P, a, b: P.triangular_solve(
            P.tril(a), b, upper=False, transpose=True), [SPD(3), F(3, 2)],
          tol=RED),
        C("cholesky_solve", lambda P, b, a: P.cholesky_solve(
            b, P.cholesky(a)), [F(3, 2), SPD(3)], tol=RED),
        C("lstsq_solution", lambda P, a, b: P.lstsq(a, b)[0],
          [F(5, 3), F(5, 2)], tol=RED),
        C("lstsq_rank_sv", lambda P, a, b: P.lstsq(a, b)[1:],
          [F(5, 3), F(5, 2)], tol=RED, grad=False),
        C("lu", op("lu"), [F(4, 4)], tol=RED),
        C("lu_unpack", lambda P, a: P.lu_unpack(*P.lu(a)), [F(4, 4)],
          tol=RED, grad=False),
        C("multi_dot", lambda P, a, b, c: P.multi_dot([a, b, c]),
          [F(2, 3), F(3, 4), F(4, 2)], tol=RED),
        C("histogram", op("histogram", 3, 0.0, 3.0),
          [K([-5.0, 0.5, 1.5, 2.5, 99.0, 3.0], np.float32)]),
        C("histogram_auto", op("histogram", 4), [F(20)]),
        C("bincount", op("bincount"), [K([0, 1, 1, 3], np.int64)],
          jax_uncached=True),
        C("bincount_weights", lambda P, x, w: P.bincount(x, w, 6),
          [K([0, 1, 1, 3], np.int64), F(4)], tol=RED, jax_uncached=True),
        C("cov", op("cov"), [F(3, 6)], tol=RED),
        C("cov_cols_biased", op("cov", False, False), [F(6, 3)], tol=RED),
        C("corrcoef", op("corrcoef"), [F(3, 6)], tol=RED),
        C("einsum_transpose", lambda P, a: P.einsum("ij->ji", a), [F(3, 4)]),
        C("einsum_bmm", lambda P, a, b: P.einsum("bij,bjk->bik", a, b),
          [F(2, 3, 4), F(2, 4, 2)], tol=RED),
        C("einsum_trace", lambda P, a: P.einsum("ii", a), [F(3, 3)],
          tol=RED),
        # ----------------------------------------------------------- extras
        C("addmm", op("addmm", beta=0.5, alpha=2.0),
          [F(3, 2), F(3, 4), F(4, 2)], tol=RED),
        C("trace", op("trace"), [F(3, 4)], tol=RED),
        C("trace_offset", op("trace", 1, 1, 2), [F(2, 3, 3)], tol=RED),
        C("diagonal", op("diagonal", 1), [F(3, 4)]),
        C("diagonal_axes", op("diagonal", 0, 1, 2), [F(2, 3, 3)]),
        C("vector_norm", op("vector_norm"), [F(3, 4)], tol=RED),
        C("vector_norm_axis_p1", op("vector_norm", 1.0, 1, True),
          [F(3, 4)], tol=RED),
        C("vector_norm_inf", op("vector_norm", float("inf")), [F(3, 4)],
          tol=RED),
        C("renorm", op("renorm", 2.0, 0, 1.0), [F(3, 4, lo=-2, hi=2)],
          tol=RED),
        C("logit", op("logit"), [F(3, 4, lo=0.05, hi=0.95)]),
        C("logit_eps", op("logit", 0.2), [F(3, 4, lo=0.05, hi=0.95)]),
        C("sgn", op("sgn"), [F(3, 4)]),
        C("logcumsumexp", op("logcumsumexp", 1), [F(3, 4)], tol=RED),
        C("logcumsumexp_flat", op("logcumsumexp"), [F(3, 4)], tol=RED),
        C("cast_int", op("cast", "int32"), [F(3, 4, lo=-3, hi=3)]),
        C("cast_f64", op("cast", "float64"), [F(3, 4)]),
        C("cast_bf16", op("cast", "bfloat16"), [F(3, 4)], tol=BF16),
        C("bucketize", op("bucketize"), [K([0.5, 1.5, 2.5, 2.0], np.float32),
                                         K([1.0, 2.0], np.float32)]),
        C("bucketize_right", op("bucketize", right=True),
          [K([0.5, 1.5, 2.5, 2.0], np.float32), K([1.0, 2.0], np.float32)]),
        C("index_add", lambda P, x, i, v: P.index_add(x, i, 0, v),
          [F(4, 3), K([0, 2, 0], np.int64), F(3, 3)]),
        C("crop", op("crop", [2, 2], [1, 1]), [F(3, 4)]),
        C("crop_minus_one", op("crop", [-1, 2], [1, 0]), [F(3, 4)]),
        C("unstack", op("unstack", 1), [F(2, 3)]),
        C("fill_diagonal_tensor", op("fill_diagonal_tensor", 1),
          [F(3, 4), F(3)]),
        C("rank", op("rank"), [F(2, 3, 4)]),
        C("fill", op("fill", 3.0), [F(3, 4)]),
        C("vander", op("vander", 3), [F(4)], tol=RED),
        C("vander_increasing", op("vander", None, True), [F(3)], tol=RED),
        C("trapezoid", op("trapezoid"), [F(3, 5)], tol=RED),
        C("trapezoid_x", lambda P, y, x: P.trapezoid(y, x), [F(5), Pos(5)],
          tol=RED),
        C("trapezoid_dx", op("trapezoid", dx=0.5, axis=0), [F(4, 3)],
          tol=RED),
        C("cumulative_trapezoid", op("cumulative_trapezoid"), [F(3, 5)],
          tol=RED),
        C("cumulative_trapezoid_x",
          lambda P, y, x: P.cumulative_trapezoid(y, x), [F(5), Pos(5)],
          tol=RED),
        C("frexp", op("frexp"), [K([8.0, 0.3, -5.0, 0.0], np.float32)],
          grad=False),
        C("ldexp", op("ldexp"), [F(4), K([1, 2, -1, 0], np.int64)]),
        C("copysign", op("copysign"), [F(6), F(6)]),
        C("nextafter", op("nextafter"), [F(4), F(4)], grad=False),
        C("hypot", op("hypot"), [F(3, 4), F(3, 4)]),
        C("signbit", op("signbit"), [F(3, 4)]),
        C("isposinf", op("isposinf"), [WithSpecial()]),
        C("isneginf", op("isneginf"), [WithSpecial()]),
        C("isreal", op("isreal"), [F(3)]),
        C("polar", op("polar"), [Pos(3), F(3)], grad=False),
        C("view_as_complex_real",
          lambda P, a: P.view_as_real(P.view_as_complex(a)), [F(3, 2)],
          grad=False),
        C("matrix_exp", op("matrix_exp"), [F(3, 3, lo=-0.3, hi=0.3)],
          tol=RED),
        C("cdist", op("cdist"), [F(3, 5), F(4, 5)], tol=RED),
        C("cdist_p1", op("cdist", 1.0), [F(3, 5), F(4, 5)], tol=RED),
        C("cdist_inf", op("cdist", float("inf")), [F(3, 5), F(4, 5)],
          tol=RED),
        C("cdist_p0", op("cdist", 0.0), [K([[0.0, 1.0], [1.0, 1.0]],
                                           np.float32),
                                         K([[0.0, 1.0]], np.float32)],
          grad=False),
        C("householder_product", op("householder_product"),
          [F(5, 3), F(3, lo=0.5, hi=1.5)], tol=RED),
        C("cond", op("cond"), [SPD(3)], tol=RED),
        C("frobenius_norm", op("frobenius_norm"), [F(3, 4)], tol=RED),
        C("frobenius_norm_axis", op("frobenius_norm", [1], True),
          [F(3, 4)], tol=RED),
        C("shape", op("shape"), [F(2, 3, 4)]),
        # --------------------------------------------------------- creation
        C("zeros_like", op("zeros_like"), [F(3, 4)]),
        C("ones_like_int", op("ones_like", "int64"), [F(3, 4)]),
        C("full_like", op("full_like", 2.5), [F(3, 4)]),
        C("empty_like_shape", lambda P, a: P.empty_like(a).shape, [F(3, 4)],
          grad=False),
        C("diag_vector", op("diag", 1), [F(3)]),
        C("diag_padding", op("diag", 0, 9.0), [F(3)]),
        C("diag_matrix", op("diag", -1), [F(3, 4)]),
        C("diagflat", op("diagflat", 1), [F(2, 2)]),
        C("tril", op("tril"), [F(3, 4)]),
        C("triu", op("triu", 1), [F(3, 4)]),
        C("meshgrid", lambda P, a, b: P.meshgrid(a, b), [F(3), F(4)],
          grad=False),
        C("assign", op("assign"), [F(3, 4)]),
        C("clone", op("clone"), [F(3, 4)]),
        C("complex_abs", lambda P, r, i: P.abs(P.complex(r, i)),
          [F(3), F(3)], grad=False),
        C("tolist", op("tolist"), [I(2, 3)]),
        # ------------------------------------------- Tensor methods and ops
        C("method_sum", lambda P, a: a.sum(axis=1), [F(3, 4)], tol=RED),
        C("method_mean", lambda P, a: a.mean(), [F(3, 4)], tol=RED),
        C("method_reshape", lambda P, a: a.reshape([4, 3]), [F(3, 4)]),
        C("method_transpose", lambda P, a: a.transpose([1, 0]), [F(3, 4)]),
        C("method_matmul", lambda P, a, b: a.matmul(b), [F(3, 4), F(4, 2)],
          tol=RED),
        C("method_astype", lambda P, a: a.astype("int64"),
          [F(3, 4, lo=-3, hi=3)]),
        C("getitem_basic", lambda P, a: a[0, 1:3], [F(3, 4)]),
        C("getitem_ellipsis", lambda P, a: a[..., -1], [F(2, 3, 4)]),
        C("getitem_none", lambda P, a: a[None, :, 1], [F(3, 4)]),
        C("getitem_tensor", lambda P, a, i: a[i], [F(4, 3),
                                                   K([2, 0], np.int64)]),
        C("getitem_mask", lambda P, a, m: a[m], [F(3, 4), B(3, 4)]),
        C("neg_abs_invert", lambda P, a, m: (-a, abs(a), ~m),
          [F(3, 4), B(3, 4)]),
        C("floordiv_mod_ops", lambda P, a, b: (a // b, a % b),
          [F(3, 4, lo=-3, hi=3), Pos(3, 4)], grad=False),
        C("rsub_rtruediv", lambda P, a: (1.5 - a, 2.0 / a), [Pos(3, 4)]),
        C("compare_ops", lambda P, a, b: (a == b, a != b, a < b, a <= b,
                                          a > b, a >= b),
          [I(3, 4, hi=3), I(3, 4, hi=3)]),
        C("bf16_matmul", lambda P, a, b: P.matmul(a.astype("bfloat16"),
                                                  b.astype("bfloat16")),
          [F(3, 4), F(4, 2)], tol=BF16),
        C("bf16_softplus_ops", lambda P, a: P.log1p(P.exp(
            a.astype("bfloat16"))), [F(3, 4)], tol=BF16),
    ]
)

# in-place variants: (op_, args) applied to a fresh copy of one input
INPLACE_TABLE = [
    ("tanh_", (), F(3, 4)), ("clip_", (-0.3, 0.3), F(3, 4)),
    ("exp_", (), F(3, 4)), ("sqrt_", (), Pos(3, 4)),
    ("rsqrt_", (), Pos(3, 4)), ("reciprocal_", (), Pos(3, 4)),
    ("round_", (), F(3, 4, lo=-3, hi=3)), ("floor_", (), F(3, 4)),
    ("ceil_", (), F(3, 4)), ("erfinv_", (), F(3, 4, lo=-0.9, hi=0.9)),
    ("squeeze_", (1,), F(2, 1, 3)), ("unsqueeze_", (0,), F(2, 3)),
    ("flatten_", (), F(2, 3)), ("reshape_", ([3, 2],), F(2, 3)),
    ("scale_", (2.0,), F(3, 4)), ("fill_", (1.5,), F(3, 4)),
    ("zero_", (), F(3, 4)), ("add_", (1.0,), F(3, 4)),
    ("subtract_", (0.5,), F(3, 4)), ("multiply_", (3.0,), F(3, 4)),
    ("cast_", ("int64",), F(3, 4, lo=-3, hi=3)),
    ("fill_diagonal_", (7.0,), F(3, 3)),
]


def width_map(name):
    """A port dtype name -> the JAX package's name for it (C.14)."""
    return {"int64": "int32", "float64": "float32",
            "complex128": "complex64"}.get(name, name)


def flat_outputs(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res.extend(flat_outputs(o))
        return res
    return [out]


def host(o):
    """(numpy value or Python value, dtype name or None) of one output."""
    if hasattr(o, "numpy") and hasattr(o, "dtype"):
        arr = np.asarray(o.numpy())
        name = str(o.dtype).replace("torch.", "")
        if "bfloat16" in name:
            arr = arr.astype(np.float32)
        return arr, name
    return o, None


def compare(got, want, tol, what):
    """Port outputs `got` against JAX outputs `want` (host() pairs)."""
    assert len(got) == len(want), (what, len(got), len(want))
    for (g, gd), (w, wd) in zip(got, want):
        if gd is None:
            assert g == w, (what, g, w)
            continue
        assert width_map(gd) == width_map(wd), (what, gd, wd)
        assert g.shape == np.shape(w), (what, g.shape, np.shape(w))
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, np.asarray(w, g.dtype), rtol=tol,
                                       atol=tol, err_msg=what)


def run_case(P, case, arrays, *, grad, place=None):
    """Run one case in package P; returns (outputs, input grads)."""
    kw = {} if place is None else {"place": place}
    tensors = [P.to_tensor(a, stop_gradient=not (
        grad and a.dtype.kind == "f"), **kw) for a in arrays]
    out = case.fn(P, *tensors)
    outs = flat_outputs(out)
    grads = None
    if grad:
        rng = np.random.RandomState(7)
        loss = None
        for o in outs:
            if not hasattr(o, "stop_gradient") or o.stop_gradient \
                    or "complex" in str(o.dtype):
                continue
            w = P.to_tensor(rng.uniform(0.5, 1.5, o.shape).astype(
                np.float32), **kw).astype(o.dtype)
            term = (o * w).sum()
            loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        grads = [t.grad for t in tensors]
    return outs, grads


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


@pytest.mark.parametrize("case", OP_TABLE, ids=lambda c: c.id)
def test_op_matches_jax(case, cpu):
    import paddle_tpu as pj
    pt = cpu
    arrays = case.inputs()
    grad = case.grad and any(a.dtype.kind == "f" for a in arrays)
    from paddle_tpu.core import tensor as jax_tensor
    cached = jax_tensor.eager_op_cache_enabled
    jax_tensor.eager_op_cache_enabled = cached and not case.jax_uncached
    try:
        want, wgrads = run_case(pj, case, arrays, grad=grad)
    finally:
        jax_tensor.eager_op_cache_enabled = cached
    got, ggrads = run_case(pt, case, arrays, grad=grad)
    want = [host(o) for o in want]
    got = [host(o) for o in got]
    if case.post is not None:
        want = [(v, d) for v, d in zip(case.post([w for w, _ in want]),
                                       [d for _, d in want])]
        got = [(v, d) for v, d in zip(case.post([g for g, _ in got]),
                                      [d for _, d in got])]
    compare(got, want, case.tol, case.id)
    if grad:
        for i, (g, w) in enumerate(zip(ggrads, wgrads)):
            if arrays[i].dtype.kind != "f":
                continue
            g = np.zeros_like(arrays[i]) if g is None else g.numpy()
            w = np.zeros_like(arrays[i]) if w is None else np.asarray(
                w.numpy())
            np.testing.assert_allclose(g, w, rtol=case.tol, atol=case.tol,
                                       err_msg=f"{case.id}: grad of input "
                                               f"{i}")


@pytest.mark.parametrize("name,args,maker", INPLACE_TABLE,
                         ids=[r[0] for r in INPLACE_TABLE])
def test_inplace_variant_matches_jax(name, args, maker, cpu):
    import paddle_tpu as pj
    pt = cpu
    a = maker(np.random.RandomState(3))
    outs = []
    for P in (pj, pt):
        x = P.to_tensor(a)
        r = getattr(x, name)(*args)
        assert r is x
        outs.append(host(x))
    compare([outs[1]], [outs[0]], EW, name)


def test_creation_ops_match_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    calls = [
        lambda P: P.zeros([2, 3]), lambda P: P.ones([2, 3], "int64"),
        lambda P: P.full([2, 2], 7), lambda P: P.full([2], 1.5, "float64"),
        lambda P: P.empty([2, 3]), lambda P: P.arange(5),
        lambda P: P.arange(1, 10, 3), lambda P: P.arange(0.0, 1.0, 0.25),
        lambda P: P.linspace(0, 1, 5), lambda P: P.logspace(0, 2, 3),
        lambda P: P.logspace(0, 3, 4, base=2.0), lambda P: P.eye(3),
        lambda P: P.eye(2, 3, "int32"), lambda P: P.tril_indices(3),
        lambda P: P.triu_indices(3, 4, 1), lambda P: P.numel(P.ones([2, 5])),
        lambda P: P.to_tensor([1, 2, 3]), lambda P: P.to_tensor(2.5),
        lambda P: P.to_tensor([[True, False]]),
        lambda P: P.to_tensor(np.arange(4.0)),
        lambda P: P.to_tensor([1.0, 2.0], dtype="bfloat16"),
    ]
    for i, call in enumerate(calls):
        compare([host(o) for o in flat_outputs(call(pt))],
                [host(o) for o in flat_outputs(call(pj))], EW,
                f"creation call {i}")


def test_dtype_predicates_and_info_match_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    for fn in ("is_complex", "is_floating_point", "is_integer"):
        for a in (np.ones(2, np.float32), np.ones(2, np.int64)):
            assert getattr(pt, fn)(pt.to_tensor(a)) == \
                getattr(pj, fn)(pj.to_tensor(a)), fn
    for d in ("bfloat16", "float16", "float32"):
        for attr in ("bits", "eps", "max", "min", "tiny"):
            assert float(getattr(pt.finfo(d), attr)) == \
                float(getattr(pj.finfo(d), attr)), (d, attr)
    for d in ("int8", "int32", "int64", "uint8"):
        for attr in ("bits", "max", "min"):
            assert getattr(pt.iinfo(d), attr) == getattr(pj.iinfo(d), attr)
    assert pt.broadcast_shape([3, 1], [1, 4]) == \
        pj.broadcast_shape([3, 1], [1, 4]) == [3, 4]
    assert pt.is_tensor(pt.ones([1])) and not pt.is_tensor(1.0)
