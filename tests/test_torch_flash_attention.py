"""The port's flash attention against the JAX package's Pallas kernels, on
the CPU.

The same numpy inputs go through `paddle_tpu.ops.pallas.flash_attention`
(its kernels in interpret mode, as `tests/test_pallas_flash.py` runs them,
with block 64 over S=128, so every case spans several blocks) and through
`paddle_tpu_torch.ops.flash_attention`. On CPU tensors the port's kernel
wrappers run their plain versions, so these tests hold the plain versions
(the ones the CUDA kernels are held against on the card) to the TPU
kernels: forward O and logsumexp, and dQ/dK/dV through autograd.

The edge-shape cases hold the same plain versions, at the lengths where
the card kernels' 128-row tiles end ragged (S = 64, 129, 200), to the JAX
package's XLA path `_ref_attention_bhsd` under `jax.vjp` (the Pallas
kernels take only S that their blocks divide).

Tolerances: float32 atol 2e-5 forward, 1e-4 gradients (the kernels sum
in blocks, the plain versions over whole rows); bf16 2e-2 (8 mantissa
bits, and P is rounded against a different running max).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.flash_attention import _ref_attention_bhsd
from paddle_tpu_torch.ops import flash_attention as fa

# the module (the package re-exports its `flash_attention` function)
jpf = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

BLOCK = 64
F32_FWD, F32_GRAD, BF16 = 2e-5, 1e-4, 2e-2

# name -> (B, H, Hk, S, D, causal, mask kind, dropout rate, dtype)
CASES = {
    "causal": (2, 2, 2, 128, 64, True, None, 0.0, "float32"),
    "noncausal": (2, 2, 2, 128, 64, False, None, 0.0, "float32"),
    "mask_b1ss": (2, 2, 2, 128, 32, False, "b1ss", 0.0, "float32"),
    "mask_causal_11ss": (1, 2, 2, 128, 32, True, "11ss", 0.0, "float32"),
    "dropout": (1, 2, 2, 128, 32, True, None, 0.1, "float32"),
    "gqa": (1, 4, 2, 128, 32, True, None, 0.0, "float32"),
    "bf16": (2, 2, 2, 128, 64, True, None, 0.0, "bfloat16"),
}
SEED = 1234


def _inputs(case, seed=0):
    B, H, Hk, S, D, causal, mask_kind, rate, dtype = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, Hk, S, D).astype(np.float32)
    v = rng.randn(B, Hk, S, D).astype(np.float32)
    w = rng.randn(B, H, S, D).astype(np.float32)       # output cotangent
    mask = None
    if mask_kind is not None:
        Bm = B if mask_kind == "b1ss" else 1
        mask = (rng.randn(Bm, 1, S, S) * 2).astype(np.float32)
        mask[rng.rand(Bm, 1, S, S) < 0.2] = -np.inf
        mask[:, :, 5, :] = -np.inf                     # a fully masked row
        mask[:, :, 70, :] = -1e9
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    return dict(q=q, k=k, v=v, w=w, mask=mask, causal=causal, rate=rate,
                dtype=dtype, H=H, Hk=Hk)


def _j(x, dtype):
    return None if x is None else jnp.asarray(x, jnp.dtype(dtype))


def _t(x, dtype, grad=False):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x)).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
    return t.requires_grad_(grad)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _jax_fwd(c):
    """O and lse from the Pallas forward kernel (interpret mode)."""
    B, H, S, D = c["q"].shape
    Hk = c["Hk"]
    dt = c["dtype"]
    mf, mask_dims = jpf._flatten_mask(_j(c["mask"], "float32"), B, H)
    seed = ((jnp.asarray([SEED], jnp.int32), c["rate"])
            if c["rate"] > 0 else None)
    o, lse = jpf._mha_forward(
        _j(c["q"], dt).reshape(B * H, S, D),
        _j(c["k"], dt).reshape(B * Hk, S, D),
        _j(c["v"], dt).reshape(B * Hk, S, D), mf, seed, c["causal"],
        1.0 / D ** 0.5, BLOCK, BLOCK, True, H, Hk, mask_dims)
    return o.reshape(B, H, S, D), lse[..., 0]


def _jax_grads(c):
    dt = c["dtype"]
    kw = dict(mask=_j(c["mask"], "float32"), causal=c["causal"],
              block_q=BLOCK, block_k=BLOCK, interpret=True)
    if c["rate"] > 0:
        kw.update(dropout_rate=c["rate"], dropout_seed=SEED)
    _, vjp = jax.vjp(lambda q, k, v: jpf.flash_attention(q, k, v, **kw),
                     _j(c["q"], dt), _j(c["k"], dt), _j(c["v"], dt))
    return vjp(_j(c["w"], dt))


def _port(c, grad=False):
    dt = c["dtype"]
    q, k, v = (_t(c[n], dt, grad) for n in "qkv")
    o = fa.flash_attention_bhsd(
        q, k, v, causal=c["causal"], mask=_t(c["mask"], "float32"),
        dropout_rate=c["rate"], dropout_seed=SEED if c["rate"] else None)
    if grad:
        (o.float() * _t(c["w"], "float32")).sum().backward()
    return o, (q, k, v)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_lse_match_pallas(case):
    c = _inputs(case)
    jo, jlse = _jax_fwd(c)
    B, H, S, D = c["q"].shape
    meta = fa.Meta(H=H, Hk=c["Hk"], causal=c["causal"], scale=D ** -0.5,
                   rate=c["rate"], seed=SEED)
    mf = None
    if c["mask"] is not None:
        mf = _t(c["mask"], "float32")
        meta = fa.Meta(**{**meta.__dict__, "Bm": mf.shape[0]})
        mf = mf.reshape(-1, S, S)
    dt = c["dtype"]
    o, lse = fa.flash_fwd(_t(c["q"], dt).reshape(B * H, S, D),
                          _t(c["k"], dt).reshape(-1, S, D),
                          _t(c["v"], dt).reshape(-1, S, D), mf, meta)
    tol = BF16 if dt == "bfloat16" else F32_FWD
    np.testing.assert_allclose(_np(o).reshape(B, H, S, D), _np(jo),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=tol, rtol=tol)
    # the public entry point gives the same O
    po, _ = _port(c)
    np.testing.assert_array_equal(_np(po), _np(o).reshape(B, H, S, D))
    if c["mask"] is not None:
        assert np.all(_np(o).reshape(B, H, S, D)[:, :, 5] == 0)


@pytest.mark.parametrize("case", [n for n in CASES if n != "bf16"])
def test_grads_match_pallas(case):
    c = _inputs(case, seed=1)
    jg = _jax_grads(c)
    _, tg = _port(c, grad=True)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(_np(a.grad), _np(b), atol=F32_GRAD,
                                   rtol=F32_GRAD, err_msg=f"d{name}")


def test_bf16_grads_match_pallas():
    c = _inputs("bf16", seed=2)
    jg = _jax_grads(c)
    _, tg = _port(c, grad=True)
    for a, b, name in zip(tg, jg, "qkv"):
        assert a.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a.grad), _np(b), atol=BF16, rtol=BF16,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (-7, 0.5), (2 ** 31 - 1,
                                                              0.9)])
def test_dropout_keep_is_bit_identical(seed, rate):
    BH, S = 6, 96
    b = np.arange(BH, dtype=np.int32)[:, None, None]
    row = np.arange(S, dtype=np.int32)[None, :, None]
    col = np.arange(S, dtype=np.int32)[None, None, :]
    want = np.asarray(jpf._dropout_keep(jnp.int32(seed), jnp.asarray(b),
                                        jnp.asarray(row), jnp.asarray(col),
                                        rate))
    got = fa.dropout_keep(seed, torch.from_numpy(b), torch.from_numpy(row),
                          torch.from_numpy(col), rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("case", ["causal", "mask_b1ss", "dropout", "gqa"])
def test_plain_backward_equals_autograd_of_plain_forward(case):
    """dq_plain / dkv_plain (and the GQA sum) are the gradient of fwd_plain:
    torch.autograd through fwd_plain gives the same dQ, dK, dV."""
    c = _inputs(case, seed=3)
    if c["mask"] is not None:
        # scores near -1e9 lose the logsumexp to f32 spacing (64 there), in
        # the TPU kernels as here, so the recomputed P of that row is not
        # the forward's: the identity holds for rows of ordinary scores
        c["mask"][:, :, 70, :] = 0.0
    B, H, S, D = c["q"].shape
    Hk = c["Hk"]
    mf = None if c["mask"] is None else \
        _t(c["mask"], "float32").reshape(-1, S, S)
    meta = fa.Meta(H=H, Hk=Hk, Bm=1 if mf is None else mf.shape[0],
                   causal=c["causal"], scale=D ** -0.5, rate=c["rate"],
                   seed=SEED)
    q = _t(c["q"], "float32", True).reshape(B * H, S, D).detach() \
        .requires_grad_(True)
    k = _t(c["k"], "float32").reshape(B * Hk, S, D).requires_grad_(True)
    v = _t(c["v"], "float32").reshape(B * Hk, S, D).requires_grad_(True)
    w = _t(c["w"], "float32").reshape(B * H, S, D)
    o, _ = fa.fwd_plain(q, k, v, mf, meta)
    auto = torch.autograd.grad((o * w).sum(), (q, k, v))
    q2, k2, v2 = (x.detach().requires_grad_(True) for x in (q, k, v))
    (fa._Flash.apply(q2, k2, v2, mf, meta) * w).sum().backward()
    for a, b, name in zip((q2.grad, k2.grad, v2.grad), auto, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F32_GRAD,
                                   rtol=F32_GRAD, err_msg=f"d{name}")


def test_bshd_layout_and_reference_attention():
    """flash_attention_bshd is bhsd with the JAX layout swap, and the
    port's dense `reference_attention_bhsd` matches the JAX XLA path."""
    c = _inputs("mask_b1ss", seed=4)
    q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
    mask = torch.from_numpy(c["mask"])
    got = fa.flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), mask=mask)
    want = fa.flash_attention_bhsd(q, k, v, mask=mask)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want.numpy())
    ref = fa.reference_attention_bhsd(q, k, v, mask=mask)
    jref = _ref_attention_bhsd(*(jnp.asarray(c[n]) for n in "qkv"), False,
                               c["q"].shape[-1] ** -0.5,
                               jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=F32_FWD,
                               rtol=F32_FWD)
    # -inf mask entries give the same P in both (row 5, fully masked, is
    # NaN -> 0 in the dense path and l == 0 -> 0 in the kernels)
    np.testing.assert_allclose(ref.numpy(), want.numpy(), atol=F32_FWD,
                               rtol=F32_FWD)


@pytest.mark.parametrize("D,match", [(256, "head_dim 256 is not built"),
                                     (64, "unsupported device meta")])
def test_non_cpu_tensors_raise_before_any_launch(D, match):
    """A non-CPU tensor never takes the plain version: what the kernels do
    not take raises before the library is loaded or anything launches."""
    q = torch.empty((1, 2, 16, D), device="meta")
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bhsd(q, q, q, causal=True)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
    assert fa._lib is None


# name -> (B, H, Hk, S, causal, dtype), head_dim 64: S below one 128-row
# tile, one past it, and a ragged 200; one GQA case
EDGE_CASES = {
    f"S{S}_{'causal' if causal else 'full'}_{dt}": (1, 2, 2, S, causal, dt)
    for S in (64, 129, 200) for causal in (True, False)
    for dt in ("float32", "bfloat16")}
EDGE_CASES["gqa_4_2_S129_causal_float32"] = (1, 4, 2, 129, True, "float32")


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_shapes_match_xla_reference(case):
    """flash_attention_bhsd forward and autograd at ragged S against the
    JAX XLA path (inputs rounded to bf16 first in the bf16 cases, and the
    reference run in the same dtype)."""
    B, H, Hk, S, causal, dt = EDGE_CASES[case]
    D = 64
    rng = np.random.RandomState(5)
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, Hk, S, D).astype(np.float32)
    v = rng.randn(B, Hk, S, D).astype(np.float32)
    w = rng.randn(B, H, S, D).astype(np.float32)
    if dt == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    jo, vjp = jax.vjp(
        lambda a, b, c: _ref_attention_bhsd(a, b, c, causal, D ** -0.5),
        _j(q, dt), _j(k, dt), _j(v, dt))
    jg = vjp(_j(w, dt))
    tq, tk, tv = (_t(x, dt, grad=True) for x in (q, k, v))
    o = fa.flash_attention_bhsd(tq, tk, tv, causal=causal)
    assert o.dtype == tq.dtype and o.shape == (B, H, S, D)
    (o.float() * _t(w, "float32")).sum().backward()
    fwd, grad = (BF16, BF16) if dt == "bfloat16" else (F32_FWD, F32_GRAD)
    np.testing.assert_allclose(_np(o), _np(jo), atol=fwd, rtol=fwd)
    for a, b, name in zip((tq, tk, tv), jg, "qkv"):
        assert a.grad.dtype == a.dtype
        np.testing.assert_allclose(_np(a.grad), _np(b), atol=grad,
                                   rtol=grad, err_msg=f"d{name}")
