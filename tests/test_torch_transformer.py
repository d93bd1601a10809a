"""`F.scaled_dot_product_attention`, `MultiHeadAttention` and the
transformer Layers of the port against the JAX package's, on the CPU.

The attention runs on two routes in each package (ROADMAP C.15):
  * the kernel route: the port's `flash_attention_bhsd`, on CPU tensors
    its kernels' plain versions, against the Pallas kernels in interpret
    mode (`paddle_tpu.ops.pallas.flash_attention.flash_attention`, block
    64 over S=128). The JAX side takes that route when `_use_pallas` says
    so on its accelerator; here its rule is applied without the backend
    check, and its key-padding mask is broadcast to (B, 1, S, S) before
    the call, as the port's route does;
  * the plain route: `reference_attention_bhsd` against the JAX package
    as it runs on the CPU (`_ref_attention_bhsd`).
At S=128 and D=64 the reference's own TPU rule picks the kernel. Both
routes are held with a key-padding mask that masks every key of one batch
row (the kernel zeroes those rows; the plain route, with float32's finite
minimum, gives the mean of V) and with dropout under one fixed seed (the
keep mask is the TPU kernel's hash, bit for bit).

Tolerances: float32 2e-5 forward and 1e-4 gradients on the kernel route
(the kernels sum in blocks), 1e-5 / 1e-4 on the plain route.
"""
import importlib

import numpy as np
import pytest
import torch

SEED = 4321
B, S, H, D = 2, 128, 2, 64
FWD, GRAD = 2e-5, 1e-4


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _jax_kernel_route(monkeypatch):
    """Send the JAX package's attention to its Pallas kernels (interpret
    mode) by its own shape rule, the mask broadcast to (Bm, Hm, S, S)."""
    import jax.numpy as jnp
    from paddle_tpu.ops import flash_attention as jfa
    jpf = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

    def use(q, k):
        Sq, Dq = q.shape[2], q.shape[3]
        return Sq == k.shape[2] and Sq % 128 == 0 and Dq in (64, 128, 256)

    def pallas(q, k, v, causal, scale, mask=None, dropout_rate=0.0,
               dropout_seed=None):
        if mask is not None:
            while mask.ndim < 4:
                mask = mask[None]
            Bq, Hq, Sq = q.shape[0], q.shape[1], q.shape[2]
            mask = jnp.broadcast_to(mask, (
                Bq if mask.shape[0] == Bq else 1,
                Hq if mask.shape[1] == Hq else 1, Sq, Sq))
        return jpf.flash_attention(q, k, v, mask=mask, causal=causal,
                                   sm_scale=scale, dropout_rate=dropout_rate,
                                   dropout_seed=dropout_seed, block_q=64,
                                   block_k=64, interpret=True)
    monkeypatch.setattr(jfa, "_use_pallas", use)
    monkeypatch.setattr(jfa, "_pallas_flash_bhsd", pallas)


def _fixed_seeds(monkeypatch):
    """Both packages draw SEED for the dropout hash."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu_torch.nn.functional import attention as ta
    monkeypatch.setattr(ta, "_dropout_seed", lambda: SEED)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(SEED, jnp.int32))


def _uncached_jax(monkeypatch):
    """Trace every JAX op afresh: its eager op cache keys an op by code and
    shapes, so an executable traced on one route would serve the other."""
    from paddle_tpu.core import tensor as jax_tensor
    monkeypatch.setattr(jax_tensor, "eager_op_cache_enabled", False)


def _port_kernel_route(monkeypatch):
    from paddle_tpu_torch.nn.functional import attention as ta
    monkeypatch.setattr(ta, "sdpa_route", lambda *a: "kernel")


def _keypad(dead_row=1):
    """[B, 1, 1, S] bool key padding: batch row 0 hides its last 16 keys,
    batch row `dead_row` hides every key."""
    m = np.ones((B, 1, 1, S), bool)
    m[0, ..., -16:] = False
    m[dead_row] = False
    return m


def _additive(m):
    return np.where(m, 0.0, np.finfo(np.float32).min).astype(np.float32)


def _sdpa(P, arrays, mask, causal, rate):
    q, k, v, w = (P.to_tensor(a, stop_gradient=i == 3)
                  for i, a in enumerate(arrays))
    m = None if mask is None else P.to_tensor(mask)
    o = P.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m, dropout_p=rate, is_causal=causal)
    (o * w).sum().backward()
    return o.numpy(), [t.grad.numpy() for t in (q, k, v)]


_SDPA = {
    "plain": (None, False, 0.0),
    "causal": (None, True, 0.0),
    "keypad_dead_row": ("keypad", False, 0.0),
    "dropout": (None, True, 0.1),
    "keypad_dropout": ("keypad", False, 0.1),
}


# interpret mode is slow: the kernel route takes three of the five cases
_ROUTE_CASES = [("plain", n) for n in _SDPA] + [
    ("kernel", n) for n in ("plain", "keypad_dead_row", "dropout")]


@pytest.mark.parametrize("route,name", _ROUTE_CASES,
                         ids=[f"{r}-{n}" for r, n in _ROUTE_CASES])
def test_sdpa_routes_match_jax(cpu, monkeypatch, route, name):
    import paddle_tpu as pj
    pt = cpu
    mask_kind, causal, rate = _SDPA[name]
    _uncached_jax(monkeypatch)
    _fixed_seeds(monkeypatch)
    if route == "kernel":
        _jax_kernel_route(monkeypatch)
        _port_kernel_route(monkeypatch)
    rng = np.random.RandomState(3)
    arrays = [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]
    mask = None if mask_kind is None else _additive(_keypad())
    from paddle_tpu_torch.nn.functional import attention as ta
    before = dict(ta.sdpa_routes)
    want, wg = _sdpa(pj, arrays, mask, causal, rate)
    got, gg = _sdpa(pt, arrays, mask, causal, rate)
    counted = {k: ta.sdpa_routes[k] - before[k] for k in before}
    if route == "plain":
        assert counted == {"kernel": 0, "plain": 1}
    fwd, grad = (FWD, GRAD) if route == "kernel" else (1e-5, 1e-4)
    np.testing.assert_allclose(got, want, rtol=fwd, atol=fwd)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g, w, rtol=grad, atol=grad)
    if mask_kind == "keypad" and rate == 0:
        dead = got[1]                                  # every key hidden
        if route == "kernel":
            assert not dead.any()                      # exact zeros
        else:                                          # the mean of V
            np.testing.assert_allclose(
                dead, np.broadcast_to(arrays[2][1].mean(0), dead.shape),
                rtol=1e-5, atol=1e-5)


def test_dropout_keep_mask_is_the_tpu_hash(cpu):
    """The port's keep mask at the SDPA shape, bit for bit the Pallas
    kernel's `_dropout_keep`."""
    import jax.numpy as jnp
    from paddle_tpu_torch.ops import flash_attention as fa
    jpf = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    row = np.arange(S)[:, None]
    col = np.arange(S)[None, :]
    b = np.arange(B * H).reshape(B * H, 1, 1)
    want = np.asarray(jpf._dropout_keep(jnp.int32(SEED), jnp.asarray(b,
                                                                 jnp.int32),
                                        jnp.asarray(row, jnp.int32),
                                        jnp.asarray(col, jnp.int32), 0.1))
    got = fa.dropout_keep(SEED, torch.as_tensor(b), torch.as_tensor(row),
                          torch.as_tensor(col), 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95


# the reference's `_use_pallas` rule on CUDA: head dims 64, 128 and 256 in
# any float dtype take the kernel route, and the kernels are built for
# every input the rule sends them (head dim 256 and float16 since ROADMAP
# B.4's repair); other head dims take the dense attention
@pytest.mark.parametrize("q,k,dtype,device,want", [
    ((2, 128, 12, 64), (2, 128, 12, 64), "float32", "cuda", "kernel"),
    ((2, 512, 12, 64), (2, 512, 4, 64), "bfloat16", "cuda", "kernel"),
    ((2, 256, 8, 128), (2, 256, 8, 128), "bfloat16", "cuda", "kernel"),
    ((2, 128, 12, 64), (2, 128, 12, 64), "float32", "cpu", "plain"),
    ((2, 1, 12, 64), (2, 9, 12, 64), "float32", "cuda", "plain"),
    ((2, 128, 12, 64), (2, 256, 12, 64), "float32", "cuda", "plain"),
    ((2, 200, 12, 64), (2, 200, 12, 64), "float32", "cuda", "plain"),
    ((2, 128, 4, 256), (2, 128, 4, 256), "bfloat16", "cuda", "kernel"),
    ((2, 128, 12, 64), (2, 128, 12, 64), "float16", "cuda", "kernel"),
    ((2, 128, 12, 32), (2, 128, 12, 32), "float32", "cuda", "plain"),
], ids=["f32", "bf16_gqa", "d128", "cpu", "decode_cache", "cross_length",
        "ragged_S", "d256", "fp16", "d32"])
def test_sdpa_route_rule(q, k, dtype, device, want):
    from paddle_tpu_torch.nn.functional.attention import sdpa_route
    from paddle_tpu_torch.ops import flash_attention as fa
    assert sdpa_route(q, k, device) == want
    if q[3] not in fa.SUPPORTED_HEAD_DIMS:
        t = torch.zeros((1, 1, 1, q[3]), dtype=getattr(torch, dtype))
        with pytest.raises(ValueError, match="not built"):
            fa._check_kernel_args("fwd", t, t, t, None, ())
    if want == "kernel":
        # a kernel is built for what the route sends it
        assert q[3] in fa.SUPPORTED_HEAD_DIMS
        assert getattr(torch, dtype) in fa._DTYPES


def test_kernel_mask_broadcasts_without_a_copy_per_head():
    from paddle_tpu_torch.ops.flash_attention import _flatten_mask
    kp = torch.zeros((B, 1, 1, S))
    m, Bm, Hm = _flatten_mask(kp, B, 12, S)
    assert (Bm, Hm) == (B, 1) and tuple(m.shape) == (B, S, S)
    causal = torch.zeros((S, S))
    m, Bm, Hm = _flatten_mask(causal, B, 12, S)
    assert (Bm, Hm) == (1, 1) and tuple(m.shape) == (1, S, S)
    full = torch.randn((B, 12, S, S))
    m, Bm, Hm = _flatten_mask(full, B, 12, S)
    assert (Bm, Hm) == (B, 12) and torch.equal(m, full.reshape(-1, S, S))
    keys = torch.randn((B, 1, 1, S))
    m, _, _ = _flatten_mask(keys, B, 12, S)
    assert torch.equal(m, keys.reshape(B, 1, S).expand(B, S, S))
    with pytest.raises(ValueError, match="does not broadcast"):
        _flatten_mask(torch.zeros((B, 1, 1, S + 1)), B, 12, S)


def test_sdpa_draws_one_host_seed_per_call(cpu, monkeypatch):
    pt = cpu
    from paddle_tpu_torch.nn.functional import attention as ta
    calls = []
    monkeypatch.setattr(ta, "_dropout_seed",
                        lambda: calls.append(1) or 7)
    x = pt.to_tensor(np.ones((1, 4, 2, 8), np.float32))
    pt.nn.functional.scaled_dot_product_attention(x, x, x, dropout_p=0.5)
    pt.nn.functional.scaled_dot_product_attention(x, x, x, dropout_p=0.5,
                                                  training=False)
    pt.nn.functional.scaled_dot_product_attention(x, x, x)
    assert calls == [1]


# ------------------------------------------------------ MultiHeadAttention

def _carry(jl, tl):
    assert [(k, tuple(v.shape)) for k, v in tl.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in jl.state_dict().items()]
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})


def _mha_run(P, layer, x, mask, w):
    xt = P.to_tensor(x, stop_gradient=False)
    out = layer(xt, attn_mask=None if mask is None else P.to_tensor(mask))
    (out * P.to_tensor(w)).sum().backward()
    return (out.numpy(), xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_mha_keypad_dropout_matches_jax(cpu, monkeypatch, route):
    import paddle_tpu as pj
    pt = cpu
    _uncached_jax(monkeypatch)
    _fixed_seeds(monkeypatch)
    if route == "kernel":
        _jax_kernel_route(monkeypatch)
        _port_kernel_route(monkeypatch)
    E = H * D
    jl = pj.nn.MultiHeadAttention(E, H, dropout=0.1)
    tl = pt.nn.MultiHeadAttention(E, H, dropout=0.1)
    _carry(jl, tl)
    rng = np.random.RandomState(9)
    x = rng.randn(B, S, E).astype(np.float32)
    w = rng.randn(B, S, E).astype(np.float32)
    mask = _keypad()
    want = _mha_run(pj, jl, x, mask, w)
    got = _mha_run(pt, tl, x, mask, w)
    tol = (FWD, GRAD) if route == "kernel" else (1e-5, 1e-4)
    np.testing.assert_allclose(got[0], want[0], rtol=tol[1], atol=tol[1])
    np.testing.assert_allclose(got[1], want[1], rtol=tol[1], atol=tol[1])
    for n in got[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], rtol=tol[1],
                                   atol=tol[1], err_msg=n)


# ------------------------------------------------- small transformer layers

E_S, H_S, FF_S, S_S = 16, 2, 32, 6


def _small(P, kind, pre):
    if kind == "encoder_layer":
        return P.nn.TransformerEncoderLayer(E_S, H_S, FF_S, dropout=0.0,
                                            activation="gelu",
                                            normalize_before=pre)
    if kind == "encoder":
        layer = P.nn.TransformerEncoderLayer(E_S, H_S, FF_S, dropout=0.0,
                                             normalize_before=pre)
        return P.nn.TransformerEncoder(layer, 2, P.nn.LayerNorm(E_S))
    if kind == "decoder_layer":
        return P.nn.TransformerDecoderLayer(E_S, H_S, FF_S, dropout=0.0,
                                            normalize_before=pre)
    if kind == "decoder":
        layer = P.nn.TransformerDecoderLayer(E_S, H_S, FF_S, dropout=0.0,
                                             normalize_before=pre)
        return P.nn.TransformerDecoder(layer, 2)
    return P.nn.Transformer(E_S, H_S, 1, 1, FF_S, dropout=0.0,
                            normalize_before=pre)


def _small_run(P, layer, kind, arrays):
    src, tgt, w = arrays
    s = P.to_tensor(src, stop_gradient=False)
    t = P.to_tensor(tgt, stop_gradient=False)
    causal = P.nn.Transformer.generate_square_subsequent_mask(S_S)
    if kind.startswith("encoder"):
        out, ins = layer(s, causal), [s]
    elif kind.startswith("decoder"):
        out, ins = layer(t, s, causal), [s, t]
    else:
        out, ins = layer(s, t, tgt_mask=causal), [s, t]
    (out * P.to_tensor(w)).sum().backward()
    return (out.numpy(), [i.grad.numpy() for i in ins],
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
@pytest.mark.parametrize("kind", ["encoder_layer", "encoder",
                                  "decoder_layer", "decoder",
                                  "transformer"])
def test_transformer_layers_match_jax(cpu, kind, pre):
    import paddle_tpu as pj
    pt = cpu
    jl, tl = _small(pj, kind, pre), _small(pt, kind, pre)
    _carry(jl, tl)
    rng = np.random.RandomState(11)
    arrays = [rng.randn(2, S_S, E_S).astype(np.float32) for _ in range(3)]
    want = _small_run(pj, jl, kind, arrays)
    got = _small_run(pt, tl, kind, arrays)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert list(got[2]) == list(want[2])
    for n in got[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_square_subsequent_mask_matches_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    np.testing.assert_array_equal(
        pt.nn.Transformer.generate_square_subsequent_mask(5).numpy(),
        pj.nn.Transformer.generate_square_subsequent_mask(5).numpy())


def _decode(P, layer, x, how):
    """Three one-token steps through a cache after a 3-token prompt."""
    outs = []
    xs = [P.to_tensor(x[:, :3])] + [P.to_tensor(x[:, i:i + 1])
                                   for i in range(3, 6)]
    if how == "cache":
        cache = layer.gen_cache(xs[0])
        for t in xs:
            out, cache = layer(t, t, t, None, cache)
            outs.append(out.numpy())
    elif how == "static_cache":
        mem = P.to_tensor(x[:, ::-1].copy())
        cache = layer.gen_cache(mem, mem, type=layer.StaticCache)
        for t in xs:
            out, cache = layer(t, mem, mem, None, cache)
            outs.append(out.numpy())
    else:
        cache = layer.gen_static_decode_cache(2, 8)
        for t in xs:
            out, cache = layer(t, cache=cache)
            outs.append(out.numpy())
        outs.append(cache.pos.numpy())
    return outs


@pytest.mark.parametrize("how", ["cache", "static_cache",
                                 "static_decode_cache"])
def test_mha_decode_caches_match_jax(cpu, how):
    import paddle_tpu as pj
    pt = cpu
    jl, tl = pj.nn.MultiHeadAttention(E_S, H_S), \
        pt.nn.MultiHeadAttention(E_S, H_S)
    _carry(jl, tl)
    jl.eval()
    tl.eval()
    x = np.random.RandomState(2).randn(2, 6, E_S).astype(np.float32)
    want = _decode(pj, jl, x, how)
    got = _decode(pt, tl, x, how)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # a growing cache's keys outgrow the queries: SDPA's plain route
    from paddle_tpu_torch.nn.functional.attention import sdpa_route
    assert sdpa_route((2, 1, H_S, 64), (2, 4, H_S, 64), "cuda") == "plain"
