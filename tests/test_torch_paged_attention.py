"""The port's paged-attention ops against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions (`serving.blocks.*`, and
the Pallas kernel `paged_attention` in interpret mode, as
`tests/test_paged_kernel.py` runs it) and their counterparts in
`paddle_tpu_torch`. On CPU tensors the port's kernel wrapper runs its plain
version, so these tests hold the plain version — the one the CUDA kernel is
held against on the card — to the reference. Tolerance: rtol = atol = 1e-5
in float32 (the online-softmax kernel sums in another order).

`attend_split_plain` models the split over the KV length of the decode
and window kernels (T = 1..WINDOW_ROWS) and their merge of the splits'
softmax states; it is held to the same references at the same tolerance,
so the merge rule is checked here and the kernels themselves against the
plain version on the card.

The kernels take head dims 32, 64 and 128 (the GPT family's); the `_d128`
tests run the same checks at 128 (gpt_1p3b's), and `_bf16` ones hold bf16
q and pools to the Pallas kernel (8 mantissa bits; the plain
version rounds its output to bf16 once, the kernel too) at 2e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from paddle_tpu.serving import blocks as jblk
from paddle_tpu_torch.ops.paged_attention import (WINDOW_ROWS,
                                                  attend_split_plain,
                                                  paged_attention)
from paddle_tpu_torch.serving import blocks as tblk

H, D = 4, 32          # the tiny GPT's heads and head_dim
TOL = dict(rtol=1e-5, atol=1e-5)


def _state(seed, S, bs, nb, N, poison=False, d=D):
    """Pools + tables where every slot's table is filled with distinct real
    blocks (the engine invariant: a visible position is backed)."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(N, bs, H, d).astype(np.float32)
    vp = rng.randn(N, bs, H, d).astype(np.float32)
    if poison:
        kp[jblk.GARBAGE_BLOCK] = np.nan
        vp[jblk.GARBAGE_BLOCK] = np.inf
    perm = rng.permutation(np.arange(1, N))
    tables = perm[:S * nb].reshape(S, nb).astype(np.int32)
    return kp, vp, tables


def _quant_state(seed, S, bs, nb, N, d=D):
    rng = np.random.RandomState(seed)
    kq = rng.randint(-127, 128, (N, bs, H, d)).astype(np.int8)
    vq = rng.randint(-127, 128, (N, bs, H, d)).astype(np.int8)
    ks = (rng.rand(N, H) * 3 + 0.1).astype(np.float32)
    vs = (rng.rand(N, H) * 3 + 0.1).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[:S * nb] \
        .reshape(S, nb).astype(np.int32)
    return kq, vq, ks, vs, tables


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _all_three(q, kp, vp, tables, pos, **scales):
    """(JAX gather oracle, JAX Pallas kernel in interpret mode, the port's
    wrapper on CPU tensors) for one input."""
    j = [jnp.asarray(x) for x in (q, kp, vp, tables, pos)]
    tj = {k: jnp.asarray(v) for k, v in scales.items()}
    if scales:
        want = jblk.attend_quant(j[0], j[1], j[2], tj["k_scale"],
                                 tj["v_scale"], j[3], j[4])
    else:
        want = jblk.attend(*j)
    pallas = jax_paged_attention(*j, interpret=True, **tj)
    port = paged_attention(*(_t(x) for x in (q, kp, vp, tables, pos)),
                           **{k: _t(v) for k, v in scales.items()})
    return np.asarray(want), np.asarray(pallas), port.numpy()


# ------------------------------------------------------------- float pools
@pytest.mark.parametrize("T,pos", [
    (1, [0, 7, 8, 9, 21, 46, 47]),     # block edges, edge-1, edge+1, last
    (2, [0, 5, 46]),
    (8, [0, 5, 40]),
    (16, [0, 9, 32]),                  # prefill windows over ragged slots
])
def test_attend_matches_jax_across_blocks(T, pos):
    _check_attend(T, pos, D)


def _check_attend(T, pos, d):
    bs, nb = 8, 6
    S = len(pos)
    kp, vp, tables = _state(T, S, bs, nb, N=S * nb + 1, d=d)
    q = np.random.RandomState(10 + T).randn(S, T, H, d).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want, pallas, port = _all_three(q, kp, vp, tables, pos)
    np.testing.assert_allclose(port, want, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(
        tblk.attend(*(_t(x) for x in (q, kp, vp, tables, pos))).numpy(),
        want, **TOL)


def test_poisoned_garbage_block_stays_finite():
    """Garbage block 0 holds NaN K and inf V; tables point at it past the
    owned blocks, as unallocated logical blocks do."""
    bs, nb, S = 8, 4, 2
    kp, vp, tables = _state(4, S, bs, nb, N=S * nb + 1, poison=True)
    tables[0, 2:] = jblk.GARBAGE_BLOCK
    tables[1, 1:] = jblk.GARBAGE_BLOCK
    q = np.random.RandomState(5).randn(S, 2, H, D).astype(np.float32)
    pos = np.asarray([13, 5], np.int32)     # writes stay in owned blocks
    want, pallas, port = _all_three(q, kp, vp, tables, pos)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, want, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)


def test_all_masked_rows_emit_zeros():
    """No visible key (pos = -1) over an all-NaN pool: exact zeros."""
    bs, nb = 8, 2
    _, _, tables = _state(6, 1, bs, nb, N=3)
    kp = np.full((3, bs, H, D), np.nan, np.float32)
    vp = np.full((3, bs, H, D), np.nan, np.float32)
    q = np.random.RandomState(7).randn(1, 1, H, D).astype(np.float32)
    pos = np.asarray([-1], np.int32)
    want, pallas, port = _all_three(q, kp, vp, tables, pos)
    assert (port == 0.0).all() and (want == 0.0).all()
    assert (pallas == 0.0).all()


# ------------------------------------------- decode split-and-merge rule
def _ragged_state(seed, pos, bs, nb, quant, T=1, d=D):
    """Each slot owns exactly the blocks its positions up to pos + T - 1
    need; every later table entry points at the garbage block 0, which
    holds NaN K and inf V (NaN and inf scales for int8 pools)."""
    rng = np.random.RandomState(seed)
    live = [max(0, min(nb, -(-(p + T) // bs))) for p in pos]
    N = 1 + sum(live)
    ids = iter(rng.permutation(np.arange(1, N)))
    tables = np.zeros((len(pos), nb), np.int32)
    for s, n in enumerate(live):
        tables[s, :n] = [next(ids) for _ in range(n)]
    if quant:
        kp = rng.randint(-127, 128, (N, bs, H, d)).astype(np.int8)
        vp = rng.randint(-127, 128, (N, bs, H, d)).astype(np.int8)
        ks = (rng.rand(N, H) * 3 + 0.1).astype(np.float32)
        vs = (rng.rand(N, H) * 3 + 0.1).astype(np.float32)
        ks[jblk.GARBAGE_BLOCK] = np.nan
        vs[jblk.GARBAGE_BLOCK] = np.inf
        return kp, vp, tables, dict(k_scale=ks, v_scale=vs)
    kp = rng.randn(N, bs, H, d).astype(np.float32)
    vp = rng.randn(N, bs, H, d).astype(np.float32)
    kp[jblk.GARBAGE_BLOCK] = np.nan
    vp[jblk.GARBAGE_BLOCK] = np.inf
    return kp, vp, tables, {}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("split,bs", [(16, 8), (64, 8), (128, 16)])
def test_split_merge_model_matches_jax(split, bs, quant):
    """Decode (T = 1) with the KV length cut into splits: positions on a
    split edge and one either side (key counts split - 1, split, split +
    1, 2 * split, 2 * split + 1), the full table, a pos = -1 slot beside
    the long ones, later splits wholly past a slot's last key, and the
    garbage block poisoned. Tolerance: f32 rtol = atol = 1e-5."""
    _check_split_merge(split, bs, quant, D)


def _check_split_merge(split, bs, quant, d):
    nb = (2 * split + 2 * bs) // bs
    pos = [split - 2, -1, split - 1, split, 2 * split - 1, 2 * split,
           nb * bs - 1]
    kp, vp, tables, scales = _ragged_state(split + quant, pos, bs, nb,
                                           quant, d=d)
    q = np.random.RandomState(split).randn(len(pos), 1, H, d) \
        .astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want, pallas, _ = _all_three(q, kp, vp, tables, pos, **scales)
    got = attend_split_plain(
        *(_t(x) for x in (q, kp, vp, tables, pos)), split,
        **{k: _t(v) for k, v in scales.items()}).numpy()
    assert np.isfinite(got).all()
    assert (got[1] == 0.0).all()            # pos = -1: exact zeros
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("split,bs", [(16, 8), (128, 16)])
@pytest.mark.parametrize("T", [2, 5, 16])
def test_window_split_merge_model_matches_jax(T, split, bs, quant):
    """Windows (T = 2..WINDOW_ROWS, the speculative verify windows) with
    the KV length cut into splits: windows that end on the last key of a
    split, that straddle the first and the second split edge and a block
    edge, one that ends on the table's last key, one at position 0, and a
    pos = -1 slot (its first row sees no key, the others the keys before
    them); the garbage block poisoned. Tolerance: f32 rtol = atol =
    1e-5."""
    _check_window_split_merge(T, split, bs, quant, D)


def _check_window_split_merge(T, split, bs, quant, d):
    nb = (2 * split + 2 * bs) // bs
    pos = [split - T, split - T + 1, -1, bs - 1, 2 * split - 2,
           nb * bs - T, 0]
    kp, vp, tables, scales = _ragged_state(T + split + quant, pos, bs, nb,
                                           quant, T=T, d=d)
    q = np.random.RandomState(T + split).randn(len(pos), T, H, d) \
        .astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want, pallas, port = _all_three(q, kp, vp, tables, pos, **scales)
    got = attend_split_plain(
        *(_t(x) for x in (q, kp, vp, tables, pos)), split,
        **{k: _t(v) for k, v in scales.items()}).numpy()
    assert got.shape == q.shape and np.isfinite(got).all()
    assert (got[2, 0] == 0.0).all()         # pos = -1: row 0 sees nothing
    assert (got[2, 1:] != 0.0).any()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(port, want, **TOL)


def test_split_merge_model_rejects_prefill_windows():
    """Calls of more than WINDOW_ROWS query tokens run the tile path,
    whose split the model does not describe, so the model refuses them
    rather than model code that does not exist."""
    kp, vp, tables, _ = _ragged_state(7, [30], 8, 4, False)
    q = torch.zeros((1, WINDOW_ROWS + 1, H, D))
    with pytest.raises(ValueError, match="decode and window kernels"):
        attend_split_plain(q, _t(kp), _t(vp), _t(tables),
                           torch.tensor([0], dtype=torch.int32), 16)
    assert attend_split_plain(q[:, :WINDOW_ROWS], _t(kp), _t(vp),
                              _t(tables), torch.tensor([0], dtype=torch.int32),
                              16).shape == (1, WINDOW_ROWS, H, D)


# -------------------------------------------------------------- int8 pools
@pytest.mark.parametrize("T,pos", [(1, [0, 8, 17, 47]), (8, [0, 3, 33])])
def test_attend_quant_matches_jax(T, pos):
    _check_attend_quant(T, pos, D)


def _check_attend_quant(T, pos, d):
    bs, nb = 8, 6
    S = len(pos)
    kq, vq, ks, vs, tables = _quant_state(20 + T, S, bs, nb, N=S * nb + 1,
                                          d=d)
    q = np.random.RandomState(30 + T).randn(S, T, H, d).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want, pallas, port = _all_three(q, kq, vq, tables, pos, k_scale=ks,
                                    v_scale=vs)
    np.testing.assert_allclose(port, want, **TOL)
    np.testing.assert_allclose(port, pallas, **TOL)


# ------------------------------------------- head dim 128 (gpt_1p3b's)
@pytest.mark.parametrize("T,pos", [
    (1, [0, 7, 8, 9, 21, 46, 47]),
    (5, [0, 5, 40]),
    (16, [0, 9, 32]),
    (24, [0, 3, 20]),                  # the tile path (T > WINDOW_ROWS)
])
def test_attend_matches_jax_d128(T, pos):
    """Float pools at head dim 128: decode, window and tile lengths."""
    _check_attend(T, pos, 128)


@pytest.mark.parametrize("T,pos", [(1, [0, 8, 17, 47]), (8, [0, 3, 33]),
                                   (20, [0, 27])])
def test_attend_quant_matches_jax_d128(T, pos):
    _check_attend_quant(T, pos, 128)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("split,bs", [(16, 8), (128, 16)])
def test_split_merge_model_matches_jax_d128(split, bs, quant):
    _check_split_merge(split, bs, quant, 128)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T", [2, 5, 16])
def test_window_split_merge_model_matches_jax_d128(T, quant):
    _check_window_split_merge(T, 16, 8, quant, 128)


# ------------------------------------------------------------ bf16 pools
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("T,pos", [(1, [0, 9, 46]), (5, [0, 40]),
                                   (20, [0, 27])])
def test_attend_bf16_matches_jax(T, pos, d):
    """bf16 q and pools (the kernel's mode 1) against the Pallas kernel on
    the same bf16 values: 2e-2 (the output is rounded to bf16, and the
    Pallas kernel rounds P to bf16 before P.V where the port's products
    stay in f32)."""
    bs, nb = 8, 6
    S = len(pos)
    kp, vp, tables = _state(60 + T, S, bs, nb, N=S * nb + 1, d=d)
    q = np.random.RandomState(70 + T).randn(S, T, H, d).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp))
    pallas = jax_paged_attention(jq, jk, jv, jnp.asarray(tables),
                                 jnp.asarray(pos), interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    port = paged_attention(tq, tk, tv, _t(tables), _t(pos))
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_dequant_and_quantize_expressions_match_jax():
    """`code * (scale / QMAX)` and the round/clip quantizer give the JAX
    package's values bit for bit."""
    rng = np.random.RandomState(3)
    codes = rng.randint(-127, 128, (5, 8, H, D)).astype(np.int8)
    scale = (rng.rand(5, H) * 2).astype(np.float32)
    np.testing.assert_array_equal(
        tblk.dequant(_t(codes), _t(scale)).numpy(),
        np.asarray(jblk.dequant(jnp.asarray(codes), jnp.asarray(scale))))
    x = rng.randn(5, 8, H, D).astype(np.float32) * 3
    sb = np.abs(x).max(axis=(1, 3))[:, None, :, None]
    np.testing.assert_array_equal(
        tblk.quantize_codes(_t(x), _t(sb)).numpy(),
        np.asarray(jblk.quantize_codes(jnp.asarray(x), jnp.asarray(sb))))


# ------------------------------------------------------------------ writes
@pytest.mark.parametrize("T,pos", [(1, [0, 7, 8, 40]), (12, [0, 5, 30, 44])])
def test_write_matches_jax(T, pos):
    """Scatter through the tables; positions past the table (a padded
    prefill tail) land in the garbage block, whose contents are not
    compared."""
    bs, nb, S = 8, 6, len(pos)
    kp, _, tables = _state(40 + T, S, bs, nb, N=S * nb + 1)
    new = np.random.RandomState(50 + T).randn(S, T, H, D).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jblk.write(jnp.asarray(kp), jnp.asarray(new),
                                 jnp.asarray(tables), jnp.asarray(pos)))
    pool = _t(kp.copy())
    got = tblk.write(pool, _t(new), _t(tables), _t(pos))
    assert got is pool                      # in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


@pytest.mark.parametrize("T,pos,valid", [
    (1, [0, 7, 8, 15], None),               # decode: one block per slot
    (8, [0, 3, 16, 21], [8, 5, 1, 8]),      # bucket-padded prefill
])
def test_quant_write_matches_jax(T, pos, valid):
    bs, nb, S = 8, 6, len(pos)
    kq, _, ks, _, tables = _quant_state(60 + T, S, bs, nb, N=S * nb + 1)
    new = np.random.RandomState(70 + T).randn(S, T, H, D).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    wq, ws = jblk.quant_write(jnp.asarray(kq), jnp.asarray(ks),
                              jnp.asarray(new), jnp.asarray(tables),
                              jnp.asarray(pos), jv)
    tv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    gq, gs = tblk.quant_write(_t(kq.copy()), _t(ks.copy()), _t(new),
                              _t(tables), _t(pos), tv)
    np.testing.assert_array_equal(gq.numpy()[1:], np.asarray(wq)[1:])
    np.testing.assert_allclose(gs.numpy()[1:], np.asarray(ws)[1:],
                               rtol=0, atol=0)


# ------------------------------------------------------------------ guards
def test_wrapper_rejects_bad_scale_combinations():
    bs, nb = 8, 2
    kq, vq, ks, vs, tables = _quant_state(80, 1, bs, nb, N=3)
    q = _t(np.zeros((1, 1, H, D), np.float32))
    tb, pos = _t(tables), torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 pools need"):
        paged_attention(q, _t(kq), _t(vq), tb, pos)
    with pytest.raises(ValueError, match="BOTH"):
        paged_attention(q, _t(kq), _t(vq), tb, pos, k_scale=_t(ks))
    kp = _t(np.zeros((3, bs, H, D), np.float32))
    with pytest.raises(ValueError, match="want int8"):
        paged_attention(q, kp, kp, tb, pos, k_scale=_t(ks), v_scale=_t(vs))


def test_wrapper_counts_no_launch_on_cpu():
    """CPU tensors take the plain version; only kernel launches count."""
    from paddle_tpu_torch.ops import paged_attention as pa
    kp, vp, tables = _state(90, 1, 8, 2, N=3)
    before = (pa.launches, pa.launches_window, pa.launches_prefill)
    for T in (1, 5, WINDOW_ROWS + 1):
        paged_attention(_t(np.ones((1, T, H, D), np.float32)), _t(kp),
                        _t(vp), _t(tables),
                        torch.tensor([-1], dtype=torch.int32))
    assert (pa.launches, pa.launches_window, pa.launches_prefill) == before


def test_attention_impl_scope():
    assert tblk.current_attention_impl() == "gather"
    with tblk.attention_impl("kernel"):
        assert tblk.current_attention_impl() == "kernel"
    assert tblk.current_attention_impl() == "gather"
    with pytest.raises(ValueError, match="unknown"):
        with tblk.attention_impl("fused"):
            pass


def test_block_pool_refcounts_and_garbage_block():
    pool = tblk.BlockPool(4, 8)
    assert pool.capacity == 3
    a = pool.alloc(2)
    assert tblk.GARBAGE_BLOCK not in a
    pool.ref(a[0])
    pool.unref(a[0])
    assert pool.refcount(a[0]) == 1
    with pytest.raises(tblk.BlockAllocError):
        pool.alloc(2)
    pool.unref(a[0])
    pool.unref(a[1])
    assert pool.available == 3
    pool.unref(tblk.GARBAGE_BLOCK)          # a no-op, never freed
    with pytest.raises(ValueError):
        pool.unref(a[0])
