"""The port's multi-device training step without a pipeline (dp, ZeRO-2
sharding, mp, sp ring and ulysses, the clip, fused CE's vocab-parallel
mode) against the JAX package's, on the CPU.

The JAX `make_train_step` runs on the 8 virtual CPU devices at
`tests/test_parallel_spmd.py`'s tiny config (vocab 128, hidden 64, 4
layers, 4 heads, ffn 128, B=8, S=32), lr 1e-3 (ROADMAP C.2). The port
drives every rank from one process on the CPU. Two plans run in both
packages from the same JAX-initialised weights and state (direct parity:
losses at the JAX suite's hybrid rtol 5e-4, the gathered parameters and
the sharded m / v / master at atol 1e-5); every other plan of
`test_parallel_spmd.py` is held to the JAX single-device golden (losses at
its rtols, parameters at atol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jfused_ce
from paddle_tpu.parallel.ring_attention import \
    ring_attention as jring_attention
from paddle_tpu.parallel.ring_attention import \
    ulysses_attention as julysses_attention
from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.parallel import (GPTSpmdConfig, gather_opt_state,
                                       make_train_step)
from paddle_tpu_torch.parallel.ring_attention import (ring_attention,
                                                      ring_attention_bshd,
                                                      ulysses_attention)
from torch_spmd_common import one_torch_thread  # noqa: F401
from torch_spmd_common import (CFG, HYBRID_RTOL, LOSS_RTOL, MeshPlan,
                               assert_direct, assert_golden,
                               count_flash_calls, jax_run, logical_state,
                               port_run)

DIRECT = {
    "sharding2_mp2_sp2": MeshPlan(sharding=2, mp=2, sp=2),
    "ulysses_dp2_sp2_mp2": MeshPlan(dp=2, sp=2, mp=2, sp_mode="ulysses"),
}


@pytest.fixture(scope="module")
def golden():
    return jax_run(MeshPlan())


@pytest.fixture(scope="module", params=sorted(DIRECT))
def direct(request):
    plan = DIRECT[request.param]
    return plan, jax_run(plan)


def test_direct_parity_with_jax(direct):
    plan, ref = direct
    assert_direct(ref, port_run(plan, ref[0], ref[1]), plan, HYBRID_RTOL)


@pytest.mark.parametrize("plan", [
    MeshPlan(dp=4), MeshPlan(sharding=4), MeshPlan(mp=4), MeshPlan(sp=4),
    MeshPlan(sp=4, sp_mode="ulysses"), MeshPlan(dp=2, sharding=2, mp=2)],
    ids=["dp4", "sharding4", "mp4", "sp4_ring", "sp4_ulysses",
         "dp2_sharding2_mp2"])
def test_plan_matches_golden(golden, plan):
    assert_golden(golden, port_run(plan, golden[0]), plan, LOSS_RTOL)


def test_hybrid_sharding_mp_matches_golden(golden):
    plan = DIRECT["sharding2_mp2_sp2"]
    assert_golden(golden, port_run(plan, golden[0]), plan, HYBRID_RTOL)


def test_zero2_state_is_one_shard_a_rank(golden):
    """sharding=4: each rank's m / v / master hold ceil(size / 4) floats
    (the pad on the last rank of a leaf whose size does not divide), and
    the all-gathered parameters are the same on every rank."""
    plan = MeshPlan(sharding=4)
    cfg = dict(CFG, hidden=34, heads=2, ffn=68)
    ref = jax_run(MeshPlan(), cfg=cfg)
    losses, params, state, _ = port_run(plan, ref[0], cfg=cfg)
    np.testing.assert_allclose(losses, ref[2], rtol=LOSS_RTOL)
    for name, pieces in params.items():
        size = pieces[0].numel()
        for st in state[name]:
            assert st["m"].numel() == -(-size // 4)
        for p in pieces[1:]:
            assert torch.equal(p, pieces[0]), name
    assert params["lnf_w"][0].numel() % 4     # a padded leaf took part


def test_mp4_gradients_equal_single_device(golden):
    """The double-count guard: with no clip, the first Adam step's m is
    0.1 * g, so mp=4's gathered m (in the logical layout) must be the
    single device's gradient, not 4x it or a quarter of it."""
    single = port_run(MeshPlan(), golden[0], grad_clip=0.0, steps=1)
    plan = MeshPlan(mp=4)
    got = port_run(plan, golden[0], grad_clip=0.0, steps=1)
    gs = gather_opt_state(got[2], plan)
    for name, pieces in got[1].items():
        want = single[2][name]["m"].numpy().reshape(golden[0][name].shape)
        have = logical_state(gs[name]["m"], name, tuple(pieces[0].shape),
                             plan)
        scale = float(np.abs(want).max())
        assert float(np.abs(have - want).max()) <= 1e-4 * scale, name


def test_grad_clip_active_under_mp_matches_jax_golden():
    """A clip far below the gradient norm: the global norm must count a
    leaf replicated over mp once, or the scale (and every update)
    differs."""
    ref = jax_run(MeshPlan(), grad_clip=1e-3)
    plan = MeshPlan(mp=2, dp=2)
    got = port_run(plan, ref[0], grad_clip=1e-3)
    assert_golden(ref, got, plan, LOSS_RTOL)
    unclipped = port_run(plan, ref[0], grad_clip=0.0)
    assert unclipped[0][1:] != got[0][1:]


def test_fused_ce_vocab_parallel_step_matches_golden():
    """fused_ce_chunks=4 under mp=2 (a local shard of 64 rows)."""
    cfg = dict(CFG, fused_ce_chunks=4)
    ref = jax_run(MeshPlan(), cfg=cfg)
    plan = MeshPlan(mp=2)
    assert_golden(ref, port_run(plan, ref[0], cfg=cfg), plan, LOSS_RTOL,
                  cfg=cfg)


@pytest.mark.parametrize("nc", [1, 4])
def test_fused_ce_vocab_parallel_matches_jax_op(nc):
    """The vocab-parallel op against the JAX op with axis_name under
    shard_map over mp=4: the full loss on every rank, each rank's partial
    dh and its dwte rows."""
    T, H, V, n = 64, 32, 128, 4
    rng = np.random.RandomState(nc)
    h = rng.randn(T, H).astype(np.float32)
    w = (rng.randn(V, H) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, T)
    g = rng.rand(T).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("mp",))

    def local(h, w, lab, g):
        nll, vjp = jax.vjp(lambda h, w: jfused_ce(h, w, lab, nc, "mp"), h, w)
        dh, dw = vjp(g)
        return nll[None], dh[None], dw
    jl, jdh, jdw = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P("mp", None), P(), P()),
        out_specs=(P("mp"), P("mp"), P("mp", None)), check_vma=False))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), jnp.asarray(g))
    hs = [torch.from_numpy(h).requires_grad_(True) for _ in range(n)]
    ws = [torch.from_numpy(w[i * V // n:(i + 1) * V // n].copy())
          .requires_grad_(True) for i in range(n)]
    lab = [torch.from_numpy(labels)] * n
    out = fused_linear_cross_entropy(hs, ws, lab, nc)
    sum((o * torch.from_numpy(g)).sum() for o in out).backward()
    for i in range(n):
        np.testing.assert_allclose(out[i].detach().numpy(),
                                   np.asarray(jl)[i], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hs[i].grad.numpy(), np.asarray(jdh)[i],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            ws[i].grad.numpy(), np.asarray(jdw)[i * V // n:(i + 1) * V // n],
            rtol=1e-4, atol=1e-5)


def _sp_inputs(H, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, H, 32, 16).astype(np.float32) for _ in range(4)]


def _jax_sp(fn, q, k, v, g):
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    spec = P(None, None, "sp", None)

    def local(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, "sp", causal=True),
                           q, k, v)
        return (out,) + vjp(g)
    return [np.asarray(x) for x in jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 4,
        check_vma=False))(*map(jnp.asarray, (q, k, v, g)))]


def _port_sp(fn, q, k, v, g):
    ts = [[torch.from_numpy(c.copy()).requires_grad_(True)
           for c in np.split(x, 4, axis=2)] for x in (q, k, v)]
    out = fn(*ts, causal=True)
    gs = np.split(g, 4, axis=2)
    sum((o * torch.from_numpy(gc.copy())).sum()
        for o, gc in zip(out, gs)).backward()
    cat = lambda xs: np.concatenate(xs, axis=2)       # noqa: E731
    return [cat([o.detach().numpy() for o in out])] + \
        [cat([t.grad.numpy() for t in x]) for x in ts]


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_sp_attention_matches_jax(which):
    """ring_attention / ulysses_attention over 4 sequence shards against
    the JAX functions under shard_map: outputs and the gradients of q, k
    and v (ppermute's and all_to_all's transposes)."""
    H = 2 if which == "ring" else 4
    q, k, v, g = _sp_inputs(H, 0 if which == "ring" else 1)
    jfn = jring_attention if which == "ring" else julysses_attention
    pfn = ring_attention if which == "ring" else ulysses_attention
    for want, got in zip(_jax_sp(jfn, q, k, v, g), _port_sp(pfn, q, k, v,
                                                            g)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_ring_attention_bshd_and_ulysses_heads_check():
    q, k, v, _ = _sp_inputs(2, 3)
    qs = [torch.from_numpy(c.copy()) for c in np.split(q, 4, axis=2)]
    ks = [torch.from_numpy(c.copy()) for c in np.split(k, 4, axis=2)]
    vs = [torch.from_numpy(c.copy()) for c in np.split(v, 4, axis=2)]
    a = ring_attention(qs, ks, vs)
    b = ring_attention_bshd([x.transpose(1, 2) for x in qs],
                            [x.transpose(1, 2) for x in ks],
                            [x.transpose(1, 2) for x in vs])
    for x, y in zip(a, b):
        assert torch.equal(x, y.transpose(1, 2))
    with pytest.raises(ValueError, match="divisible by the sp axis"):
        ulysses_attention(qs, ks, vs)


def test_ring_route_launches_no_flash(golden, monkeypatch):
    """The sp ring is plain in the reference too: no flash call; the
    ulysses route calls the flash wrapper."""
    calls = count_flash_calls(monkeypatch)
    port_run(MeshPlan(sp=2), golden[0], steps=1)
    assert calls["fwd"] == 0
    port_run(MeshPlan(sp=2, sp_mode="ulysses"), golden[0], steps=1)
    assert calls["fwd"] == 2 * CFG["layers"]    # 2 sp ranks a layer


@pytest.mark.parametrize("remat", ["dots", "dots+attn", True])
def test_remat_policies_match_no_remat(golden, remat):
    """Remat changes the recompute schedule, never the values: every
    policy reproduces the no-remat step (rtol 1e-6, as the JAX suite's
    `test_remat_modes_match_golden`)."""
    base = port_run(MeshPlan(), golden[0])
    got = port_run(MeshPlan(), golden[0], cfg=dict(CFG, remat=remat))
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6)
    for name in base[1]:
        np.testing.assert_allclose(got[1][name].detach().numpy(),
                                   base[1][name].detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_dots_policy_saves_the_products():
    """"dots" recomputes the elementwise work of a block but no 2-D
    product: its backward runs fewer `mm` calls than full remat's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in (False, True, "dots"):
        cfg = GPTSpmdConfig(**dict(CFG, remat=remat))
        from paddle_tpu_torch.parallel.gpt_spmd import _loss
        from paddle_tpu_torch.ops.flash_attention import \
            flash_attention_bhsd
        step, init = make_train_step(cfg, device="cpu")
        params, _ = init(0)
        for p in params.values():
            p.requires_grad_(True)
        toks = torch.zeros((2, 16), dtype=torch.long)
        loss = _loss(params, toks, toks, cfg, flash_attention_bhsd)
        with Count() as c:
            loss.backward()
        counts[remat] = c.mm
    assert counts["dots"] == counts[False] < counts[True], counts
