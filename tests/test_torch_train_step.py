"""The port's single-device GPT training step against the JAX package's, on
the CPU.

`paddle_tpu.parallel.make_train_step` under `MeshPlan()` at
`tests/test_parallel_spmd.py`'s tiny config (vocab 128, hidden 64, 4
layers, 4 heads, ffn 128, B=8, S=32) is the reference. Its initial
parameters and AdamW state are carried into the port with
`params_from_jax` / `opt_state_from_jax`, both take the same numpy batches
for 3 steps, and the losses, parameters and optimizer state must agree.
The port runs with `device="cpu"`: its attention wrappers take their plain
versions, and JAX's attention on the CPU is its XLA path.

Tolerances (float32): losses rtol 2e-4 (as the JAX package's own
strategy-vs-golden tests), parameters and m / v / master atol 1e-5 (XLA
and PyTorch sum in different orders). Fused CE: the JAX op's contract,
rtol = atol = 1e-5 for the loss, 1e-4 / 1e-5 for gradients, 0.05 / 0.02
in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jfused_ce
from paddle_tpu.parallel import GPTSpmdConfig as JConfig
from paddle_tpu.parallel import MeshPlan as JPlan
from paddle_tpu.parallel import make_forward_fn as jmake_forward_fn
from paddle_tpu.parallel import make_train_step as jmake_train_step
from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.parallel import (GPTSpmdConfig, MeshPlan,
                                       make_forward_fn, make_train_step,
                                       opt_state_from_jax, params_from_jax)

CFG = dict(vocab_size=128, max_seq_len=64, hidden=64, layers=4, heads=4,
           ffn=128, remat=False)
# lr 1e-3, not the 1e-2 of test_parallel_spmd.py: the key bias gets a
# gradient that is zero in exact arithmetic (a per-row constant under the
# softmax), and Adam turns its rounding noise into updates of up to ~1e-2
# of lr, different in the two frameworks
B, S, STEPS, LR = 8, 32, 3, 1e-3
LOSS_RTOL, ATOL = 2e-4, 1e-5


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, CFG["vocab_size"], (B, S)),
             rng.randint(0, CFG["vocab_size"], (B, S)))
            for _ in range(STEPS)]


def _jax_run(grad_clip=1.0, **over):
    """(initial params, initial state, losses, final params, final state),
    all numpy, from the JAX step."""
    cfg = JConfig(**{**CFG, **over})
    step_fn, init_fn, _ = jmake_train_step(cfg, JPlan(), learning_rate=LR,
                                           grad_clip=grad_clip)
    params, state = init_fn(jax.random.key(0))
    as_np = jax.tree_util.tree_map
    p0, s0 = as_np(np.asarray, params), as_np(np.asarray, state)
    losses = []
    for toks, labs in _batches():
        loss, params, state = step_fn(params, state, jnp.asarray(toks),
                                      jnp.asarray(labs), jnp.float32(LR))
        losses.append(float(loss))
    return p0, s0, losses, as_np(np.asarray, params), as_np(np.asarray,
                                                           state)


def _port_run(ref, grad_clip=1.0, attention="kernel", **over):
    cfg = GPTSpmdConfig(**{**CFG, **over})
    p0, s0 = ref[0], ref[1]
    step_fn, _ = make_train_step(cfg, learning_rate=LR, grad_clip=grad_clip,
                                 device="cpu", attention=attention)
    params = params_from_jax(p0, device="cpu", cfg=cfg)
    state = opt_state_from_jax(s0, device="cpu")
    losses = []
    for toks, labs in _batches():
        loss, params, state = step_fn(params, state, torch.from_numpy(toks),
                                      torch.from_numpy(labs))
        losses.append(float(loss))
    return losses, params, state


def _assert_same(ref, got):
    _, _, jl, jp, js = ref
    losses, params, state = got
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    for name in jp:
        np.testing.assert_allclose(params[name].detach().numpy(), jp[name],
                                   atol=ATOL, err_msg=name)
        for k in ("m", "v", "master"):
            np.testing.assert_allclose(state[name][k].numpy(), js[name][k],
                                       atol=ATOL, err_msg=f"{name}.{k}")
        assert int(state[name]["t"]) == int(js[name]["t"]) == STEPS


@pytest.fixture(scope="module")
def golden():
    return _jax_run()


@pytest.mark.parametrize("remat,attention", [(False, "kernel"),
                                             (True, "kernel"),
                                             (False, "plain")])
def test_three_steps_match_jax(golden, remat, attention):
    _assert_same(golden, _port_run(golden, remat=remat, attention=attention))


def test_remat_changes_nothing(golden):
    a = _port_run(golden, remat=False)
    b = _port_run(golden, remat=True)
    assert a[0] == b[0]
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name


def test_grad_clip_active_matches_jax():
    """A clip far below the gradient norm scales every step's update."""
    ref = _jax_run(grad_clip=1e-3)
    got = _port_run(ref, grad_clip=1e-3)
    _assert_same(ref, got)
    unclipped = _port_run(ref, grad_clip=0.0)
    assert unclipped[0][1:] != got[0][1:]


def test_fused_ce_step_matches_jax():
    ref = _jax_run(fused_ce_chunks=4)
    _assert_same(ref, _port_run(ref, fused_ce_chunks=4))


def test_fused_ce_step_matches_unfused(golden):
    """fused_ce_chunks=4 against the unfused loss: the same trajectory."""
    fused = _port_run(golden, fused_ce_chunks=4)
    unfused = _port_run(golden)
    np.testing.assert_allclose(fused[0], unfused[0], rtol=1e-5)


def _ce_inputs(T, H, V, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    h = rng.randn(T, H).astype(np.float32)
    w = (rng.randn(V, H) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, T)
    return h, w, labels


@pytest.mark.parametrize("nc", [1, 4, 8])
def test_fused_ce_matches_jax_op(nc):
    """Loss and gradients of the port's fused CE against the JAX op."""
    h, w, labels = _ce_inputs(64, 32, 128, nc)
    jl, jvjp = jax.vjp(lambda h, w: jfused_ce(h, w, jnp.asarray(labels), nc),
                       jnp.asarray(h), jnp.asarray(w))
    g = np.random.RandomState(9).rand(64).astype(np.float32)
    jgh, jgw = jvjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), nc)
    (tl * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-5)


def test_fused_ce_bf16_grads_keep_the_operand_dtype():
    h, w, labels = _ce_inputs(32, 16, 64, 2)
    hb = jnp.asarray(h * 0.5, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    jgh, jgw = jax.grad(lambda h, w: jnp.mean(
        jfused_ce(h, w, jnp.asarray(labels), 4)), argnums=(0, 1))(hb, wb)
    th = torch.from_numpy(np.asarray(hb, np.float32)).bfloat16() \
        .requires_grad_(True)
    tw = torch.from_numpy(np.asarray(wb, np.float32)).bfloat16() \
        .requires_grad_(True)
    fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), 4).mean() \
        .backward()
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(jgh, np.float32), rtol=0.05,
                               atol=0.02)
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               np.asarray(jgw, np.float32), rtol=0.05,
                               atol=0.02)


def test_fused_ce_indivisible_vocab_raises():
    with pytest.raises(ValueError, match="not divisible"):
        fused_linear_cross_entropy(torch.zeros(4, 8), torch.zeros(10, 8),
                                   torch.zeros(4, dtype=torch.long), 3)
    with pytest.raises(ValueError, match="fused_ce_chunks"):
        GPTSpmdConfig(vocab_size=100, fused_ce_chunks=7)


def test_forward_logits_match_jax(golden):
    cfg = GPTSpmdConfig(**CFG)
    toks = _batches()[0][0]
    want = jmake_forward_fn(JConfig(**CFG))(
        jax.tree_util.tree_map(jnp.asarray, golden[0]), jnp.asarray(toks))
    got = make_forward_fn(cfg, device="cpu")(
        params_from_jax(golden[0], device="cpu", cfg=cfg),
        torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_params_from_jax_is_a_checked_copy(golden, change):
    cfg = GPTSpmdConfig(**CFG)
    params = dict(golden[0])
    if change == "missing":
        del params["wpe"]
    elif change == "extra":
        params["w_extra"] = params["wpe"]
    else:
        params["w_fc1"] = params["w_fc1"][:, :, :-1]
    with pytest.raises(ValueError, match="missing|unexpected|shape"):
        params_from_jax(params, device="cpu", cfg=cfg)


def test_params_from_jax_bf16_is_exact(golden):
    cfg = GPTSpmdConfig(**{**CFG, "param_dtype": "bfloat16"})
    jp = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
          for k, v in golden[0].items()}
    tp = params_from_jax(jp, device="cpu", cfg=cfg)
    for k, v in tp.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(),
                                      jp[k].astype(np.float32))


@pytest.mark.parametrize("what", ["sp_mode", "ulysses_heads",
                                  "fused_ce_local_shard", "absent_card"])
def test_refused_plans_raise(what):
    """What the port still refuses, each with the reference's reason: an
    unknown sp_mode, ulysses with heads/mp not divisible by sp, a fused-CE
    chunk count that does not divide the local vocab shard, and a rank
    placed on a card the host lacks."""
    cfg = GPTSpmdConfig(**CFG)
    if what == "sp_mode":
        with pytest.raises(ValueError, match="sp_mode"):
            MeshPlan(sp=2, sp_mode="Ulysses")
    elif what == "ulysses_heads":
        with pytest.raises(ValueError, match="divisible by the sp axis"):
            make_train_step(cfg, MeshPlan(sp=4, mp=2, sp_mode="ulysses"),
                            device="cpu")
    elif what == "fused_ce_local_shard":
        cfg = dataclasses.replace(cfg, fused_ce_chunks=128)
        with pytest.raises(ValueError, match="LOCAL shard"):
            make_train_step(cfg, MeshPlan(mp=2), device="cpu")
    else:
        absent = f"cuda:{torch.cuda.device_count()}"
        with pytest.raises((ValueError, RuntimeError),
                           match="not on this host|CUDA is not available"):
            make_train_step(cfg, MeshPlan(dp=2), device="cpu",
                            devices=["cpu", absent])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(GPTSpmdConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_forward_fn(GPTSpmdConfig(**CFG))


def test_single_device_trains():
    """The port's own init: memorising one fixed batch, the loss falls
    decisively (the JAX package's `test_single_device_trains`)."""
    cfg = GPTSpmdConfig(**CFG)
    step_fn, init_fn = make_train_step(cfg, learning_rate=1e-2, device="cpu")
    params, state = init_fn(0)
    toks, labs = (torch.from_numpy(x) for x in _batches()[0])
    losses = [float(step_fn(params, state, toks, labs)[0])
              for _ in range(20)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.6, losses


def test_init_matches_the_jax_statistics():
    """Same leaves, shapes and scales as the JAX init (different draws)."""
    cfg = GPTSpmdConfig(**{**CFG, "layers": 24})
    from paddle_tpu_torch.parallel import init_gpt_params
    p = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    from paddle_tpu.parallel import init_gpt_params as jinit
    jp = jinit(JConfig(**{**CFG, "layers": 24}), jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("wte", "w_qkv", "w_proj", "w_fc2"):
        np.testing.assert_allclose(float(p[k].std()),
                                   float(np.asarray(jp[k]).std()), rtol=0.1)
    assert torch.equal(p["ln1_w"], torch.ones_like(p["ln1_w"]))
    assert not p["b_fc1"].any()
    cfg_bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    assert init_gpt_params(cfg_bf16, torch.Generator().manual_seed(0),
                           "cpu")["wte"].dtype == torch.bfloat16
