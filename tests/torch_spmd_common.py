"""Shared helpers of the port's multi-device training tests
(`test_torch_spmd.py`, `test_torch_pipeline.py`,
`test_torch_spmd_checkpoint.py`): run the JAX `gpt_spmd` step under a
plan, run the port's step from the same weights and state, and compare.

Everything crosses between the packages as numpy global arrays. The JAX
step runs on the 8 virtual CPU devices of `tests/conftest.py`; the port
runs every rank on the CPU (`device="cpu"`), where its flash wrappers take
their plain versions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import GPTSpmdConfig as JConfig
from paddle_tpu.parallel import MeshPlan as JPlan
from paddle_tpu.parallel import make_train_step as jmake_train_step
from paddle_tpu_torch.parallel import (GPTSpmdConfig, MeshPlan,
                                       gather_opt_state, gather_params,
                                       init_opt_state_leaf,
                                       interleave_permutation,
                                       make_train_step, opt_state_from_jax,
                                       params_from_jax)
from paddle_tpu_torch.parallel.gpt_spmd import _BLOCK_LEAVES

# tests/test_parallel_spmd.py's tiny config; lr 1e-3 as
# test_torch_train_step.py explains (ROADMAP C.2)
CFG = dict(vocab_size=128, max_seq_len=64, hidden=64, layers=4, heads=4,
           ffn=128, remat=False)
# tests/test_pipeline_schedules.py's config
PIPE_CFG = dict(vocab_size=128, max_seq_len=64, hidden=32, layers=8,
                heads=4, ffn=64, remat=False)
B, S, STEPS, LR = 8, 32, 3, 1e-3
LOSS_RTOL, HYBRID_RTOL, ATOL = 2e-4, 5e-4, 1e-5
# against the single-device golden (another plan: other summation orders
# compound over 3 Adam steps): the chip's parity tolerance
GOLDEN_PARAM_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ranks run tiny ops in lockstep: with one intra-op thread
    they stay off the cores of the files xdist runs beside them (threads
    spinning on a loaded host slowed these files up to 80x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(cfg, seed=0, b=B, s=S):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg["vocab_size"], (b, s)),
             rng.randint(0, cfg["vocab_size"], (b, s)))
            for _ in range(STEPS)]


def jplan(plan):
    return JPlan(**{k: getattr(plan, k) for k in (
        "dp", "pp", "sharding", "sp", "mp", "microbatches", "schedule",
        "vpp", "sp_mode")})


def jax_run(plan, cfg=CFG, grad_clip=1.0, b=B, s=S):
    """(initial params, initial state, losses, final params, final state)
    of the JAX step under `plan` (a port MeshPlan), as numpy globals."""
    step_fn, init_fn, _ = jmake_train_step(JConfig(**cfg), jplan(plan),
                                           learning_rate=LR,
                                           grad_clip=grad_clip)
    params, state = init_fn(jax.random.key(0))
    as_np = jax.tree_util.tree_map
    p0, s0 = as_np(np.asarray, params), as_np(np.asarray, state)
    losses = []
    for toks, labs in batches(cfg, b=b, s=s):
        loss, params, state = step_fn(params, state, jnp.asarray(toks),
                                      jnp.asarray(labs), jnp.float32(LR))
        losses.append(float(loss))
    return p0, s0, losses, as_np(np.asarray, params), as_np(np.asarray,
                                                           state)


def permute_blocks(params, cfg, plan, inverse=False):
    """The vpp storage order of the stacked block leaves (or back)."""
    if plan.vpp == 1:
        return dict(params)
    perm = interleave_permutation(cfg["layers"], plan.pp, plan.vpp)
    if inverse:
        perm = np.argsort(perm)
    return {k: (v[perm] if k in _BLOCK_LEAVES else v)
            for k, v in params.items()}


def port_run(plan, p0, s0=None, cfg=CFG, grad_clip=1.0, b=B, s=S,
             attention="kernel", steps=STEPS):
    """(losses, params, state, step_fn) of the port's step under `plan`
    from the JAX global parameters p0 (in the plan's storage order) and
    the JAX global state s0 (None: the zero state)."""
    c = GPTSpmdConfig(**cfg)
    step_fn, _ = make_train_step(c, plan, learning_rate=LR,
                                 grad_clip=grad_clip, device="cpu",
                                 attention=attention)
    params = params_from_jax(p0, device="cpu", cfg=c, plan=plan)
    if s0 is not None:
        state = opt_state_from_jax(s0, device="cpu", plan=plan)
    elif plan.n_devices == 1:
        state = {k: init_opt_state_leaf(v, plan) for k, v in params.items()}
    else:
        state = {k: [init_opt_state_leaf(p, plan) for p in v]
                 for k, v in params.items()}
    losses = []
    for toks, labs in batches(cfg, b=b, s=s)[:steps]:
        loss, params, state = step_fn(params, state, torch.from_numpy(toks),
                                      torch.from_numpy(labs))
        losses.append(float(loss))
    return losses, params, state, step_fn


def assert_direct(ref, got, plan, rtol):
    """Plan-for-plan parity: losses, gathered parameters and the sharded
    m / v / master against the JAX global state arrays."""
    _, _, jl, jp, js = ref
    losses, params, state, _ = got
    np.testing.assert_allclose(losses, jl, rtol=rtol)
    gp = gather_params(params, plan)
    gs = gather_opt_state(state, plan)
    for name in jp:
        np.testing.assert_allclose(gp[name], jp[name], atol=ATOL,
                                   err_msg=name)
        for k in ("m", "v", "master"):
            assert gs[name][k].shape == js[name][k].shape, (name, k)
            np.testing.assert_allclose(gs[name][k], js[name][k], atol=ATOL,
                                       err_msg=f"{name}.{k}")
        assert int(gs[name]["t"]) == int(js[name]["t"]) == STEPS


def assert_golden(golden, got, plan, rtol, cfg=CFG):
    """A plan against the single-device JAX golden: losses, and the
    gathered parameters (back in the logical layer order)."""
    _, _, jl, jp, _ = golden
    losses, params, _, _ = got
    np.testing.assert_allclose(losses, jl, rtol=rtol)
    gp = permute_blocks(gather_params(params, plan), cfg, plan,
                        inverse=True)
    for name in jp:
        np.testing.assert_allclose(gp[name], jp[name],
                                   atol=GOLDEN_PARAM_ATOL, err_msg=name)


def logical_state(vec, name, local_shape, plan):
    """A JAX-layout global state vector (no sharding pad: sharding=1) ->
    the leaf's logical array, by its spec's pp / mp pieces."""
    from paddle_tpu_torch.parallel import param_specs
    spec = param_specs()[name]
    axes = [a for a in spec if a in ("pp", "mp")]
    dims = plan.dims
    n = math.prod(dims[a] for a in axes)
    pieces = np.asarray(vec).reshape(n, *local_shape)
    full_shape = [d * (dims[p] if p in ("pp", "mp") else 1)
                  for d, p in zip(local_shape, list(spec) + [None] * 3)]
    full = np.zeros(full_shape, pieces.dtype)
    for flat in range(n):
        idx = np.unravel_index(flat, [dims[a] for a in axes]) if axes \
            else ()
        coord = dict(zip(axes, idx))
        sl = tuple(slice(coord[p] * d, (coord[p] + 1) * d)
                   if p in coord else slice(None)
                   for d, p in zip(local_shape, list(spec) + [None] * 3))
        full[sl] = pieces[flat]
    return full


def count_flash_calls(monkeypatch):
    """Count the flash forward calls (the plain version runs on the CPU,
    where launches are not counted)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    calls = {"fwd": 0}
    real = fa.flash_fwd

    def counted(*a, **k):
        calls["fwd"] += 1
        return real(*a, **k)
    monkeypatch.setattr(fa, "flash_fwd", counted)
    return calls


__all__ = ["one_torch_thread", "CFG", "PIPE_CFG", "B", "S", "STEPS", "LR", "LOSS_RTOL",
           "HYBRID_RTOL", "ATOL", "MeshPlan", "batches", "jax_run",
           "port_run", "permute_blocks", "assert_direct", "assert_golden",
           "logical_state", "count_flash_calls"]
