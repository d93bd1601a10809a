"""The port's pipeline-parallel training step (GPipe, 1F1B, eager 1F1B,
interleaved vpp 2 and 4, and the hybrids with dp, mp and sp) against the
JAX package's, on the CPU.

Two plans run in both packages from the same JAX-initialised weights and
state (direct parity: losses at rtol 5e-4, the gathered parameters and
the sharded m / v / master at atol 1e-5): dp=2 x mp=2 x pp=2 and
pp=2 x sp=2 x dp=2 with vpp=2 (the all-gather sp route). The other plans
of `tests/test_parallel_spmd.py` are held to its single-device golden
(tiny config), and `test_pipeline_parity`'s five plans to the golden of
`tests/test_pipeline_schedules.py`'s config (hidden 32, 8 layers), at
their tolerances; parameters at atol 1e-4.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import gather_params
from paddle_tpu_torch.parallel.collectives import RankGrid
from paddle_tpu_torch.parallel.pipeline_schedule import (arrival_tables,
                                                         build_tables,
                                                         required_slots)
from torch_spmd_common import one_torch_thread  # noqa: F401
from torch_spmd_common import (CFG, HYBRID_RTOL, LOSS_RTOL, PIPE_CFG,
                               MeshPlan, assert_direct, assert_golden,
                               count_flash_calls, jax_run, permute_blocks,
                               port_run)

DIRECT = {
    "dp2_mp2_pp2": MeshPlan(dp=2, mp=2, pp=2, microbatches=2),
    "pp2_sp2_dp2_vpp2": MeshPlan(pp=2, sp=2, dp=2, microbatches=4, vpp=2),
}


@pytest.fixture(scope="module")
def golden():
    return jax_run(MeshPlan())


@pytest.fixture(scope="module")
def pipe_golden():
    return jax_run(MeshPlan(), cfg=PIPE_CFG)


@pytest.fixture(scope="module", params=sorted(DIRECT))
def direct(request):
    plan = DIRECT[request.param]
    return plan, jax_run(plan)


def test_direct_parity_with_jax(direct):
    plan, ref = direct
    assert_direct(ref, port_run(plan, ref[0], ref[1]), plan, HYBRID_RTOL)


@pytest.mark.parametrize("plan,rtol", [
    (MeshPlan(pp=2, microbatches=4), LOSS_RTOL),
    (MeshPlan(pp=2, microbatches=4, schedule="gpipe"), LOSS_RTOL),
    (MeshPlan(pp=2, sp=2, dp=2, microbatches=2), HYBRID_RTOL),
    (MeshPlan(pp=2, sp=2, dp=2, microbatches=2, sp_mode="ulysses"),
     HYBRID_RTOL),
    (MeshPlan(dp=2, mp=2, pp=2, microbatches=2), HYBRID_RTOL),
    (MeshPlan(pp=2, sp=2, dp=2, microbatches=4, vpp=2), HYBRID_RTOL),
    (MeshPlan(dp=2, mp=2, pp=2, microbatches=2, schedule="gpipe"),
     HYBRID_RTOL),
], ids=["pp2_1f1b", "pp2_gpipe", "pp2_sp2_dp2_ring", "pp2_sp2_dp2_ulysses",
        "dp2_mp2_pp2", "pp2_sp2_dp2_vpp2", "dp2_mp2_pp2_gpipe"])
def test_plan_matches_golden(golden, plan, rtol):
    p0 = permute_blocks(golden[0], CFG, plan)
    assert_golden(golden, port_run(plan, p0), plan, rtol)


@pytest.mark.parametrize("plan", [
    MeshPlan(pp=4, microbatches=8, schedule="1f1b"),
    MeshPlan(pp=4, microbatches=8, schedule="eager1f1b"),
    MeshPlan(pp=4, microbatches=4, vpp=2),
    MeshPlan(pp=2, microbatches=4, vpp=4),
    MeshPlan(pp=2, mp=2, dp=2, microbatches=2),
], ids=["1f1b", "eager1f1b", "interleave_v2", "interleave_v4", "hybrid"])
def test_pipeline_parity(pipe_golden, plan):
    """`tests/test_pipeline_schedules.py::test_pipeline_parity`'s plans:
    losses within 3e-4 of the golden (its own bound), parameters 1e-4."""
    p0 = permute_blocks(pipe_golden[0], PIPE_CFG, plan)
    losses, params, _, _ = got = port_run(plan, p0, cfg=PIPE_CFG)
    diff = max(abs(a - b) for a, b in zip(pipe_golden[2], losses))
    assert diff < 3e-4, (plan, pipe_golden[2], losses)
    assert_golden(pipe_golden, got, plan, 3e-4 / min(pipe_golden[2]),
                  cfg=PIPE_CFG)


@pytest.mark.parametrize("remat", ["dots", "dots+attn"])
def test_remat_policies_under_1f1b_match_no_remat(golden, remat):
    """Remat inside the 1F1B recompute changes no value (rtol 1e-6)."""
    plan = MeshPlan(pp=2, microbatches=4)
    base = port_run(plan, golden[0])
    got = port_run(plan, golden[0], cfg=dict(CFG, remat=remat))
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6)
    a, b = gather_params(got[1], plan), gather_params(base[1], plan)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("plan", [
    MeshPlan(pp=2, microbatches=4),
    MeshPlan(pp=2, microbatches=4, schedule="gpipe"),
    MeshPlan(dp=2, mp=2, pp=2, microbatches=2),
], ids=["1f1b", "gpipe", "dp2_mp2_pp2"])
def test_pp_replicated_leaves_stay_identical(golden, plan):
    """wte, wpe and lnf_* live on every stage: their gradients are summed
    over pp before the clip, so every stage's copy is the same after each
    step, bit for bit."""
    _, params, state, _ = port_run(plan, golden[0])
    grid = RankGrid(plan.dims, [torch.device("cpu")] * plan.n_devices)
    for name in ("wte", "wpe", "lnf_w", "lnf_b"):
        first = {}                      # one copy a mp shard
        for r, p in enumerate(params[name]):
            key = grid.coords[r]["mp"]
            if key not in first:
                first[key] = (p, state[name][r]["master"])
                continue
            assert torch.equal(p, first[key][0]), (name, r)
            assert torch.equal(state[name][r]["master"], first[key][1]), \
                (name, r)
        assert len(first) == plan.mp


def test_1f1b_buffers_bounded_and_gpipe_grows(pipe_golden):
    """The CPU counterpart of `test_1f1b_memory_below_gpipe`: at pp=4 the
    1F1B step never holds more live stage inputs than `required_slots`
    (the same slots for M = 8, 16 and 32), while GPipe keeps all M of
    them for its backward."""
    peaks = {}
    for M in (8, 16, 32):
        f, b, _ = build_tables(M, 4, "1f1b")
        f, b = f[:, :, None], b[:, :, None]
        W = required_slots(f, b, *arrival_tables(f, b, 4, 1), M, 4, 1)
        for sched in ("1f1b", "gpipe"):
            plan = MeshPlan(pp=4, microbatches=M, schedule=sched)
            _, _, _, step = port_run(plan, pipe_golden[0], cfg=PIPE_CFG,
                                     b=32, s=8, steps=1)
            st = step.stats
            if sched == "1f1b":
                assert st["slots"] == W
                assert max(st["peak_live"]) <= W, st
            peaks[(sched, M)] = max(st["peak_live"])
    assert peaks[("1f1b", 8)] == peaks[("1f1b", 16)] == peaks[("1f1b", 32)]
    assert [peaks[("gpipe", M)] for M in (8, 16, 32)] == [8, 16, 32]


def test_allgather_route_launches_no_flash(golden, monkeypatch):
    """pp x sp ring attends S/sp queries over the gathered keys: the
    plain cross-length route of the reference, no flash call; pp x sp
    ulysses calls the flash wrapper (forward and its 1F1B recompute)."""
    calls = count_flash_calls(monkeypatch)
    port_run(MeshPlan(pp=2, sp=2, microbatches=2), golden[0], steps=1)
    assert calls["fwd"] == 0
    port_run(MeshPlan(pp=2, sp=2, microbatches=2, sp_mode="ulysses"),
             golden[0], steps=1)
    assert calls["fwd"] > 0


def test_flash_wrapper_keeps_refusing_cross_length():
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bhsd
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bhsd(q, k, k)


def test_unknown_schedule_and_stage_split_raise():
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    cfg = GPTSpmdConfig(**CFG)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        make_train_step(cfg, MeshPlan(pp=2, schedule="zb"), device="cpu")
    with pytest.raises(ValueError, match="do not split over"):
        make_train_step(cfg, MeshPlan(pp=4, vpp=2), device="cpu")
