"""Sharded checkpoints of the port's training step and their re-slicing
across plans, between the two packages, on the CPU.

The port saves a sharded leaf (one piece a rank) as one chunk per distinct
shard with its JAX PartitionSpec, as `paddle_tpu.distributed.checkpoint`
saves a sharded array, and `load_state_dict(plan=...)` cuts any
checkpoint into any plan's pieces (the JAX `mesh=` argument), folding
away axes the plan does not name. Arrays must be equal, bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from paddle_tpu.distributed.checkpoint import \
    load_state_dict as jload_state_dict
from paddle_tpu.distributed.checkpoint import \
    save_state_dict as jsave_state_dict
from paddle_tpu.parallel import MeshPlan as JPlan
from paddle_tpu.parallel.gpt_spmd import param_specs as jparam_specs
from paddle_tpu_torch.distributed.checkpoint import (convert_state_dict,
                                                     load_state_dict,
                                                     save_state_dict)
from paddle_tpu_torch.parallel import (gather_opt_state, gather_params,
                                       param_specs, state_specs)
from paddle_tpu_torch.parallel.collectives import RankGrid
from paddle_tpu_torch.parallel.gpt_spmd import _window
from torch_spmd_common import one_torch_thread  # noqa: F401
from torch_spmd_common import CFG, MeshPlan, batches, jax_run, port_run


@pytest.fixture(scope="module")
def trained():
    """The JAX golden's initial weights, and the port's dp=2 x mp=2 step
    after 3 steps from them."""
    golden = jax_run(MeshPlan())
    plan = MeshPlan(dp=2, mp=2)
    _, params, state, _ = port_run(plan, golden[0])
    return plan, params, state


def _grid(plan):
    return RankGrid(plan.dims, [torch.device("cpu")] * plan.n_devices)


def _assert_pieces(pieces, full, spec, plan):
    grid = _grid(plan)
    for r, t in enumerate(pieces):
        want = full[_window(full.shape, spec, grid, r)]
        np.testing.assert_array_equal(t.float().numpy(), want)


def test_port_save_loads_in_jax_on_another_mesh(trained, tmp_path):
    """dp=2 x mp=2 port step -> checkpoint -> JAX onto MeshPlan(mp=4)."""
    plan, params, _ = trained
    save_state_dict(params, str(tmp_path / "ck"), plan=plan)
    files = os.listdir(tmp_path / "ck")
    # one chunk per distinct shard: wte over mp=2, wpe replicated
    assert sum(f.startswith("wte.") for f in files) == 2
    assert sum(f.startswith("wpe.") for f in files) == 1
    want = gather_params(params, plan)
    mesh = JPlan(mp=4).build_mesh()
    out = jload_state_dict(str(tmp_path / "ck"), mesh=mesh)
    for name, arr in want.items():
        got = out[name]._data
        np.testing.assert_array_equal(np.asarray(got), arr)
        if "mp" in param_specs()[name]:
            assert "mp" in str(got.sharding.spec), name


def test_jax_save_loads_in_port_on_another_plan(trained, tmp_path):
    """JAX arrays sharded over a dp=2 x mp=2 mesh -> checkpoint -> the
    port onto MeshPlan(mp=4) and onto MeshPlan(pp=2, dp=2)."""
    plan, params, _ = trained
    full = gather_params(params, plan)
    mesh = JPlan(dp=2, mp=2).build_mesh()
    specs = jparam_specs(None)
    jsave_state_dict({k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                      for k, v in full.items()}, str(tmp_path / "ck"))
    for target in (MeshPlan(mp=4), MeshPlan(pp=2, dp=2)):
        got = load_state_dict(str(tmp_path / "ck"), device="cpu",
                              plan=target)
        for name, arr in full.items():
            assert len(got[name]) == target.n_devices
            _assert_pieces(got[name], arr, param_specs()[name], target)
        for name, arr in gather_params(got, target).items():
            np.testing.assert_array_equal(arr, full[name])


def test_axes_the_plan_lacks_fold_away(tmp_path):
    """A spec naming an axis the port's meshes lack loads replicated on
    that dimension (the JAX loader drops it the same way)."""
    want = np.arange(32, dtype=np.float32).reshape(8, 4)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("x",))
    arr = jax.device_put(want, NamedSharding(mesh, PartitionSpec("x", None)))
    jsave_state_dict({"w": arr}, str(tmp_path / "ck"))
    plan = MeshPlan(mp=2)
    got = load_state_dict(str(tmp_path / "ck"), device="cpu", plan=plan)
    for t in got["w"]:
        np.testing.assert_array_equal(t.numpy(), want)


def test_optimizer_state_round_trips_both_ways(trained, tmp_path):
    """The sharded m / v / master in the JAX state layout: saved by the
    port, read back by the port on the same plan (equal) and by the JAX
    loader as the JAX global state arrays."""
    plan, _, state = trained
    flat = {f"{k}.{n}": [st[n] for st in v]
            for k, v in state.items() for n in ("m", "v", "master")}
    specs = {f"{k}.{n}": state_specs()[k][n]
             for k in state for n in ("m", "v", "master")}
    save_state_dict(flat, str(tmp_path / "opt"), plan=plan, specs=specs)
    back = load_state_dict(str(tmp_path / "opt"), device="cpu", plan=plan)
    for name, pieces in flat.items():
        for a, b in zip(pieces, back[name]):
            assert torch.equal(a, b), name
    glob = gather_opt_state(state, plan)
    out = jload_state_dict(str(tmp_path / "opt"), return_numpy=True)
    for k in state:
        for n in ("m", "v", "master"):
            np.testing.assert_array_equal(out[f"{k}.{n}"], glob[k][n])


def test_resume_from_a_sharded_checkpoint_is_exact(tmp_path):
    """Save params and state after one step, load them into a new step on
    the same plan, take two more steps: the same as three straight."""
    golden = jax_run(MeshPlan())
    plan = MeshPlan(sharding=2, mp=2)
    straight = port_run(plan, golden[0])
    one = port_run(plan, golden[0], steps=1)
    sd = dict(one[1])
    specs = dict(param_specs())
    for k, v in one[2].items():
        for n in ("m", "v", "master"):
            sd[f"opt.{k}.{n}"] = [st[n] for st in v]
            specs[f"opt.{k}.{n}"] = state_specs()[k][n]
    save_state_dict(sd, str(tmp_path / "step1"), plan=plan, specs=specs)
    got = load_state_dict(str(tmp_path / "step1"), device="cpu", plan=plan)
    params = {k: got[k] for k in one[1]}
    state = {k: [{"m": got[f"opt.{k}.m"][r], "v": got[f"opt.{k}.v"][r],
                  "master": got[f"opt.{k}.master"][r],
                  "t": torch.tensor(1, dtype=torch.int32)}
                 for r in range(plan.n_devices)] for k in one[1]}
    step = one[3]
    losses = []
    for toks, labs in batches(CFG)[1:]:
        loss, params, state = step(params, state, torch.from_numpy(toks),
                                   torch.from_numpy(labs))
        losses.append(float(loss))
    assert losses == straight[0][1:]
    for k, v in gather_params(params, plan).items():
        np.testing.assert_array_equal(
            v, gather_params(straight[1], plan)[k])


def test_convert_state_dict_reslices_for_another_plan(trained, tmp_path):
    """convert_state_dict writes the checkpoint laid out for the target
    plan: one chunk per distinct piece of that plan, readable by JAX."""
    plan, params, _ = trained
    save_state_dict(params, str(tmp_path / "src"), plan=plan)
    target = MeshPlan(mp=4)
    convert_state_dict(str(tmp_path / "src"), str(tmp_path / "dst"), target)
    files = os.listdir(tmp_path / "dst")
    assert sum(f.startswith("wte.") for f in files) == 4
    out = jload_state_dict(str(tmp_path / "dst"), return_numpy=True)
    for name, arr in gather_params(params, plan).items():
        np.testing.assert_array_equal(out[name], arr)


def test_sharded_leaf_needs_its_plan(trained, tmp_path):
    _, params, _ = trained
    with pytest.raises(ValueError, match="plan="):
        save_state_dict({"wte": params["wte"]}, str(tmp_path / "x"))
