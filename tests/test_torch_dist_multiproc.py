"""The port's process layer across two processes, against the JAX package.

One module-scoped job: the port's launcher (`distributed.launch`, in this
process) starts two ranks of `tests/torch_dist_worker.py`, which join a
gloo process group on the CPU (each rank kills itself after its own
timeout). The goldens are the reference's own recipes, computed here on
its 8 virtual CPU devices; no JAX process is started:
  * the psum of rank+1 over 8 ranks split 4 + 4 over the processes reads
    36 on every rank, as the reference's shard_map psum does;
  * the eager collectives read what `tests/test_multiprocess_dist.py`
    expects of the reference (sum 3, max 2, broadcast from process 1
    20), the port's all_gather and reduce_scatter their exact values,
    and the collectives the reference keeps local their identity;
  * the dp MLP of `tests/dist_worker.py` (8 ranks, 4 a process, the
    gradients and loss pmean'd over dp in a manual region) matches the
    reference's one-process shard_map run at rtol 1e-6;
  * `Model.train_batch` of a small CNN with `SyncBatchNorm` on a dp2 mesh,
    one rank a process, matches the reference `Model` on its dp2 mesh
    (the global batch's loss and BatchNorm statistics) at rtol 1e-5 (f32;
    the port reduces sum and sum of squares, the reference two-pass);
  * the multi-controller `gpt_spmd` dp2 step, from the reference's
    initial weights (carried with `params_from_jax(plan=)`), matches the
    reference's dp2 step at rtol 2e-4 and the port's one-controller dp2
    plan at rtol 1e-6 (same sums in the same order), and its init_fn
    builds the one-controller plan's leaves;
  * `DataParallel.apply_collective_grads`, the sampler's defaults, the
    TCPStore and `all_gather_object` across the processes;
  * the ranks imported neither JAX nor `paddle_tpu`.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as pj
from paddle_tpu.distributed import env as jenv
from paddle_tpu_torch.distributed.launch import launch

import torch_dist_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
# the f32 loss tolerance of the port's gpt_spmd steps against the
# reference's (tests/torch_spmd_common.py LOSS_RTOL)
LOSS_RTOL = 2e-4


def jax_mlp_golden():
    """tests/dist_worker.py (b) on the 8 virtual devices."""
    mesh = Mesh(np.asarray(jax.devices()), ("dp",))

    def put(v, spec):
        return jax.device_put(v, NamedSharding(mesh, spec))

    rng = np.random.RandomState(0)
    W1 = put(rng.randn(16, 32).astype(np.float32) * 0.1, P())
    W2 = put(rng.randn(32, 1).astype(np.float32) * 0.1, P())
    X = put(rng.randn(64, 16).astype(np.float32), P("dp"))
    Y = put(rng.randn(64, 1).astype(np.float32), P("dp"))

    def local_step(w1, w2, x, y):
        def loss_fn(w1, w2):
            return jnp.mean((jnp.tanh(x @ w1) @ w2 - y) ** 2)
        l, (g1, g2) = jax.value_and_grad(loss_fn, argnums=(0, 1))(w1, w2)
        l = jax.lax.pmean(l, "dp")
        g1 = jax.lax.pmean(g1, "dp")
        g2 = jax.lax.pmean(g2, "dp")
        return l, w1 - 0.1 * g1, w2 - 0.1 * g2

    step = jax.jit(jax.shard_map(local_step, mesh=mesh,
                                 in_specs=(P(), P(), P("dp"), P("dp")),
                                 out_specs=(P(), P(), P()), check_vma=False))
    losses = []
    for _ in range(5):
        loss, W1, W2 = step(W1, W2, X, Y)
        losses.append(float(np.asarray(loss)))

    psum = jax.jit(jax.shard_map(lambda v: jax.lax.psum(v, "dp"), mesh=mesh,
                                 in_specs=P("dp"), out_specs=P(),
                                 check_vma=False))
    total = psum(put(np.arange(8, dtype=np.float32) + 1, P("dp")))
    return float(np.asarray(total).reshape(-1)[0]), losses


def jax_model_golden(out_dir):
    """The reference Model on a dp2 mesh over the CNN; its weights go to
    `<out_dir>/cnn.npz` for the ranks."""
    prev = jenv.get_mesh()
    try:
        pj.seed(4)
        net = W.cnn(pj)
        np.savez(os.path.join(out_dir, "cnn.npz"),
                 **{k: np.asarray(v.numpy())
                    for k, v in net.state_dict().items()})
        mesh = jenv.build_mesh({"dp": 2})
        m = pj.Model(net)
        m.prepare(pj.optimizer.SGD(0.1, parameters=net.parameters()),
                  pj.nn.CrossEntropyLoss())
        losses = [m.train_batch([x], [y])[0][0] for x, y in W.cnn_batches()]
        assert m._dp_mesh() is mesh
        return losses, np.asarray(net.bn._mean.numpy())
    finally:
        jenv._global_mesh = prev


def jax_gpt_golden(out_dir):
    """The reference `gpt_spmd` dp2 step (2 of the 8 virtual devices) on
    the ranks' batches; its initial weights go to `<out_dir>/gpt.npz`."""
    from paddle_tpu.parallel import GPTSpmdConfig as JConfig
    from paddle_tpu.parallel import MeshPlan as JPlan
    from paddle_tpu.parallel import make_train_step as jmake_train_step
    step_fn, init_fn, _ = jmake_train_step(JConfig(**W.GPT_CFG),
                                           JPlan(dp=2), learning_rate=1e-3)
    params, state = init_fn(jax.random.key(0))
    p0 = {k: np.asarray(v) for k, v in params.items()}
    np.savez(os.path.join(out_dir, "gpt.npz"), **p0)
    losses = []
    for toks, labs in W.gpt_batches():
        loss, params, state = step_fn(params, state, jnp.asarray(toks),
                                      jnp.asarray(labs))
        losses.append(float(loss))
    return p0, losses


def port_gpt_golden(p0):
    """The port's one-controller dp2 plan from the same weights and on the
    same batches, and its init_fn's first leaf piece."""
    from paddle_tpu_torch.parallel import GPTSpmdConfig, MeshPlan
    losses, params = W.gpt_steps(p0)
    _, init_fn = W.make_train_step(GPTSpmdConfig(**W.GPT_CFG),
                                   MeshPlan(dp=2), device="cpu")
    return (losses, float(params["wte"][0].detach().double().sum()),
            float(init_fn(0)[0]["wte"][0].double().sum()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_dist")
    model_golden = jax_model_golden(str(out))
    gpt_p0, gpt_losses = jax_gpt_golden(str(out))
    rc = launch(["--nproc_per_node", "2", os.path.join(HERE,
                                                       "torch_dist_worker.py"),
                 str(out)])
    assert rc == 0, f"a rank failed with exit code {rc}"
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    return {"ranks": ranks, "mlp": jax_mlp_golden(),
            "model": model_golden, "gpt": (gpt_p0, gpt_losses)}


def test_rendezvous_through_the_launcher(runs):
    for r, res in enumerate(runs["ranks"]):
        assert (res["rank"], res["world"], res["trainer_id"]) == (r, 2, r)
        assert res["backend"] == "gloo"
        assert res["local_ranks"] == list(range(4 * r, 4 * r + 4))
        # the dp2 mesh built before init_parallel_env, split over the
        # processes when it joined the group
        assert res["mesh_before_init"] == [2, [r], {"dp": 2}]
        assert res["jax_free"]


def test_psum_over_ranks_split_across_processes(runs):
    golden, _ = runs["mlp"]
    assert golden == 36.0
    for res in runs["ranks"]:
        assert res["psum"] == [36.0] * 4


def test_eager_collectives_across_processes(runs):
    r0, r1 = runs["ranks"]
    for res in (r0, r1):
        assert res["eager_allreduce"] == [3.0] * 3
        assert res["eager_max"] == [2.0] * 2
        assert res["eager_bcast"] == [20.0] * 2
        assert res["eager_min"] == [1.0] * 2
        assert res["eager_prod_int"] == [6, 6]
        assert res["eager_avg"] == [1.5] * 2
        assert res["all_gather"] == [[0.0, 0.0], [1.0, 1.0]]
        assert res["objects"] == [{"rank": 0}, {"rank": 1}]
    # reduce_scatter of arange(4)*(rank+1): the sum is [0, 3, 6, 9]
    assert (r0["reduce_scatter"], r1["reduce_scatter"]) == ([0.0, 3.0],
                                                            [6.0, 9.0])
    # the collectives the reference keeps local across processes are the
    # single participant's identity in the port too
    for me, res in enumerate((r0, r1)):
        v = float(me)
        assert res["identities"] == {
            "alltoall": [[10.0 * me], [10.0 * me + 1]], "p2p_shift": [v],
            "scatter": [v, v], "send": [v], "recv": [v],
            "all_gather_concat": [v]}


def test_store_across_processes(runs):
    r0, r1 = runs["ranks"]
    assert sorted([r0["store_add"], r1["store_add"]]) == [1, 2]
    assert (r0["store_get"], r1["store_get"]) == ("v1", "v0")


def test_dp_mlp_matches_the_reference_golden(runs):
    _, golden = runs["mlp"]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["mlp_losses"], golden, rtol=1e-6)
    assert golden[-1] < golden[0]


def test_model_dp2_sync_batchnorm_matches_the_reference(runs):
    losses, bn_mean = runs["model"]
    for res in runs["ranks"]:
        assert res["model_dp_mesh"]
        np.testing.assert_allclose(res["model_losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["model_bn_mean"], bn_mean, rtol=1e-5,
                                   atol=1e-6)


def test_multi_controller_gpt_dp2_matches_one_controller(runs):
    p0, jax_losses = runs["gpt"]
    losses, wte_sum, init_wte_sum = port_gpt_golden(p0)
    # the one-controller plan against the reference's dp2 step, from the
    # same weights (f32; test_torch_spmd.py's loss rtol)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    for res in runs["ranks"]:
        assert res["gpt_leaves"] == 1          # one local rank a process
        # the same sums in the same order as the one-controller plan
        np.testing.assert_allclose(res["gpt_losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(res["gpt_wte_sum"], wte_sum, rtol=1e-6)
        np.testing.assert_allclose(res["gpt_init_wte_sum"], init_wte_sum,
                                   rtol=1e-6)
        np.testing.assert_allclose(res["gpt_losses"], jax_losses,
                                   rtol=LOSS_RTOL)


def test_data_parallel_and_sampler_under_the_group(runs):
    for r, res in enumerate(runs["ranks"]):
        # d(sum(x @ w.T + b))/dw = column sums of x: 3*(rank+1), mean 4.5
        assert res["dp_grad"] == [[4.5] * 2] * 4
        nranks, local, batches = res["sampler"]
        assert (nranks, local) == (2, r)
        assert batches == [[r, r + 2], [r + 4, r + 6], [r + 8]]
