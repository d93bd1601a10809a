"""Fleet's hybrid parallelism across two processes, against the JAX
package and the port's one controller.

One module-scoped job: the port's launcher (`distributed.launch`, in this
process) starts two ranks of `tests/torch_dist_hybrid_worker.py`, which
join a gloo process group on the CPU (each rank kills itself after its
own timeout). The reference's goldens are computed here, with no JAX
process started, on its 8 virtual CPU devices; the port's one-controller
plans are computed by the ranks once their process group is gone.

  * `gpt_spmd` plans 1-3 of `tests/dist_hybrid_worker.py` (pp, mp and
    sharding across the processes): the two processes' losses at rtol
    1e-6 and every leaf of every rank's parameters within 1e-6 of the
    leaf's largest magnitude against the port's one-controller plan on
    the same batch (the same sums in the same order), and the losses at
    rtol 1e-5 against the reference's;
  * fleet's mp layers and `split` with mp across the processes: outputs
    and gradients against the full weights (f32, 1e-6 of the largest
    magnitude);
  * `Model` over mp=2 across the processes against the reference's
    one-process mp `Model` losses (`tests/test_hapi_hybrid.py:72-80`'s
    TinyErnie on its dp=2 x mp=4 mesh, rtol 5e-4 as that test);
  * `group_sharded_parallel` os_g and p_g_os across the processes against
    one process's update (1e-5), each process keeping its rows; the
    saved optimizer state whole and equal to one process's (1e-5), and
    a fresh sharded model restored from it taking one process's next
    step (1e-5);
  * the HybridCommunicateGroup's ranks and groups under the process
    group; the ranks imported no JAX.
"""
import json
import os

import numpy as np
import pytest

import torch_dist_hybrid_worker as W
from torch_jax_init import numpy_initializers

HERE = os.path.dirname(os.path.abspath(__file__))


def jax_gpt_golden(tag, plan, out_dir):
    """The reference's 3 steps of a plan on its 8 virtual devices (the
    one-process golden of tests/dist_hybrid_worker.py): (losses, initial
    weights); the weights go to `<out_dir>/gpt_<tag>.npz` before the
    steps run."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import GPTSpmdConfig, MeshPlan, make_train_step
    cfg, mp = GPTSpmdConfig(**W.gpt_cfg(plan)), MeshPlan(**plan)
    step_fn, init_fn, _ = make_train_step(cfg, mp, learning_rate=1e-3)
    params, state = init_fn(jax.random.key(0))
    p0 = {k: np.asarray(v) for k, v in params.items()}
    W.write_npz(os.path.join(out_dir, f"gpt_{tag}.npz"), p0)
    toks, labs = (jnp.asarray(a) for a in W.gpt_batch(plan))
    losses = []
    for _ in range(3):
        loss, params, state = step_fn(params, state, toks, labs,
                                      jnp.float32(1e-3))
        losses.append(float(loss))
    return losses, p0


def jax_ernie(out_dir):
    """The reference's TinyErnie from seed 5 (weights to
    `<out_dir>/ernie.npz`) and its Model's losses on the one-process
    dp=2 x mp=4 mesh of tests/test_hapi_hybrid.py:72-80."""
    import paddle_tpu as pj
    from paddle_tpu.distributed import env as jenv
    pj.seed(5)
    with numpy_initializers():
        net = W.tiny_ernie(pj)
    W.write_npz(os.path.join(out_dir, "ernie.npz"),
                {k: np.asarray(v.numpy())
                 for k, v in net.state_dict().items()})
    prev = jenv.get_mesh()
    try:
        jenv.build_mesh({"dp": 2, "mp": 4})
        m = pj.Model(net)
        m.prepare(pj.optimizer.Adam(1e-2, parameters=net.parameters()),
                  pj.nn.CrossEntropyLoss())
        return [m.train_batch([x], [y])[0][0] for x, y in W.ernie_batches()]
    finally:
        jenv._global_mesh = prev


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start first and wait for each input as they need it; the
    reference's goldens are computed here meanwhile, its plans in threads
    (their compiles overlap) beside the ERNIE losses."""
    import functools
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu.parallel import gpt_spmd as jgs
    import jax
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.launch import launch
    pt.set_device("cpu")
    out = tmp_path_factory.mktemp("port_hybrid")
    rc = []
    job = threading.Thread(target=lambda: rc.append(launch([
        "--nproc_per_node", "2",
        os.path.join(HERE, "torch_dist_hybrid_worker.py"), str(out)])))
    job.start()
    # the same draws as the eager init, compiled once instead of op by op
    eager = jgs.init_gpt_params
    jgs.init_gpt_params = lambda c, key: jax.jit(
        functools.partial(eager, c))(key)
    try:
        with ThreadPoolExecutor(len(W.PLANS)) as pool:
            jax_gold = {tag: pool.submit(jax_gpt_golden, tag, plan, str(out))
                        for tag, plan, _ in W.PLANS}
            ernie = jax_ernie(str(out))
            jax_losses = {tag: f.result()[0] for tag, f in jax_gold.items()}
    finally:
        jgs.init_gpt_params = eager
        job.join(timeout=W.TIMEOUT_S + 60)
    assert rc == [0], f"a rank failed: {rc}"
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    gold = {}
    for tag, _, _ in W.PLANS:
        one = [r["one_controller"][tag] for r in ranks
               if tag in r["one_controller"]]
        assert len(one) == 1, tag
        with np.load(out / f"one_{tag}.npz") as f:
            gold[tag] = (jax_losses[tag], one[0], {k: f[k] for k in f.files})
    return gold, ernie, ranks, out


@pytest.mark.parametrize("tag", [t for t, _, _ in W.PLANS])
def test_gpt_hybrid_plan_across_processes(runs, tag):
    gold, _, ranks, out = runs
    jax_losses, one_losses, one_leaves = gold[tag]
    leaves = {}
    for r in ranks:
        got = r["gpt"][tag]
        np.testing.assert_allclose(got["losses"], one_losses, rtol=1e-6)
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5)
        with np.load(out / f"gpt_{tag}_rank{r['rank']}.npz") as f:
            leaves.update({k: f[k] for k in f.files})
    assert sorted(leaves) == sorted(one_leaves)
    assert sorted({int(k.split("/")[0]) for k in leaves}) == list(range(8))
    for k, want in one_leaves.items():
        assert leaves[k].shape == want.shape, k
        err = np.abs(leaves[k] - want).max() / (np.abs(want).max() + 1e-12)
        assert err <= 1e-6, (k, err)
    assert one_losses[-1] < one_losses[0]


def test_mp_layers_and_split_across_processes(runs):
    for r in runs[2]:
        errs = r["mp_layers"]
        split = errs.pop("split")
        assert set(errs) == {"column_gather", "column_shard", "row_split",
                             "row_parallel_input", "vocab_embedding",
                             "parallel_cross_entropy"}
        for name, e in errs.items():
            for k, v in e.items():
                assert v < 1e-6, (r["rank"], name, k, v)
        assert all(v < 1e-6 for v in split.values()), split


def test_model_mp_across_processes_matches_reference(runs):
    _, ernie, ranks, _ = runs
    for r in ranks:
        m = r["model_mp"]
        assert m["mp_rank"] == r["rank"] and m["fc1_shape"] == [16, 16]
        np.testing.assert_allclose(m["losses"], ernie, rtol=5e-4, atol=1e-5)
    assert ranks[0]["model_mp"]["losses"] == ranks[1]["model_mp"]["losses"]


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_group_sharded_across_processes(runs, level):
    import paddle_tpu_torch as pt
    _, _, ranks, out = runs
    for r in ranks:
        s = r["sharded"][level]
        assert max(s["param_err"].values()) < 1e-5, s["param_err"]
        # Linear(8, 64): its 64 columns split over sharding=2
        assert s["state_rows"] == [[8, 32], [8, 32]]
        assert s["rows_shape"] == ([8, 32] if level == "p_g_os" else [8, 64])
        saved = pt.framework.io.load(
            str(out / f"{level}_{r['rank']}" / "model.pdmodel"),
            return_numpy=True)
        assert list(saved["0.weight"].shape) == [8, 64]
        assert s["saved_moment_shape"] == [8, 64]
        assert len(s["saved_state_err"]) == 12, s["saved_state_err"]
        assert max(s["saved_state_err"].values()) < 1e-5, \
            s["saved_state_err"]
        assert max(s["restored_param_err"].values()) < 1e-5, \
            s["restored_param_err"]


def test_topology_under_the_process_group(runs):
    for r in runs[2]:
        me = r["rank"]
        assert r["world"] == 2
        assert r["topology"]["dp"] == [me, 2, True, 3.0, "data", me, 2]
        assert r["topology"]["mp"] == [me, 0, 2, 20.0, "model", [me]]


def test_ranks_imported_no_jax(runs):
    assert all(r["jax_free"] for r in runs[2])
