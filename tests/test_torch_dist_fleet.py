"""Fleet across processes: sp, GPipe, the interleaved schedule and the
pipeline runner over two processes, against the JAX package and the
port's one controller.

One module-scoped job: the port's launcher (`distributed.launch`, in this
process) starts two ranks of `tests/torch_dist_fleet_worker.py`, which
join a gloo process group on the CPU (each rank kills itself after its
own timeout). The reference's goldens are computed here on its 8 virtual
CPU devices while the ranks run; the port's one-controller goldens by the
ranks once their process group is gone.

  * `gpt_spmd` with sp (ring and Ulysses) or pp (GPipe, vpp=2) across the
    processes: losses and every leaf of every rank equal to the port's
    one-controller plan bit for bit, and losses at rtol 1e-5 against the
    reference's `make_train_step` on the same plan;
  * the partial-sum reduction where a group holds two members a process
    (dp4 x mp2 with dp across): one step's losses at rtol 1e-6 and every
    leaf within 1e-6 of the leaf's largest magnitude of one controller's;
  * `Model` over a fleet `PipelineLayer`, one stage a process (the pp
    tests of tests/test_hapi_hybrid.py): losses at those tests'
    tolerances against the same network trained serially, and losses and
    each stage's parameters equal to the one-controller pipeline's;
  * `Model` with dp across the processes and mp within them, and with mp
    across them two ranks a process, against the reference's one-process
    mp `Model` losses (rtol 5e-4 as tests/test_hapi_hybrid.py);
  * the ranks imported no JAX.
"""
import json
import os

import numpy as np
import pytest

import torch_dist_fleet_worker as W
from test_torch_dist_hybrid import jax_ernie, jax_gpt_golden

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start first and wait for each input as they need it; the
    reference's plans are computed here meanwhile, in threads (their
    compiles overlap), beside the ERNIE losses."""
    import functools
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import jax
    from paddle_tpu.parallel import gpt_spmd as jgs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.launch import launch
    pt.set_device("cpu")
    out = tmp_path_factory.mktemp("port_fleet")
    rc = []
    job = threading.Thread(target=lambda: rc.append(launch([
        "--nproc_per_node", "2",
        os.path.join(HERE, "torch_dist_fleet_worker.py"), str(out)])))
    job.start()
    eager = jgs.init_gpt_params
    jgs.init_gpt_params = lambda c, key: jax.jit(
        functools.partial(eager, c))(key)
    try:
        ernie = jax_ernie(str(out))
        with ThreadPoolExecutor(len(W.PLANS)) as pool:
            jax_gold = {tag: pool.submit(jax_gpt_golden, tag, plan, str(out))
                        for tag, plan, _ in W.PLANS}
            jax_losses = {tag: f.result()[0] for tag, f in jax_gold.items()}
    finally:
        jgs.init_gpt_params = eager
        job.join(timeout=W.TIMEOUT_S + 60)
    assert rc == [0], f"a rank failed: {rc}"
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    return jax_losses, ernie, ranks, out


def _leaves(out, prefix):
    got = {}
    for r in range(2):
        with np.load(out / f"{prefix}_rank{r}.npz") as f:
            got.update({k: f[k] for k in f.files})
    return got


def _one(ranks, out, tag):
    one = [r["one_controller"][tag] for r in ranks
           if tag in r["one_controller"]]
    assert len(one) == 1, tag
    with np.load(out / f"one_{tag}.npz") as f:
        return one[0], {k: f[k] for k in f.files}


@pytest.mark.parametrize("tag", [t for t, _, _ in W.PLANS])
def test_gpt_sp_and_pipeline_across_processes(runs, tag):
    jax_losses, _, ranks, out = runs
    one_losses, one_leaves = _one(ranks, out, tag)
    for r in ranks:
        assert r["gpt"][tag]["losses"] == one_losses
        np.testing.assert_allclose(r["gpt"][tag]["losses"],
                                   jax_losses[tag], rtol=1e-5)
    leaves = _leaves(out, f"gpt_{tag}")
    assert sorted(leaves) == sorted(one_leaves)
    assert sorted({int(k.split("/")[0]) for k in leaves}) == list(range(8))
    for k, want in one_leaves.items():
        np.testing.assert_array_equal(leaves[k], want, err_msg=k)
    assert one_losses[-1] < one_losses[0]


def test_partial_sums_within_tolerance_of_one_controller(runs):
    _, _, ranks, out = runs
    tag = W.TOL_PLAN[0]
    one_losses, one_leaves = _one(ranks, out, tag)
    leaves = _leaves(out, f"gpt_{tag}")
    assert sorted(leaves) == sorted(one_leaves)
    for r in ranks:
        np.testing.assert_allclose(r["gpt"][tag]["losses"], one_losses,
                                   rtol=1e-6)
    for k, want in one_leaves.items():
        err = np.abs(leaves[k] - want).max() / (np.abs(want).max() + 1e-12)
        assert err <= 1e-6, (k, err)


@pytest.mark.parametrize("case", W.PP_CASES, ids=[c[0] for c in W.PP_CASES])
def test_model_pipeline_one_stage_a_process(runs, case):
    _, _, ranks, out = runs
    tag = case[0]
    # tests/test_hapi_hybrid.py's tolerances: dp x pp, then mp x pp
    rtol, atol = (2e-5, 1e-6) if tag == "dp4_pp2" else (2e-4, 1e-5)
    stages = []
    for r in ranks:
        got = r["pp"][tag]["losses"]
        np.testing.assert_allclose(got, r["pp_serial"][tag], rtol=rtol,
                                   atol=atol)
        assert got == r["pp_one"][tag]
        with np.load(out / f"pp_{tag}_rank{r['rank']}.npz") as f, \
                np.load(out / f"pp_one_{tag}_rank{r['rank']}.npz") as g, \
                np.load(out / f"pp_serial_{tag}_rank{r['rank']}.npz") as h:
            assert sorted(f.files) == r["pp"][tag]["stage_params"]
            stages.append(set(f.files))
            for k in f.files:
                np.testing.assert_array_equal(f[k], g[k], err_msg=k)
                np.testing.assert_allclose(f[k], h[k], rtol=rtol, atol=atol)
    # each process ran its own stage, and the two cover the network
    assert stages[0] and stages[1] and not stages[0] & stages[1]


@pytest.mark.parametrize("case", W.MODEL_CASES,
                         ids=[c[0] for c in W.MODEL_CASES])
def test_model_dp_and_mp_across_processes(runs, case):
    _, ernie, ranks, _ = runs
    tag = case[0]
    for r in ranks:
        m = r["model"][tag]
        np.testing.assert_allclose(m["losses"], ernie, rtol=5e-4, atol=1e-5)
        # fc1's 32 columns: whole with mp in a process, else the
        # process's two of four mp blocks
        assert m["fc1_shape"] == ([16, 32] if "dp_cross" in tag
                                  else [16, 16])
    assert ranks[0]["model"][tag]["losses"] == \
        ranks[1]["model"][tag]["losses"]


def test_ranks_imported_no_jax(runs):
    assert all(r["jax_free"] for r in runs[2])
