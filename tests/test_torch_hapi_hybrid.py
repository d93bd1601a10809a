"""`Model`'s mp and pp routes and the pipeline runner, one process, held
to the JAX package (the counterparts of every test of
`tests/test_hapi_hybrid.py`).

Each test builds its network in both packages, carries the JAX weights
over, and runs the same batches on the same mesh dims: the JAX package on
its 8 virtual CPU devices, the port with one controller over a mesh of
ranks on the CPU. The losses, gradients and buffers are held to the JAX
package's at the reference test's own tolerance. Where the reference
test asserts device placement, the port's recorded partition spec is held
to the reference's `sharding.spec`.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu_torch as pt
from torch_jax_init import numpy_initializers


@pytest.fixture(autouse=True)
def meshes(monkeypatch):
    """Both packages' global mesh and fleet state restored after a test."""
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu_torch.distributed import env as penv
    for env in (jenv, penv):
        monkeypatch.setattr(env, "_global_mesh", None)
        monkeypatch.setattr(env, "_initialized", False)
    pt.set_device("cpu")
    with numpy_initializers():
        yield


def jx():
    import paddle_tpu as pj
    return pj


def mod(P, path):
    """The module `path` of package P."""
    return importlib.import_module(f"{P.__name__}.{path}")


def carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


def tiny_ernie(P):
    nn = P.nn
    mp = mod(P, "distributed.fleet.layers.mp_layers")

    class TinyErnieBlock(nn.Layer):
        def __init__(self, hidden, ffn):
            super().__init__()
            self.ln = nn.LayerNorm(hidden)
            self.fc1 = mp.ColumnParallelLinear(hidden, ffn,
                                               gather_output=False)
            self.act = nn.GELU()
            self.fc2 = mp.RowParallelLinear(ffn, hidden,
                                            input_is_parallel=True)

        def forward(self, x):
            return x + self.fc2(self.act(self.fc1(self.ln(x))))

    class TinyErnie(nn.Layer):
        def __init__(self, vocab=64, hidden=16, ffn=32, n_cls=4):
            super().__init__()
            self.emb = nn.Embedding(vocab, hidden)
            self.b1 = TinyErnieBlock(hidden, ffn)
            self.b2 = TinyErnieBlock(hidden, ffn)
            self.head = nn.Linear(hidden, n_cls)

        def forward(self, ids):
            h = self.emb(ids)
            h = self.b2(self.b1(h))
            return self.head(h.mean(axis=1))
    return TinyErnieBlock, TinyErnie


def both(factory, seed):
    """factory(P) built in both packages, the JAX weights carried over."""
    pj = jx()
    pj.seed(seed)
    jnet = factory(pj)
    pnet = factory(pt)
    carry(jnet, pnet)
    return {pj: jnet, pt: pnet}


def ernie_losses(P, net, n_steps=4):
    m = P.Model(net)
    m.prepare(P.optimizer.Adam(1e-2, parameters=net.parameters()),
              P.nn.CrossEntropyLoss())
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(n_steps):
        x = rng.randint(0, 64, (8, 12))
        y = rng.randint(0, 4, 8)
        (l,), _ = m.train_batch([x], [y])
        losses.append(l)
    return losses


def test_model_fit_mp_matches_reference():
    """dp=2 x mp=4 (the reference's GSPMD fit; the port's one-controller
    global step) from the same weights: rtol 5e-4, atol 1e-5."""
    nets = both(lambda P: tiny_ernie(P)[1](), 5)
    got = {}
    for P, net in nets.items():
        mod(P, "distributed.env").build_mesh({"dp": 2, "mp": 4})
        got[P] = ernie_losses(P, net)
    np.testing.assert_allclose(got[pt], got[jx()], rtol=5e-4, atol=1e-5)


def test_model_fit_mp_partition_specs_match_reference():
    """The reference shards every parameter it places over mp; the port
    records the same split as `partition_spec`, parameter for
    parameter."""
    nets = both(lambda P: tiny_ernie(P)[1](), 1)
    x = np.random.RandomState(1).randint(0, 64, (8, 12))
    y = np.random.RandomState(2).randint(0, 4, 8)
    for P, net in nets.items():
        mod(P, "distributed.env").build_mesh({"dp": 2, "mp": 4})
        m = P.Model(net)
        m.prepare(P.optimizer.SGD(0.1, parameters=net.parameters()),
                  P.nn.CrossEntropyLoss())
        m.train_batch([x], [y])
    jparams = dict(nets[jx()].named_parameters())
    n_mp = 0
    for n, p in nets[pt].named_parameters():
        want = tuple(jparams[n]._data.sharding.spec)
        assert p.partition_spec == want, (n, p.partition_spec, want)
        n_mp += "mp" in want
    assert n_mp == 6       # fc1 weight and bias, fc2 weight, in 2 blocks


def pipeline_losses(P, pl, dims, micro, batches, lr=0.1):
    mod(P, "distributed.env").build_mesh(dims)
    m = P.Model(pl)
    m.prepare(P.optimizer.SGD(lr, parameters=pl.parameters()),
              P.nn.CrossEntropyLoss(), strategy={"microbatches": micro})
    return [m.train_batch([x], [y])[0][0] for x, y in batches]


def _batches(seed, n, B, d, classes):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, d).astype("float32"), rng.randint(0, classes, B))
            for _ in range(n)]


def test_model_fit_pp_pipeline_layer():
    """A PipelineLayer through Model.fit over pp=2 x dp=4, microbatches 4:
    each step's loss against the reference's (rtol 2e-5, atol 1e-6)."""
    def make(P):
        nn = mod(P, "distributed.fleet.meta_parallel")
        return nn.PipelineLayer(
            [nn.LayerDesc(P.nn.Linear, 12, 32), nn.LayerDesc(P.nn.ReLU),
             nn.LayerDesc(P.nn.Linear, 32, 32), nn.LayerDesc(P.nn.ReLU),
             nn.LayerDesc(P.nn.Linear, 32, 4)],
            num_stages=2, loss_fn=P.nn.CrossEntropyLoss())
    nets = both(make, 7)
    batches = _batches(3, 3, 16, 12, 4)
    got = {P: pipeline_losses(P, pl, {"dp": 4, "pp": 2}, 4, batches)
           for P, pl in nets.items()}
    np.testing.assert_allclose(got[pt], got[jx()], rtol=2e-5, atol=1e-6)


def _mp_pipe(P, blocks):
    nn = mod(P, "distributed.fleet.meta_parallel")
    block = tiny_ernie(P)[0]
    return nn.PipelineLayer(
        [nn.LayerDesc(P.nn.Linear, 12, 16)]
        + [nn.LayerDesc(block, 16, 32) for _ in range(blocks)]
        + [nn.LayerDesc(P.nn.Linear, 16, 4)],
        num_stages=2, loss_fn=P.nn.CrossEntropyLoss())


@pytest.mark.parametrize("dims,blocks,seed,steps", [
    ({"pp": 2, "mp": 2}, 2, 11, 3),
    ({"dp": 2, "pp": 2, "mp": 2}, 1, 13, 2)], ids=["mp_x_pp", "mp_x_pp_x_dp"])
def test_model_fit_mp_x_pp_parity(dims, blocks, seed, steps):
    """Pipelines whose stages hold fleet mp layers through Model.fit,
    microbatches 2: the port's stage bodies run the mp layers' ranks in a
    manual region; each loss against the reference's (rtol 2e-4, atol
    1e-5)."""
    nets = both(lambda P: _mp_pipe(P, blocks), seed)
    batches = _batches(9 if blocks == 2 else 17, steps, 8, 12, 4)
    got = {P: pipeline_losses(P, pl, dims, 2, batches)
           for P, pl in nets.items()}
    np.testing.assert_allclose(got[pt], got[jx()], rtol=2e-4, atol=1e-5)


def step_both(nets, dims, M, x, y):
    """Each package's pipeline step on the same params: (loss, grads,
    new buffers) as numpy, keyed by package."""
    from paddle_tpu.distributed.fleet.meta_parallel.pp_compiled import \
        make_compiled_pipeline_step as jmake
    from paddle_tpu.nn.layer.layers import functional_state as jstate
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_compiled \
        import make_compiled_pipeline_step as pmake
    from paddle_tpu_torch.nn.layer.layers import functional_state as pstate
    import torch
    out = {}
    for P, pl in nets.items():
        mod(P, "distributed.env").build_mesh(dims)
        mesh = mod(P, "distributed.env").get_mesh()
        if P is pt:
            step = pmake(pl, mesh, microbatches=M)
            params, buffers = pstate(pl)
            loss, grads, nb = step(params, buffers, torch.from_numpy(x),
                                   torch.from_numpy(y))
            conv = (lambda t: None if t is None else
                    t.detach().double().numpy())
        else:
            step = jmake(pl, mesh, microbatches=M)
            params, buffers = jstate(pl)
            loss, grads, nb = step(params, buffers, x, y)
            conv = (lambda a: np.asarray(a, np.float64))
        out[P] = (float(loss), {n: conv(g) for n, g in grads.items()},
                  {n: conv(b) for n, b in nb.items()}, buffers)
    return out


def test_pipeline_bn_buffers_written_back():
    """BatchNorm's running statistics through the pipeline: per
    microbatch, in schedule order, each stage its own; against the
    reference's step (rtol 1e-4, atol 1e-5), and both stages' moved."""
    def make(P):
        nn = mod(P, "distributed.fleet.meta_parallel")
        return nn.PipelineLayer(
            [nn.LayerDesc(P.nn.Linear, 6, 8),
             nn.LayerDesc(P.nn.BatchNorm1D, 8), nn.LayerDesc(P.nn.ReLU),
             nn.LayerDesc(P.nn.Linear, 8, 8),
             nn.LayerDesc(P.nn.BatchNorm1D, 8),
             nn.LayerDesc(P.nn.Linear, 8, 3)],
            num_stages=2, loss_fn=P.nn.CrossEntropyLoss())
    rng = np.random.RandomState(0)
    x = rng.rand(8, 6).astype("float32")
    y = rng.randint(0, 3, 8)
    got = step_both(both(make, 31), {"pp": 2}, 2, x, y)
    (pl_, pg, pb, b0), (jl, jg, jb, _) = got[pt], got[jx()]
    np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    changed = 0
    for n in jb:
        np.testing.assert_allclose(pb[n], jb[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
        changed += not np.allclose(pb[n], b0[n].double().numpy())
    assert changed >= 2
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], rtol=2e-4, atol=2e-5,
                                   err_msg=n)


def test_pipeline_buffer_dependent_forward_grads():
    """A stage whose forward reads a buffer it also updates: the backward
    recompute replays the buffers its forward saw; loss, gradients and
    buffers against the reference's step."""
    def make(P):
        nn = mod(P, "distributed.fleet.meta_parallel")

        class ScaleDrift(P.nn.Layer):
            def __init__(self, dim):
                super().__init__()
                self.lin = P.nn.Linear(dim, dim)
                self.register_buffer("scale", P.to_tensor(
                    np.ones((1,), "float32")))

            def forward(self, x):
                out = self.lin(x) * self.scale
                if self.training:
                    self.scale._data = self.scale._data * 1.1
                return out
        return nn.PipelineLayer(
            [nn.LayerDesc(ScaleDrift, 6), nn.LayerDesc(P.nn.ReLU),
             nn.LayerDesc(ScaleDrift, 6), nn.LayerDesc(P.nn.Linear, 6, 3)],
            num_stages=2, loss_fn=P.nn.CrossEntropyLoss())
    rng = np.random.RandomState(1)
    x = rng.rand(8, 6).astype("float32")
    y = rng.randint(0, 3, 8)
    got = step_both(both(make, 41), {"pp": 2}, 2, x, y)
    (pl_, pg, pb, _), (jl, jg, jb, _) = got[pt], got[jx()]
    np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    for n in jb:
        np.testing.assert_allclose(pb[n], jb[n], rtol=1e-5, err_msg=n)


def test_pipeline_shared_layer_with_buffers_rejected():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_compiled \
        import make_compiled_pipeline_step
    nn = pt.nn
    pt.distributed.env.build_mesh({"pp": 2})
    descs = [SharedLayerDesc("tiedbn", nn.BatchNorm1D, forward_func=None,
                             shared_weight_attr="weight", num_features=6),
             LayerDesc(nn.Linear, 6, 6), LayerDesc(nn.ReLU),
             SharedLayerDesc("tiedbn", nn.BatchNorm1D, forward_func=None,
                             shared_weight_attr="weight", num_features=6)]
    pl = PipelineLayer(descs, num_stages=2, loss_fn=nn.MSELoss())
    with pytest.raises(ValueError, match="shared across pipeline stages"):
        make_compiled_pipeline_step(pl, pt.distributed.env.get_mesh(),
                                    microbatches=2)


def test_sync_batch_norm_grads_match_reference():
    """SyncBatchNorm: the reference's dp=2 shard_map gradients (the mean
    of the ranks' gradients of their own sums) are half the full batch's;
    the port's one-process SyncBatchNorm computes the full batch (rtol
    1e-4, atol 1e-5)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.nn.layer.layers import functional_call, functional_state

    def make(Pk):
        nn = Pk.nn
        return nn.Sequential(nn.Linear(6, 4), nn.SyncBatchNorm(4),
                             nn.Linear(4, 2))
    nets = both(make, 3)
    jnet = nets[jx()]
    mesh = jenv.build_mesh({"dp": 2})
    params, buffers = functional_state(jnet)
    x = np.random.RandomState(0).rand(8, 6).astype("float32")

    def loss_local(p, xx):
        with jenv.axis_context(dp="dp"):
            out, _ = functional_call(jnet, p, buffers, args=(Tensor(xx),),
                                     train=True)
        return jnp.sum(out._data ** 2)

    g = jax.jit(jax.shard_map(
        lambda p, xx: jax.tree_util.tree_map(
            lambda v: jax.lax.pmean(v, "dp"), jax.grad(loss_local)(p, xx)),
        mesh=mesh, in_specs=(P(), P("dp")), out_specs=P(),
        check_vma=False))(params, x)
    pnet = nets[pt]
    (pnet(pt.to_tensor(x)) ** 2).sum().backward()
    for n, p in pnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), 2 * np.asarray(g[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_pipeline_sync_bn_stats():
    """SyncBatchNorm in a dp=2 x pp=2 pipeline: the port's microbatch is
    the dp shards' union, whose statistics the reference syncs; buffers
    against the reference's step (rtol 1e-4, atol 1e-5)."""
    def make(P):
        nn = mod(P, "distributed.fleet.meta_parallel")
        return nn.PipelineLayer(
            [nn.LayerDesc(P.nn.Linear, 6, 8),
             nn.LayerDesc(P.nn.SyncBatchNorm, 8), nn.LayerDesc(P.nn.ReLU),
             nn.LayerDesc(P.nn.Linear, 8, 3)],
            num_stages=2, loss_fn=P.nn.CrossEntropyLoss())
    rng = np.random.RandomState(2)
    x = rng.rand(8, 6).astype("float32")
    y = rng.randint(0, 3, 8)
    got = step_both(both(make, 47), {"dp": 2, "pp": 2}, 2, x, y)
    (pl_, _, pb, _), (jl, _, jb, _) = got[pt], got[jx()]
    np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    for n in jb:
        np.testing.assert_allclose(pb[n], jb[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_row_parallel_input_split_grads():
    """RowParallelLinear(input_is_parallel=False) in a manual region over
    mp=2: the port's ranks split the input and sum their partial
    products; the replicated upstream layer gets the whole cotangent.
    Gradients against the reference's shard_map gradients (rtol 1e-4,
    atol 1e-5)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.nn.layer.layers import functional_call, functional_state
    from paddle_tpu_torch.distributed import env as penv

    def make(Pk):
        mp = mod(Pk, "distributed.fleet.layers.mp_layers")

        class Net(Pk.nn.Layer):
            def __init__(self):
                super().__init__()
                self.pre = Pk.nn.Linear(8, 8)
                self.row = mp.RowParallelLinear(8, 4, input_is_parallel=False)

            def forward(self, x):
                return self.row(self.pre(x))
        return Net()
    nets = both(make, 2)
    jnet = nets[jx()]
    mesh = jenv.build_mesh({"mp": 2})
    params, buffers = functional_state(jnet)
    x = np.random.RandomState(0).rand(4, 8).astype("float32")

    def loss_local(p, xx):
        with jenv.axis_context(mp="mp"):
            out, _ = functional_call(jnet, p, buffers, args=(Tensor(xx),),
                                     train=True)
        return jnp.sum(out._data ** 2)

    specs = {"pre.weight": P(), "pre.bias": P(),
             "row.weight": P("mp", None), "row.bias": P()}
    g = jax.jit(jax.shard_map(
        lambda p, xx: jax.grad(loss_local)(p, xx), mesh=mesh,
        in_specs=(specs, P()), out_specs=specs, check_vma=False))(params, x)
    penv.build_mesh({"mp": 2})
    pnet = nets[pt]
    with penv.axis_context(mp="mp"):
        out = pnet(pt.to_tensor(x))
    (out ** 2).sum().backward()
    for n, p in pnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_model_fit_ernie_tiny_pipeline():
    """ERNIE-tiny as a PipelineLayer (the embedding tied to the MLM head
    across the first and last stage) through Model.fit over dp=2 x pp=2 x
    mp=2, microbatches 2: each loss against the reference's (rtol 5e-4,
    atol 1e-5)."""
    def mlm_loss_of(P):
        def mlm_loss(logits, labels):
            return P.nn.functional.cross_entropy(
                logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1]))
        return mlm_loss

    def make(P):
        tm = mod(P, "text.models.ernie")
        cfg = tm.ernie_tiny_config(hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
        loss = mlm_loss_of(P)
        return mod(P, "distributed.fleet.meta_parallel").PipelineLayer(
            tm.ernie_pipeline_descs(cfg, loss_fn=loss), num_stages=2,
            loss_fn=loss)
    nets = both(make, 21)
    rng = np.random.RandomState(5)
    batches = [(rng.randint(0, 1000, (8, 16)), rng.randint(0, 1000, (8, 16)))
               for _ in range(2)]
    got = {}
    for P, pl in nets.items():
        mod(P, "distributed.env").build_mesh({"dp": 2, "pp": 2, "mp": 2})
        m = P.Model(pl)
        m.prepare(P.optimizer.SGD(0.05, parameters=pl.parameters()), None,
                  strategy={"microbatches": 2})
        got[P] = [m.train_batch([x], [y])[0][0] for x, y in batches]
    np.testing.assert_allclose(got[pt], got[jx()], rtol=5e-4, atol=1e-5)
