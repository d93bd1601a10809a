"""`incubate.distributed.moe` and `distributed.auto_parallel` of the port
against the JAX package, on the CPU: the counterparts of every test of
`tests/test_moe.py` and `tests/test_auto_parallel.py`.

The same numpy inputs and weights go through both packages: routing,
outputs and gradients at f32 tolerances (1e-5 unless stated; 1e-4 where
the reference test uses it). Expert parallelism in the port is a
one-controller manual region: one value a rank of the ep group and the
list all_to_all each way.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.distributed import moe as pmoe
from torch_jax_init import numpy_initializers


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu_torch.distributed import env as penv
    for env in (jenv, penv):
        monkeypatch.setattr(env, "_global_mesh", None)
        monkeypatch.setattr(env, "_initialized", False)
    pt.set_device("cpu")
    with numpy_initializers():
        yield


def jmoe():
    from paddle_tpu.incubate.distributed import moe
    return moe


def jmoe_forward(x, gw, params, **kw):
    """The reference's moe_forward on numpy inputs, compiled once."""
    import functools
    import jax
    import jax.numpy as jnp
    fn = jax.jit(functools.partial(jmoe().moe_forward, **kw))
    return fn(jnp.asarray(x), jnp.asarray(gw),
              {k: jnp.asarray(v) for k, v in params.items()})


def _experts(seed, E, d, h):
    rng = np.random.RandomState(seed)
    return {"w1": rng.uniform(-0.3, 0.3, (E, d, h)).astype("float32"),
            "b1": rng.uniform(-0.1, 0.1, (E, h)).astype("float32"),
            "w2": rng.uniform(-0.3, 0.3, (E, h, d)).astype("float32"),
            "b2": rng.uniform(-0.1, 0.1, (E, d)).astype("float32")}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_dispatch_matches_reference():
    """combine, dispatch and the aux loss equal the reference's on the
    same gates; each (expert, slot) holds one token at most, each expert
    at most C, routed weights sum to 1."""
    import jax
    import jax.numpy as jnp
    T, E, C, k = 32, 4, 4, 2
    rng = np.random.RandomState(0)
    logits = rng.randn(T, E).astype("float32")
    gates = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jc, jd, ja = jax.jit(jmoe().gshard_dispatch, static_argnums=(1, 2))(
        jnp.asarray(gates), k, C)
    pc, pd, pa = pmoe.gshard_dispatch(torch.from_numpy(gates), k, C)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(pa), float(ja), rtol=1e-6)
    d = pd.numpy()
    assert d.sum(0).max() <= 1 and d.sum((0, 2)).max() <= C
    routed = d.any((1, 2))
    np.testing.assert_allclose(pc.numpy().sum((1, 2))[routed], 1.0,
                               atol=1e-5)
    assert pmoe.compute_capacity(1.2, 2, 37, 4) == \
        jmoe().functional.compute_capacity(1.2, 2, 37, 4)


def test_capacity_drops_overflow():
    T, E, C = 16, 4, 3
    gates = torch.tensor([[0.97, 0.01, 0.01, 0.01]]).repeat(T, 1)
    _, dispatch, _ = pmoe.gshard_dispatch(gates, 1, C)
    assert int(dispatch[:, 0, :].sum()) == C


def test_moe_matches_dense_single_expert_and_reference():
    """E=1, k=1, capacity >= T: the routed FFN is the plain FFN; and the
    dense moe_forward equals the reference's on the same weights."""
    import jax.numpy as jnp
    T, d, h = 16, 8, 32
    x = np.random.RandomState(1).randn(T, d).astype("float32")
    params = _experts(2, 1, d, h)
    out, _ = pmoe.moe_forward(torch.from_numpy(x), torch.zeros(d, 1),
                              _t(params), k=1, capacity_factor=float(T))
    ref = torch.nn.functional.gelu(
        torch.from_numpy(x @ params["w1"][0] + params["b1"][0]),
        approximate="tanh").numpy() @ params["w2"][0] + params["b2"][0]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    E = 4
    params = _experts(3, E, d, h)
    gw = np.random.RandomState(4).randn(d, E).astype("float32") * 0.1
    po, pa = pmoe.moe_forward(torch.from_numpy(x), torch.from_numpy(gw),
                              _t(params), k=2, capacity_factor=1.0)
    jo, ja = jmoe_forward(x, gw, params, k=2, capacity_factor=1.0)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(float(pa), float(ja), rtol=1e-5)


def _ep_case(T, d, h, E, seeds):
    rng = np.random.RandomState(seeds[0])
    x = rng.randn(T, d).astype("float32")
    gw = np.random.RandomState(seeds[1]).randn(d, E).astype("float32") * 0.1
    return x, gw, _experts(seeds[2], E, d, h)


def test_expert_parallel_matches_local():
    """ep=4 in a manual region (each rank the whole tokens and E/ep
    experts, the list all_to_all each way): every rank's output and aux
    loss equal the single-rank computation over the whole expert stack
    (atol 1e-4, rtol 1e-4), which equals the reference's."""
    import jax.numpy as jnp
    T, d, h, E, ep = 64, 16, 32, 8, 4
    x, gw, params = _ep_case(T, d, h, E, (3, 4, 5))
    ref, ref_aux = pmoe.moe_forward(torch.from_numpy(x), torch.from_numpy(gw),
                                    _t(params), k=2, capacity_factor=2.0)
    shards = [{k: torch.from_numpy(v[r * (E // ep):(r + 1) * (E // ep)])
               for k, v in params.items()} for r in range(ep)]
    got = pmoe.moe_forward([torch.from_numpy(x)] * ep,
                           [torch.from_numpy(gw)] * ep, shards, k=2,
                           capacity_factor=2.0, axis_name="ep",
                           num_experts=E)
    for out, aux in got:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-5)
    jo, _ = jmoe_forward(x, gw, params, k=2, capacity_factor=2.0)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jo), atol=1e-5)


def test_expert_parallel_grads():
    """Every rank computes the same loss over the same tokens, and the
    all_to_all's transpose sums the ep identical cotangent streams into
    the expert owners: the ep gradients are exactly ep x the local ones
    (atol 1e-4, rtol 1e-4), as the reference's."""
    T, d, h, E, ep = 32, 8, 16, 4, 4
    x, gw, params = _ep_case(T, d, h, E, (6, 7, 8))
    full = {k: torch.from_numpy(v).requires_grad_() for k, v in
            params.items()}
    out, aux = pmoe.moe_forward(torch.from_numpy(x), torch.from_numpy(gw),
                                full, k=2, capacity_factor=2.0)
    ((out ** 2).sum() + 0.01 * aux).backward()
    shards = [{k: torch.from_numpy(v[r:r + 1].copy()).requires_grad_()
               for k, v in params.items()} for r in range(ep)]
    got = pmoe.moe_forward([torch.from_numpy(x)] * ep,
                           [torch.from_numpy(gw)] * ep, shards, k=2,
                           capacity_factor=2.0, axis_name="ep",
                           num_experts=E)
    sum((o ** 2).sum() + 0.01 * a for o, a in got).backward()
    for name in ("w1", "b1", "w2", "b2"):
        g = torch.cat([s[name].grad for s in shards]).numpy()
        np.testing.assert_allclose(g, ep * full[name].grad.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_moe_grad_clip_matches_reference():
    """ClipGradForMOEByGlobalNorm with one expert parameter equals the
    plain global-norm clip, and the reference's clip, and the clipped
    norm is the clip norm."""
    import paddle_tpu as pj
    rng = np.random.RandomState(0)
    vals = [(rng.rand(*s).astype("float32"),
             rng.rand(*s).astype("float32") * 3)
            for s in [(4, 4), (8,), (3, 5)]]
    got = {}
    for P, m in ((pt, pmoe), (pj, jmoe())):
        ps = [P.to_tensor(p) for p, _ in vals]
        pairs = list(zip(ps, [P.to_tensor(g) for _, g in vals]))
        clipped = m.ClipGradForMOEByGlobalNorm(
            1.0, is_expert_param_func=lambda p: p is ps[2])(pairs)
        plain = P.nn.ClipGradByGlobalNorm(1.0)(pairs)
        for (_, a), (_, b) in zip(clipped, plain):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        got[P] = [g.numpy() for _, g in clipped]
    for a, b in zip(got[pt], got[pj]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    total = np.sqrt(sum(float((g ** 2).sum()) for g in got[pt]))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_eager_moe_layer_trains_like_reference():
    """MoELayer (gshard) trained with Adam from the reference's weights:
    the expert weights get gradients, the loss falls, and the losses
    follow the reference's (rtol 1e-4)."""
    import paddle_tpu as pj
    pj.seed(0)
    jl = jmoe().MoELayer(d_model=8, d_hidden=16, num_experts=4,
                         gate="gshard")
    pl = pmoe.MoELayer(d_model=8, d_hidden=16, num_experts=4, gate="gshard")
    assert list(pl.state_dict()) == list(jl.state_dict())
    pl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})
    rng = np.random.RandomState(0)
    xv = rng.rand(32, 8).astype("float32")
    tv = rng.rand(32, 8).astype("float32")
    got = {}
    for P, layer in ((pj, jl), (pt, pl)):
        o = P.optimizer.Adam(1e-2, parameters=layer.parameters())
        x, target = P.to_tensor(xv), P.to_tensor(tv)
        losses = []
        for step in range(4):
            loss = ((layer(x) - target) ** 2).mean() + 0.01 * layer.aux_loss
            loss.backward()
            if step == 0:
                assert float(np.abs(layer.w1.grad.numpy()).max()) > 0
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        got[P] = losses
    assert got[pt][-1] < got[pt][0]
    np.testing.assert_allclose(got[pt], got[pj], rtol=1e-4)


def test_moe_layer_state_dict():
    layer = pmoe.MoELayer(d_model=4, d_hidden=8, num_experts=2,
                          gate="switch")
    sd = layer.state_dict()
    assert any("w1" in k for k in sd) and any("gate" in k for k in sd)
    assert type(layer.gate).__name__ == "SwitchGate" and \
        layer.gate.top_k == 1 and layer.gate.jitter_eps == 0.1
    layer(pt.to_tensor(np.ones((6, 4), "float32")))   # jitter drawn


# ------------------------------------------------------------ auto_parallel

class _RandDataset:
    def __new__(cls, P, n=64, d=8, classes=4):
        class DS(P.io.Dataset):
            def __init__(self):
                rng = np.random.RandomState(0)
                self.x = rng.rand(n, d).astype("float32")
                self.y = (self.x.sum(1) * classes / self.x.sum(1).max()) \
                    .clip(0, classes - 1e-3).astype("int64")

            def __len__(self):
                return len(self.x)

            def __getitem__(self, i):
                return self.x[i], self.y[i]
        return DS()


def _batches(bs=16):
    ds = _RandDataset(pt)
    return [(ds.x[i:i + bs], ds.y[i:i + bs]) for i in range(0, 64, bs)]


def test_process_mesh_shapes():
    ap = pt.distributed.auto_parallel
    pm = ap.ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["dp", "mp"])
    assert pm.shape == [2, 4] and pm.ndim == 2
    assert pm.mesh.axes == ("dp", "mp") and pm.mesh.size == 8
    assert pm.process_ids == list(range(8))


def test_shard_tensor_and_op_annotations_match_reference():
    """shard_tensor records the reference's spec (named and dims_mapping
    forms); shard_op keeps the op's value and annotates its output."""
    import paddle_tpu as pj
    got = {}
    for P in (pt, pj):
        ap = P.distributed.auto_parallel
        pm = ap.ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["x", "y"])
        t = P.to_tensor(np.ones((4, 8), np.float32))
        assert ap.shard_tensor(t, pm, ["x", "y"]) is t
        t2 = ap.shard_tensor(P.to_tensor(np.ones((4, 8), np.float32)),
                             dist_attr={"process_mesh": pm,
                                        "dims_mapping": [0, -1]})
        f = ap.shard_op(P.matmul, ap.ProcessMesh(np.arange(8),
                                                 dim_names=["dp"]),
                        in_shard_specs=[["dp", None], None],
                        out_shard_specs=[["dp", None]])
        out = f(P.to_tensor(np.ones((8, 4), np.float32)),
                P.to_tensor(np.ones((4, 2), np.float32)))
        np.testing.assert_allclose(out.numpy(), np.full((8, 2), 4.0))
        got[P] = [tuple(a._dist_attr[1]) for a in (t, t2, out)]
    assert got[pt] == got[pj] == [("x", "y"), ("x", None), ("dp", None)]


def _engines(opt, strategy=None, seed=0):
    """The reference's and the port's Engine over the same weights."""
    import paddle_tpu as pj
    out = {}
    pj.seed(seed)
    for P in (pj, pt):
        net = P.nn.Sequential(P.nn.Linear(8, 32), P.nn.ReLU(),
                              P.nn.Linear(32, 4))
        if P is pt:
            net.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                                out[pj][0].state_dict().items()})
        ap = P.distributed.auto_parallel
        pm = ap.ProcessMesh(np.arange(8).reshape(4, 2),
                            dim_names=["dp", "mp"])
        ap.shard_tensor(net[0].weight, pm, [None, "mp"])
        st = None
        if strategy is not None:
            st = ap.Strategy()
            strategy(st)
        out[P] = (net, ap.Engine(
            net, loss=P.nn.CrossEntropyLoss(),
            optimizer=opt(P, net.parameters()),
            metrics=P.metric.Accuracy(), strategy=st, process_mesh=pm))
    return out


def test_engine_fit_matches_reference_and_learns():
    """Engine.fit over the same batches: with SGD the port's losses equal
    the reference's (rtol 1e-5); with Adam they fall by 10% (the
    reference's Engine hands Adam a step count one ahead of `Model`'s,
    ROADMAP C.22, so its Adam trajectory is not the port's)."""
    import paddle_tpu as pj
    eng = _engines(lambda P, ps: P.optimizer.SGD(0.05, parameters=ps))
    hist = {P: e.fit(_batches() * 2, epochs=1, verbose=0)["loss"]
            for P, (_, e) in eng.items()}
    np.testing.assert_allclose(hist[pt], hist[pj], rtol=1e-5)
    _, e = _engines(lambda P, ps: P.optimizer.Adam(5e-3, parameters=ps))[pt]
    losses = e.fit(_batches() * 4, epochs=1, verbose=0)["loss"]
    assert losses[-1] < losses[0] * 0.9


def test_engine_evaluate_and_predict_match_reference():
    import paddle_tpu as pj
    eng = _engines(lambda P, ps: P.optimizer.SGD(1e-2, parameters=ps))
    res = {}
    for P, (_, e) in eng.items():
        e.fit(_batches(), epochs=1, verbose=0)
        r = e.evaluate(_batches())
        preds = e.predict(_batches())
        res[P] = (r["loss"], r["acc"], np.asarray(preds[0]))
    assert res[pt][2].shape == (16, 4)
    np.testing.assert_allclose(res[pt][0], res[pj][0], rtol=1e-5)
    assert res[pt][1] == res[pj][1]
    np.testing.assert_allclose(res[pt][2], res[pj][2], rtol=1e-4,
                               atol=1e-5)


def test_engine_save_load_roundtrip(tmp_path):
    ap = pt.distributed.auto_parallel
    pm = ap.ProcessMesh(np.arange(8), dim_names=["dp"])
    net = pt.nn.Linear(8, 4)
    engine = ap.Engine(net, loss=pt.nn.CrossEntropyLoss(),
                       optimizer=pt.optimizer.SGD(
                           1e-2, parameters=net.parameters()),
                       process_mesh=pm)
    engine.fit(_RandDataset(pt), epochs=1, batch_size=16, verbose=0)
    w_after = net.weight.numpy().copy()
    engine.save(str(tmp_path / "ckpt"))
    net2 = pt.nn.Linear(8, 4)
    engine2 = ap.Engine(net2, loss=pt.nn.CrossEntropyLoss(),
                        optimizer=pt.optimizer.SGD(
                            1e-2, parameters=net2.parameters()),
                        process_mesh=pm)
    engine2.load(str(tmp_path / "ckpt"))
    np.testing.assert_allclose(net2.weight.numpy(), w_after)


def test_engine_strategy_amp_recompute():
    """amp (bf16) and recompute: finite losses, and recompute alone keeps
    the plain engine's losses."""
    def amp_rc(st):
        st.amp.enable = True
        st.recompute.enable = True

    def rc(st):
        st.recompute.enable = True
    _, e = _engines(lambda P, ps: P.optimizer.Adam(5e-3, parameters=ps),
                    amp_rc)[pt]
    assert np.isfinite(e.fit(_batches(), epochs=2, verbose=0)["loss"][-1])
    _, e1 = _engines(lambda P, ps: P.optimizer.Adam(5e-3, parameters=ps),
                     rc)[pt]
    _, e0 = _engines(lambda P, ps: P.optimizer.Adam(5e-3, parameters=ps))[pt]
    np.testing.assert_allclose(e1.fit(_batches(), verbose=0)["loss"],
                               e0.fit(_batches(), verbose=0)["loss"],
                               rtol=1e-6)
