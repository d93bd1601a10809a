"""The port's `amp` against the JAX package's, on the CPU.

`auto_cast` (O1) writes the AMP state and casts nothing in either
package, so an O1 region computes what the same code computes outside it
(ROADMAP C.15). `decorate(level="O2")` casts the float parameters to
bfloat16, each parameter keeping its identity and staying a trainable
leaf; training under it is held to the JAX package's at bf16's 2e-2.
`GradScaler` runs the dynamic-scale algorithm step for step with the
JAX one, skipping the step whose gradients hold an injected inf.
"""
import numpy as np
import pytest

BF16 = 2e-2


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _net(P, state=None):
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.GELU(),
                          P.nn.LayerNorm(16), P.nn.Linear(16, 4))
    if state is not None:
        net.set_state_dict(state)
    return net


def _data(P):
    rng = np.random.RandomState(0)
    return (P.to_tensor(rng.randn(6, 8).astype(np.float32)),
            P.to_tensor(rng.randint(0, 4, (6,)).astype(np.int64)))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_casts_nothing(cpu, level):
    import paddle_tpu as pj
    pt = cpu
    state = {k: v.numpy() for k, v in _net(pj).state_dict().items()}
    outs = {}
    for P in (pj, pt):
        net = _net(P, state)
        x, y = _data(P)
        plain = P.nn.functional.cross_entropy(net(x), y)
        plain.backward()
        g_plain = net[0].weight.grad.numpy()
        net.clear_gradients()
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            assert P.amp.amp_state()["enable"] is True
            assert P.amp.amp_state()["level"] == level
            out = net(x)
            loss = P.nn.functional.cross_entropy(out, y)
        assert P.amp.amp_state()["enable"] is False
        assert "float32" in str(out.dtype)
        loss.backward()
        np.testing.assert_array_equal(loss.numpy(), plain.numpy())
        np.testing.assert_array_equal(net[0].weight.grad.numpy(), g_plain)
        outs[P.__name__] = loss.numpy()
    np.testing.assert_allclose(outs["paddle_tpu_torch"], outs["paddle_tpu"],
                               rtol=1e-5, atol=1e-5)


def test_auto_cast_nests_and_restores(cpu):
    pt = cpu
    with pt.amp.auto_cast(dtype="float16"):
        with pt.amp.auto_cast(enable=False):
            assert pt.amp.amp_state()["enable"] is False
        assert str(pt.amp.amp_state()["dtype"]) == "torch.float16"
    assert pt.amp.amp_state()["enable"] is False
    assert pt.amp.amp_guard is pt.amp.auto_cast


def test_decorate_o1_casts_nothing_o2_casts_params(cpu):
    pt = cpu
    net = _net(pt)
    ps = net.parameters()
    assert pt.amp.decorate(net, level="O1") is net
    assert all("float32" in str(p.dtype) for p in ps)
    opt = pt.optimizer.Adam(0.01, parameters=ps)
    m, o = pt.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    assert m is net and o is opt
    assert [id(p) for p in net.parameters()] == [id(p) for p in ps]
    for p in ps:
        assert "bfloat16" in str(p.dtype)
        assert not p.stop_gradient and p.is_leaf


def test_o2_training_matches_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    state = {k: v.numpy() for k, v in _net(pj).state_dict().items()}
    res = {}
    for P in (pj, pt):
        net = _net(P, state)
        opt = P.optimizer.AdamW(0.01, parameters=net.parameters(),
                                weight_decay=0.01)
        net, opt = P.amp.decorate(net, opt, level="O2", dtype="bfloat16")
        x, y = _data(P)
        losses = []
        for _ in range(3):
            with P.amp.auto_cast(level="O2"):
                loss = P.nn.functional.cross_entropy(
                    net(x.astype("bfloat16")).astype("float32"), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        res[P.__name__] = (losses, {n: p.numpy() for n, p in
                                    net.named_parameters()})
    np.testing.assert_allclose(res["paddle_tpu_torch"][0],
                               res["paddle_tpu"][0], rtol=BF16, atol=BF16)
    for n, w in res["paddle_tpu"][1].items():
        np.testing.assert_allclose(res["paddle_tpu_torch"][1][n], w,
                                   rtol=BF16, atol=BF16, err_msg=n)


def _scaler_run(P, state):
    net = _net(P, state)
    opt = P.optimizer.SGD(0.1, parameters=net.parameters())
    scaler = P.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                              decr_ratio=0.5)
    x, y = _data(P)
    trace = []
    for step in range(6):
        loss = P.nn.functional.cross_entropy(net(x), y)
        if step == 2:
            loss = loss * float("inf")           # an overflowing step
        scaler.scale(loss).backward()
        before = net[0].weight.numpy().copy()
        scaler.step(opt)
        opt.clear_grad()
        skipped = np.array_equal(before, net[0].weight.numpy())
        trace.append((scaler.get_init_loss_scaling(), skipped,
                      net[0].weight.numpy().copy()))
    return trace, scaler.state_dict()


def test_grad_scaler_matches_jax_and_skips_inf(cpu):
    import paddle_tpu as pj
    pt = cpu
    state = {k: v.numpy() for k, v in _net(pj).state_dict().items()}
    want, wsd = _scaler_run(pj, state)
    got, gsd = _scaler_run(pt, state)
    assert [(s, k) for s, k, _ in got] == [(s, k) for s, k, _ in want]
    assert [k for _, k, _ in got] == [False, False, True, False, False,
                                      False]
    assert [s for s, _, _ in got] == [8.0, 16.0, 8.0, 8.0, 16.0, 16.0]
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert gsd == wsd


def test_grad_scaler_clamps_at_one_and_state(cpu):
    pt = cpu
    s = pt.amp.GradScaler(init_loss_scaling=2.0, decr_ratio=0.5,
                          decr_every_n_nan_or_inf=1)
    for _ in range(4):
        s._found_inf = True
        s.update()
    assert s._scale == 1.0
    s2 = pt.amp.GradScaler()
    s2.load_state_dict({"scale": 4.0, "good_steps": 3, "bad_steps": 0})
    assert s2.get_init_loss_scaling() == 4.0 and s2._good_steps == 3
    off = pt.amp.GradScaler(enable=False)
    x = pt.to_tensor(np.ones(2, np.float32))
    assert off.scale(x) is x and not off.is_enable()
    assert s.is_use_dynamic_loss_scaling()
