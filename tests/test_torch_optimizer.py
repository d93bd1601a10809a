"""The port's optimizers, gradient clipping and LR schedules against the
JAX package's, on the CPU.

Each optimizer runs five steps in both packages from the same weights:
eagerly (a small Layer, the same batch, backward, `step()`,
`clear_grad()`), and functionally (`apply_gradients_functional` on dicts
of raw arrays under the same seeded gradients), plain and with
clipping and weight decay. Parameters and optimizer state are held to
the JAX package's at 1e-5 (rtol = atol), after every eager step.

Every schedule runs 50 epochs in both packages and must give the same
learning rates exactly (they are host floats in both), and the same
state_dict. Then the reference's decay quirks, the numerics taps
(`train.grad_norm`, `train.param_norm`; oracles
`tests/test_numerics.py:465, :490`), `FLAGS_check_nan_inf`'s post-step
scan, the Optimization span, and state_dict round trips.
"""
import numpy as np
import pytest

TOL = 1e-5
STEPS = 5

# name -> (ctor kwargs, decay kwargs) for the optimizers' own decay arm
_OPTS = {
    "SGD": ({"learning_rate": 0.1}, {"weight_decay": 0.01}),
    "Momentum": ({"learning_rate": 0.05, "momentum": 0.9},
                 {"weight_decay": 0.01}),
    "Momentum_nesterov": ({"learning_rate": 0.05, "momentum": 0.8,
                           "use_nesterov": True}, {"weight_decay": 0.02}),
    "Adam": ({"learning_rate": 0.01}, {"weight_decay": 0.01}),
    "AdamW": ({"learning_rate": 0.01, "weight_decay": 0.1},
              {"apply_decay_param_fun": lambda n: "bias" not in n}),
    "Adamax": ({"learning_rate": 0.01}, {"weight_decay": 0.01}),
    "RMSProp": ({"learning_rate": 0.01}, {"weight_decay": 0.01}),
    "RMSProp_centered": ({"learning_rate": 0.01, "momentum": 0.5,
                          "centered": True}, {"weight_decay": 0.01}),
    "Adagrad": ({"learning_rate": 0.05, "initial_accumulator_value": 0.1},
                {"weight_decay": 0.01}),
    "Lamb": ({"learning_rate": 0.01},
             {"exclude_from_weight_decay_fn": lambda n: "bias" in n}),
    "LarsMomentum": ({"learning_rate": 0.1, "lars_coeff": 0.01},
                     {"exclude_from_weight_decay": ["bias"]}),
    "Adadelta": ({"learning_rate": 1.0}, {"weight_decay": 0.01}),
    "NAdam": ({"learning_rate": 0.01}, {"weight_decay": 0.01}),
    "RAdam": ({"learning_rate": 0.01}, {"weight_decay": 0.01}),
}
_ARMS = ["plain", "clip", "decay"]


def _cls(P, name):
    return getattr(P.optimizer, name.split("_")[0])


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _net(P):
    net = P.nn.Sequential(P.nn.Linear(4, 6), P.nn.Tanh(), P.nn.Linear(6, 3))
    for n, p in net.named_parameters():
        p.name = n
    return net


def _make_opt(P, name, arm, params):
    kw, decay = _OPTS[name]
    kw = dict(kw)
    if arm == "clip":
        kw["grad_clip"] = P.nn.ClipGradByGlobalNorm(0.05)
    if arm == "decay":
        kw.update(decay)
    return _cls(P, name)(parameters=params, **kw)


def _eager(P, name, arm, state):
    net = _net(P)
    if state is not None:
        net.set_state_dict(state)
    if arm == "clip":
        net[2].bias.need_clip = False          # skipped by the clip
    opt = _make_opt(P, name, arm, net.parameters())
    rng = np.random.RandomState(1)
    x = P.to_tensor(rng.randn(8, 4).astype(np.float32))
    y = P.to_tensor(rng.randn(8, 3).astype(np.float32))
    trace = []
    for _ in range(STEPS):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        trace.append({n: p.numpy() for n, p in net.named_parameters()})
    return net, opt, trace


@pytest.mark.parametrize("arm", _ARMS)
@pytest.mark.parametrize("name", list(_OPTS))
def test_eager_steps_match_jax(cpu, name, arm):
    import paddle_tpu as pj
    pt = cpu
    # the same starting weights in both: a JAX net's initial state
    state0 = {k: v.numpy() for k, v in _net(pj).state_dict().items()}
    jnet, jopt, want = _eager(pj, name, arm, state0)
    tnet, topt, got = _eager(pt, name, arm, state0)
    for step, (g, w) in enumerate(zip(got, want)):
        for n in w:
            np.testing.assert_allclose(g[n], w[n], rtol=TOL, atol=TOL,
                                       err_msg=f"{name}/{arm} step {step} {n}")
    js, ts = jopt.state_dict(), topt.state_dict()
    assert set(js) == set(ts) and ts["step_count"] == STEPS
    for key in js:
        if key == "step_count":
            continue
        assert set(js[key]) == set(ts[key])
        for sk in js[key]:
            np.testing.assert_allclose(ts[key][sk].numpy(),
                                       np.asarray(js[key][sk].numpy()),
                                       rtol=TOL, atol=TOL)
    for p in tnet.parameters():
        assert not p.stop_gradient and p.is_leaf      # still trainable


def _functional(P, name, arm, params0, grads_seq, to_array):
    opt = _make_opt(P, name, arm, None)
    if arm == "clip":
        opt._grad_clip = P.nn.ClipGradByGlobalNorm(0.05)
    params = {n: to_array(v) for n, v in params0.items()}
    state = opt.functional_state(params)
    for grads in grads_seq:
        params, state = opt.apply_gradients_functional(
            params, {n: to_array(g) for n, g in grads.items()}, state)
    return params, state


@pytest.mark.parametrize("arm", _ARMS)
@pytest.mark.parametrize("name", list(_OPTS))
def test_functional_steps_match_jax(cpu, name, arm):
    import jax.numpy as jnp
    import paddle_tpu as pj
    import torch
    pt = cpu
    rng = np.random.RandomState(4)
    params0 = {"w": rng.randn(4, 3).astype(np.float32),
               "bias": rng.randn(3).astype(np.float32)}
    grads_seq = [{n: rng.randn(*v.shape).astype(np.float32)
                  for n, v in params0.items()} for _ in range(STEPS)]
    wp, ws = _functional(pj, name, arm, params0, grads_seq, jnp.asarray)
    gp, gs = _functional(pt, name, arm, params0, grads_seq,
                         torch.from_numpy)
    for n in wp:
        np.testing.assert_allclose(gp[n].numpy(), np.asarray(wp[n]),
                                   rtol=TOL, atol=TOL, err_msg=n)
        assert set(gs[n]) == set(ws[n])
        for k in ws[n]:
            np.testing.assert_allclose(gs[n][k].numpy(), np.asarray(ws[n][k]),
                                       rtol=TOL, atol=TOL, err_msg=f"{n}.{k}")


def test_decay_quirks_eager_regularizer_first_functional_optimizer_only(cpu):
    """Eager: a parameter's regularizer wins over the optimizer's decay;
    functional: only the optimizer's decay applies (as in the
    reference)."""
    import torch
    pt = cpu
    from paddle_tpu_torch.regularizer import L2Decay
    p = pt.nn.Linear(2, 2).weight
    p.set_value(np.ones((2, 2), np.float32))
    p.regularizer = L2Decay(1.0)
    opt = pt.optimizer.SGD(0.1, parameters=[p], weight_decay=0.5)
    p.grad = np.zeros((2, 2), np.float32)
    opt.step()
    np.testing.assert_allclose(p.numpy(), np.full((2, 2), 0.9), rtol=1e-6)
    new, _ = opt.apply_gradients_functional(
        {"w": torch.ones(2, 2)}, {"w": torch.zeros(2, 2)}, {"w": {}})
    np.testing.assert_allclose(new["w"].numpy(), np.full((2, 2), 0.95),
                               rtol=1e-6)


def test_clip_need_clip_and_functional_tree(cpu):
    import torch
    pt = cpu
    a, b = pt.nn.Linear(2, 2).weight, pt.nn.Linear(2, 2).weight
    b.need_clip = False
    ga = pt.to_tensor(np.full((2, 2), 3.0, np.float32))
    gb = pt.to_tensor(np.full((2, 2), 4.0, np.float32))
    for clip, want in ((pt.nn.ClipGradByValue(1.0), 1.0),
                       (pt.nn.ClipGradByNorm(1.0), 0.5),
                       (pt.nn.ClipGradByGlobalNorm(1.0), 0.5)):
        out = clip([(a, ga), (b, gb), (a, None)])
        np.testing.assert_allclose(out[0][1].numpy(), np.full((2, 2), want),
                                   rtol=1e-6)
        assert out[1][1] is gb and out[2][1] is None
    tree = pt.nn.ClipGradByGlobalNorm(1.0).clip_tree(
        {"a": torch.full((2, 2), 3.0), "b": torch.full((2, 2), 4.0)})
    np.testing.assert_allclose(tree["a"].numpy(), np.full((2, 2), 0.3),
                               rtol=1e-6)


def test_clip_grad_norm_matches_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    outs = []
    for P in (pj, pt):
        ps = [P.to_tensor(np.full((3,), v, np.float32), stop_gradient=False)
              for v in (1.0, 2.0)]
        (ps[0] * 3.0).sum().backward()
        (ps[1] * -4.0).sum().backward()
        total = P.nn.clip_grad_norm_(ps, 1.0)
        outs.append((float(total), [p.grad.numpy() for p in ps]))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for g, w in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


# ------------------------------------------------------------ schedules

def _schedules(P):
    lr = P.optimizer.lr
    return {
        "NoamDecay": lr.NoamDecay(64, 10, learning_rate=2.0),
        "PiecewiseDecay": lr.PiecewiseDecay([5, 20, 30], [0.1, 0.05, 0.01,
                                                          0.001]),
        "NaturalExpDecay": lr.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lr.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": lr.PolynomialDecay(0.5, 20, end_lr=0.01,
                                              power=2.0),
        "PolynomialDecay_cycle": lr.PolynomialDecay(0.5, 15, cycle=True),
        "LinearWarmup": lr.LinearWarmup(0.3, 10, 0.0, 0.3),
        "LinearWarmup_cosine": lr.LinearWarmup(
            lr.CosineAnnealingDecay(0.3, 25), 10, 0.01, 0.3),
        "ExponentialDecay": lr.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lr.MultiStepDecay(0.5, [10, 25, 40], 0.5),
        "StepDecay": lr.StepDecay(0.5, 7, 0.7),
        "LambdaDecay": lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "CosineAnnealingDecay": lr.CosineAnnealingDecay(0.5, 20, 0.01),
        "OneCycleLR": lr.OneCycleLR(0.4, 50, phase_pct=0.25),
        "CyclicLR": lr.CyclicLR(0.01, 0.1, 6, mode="triangular2"),
        "CyclicLR_exp": lr.CyclicLR(0.01, 0.1, 5, 8, mode="exp_range",
                                    exp_gamma=0.97),
        "ReduceOnPlateau": lr.ReduceOnPlateau(0.5, patience=2, cooldown=1,
                                              factor=0.5),
    }


_METRICS = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.5, 0.6, 0.6, 0.6, 0.7] * 5


_SCHEDULES = ["NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
              "InverseTimeDecay", "PolynomialDecay", "PolynomialDecay_cycle",
              "LinearWarmup", "LinearWarmup_cosine", "ExponentialDecay",
              "MultiStepDecay", "StepDecay", "LambdaDecay",
              "CosineAnnealingDecay", "OneCycleLR", "CyclicLR",
              "CyclicLR_exp", "ReduceOnPlateau"]


@pytest.mark.parametrize("name", _SCHEDULES)
def test_schedule_matches_jax_over_50_epochs(name):
    import paddle_tpu as pj
    import paddle_tpu_torch as pt
    js, ts = _schedules(pj)[name], _schedules(pt)[name]
    seq = {}
    for label, s in (("jax", js), ("port", ts)):
        lrs = []
        for e in range(50):
            lrs.append(s())
            s.step(_METRICS[e]) if name == "ReduceOnPlateau" else s.step()
        seq[label] = lrs
    assert seq["port"] == seq["jax"]
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert {k: v for k, v in tsd.items() if k != "lr_sched"} == \
        {k: v for k, v in jsd.items() if k != "lr_sched"}


def test_lr_semantics_oracles():
    """The cases of `tests/test_lr_semantics.py`, on the port."""
    import math
    from paddle_tpu_torch.optimizer import lr
    s = lr.CosineAnnealingDecay(1.0, T_max=4, eta_min=0.0)
    vals = []
    for _ in range(10):
        vals.append(s())
        s.step()
    assert vals[4] == pytest.approx(0.0, abs=1e-12)
    assert vals[8] == pytest.approx((1 - math.cos(0)) / 2 * 0 + 1.0 *
                                    (1 + math.cos(math.pi * 2)) / 2)
    w = lr.LinearWarmup(0.5, 4, 0.0, 0.5)
    got = []
    for _ in range(6):
        got.append(w())
        w.step()
    assert got == [0.0, 0.125, 0.25, 0.375, 0.5, 0.5]
    r = lr.ReduceOnPlateau(1.0, patience=0)
    with pytest.raises(TypeError):
        r.step()
    assert r.last_epoch == 0
    r.step(1.0)
    r.step(2.0)
    assert r.last_epoch == 2 and r() == pytest.approx(0.1)


def test_optimizer_with_schedule_and_state_roundtrip(cpu):
    import paddle_tpu as pj
    pt = cpu
    outs = []
    for P in (pj, pt):
        net = _net(P)
        if P is pt:
            net.set_state_dict(state0)
        else:
            state0 = {k: v.numpy() for k, v in net.state_dict().items()}
        sched = P.optimizer.lr.LinearWarmup(0.05, 3, 0.0, 0.05)
        opt = P.optimizer.AdamW(sched, parameters=net.parameters(),
                                weight_decay=0.01)
        x = P.to_tensor(np.ones((2, 4), np.float32))
        for _ in range(4):
            net(x).sum().backward()
            opt.step()
            opt.clear_grad()
            sched.step()
        outs.append((opt.get_lr(), opt.state_dict(),
                     {n: p.numpy() for n, p in net.named_parameters()}))
    assert outs[0][0] == outs[1][0]
    for n in outs[0][2]:
        np.testing.assert_allclose(outs[1][2][n], outs[0][2][n], rtol=TOL,
                                   atol=TOL)
    sd = outs[1][1]
    assert sd["LR_Scheduler"] == outs[0][1]["LR_Scheduler"]
    net2 = _net(pt)
    opt2 = pt.optimizer.AdamW(pt.optimizer.lr.LinearWarmup(0.05, 3, 0.0,
                                                           0.05),
                              parameters=net2.parameters())
    opt2.set_state_dict(sd)
    assert opt2._step_count == 4
    assert opt2._lr.last_epoch == sd["LR_Scheduler"]["last_epoch"]
    st = opt2._accumulators[id(net2[0].weight)]
    np.testing.assert_array_equal(st["moment1"].numpy(),
                                  sd["0.weight"]["moment1"].numpy())


# --------------------------------------------- taps, nan scan, the span

def test_functional_update_taps_in_graph(cpu):
    import torch
    pt = cpu
    from paddle_tpu_torch.observability import numerics
    o = pt.optimizer.SGD(learning_rate=0.1)
    params = {"w": torch.ones(4), "b": torch.zeros(2)}
    grads = {"w": torch.full((4,), 0.5), "b": torch.ones(2)}
    state = o.functional_state(params)
    with numerics.sink_scope() as sink:
        new_p, _ = o.apply_gradients_functional(params, grads, state)
    assert set(sink) == {"train.grad_norm", "train.param_norm"}
    gstats = numerics.stats_dict(np.asarray(sink["train.grad_norm"]))
    assert gstats["finite_frac"] == 1.0
    assert gstats["absmax"] == pytest.approx(1.0)
    np.testing.assert_allclose(new_p["w"].numpy(), np.full(4, 0.95),
                               rtol=1e-6)
    p2, _ = o.apply_gradients_functional(params, grads, state)
    np.testing.assert_allclose(p2["w"].numpy(), new_p["w"].numpy())


def test_eager_step_observes_into_process_monitor(cpu):
    pt = cpu
    from paddle_tpu_torch.observability import numerics
    mon = numerics.NumericsMonitor(auto_bundle=False)
    prev = numerics.set_monitor(mon)
    try:
        p = pt.to_tensor(np.array([1.0, 2.0], np.float32),
                         stop_gradient=False)
        o = pt.optimizer.SGD(learning_rate=0.1, parameters=[p])
        (p * p).sum().backward()
        o.step()
        assert mon.total() == 0
        assert {"train.grad_norm", "train.param_norm"} <= \
            set(mon.site_stats())
        p.clear_grad()
        (p * float("nan")).sum().backward()
        o.step()
        assert mon.counts().get("train.grad_norm:nonfinite", 0) >= 1
    finally:
        numerics.set_monitor(prev)


def test_check_nan_inf_names_the_parameter(cpu):
    pt = cpu
    from paddle_tpu_torch.framework.flags import set_flags
    net = _net(pt)
    opt = pt.optimizer.Adam(0.01, parameters=net.parameters())
    (net(pt.to_tensor(np.ones((1, 4), np.float32))).sum()
     * float("inf")).backward()
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(RuntimeError, match=r"in grad of '0.weight'"):
            opt.step()
    finally:
        set_flags({"FLAGS_check_nan_inf": False})


def test_step_is_an_optimization_span(cpu):
    pt = cpu
    from paddle_tpu_torch.profiler import _tracer
    p = pt.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    o = pt.optimizer.Momentum(0.1, parameters=[p])
    p.sum().backward()
    _tracer.enabled = True
    try:
        _tracer.drain()
        o.step()
        spans = [r for r in _tracer.drain() if r["type"] == "Optimization"]
    finally:
        _tracer.enabled = False
    assert [r["name"] for r in spans] == ["Optimizer.step.Momentum"]
    assert spans[0]["attrs"] == {"n_params": 1}


def test_minimize_and_set_lr(cpu):
    pt = cpu
    p = pt.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    o = pt.optimizer.SGD(0.5, parameters=[p])
    o.set_lr(0.25)
    _, pg = o.minimize((p * 2.0).sum())
    np.testing.assert_allclose(p.numpy(), [0.5, 0.5])
    assert pg[0][0] is p
    o2 = pt.optimizer.SGD(pt.optimizer.lr.StepDecay(0.1, 1),
                          parameters=[p])
    with pytest.raises(RuntimeError):
        o2.set_lr(0.3)


_CONVERGE = [("SGD", {"learning_rate": 0.5}),
             ("Momentum", {"learning_rate": 0.1, "momentum": 0.9}),
             ("Adam", {"learning_rate": 0.05}),
             ("AdamW", {"learning_rate": 0.05, "weight_decay": 0.01}),
             ("RMSProp", {"learning_rate": 0.01}),
             ("Adagrad", {"learning_rate": 0.3}),
             ("Lamb", {"learning_rate": 0.03}),
             ("Adamax", {"learning_rate": 0.05}),
             ("Adadelta", {"learning_rate": 1.0}),
             ("NAdam", {"learning_rate": 0.05}),
             ("RAdam", {"learning_rate": 0.05})]


@pytest.mark.parametrize("name,kw", _CONVERGE, ids=[n for n, _ in _CONVERGE])
def test_optimizer_converges_like_jax(cpu, name, kw):
    """`tests/test_optimizer.py`'s quadratic problem, 60 steps: the loss
    halves, and the port's losses follow the JAX package's."""
    import paddle_tpu as pj
    pt = cpu
    rng = np.random.RandomState(0)
    xa = rng.rand(16, 4).astype(np.float32)
    ya = rng.rand(16, 2).astype(np.float32)
    state = {k: v.numpy() for k, v in pj.nn.Linear(4, 2).state_dict().items()}
    runs = {}
    for P in (pj, pt):
        layer = P.nn.Linear(4, 2)
        layer.set_state_dict(state)
        o = getattr(P.optimizer, name)(parameters=layer.parameters(), **kw)
        x, y = P.to_tensor(xa), P.to_tensor(ya)
        losses = []
        for _ in range(60):
            loss = ((layer(x) - y) ** 2).mean()
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        runs[P.__name__] = losses
    got, want = runs["paddle_tpu_torch"], runs["paddle_tpu"]
    assert got[-1] < got[0] * 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
