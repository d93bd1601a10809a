"""The port's `hapi` (`Model`, the callbacks, `summary` / `flops`) and
`metric` against the JAX package's, on the CPU.

`Model.fit` trains `tests/test_e2e_training.py`'s TinyCNN and MLP in both
packages from the same weights (the JAX `state_dict` carried across) over
the same FakeData batches; every step's loss, the final parameters and
BatchNorm's running statistics are held to the JAX package's (rtol 1e-5,
atol 1e-6 on the loss; 1e-5 / 1e-5 on parameters and buffers). The
port's step is the eager functional step (ROADMAP C.16): it never fills
`.grad`.
"""
import numpy as np
import pytest

import paddle_tpu_torch as pt

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield pt


def jax():
    import paddle_tpu as pj
    return pj


def tiny_cnn(P, num_classes=3):
    nn = P.nn

    class TinyCNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(3, 8, 3, padding=1)
            self.bn1 = nn.BatchNorm2D(8)
            self.relu = nn.ReLU()
            self.pool = nn.MaxPool2D(2, 2)
            self.conv2 = nn.Conv2D(8, 16, 3, padding=1)
            self.fc = nn.Linear(16 * 8 * 8, num_classes)

        def forward(self, x):
            x = self.pool(self.relu(self.bn1(self.conv1(x))))
            x = self.pool(self.relu(self.conv2(x)))
            return self.fc(x.flatten(1))
    return TinyCNN()


def mlp(P):
    nn = P.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(3 * 16 * 16, 32)
            self.relu = nn.ReLU()
            self.fc2 = nn.Linear(32, 4)

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x.flatten(1))))
    return MLP()


def carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


class Losses:
    """A callback per package that keeps every train step's loss."""

    @staticmethod
    def make(P):
        class Rec(P.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])
        return Rec()


CASES = {
    "tiny_cnn_momentum": dict(
        net=tiny_cnn, shape=(3, 32, 32), classes=3, n=24, bs=8, epochs=2,
        opt=lambda P, ps: P.optimizer.Momentum(
            0.05, momentum=0.9, parameters=ps, weight_decay=5e-4)),
    "tiny_cnn_sgd_steplr": dict(
        net=tiny_cnn, shape=(3, 32, 32), classes=3, n=16, bs=8, epochs=2,
        opt=lambda P, ps: P.optimizer.SGD(
            P.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5),
            parameters=ps)),
    "mlp_adam": dict(
        net=mlp, shape=(3, 16, 16), classes=4, n=64, bs=16, epochs=2,
        opt=lambda P, ps: P.optimizer.Adam(1e-3, parameters=ps)),
}


def fit_both(case, **fit_kw):
    pj = jax()
    c = CASES[case]
    out = {}
    nets = {pj: c["net"](pj), pt: c["net"](pt)}
    carry(nets[pj], nets[pt])
    for P in (pj, pt):
        net = nets[P]
        model = P.Model(net)
        model.prepare(optimizer=c["opt"](P, model.parameters()),
                      loss=P.nn.CrossEntropyLoss(),
                      metrics=P.metric.Accuracy())
        ds = P.vision.datasets.FakeData(c["n"], c["shape"], c["classes"])
        rec = Losses.make(P)
        model.fit(ds, batch_size=c["bs"], epochs=c["epochs"], shuffle=False,
                  verbose=0, callbacks=[rec], **fit_kw)
        out["jax" if P is pj else "port"] = (model, net, rec.losses, ds)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(case):
    runs = fit_both(case)
    (jm, jn, jl, _), (tm, tn, tl, _) = runs["jax"], runs["port"]
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[-1] < tl[0]
    for (n, p), (_, q) in zip(tn.named_parameters(), jn.named_parameters()):
        np.testing.assert_allclose(p.numpy(), np.asarray(q.numpy()),
                                   err_msg=n, **TOL)
        assert p.grad is None, n              # the step never fills .grad
        assert not p.stop_gradient
    for (n, b), (_, c) in zip(tn.named_buffers(), jn.named_buffers()):
        np.testing.assert_allclose(b.numpy(), np.asarray(c.numpy()),
                                   err_msg=n, **TOL)
    if "cnn" in case:
        assert not np.allclose(tn.bn1._mean.numpy(), 0)


def test_evaluate_and_predict_match_jax():
    runs = fit_both("mlp_adam")
    (jm, _, _, jds), (tm, _, _, tds) = runs["jax"], runs["port"]
    jr = jm.evaluate(jds, batch_size=16)
    tr = tm.evaluate(tds, batch_size=16)
    assert sorted(tr) == sorted(jr) == ["acc", "loss"]
    np.testing.assert_allclose(tr["loss"], jr["loss"], **TOL)
    assert tr["acc"] == jr["acc"]
    jp = jm.predict(jds, batch_size=16, stack_outputs=True)
    tp = tm.predict(tds, batch_size=16, stack_outputs=True)
    assert tp[0].shape == (64, 4)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), **TOL)
    per_batch = tm.predict(tds, batch_size=16)
    assert len(per_batch) == 4 and per_batch[0][0].shape == (16, 4)


def test_train_batch_contract():
    """train_batch / eval_batch on numpy inputs: the optimizer state lives
    in `_opt_state`, BatchNorm's statistics move through new_buffers, and
    an eval step changes neither parameters nor buffers."""
    pj = jax()
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 3, (4,)).astype(np.int64)
    got = {}
    nets = {pj: tiny_cnn(pj), pt: tiny_cnn(pt)}
    carry(nets[pj], nets[pt])
    for P in (pj, pt):
        net = nets[P]
        m = P.Model(net)
        m.prepare(P.optimizer.Momentum(0.05, parameters=net.parameters()),
                  P.nn.CrossEntropyLoss(), P.metric.Accuracy(topk=(1, 2)))
        before = {k: np.asarray(v.numpy()).copy()
                  for k, v in net.state_dict().items()}
        loss, metrics = m.train_batch([x], [y])
        ev_loss, ev_metrics = m.eval_batch([x], [y])
        after = {k: np.asarray(v.numpy()).copy()
                 for k, v in net.state_dict().items()}
        m.eval_batch([x], [y])
        again = {k: np.asarray(v.numpy()) for k, v in
                 net.state_dict().items()}
        got["jax" if P is pj else "port"] = (loss, metrics, ev_loss,
                                             ev_metrics, before, after,
                                             again, m)
    t, j = got["port"], got["jax"]
    np.testing.assert_allclose(t[0], j[0], **TOL)
    np.testing.assert_allclose(t[2], j[2], **TOL)
    assert t[1] == j[1] and t[3] == j[3]
    for k in t[5]:
        np.testing.assert_allclose(t[5][k], j[5][k], err_msg=k, **TOL)
        np.testing.assert_array_equal(t[6][k], t[5][k])
    assert not np.allclose(t[5]["bn1._mean"], t[4]["bn1._mean"])
    state = t[7]._opt_state
    assert set(state) == {n for n, _ in t[7].network.named_parameters()}
    assert sorted(state["fc.weight"]) == ["velocity"]
    assert float(state["fc.weight"]["velocity"].abs().sum()) > 0


def test_save_files_read_by_jax(tmp_path):
    pj = jax()
    from paddle_tpu.framework import io as jio
    runs = fit_both("tiny_cnn_sgd_steplr")
    tm, tn = runs["port"][0], runs["port"][1]
    path = str(tmp_path / "ckpt" / "final")
    tm.save(path)
    state = jio.load(path + ".pdparams")
    assert list(state) == list(tn.state_dict())
    for k, v in tn.state_dict().items():
        np.testing.assert_array_equal(np.asarray(state[k].numpy()),
                                      v.numpy(), err_msg=k)
    opt = jio.load(path + ".pdopt")
    assert opt["step_count"] == tm._optimizer.state_dict()["step_count"]
    assert opt["LR_Scheduler"] == tm._optimizer._lr.state_dict()
    # and the JAX Model loads the port's files
    jm = runs["jax"][0]
    jm.load(path)
    for (n, p), (_, q) in zip(tn.named_parameters(),
                              jm.network.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q.numpy()))
    # the port's load round trip: logits bit for bit
    fresh = pt.Model(tiny_cnn(pt))
    fresh.prepare(pt.optimizer.SGD(0.1, parameters=fresh.parameters()),
                  pt.nn.CrossEntropyLoss())
    fresh.load(path)
    x = np.random.RandomState(3).rand(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_array_equal(fresh.predict_batch([x])[0],
                                  tm.predict_batch([x])[0])
    fresh.load(path, reset_optimizer=True)
    tm.save(str(tmp_path / "net_only"), training=False)
    assert not (tmp_path / "net_only.pdopt").exists()


# ------------------------------------------------------------------ metrics

def _metric_inputs():
    rng = np.random.RandomState(7)
    pred = rng.rand(12, 5).astype(np.float32)
    label = rng.randint(0, 5, (12, 1)).astype(np.int64)
    onehot = np.eye(5, dtype=np.float32)[label[:, 0]]
    probs = rng.rand(40).astype(np.float32)
    bins = (rng.rand(40) > 0.5).astype(np.int64)
    return pred, label, onehot, probs, bins


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
@pytest.mark.parametrize("onehot", [False, True])
def test_accuracy_matches_jax(topk, onehot):
    pj = jax()
    pred, label, oh, _, _ = _metric_inputs()
    lab = oh if onehot else label
    out = {}
    for P in (pj, pt):
        m = P.metric.Accuracy(topk=topk)
        rs = []
        for s in (slice(0, 5), slice(5, 12)):
            c = m.compute(P.to_tensor(pred[s]), P.to_tensor(lab[s]))
            rs.append((np.asarray(c.numpy()), m.update(c)))
        out[P] = (rs, m.accumulate(), m.name())
        m.reset()
        assert m.accumulate() in (0.0, [0.0] * len(m.topk))
    (tr, ta, tn), (jr, ja, jn) = out[pt], out[pj]
    for (c1, u1), (c2, u2) in zip(tr, jr):
        np.testing.assert_array_equal(c1, c2)
        assert u1 == u2
    assert ta == ja and tn == jn


def test_precision_recall_auc_and_accuracy_fn_match_jax():
    pj = jax()
    pred, label, _, probs, bins = _metric_inputs()
    out = {}
    for P in (pj, pt):
        res = {}
        for name, m in (("precision", P.metric.Precision()),
                        ("recall", P.metric.Recall()),
                        ("auc", P.metric.Auc(num_thresholds=255))):
            m.update(P.to_tensor(probs[:20]), P.to_tensor(bins[:20]))
            m.update(probs[20:], bins[20:])
            res[name] = (m.accumulate(), m.name())
        two_col = np.stack([1 - probs, probs], axis=1)
        auc2 = P.metric.Auc()
        auc2.update(P.to_tensor(two_col), P.to_tensor(bins))
        res["auc2"] = auc2.accumulate()
        for k in (1, 3):
            res[f"acc{k}"] = float(P.metric.accuracy(
                P.to_tensor(pred), P.to_tensor(label), k=k))
        out[P] = res
    assert out[pt].keys() == out[pj].keys()
    for k in out[pt]:
        if k.startswith("acc"):
            np.testing.assert_allclose(out[pt][k], out[pj][k], rtol=1e-6)
        else:
            assert out[pt][k] == out[pj][k], k


# ---------------------------------------------------------------- callbacks

def recorder(P):
    class Rec(P.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.events = []

        def __getattribute__(self, name):
            attr = object.__getattribute__(self, name)
            if name.startswith("on_") and callable(attr):
                events = object.__getattribute__(self, "events")

                def wrapped(*args):
                    events.append((name,) + tuple(
                        a if not isinstance(a, dict) else sorted(a)
                        for a in args))
                    return attr(*args)
                return wrapped
            return attr
    return Rec()


def test_callback_event_sequence_matches_jax():
    pj = jax()
    seqs = {}
    nets = {pj: mlp(pj), pt: mlp(pt)}
    carry(nets[pj], nets[pt])
    for P in (pj, pt):
        net = nets[P]
        m = P.Model(net)
        m.prepare(P.optimizer.SGD(0.01, parameters=net.parameters()),
                  P.nn.CrossEntropyLoss(), P.metric.Accuracy())
        rec = recorder(P)
        ds = P.vision.datasets.FakeData(12, (3, 16, 16), 4)
        m.fit(ds, eval_data=ds, batch_size=5, epochs=2, verbose=0,
              callbacks=[rec], num_iters=5, shuffle=False)
        assert rec.model is m and rec.params["steps"] == 3
        seqs[P] = rec.events
    assert seqs[pt] == seqs[pj]
    assert [e[0] for e in seqs[pt][:2]] == ["on_begin", "on_train_begin"]
    assert [e[0] for e in seqs[pt][-2:]] == ["on_end", "on_train_end"]


def _fit_with(P, net, cbs, epochs=4, lr=0.1, opt=None, eval_data=None,
              verbose=0, **kw):
    m = P.Model(net)
    m.prepare(opt or P.optimizer.SGD(lr, parameters=net.parameters()),
              P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    ds = P.vision.datasets.FakeData(8, (3, 16, 16), 4)
    m.fit(ds, eval_data=eval_data, batch_size=4, epochs=epochs,
          verbose=verbose, callbacks=cbs, shuffle=False, **kw)
    return m


@pytest.mark.parametrize("mode,monitor", [("auto", "loss"), ("max", "acc"),
                                          ("min", "loss"),
                                          ("bogus", "acc")])
def test_early_stopping_matches_jax(mode, monitor):
    pj = jax()
    stops = {}
    nets = {pj: mlp(pj), pt: mlp(pt)}
    carry(nets[pj], nets[pt])
    for P in (pj, pt):
        net = nets[P]
        es = P.callbacks.EarlyStopping(monitor=monitor, mode=mode,
                                       patience=1, min_delta=10.0)
        rec = recorder(P)
        if mode == "bogus":
            with pytest.warns(UserWarning, match="unknown mode"):
                es = P.callbacks.EarlyStopping(monitor=monitor, mode=mode,
                                               patience=1)
        m = _fit_with(P, net, [es, rec], epochs=5)
        stops[P] = (es.mode, es.wait, m.stop_training,
                    [e[1] for e in rec.events if e[0] == "on_epoch_end"])
    assert stops[pt] == stops[pj]


def test_reduce_lr_on_plateau_and_lr_scheduler_match_jax():
    pj = jax()
    out = {}
    nets = {pj: mlp(pj), pt: mlp(pt)}
    carry(nets[pj], nets[pt])
    for P in (pj, pt):
        net = nets[P]
        rop = P.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                            patience=1, min_delta=10.0,
                                            cooldown=1, verbose=0)
        m = _fit_with(P, net, [rop], epochs=5)
        sched = P.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        net2 = mlp(P)
        cb = P.callbacks.LRScheduler(by_step=True, by_epoch=True)
        m2 = _fit_with(P, net2, [cb], epochs=2,
                       opt=P.optimizer.SGD(sched,
                                           parameters=net2.parameters()))
        with pytest.warns(UserWarning, match="LRScheduler"):
            rop2 = P.callbacks.ReduceLROnPlateau(monitor="loss",
                                                 patience=0, min_delta=10.0)
            _fit_with(P, mlp(P), [rop2], epochs=2,
                      opt=P.optimizer.SGD(P.optimizer.lr.StepDecay(
                          0.1, 1), parameters=mlp(P).parameters()))
        out[P] = (m._optimizer.get_lr(), rop.wait, rop.cooldown_counter,
                  sched.last_epoch, m2._optimizer.get_lr())
    assert out[pt] == out[pj]
    assert out[pt][0] < 0.1


def test_checkpoint_visualdl_and_progbar(tmp_path, capsys):
    pj = jax()
    logs = {}
    nets = {pj: mlp(pj), pt: mlp(pt)}
    carry(nets[pj], nets[pt])
    for P in (pj, pt):
        tag = "jax" if P is pj else "port"
        net = nets[P]
        ck = P.callbacks.ModelCheckpoint(save_freq=2,
                                         save_dir=str(tmp_path / tag))
        vdl = P.callbacks.VisualDL(str(tmp_path / f"vdl_{tag}"))
        capsys.readouterr()
        _fit_with(P, net, [ck, vdl], epochs=3, verbose=2, log_freq=1)
        printed = capsys.readouterr().out.splitlines()
        logs[tag] = (sorted(p.name for p in (tmp_path / tag).iterdir()),
                     [line.rsplit(" - ", 1)[0] for line in printed],
                     (tmp_path / f"vdl_{tag}" / "scalars.jsonl")
                     .read_text().splitlines())
    assert logs["port"][0] == logs["jax"][0] == [
        "0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams", "final.pdopt",
        "final.pdparams"]
    assert len(logs["port"][1]) == len(logs["jax"][1]) == 6
    import json
    tp = [json.loads(x) for x in logs["port"][2]]
    jp = [json.loads(x) for x in logs["jax"][2]]
    assert [sorted(r) for r in tp] == [sorted(r) for r in jp]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert a["step"] == b["step"]
    for a, b in zip(logs["port"][1], logs["jax"][1]):
        assert a.split(" - ")[0] == b.split(" - ")[0]


# -------------------------------------------------------- summary and flops

@pytest.mark.parametrize("name,size", [("LeNet", (1, 1, 28, 28)),
                                       ("tiny_cnn", (1, 3, 32, 32))])
def test_summary_and_flops_match_jax(name, size, capsys):
    pj = jax()
    out = {}
    for P in (pj, pt):
        net = P.vision.models.LeNet() if name == "LeNet" else tiny_cnn(P)
        capsys.readouterr()
        counts = P.summary(net)
        table = capsys.readouterr().out
        model = P.Model(net)
        model_counts = model.summary()
        capsys.readouterr()
        was = net.training
        out[P] = (counts, table, model_counts, P.flops(net, list(size)),
                  net.training == was)
    assert out[pt] == out[pj]
    assert out[pt][3] > 0
