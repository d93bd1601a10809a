"""The port's `static` surface against the JAX package's, on the CPU: the
counterparts of `tests/test_static_nn.py`, `tests/test_static_extras.py`
and `tests/test_static_honesty.py`.

* `static.nn` control flow: concrete predicates in both packages, and
  traced ones (the JAX side under `jax.jit`, the port under
  `jit.to_static`, where they lower to `cond` / `while_loop`); results
  equal.
* Layer functions that create their parameters inline draw them from
  each package's own generator, so they are held to the oracle's shapes
  and properties; the parameter-free ones (norms, sequence ops, CRF
  decoding, AUC) to the JAX outputs at 1e-5 and exactly for integers.
* Beam search over weights carried from the JAX cell, embedding and
  projection: ids exact, scores at 1e-5.
* EMA, `py_func` (eager and traced), `gradients` / `append_backward`,
  scopes, program state, places, the IPU refusal.
* `TracedLayer`, `Executor.run`'s exact feed matching, the Predictor's
  saved feed names, and the Cifar100 parser, against the JAX package.
"""
import io
import pickle
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.static import nn as jsnn
from paddle_tpu_torch.static import nn as tsnn

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


# ------------------------------------------------------ static.nn control
def test_cond_eager_and_traced():
    for P, snn in ((pj, jsnn), (pt, tsnn)):
        out = snn.cond(P.to_tensor(np.array(True)),
                       lambda: P.to_tensor(1.0), lambda: P.to_tensor(2.0))
        assert float(out) == 1.0

    def jf(flag):
        return jsnn.cond(pj.Tensor(flag),
                         lambda: pj.to_tensor(np.float32(1.0)),
                         lambda: pj.to_tensor(np.float32(2.0)))._data

    def tf(flag):
        return tsnn.cond(flag, lambda: pt.to_tensor(np.float32(1.0)),
                         lambda: pt.to_tensor(np.float32(2.0)))

    st = pt.jit.to_static(tf)
    for v in (False, True):
        assert float(st(pt.to_tensor(np.array(v)))) == \
            float(jax.jit(jf)(jnp.asarray(v)))
    (prog,) = st.concrete_programs.values()
    assert "cond" in prog.code


def test_switch_case_and_case():
    for P, snn in ((pj, jsnn), (pt, tsnn)):
        out = snn.switch_case(P.to_tensor(np.array(1)),
                              {0: lambda: P.to_tensor(10.0),
                               1: lambda: P.to_tensor(20.0)},
                              default=lambda: P.to_tensor(-1.0))
        assert float(out) == 20.0
        assert float(snn.switch_case(P.to_tensor(np.array(0)),
                                     {1: lambda: P.to_tensor(10.0),
                                      3: lambda: P.to_tensor(30.0)})) == 30.0
        out = snn.case([(P.to_tensor(np.array(False)),
                         lambda: P.to_tensor(1.0)),
                        (P.to_tensor(np.array(True)),
                         lambda: P.to_tensor(2.0))])
        assert float(out) == 2.0

    # traced out-of-range with NO default falls to the LAST branch
    def jg(i):
        return jsnn.switch_case(pj.Tensor(i),
                                {1: lambda: pj.to_tensor(np.float32(10.)),
                                 3: lambda: pj.to_tensor(np.float32(30.))}
                                )._data

    def tg(i):
        return tsnn.switch_case(i, {1: lambda: pt.to_tensor(np.float32(10.)),
                                    3: lambda: pt.to_tensor(np.float32(30.))})

    st = pt.jit.to_static(tg)
    for i in (0, 3, 1):
        want = float(jax.jit(jg)(jnp.asarray(i)))
        assert float(st(pt.to_tensor(np.array(i)))) == want
    assert [float(jax.jit(jg)(jnp.asarray(i))) for i in (0, 3, 1)] == \
        [30.0, 30.0, 10.0]


def test_while_loop_traced():
    def jf(n):
        i, s, nt = pj.Tensor(jnp.asarray(0)), pj.Tensor(jnp.asarray(0)), \
            pj.Tensor(n)
        i, s, nt = jsnn.while_loop(lambda i, s, nt: i < nt,
                                   lambda i, s, nt: (i + 1, s + i, nt),
                                   [i, s, nt])
        return s._data

    def tf(nt):
        i = pt.to_tensor(np.int64(0))
        s = pt.to_tensor(np.int64(0))
        i, s, nt = tsnn.while_loop(lambda i, s, nt: i < nt,
                                   lambda i, s, nt: (i + 1, s + i, nt),
                                   [i, s, nt])
        return s

    st = pt.jit.to_static(tf)
    for n in (5, 0, 7):
        got = int(st(pt.to_tensor(np.int64(n))))
        assert got == int(jax.jit(jf)(jnp.asarray(n))) == n * (n - 1) // 2
    (prog,) = st.concrete_programs.values()
    assert "while_loop" in prog.code
    # eager: a plain python loop
    i, s, _ = tsnn.while_loop(lambda i, s, nt: i < nt,
                              lambda i, s, nt: (i + 1, s + i, nt),
                              [pt.to_tensor(np.int64(0)),
                               pt.to_tensor(np.int64(0)),
                               pt.to_tensor(np.int64(5))])
    assert int(s) == 10


def test_layer_fns_shapes():
    pt.seed(0)
    rng = np.random.RandomState(0)
    x = pt.to_tensor(rng.rand(2, 3, 8, 8).astype("float32"))
    out_valid = tsnn.conv2d(x, 4, 3, act="relu")
    assert tuple(out_valid.shape) == (2, 4, 6, 6)     # valid padding
    assert float(out_valid.numpy().min()) >= 0.0      # relu applied
    assert tuple(tsnn.conv2d(x, 4, 3, padding=1).shape) == (2, 4, 8, 8)
    # batch_norm with fresh statistics: the JAX package's output
    np.testing.assert_allclose(tsnn.batch_norm(x).numpy(),
                               jsnn.batch_norm(pj.to_tensor(x.numpy()))
                               .numpy(), rtol=TOL, atol=TOL)
    g = rng.rand(2, 4, 8, 8).astype("float32")
    np.testing.assert_allclose(
        tsnn.group_norm(pt.to_tensor(g), groups=2).numpy(),
        jsnn.group_norm(pj.to_tensor(g), groups=2).numpy(), rtol=TOL,
        atol=TOL)
    flat = pt.to_tensor(rng.rand(4, 6).astype("float32"))
    assert tuple(tsnn.fc(flat, 5).shape) == (4, 5)
    emb = tsnn.embedding(pt.to_tensor(np.array([[1, 2]], "int64")),
                         size=(10, 4))
    assert tuple(emb.shape) == (1, 2, 4)
    assert tuple(tsnn.bilinear_tensor_product(flat, flat, 7).shape) == (4, 7)
    rc = tsnn.row_conv(pt.to_tensor(rng.rand(2, 5, 6).astype("float32")),
                       future_context_size=2)
    assert tuple(rc.shape) == (2, 5, 6)
    nce_loss = tsnn.nce(flat, pt.to_tensor(np.array([[1], [2], [0], [3]],
                                                    "int64")), 10)
    assert tuple(nce_loss.shape) == (4, 1)
    assert float(nce_loss.numpy().min()) > 0          # a logistic loss
    d = rng.rand(5, 3).astype("float32")
    np.testing.assert_allclose(tsnn.data_norm(pt.to_tensor(d)).numpy(),
                               jsnn.data_norm(pj.to_tensor(d)).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tsnn.instance_norm(x).numpy(),
                               jsnn.instance_norm(pj.to_tensor(x.numpy()))
                               .numpy(), rtol=1e-4, atol=1e-4)


def test_sequence_ops_padded_semantics():
    x = np.arange(24, dtype="float32").reshape(2, 4, 3)
    ln = np.array([2, 4], "int64")
    row = np.array([[1.0, 2.0, 3.0, 4.0]], "float32")
    outs = {}
    for P, snn in ((pj, jsnn), (pt, tsnn)):
        X, L = P.to_tensor(x), P.to_tensor(ln)
        o = {"softmax": snn.sequence_softmax(
                P.to_tensor(row), length=P.to_tensor(np.array([2], "int64"))),
             "pool_avg": snn.sequence_pool(X, "average", length=L),
             "pool_max": snn.sequence_pool(X, "max", length=L),
             "pool_sum": snn.sequence_pool(X, "sum", length=L),
             "last": snn.sequence_last_step(X, length=L),
             "first": snn.sequence_first_step(X, length=L),
             "rev": snn.sequence_reverse(X, length=L),
             "pad": snn.sequence_pad(X, -1.0, length=L)[0],
             "unpad": snn.sequence_unpad(X, L),
             "slice": snn.sequence_slice(
                 X, P.to_tensor(np.array([1, 0], "int64")),
                 P.to_tensor(np.array([2, 3], "int64"))),
             "enum": snn.sequence_enumerate(
                 P.to_tensor(np.array([[1, 2, 3]], "int64")), win_size=2,
                 pad_value=0),
             "reshape": snn.sequence_reshape(X, 6),
             "expand": snn.sequence_expand(X, P.to_tensor(np.zeros((4, 1)))),
             "scatter": snn.sequence_scatter(
                 X[:, :, 0], P.to_tensor(np.array([[0, 2], [1, 3]], "int64")),
                 P.to_tensor(np.ones((2, 2), "float32")))}
        outs[P.__name__] = {k: v.numpy() for k, v in o.items()}
    j, t = outs["paddle_tpu"], outs["paddle_tpu_torch"]
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    # the oracle's reads
    np.testing.assert_allclose(t["softmax"][0, :2].sum(), 1.0, rtol=1e-6)
    assert t["softmax"][0, 2] == 0 and t["softmax"][0, 3] == 0
    np.testing.assert_allclose(t["pool_avg"][0], x[0, :2].mean(0), rtol=1e-6)
    np.testing.assert_allclose(t["last"][1], x[1, 3])
    np.testing.assert_allclose(t["rev"][0, 0], x[0, 1])
    np.testing.assert_allclose(t["rev"][0, 2], x[0, 2])     # pad stays
    assert (t["pad"][0, 2:] == -1.0).all()
    np.testing.assert_array_equal(t["enum"][0], [[1, 2], [2, 3], [3, 0]])
    sc = tsnn.sequence_conv(pt.to_tensor(x), num_filters=5, filter_size=3)
    assert tuple(sc.shape) == (2, 4, 5)


def test_crf_decoding_matches_viterbi():
    rng = np.random.RandomState(0)
    pot = rng.rand(2, 5, 4).astype("float32")
    trans = rng.rand(4, 4).astype("float32")
    crf = rng.rand(6, 4).astype("float32")              # start/stop rows
    lab = rng.randint(0, 4, (2, 5)).astype("int64")
    ln = np.array([5, 3], "int64")
    got = {}
    for P, snn in ((pj, jsnn), (pt, tsnn)):
        path = snn.crf_decoding(P.to_tensor(pot), P.to_tensor(trans))
        _, expect = P.text.viterbi_decode(
            P.to_tensor(pot), P.to_tensor(trans),
            P.to_tensor(np.array([5, 5], "int64")), include_bos_eos_tag=False)
        np.testing.assert_array_equal(path.numpy(), expect.numpy())
        got[P.__name__] = (
            path.numpy(),
            snn.crf_decoding(P.to_tensor(pot), P.to_tensor(crf),
                             length=P.to_tensor(ln)).numpy(),
            snn.crf_decoding(P.to_tensor(pot), P.to_tensor(crf),
                             label=P.to_tensor(lab),
                             length=P.to_tensor(ln)).numpy())
    for a, b in zip(got["paddle_tpu"], got["paddle_tpu_torch"]):
        np.testing.assert_array_equal(b, a)


def _beam_parts(P, V, H, seed):
    P.seed(seed)
    return P.nn.GRUCell(H, H), P.nn.Embedding(V, H), P.nn.Linear(H, V)


def _beam_pair(V, H, seed):
    """The JAX cell, embedding and projection, and the port's with the
    JAX weights."""
    j = _beam_parts(pj, V, H, seed)
    t = _beam_parts(pt, V, H, seed)
    for a, b in zip(j, t):
        _carry(a, b)
    return j, t


def _decode(P, parts, V, h0, beam, steps, **kw):
    cell, emb, proj = parts
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=V - 1,
                                 beam_size=beam, embedding_fn=emb,
                                 output_fn=proj)
    return P.nn.dynamic_decode(dec, inits=P.to_tensor(h0),
                               max_step_num=steps, **kw)


def test_beam_search_decoder_greedy_agreement():
    """With beam_size=1 beam search reproduces greedy argmax decode, and
    the port's ids and scores are the JAX package's."""
    V, H = 12, 16
    j, t = _beam_pair(V, H, 0)
    h0 = np.random.RandomState(0).rand(2, H).astype("float32")
    jids, jsc = _decode(pj, j, V, h0, 1, 6)
    ids, scores = _decode(pt, t, V, h0, 1, 6)
    np.testing.assert_array_equal(ids.numpy(), jids.numpy())
    np.testing.assert_allclose(scores.numpy(), jsc.numpy(), rtol=TOL,
                               atol=TOL)
    cell, emb, proj = t
    tok = np.zeros(2, "int64")
    h = pt.to_tensor(h0)
    done = np.zeros(2, bool)
    for s in range(ids.shape[2]):
        out, h = cell(emb(pt.to_tensor(tok)), h)
        nxt = proj(out).numpy().argmax(-1)
        got = ids.numpy()[:, 0, s]
        for b in range(2):
            assert got[b] == (V - 1 if done[b] else nxt[b]), (b, s)
        done |= (nxt == V - 1)
        tok = nxt.astype("int64")


def test_beam_search_paths_are_consistent_prefixes():
    """Every beam's tokens re-scored step by step reproduce the beam's
    reported log-prob, in the port as in the JAX package."""
    V, H = 7, 8
    j, t = _beam_pair(V, H, 3)
    h0 = np.random.RandomState(5).rand(2, H).astype("float32")
    jids, jsc = _decode(pj, j, V, h0, 3, 4)
    ids, scores = _decode(pt, t, V, h0, 3, 4)
    np.testing.assert_array_equal(ids.numpy(), jids.numpy())
    np.testing.assert_allclose(scores.numpy(), jsc.numpy(), rtol=TOL,
                               atol=TOL)
    cell, emb, proj = t
    end = V - 1
    for b in range(2):
        for k in range(3):
            toks = ids.numpy()[b, k]
            lp, finished = 0.0, False
            h = pt.to_tensor(h0[b:b + 1])
            prev = np.array([0], "int64")
            for s in range(len(toks)):
                out, h = cell(emb(pt.to_tensor(prev)), h)
                step_lp = torch.log_softmax(proj(out)._data.float(), -1)
                if not finished:
                    lp += float(step_lp[0, toks[s]])
                else:
                    assert toks[s] == end
                finished = finished or toks[s] == end
                prev = np.array([toks[s]], "int64")
            np.testing.assert_allclose(lp, scores.numpy()[b, k], rtol=1e-4,
                                       atol=1e-5)


def test_case_traced_and_auc_ties():
    def jf(x):
        return jsnn.case(
            [(pj.Tensor(x > 1.0), lambda: pj.to_tensor(np.float32(10.0))),
             (pj.Tensor(x > 0.0), lambda: pj.to_tensor(np.float32(20.0)))],
            default=lambda: pj.to_tensor(np.float32(30.0)))._data

    def tf(x):
        return tsnn.case(
            [(x > 1.0, lambda: pt.to_tensor(np.float32(10.0))),
             (x > 0.0, lambda: pt.to_tensor(np.float32(20.0)))],
            default=lambda: pt.to_tensor(np.float32(30.0)))

    st = pt.jit.to_static(tf)
    for v, want in ((0.5, 20.0), (-1.0, 30.0), (2.0, 10.0)):
        assert float(jax.jit(jf)(jnp.float32(v))) == want
        assert float(st(pt.to_tensor(np.float32(v)))) == want
    # all-tied scores give AUC 0.5 regardless of input order
    score = np.full((4, 2), 0.5, "float32")
    for lab in ([1, 0, 1, 0], [0, 1, 0, 1]):
        for P in (pj, pt):
            a = P.static.auc(P.to_tensor(score),
                             P.to_tensor(np.array(lab, "int64")[:, None]))
            np.testing.assert_allclose(float(a), 0.5)


def test_beam_search_wider_beam_scores_sorted():
    V, H = 8, 8
    j, t = _beam_pair(V, H, 1)
    h0 = np.random.RandomState(2).rand(2, H).astype("float32")
    jids, jsc, jlens = _decode(pj, j, V, h0, 3, 5, return_length=True)
    ids, scores, lens = _decode(pt, t, V, h0, 3, 5, return_length=True)
    s = scores.numpy()
    assert (np.diff(s, axis=1) <= 1e-5).all()      # beams ranked best-first
    assert tuple(ids.shape[:2]) == (2, 3) and tuple(lens.shape) == (2, 3)
    np.testing.assert_array_equal(ids.numpy(), jids.numpy())
    np.testing.assert_array_equal(lens.numpy(), jlens.numpy())
    np.testing.assert_allclose(s, jsc.numpy(), rtol=TOL, atol=TOL)


# ----------------------------------------------------------- static extras
def test_ema_tracks_and_swaps():
    pj.seed(0)
    nets = {pj: pj.nn.Linear(4, 2), pt: pt.nn.Linear(4, 2)}
    _carry(nets[pj], nets[pt])
    res = {}
    for P, net in nets.items():
        ema = P.static.ExponentialMovingAverage(decay=0.5)
        p0 = [p.numpy().copy() for p in net.parameters()]
        ema.update(net.parameters())
        for p in net.parameters():
            with P.no_grad():
                p.set_value(P.to_tensor(p.numpy() + 1.0))
        ema.update()
        p1 = [p.numpy().copy() for p in net.parameters()]
        with ema.apply(net.parameters()):
            inside = [p.numpy().copy() for p in net.parameters()]
            for p, a, b in zip(inside, p0, p1):
                np.testing.assert_allclose(p, (0.25 * a + 0.5 * b) / 0.75,
                                           rtol=1e-5)
        for p, b in zip(net.parameters(), p1):
            np.testing.assert_allclose(p.numpy(), b)     # restored
        res[P] = inside
    for a, b in zip(res[pj], res[pt]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_static_auc_exact():
    score = np.array([[0.8, 0.2], [0.3, 0.7], [0.4, 0.6], [0.9, 0.1]],
                     "float32")
    for lab, want in (([[0], [1], [1], [0]], 1.0), ([[1], [0], [1], [0]], 0.5)):
        for P in (pj, pt):
            a = P.static.auc(P.to_tensor(score),
                             P.to_tensor(np.array(lab, "int64")))
            np.testing.assert_allclose(float(a), want)


def test_py_func_eager_and_traced():
    def np_double(a):
        return a * 2

    for P in (pj, pt):
        x = P.to_tensor(np.ones((2, 2), "float32"))
        out = P.static.py_func(np_double, x, out=x)
        np.testing.assert_allclose(out.numpy(), 2 * np.ones((2, 2)))

    def jtraced(a):
        t = pj.static.py_func(np_double, pj.Tensor(a), out=pj.Tensor(a))
        return t._data + 1

    def ttraced(a):
        return pt.static.py_func(np_double, a, out=a) + 1

    st = pt.jit.to_static(ttraced)
    want = np.asarray(jax.jit(jtraced)(jnp.ones((2, 2), jnp.float32)))
    np.testing.assert_allclose(st(pt.to_tensor(np.ones((2, 2), "float32")))
                               .numpy(), want)
    np.testing.assert_allclose(want, 3 * np.ones((2, 2)))
    (prog,) = st.concrete_programs.values()
    assert "py_func" in prog.code


def test_gradients_and_append_backward():
    for P in (pj, pt):
        x = P.to_tensor(np.array([2.0], "float32"), stop_gradient=False)
        (gx,) = P.static.gradients([x * x], [x])
        np.testing.assert_allclose(gx.numpy(), [4.0])
        net = P.nn.Linear(3, 1)
        loss = net(P.to_tensor(np.ones((2, 3), "float32"))).sum()
        pgs = P.static.append_backward(loss)
        assert pgs and all(g is not None for _, g in pgs)
        assert len(pgs) == 2                       # the weight and the bias


def test_scope_and_global_var():
    for P in (pj, pt):
        s = P.static.Scope()
        with P.static.scope_guard(s):
            v = P.static.create_global_var([2], 3.0, "float32", name="gv")
            assert P.static.global_scope().find_var("gv") is v
            np.testing.assert_allclose(v.numpy(), [3.0, 3.0])
        assert P.static.global_scope() is not s


def test_program_state_roundtrip(tmp_path):
    j = pj.nn.Linear(3, 2)
    t = pt.nn.Linear(3, 2)
    _carry(j, t)
    for P, net in ((pj, j), (pt, t)):
        path = str(tmp_path / P.__name__)
        P.static.save(net, path)
        w0 = [p.numpy().copy() for p in net.parameters()]
        for p in net.parameters():
            p.set_value(P.to_tensor(np.zeros_like(p.numpy())))
        P.static.load(net, path)
        for p, w in zip(net.parameters(), w0):
            np.testing.assert_allclose(p.numpy(), w)
        state = P.static.load_program_state(path)
        assert len(state) == len(list(net.parameters()))
    # each package reads the other's file
    for P, other in ((pj, "paddle_tpu_torch"), (pt, "paddle_tpu")):
        state = P.static.load_program_state(str(tmp_path / other))
        for k, v in t.state_dict().items():
            np.testing.assert_allclose(np.asarray(state[k]), v.numpy())


def test_places_and_device_guard():
    assert pt.static.cpu_places(2) and pj.static.cpu_places(2)
    assert len(pt.static.cuda_places()) == torch.cuda.device_count()
    before = pt.get_device()
    with pt.static.device_guard("cpu"):
        assert pt.get_device().startswith("cpu")
    assert pt.get_device() == before


def test_ipu_descoped_raises():
    for P in (pj, pt):
        with pytest.raises(RuntimeError, match="descoped"):
            P.static.IpuStrategy()


# ------------------------------------------------------- static honesty
def _net(P):
    P.seed(7)
    return P.nn.Sequential(P.nn.Linear(6, 12), P.nn.ReLU(),
                           P.nn.Linear(12, 3))


def _net_pair():
    j, t = _net(pj), _net(pt)
    _carry(j, t)
    j.eval()
    t.eval()
    return j, t


def test_traced_layer_trace_and_call():
    x = np.random.RandomState(0).rand(4, 6).astype("float32")
    got = []
    for P, net in zip((pj, pt), _net_pair()):
        out, traced = P.jit.TracedLayer.trace(net, [P.to_tensor(x)])
        g = traced([P.to_tensor(x)])
        assert isinstance(g, list) and len(g) == 1
        np.testing.assert_allclose(g[0].numpy(), out.numpy(), rtol=1e-6)
        assert len(traced.program.ops()) > 0
        got.append(g[0].numpy())
    np.testing.assert_allclose(got[1], got[0], rtol=TOL, atol=TOL)


def test_traced_layer_save_inference_model(tmp_path):
    x = np.random.RandomState(1).rand(2, 6).astype("float32")
    for P, net in zip((pj, pt), _net_pair()):
        _, traced = P.jit.TracedLayer.trace(net, [P.to_tensor(x)])
        path = str(tmp_path / P.__name__)
        traced.save_inference_model(path)
        loaded = P.jit.load(path)
        np.testing.assert_allclose(loaded(P.to_tensor(x)).numpy(),
                                   net(P.to_tensor(x)).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_executor_feed_exact_match(tmp_path):
    x = np.random.RandomState(2).rand(3, 6).astype("float32")
    outs = []
    for P, net in zip((pj, pt), _net_pair()):
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=[P.static.InputSpec(
            [None, 6], "float32", name="img")])
        prog, feed_names, _ = P.static.load_inference_model(path)
        assert feed_names == ["img"]        # REAL saved name
        exe = P.static.Executor()
        out = exe.run(prog, feed={"img": x})
        np.testing.assert_allclose(out[0], net(P.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
        with pytest.raises(KeyError, match="img"):
            exe.run(prog, feed={"image": x})
        with pytest.raises(KeyError, match="unexpected"):
            exe.run(prog, feed={"img": x, "bogus": x})
        outs.append(out[0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)


def _two_in(P):
    class TwoIn(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(3, 3)

        def forward(self, a, b):
            return self.fc(a * 2.0 + b)
    return TwoIn()


def test_traced_layer_feed_permutation(tmp_path):
    r = np.random.RandomState(3)
    a, b = r.rand(2, 3).astype("float32"), r.rand(2, 3).astype("float32")
    j, t = _two_in(pj), _two_in(pt)
    _carry(j, t)
    got = []
    for P, net in ((pj, j), (pt, t)):
        net.eval()
        A, B = P.to_tensor(a), P.to_tensor(b)
        want = net(A, B).numpy()
        _, traced = P.jit.TracedLayer.trace(net, [A, B])
        path = str(tmp_path / P.__name__)
        traced.save_inference_model(path, feed=[1, 0])   # declared: b, a
        loaded = P.jit.load(path)
        g = loaded(B, A).numpy()
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)
        assert len(loaded.state_dict()) > 0
        with pytest.raises(ValueError, match="permutation"):
            traced.save_inference_model(str(tmp_path / "sub"), feed=[0])
        got.append(g)
    np.testing.assert_allclose(got[1], got[0], rtol=TOL, atol=TOL)


def _two_out(P):
    class TwoOut(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(3, 3)

        def forward(self, x):
            h = self.fc(x)
            return h, h * 10.0
    return TwoOut()


def test_traced_layer_fetch_slice_keeps_params(tmp_path):
    x = np.random.RandomState(4).rand(2, 3).astype("float32")
    j, t = _two_out(pj), _two_out(pt)
    _carry(j, t)
    for P, net in ((pj, j), (pt, t)):
        net.eval()
        _, traced = P.jit.TracedLayer.trace(net, [P.to_tensor(x)])
        path = str(tmp_path / P.__name__)
        traced.save_inference_model(path, fetch=[1])
        loaded = P.jit.load(path)
        np.testing.assert_allclose(loaded(P.to_tensor(x)).numpy(),
                                   net(P.to_tensor(x))[1].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert len(loaded.state_dict()) > 0


def test_predictor_uses_saved_feed_names(tmp_path):
    x = np.random.RandomState(5).rand(2, 6).astype("float32")
    outs = []
    for P, net in zip((pj, pt), _net_pair()):
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=[P.static.InputSpec(
            [None, 6], "float32", name="img")])
        cfg = P.inference.Config(path + ".pdmodel", path + ".pdiparams")
        if P is pt:
            cfg.disable_gpu()
        pred = P.inference.create_predictor(cfg)
        assert pred.get_input_names() == ["img"]
        pred.get_input_handle("img").copy_from_cpu(x)
        pred.run()
        out = pred.get_output_handle(pred.get_output_names()[0]) \
            .copy_to_cpu()
        np.testing.assert_allclose(out, net(P.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)


def _fake_cifar100(path):
    """Minimal cifar-100-python archive: 4 train + 2 test samples."""
    def member(name, n, seed):
        rng = np.random.RandomState(seed)
        payload = {b"data": rng.randint(0, 255, (n, 3072), dtype=np.uint8),
                   b"fine_labels": rng.randint(0, 100, n).tolist(),
                   b"coarse_labels": rng.randint(0, 20, n).tolist()}
        return name, pickle.dumps(payload)

    with tarfile.open(path, "w:gz") as tf:
        for name, blob in [member("cifar-100-python/train", 4, 0),
                           member("cifar-100-python/test", 2, 1)]:
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_cifar100_parser(tmp_path):
    arch = str(tmp_path / "cifar-100-python.tar.gz")
    _fake_cifar100(arch)
    sets = {}
    for P in (pj, pt):
        train = P.vision.datasets.Cifar100(data_file=arch, mode="train")
        test = P.vision.datasets.Cifar100(data_file=arch, mode="test")
        assert len(train) == 4 and len(test) == 2
        img, label = train[0]
        assert img.shape == (3, 32, 32) and img.dtype == np.float32
        assert img.max() <= 1.0 and 0 <= int(label) < 100
        sets[P.__name__] = [train[i] for i in range(4)]
    for (ja, jl), (ta, tl) in zip(sets["paddle_tpu"],
                                  sets["paddle_tpu_torch"]):
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
        assert int(np.asarray(tl)) == int(np.asarray(jl))
