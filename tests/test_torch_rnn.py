"""The port's RNN Layers and beam search against the JAX package, on the
CPU.

Each case builds the Layer in both packages, asserts equal `state_dict`
keys and shapes (the reference's names, shapes and gate order), carries
the JAX weights over with `set_state_dict`, runs the same seeded inputs
(ragged `sequence_length`, initial states, time-major, reverse) and holds
the outputs, final states, input and parameter gradients under a seeded
cotangent to the JAX Layer's: 1e-5 for outputs and states, 1e-4 for
gradients (the time loop's products run in another order). The
reference's own oracles (`tests/test_rnn_sequence_length.py`, the
zero-length cases of `tests/test_advice_r5.py`, the beam-search checks
of `tests/test_static_nn.py`) run here on the port. Beam search is held
to the JAX decoder token for token, ties included.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj

OUT, GRAD = 1e-5, 1e-4


@pytest.fixture
def pt():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _carry(src, dst):
    assert [(k, tuple(v.shape)) for k, v in dst.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in src.state_dict().items()]
    missing, unexpected = dst.set_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _run(P, layer, x, init=None, seq=None, cell=False):
    t = P.to_tensor(x, stop_gradient=False)
    init_t = None if init is None else \
        type(init)(P.to_tensor(a) for a in init) if isinstance(init, tuple) \
        else P.to_tensor(init)
    if cell:
        out, st = layer(t, init_t)
    else:
        out, st = layer(t, init_t, sequence_length=None if seq is None
                        else P.to_tensor(seq))
    outs = [out] + _flat(st)
    rng = np.random.RandomState(7)
    loss = None
    for o in outs:
        w = P.to_tensor(rng.uniform(0.5, 1.5, o.shape).astype(np.float32))
        term = (o * w).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return ([o.numpy() for o in outs], t.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


def _compare(got, want):
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=OUT, atol=OUT)
    np.testing.assert_allclose(got[1], want[1], rtol=GRAD, atol=GRAD)
    assert got[2].keys() == want[2].keys()
    for n in want[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], rtol=GRAD,
                                   atol=GRAD, err_msg=n)


B, T, I, H = 3, 5, 4, 6
LENS = np.array([5, 2, 1], "int64")

# id -> (ctor(P), input shape, init maker or None, lengths or None, cell)
CASES = {
    "SimpleRNNCell": (lambda P: P.nn.SimpleRNNCell(I, H), (B, I),
                      lambda r: r.randn(B, H), None, True),
    "SimpleRNNCell_relu": (lambda P: P.nn.SimpleRNNCell(I, H, "relu"),
                           (B, I), None, None, True),
    "LSTMCell": (lambda P: P.nn.LSTMCell(I, H), (B, I),
                 lambda r: (r.randn(B, H), r.randn(B, H)), None, True),
    "GRUCell": (lambda P: P.nn.GRUCell(I, H), (B, I), lambda r: r.randn(B, H),
                None, True),
    "SimpleRNN": (lambda P: P.nn.SimpleRNN(I, H), (B, T, I), None, None,
                  False),
    "SimpleRNN_relu_2layer_seq": (
        lambda P: P.nn.SimpleRNN(I, H, num_layers=2, activation="relu"),
        (B, T, I), None, LENS, False),
    "LSTM": (lambda P: P.nn.LSTM(I, H), (B, T, I), None, None, False),
    "LSTM_init": (lambda P: P.nn.LSTM(I, H), (B, T, I),
                  lambda r: (r.randn(1, B, H), r.randn(1, B, H)), None,
                  False),
    "LSTM_2layer_bidirect_seq": (
        lambda P: P.nn.LSTM(I, H, num_layers=2, direction="bidirect"),
        (B, T, I), None, LENS, False),
    "LSTM_bidirect_seq_init": (
        lambda P: P.nn.LSTM(I, H, direction="bidirect"), (B, T, I),
        lambda r: (r.randn(2, B, H), r.randn(2, B, H)), LENS, False),
    "GRU": (lambda P: P.nn.GRU(I, H), (B, T, I), None, None, False),
    "GRU_bidirect_seq": (lambda P: P.nn.GRU(I, H, direction="bidirect"),
                         (B, T, I), None, LENS, False),
    "GRU_time_major_seq": (lambda P: P.nn.GRU(I, H, time_major=True),
                           (T, B, I), None, LENS, False),
    "GRU_2layer_init_seq": (lambda P: P.nn.GRU(I, H, num_layers=2),
                            (B, T, I), lambda r: r.randn(2, B, H),
                            np.array([5, 0, 3], "int64"), False),
    "RNN_reverse_seq": (lambda P: P.nn.RNN(P.nn.GRUCell(I, H),
                                           is_reverse=True),
                        (B, T, I), lambda r: r.randn(B, H), LENS, False),
    "RNN_time_major_reverse": (
        lambda P: P.nn.RNN(P.nn.LSTMCell(I, H), is_reverse=True,
                           time_major=True), (T, B, I), None, None, False),
    "BiRNN_seq_init": (
        lambda P: P.nn.BiRNN(P.nn.LSTMCell(I, H), P.nn.LSTMCell(I, H)),
        (B, T, I), lambda r: ((r.randn(B, H), r.randn(B, H)),
                              (r.randn(B, H), r.randn(B, H))), LENS, False),
}


def _as_f32(init):
    if isinstance(init, tuple):
        return tuple(_as_f32(a) for a in init)
    return np.asarray(init, np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_rnn_matches_jax(pt, case):
    ctor, shape, init_fn, seq, cell = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x = rng.randn(*shape).astype(np.float32)
    init = None if init_fn is None else _as_f32(init_fn(rng))
    jl, tl = ctor(pj), ctor(pt)
    _carry(jl, tl)

    def run(P, layer):
        if isinstance(init, tuple) and isinstance(init[0], tuple):
            # BiRNN: a (states_fw, states_bw) pair of (h, c) pairs
            t = P.to_tensor(x, stop_gradient=False)
            st = tuple(tuple(P.to_tensor(a) for a in s) for s in init)
            out, states = layer(t, st, sequence_length=P.to_tensor(seq))
            outs = [out] + _flat(states)
            rng = np.random.RandomState(7)
            loss = sum((o * P.to_tensor(rng.uniform(0.5, 1.5, o.shape)
                                        .astype(np.float32))).sum()
                       for o in outs)
            loss.backward()
            return ([o.numpy() for o in outs], t.grad.numpy(),
                    {n: p.grad.numpy() for n, p in layer.named_parameters()})
        return _run(P, layer, x, init, seq, cell)
    _compare(run(pt, tl), run(pj, jl))


def test_gate_order_and_parameter_shapes(pt):
    lstm, gru = pt.nn.LSTMCell(I, H), pt.nn.GRUCell(I, H)
    assert tuple(lstm.weight_ih.shape) == (4 * H, I)
    assert tuple(gru.weight_hh.shape) == (3 * H, H)
    # with every weight zero and the bias pushing one gate at a time, the
    # i, f, c(g), o order shows in the new cell state
    for p in lstm.parameters():
        p.set_value(np.zeros(p.shape, np.float32))
    b = np.zeros(4 * H, np.float32)
    b[2 * H:3 * H] = 10.0                    # g: tanh -> ~1
    b[:H] = 10.0                             # i: sigmoid -> ~1
    lstm.bias_ih.set_value(b)
    x = pt.to_tensor(np.zeros((1, I), np.float32))
    c0 = pt.to_tensor(np.zeros((1, H), np.float32))
    _, (h, c) = lstm(x, (c0, c0))
    np.testing.assert_allclose(c.numpy(), np.tanh(10.0) / (1 + np.exp(-10.0)),
                               rtol=1e-6)


# ------------------------------------------- the reference's own oracles
def _copy_lstm_weights(pl, tl):
    tl.load_state_dict({
        "weight_ih_l0": torch.tensor(pl.cells[0].weight_ih.numpy()),
        "weight_hh_l0": torch.tensor(pl.cells[0].weight_hh.numpy()),
        "bias_ih_l0": torch.tensor(pl.cells[0].bias_ih.numpy()),
        "bias_hh_l0": torch.tensor(pl.cells[0].bias_hh.numpy())})


def test_lstm_sequence_length_matches_torch_packed(pt):
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, I).astype("float32")
    pl = pt.nn.LSTM(I, H)
    tl = torch.nn.LSTM(I, H, batch_first=True)
    _copy_lstm_weights(pl, tl)
    out, (h, c) = pl(pt.to_tensor(x), sequence_length=pt.to_tensor(LENS))
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.tensor(x), torch.tensor(LENS), batch_first=True)
    po, (th, tc) = tl(packed)
    to, _ = torch.nn.utils.rnn.pad_packed_sequence(
        po, batch_first=True, total_length=T)
    np.testing.assert_allclose(out.numpy(), to.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy()[0], th.detach().numpy()[0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy()[0], tc.detach().numpy()[0],
                               rtol=1e-5, atol=1e-5)


def test_bidirectional_masking_and_reverse_segments(pt):
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, I).astype("float32")
    pg = pt.nn.GRU(I, H, direction="bidirect")
    og, _ = pg(pt.to_tensor(x), sequence_length=pt.to_tensor(LENS))
    og = og.numpy()
    assert (og[1, 2:] == 0).all() and (og[2, 1:] == 0).all()
    assert not (og[1, :2] == 0).all()
    pg2 = pt.nn.GRU(I, H)
    pg2.cells[0].set_state_dict(pg.cells_bw[0].state_dict())
    o2, _ = pg2(pt.to_tensor(x[2:3, :1]))
    np.testing.assert_allclose(og[2, 0, H:], o2.numpy()[0, 0], rtol=1e-5,
                               atol=1e-6)


def test_no_sequence_length_unchanged(pt):
    x = np.random.RandomState(2).randn(2, 4, 3).astype("float32")
    m = pt.nn.SimpleRNN(3, 5)
    o1, _ = m(pt.to_tensor(x))
    o2, _ = m(pt.to_tensor(x),
              sequence_length=pt.to_tensor(np.array([4, 4], "int64")))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-5, atol=1e-6)


def test_initial_states_threaded_matches_torch(pt):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 3).astype("float32")
    h0 = rng.randn(1, 2, 5).astype("float32")
    c0 = rng.randn(1, 2, 5).astype("float32")
    pl = pt.nn.LSTM(3, 5)
    tl = torch.nn.LSTM(3, 5, batch_first=True)
    _copy_lstm_weights(pl, tl)
    out, (h, c) = pl(pt.to_tensor(x), (pt.to_tensor(h0), pt.to_tensor(c0)))
    to, (th, tc) = tl(torch.tensor(x), (torch.tensor(h0), torch.tensor(c0)))
    for a, b in ((out, to), (h, th), (c, tc)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_rnn_zero_length_holds_initial_state(pt):
    pt.seed(3)
    rnn = pt.nn.RNN(pt.nn.GRUCell(4, 5))
    x = pt.to_tensor(np.random.RandomState(0).rand(3, 6, 4)
                     .astype("float32"))
    init = pt.to_tensor(np.random.RandomState(1).rand(3, 5)
                        .astype("float32"))
    seq = pt.to_tensor(np.asarray([6, 0, 3], np.int32))
    out, final = rnn(x, initial_states=init, sequence_length=seq)
    np.testing.assert_allclose(final.numpy()[1], init.numpy()[1], rtol=1e-6)
    np.testing.assert_allclose(out.numpy()[1], np.zeros((6, 5)), atol=0)


def test_rnn_zero_length_no_initial_state_zero(pt):
    pt.seed(4)
    rnn = pt.nn.RNN(pt.nn.GRUCell(4, 5))
    x = pt.to_tensor(np.random.RandomState(2).rand(2, 4, 4)
                     .astype("float32"))
    _, final = rnn(x, sequence_length=pt.to_tensor(np.asarray([4, 0],
                                                              np.int32)))
    np.testing.assert_allclose(final.numpy()[1], np.zeros(5), atol=0)


# ------------------------------------------------------------ beam search
def _decoders(pt, V, Hd, beam, seed, scale=1.0):
    """The same GRUCell / Embedding / Linear in both packages (the JAX
    weights carried over; the projection scaled by `scale`)."""
    pj.seed(seed)
    out = {}
    for P in (pj, pt):
        cell, emb, proj = P.nn.GRUCell(Hd, Hd), P.nn.Embedding(V, Hd), \
            P.nn.Linear(Hd, V)
        out[P] = (cell, emb, proj)
    for a, b in zip(out[pj], out[pt]):
        _carry(a, b)
    for P in (pj, pt):
        proj = out[P][2]
        proj.weight.set_value((proj.weight.numpy() * scale)
                              .astype(np.float32))
    return {P: P.nn.BeamSearchDecoder(c, 0, V - 1, beam_size=beam,
                                      embedding_fn=e, output_fn=p)
            for P, (c, e, p) in out.items()}


@pytest.mark.parametrize("beam,scale,steps", [(1, 1.0, 6), (3, 1.0, 5),
                                              (4, 8.0, 12), (3, 0.0, 4)],
                         ids=["greedy", "beam3", "beam4_wide", "all_ties"])
def test_beam_search_matches_jax(pt, beam, scale, steps):
    """Tokens and lengths exact, scores at 1e-5. `all_ties`: a zero
    projection makes every continuation equal, so the top-k order on ties
    (the lower index first, as `jax.lax.top_k`) decides every beam."""
    V, Hd = 12, 16
    decs = _decoders(pt, V, Hd, beam, 5, scale)
    h0 = np.random.RandomState(0).rand(2, Hd).astype("float32")
    got = {P: P.nn.dynamic_decode(decs[P], inits=P.to_tensor(h0),
                                  max_step_num=steps, return_length=True)
           for P in decs}
    (gi, gs, gl), (ji, js, jl) = got[pt], got[pj]
    np.testing.assert_array_equal(gi.numpy(), ji.numpy())
    np.testing.assert_array_equal(gl.numpy(), jl.numpy())
    np.testing.assert_allclose(gs.numpy(), js.numpy(), rtol=1e-5, atol=1e-5)


def test_beam_search_decoder_greedy_agreement(pt):
    """beam_size=1 reproduces greedy argmax decoding up to each
    sequence's first <end>."""
    pt.seed(0)
    V, Hd = 12, 16
    cell, emb, proj = pt.nn.GRUCell(Hd, Hd), pt.nn.Embedding(V, Hd), \
        pt.nn.Linear(Hd, V)
    dec = pt.nn.BeamSearchDecoder(cell, start_token=0, end_token=V - 1,
                                  beam_size=1, embedding_fn=emb,
                                  output_fn=proj)
    h0 = pt.to_tensor(np.random.RandomState(0).rand(2, Hd)
                      .astype("float32"))
    ids, _ = pt.nn.dynamic_decode(dec, inits=h0, max_step_num=6)
    assert tuple(ids.shape[:2]) == (2, 1)
    tok, h, done = np.zeros(2, "int64"), h0, np.zeros(2, bool)
    for t in range(ids.shape[2]):
        out, h = cell(emb(pt.to_tensor(tok)), h)
        nxt = proj(out).numpy().argmax(-1)
        got = ids.numpy()[:, 0, t]
        for b in range(2):
            assert got[b] == (V - 1 if done[b] else nxt[b]), (b, t)
        done |= nxt == V - 1
        tok = nxt


def test_beam_search_paths_rescore_to_their_scores(pt):
    """Every reconstructed beam, re-scored step by step, gives its
    reported log-prob (the parents are followed, not the slots)."""
    pt.seed(3)
    V, Hd, end = 7, 8, 6
    cell, emb, proj = pt.nn.GRUCell(Hd, Hd), pt.nn.Embedding(V, Hd), \
        pt.nn.Linear(Hd, V)
    dec = pt.nn.BeamSearchDecoder(cell, 0, end, beam_size=3,
                                  embedding_fn=emb, output_fn=proj)
    h0 = pt.to_tensor(np.random.RandomState(5).rand(2, Hd)
                      .astype("float32"))
    ids, scores = pt.nn.dynamic_decode(dec, inits=h0, max_step_num=4)
    for b in range(2):
        for k in range(3):
            lp, h, prev, finished = 0.0, h0[b:b + 1], 0, False
            for tk in ids.numpy()[b, k]:
                out, h = cell(emb(pt.to_tensor(np.array([prev]))), h)
                step = torch.log_softmax(proj(out)._data.float(), -1)
                if not finished:
                    lp += float(step[0, tk].detach())
                else:
                    assert tk == end
                finished = finished or tk == end
                prev = tk
            np.testing.assert_allclose(lp, scores.numpy()[b, k], rtol=1e-4,
                                       atol=1e-5)


def test_beam_search_wider_beam_scores_sorted(pt):
    pt.seed(1)
    V, Hd = 8, 8
    dec = pt.nn.BeamSearchDecoder(pt.nn.GRUCell(Hd, Hd), 0, V - 1, 3,
                                  embedding_fn=pt.nn.Embedding(V, Hd),
                                  output_fn=pt.nn.Linear(Hd, V))
    h0 = pt.to_tensor(np.random.RandomState(2).rand(2, Hd)
                      .astype("float32"))
    ids, scores, lens = pt.nn.dynamic_decode(dec, inits=h0, max_step_num=5,
                                             return_length=True)
    assert (np.diff(scores.numpy(), axis=1) <= 1e-5).all()
    assert tuple(ids.shape[:2]) == (2, 3) and tuple(lens.shape) == (2, 3)
