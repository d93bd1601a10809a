"""The port's `text` against the JAX package, on the CPU: Viterbi
decoding, the datasets, BERT and ERNIE, the GPT family's constructors,
and a paged engine at head dim 128.

* Viterbi: scores at 1e-5 and paths exact against the JAX DP on ragged
  lengths (1 and T included), with and without the start / stop rows,
  ties included; the reference's brute-force oracle
  (`tests/test_text_ops.py`) and the Layer on the port.
* Datasets: the synthetic ones item for item; the reference's datasets
  parse small archives of the formats the reference downloads, written
  under `tmp_path`, into the JAX package's items exactly.
* BERT and ERNIE (tiny configurations, dropout 0): the JAX weights
  carried over with `set_state_dict`; hidden states, pooled outputs,
  logits and the pretraining loss at 1e-5 (of the largest magnitude),
  gradients and, after three AdamW steps, the first moments at 1e-4 of
  the model's largest (ROADMAP C.2: the moment, not the parameters; the
  key bias's gradient is rounding noise in both packages); the reference's
  ERNIE oracles (`tests/test_det_nlp_models.py`) on the port.
* `gpt_350m`, `gpt_1p3b`, `gpt_6p7b`: the JAX constructors' widths.
* A 2-layer GPT at hidden 256 with 2 heads (head dim 128): greedy
  streams of the port's paged engine on the plain path token-exact
  against the JAX paged engine (its Pallas kernel in interpret mode),
  f32 and int8 pools.
"""
import io
import itertools
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu as pj

REL, GRAD = 1e-5, 1e-4


@pytest.fixture
def pt():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, \
        float(np.abs(got - want).max()) / scale


def _grads_close(got, want):
    """Parameter gradients at GRAD of the largest gradient of the model:
    a leaf whose gradient is zero in exact arithmetic (the key bias, under
    softmax's shift invariance) holds rounding noise in both packages."""
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=GRAD,
                                   atol=GRAD * scale, err_msg=n)


def _carry(src, dst):
    assert [(k, tuple(v.shape)) for k, v in dst.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in src.state_dict().items()]
    missing, unexpected = dst.set_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


# ---------------------------------------------------------------- viterbi
VITERBI = {
    "ragged": (4, 7, 5, [7, 1, 3, 6], "randn"),
    "all_full": (2, 5, 3, [5, 5], "randn"),
    "ties": (3, 6, 4, [6, 2, 4], "ints"),     # integer scores: many ties
    "single_step": (2, 1, 4, [1, 1], "randn"),
}


@pytest.mark.parametrize("bos_eos", [True, False])
@pytest.mark.parametrize("case", list(VITERBI))
def test_viterbi_matches_jax(pt, case, bos_eos):
    B, T, N, lens, kind = VITERBI[case]
    rng = np.random.RandomState(len(case))
    if kind == "ints":
        pot = rng.randint(0, 3, (B, T, N)).astype(np.float32)
        trans = rng.randint(0, 2, (N, N)).astype(np.float32)
    else:
        pot = rng.randn(B, T, N).astype(np.float32)
        trans = rng.randn(N, N).astype(np.float32)
    lens = np.asarray(lens, np.int64)
    out = [P.text.viterbi_decode(P.to_tensor(pot), P.to_tensor(trans),
                                 P.to_tensor(lens), bos_eos)
           for P in (pj, pt)]
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(),
                               rtol=REL, atol=REL)
    np.testing.assert_array_equal(out[1][1].numpy(), out[0][1].numpy())


def _brute_viterbi(pot, trans, L, bos_eos):
    T, N = pot.shape
    best, best_path = -np.inf, None
    for path in itertools.product(range(N), repeat=int(L)):
        s = pot[0, path[0]]
        if bos_eos:
            s += trans[N - 1, path[0]]
        for t in range(1, L):
            s += trans[path[t - 1], path[t]] + pot[t, path[t]]
        if bos_eos:
            s += trans[N - 2, path[L - 1]]
        if s > best:
            best, best_path = s, path
    return best, list(best_path) + [0] * (T - L)


def test_viterbi_matches_bruteforce(pt):
    rng = np.random.RandomState(3)
    pot = rng.rand(3, 4, 3).astype("float32")
    trans = rng.rand(3, 3).astype("float32")
    lens = np.array([4, 2, 3], "int64")
    for bos_eos in (False, True):
        scores, paths = pt.text.viterbi_decode(
            pt.to_tensor(pot), pt.to_tensor(trans), pt.to_tensor(lens),
            include_bos_eos_tag=bos_eos)
        for b in range(3):
            gs, gp = _brute_viterbi(pot[b], trans, lens[b], bos_eos)
            np.testing.assert_allclose(float(scores.numpy()[b]), gs,
                                       rtol=1e-5)
            assert paths.numpy()[b].tolist() == gp, (b, bos_eos)


def test_viterbi_decoder_layer(pt):
    rng = np.random.RandomState(0)
    pot = pt.to_tensor(rng.rand(2, 5, 4).astype("float32"))
    trans = pt.to_tensor(rng.rand(4, 4).astype("float32"))
    dec = pt.text.ViterbiDecoder(trans)
    scores, paths = dec(pot, pt.to_tensor(np.array([5, 3], "int64")))
    assert tuple(paths.shape) == (2, 5)
    assert paths.numpy()[1, 3:].tolist() == [0, 0]


# --------------------------------------------------------------- datasets
def _items_equal(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        for x, y in zip(_leaves(a[i]), _leaves(b[i])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _leaves(item):
    if isinstance(item, (tuple, list)):
        return [v for x in item for v in _leaves(x)]
    return [item]


def test_synthetic_text_datasets_match_jax(pt):
    _items_equal(pt.text.FakeTextDataset(5, 16, 100, seed=3),
                 pj.text.FakeTextDataset(5, 16, 100, seed=3))
    toks = np.arange(100, dtype=np.int64)
    _items_equal(pt.text.LMDataset(toks, 16), pj.text.LMDataset(toks, 16))


def _add(tf, name, text):
    data = text.encode("latin-1")
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _words(rng, n, vocab=("a", "b", "c", "the", "cat", "dog", "sat")):
    return " ".join(rng.choice(vocab, n))


def _imdb(path, rng):
    with tarfile.open(path, "w:gz") as tf:
        for part in ("train", "test"):
            for lab in ("pos", "neg"):
                for i in range(3):
                    _add(tf, f"aclImdb/{part}/{lab}/{i}_7.txt",
                         _words(rng, 12) + "! The.")


def _ptb(path, rng):
    with tarfile.open(path, "w:gz") as tf:
        for part in ("train", "valid"):
            _add(tf, f"./simple-examples/data/ptb.{part}.txt",
                 "\n".join(_words(rng, 6) for _ in range(5)))


def _movielens(path, rng):
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat", "\n".join(
            f"{m}::Film {m} (1999)::Drama|Comedy" for m in range(1, 5)))
        z.writestr("ml-1m/users.dat", "\n".join(
            f"{u}::{'MF'[u % 2]}::{18 + u}::{u % 3}::0000{u}"
            for u in range(1, 4)))
        z.writestr("ml-1m/ratings.dat", "\n".join(
            f"{rng.randint(1, 4)}::{rng.randint(1, 5)}::{rng.randint(1, 6)}"
            f"::97830{i}" for i in range(40)))


def _conll(path, rng):
    words = "\n".join(["The", "cat", "sat", "", "A", "dog", "ran", ""])
    props = "\n".join(["- (A0*", "- *)", "sat (V*)", "", "- (A0*", "- *)",
                       "ran (V*)", ""])
    with tarfile.open(path, "w:gz") as tf:
        _add(tf, "conll05st-release/test.wsj/words/test.wsj.words", words)
        _add(tf, "conll05st-release/test.wsj/props/test.wsj.props", props)


def _wmt14(path, rng):
    with tarfile.open(path, "w:gz") as tf:
        for part in ("train", "test"):
            _add(tf, f"wmt14/{part}/{part}.src",
                 "\n".join(_words(rng, 5) for _ in range(4)))
            _add(tf, f"wmt14/{part}/{part}.trg",
                 "\n".join(_words(rng, 6) for _ in range(4)))


def _wmt16(path, rng):
    with tarfile.open(path, "w:gz") as tf:
        for part in ("train", "val"):
            for lang in ("en", "de"):
                _add(tf, f"wmt16/{part}.{lang}",
                     "\n".join(_words(rng, 5) for _ in range(4)))


def _uci(path, rng):
    path.write_text("\n".join(" ".join(f"{v:.4f}" for v in row)
                              for row in rng.rand(20, 14) * 10))


DATASETS = {
    "UCIHousing": (_uci, "housing.data", [dict(mode="train"),
                                          dict(mode="test")]),
    "Imdb": (_imdb, "aclImdb.tar.gz", [dict(mode="train", cutoff=1)]),
    "Imikolov": (_ptb, "ptb.tgz", [dict(data_type="NGRAM", window_size=3,
                                        min_word_freq=2),
                                   dict(data_type="SEQ", mode="test",
                                        min_word_freq=1)]),
    "Movielens": (_movielens, "ml-1m.zip", [dict(mode="train"),
                                            dict(mode="test")]),
    "Conll05st": (_conll, "conll05.tgz", [dict()]),
    "WMT14": (_wmt14, "wmt14.tgz", [dict(mode="train", dict_size=8)]),
    "WMT16": (_wmt16, "wmt16.tgz", [dict(mode="train"),
                                    dict(mode="val", lang="de")]),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_reference_datasets_match_jax(pt, tmp_path, name):
    make, fname, kws = DATASETS[name]
    path = tmp_path / fname
    make(path, np.random.RandomState(11))
    for kw in kws:
        a = getattr(pt.text, name)(data_file=str(path), **kw)
        b = getattr(pj.text, name)(data_file=str(path), **kw)
        _items_equal(a, b)


def test_reference_datasets_need_a_file(pt):
    for name in DATASETS:
        with pytest.raises(RuntimeError, match="cannot download"):
            getattr(pt.text, name)()


# ------------------------------------------------------------ BERT, ERNIE
def _bert_cfg(P):
    from importlib import import_module
    m = import_module(P.__name__ + ".text.models")
    return m.BertConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0,
                        max_position_embeddings=64)


def _pair(pt, make):
    """(JAX model, port model with the JAX weights)."""
    pj.seed(5)
    jm, tm = make(pj), make(pt)
    _carry(jm, tm)
    return jm, tm


def _ids(B=3, S=16, V=97, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, S)).astype(np.int64),
            rng.randint(0, 2, (B, S)).astype(np.int64))


def test_bert_forward_matches_jax(pt):
    jm, tm = _pair(pt, lambda P: P.text.models.Bert(_bert_cfg(P)))
    ids, tt = _ids()
    outs = [m(P.to_tensor(ids), P.to_tensor(tt))
            for m, P in ((jm, pj), (tm, pt))]
    for g, w in zip(outs[1], outs[0]):
        _close(g.numpy(), w.numpy())


def _adam_steps(P, model, ids, tt, labels, nsp, steps=3):
    opt = P.optimizer.AdamW(1e-3, parameters=model.parameters(),
                            weight_decay=0.01)
    losses, grads = [], None
    for i in range(steps):
        loss = model.loss(P.to_tensor(ids), P.to_tensor(labels),
                          P.to_tensor(tt), P.to_tensor(nsp))
        loss.backward()
        if i == 0:
            grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    moments = [np.asarray(opt._accumulators[id(p)]["moment1"])
               for p in model.parameters()]
    return losses, grads, moments


def test_bert_pretraining_matches_jax(pt):
    """Logits, the MLM + NSP loss (ignore_index=-1), the first gradients
    and the first moments after three AdamW steps."""
    jm, tm = _pair(pt, lambda P: P.text.models.BertForPretraining(
        _bert_cfg(P)))
    ids, tt = _ids(seed=1)
    rng = np.random.RandomState(2)
    labels = np.where(rng.rand(*ids.shape) < 0.3, ids, -1).astype(np.int64)
    nsp = rng.randint(0, 2, (ids.shape[0],)).astype(np.int64)
    for m, P in ((jm, pj), (tm, pt)):
        m.eval()
    logits = [m(P.to_tensor(ids), P.to_tensor(tt))
              for m, P in ((jm, pj), (tm, pt))]
    for g, w in zip(logits[1], logits[0]):
        _close(g.numpy(), w.numpy())
    for m in (jm, tm):
        m.train()
    jl, jg, jmom = _adam_steps(pj, jm, ids, tt, labels, nsp)
    tl, tg, tmom = _adam_steps(pt, tm, ids, tt, labels, nsp)
    np.testing.assert_allclose(tl, jl, rtol=REL, atol=REL)
    _grads_close(tg, jg)
    scale = max(float(np.abs(w).max()) for w in jmom)
    for g, w in zip(tmom, jmom):
        np.testing.assert_allclose(g, w, rtol=GRAD, atol=GRAD * scale)


def _ernie_cfg(P, **kw):
    return P.text.models.ernie_tiny_config(hidden_dropout_prob=0.0,
                                           attention_probs_dropout_prob=0.0,
                                           **kw)


@pytest.mark.parametrize("use_task_id", [True, False])
def test_ernie_matches_jax(pt, use_task_id):
    jm, tm = _pair(pt, lambda P: P.text.models.Ernie(
        _ernie_cfg(P, use_task_id=use_task_id)))
    ids, tt = _ids(V=1000, seed=3)
    task = np.random.RandomState(4).randint(0, 3, ids.shape).astype(np.int64)
    outs = [m(P.to_tensor(ids), P.to_tensor(tt), P.to_tensor(task))
            for m, P in ((jm, pj), (tm, pt))]
    for g, w in zip(outs[1], outs[0]):
        _close(g.numpy(), w.numpy())


def test_ernie_heads_match_jax(pt):
    jc, tc = _pair(pt, lambda P: P.text.models.ErnieForSequenceClassification(
        _ernie_cfg(P), num_classes=3))
    jp, tp = _pair(pt, lambda P: P.text.models.ErnieForPretraining(
        _ernie_cfg(P)))
    ids, tt = _ids(V=1000, seed=5)
    labels = np.where(np.random.RandomState(6).rand(*ids.shape) < 0.3, ids,
                      -1).astype(np.int64)
    sop = np.array([0, 1, 1], np.int64)
    _close(tc(pt.to_tensor(ids)).numpy(), jc(pj.to_tensor(ids)).numpy())
    losses = []
    for m, P in ((jp, pj), (tp, pt)):
        loss = m.loss(P.to_tensor(ids), P.to_tensor(labels),
                      P.to_tensor(tt), P.to_tensor(sop))
        loss.backward()
        losses.append((float(loss), {n: p.grad.numpy()
                                     for n, p in m.named_parameters()}))
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=REL)
    _grads_close(losses[1][1], losses[0][1])


def test_ernie_factories_and_configs(pt):
    M, J = pt.text.models, pj.text.models
    assert vars(M.ernie_3_base_config()) == vars(J.ernie_3_base_config())
    assert vars(M.ernie_tiny_config()) == vars(J.ernie_tiny_config())
    assert isinstance(M.ernie_tiny(), M.Ernie)
    assert callable(M.ernie_pipeline_descs) and \
        callable(J.ernie_pipeline_descs)


def test_ernie_forward_and_classification(pt):
    cfg = pt.text.models.ernie_tiny_config()
    m = pt.text.models.ErnieForSequenceClassification(cfg, num_classes=3)
    ids = pt.to_tensor(np.random.RandomState(0)
                       .randint(0, cfg.vocab_size, (2, 16)))
    assert list(m(ids).shape) == [2, 3]


def test_ernie_pretraining_loss_decreases(pt):
    pt.seed(1)
    cfg = pt.text.models.ernie_tiny_config()
    m = pt.text.models.ErnieForPretraining(cfg)
    o = pt.optimizer.Adam(5e-4, parameters=m.parameters())
    rng = np.random.RandomState(2)
    ids = pt.to_tensor(rng.randint(0, cfg.vocab_size, (4, 16)))
    labels = pt.to_tensor(rng.randint(0, cfg.vocab_size, (4, 16)))
    losses = []
    for _ in range(8):
        loss = m.loss(ids, labels)
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.3, losses


# ------------------------------------------------------------- GPT family
@pytest.mark.parametrize("name", ["gpt_tiny", "gpt_125m", "gpt_350m",
                                  "gpt_1p3b", "gpt_6p7b"])
def test_gpt_constructors_match_jax(monkeypatch, name):
    """The widths of each constructor (the models are not built: 6.7B in
    f32 is 27 GB), and the port's device / seed pass through."""
    from paddle_tpu.text.models import gpt as jg
    from paddle_tpu_torch.text.models import gpt as tg
    monkeypatch.setattr(jg, "GPT", lambda cfg: cfg)
    monkeypatch.setattr(tg, "GPT", lambda cfg, device, seed:
                        (cfg, device, seed))
    jc = getattr(jg, name)()
    tc, device, seed = getattr(tg, name)(device="cpu", seed=3)
    assert (device, seed) == ("cpu", 3)
    for f in ("vocab_size", "max_position_embeddings", "hidden_size",
              "num_layers", "num_heads", "intermediate_size"):
        assert getattr(tc, f) == getattr(jc, f), f
    import paddle_tpu_torch.text.models as M
    assert getattr(M, name) is getattr(tg, name)


def _gpt_d128(pt):
    from paddle_tpu.text.models.gpt import GPT as JGPT, GPTConfig as JCfg
    from paddle_tpu_torch.text.models import GPT, GPTConfig
    from paddle_tpu_torch.text.models.convert import load_jax_params
    kw = dict(hidden_size=256, num_layers=2, num_heads=2,
              max_position_embeddings=128, vocab_size=512)
    pj.seed(11)
    jm = JGPT(JCfg(**kw))
    jm.eval()
    tm = load_jax_params(GPT(GPTConfig(**kw), device="cpu"),
                         {k: np.asarray(v)
                          for k, v in jm.state_dict().items()})
    return jm, tm


def _streams(eng, steps=6):
    rows = []
    for s, n in enumerate((9, 30)):
        p = np.random.RandomState(40 + s).randint(0, 512, n)
        rows.append([eng.prefill(s, p)])
    for _ in range(steps):
        out = eng.decode()
        for s in range(2):
            rows[s].append(int(out[s]))
    return rows


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_engine_head_dim_128_matches_jax(pt, kv):
    from paddle_tpu.serving import PagedGenerationEngine as JPaged
    from paddle_tpu_torch.serving import PagedGenerationEngine
    jm, tm = _gpt_d128(pt)
    kw = dict(slots=2, max_len=64, block_size=8, attention_impl="kernel")
    if kv == "int8":
        kw["kv_dtype"] = "int8"
    tk = PagedGenerationEngine(tm, device="cpu", **kw)
    assert tm.cfg.hidden_size // tm.cfg.num_heads == 128
    assert _streams(tk) == _streams(JPaged(jm, **kw))
    assert tk.kernel_launches == 0          # CPU tensors: the plain version
