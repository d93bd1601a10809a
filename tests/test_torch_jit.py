"""The port's `jit` (`to_static`, `save` / `load`, the Predictor over a
saved program) against the JAX package's, on the CPU: the counterparts of
the jit half of `tests/test_inference.py`, a tiny BERT through every
route, and the port's own contracts.

* The oracle's save/load cases run in both packages on the same weights
  (carried with `set_state_dict`) and inputs: outputs at 1e-5, shapes at
  every batch size of a `None` dim. Left out: the persistent-compile-cache
  case (XLA's cache, ROADMAP C.3). The quantized deploy is
  `tests/test_torch_quantization.py::test_quantized_deploy_roundtrip`.
* BERT (2 layers, hidden 64, 2 heads, S=16, a key-padding mask): the
  port's eager forward, `to_static`, `jit.save` -> `jit.load`, the
  Predictor and `Executor.run` against each other and against the JAX
  package's `to_static` / `jit.save` / Predictor, at 1e-5. The attention
  takes the kernel route (monkeypatched `sdpa_route`, so CPU tensors run
  the flash ops' plain versions) and the saved program holds one
  `flash_fwd` node per layer.
* `.pdiparams` reads both ways: names and arrays equal.
* A saved program with flash nodes runs after `jit.load` in a fresh
  process that imports only `paddle_tpu_torch`, at batch 1, 5 and 17.
* A program loads only for the device type it was traced on; a JAX
  `.pdmodel` (StableHLO) raises and says what it is.
* Dropout in a train-mode `to_static` program draws at every call: two
  calls keep different elements, the same generator state the same.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework import io as jio
from paddle_tpu_torch.framework import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture
def kernel_route(monkeypatch):
    import paddle_tpu_torch.nn.functional.attention as A
    monkeypatch.setattr(A, "sdpa_route", lambda q, k, d: "kernel")


def _carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


def _small_net(P):
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.BatchNorm1D(16), P.nn.Linear(16, 4))
    net.eval()
    return net


def _pair(make):
    pj.seed(0)
    j, t = make(pj), make(pt)
    _carry(j, t)
    return {pj: j, pt: t}


def _spec(P, shape, dtype="float32", name=None):
    return P.static.InputSpec(shape, dtype, name)


# ------------------------------------------------- the oracle's cases
def test_jit_save_load_roundtrip(tmp_path):
    x = np.random.RandomState(0).rand(3, 8).astype("float32")
    got = {}
    for P, net in _pair(_small_net).items():
        want = net(P.to_tensor(x)).numpy()
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=[_spec(P, [None, 8])])
        got[P] = P.jit.load(path)(P.to_tensor(x)).numpy()
        np.testing.assert_allclose(got[P], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[pt], got[pj], rtol=TOL, atol=TOL)


def test_jit_load_polymorphic_batch(tmp_path):
    nets = _pair(_small_net)
    for P, net in nets.items():
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=[_spec(P, [None, 8])])
        nets[P] = P.jit.load(path)
    for bs in (1, 5, 17):
        x = np.random.RandomState(bs).rand(bs, 8).astype(np.float32)
        outs = [nets[P](P.to_tensor(x)).numpy() for P in (pj, pt)]
        assert list(outs[1].shape) == [bs, 4]
        np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)


def test_jit_save_requires_input_spec(tmp_path):
    for P in (pj, pt):
        with pytest.raises(ValueError):
            P.jit.save(_small_net(P), str(tmp_path / "m"))


def _config(P, path):
    cfg = P.inference.Config(path + ".pdmodel", path + ".pdiparams")
    if P is pt:
        cfg.disable_gpu()
    return cfg


def test_predictor_handles(tmp_path):
    x = np.random.RandomState(1).rand(4, 8).astype("float32")
    outs = {}
    for P, net in _pair(_small_net).items():
        want = net(P.to_tensor(x)).numpy()
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=[_spec(P, [None, 8])])
        cfg = _config(P, path)
        cfg.enable_memory_optim()
        pred = P.inference.create_predictor(cfg)
        names = pred.get_input_names()
        assert names == ["input_0"]
        pred.get_input_handle(names[0]).copy_from_cpu(x)
        assert pred.run() is True
        out = pred.get_output_handle(pred.get_output_names()[0]) \
            .copy_to_cpu()
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        out2 = pred.run([x])[0]                    # direct-list form
        np.testing.assert_allclose(out2, want, rtol=1e-5, atol=1e-5)
        outs[P] = out2
    np.testing.assert_allclose(outs[pt], outs[pj], rtol=TOL, atol=TOL)


def test_save_load_inference_model(tmp_path):
    x = np.ones((2, 8), np.float32)
    for P, net in _pair(_small_net).items():
        path = str(tmp_path / P.__name__)
        P.static.save_inference_model(path, [_spec(P, [None, 8])], net)
        prog, feeds, fetches = P.static.load_inference_model(path)
        assert feeds == ["input_0"] and fetches == ["output_0"]
        np.testing.assert_allclose(prog(P.to_tensor(x)).numpy(),
                                   net(P.to_tensor(x)).numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_save_inference_model_function_form(tmp_path):
    a = np.random.RandomState(2).rand(2, 3).astype("float32")
    b = np.random.RandomState(3).rand(3, 2).astype("float32")
    for P in (pj, pt):
        def fn(u, v):
            return P.matmul(u, v)

        path = str(tmp_path / P.__name__)
        P.static.save_inference_model(
            path, [_spec(P, [2, 3]), _spec(P, [3, 2])], fn)
        loaded = P.jit.load(path)
        np.testing.assert_allclose(
            loaded(P.to_tensor(a), P.to_tensor(b)).numpy(), a @ b,
            rtol=1e-5, atol=1e-5)


def _two_in(P):
    class TwoIn(P.nn.Layer):
        def forward(self, a, b):
            return P.matmul(a + b, P.transpose(a, [1, 0]))
    return TwoIn()


def test_multi_input_shared_batch_dim(tmp_path):
    for P in (pj, pt):
        path = str(tmp_path / P.__name__)
        P.jit.save(_two_in(P), path,
                   input_spec=[_spec(P, [None, 8]), _spec(P, [None, 8])])
        loaded = P.jit.load(path)
        for bs in (2, 6):
            a = P.to_tensor(np.ones((bs, 8), np.float32))
            assert list(loaded(a, a).shape) == [bs, bs]
    ep = pt.jit.load(str(tmp_path / "paddle_tpu_torch"))._exported
    dims = [n.meta["val"].shape[0] for n in ep.graph.nodes
            if n.op == "placeholder"]
    assert len(dims) == 2 and str(dims[0]) == str(dims[1])   # one Dim


def test_executor_runs_loaded_program(tmp_path):
    x = np.random.RandomState(4).rand(3, 8).astype("float32")
    outs = {}
    for P, net in _pair(_small_net).items():
        path = str(tmp_path / P.__name__)
        P.static.save_inference_model(path, [_spec(P, [None, 8])], net)
        prog, feeds, fetches = P.static.load_inference_model(path)
        outs[P] = P.static.Executor().run(prog, feed={feeds[0]: x},
                                          fetch_list=fetches)[0]
        np.testing.assert_allclose(outs[P], net(P.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[pt], outs[pj], rtol=TOL, atol=TOL)


def _two_out(P):
    class TwoOut(P.nn.Layer):
        def forward(self, x):
            return x * 2.0, x.sum()
    return TwoOut()


def test_multi_output_fetch_names(tmp_path):
    for P in (pj, pt):
        path = str(tmp_path / P.__name__)
        P.static.save_inference_model(path, [_spec(P, [2, 2])], _two_out(P))
        _, feeds, fetches = P.static.load_inference_model(path)
        assert fetches == ["output_0", "output_1"]


def test_jit_save_uses_to_static_spec(tmp_path):
    x = np.random.RandomState(5).rand(3, 8).astype(np.float32)
    outs = {}
    for P, net in _pair(_small_net).items():
        net = P.jit.to_static(net, input_spec=[_spec(P, [None, 8])])
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path)       # no explicit input_spec
        outs[P] = P.jit.load(path)(P.to_tensor(x)).numpy()
        assert list(outs[P].shape) == [3, 4]
    np.testing.assert_allclose(outs[pt], outs[pj], rtol=TOL, atol=TOL)


def test_bf16_params_roundtrip(tmp_path):
    nets = _pair(lambda P: P.nn.Linear(4, 4))
    outs = {}
    for P, net in nets.items():
        net._cast_all("bfloat16")
        net.eval()
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=[_spec(P, [2, 4], "bfloat16")])
        loaded = P.jit.load(path)
        x = P.to_tensor(np.ones((2, 4), np.float32), dtype="bfloat16")
        want = net(x).astype("float32").numpy()
        outs[P] = loaded(x).astype("float32").numpy()
        np.testing.assert_allclose(outs[P], want, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(outs[pt], outs[pj], rtol=1e-2, atol=1e-2)


def test_program_capture_ir_surface():
    """Program.capture exposes the ProgramDesc-style op/var graph; a
    jaxpr's `dot_general` is the port's `mm` (ROADMAP C.18)."""
    for P, word in ((pj, "dot_general"), (pt, "mm")):
        def fn(x, y):
            return (x @ y).sum() * 2.0

        prog = P.static.Program.capture(fn, _spec(P, [4, 8]),
                                        _spec(P, [8, 2]))
        types = [op.type() for op in prog.ops()]
        assert word in types, types
        assert prog.num_blocks == 1
        assert len(prog.var_names()) >= 3
        assert word in prog.to_string()
        op = prog.ops()[0]
        assert op.input_arg_names() and op.output_arg_names()


def test_executor_legacy_feed_fallback_warns_loudly(tmp_path):
    import warnings
    x = np.random.RandomState(4).rand(3, 8).astype("float32")
    for P, net in _pair(_small_net).items():
        path = str(tmp_path / P.__name__)
        P.static.save_inference_model(path, [_spec(P, [None, 8])], net)
        prog, feeds, fetches = P.static.load_inference_model(path)
        exe = P.static.Executor()
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            want = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)[0]
        prog._feed_names = None
        with pytest.warns(DeprecationWarning,
                          match="NATURAL-SORTED.*TranslatedLayer"
                                "|TranslatedLayer.*NATURAL-SORTED"):
            got = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)[0]
        np.testing.assert_allclose(got, want)


# ------------------------------------------------------------------ BERT
def _bert(P):
    from importlib import import_module
    m = import_module(P.__name__ + ".text.models")
    cfg = m.BertConfig(vocab_size=97, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=128,
                       max_position_embeddings=64)
    net = m.Bert(cfg)
    net.eval()
    return net


def _bert_inputs(B=3, S=16, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, 1, 1, S), np.float32)
    mask[B // 2, ..., 11:] = -1e4                # a padded row
    return [rng.randint(0, 97, (B, S)).astype(np.int64),
            rng.randint(0, 2, (B, S)).astype(np.int64), mask]


def _bert_specs(P):
    return [_spec(P, [None, 16], "int64", "input_ids"),
            _spec(P, [None, 16], "int64", "token_type_ids"),
            _spec(P, [None, 1, 1, 16], "float32", "attention_mask")]


def test_bert_through_every_route(tmp_path, kernel_route):
    nets = _pair(_bert)
    ins = _bert_inputs()
    got = {}
    for P, net in nets.items():
        args = [P.to_tensor(a) for a in ins]
        eager = [o.numpy() for o in net(*args)]
        static = [o.numpy() for o in P.jit.to_static(net)(*args)]
        net.forward = type(net).forward.__get__(net)   # drop the wrapper
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=_bert_specs(P))
        loaded = [o.numpy() for o in P.jit.load(path)(*args)]
        pred = P.inference.create_predictor(_config(P, path))
        assert pred.get_input_names() == ["input_ids", "token_type_ids",
                                          "attention_mask"]
        served = pred.run(ins)
        prog, feeds, _ = P.static.load_inference_model(path)
        executed = P.static.Executor().run(prog, feed=dict(zip(feeds, ins)))
        for route in (static, loaded, served, executed):
            for a, b in zip(route, eager):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        got[P] = eager
    for a, b in zip(got[pt], got[pj]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    ep = pt.jit.load(str(tmp_path / "paddle_tpu_torch"))._exported
    flash = [n for n in ep.graph.nodes if "flash_fwd" in str(n.target)]
    assert len(flash) == 2                           # one a layer


def test_bert_predictor_at_several_batches(tmp_path, kernel_route):
    nets = _pair(_bert)
    preds = {}
    for P, net in nets.items():
        path = str(tmp_path / P.__name__)
        P.jit.save(net, path, input_spec=_bert_specs(P))
        preds[P] = P.inference.create_predictor(_config(P, path))
    assert set(preds[pt].ready_stages) == {"program_load_s",
                                           "weights_read_s", "first_run_s"}
    for B in (1, 4):
        ins = _bert_inputs(B=B, seed=B)
        outs = [preds[P].run(ins) for P in (pj, pt)]
        for a, b in zip(outs[1], outs[0]):
            assert a.shape[0] == B
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


# ------------------------------------------------------------ artifacts
def test_pdiparams_read_both_ways(tmp_path):
    nets = _pair(_small_net)
    for P, net in nets.items():
        P.jit.save(net, str(tmp_path / P.__name__),
                   input_spec=[_spec(P, [None, 8], name="x")])
    mine = tio.load(str(tmp_path / "paddle_tpu_torch.pdiparams"),
                    return_numpy=True)
    theirs = jio.load(str(tmp_path / "paddle_tpu.pdiparams"),
                      return_numpy=True)
    by_jax = jio.load(str(tmp_path / "paddle_tpu_torch.pdiparams"),
                      return_numpy=True)
    by_port = tio.load(str(tmp_path / "paddle_tpu.pdiparams"),
                       return_numpy=True)
    for a, b in ((by_jax, mine), (by_port, theirs), (mine, theirs)):
        assert a["feed_names"] == b["feed_names"] == ["x"]
        for part in ("params", "buffers"):
            assert list(a[part]) == list(b[part])
            for k in a[part]:
                np.testing.assert_array_equal(np.asarray(a[part][k]),
                                              np.asarray(b[part][k]))


def test_flash_program_loads_in_a_fresh_process(tmp_path, kernel_route):
    """The saved program holds `paddle_tpu_torch::flash_fwd` nodes; a
    process that imports only paddle_tpu_torch (which registers the ops)
    runs it at batch 1, 5 and 17 and gives the eager outputs."""
    net = _bert(pt)
    path = str(tmp_path / "bert")
    pt.jit.save(net, path, input_spec=_bert_specs(pt))
    want = {}
    for B in (1, 5, 17):
        ins = _bert_inputs(B=B, seed=B)
        np.savez(str(tmp_path / f"in{B}.npz"), *ins)
        want[B] = [o.numpy() for o in net(*[pt.to_tensor(a) for a in ins])]
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        m = pt.jit.load({path!r})
        ops = sorted({{str(n.target) for n in m._exported.graph.nodes
                       if "paddle_tpu_torch" in str(n.target)}})
        out = {{}}
        for B in (1, 5, 17):
            z = np.load({str(tmp_path)!r} + f"/in{{B}}.npz")
            ins = [pt.to_tensor(z[f"arr_{{i}}"]) for i in range(3)]
            out[B] = [o.numpy().tolist() for o in m(*ins)]
        print(json.dumps({{"ops": ops, "out": out}}))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["ops"] == ["paddle_tpu_torch.flash_fwd.default"]
    for B in (1, 5, 17):
        for a, b in zip(res["out"][str(B)], want[B]):
            np.testing.assert_allclose(np.asarray(a, np.float32), b,
                                       rtol=TOL, atol=TOL)


def test_program_refuses_another_device_type(tmp_path):
    from paddle_tpu_torch.jit import load_program
    net = _small_net(pt)
    path = str(tmp_path / "cpu")
    pt.jit.save(net, path, input_spec=[_spec(pt, [None, 8])])
    with pytest.raises(RuntimeError, match="traced on cpu"):
        load_program(path + ".pdmodel", torch.device("cuda"))
    assert load_program(path + ".pdmodel", torch.device("cpu")) is not None


def test_jax_pdmodel_is_refused(tmp_path):
    net = _small_net(pj)
    path = str(tmp_path / "jax")
    pj.jit.save(net, path, input_spec=[_spec(pj, [None, 8])])
    with pytest.raises(ValueError, match="StableHLO"):
        pt.jit.load(path)
    with pytest.raises(ValueError, match="StableHLO"):
        pt.inference.create_predictor(_config(pt, path))


def test_onnx_export_names_the_supported_route():
    for P, route in ((pj, "jit.save"), (pt, "jit.save")):
        with pytest.raises(RuntimeError, match=route.replace(".", r"\.")):
            P.onnx.export(_small_net(P), "x.onnx")


# --------------------------------------------------------------- dropout
def test_to_static_dropout_draws_every_call(kernel_route):
    """A train-mode program draws its dropout inside: the elementwise
    dropout from the generator, the attention's seed as a 0-d tensor the
    flash op reads. Two calls keep different elements; the same generator
    state keeps the same ones."""
    from paddle_tpu_torch.core.random import get_rng_state, set_rng_state
    pt.seed(0)
    layer = pt.nn.TransformerEncoderLayer(128, 2, 256, dropout=0.1,
                                          attn_dropout=0.1)
    layer.train()
    st = pt.jit.to_static(layer)
    x = pt.to_tensor(np.random.RandomState(0).randn(2, 128, 128)
                     .astype(np.float32))
    state = get_rng_state()
    a = st(x).numpy()
    b = st(x).numpy()
    assert not np.allclose(a, b)
    set_rng_state(state)
    np.testing.assert_array_equal(st(x).numpy(), a)
    (prog,) = st.forward.concrete_programs.values()
    seeds = [n for n in prog.graph.nodes if "flash_fwd" in str(n.target)]
    assert len(seeds) == 1 and seeds[0].args[-1].target is \
        torch.ops.aten.randint.low_generator


def test_config_finds_a_program_by_its_directory(tmp_path):
    """`Config(model_dir)` finds a `jit.save` program by its `.pdmodel`
    (a `.gencfg` record still wins); the Predictor over a program serves
    `run()` and refuses `generate()`."""
    net = _small_net(pt)
    pt.jit.save(net, str(tmp_path / "m"), input_spec=[_spec(pt, [None, 8])])
    cfg = pt.inference.Config(str(tmp_path))
    cfg.disable_gpu()
    assert cfg.prog_file().endswith("m.pdmodel")
    pred = pt.inference.create_predictor(cfg)
    x = np.random.RandomState(6).rand(2, 8).astype(np.float32)
    np.testing.assert_allclose(pred.run([x])[0], net(pt.to_tensor(x)).numpy(),
                               rtol=TOL, atol=TOL)
    with pytest.raises(TypeError, match="run"):
        pred.generate([[1, 2, 3]])
    (tmp_path / "a.gencfg").write_text("{}")
    assert pt.inference.Config(str(tmp_path)).prog_file().endswith(
        "a.gencfg")
