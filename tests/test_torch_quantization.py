"""The port's `quantization` against the JAX package's on the CPU, on the
same seeded numpy inputs, with the JAX nets' weights carried across by
`set_state_dict`.

* `fake_quant` per tensor, per channel and at a given scale: values and
  the straight-through gradient within 1e-6 (the port's STE is
  `x + (round(x) - x).detach()`, whose value is round(x) exactly).
* The observers are the reference's numpy: every algorithm's threshold on
  the same stream is equal (within 1e-12), and `PostTrainingQuantization`
  gives the same activation and weight scales (every algorithm, per
  tensor and per channel) within 1e-5 relative, and the same quantized
  outputs within 1e-5.
* QAT (`ImperativeQuantAware`): three SGD steps, losses and the
  moving-average activation scales within 1e-5.
* `fuse_conv_bn`: the fused net's eval output within 1e-5 of the JAX
  fused net's and within 2e-5 of its own unfused output (the reference
  test's bound), and a QuantedConv2D over it within 1e-5.
* The deploy round trip (`test_inference.py::test_quantized_deploy_roundtrip`
  on the port, on the CPU): PTQ (KL, per-channel weights), `jit.save`,
  the port's Predictor; served outputs within 1e-5 of the in-process
  quantized model and of the JAX package's quantized model; and a QAT
  model through `save_quantized_model` (the STE traces under export).
"""
import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from torch_jax_init import numpy_initializers

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: _np(v) for k, v in src.state_dict().items()})
    assert not missing and not unexpected


def _pair(make, seed=0):
    with numpy_initializers():
        pj.seed(seed)
        j = make(pj)
    t = make(pt)
    _carry(j, t)
    return j, t


@pytest.mark.parametrize("case", ["tensor", "channel0", "channel1",
                                  "scale", "bits4"])
def test_fake_quant_and_ste(case):
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5) * 2).astype("float32")
    res = []
    for P in (pj, pt):
        xt = P.to_tensor(x, stop_gradient=False)
        kw = {"tensor": {}, "channel0": {"channel_axis": 0},
              "channel1": {"channel_axis": 1}, "scale": {"scale": 1.5},
              "bits4": {"scale": 3.0, "bits": 4}}[case]
        q = P.quantization.fake_quant(xt, **kw)
        (q * P.to_tensor(np.arange(30, dtype="float32").reshape(6, 5))
         ).sum().backward()
        res.append((q, xt.grad))
    for a, b in zip(res[1], res[0]):
        _close(a, b, 1e-6)


def test_observer_thresholds_equal():
    rng = np.random.RandomState(1)
    batches = [rng.lognormal(0, 1.5, 4096).astype("float32")
               for _ in range(6)]
    batches.insert(2, np.zeros(10, "float32"))
    batches[3][:3] = [np.inf, -np.inf, np.nan]
    obs = {}
    for P in (pj, pt):
        o = P.quantization.HistogramObserver()
        for b in batches:
            o.collect(b)
        obs[P] = o
    np.testing.assert_array_equal(obs[pt].hist, obs[pj].hist)
    for algo in ("abs_max", "min_max", "avg", "hist", "KL", "mse"):
        for bits in (8, 4):
            assert obs[pt].threshold(algo, bits) == pytest.approx(
                obs[pj].threshold(algo, bits), rel=1e-12, abs=0), algo
    with pytest.raises(ValueError):
        obs[pt].threshold("nope")


def _small_net(P):
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.BatchNorm1D(16), P.nn.Linear(16, 4))
    net.eval()
    return net


def _batches(P, rng_seed=2, n=4):
    rng = np.random.RandomState(rng_seed)
    return [(P.to_tensor(rng.rand(4, 8).astype("float32")),)
            for _ in range(n)]


# every algorithm once, the two weight types taken in turn (the thresholds
# of every algorithm at both bit widths are held above on one stream; KL
# with per-channel weights is the deploy test's)
@pytest.mark.parametrize("algo,wtype", [
    ("mse", "abs_max"),
    ("hist", "channel_wise_abs_max"),
    ("abs_max", "channel_wise_abs_max"), ("min_max", "abs_max")])
def test_ptq_scales_and_outputs(algo, wtype):
    jnet, tnet = _pair(_small_net, 7)
    x = np.random.RandomState(3).rand(5, 8).astype("float32")
    res = {}
    for P, net in ((pj, jnet), (pt, tnet)):
        model, scales = P.quantization.PostTrainingQuantization(
            net, algo=algo, weight_quantize_type=wtype).quantize(
            _batches(P), batch_nums=4)
        res[P] = (scales, model(P.to_tensor(x)))
    _same_scales(res[pt][0], res[pj][0])
    _close(res[pt][1], res[pj][1])


def _same_scales(st, sj):
    assert sorted(st) == sorted(sj) and len(st) == 2
    for name in st:
        assert st[name]["activation"] == pytest.approx(
            sj[name]["activation"], rel=TOL)
        np.testing.assert_allclose(st[name]["weight"], sj[name]["weight"],
                                   rtol=TOL)


def test_qat_trains_like_the_reference():
    def make(P):
        return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                               P.nn.Linear(16, 2))
    jnet, tnet = _pair(make, 0)
    rng = np.random.RandomState(0)
    x = rng.rand(64, 8).astype("float32")
    y = (x.sum(1) > 4).astype("int64")
    res = {}
    for P, net in ((pj, jnet), (pt, tnet)):
        P.quantization.ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max").quantize(net)
        P.quantization.ImperativeQuantAware().quantize(net)   # idempotent
        assert isinstance(net[0], P.quantization.QuantedLinear)
        o = P.optimizer.SGD(0.5, parameters=net.parameters())
        lf = P.nn.CrossEntropyLoss()
        losses = []
        for _ in range(3):
            loss = lf(net(P.to_tensor(x)), P.to_tensor(y))
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        res[P] = (losses, float(net[0].act_scale.numpy()),
                  float(net[2].act_scale.numpy()))
    np.testing.assert_allclose(res[pt][0], res[pj][0], rtol=TOL)
    np.testing.assert_allclose(res[pt][1:], res[pj][1:], rtol=TOL)


def test_qat_conv_and_fuse_conv_bn():
    def make(P):
        return P.nn.Sequential(P.nn.Conv2D(3, 8, 3, padding=1),
                               P.nn.BatchNorm2D(8), P.nn.ReLU(),
                               P.nn.Conv2D(8, 4, 3, bias_attr=False),
                               P.nn.BatchNorm2D(4))
    jnet, tnet = _pair(make, 4)
    rng = np.random.RandomState(5)
    # BatchNorm statistics and affine terms away from their defaults
    state = {k: _np(v) for k, v in jnet.state_dict().items()}
    for k, v in state.items():
        if k.startswith(("1.", "4.")):
            state[k] = (rng.rand(*v.shape) + 0.5).astype("float32") \
                if k.endswith(("weight", "_variance")) else \
                rng.randn(*v.shape).astype("float32") * 0.3
    jnet.set_state_dict(state)
    tnet.set_state_dict(state)
    x = rng.rand(2, 3, 8, 8).astype("float32")
    res = {}
    for P, net in ((pj, jnet), (pt, tnet)):
        net.eval()
        before = net(P.to_tensor(x))
        P.quantization.fuse_conv_bn(net)
        assert type(net[1]).__name__ == "Identity"
        assert type(net[4]).__name__ == "Identity"
        after = net(P.to_tensor(x))
        np.testing.assert_allclose(_np(after), _np(before), atol=2e-5)
        P.quantization.ImperativeQuantAware().quantize(net)
        assert isinstance(net[0], P.quantization.QuantedConv2D)
        res[P] = (after, net(P.to_tensor(x)))
    for a, b in zip(res[pt], res[pj]):
        _close(a, b)


def test_quantized_deploy_roundtrip(tmp_path):
    """PTQ (KL, per-channel weights) -> jit.save -> the port's Predictor:
    the served outputs equal the in-process quantized model (the port's
    twin of test_inference.py::test_quantized_deploy_roundtrip) and the
    JAX package's quantized model."""
    jnet, tnet = _pair(_small_net, 7)
    x = np.random.RandomState(2).rand(5, 8).astype("float32")
    want, scales = {}, {}
    for P, net in ((pj, jnet), (pt, tnet)):
        model, scales[P] = P.quantization.PostTrainingQuantization(
            net, algo="KL").quantize(_batches(P), batch_nums=4)
        assert all(s["activation"] > 0 for s in scales[P].values())
        want[P] = _np(model(P.to_tensor(x)))
    _same_scales(scales[pt], scales[pj])
    np.testing.assert_allclose(want[pt], want[pj], rtol=TOL, atol=TOL)

    path = str(tmp_path / "q")
    pt.jit.save(tnet, path, input_spec=[pt.static.InputSpec([None, 8],
                                                            "float32")])
    cfg = pt.inference.Config(path + ".pdmodel", path + ".pdiparams")
    cfg.disable_gpu()
    pred = pt.inference.create_predictor(cfg)
    inp = pred.get_input_handle(pred.get_input_names()[0])
    inp.copy_from_cpu(x)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(got, want[pt], rtol=TOL, atol=TOL)


def test_qat_save_quantized_model(tmp_path):
    _, net = _pair(lambda P: P.nn.Sequential(P.nn.Linear(8, 6), P.nn.ReLU(),
                                             P.nn.Linear(6, 3)), 9)
    qat = pt.quantization.ImperativeQuantAware(
        weight_quantize_type="channel_wise_abs_max")
    qat.quantize(net)
    rng = np.random.RandomState(4)
    net.train()
    for _ in range(2):
        net(pt.to_tensor(rng.rand(4, 8).astype("float32")))
    path = str(tmp_path / "qat")
    qat.save_quantized_model(net, path, input_spec=[
        pt.static.InputSpec([None, 8], "float32")])
    x = rng.rand(3, 8).astype("float32")
    want = _np(net(pt.to_tensor(x)))
    loaded = pt.jit.load(path, device="cpu")
    np.testing.assert_allclose(_np(loaded(pt.to_tensor(x))), want,
                               rtol=TOL, atol=TOL)
