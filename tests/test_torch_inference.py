"""The port's deploy path against the JAX package's, on the CPU:
`serving.save_for_generation`, the `.gencfg` record, and
`inference.Predictor`.

  * gencfg: for dense, paged and speculative configs with the same
    explicit fields, the port's `.gencfg` JSON equals the JAX one, the
    serving record's `config` and `executables` included; `as_dict()`
    round-trips and leaves the machine-local `compile_cache_dir` out;
  * JAX -> port: a JAX `save_for_generation` artifact of `gpt_tiny`
    (dense and paged records) served by the port's Predictor
    (`disable_gpu()`): `generate` token-exact with the JAX
    `Predictor.generate`, `run` logits within atol 1e-4, rtol 0 of the
    JAX `Predictor.run` (float32, the serving tests' tolerance); explicit
    engine kwargs replace the recorded engine;
  * port -> JAX: a port artifact read by the JAX `framework.io.load` and
    `load_generation_model` gives the port model's logits within 1e-4;
  * restart: one process saves with `precompile=True` (the report reads
    "eager" on the CPU) and serves; a second process loads a Predictor
    whose streams equal the first's;
  * defaults: a Predictor runs on the card unless `disable_gpu()`, and
    raises without CUDA; weights without a `.gencfg` or a program raise
    FileNotFoundError; a "tp" record builds the tensor-parallel engine
    with no warning, and a record that fails to build raises from the
    constructor.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.framework import io as jio
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate_predictor
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import PagedEngineConfig as JPagedConfig
from paddle_tpu.serving import SpecDecodeConfig as JSpecConfig
from paddle_tpu.serving import GenerationEngine as JGenerationEngine
from paddle_tpu.serving import save_for_generation as jsave
from paddle_tpu.serving.engine import load_generation_model as jload_model
from paddle_tpu.text.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.serving import (EngineConfig, GenerationEngine,
                                      PagedEngineConfig,
                                      PagedGenerationEngine, make_engine,
                                      save_for_generation)
from paddle_tpu_torch.serving.spec_decode import SpecDecodeConfig
from paddle_tpu_torch.text.models import gpt_tiny
from paddle_tpu_torch.text.models.convert import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
LENGTHS = (1, 7, 9, 17)
MAX_NEW = 6
ENGINE = dict(slots=2, max_len=64)
PAGED = dict(block_size=8)
SPEC = dict(gamma=3, draft_layers=1)


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 1000, n).tolist() for n in LENGTHS]


@pytest.fixture(scope="module")
def models():
    """(JAX tiny GPT, the port's tiny GPT on the CPU with its weights)."""
    paddle_tpu.seed(7)
    jm = jgpt_tiny()
    jm.eval()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, load_jax_params(gpt_tiny(device="cpu"), params)


@pytest.fixture(scope="module")
def jax_artifacts(models, tmp_path_factory):
    """{kind: (prefix, JAX Predictor, JAX streams)} for a dense and a paged
    serving record of the JAX tiny GPT."""
    jm, _ = models
    d = tmp_path_factory.mktemp("jax_artifacts")
    out = {}
    for kind, cfg in (("dense", JEngineConfig(**ENGINE)),
                      ("paged", JPagedConfig(**ENGINE, **PAGED))):
        prefix = str(d / kind)
        jsave(jm, prefix, engine_config=cfg)
        jcfg = JConfig(prefix + ".pdmodel", prefix + ".pdiparams")
        # leave JAX's process-wide persistent cache alone: the recorded
        # engine is then built at the first generate()
        jcfg.disable_compile_cache()
        pred = jcreate_predictor(jcfg)
        out[kind] = (prefix, pred, pred.generate(_prompts(),
                                                  max_new_tokens=MAX_NEW))
    return out


def _cpu_predictor(path):
    cfg = Config(path)
    cfg.disable_gpu()
    return create_predictor(cfg)


@pytest.mark.parametrize("kind", ["dense", "paged", "spec"])
def test_gencfg_equals_jax(models, tmp_path, kind):
    jm, tm = models
    jcls, tcls, kw = {
        "dense": (JEngineConfig, EngineConfig, ENGINE),
        "paged": (JPagedConfig, PagedEngineConfig,
                  dict(ENGINE, **PAGED, attention_impl="kernel")),
        "spec": (JSpecConfig, SpecDecodeConfig,
                 dict(ENGINE, **PAGED, **SPEC, attention_impl="kernel",
                      numerics_taps=True))}[kind]
    jsave(jm, str(tmp_path / "j"), engine_config=jcls(**kw))
    save_for_generation(tm, str(tmp_path / "t"), engine_config=tcls(**kw))
    with open(tmp_path / "j.gencfg") as f, open(tmp_path / "t.gencfg") as g:
        jrec, trec = json.load(f), json.load(g)
    assert trec == jrec
    assert trec["serving"]["engine"] == kind
    assert not os.path.exists(tmp_path / "t.pdmodel")
    # the payload is jit.save's: params in the JAX names and layout
    got = jio.load(str(tmp_path / "t.pdiparams"), return_numpy=True)
    want = jio.load(str(tmp_path / "j.pdiparams"), return_numpy=True)
    assert got["feed_names"] == want["feed_names"] == ["input_ids"]
    assert got["buffers"] == want["buffers"] == {}
    assert sorted(got["params"]) == sorted(want["params"])
    for name, arr in want["params"].items():
        assert got["params"][name].shape == arr.shape, name
        np.testing.assert_array_equal(got["params"][name], arr)


def test_as_dict_round_trips_and_stays_machine_free(tmp_path):
    cfg = SpecDecodeConfig(**ENGINE, **PAGED, **SPEC, numerics_taps=True,
                           attention_impl="gather",
                           compile_cache_dir=str(tmp_path))
    d = cfg.as_dict()
    assert d["numerics_taps"] is True and "compile_cache_dir" not in d
    assert (d["gamma"], d["draft_layers"]) == (3, 1)
    assert SpecDecodeConfig(**d).as_dict() == d
    jd = JSpecConfig(**ENGINE, **PAGED, **SPEC, numerics_taps=True,
                     attention_impl="gather").as_dict()
    assert d == jd


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_port_predictor_serves_jax_artifact(jax_artifacts, kind):
    prefix, jpred, jstreams = jax_artifacts[kind]
    pred = _cpu_predictor(prefix)
    assert pred.precompile_report == dict.fromkeys(
        pred.engine.executable_names(), "eager")
    assert type(pred.engine) is {"dense": GenerationEngine,
                                 "paged": PagedGenerationEngine}[kind]
    assert pred.engine.config.as_dict() == \
        json.load(open(prefix + ".gencfg"))["serving"]["config"]
    assert set(pred.ready_stages) == {
        "weights_read_s", "model_build_s", "engine_build_s", "libraries_s",
        "captures_s"}
    streams = pred.generate(_prompts(), max_new_tokens=MAX_NEW)
    assert streams == jstreams
    assert len(pred.last_ttft_s) == len(LENGTHS)
    ids = np.random.RandomState(5).randint(0, 1000, (2, 256))
    (want,) = jpred.run([ids])
    (got,) = pred.run([ids])
    assert got.shape == want.shape == (2, 256, 1024)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the handle form
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(ids[:1])
    assert pred.run() is True
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, want[:1], atol=ATOL, rtol=0)


def test_explicit_kwargs_replace_the_recorded_engine(jax_artifacts):
    prefix, _, jstreams = jax_artifacts["paged"]
    pred = _cpu_predictor(prefix)
    assert isinstance(pred.engine, PagedGenerationEngine)
    got = pred.generate([[5, 6]], max_new_tokens=2, slots=3, max_len=16)
    assert type(pred.engine) is GenerationEngine
    assert pred.engine.config.slots == 3 and len(got[0]) == 2
    # a kwargs-built engine is kept by later calls
    pred.generate([[5, 6]], max_new_tokens=1, slots=1)
    assert pred.engine.config.slots == 3
    # warm-up off: the recorded engine is built on the first generate
    cfg = Config(prefix)
    cfg.disable_gpu()
    cfg.disable_aot_warmup()
    lazy = create_predictor(cfg)
    assert lazy.engine is None
    assert lazy.generate(_prompts(), max_new_tokens=MAX_NEW) == jstreams
    assert isinstance(lazy.engine, PagedGenerationEngine)


def test_jax_reads_the_port_artifact(models, tmp_path):
    _, tm = models
    prefix = str(tmp_path / "port")
    save_for_generation(tm, prefix, engine_config=PagedEngineConfig(
        **ENGINE, **PAGED))
    payload = jio.load(prefix + ".pdiparams", return_numpy=True)
    jm2 = jload_model(prefix, payload["params"])
    ids = np.random.RandomState(6).randint(0, 1000, (2, 48))
    want = tm(torch.from_numpy(ids)).detach().numpy()
    got = jm2(paddle_tpu.to_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # and the JAX dense engine serves it as the port's Predictor does
    jeng = JGenerationEngine(jm2, JEngineConfig(**ENGINE))
    first = jeng.prefill(0, np.asarray(_prompts()[1]))
    pred = _cpu_predictor(prefix)
    assert pred.generate([_prompts()[1]], max_new_tokens=1)[0] == [first]


def test_restart_serves_the_saved_streams(tmp_path):
    prefix = str(tmp_path / "art")
    prompts = json.dumps(_prompts())
    save = textwrap.dedent(f"""
        import json
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.serving import (PagedEngineConfig,
                                              save_for_generation)
        from paddle_tpu_torch.text.models import gpt_tiny
        m = gpt_tiny(device="cpu", seed=3)
        report = save_for_generation(
            m, {prefix!r}, engine_config=PagedEngineConfig(
                slots=2, max_len=64, block_size=8), precompile=True)
        cfg = Config({prefix!r})
        cfg.disable_gpu()
        streams = create_predictor(cfg).generate({prompts}, max_new_tokens=5)
        print(json.dumps({{"report": report, "streams": streams}}))
        """)
    load = textwrap.dedent(f"""
        import json
        from paddle_tpu_torch.inference import Config, create_predictor
        cfg = Config({os.path.dirname(prefix)!r})
        cfg.disable_gpu()
        pred = create_predictor(cfg)
        print(json.dumps({{"report": pred.precompile_report,
            "capture_counts": pred.engine.capture_counts,
            "streams": pred.generate({prompts}, max_new_tokens=5)}}))
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = []
    for code in (save, load):
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, r.stderr
        out.append(json.loads(r.stdout.strip().splitlines()[-1]))
    first, second = out
    names = ["decode", "prefill[32]", "prefill[64]"]
    assert first["report"] == dict.fromkeys(names, "eager")
    assert second["report"] == dict.fromkeys(names, "eager")
    assert second["capture_counts"] == {}
    assert second["streams"] == first["streams"]
    assert os.path.isdir(tmp_path / "_compile_cache")


def test_predictor_defaults_to_the_card(jax_artifacts):
    prefix = jax_artifacts["dense"][0]
    cfg = Config(prefix)
    assert cfg.use_gpu() and cfg.torch_device() == "cuda:0"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_predictor(cfg)
    cfg.disable_gpu()
    assert create_predictor(cfg).engine.device.type == "cpu"


def test_artifact_without_a_record_raises(tmp_path):
    """Weights with neither a `.gencfg` record nor a program raise; the
    `jit.save` program of a Layer serves (tests/test_torch_jit.py)."""
    from paddle_tpu_torch.framework import io as tio
    tio.save({"params": {}, "buffers": {}, "feed_names": ["x"]},
             str(tmp_path / "layer.pdiparams"))
    with pytest.raises(FileNotFoundError, match="neither"):
        _cpu_predictor(str(tmp_path / "layer"))
    with pytest.raises(FileNotFoundError):
        Config(str(tmp_path))   # no .gencfg or .pdmodel in the directory


def test_a_record_the_port_cannot_build_falls_back(models, tmp_path):
    """No record falls back any more: a "tp" record is built as the
    tensor-parallel engine, with no warning, and serves the dense
    engine's tokens; an unknown kind raises."""
    _, tm = models
    prefix = str(tmp_path / "tp")
    save_for_generation(tm, prefix, engine_config=EngineConfig(**ENGINE))
    with open(prefix + ".gencfg") as f:
        meta = json.load(f)
    meta["serving"]["engine"] = "tp"
    with open(prefix + ".gencfg", "w") as f:
        json.dump(meta, f)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pred = _cpu_predictor(prefix)
    from paddle_tpu_torch.serving.distributed import \
        TensorParallelPagedEngine
    assert type(pred.engine) is TensorParallelPagedEngine
    got = pred.generate([[1, 2, 3]], max_new_tokens=3)
    dense = GenerationEngine(tm, device="cpu", **ENGINE)
    want = [dense.prefill(0, [1, 2, 3])]
    want += [int(dense.decode()[0]) for _ in range(2)]
    assert got[0] == want
    with pytest.raises(ValueError, match="unknown serving engine kind"):
        make_engine(tm, "tq", EngineConfig(**ENGINE).as_dict(), device="cpu")


@pytest.mark.parametrize("field,value,error", [
    ("max_len", 4096, ValueError),          # over the model's positions
    ("num_blocks", 1, ValueError),          # none beyond the garbage block
    ("kv_dtype", "float64", ValueError),
    ("not_a_field", 1, TypeError),
])
def test_a_paged_record_that_fails_to_build_raises(models, tmp_path, field,
                                                   value, error):
    _, tm = models
    prefix = str(tmp_path / "paged")
    save_for_generation(tm, prefix,
                        engine_config=PagedEngineConfig(**ENGINE, **PAGED))
    with open(prefix + ".gencfg") as f:
        meta = json.load(f)
    meta["serving"]["config"][field] = value
    with open(prefix + ".gencfg", "w") as f:
        json.dump(meta, f)
    with pytest.raises(error):
        _cpu_predictor(prefix)


def test_dense_engine_executables_are_the_jax_engines(models, tmp_path):
    jm, tm = models
    eng = GenerationEngine(tm, EngineConfig(**ENGINE), device="cpu")
    jeng = JGenerationEngine(jm, JEngineConfig(**ENGINE))
    assert eng.executable_names() == jeng.executable_names()
    assert eng.precompile() == dict.fromkeys(jeng.executable_names(),
                                             "eager")
    assert eng.capture_counts == {}
    with pytest.raises(ValueError, match="engine_config"):
        save_for_generation(tm, str(tmp_path / "x"), precompile=True)


def test_enums_and_helpers():
    assert inference.PlaceType.GPU == "gpu"
    assert inference.get_num_bytes_of_data_type(
        inference.DataType.BFLOAT16) == 2
    assert inference.get_version() == paddle_tpu.__version__
    assert inference.get_trt_compile_version() == (0, 0, 0)
    assert inference._get_phi_kernel_name("matmul") == "matmul"
    with pytest.raises(NotImplementedError):
        inference.convert_to_mixed_precision("a", "b", "c", "d")
    assert inference.Tensor is inference._Handle
