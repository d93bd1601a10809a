"""The port's `framework.io` and `framework.flags` against the JAX package's.

  * io: a JAX `framework.io.save` of nested dicts and lists (f32, bf16,
    int8 and int32 tensors, int64 numpy arrays, strings, numbers) reads
    back through the port's `load` with equal values and dtypes; the
    port's `save` of the same content is byte for byte the JAX file, and
    the JAX `load` reads it; a JAX file reads in a process where
    `import paddle_tpu` is blocked, and that process never puts a
    `paddle_tpu` module into `sys.modules`;
  * flags: the registry's names and defaults are the JAX one's, the
    environment sets them as the reference's loader does, and the cache
    flags attach the port's compile cache.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import io as jio
from paddle_tpu_torch.framework import compile_cache as cc
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays():
    rng = np.random.RandomState(3)
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "bf16": rng.standard_normal((4, 2)).astype(np.float32),
            "i8": rng.randint(-128, 128, (7,)).astype(np.int8),
            "i32": rng.randint(-1000, 1000, (2, 3)).astype(np.int32),
            "i64": rng.randint(-2 ** 40, 2 ** 40, (6,)).astype(np.int64)}


def _jax_obj(a):
    bf = paddle_tpu.to_tensor(a["bf16"]).astype("bfloat16")
    return {"weights": {"w": paddle_tpu.to_tensor(a["f32"]), "b": bf},
            "codes": [paddle_tpu.to_tensor(a["i8"]),
                      paddle_tpu.to_tensor(a["i32"]), "name"],
            "steps": a["i64"], "meta": {"epoch": 3, "tag": "v1"}}


def _torch_obj(a):
    return {"weights": {"w": torch.from_numpy(a["f32"]),
                        "b": torch.from_numpy(a["bf16"]).bfloat16()},
            "codes": [torch.from_numpy(a["i8"]), torch.from_numpy(a["i32"]),
                      "name"],
            "steps": a["i64"], "meta": {"epoch": 3, "tag": "v1"}}


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def test_jax_file_loads_in_the_port(tmp_path):
    a = _arrays()
    path = str(tmp_path / "j.pdparams")
    jio.save(_jax_obj(a), path)
    got = tio.load(path, device="cpu")
    w, b = got["weights"]["w"], got["weights"]["b"]
    assert w.dtype == torch.float32 and b.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.numpy(), a["f32"])
    np.testing.assert_array_equal(b.float().numpy(), _bf16_values(a["bf16"]))
    i8, i32, name = got["codes"]
    assert (i8.dtype, i32.dtype, name) == (torch.int8, torch.int32, "name")
    np.testing.assert_array_equal(i8.numpy(), a["i8"])
    np.testing.assert_array_equal(i32.numpy(), a["i32"])
    # a plain numpy array travels as itself, int64 included
    assert got["steps"].dtype == np.int64
    np.testing.assert_array_equal(got["steps"], a["i64"])
    assert got["meta"] == {"epoch": 3, "tag": "v1"}
    # numpy view: bfloat16 as its exact float32 values
    raw = tio.load(path, return_numpy=True)
    assert raw["weights"]["b"].dtype == np.float32
    np.testing.assert_array_equal(raw["weights"]["b"],
                                  _bf16_values(a["bf16"]))


def test_port_file_is_the_jax_file_and_jax_loads_it(tmp_path):
    a = _arrays()
    jpath, tpath = str(tmp_path / "j.pkl"), str(tmp_path / "sub" / "t.pkl")
    jio.save(_jax_obj(a), jpath)
    tio.save(_torch_obj(a), tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    got = jio.load(tpath)
    assert str(got["weights"]["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(got["weights"]["w"].numpy(), a["f32"])
    np.testing.assert_array_equal(
        np.asarray(got["weights"]["b"].numpy(), np.float32),
        _bf16_values(a["bf16"]))
    np.testing.assert_array_equal(got["codes"][0].numpy(), a["i8"])
    assert got["codes"][2] == "name"
    np.testing.assert_array_equal(got["steps"], a["i64"])
    # and the port reads its own file back
    back = tio.load(tpath, device="cpu")
    np.testing.assert_array_equal(back["codes"][1].numpy(), a["i32"])


def test_jax_file_loads_with_paddle_tpu_blocked(tmp_path):
    a = _arrays()
    path = str(tmp_path / "j.pkl")
    jio.save(_jax_obj(a), path)
    code = (
        "import json, sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'paddle_tpu':\n"
        "            raise ImportError('paddle_tpu is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "from paddle_tpu_torch.framework import io\n"
        "got = io.load(sys.argv[1], device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('paddle_tpu', 'jax')]\n"
        "print(json.dumps({'bad': bad,\n"
        "    'w': got['weights']['w'].tolist(),\n"
        "    'b': got['weights']['b'].float().tolist(),\n"
        "    'b_dtype': str(got['weights']['b'].dtype),\n"
        "    'i8': got['codes'][0].tolist(), 'steps': got['steps'].tolist(),\n"
        "    'steps_dtype': str(got['steps'].dtype), 'meta': got['meta']}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    np.testing.assert_array_equal(np.float32(got["w"]), a["f32"])
    assert got["b_dtype"] == "torch.bfloat16"
    np.testing.assert_array_equal(np.float32(got["b"]),
                                  _bf16_values(a["bf16"]))
    assert got["i8"] == a["i8"].tolist()
    assert (got["steps"], got["steps_dtype"]) == (a["i64"].tolist(), "int64")
    assert got["meta"] == {"epoch": 3, "tag": "v1"}


def test_numpy_core_names_map_both_ways():
    """A file naming `numpy.core.multiarray` (numpy 1) or
    `numpy._core.multiarray` (numpy 2) loads under this numpy."""
    import io
    want = np.zeros(1).__reduce__()[0]
    u = tio._Unpickler(io.BytesIO(b""))
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        assert u.find_class(mod, "_reconstruct") is want
    assert u.find_class("paddle_tpu.framework.io", "_TensorPayload") is \
        tio._TensorPayload


def test_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "t.pkl")
    tio.save({"w": torch.ones(2)}, path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.load(path)
    assert tio.load(path, return_numpy=True)["w"].tolist() == [1.0, 1.0]


def test_flags_registry_is_the_jax_one():
    # a fresh copy of the JAX module: its defaults, whatever other tests
    # in this process set since
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_fresh_jax_flags", jflags.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert tflags.get_flags() == fresh.get_flags()
    assert tflags.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": False}
    got = tflags.get_flags(["FLAGS_profile", "FLAGS_check_nan_inf"])
    assert got == {"FLAGS_profile": False, "FLAGS_check_nan_inf": False}


def test_flags_env_loading_and_cache_flags(tmp_path, monkeypatch):
    saved = dict(tflags._FLAGS)
    monkeypatch.setenv("FLAGS_check_nan_inf", "yes")
    monkeypatch.setenv("FLAGS_compile_cache_max_entries", "5")
    monkeypatch.setenv("FLAGS_fraction_of_gpu_memory_to_use", "0.5")
    monkeypatch.setenv("FLAGS_allocator_strategy", "auto_growth")
    try:
        tflags._load_env()
        jflags_before = dict(jflags._FLAGS)
        jflags._load_env()
        for k in ("FLAGS_check_nan_inf", "FLAGS_compile_cache_max_entries",
                  "FLAGS_fraction_of_gpu_memory_to_use",
                  "FLAGS_allocator_strategy"):
            assert tflags._FLAGS[k] == jflags._FLAGS[k], k
        assert tflags._FLAGS["FLAGS_compile_cache_max_entries"] == 5
        # the cap applies to every cache built without max_entries
        assert cc.CompileCache(str(tmp_path / "c")).max_entries == 5
        assert cc.CompileCache(str(tmp_path / "c"), 2).max_entries == 2
        # the XLA cache flag attaches the port's one compile cache
        assert tflags.enable_compilation_cache(str(tmp_path / "g"))
        assert cc.active().root == str(tmp_path / "g")
        tflags.set_flags({"FLAGS_compilation_cache_dir": ""})
        assert not tflags.enable_compilation_cache()
    finally:
        cc.detach()
        jflags._FLAGS.clear()
        jflags._FLAGS.update(jflags_before)
        tflags._FLAGS.clear()
        tflags._FLAGS.update(saved)
