"""The port's `utils`, `version`, `sysconfig`, `hub`, `linalg` and
`utils.cpp_extension`, and the custom-op recipe's kernel op, against the
JAX package's on the CPU.

* `deprecated`, `require_version`, `try_import`, `unique_name`,
  `download` (local files only) and `hub` (source="local" only) behave as
  the reference's on the same calls; both refuse anything remote with
  RuntimeError.
* `cpp_extension.load` builds the same `.cc` as the reference's (g++),
  reuses its content-addressed library, raises with the compiler's output
  on a failed build, and sends `.cu` sources to nvcc with the port's
  Hopper flags (a stand-in `nvcc` on PATH here, which logs its arguments
  and compiles the source as C++).
* The recipe op `paddle_tpu_torch::scale_shift` (CPU tensors take its
  plain version `x * a + b`) against the reference's `scale_shift`,
  imported from tests/test_custom_op_recipe.py, whose Pallas kernel runs
  in interpret mode here: values and the gradient `g * a` within 1e-6
  relative (float32; the two compilers may contract `x * a + b` into one
  FMA differently), the op traced by `torch.export` and by the port's
  `to_static` (the counterpart of `test_custom_kernel_op_under_jit`).
  The kernel itself runs only on the card
  (`tests/test_torch_recipe_cuda.py`, chip_smoke.py phase 30 (a)).
"""
import os
import stat
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu_torch.utils.cpp_extension import recipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_custom_op_recipe as ref_recipe  # noqa: E402

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def test_deprecated_require_version_try_import():
    for P in (pj, pt):
        @P.utils.deprecated(update_to="paddle.new_api", since="0.1")
        def old():
            return 42

        with pytest.warns(DeprecationWarning):
            assert old() == 42

        @P.utils.deprecated(level=2)
        def gone():
            return 0

        with pytest.raises(RuntimeError):
            gone()
        assert P.utils.require_version("0.0.1")
        assert P.utils.require_version("0.1", "0.1.0")
        with pytest.raises(Exception):
            P.utils.require_version("99.0")
        with pytest.raises(Exception):
            P.utils.require_version("0.0.1", "0.0.9")
        assert P.utils.try_import("numpy") is np
        with pytest.raises(ImportError):
            P.utils.try_import("definitely_not_a_module_xyz")
    assert pt.version.full_version == pj.version.full_version
    assert (pt.version.with_gpu, pt.version.with_tpu) == ("ON", "OFF")


def test_run_check_on_the_cpu_and_refusal_without_cuda(capsys,
                                                       monkeypatch):
    pt.utils.run_check(device="cpu")
    assert "successfully" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.utils.run_check()


def test_unique_name_sequences_match():
    def run(P):
        un = P.utils.unique_name
        out = [un.generate("fc"), un.generate("fc"), un.generate("conv")]
        with un.guard():
            out += [un.generate("fc"), un.generate("fc")]
        with un.guard("blk/"):
            out.append(un.generate("fc"))
        pre = un.switch()
        out.append(un.generate("fc"))
        un.switch(pre)
        out.append(un.generate("fc"))
        return out

    j, t = run(pj), run(pt)
    # the process-wide counters may have advanced differently before
    assert [n.rsplit("_", 1)[0] for n in j] == \
        [n.rsplit("_", 1)[0] for n in t]
    assert t[3:7] == ["fc_0", "fc_1", "blk/fc_0", "fc_0"] == j[3:7]
    assert int(t[1].rsplit("_", 1)[1]) == int(t[0].rsplit("_", 1)[1]) + 1
    assert int(t[7].rsplit("_", 1)[1]) == int(t[1].rsplit("_", 1)[1]) + 1


def test_download_local_only(tmp_path, monkeypatch):
    for P in (pj, pt):
        monkeypatch.setattr(P.utils.download, "WEIGHTS_HOME", str(tmp_path))
        url = "https://example.com/w.pdparams"
        with pytest.raises(RuntimeError):
            P.utils.download.get_weights_path_from_url(url)
        with pytest.raises(RuntimeError):
            P.utils.download.get_path_from_url(url, root_dir=str(tmp_path))
    (tmp_path / "w.pdparams").write_bytes(b"x")
    for P in (pj, pt):
        assert P.utils.download.get_weights_path_from_url(url) == \
            str(tmp_path / "w.pdparams")
        assert P.utils.download.get_path_from_url(
            url, root_dir=str(tmp_path)) == str(tmp_path / "w.pdparams")


def test_hub_local(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def tiny_model(scale=1):\n"
        "    'A tiny model.'\n"
        "    return {'scale': scale}\n")
    for P in (pj, pt):
        assert P.hub.list(str(tmp_path), source="local") == ["tiny_model"]
        assert P.hub.help(str(tmp_path), "tiny_model",
                          source="local") == "A tiny model."
        assert P.hub.load(str(tmp_path), "tiny_model", source="local",
                          scale=3) == {"scale": 3}
        # an explicit local path is taken as local whatever the source
        assert P.hub.list(str(tmp_path)) == ["tiny_model"]
        for src in ("github", "gitee"):
            with pytest.raises(RuntimeError):
                P.hub.load("user/repo", "m", source=src)


def test_sysconfig_and_linalg_namespace():
    inc = pt.sysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, "flash_attention.cu"))
    assert pt.sysconfig.get_lib().endswith(os.path.join("build",
                                                        "paddle_tpu_torch"))
    names = [n for n in dir(pj.linalg) if not n.startswith("_")
             and callable(getattr(pj.linalg, n))]
    assert names and all(callable(getattr(pt.linalg, n)) for n in names)
    rng = np.random.RandomState(0)
    a = rng.rand(4, 4).astype("float32") + 4 * np.eye(4, dtype="float32")
    for fn, m in (("det", a), ("inv", a), ("cond", a),
                  ("matrix_exp", a / 8)):
        want = np.asarray(getattr(pj.linalg, fn)(pj.to_tensor(m)).numpy())
        got = getattr(pt.linalg, fn)(pt.to_tensor(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# the reference's modules of ROADMAP 13h, and A.8's `incubate.autotune`
_MODULES = ["sparse", "sparse.nn", "sparse.nn.functional", "sparse.nn.conv",
            "distribution", "distribution.transform", "quantization",
            "quantization.observers", "geometric", "incubate", "incubate.nn",
            "incubate.nn.functional", "incubate.asp", "incubate.autograd",
            "incubate.autotune",
            "incubate.checkpoint", "incubate.optimizer",
            "incubate.optimizer.functional",
            "incubate.optimizer.functional.lbfgs",
            "incubate.optimizer.wrappers", "incubate.operators", "linalg",
            "hub", "sysconfig", "version", "utils", "utils.unique_name",
            "utils.download", "utils.cpp_extension", "static.sparsity"]
# names the reference's modules import for their own use
_IMPORTED = {"next_key", "Tensor"}


@pytest.mark.parametrize("name", _MODULES)
def test_every_public_name_has_a_counterpart(name):
    import importlib
    import types
    ref = importlib.import_module("paddle_tpu." + name)
    port = importlib.import_module("paddle_tpu_torch." + name)
    missing = []
    for n in dir(ref):
        v = getattr(ref, n)
        if n.startswith("_") or n in _IMPORTED:
            continue
        mod = v.__name__ if isinstance(v, types.ModuleType) else \
            getattr(v, "__module__", None)
        if isinstance(mod, str) and not mod.startswith("paddle_tpu"):
            continue                 # numpy, jax, functools, ...
        if not hasattr(port, n):
            missing.append(n)
    assert not missing, missing
    for n in getattr(ref, "__all__", []):
        assert n in getattr(port, "__all__", dir(port)) or \
            n in _IMPORTED, n


_CC = 'extern "C" int add3(int x) { return x + 3; }\n'


def test_cpp_extension_load_cc_both_packages(tmp_path):
    src = tmp_path / "add3.cc"
    src.write_text(_CC)
    (tmp_path / "j").mkdir()     # the reference's load does not make it
    libj = pj.utils.cpp_extension.load(
        "add3", [str(src)], build_directory=str(tmp_path / "j"))
    libt = pt.utils.cpp_extension.load(
        "add3", [str(src)], build_directory=str(tmp_path / "t"))
    assert libj.add3(4) == libt.add3(4) == 7
    built = [f for f in os.listdir(tmp_path / "t") if f.endswith(".so")]
    assert len(built) == 1 and built[0].startswith("add3_")
    mtime = os.path.getmtime(tmp_path / "t" / built[0])
    again = pt.utils.cpp_extension.load(
        "add3", [str(src)], build_directory=str(tmp_path / "t"))
    assert again.add3(1) == 4
    assert os.path.getmtime(tmp_path / "t" / built[0]) == mtime
    # another source is another key
    src.write_text(_CC.replace("x + 3", "x + 30"))
    lib2 = pt.utils.cpp_extension.load(
        "add3", [str(src)], build_directory=str(tmp_path / "t"))
    assert lib2.add3(1) == 31
    assert len([f for f in os.listdir(tmp_path / "t")
                if f.endswith(".so")]) == 2


def test_cpp_extension_failed_build_raises_with_output(tmp_path):
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="bad.cc") as e:
        pt.utils.cpp_extension.load("bad", [str(src)],
                                    build_directory=str(tmp_path))
    assert "error" in str(e.value)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


_FAKE_NVCC = """#!{python}
import subprocess, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
out = args[args.index("-o") + 1]
src = [a for a in args if a.endswith(".cu")][0]
sys.exit(subprocess.call(["g++", "-x", "c++", "-shared", "-fPIC", src,
                          "-o", out]))
"""


def test_cpp_extension_load_cu_goes_to_nvcc(tmp_path, monkeypatch):
    from paddle_tpu_torch._kernels.build import NVCC_FLAGS
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src = tmp_path / "k.cu"
    src.write_text(_CC)
    lib = pt.utils.cpp_extension.load(
        "k", [str(src)], extra_cuda_cflags=["-lineinfo"],
        extra_cxx_cflags=["-Wall"], build_directory=str(tmp_path / "b"))
    assert lib.add3(0) == 3
    args = log.read_text().split()
    assert args[:len(NVCC_FLAGS)] == list(NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in args
    assert "-lineinfo" in args and args[args.index("-Wall") - 1] == \
        "-Xcompiler"


def test_cpp_extension_setuptools_helper():
    ext = pt.utils.cpp_extension.CppExtension(["a.cc"], name="m")
    assert ext.name == "m" and ext.sources == ["a.cc"]
    assert ext.language == "c++"


# ------------------------------------------------- the recipe's kernel op
def _x(shape=(8, 128), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


@pytest.mark.parametrize("a,b", [(2.0, 1.0), (3.0, 0.0), (-0.7, 0.25)])
def test_recipe_op_matches_reference(a, b):
    x = _x()
    xj = pj.to_tensor(x, stop_gradient=False)
    oj = ref_recipe.scale_shift(xj, a=a, b=b)
    (oj * oj).sum().backward()
    xt = pt.to_tensor(x, stop_gradient=False)
    ot = recipe.scale_shift(xt, a=a, b=b)
    (ot * ot).sum().backward()
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj.numpy()),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(xj.grad.numpy()),
                               rtol=TOL, atol=TOL)
    # the plain version is x * a + b with two roundings, bit for bit
    np.testing.assert_array_equal(
        ot.numpy(), (torch.from_numpy(x) * a + b).numpy())


def test_recipe_plain_in_bf16_and_the_launch_count():
    x = torch.from_numpy(_x((3, 5))).to(torch.bfloat16)
    before = recipe.launches
    o = recipe.scale_shift_raw(x, 1.5, -0.5)
    assert o.dtype == torch.bfloat16
    assert torch.equal(o, x * 1.5 + -0.5)
    assert recipe.launches == before     # a CPU tensor launches nothing


def test_recipe_op_exports_and_traces():
    class M(torch.nn.Module):
        def forward(self, x):
            return recipe.scale_shift_raw(x, 3.0, 0.5)

    x = torch.from_numpy(_x())
    ep = torch.export.export(M(), (x,))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets == ["paddle_tpu_torch.scale_shift.default"], targets
    assert torch.equal(ep.module()(x), x * 3.0 + 0.5)

    # the reference's test_custom_kernel_op_under_jit
    @pt.jit.to_static
    def f(t):
        return recipe.scale_shift(t, 3.0, 0.0).sum()

    val = f(pt.to_tensor(np.ones((8, 128), "float32")))
    assert float(val) == pytest.approx(3.0 * 8 * 128)
    want = ref_recipe._scale_shift(np.ones((8, 128), "float32"), 3.0,
                                   0.0).sum()
    assert float(val) == pytest.approx(float(want))


def test_recipe_launch_refuses_other_dtypes_before_the_library():
    before = recipe.launches
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        recipe._launch(torch.ones(2, dtype=torch.float16), 1.0, 0.0)
    assert recipe.launches == before
