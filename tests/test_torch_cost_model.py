"""The port's analytical cost model against the JAX package's, on the CPU.

`paddle_tpu_torch/cost_model/analytical.py` walks the aten ops a function
dispatches on fake tensors where the reference walks a jaxpr; both price
FLOPs and bytes per op and lower them to a roofline time. Held here, after
`tests/test_cost_model.py`:

  * product FLOPs equal the JAX `estimate`'s `dot_general` FLOPs exactly
    (a lone matmul with its bytes, a 2-layer `nn.Linear` stack, a batched
    product), and convolution FLOPs its `conv_general_dilated` FLOPs;
  * the backward is priced when the function calls `.backward()`;
  * the roofline regimes at 4096² on the H100 entries;
  * the port's tiny GPT train step within 15% of the 6N + attention
    formula (`tests/test_cost_model.py:75`);
  * `CostModel.static_costs` / `get_static_op_time` / `profile_measure`;
  * no kernel library is ever loaded under the fake mode: the train step
    and the paged decode step take their plain paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.cost_model import estimate as jestimate
from paddle_tpu_torch.cost_model import (DEVICES, CostModel, estimate,
                                         fake_mode)

PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _product_flops(report):
    return sum(c.flops for k, c in report.by_op.items() if k in PRODUCTS)


def test_matmul_flops_and_bytes_equal_jax():
    a, b = np.zeros((64, 128), np.float32), np.zeros((128, 32), np.float32)
    port = estimate(lambda a, b: a @ b, torch.from_numpy(a),
                    torch.from_numpy(b))
    ref = jestimate(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    assert port.by_op["aten::mm"].flops == ref.by_op["dot_general"].flops \
        == 2 * 64 * 128 * 32
    assert port.by_op["aten::mm"].bytes == ref.by_op["dot_general"].bytes \
        == 4 * (64 * 128 + 128 * 32 + 64 * 32)


@pytest.mark.parametrize("batch", [(5,), (3, 7)])
def test_linear_stack_flops_equal_jax(batch):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 8))
    x = torch.zeros(batch + (16,))
    port = estimate(net, x)
    w1, b1 = (net[0].weight.detach().numpy().T, net[0].bias.detach().numpy())
    w2, b2 = (net[2].weight.detach().numpy().T, net[2].bias.detach().numpy())

    def jnet(x, w1, b1, w2, b2):
        return jnp.maximum(x @ w1 + b1, 0.0) @ w2 + b2
    ref = jestimate(jnet, jnp.zeros(batch + (16,)), *map(jnp.asarray,
                                                         (w1, b1, w2, b2)))
    assert _product_flops(port) == ref.by_op["dot_general"].flops \
        == 2 * int(np.prod(batch)) * (16 * 32 + 32 * 8)


def test_batched_and_conv_flops_equal_jax():
    a, b = np.zeros((8, 64, 32), np.float32), np.zeros((8, 32, 16), np.float32)
    port = estimate(torch.bmm, torch.from_numpy(a), torch.from_numpy(b))
    ref = jestimate(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                    jnp.asarray(a), jnp.asarray(b))
    assert port.by_op["aten::bmm"].flops == \
        ref.by_op["dot_general"].flops == 2 * 8 * 64 * 32 * 16
    x, w = np.zeros((2, 3, 16, 16), np.float32), np.zeros((8, 3, 3, 3),
                                                            np.float32)
    port = estimate(lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
                    torch.from_numpy(x), torch.from_numpy(w))
    ref = jestimate(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")),
        jnp.asarray(x), jnp.asarray(w))
    assert port.by_op["aten::convolution"].flops == \
        ref.by_op["conv_general_dilated"].flops == 2 * (2 * 8 * 16 * 16) * 27


def test_backward_is_priced():
    a = torch.zeros((4096, 4096), dtype=torch.bfloat16, requires_grad=True)
    r = estimate(lambda a: torch.tanh(a @ a).sum().backward(), a)
    assert r.by_op["aten::mm"].count == 3          # forward + two grads
    assert r.by_op["aten::mm"].flops == 3 * 2 * 4096 ** 3
    assert "aten::tanh_backward" in r.by_op
    assert r.by_op["aten::tanh"].flops == 8 * 4096 ** 2


@pytest.mark.parametrize("device", ["h100-sxm", "h100-sxm-fp32"])
def test_roofline_regimes(device):
    """A big matmul is compute-bound, an elementwise add bandwidth-bound."""
    dev = DEVICES[device]
    a = torch.zeros((4096, 4096), dtype=torch.bfloat16)
    c = estimate(lambda a: a @ a, a, device=device).by_op["aten::mm"]
    assert c.flops / dev.peak_flops > c.bytes / dev.hbm_bw
    c2 = estimate(lambda a: a + a, a, device=device).by_op["aten::add"]
    assert c2.bytes / dev.hbm_bw > c2.flops / dev.peak_flops
    assert c2.bytes == 3 * 2 * 4096 ** 2


def test_h100_entries():
    assert DEVICES["h100-sxm"].peak_flops == 989e12
    assert DEVICES["h100-sxm-fp32"].peak_flops == 67e12
    assert DEVICES["h100-sxm"].hbm_bw == DEVICES["h100-sxm-fp32"].hbm_bw \
        == 3.35e12
    assert set(DEVICES) == {"h100-sxm", "h100-sxm-fp32", "cpu"}


def _tiny_step():
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    cfg = GPTSpmdConfig(vocab_size=256, max_seq_len=64, hidden=64,
                        layers=2, heads=4, remat=False)
    step_fn, init_fn = make_train_step(cfg, learning_rate=1e-3,
                                       device="cpu")
    return cfg, step_fn, init_fn


def test_gpt_step_flops_match_bench_formula():
    """The walked tiny train step against the 6N + attention formula
    within 15%, as the reference holds its jaxpr walk."""
    from paddle_tpu_torch.parallel.gpt_spmd import param_shapes
    cfg, step_fn, init_fn = _tiny_step()
    B, S = 4, 64
    with fake_mode():
        params, state = init_fn(0)
        toks = torch.zeros((B, S), dtype=torch.int64)
        r = estimate(step_fn, params, state, toks, toks)
    n_params = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    fpt = 6 * n_params + 6 * cfg.layers * S * cfg.hidden
    assert r.total_flops == pytest.approx(B * S * fpt, rel=0.15)
    assert r.time_ms > 0
    assert r.by_op["aten::mm"].count > 0


def test_cost_model_static_table():
    cm = CostModel()
    a = torch.zeros((64, 64))
    report = cm.static_costs(lambda a: torch.tanh(a @ a), a)
    t = cm.get_static_op_time("aten::mm")
    assert t["flops"] == 2 * 64 ** 3
    assert t["time"] > 0 and t["time_per_call"] == t["time"]
    assert "aten::mm" in report.table()
    assert cm.get_static_op_time("aten::nothing") == {"time": 0.0,
                                                      "time_per_call": 0.0}


def test_profile_measure_on_the_cpu():
    cm = CostModel()
    a = torch.ones((8, 8))
    cost = cm.profile_measure(torch.mm, a, a, device="cpu", repeat=2)
    assert cost["time"] > 0
    assert cm.get_static_op_time("mm")["time"] == cost["time"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cm.profile_measure(torch.mm, a, a)


def test_no_kernel_library_under_the_fake_mode(monkeypatch):
    """Under fake CPU tensors no ctypes library is loaded, so no data_ptr
    of a fake tensor reaches one: the flash launches run their custom
    ops' fake versions (priced as the kernels), the paged wrapper its
    plain path."""
    from paddle_tpu_torch._kernels import build
    from paddle_tpu_torch.serving import PagedGenerationEngine
    from paddle_tpu_torch.text.models import gpt_tiny

    def refuse(name):
        raise AssertionError(f"kernel library {name} loaded under fakes")
    monkeypatch.setattr(build, "load", refuse)
    cfg, step_fn, init_fn = _tiny_step()
    with fake_mode():
        params, state = init_fn(0)
        toks = torch.zeros((2, 64), dtype=torch.int64)
        r = estimate(step_fn, params, state, toks, toks)
    fwd = r.by_op["flash_attention_fwd"]            # the kernels, priced
    assert fwd.count > 0 and fwd.flops > 0 and fwd.bytes > 0
    assert r.by_op["flash_attention_dq"].flops == \
        1.5 * fwd.flops
    model = gpt_tiny(device="cpu")
    with fake_mode():
        eng = PagedGenerationEngine(model, slots=2, max_len=64,
                                    block_size=8, attention_impl="kernel",
                                    device="cpu")
        r = estimate(eng._decode_fn, device="h100-sxm-fp32")
    assert r.total_flops > 0 and "aten::addmm" in r.by_op
