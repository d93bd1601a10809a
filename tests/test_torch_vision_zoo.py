"""The port's model zoo against the JAX package's: the eval forward of
each family at a small input, and PP-YOLOE's forward, loss and
gradients, with weights carried from the port to the JAX model, on the
CPU.

The JAX side runs as one jitted `functional_call` a model (its eager
forward compiles each op, which costs minutes over the zoo); its models
are built with zero parameters (`test_torch_vision.py`'s `fast_jax`) and
then take the port's randomized weights (`randomize`: signal survives a
deep eval forward). Outputs are held within 1e-4 of the largest
magnitude.
"""
import numpy as np
import pytest

import paddle_tpu_torch as pt
from test_torch_vision import close, fast_jax, randomize  # noqa: F401

FORWARDS = [
    ("LeNet", 28), ("resnet18", 32), ("resnext50_32x4d", 32),
    ("wide_resnet50_2", 32), ("vgg11", 32), ("alexnet", 64),
    ("mobilenet_v1", 32), ("mobilenet_v2", 32), ("mobilenet_v3_small", 32),
    ("mobilenet_v3_large", 32), ("squeezenet1_0", 48),
    ("squeezenet1_1", 48), ("densenet121", 32), ("shufflenet_v2_x0_25", 32),
    ("shufflenet_v2_swish", 32), ("googlenet", 32), ("inception_v3", 80),
]


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield pt


def jit_call(net, *args, method=None, train=False, grad=False):
    """The JAX model under one jax.jit: outputs (and with `grad`, the
    gradient of a scalar output by parameter)."""
    import jax
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.nn.layer.layers import functional_call, functional_state
    params, buffers = functional_state(net)

    def run(p, *xs):
        out, _ = functional_call(net, p, buffers,
                                 args=tuple(Tensor(x) for x in xs),
                                 train=train, method=method)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(o._data for o in outs)
    if not grad:
        return [np.asarray(o) for o in jax.jit(run)(params, *args)]
    value, g = jax.jit(jax.value_and_grad(lambda p, *xs: run(p, *xs)[0]))(
        params, *args)
    return float(value), {n: np.asarray(v) for n, v in g.items()}


@pytest.mark.parametrize("name,size", FORWARDS, ids=[f[0] for f in FORWARDS])
def test_zoo_eval_forward_matches_jax(name, size, fast_jax):
    pj = fast_jax
    kw = {} if name == "LeNet" else dict(num_classes=10)
    t = getattr(pt.vision.models, name)(**kw)
    j = getattr(pj.vision.models, name)(**kw)
    j.set_state_dict(randomize(t))
    ch = 1 if name == "LeNet" else 3
    x = np.random.RandomState(0).rand(2, ch, size, size).astype(np.float32)
    t.eval()
    with pt.no_grad():
        got = t(pt.to_tensor(x)).numpy()
    want = jit_call(j, x)[0]
    assert got.shape == (2, 10)
    assert np.abs(want).max() > 1e-3          # the signal survived
    close(got, want, what=name)


def test_ppyoloe_forward_loss_and_grads_match_jax(fast_jax):
    pj = fast_jax
    cfg = dict(num_classes=4, width_mult=0.25, depth_mult=0.33)
    t = pt.vision.models.PPYOLOE(pt.vision.models.PPYOLOEConfig(**cfg))
    j = pj.vision.models.PPYOLOE(pj.vision.models.PPYOLOEConfig(**cfg))
    j.set_state_dict(randomize(t, 3))
    x = np.random.RandomState(1).rand(2, 3, 64, 64).astype(np.float32)
    gt_boxes = np.asarray([[[8, 8, 40, 40], [0, 0, 0, 0]],
                           [[16, 16, 56, 56], [4, 4, 20, 20]]], np.float32)
    gt_class = np.asarray([[1, 0], [2, 3]], np.int64)
    gt_mask = np.asarray([[1, 0], [1, 1]], np.float32)
    t.eval()
    with pt.no_grad():
        cls, reg = t(pt.to_tensor(x))
    jcls, jreg = jit_call(j, x)
    L = (64 // 8) ** 2 + (64 // 16) ** 2 + (64 // 32) ** 2
    assert cls.shape == [2, L, 4] and reg.shape == [2, L, 68]
    close(cls.numpy(), jcls, what="cls")
    close(reg.numpy(), jreg, what="reg")

    t.train()
    loss = pt.vision.models.ppyoloe_loss(
        t, pt.to_tensor(x), pt.to_tensor(gt_boxes), pt.to_tensor(gt_class),
        pt.to_tensor(gt_mask))
    loss.backward()
    jloss, jgrad = jit_call(
        j, x, train=True, grad=True,
        method=lambda layer, xx: pj.vision.models.ppyoloe_loss(
            layer, xx, gt_boxes, gt_class, gt_mask))
    close(float(loss), jloss, what="loss")
    for n, p in t.named_parameters():
        close(p.grad.numpy(), jgrad[n], rtol=1e-3, what=f"grad {n}")
    pts, strides = t.anchor_points((64, 64))
    jpts, jstrides = j.anchor_points((64, 64))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(jstrides))
