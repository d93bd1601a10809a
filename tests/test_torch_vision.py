"""The port's `vision` (model zoo layouts, ResNet-50, PP-YOLOE, datasets,
transforms) against the JAX package's, on the CPU.

Zoo layouts: every builder of `vision.models` in both packages, the
`state_dict` keys, shapes and order equal. The JAX models are built
with a zero-filling `create_parameter` (monkeypatched for the test; the
layout does not depend on the values, and the JAX initializers compile
once per shape). Forward parity at small inputs is in
`test_torch_vision_zoo.py`.

ResNet-50 in the reference's topology: weights carried from the port to
the JAX model, the eval forward and one training step's loss held to the
JAX model's (rtol 1e-4, atol 1e-4 of the largest magnitude), its
gradient through a float64 anchor (the test's docstring). Transforms:
the same arrays under one `np.random.seed`.
"""
import gzip
import io
import os
import pickle
import tarfile

import numpy as np
import pytest

import paddle_tpu_torch as pt


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield pt


@pytest.fixture
def fast_jax(monkeypatch):
    """The JAX package with parameters made as zeros (no initializer
    compile per shape)."""
    import paddle_tpu as pj
    from paddle_tpu.core.tensor import Parameter
    from paddle_tpu.nn.layer import layers as jlayers
    from paddle_tpu.nn.param_attr import ParamAttr

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        return Parameter(np.zeros(tuple(int(s) for s in shape), np.float32),
                         name=attr.name if attr else None,
                         trainable=attr.trainable if attr else True)
    monkeypatch.setattr(jlayers.Layer, "create_parameter", create_parameter)
    return pj


def layout(net):
    return [(k, tuple(v.shape)) for k, v in net.state_dict().items()]


def zoo_builders():
    from paddle_tpu_torch.vision import models
    skip = {"ppyoloe_loss"}
    return sorted(n for n, f in vars(models).items()
                  if callable(f) and n[0].islower() and n not in skip)


def build(P, name):
    f = getattr(P.vision.models, name)
    if name.startswith("ppyoloe"):
        return f(num_classes=4)
    return f(num_classes=10)


def test_zoo_exports_match_jax():
    import paddle_tpu as pj
    from paddle_tpu.vision import models as jm
    from paddle_tpu_torch.vision import models as tm
    public = {n for n in vars(jm) if not n.startswith("_")
              and n[0] != n[0].lower() or callable(vars(jm)[n])}
    missing = sorted(n for n in public if not hasattr(tm, n)
                     and not n.startswith("_") and n not in
                     ("alexnet", "densenet", "googlenet", "lenet",
                      "mobilenet", "mobilenetv3", "ppyoloe", "resnet",
                      "shufflenetv2", "squeezenet", "vgg"))
    assert missing == []
    assert len(zoo_builders()) == 40
    assert pj.vision.models.LeNet and pt.vision.models.LeNet


@pytest.mark.parametrize("name", ["LeNet"] + [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2", "vgg11", "vgg13", "vgg16",
    "vgg19", "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_large",
    "mobilenet_v3_small", "alexnet", "squeezenet1_0", "squeezenet1_1",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish", "googlenet",
    "inception_v3", "ppyoloe_crn_tiny", "ppyoloe_s"])
def test_zoo_state_dict_layout_matches_jax(name, fast_jax):
    pj = fast_jax
    if name == "LeNet":
        j, t = pj.vision.models.LeNet(), pt.vision.models.LeNet()
    else:
        j, t = build(pj, name), build(pt, name)
    assert layout(t) == layout(j)
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]


def test_vgg_batch_norm_and_sync_bn_layouts_match_jax(fast_jax):
    pj = fast_jax
    for kw in (dict(batch_norm=True), dict(batch_norm=False)):
        assert layout(pt.vision.models.vgg11(num_classes=10, **kw)) == \
            layout(pj.vision.models.vgg11(num_classes=10, **kw))
    cfg = dict(num_classes=4, width_mult=0.25, depth_mult=0.33, sync_bn=True)
    t = pt.vision.models.PPYOLOE(pt.vision.models.PPYOLOEConfig(**cfg))
    j = pj.vision.models.PPYOLOE(pj.vision.models.PPYOLOEConfig(**cfg))
    assert layout(t) == layout(j)
    assert any(type(m).__name__ == "SyncBatchNorm" for m in t.sublayers())


# --------------------------------------------------- carried weights, runs

def randomize(net, seed=0):
    """Weights that carry signal through a deep eval forward: N(0,
    1/fan_in) matrices and kernels, small biases, BatchNorm scales and
    variances around 1 (drawn with a seeded CPU torch generator, which
    is fast at vgg's 10^8 parameters)."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).numpy()

    def uniform(shape, lo, hi):
        return (torch.rand(shape, generator=g) * (hi - lo) + lo).numpy()
    out = {}
    for k, v in net.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("_variance"):
            a = uniform(shape, 0.5, 1.5)
        elif k.endswith("_mean"):
            a = normal(shape, 0.1)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 2 else shape[0]
            a = normal(shape, 1.0 / np.sqrt(fan_in))
        elif k.endswith("weight"):
            a = uniform(shape, 0.5, 1.5)
        else:
            a = normal(shape, 0.1)
        out[k] = a.astype(np.float32)
    net.set_state_dict(out)
    return out


def close(got, want, rtol=1e-4, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _grad_rel(got, want):
    """||got - want|| / ||want|| over every parameter's gradient."""
    num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
    den = sum(float(np.sum(want[n] ** 2)) for n in want)
    return float(np.sqrt(num / den))


def test_resnet50_forward_and_train_step_match_jax(fast_jax):
    """ResNet-50 in the reference's topology, weights carried across:

    * eval forward at B=2, 32x32: logits within 1e-4 of the largest;
    * one training step at B=8, 64x64 (train-mode BatchNorm,
      CrossEntropyLoss; the JAX side as `Model`'s jitted value_and_grad
      over `functional_call`): the loss within 1e-4 relative (2.3e-5
      read) and
      BatchNorm's new running statistics within 1e-4. Its gradient is
      ill-conditioned in float32 at this batch (train-mode BatchNorm over
      2x2 maps): both packages' float32 gradients are held to the port's
      float64 gradient (||g - g64|| / ||g64||; JAX read 3.2e-2, the port
      2.3e-2 on the CPU): the port's error at most 1.5x JAX's, JAX's
      under 5e-2, so a fault in the port's ops, shared by its float64
      run, shows as JAX's error;
    * then an SGD step moves every parameter by -lr times its gradient.
    """
    import jax
    from paddle_tpu.core.tensor import Tensor as JT
    from paddle_tpu.nn.layer.layers import functional_call as jcall
    from paddle_tpu.nn.layer.layers import functional_state as jstate
    pj = fast_jax
    t = pt.vision.models.resnet50(num_classes=10)
    j = pj.vision.models.resnet50(num_classes=10)
    state = randomize(t)
    j.set_state_dict(state)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    t.eval(), j.eval()
    close(t(pt.to_tensor(x)).numpy(), j(pj.to_tensor(x)).numpy(),
          what="eval logits")

    x = rng.rand(8, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.int64)
    params, buffers = jstate(j)

    def loss_fn(p, b):
        out, nb = jcall(j, p, b, args=(JT(x),), train=True)
        return pj.nn.functional.cross_entropy(out, JT(y))._data, nb
    (jloss, jbuf), jgrad = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, buffers)
    jgrad = {n: np.asarray(v) for n, v in jgrad.items()}

    def port_step(dtype):
        net = pt.vision.models.resnet50(num_classes=10)
        net.set_state_dict(state)
        net.to(dtype=dtype)
        net.train()
        loss = pt.nn.CrossEntropyLoss()(
            net(pt.to_tensor(x, dtype=dtype)), pt.to_tensor(y))
        loss.backward()
        return net, float(loss), {n: p.grad.numpy().astype(np.float64)
                                  for n, p in net.named_parameters()}
    t, tloss, g32 = port_step("float32")
    _, _, g64 = port_step("float64")
    close(tloss, float(jloss), what="train loss")
    for n, b in t.named_buffers():
        close(b.numpy(), np.asarray(jbuf[n]), what=f"buffer {n}")
    assert sorted(g32) == sorted(jgrad)
    port_err, jax_err = _grad_rel(g32, g64), _grad_rel(jgrad, g64)
    assert jax_err < 5e-2, jax_err
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)
    before = {n: p.numpy() for n, p in t.named_parameters()}
    pt.optimizer.SGD(0.1, parameters=t.parameters()).step()
    for n, p in t.named_parameters():
        np.testing.assert_allclose(p.numpy(), before[n] - 0.1 * g32[n],
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_ppyoloe_trains_on_port():
    """`tests/test_det_nlp_models.py`'s PP-YOLOE training check."""
    pt.seed(0)
    m = pt.vision.models.ppyoloe_crn_tiny(num_classes=4)
    o = pt.optimizer.Adam(1e-3, parameters=m.parameters())
    rng = np.random.RandomState(1)
    x = pt.to_tensor(rng.rand(2, 3, 64, 64).astype("float32"))
    gt = (pt.to_tensor(np.asarray([[[8, 8, 40, 40], [0, 0, 0, 0]],
                                   [[16, 16, 56, 56], [4, 4, 20, 20]]],
                                  np.float32)),
          pt.to_tensor(np.asarray([[1, 0], [2, 3]], np.int64)),
          pt.to_tensor(np.asarray([[1, 0], [1, 1]], np.float32)))
    losses = []
    for _ in range(5):
        loss = pt.vision.models.ppyoloe_loss(m, x, *gt)
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ---------------------------------------------------------------- datasets

def test_fakedata_equal_sample_for_sample():
    import paddle_tpu as pj
    for kw in (dict(), dict(num_samples=7, image_shape=(1, 5, 4),
                            num_classes=3, seed=11)):
        t = pt.vision.datasets.FakeData(**kw)
        j = pj.vision.datasets.FakeData(**kw)
        assert len(t) == len(j)
        for i in range(min(len(t), 6)):
            (ti, tl), (ji, jl) = t[i], j[i]
            np.testing.assert_array_equal(ti, ji)
            assert ti.dtype == np.float32 and tl == jl
            assert tl.dtype == np.int64
    t = pt.vision.datasets.FakeData(4, (3, 2, 2), transform=lambda a: a * 2)
    np.testing.assert_array_equal(
        t[1][0], pj.vision.datasets.FakeData(4, (3, 2, 2))[1][0] * 2)


def _write_cifar(path, top, members, label_key, n=6, seed=0):
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w:gz") as tf:
        for m in members:
            d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                 label_key: rng.randint(0, 10, n).tolist()}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(f"{top}/{m}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


@pytest.mark.parametrize("which", ["Cifar10", "Cifar100"])
def test_cifar_from_a_local_archive(tmp_path, which):
    import paddle_tpu as pj
    if which == "Cifar10":
        path = str(tmp_path / "cifar-10-python.tar.gz")
        _write_cifar(path, "cifar-10-batches-py",
                     [f"data_batch_{i}" for i in range(1, 6)]
                     + ["test_batch"], b"labels")
    else:
        path = str(tmp_path / "cifar-100-python.tar.gz")
        _write_cifar(path, "cifar-100-python", ["train", "test"],
                     b"fine_labels")
    for mode in ("train", "test"):
        t = getattr(pt.vision.datasets, which)(data_file=path, mode=mode)
        j = getattr(pj.vision.datasets, which)(data_file=path, mode=mode)
        assert len(t) == len(j) == (30 if which == "Cifar10" and
                                    mode == "train" else 6)
        for i in (0, len(t) - 1):
            np.testing.assert_array_equal(t[i][0], j[i][0])
            assert t[i][1] == j[i][1] and t[i][0].shape == (3, 32, 32)
    t = getattr(pt.vision.datasets, which)(
        data_file=path, mode="test", transform=lambda a: a.mean(axis=-1))
    assert t[0][0].shape == (32, 32)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        getattr(pt.vision.datasets, which)(
            data_file=str(tmp_path / "missing.tar.gz"))


def test_mnist_and_folders_from_local_files(tmp_path):
    import paddle_tpu as pj
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(b"\0" * 16 + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(b"\0" * 8 + labels.tobytes())
    for cls in ("MNIST", "FashionMNIST"):
        t = getattr(pt.vision.datasets, cls)(image_path=str(ip),
                                            label_path=str(lp))
        j = getattr(pj.vision.datasets, cls)(image_path=str(ip),
                                            label_path=str(lp))
        assert len(t) == len(j) == 5
        np.testing.assert_array_equal(t[3][0], j[3][0])
        assert t[3][1] == j[3][1]
    root = tmp_path / "folder"
    for c in ("b", "a"):
        os.makedirs(root / c / "sub")
        for k in range(2):
            np.save(root / c / f"x{k}.npy", np.full((2, 2), ord(c) + k))
        np.save(root / c / "sub" / "y.npy", np.zeros(2))
        (root / c / "skip.txt").write_text("no")
    t = pt.vision.datasets.DatasetFolder(str(root))
    j = pj.vision.datasets.DatasetFolder(str(root))
    assert t.classes == j.classes == ["a", "b"]
    assert t.samples == j.samples and len(t) == 6
    np.testing.assert_array_equal(t[1][0], j[1][0])
    ti = pt.vision.datasets.ImageFolder(str(root))
    jimg = pj.vision.datasets.ImageFolder(str(root))
    assert ti.samples == jimg.samples
    np.testing.assert_array_equal(ti[0][0], jimg[0][0])
    with pytest.raises(RuntimeError, match="no valid samples"):
        pt.vision.datasets.DatasetFolder(str(root), extensions=(".png",))
    with pytest.raises(RuntimeError, match="local"):
        pt.vision.datasets.Flowers()
    with pytest.raises(RuntimeError, match="local"):
        pt.vision.datasets.VOC2012()


def test_pil_stays_lazy():
    """Importing the port's vision package never imports PIL."""
    import subprocess
    import sys
    code = ("import sys\nimport paddle_tpu_torch.vision\n"
            "import paddle_tpu_torch.vision.ops\n"
            "assert not any(m.split('.')[0] == 'PIL' for m in sys.modules), "
            "[m for m in sys.modules if m.startswith('PIL')]\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr


# -------------------------------------------------------------- transforms

def _img(seed, shape=(12, 10, 3), u8=True):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape)
    return (a * 255).astype(np.uint8) if u8 else a.astype(np.float32)


TRANSFORMS = {
    "ToTensor": (lambda T: T.ToTensor(), True),
    "ToTensor_HWC": (lambda T: T.ToTensor(data_format="HWC"), True),
    "Normalize": (lambda T: T.Compose([T.ToTensor(), T.Normalize(
        [0.5, 0.4, 0.3], [0.2, 0.3, 0.4])]), True),
    "Normalize_HWC": (lambda T: T.Normalize(0.5, 0.25, data_format="HWC"),
                      False),
    "Resize": (lambda T: T.Resize((7, 9)), True),
    "Resize_int": (lambda T: T.Resize(6), False),
    "RandomCrop": (lambda T: T.RandomCrop(6, padding=2), True),
    "RandomCrop_pad_if_needed": (lambda T: T.RandomCrop(
        (14, 12), pad_if_needed=True), True),
    "CenterCrop": (lambda T: T.CenterCrop((5, 4)), True),
    "RandomHorizontalFlip": (lambda T: T.RandomHorizontalFlip(0.7), True),
    "RandomVerticalFlip": (lambda T: T.RandomVerticalFlip(0.7), True),
    "Transpose": (lambda T: T.Transpose(), True),
    "RandomResizedCrop": (lambda T: T.RandomResizedCrop(8), True),
    "BrightnessTransform": (lambda T: T.BrightnessTransform(0.4), True),
    "ContrastTransform": (lambda T: T.ContrastTransform(0.4), True),
    "SaturationTransform": (lambda T: T.SaturationTransform(0.4), True),
    "HueTransform": (lambda T: T.HueTransform(0.1), True),
    "ColorJitter": (lambda T: T.ColorJitter(0.2, 0.2, 0.2, 0.1), True),
    "Grayscale": (lambda T: T.Grayscale(3), True),
    "Pad": (lambda T: T.Pad((1, 2), fill=(1.0, 2.0, 3.0)), False),
    "Pad_reflect": (lambda T: T.Pad(2, padding_mode="reflect"), True),
    "RandomRotation": (lambda T: T.RandomRotation(30), True),
    "RandomRotation_expand": (lambda T: T.RandomRotation(
        (40, 50), expand=True, fill=7), False),
    "RandomErasing": (lambda T: T.RandomErasing(prob=1.0, value=0), False),
    "RandomAffine": (lambda T: T.RandomAffine(20, translate=(0.1, 0.2),
                                              scale=(0.8, 1.2),
                                              shear=(-5, 5, -5, 5)), True),
    "RandomPerspective": (lambda T: T.RandomPerspective(prob=1.0), True),
    "Compose": (lambda T: T.Compose([T.Pad(1), T.ColorJitter(
        0.1, 0.1, 0.1, 0.05), T.RandomHorizontalFlip(), T.ToTensor()]),
        True),
}


def _as_np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    from paddle_tpu.vision import transforms as JT
    from paddle_tpu_torch.vision import transforms as TT
    make, u8 = TRANSFORMS[name]
    outs = {}
    for T in (JT, TT):
        tr = make(T)
        np.random.seed(4)
        outs[T] = [_as_np(tr(_img(s, u8=u8))) for s in range(3)]
    for g, w in zip(outs[TT], outs[JT]):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)


def test_functional_transforms_match_jax():
    from paddle_tpu.vision import transforms as JT
    from paddle_tpu_torch.vision import transforms as TT
    img = _img(9)
    f = _img(10, u8=False)
    calls = [
        lambda T: T.normalize(f.transpose(2, 0, 1), [0.1] * 3, [0.5] * 3),
        lambda T: T.to_tensor_fn(img), lambda T: T.resize(img, (5, 5)),
        lambda T: T.hflip(img), lambda T: T.vflip(img),
        lambda T: T.crop(img, 1, 2, 5, 4), lambda T: T.center_crop(img, 4),
        lambda T: T.pad(img, (1, 2, 3, 4), fill=3),
        lambda T: T.rotate(img, 33, expand=True),
        lambda T: T.affine(img, 15, (1, 2), 1.1, (3, 4)),
        lambda T: T.perspective(img, [[0, 0], [9, 0], [9, 11], [0, 11]],
                                [[1, 1], [8, 0], [9, 10], [0, 11]]),
        lambda T: T.adjust_brightness(img, 1.3),
        lambda T: T.adjust_contrast(img, 0.6),
        lambda T: T.adjust_hue(img, 0.2), lambda T: T.to_grayscale(img, 3),
        lambda T: T.erase(img, 1, 2, 3, 4, 9),
    ]
    for i, call in enumerate(calls):
        g, w = _as_np(call(TT)), _as_np(call(JT))
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=i)
    chw = pt.to_tensor(f.transpose(2, 0, 1))
    out = TT.erase(chw, 0, 0, 2, 2, 5.0)
    assert float(out.numpy()[0, 0, 0]) == 5.0 and chw.numpy()[0, 0, 0] != 5
    same = TT.erase(chw, 0, 0, 2, 2, 5.0, inplace=True)
    assert same is chw and float(chw.numpy()[1, 1, 1]) == 5.0
    with pytest.raises(Exception):
        TT.RandomRotation(30, interpolation="bilinear")
