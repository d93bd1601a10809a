"""Quantization of the port (counterpart of `paddle_tpu/quantization/`):
QAT (fake-quant training) and PTQ (post-training calibration).

`ImperativeQuantAware` swaps Linear / Conv2D for quantized twins with
fake quantization of weights and activations; `PostTrainingQuantization`
calibrates scales (abs_max, min_max, avg, hist, KL, mse; per-tensor or
per-channel weights) over sample batches and fake-quantizes the weights;
`fuse_conv_bn` folds eval-mode BatchNorm into the preceding Conv2D.

The rounding is a straight-through estimator written as
`x + (round(x) - x).detach()`: its value is round(x) exactly, its
gradient is the identity, and unlike a `torch.autograd.Function` it
traces under `torch.export`, so `save_quantized_model` goes through the
port's `jit.save` (ROADMAP C.24). `torch.round` rounds half to even, as
`jnp.round` does.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, to_tensor
from ..nn.layer.layers import Layer
from .observers import HistogramObserver, channel_abs_max

__all__ = ["fake_quant", "QuantConfig", "ImperativeQuantAware",
           "PostTrainingQuantization", "QuantedLinear", "QuantedConv2D",
           "HistogramObserver", "fuse_conv_bn"]


def _ste_round(x):
    return x + (torch.round(x) - x).detach()


def _clip(v, lo, hi):
    """jnp.clip's min(max(v, lo), hi): at a bound v's gradient is halved,
    as jax splits the gradient of a tied max / min."""
    return torch.minimum(torch.maximum(v, v.new_full((), lo)),
                         v.new_full((), hi))


def _fake_quant_raw(x, scale, bits):
    qmax = 2.0 ** (bits - 1) - 1
    s = torch.clamp(torch.as_tensor(scale, dtype=x.dtype, device=x.device),
                    min=1e-8)
    return _clip(_ste_round(x / s * qmax), -qmax, qmax) * s / qmax


def fake_quant(x, scale=None, bits=8, channel_axis=None):
    """Quantize and dequantize with a straight-through gradient. With
    `channel_axis`, `scale` is a vector of per-channel scales broadcast
    along that axis (None: the absolute max, per tensor or per
    channel)."""
    data = x._data if isinstance(x, Tensor) else x
    if scale is None:
        if channel_axis is None:
            scale = data.detach().abs().max()
        else:
            axes = tuple(i for i in range(data.dim()) if i != channel_axis)
            scale = data.detach().abs().amax(dim=axes)
    if isinstance(scale, Tensor):
        scale = scale._data
    if channel_axis is not None:
        shape = [1] * data.dim()
        shape[channel_axis] = -1
        scale = torch.as_tensor(scale, device=data.device).reshape(shape)
    if isinstance(x, Tensor):
        return apply_op(_fake_quant_raw, x, scale=scale, bits=bits,
                        name="fake_quant")
    return _fake_quant_raw(x, scale, bits)


class QuantConfig:
    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.moving_rate = moving_rate


class _QuantedBase(Layer):
    """Fake-quant plumbing: a weight abs-max scale each call and a
    moving-average activation scale (the buffer `act_scale`)."""

    def __init__(self, inner, cfg):
        super().__init__()
        self.inner = inner
        self._cfg = cfg
        self.register_buffer("act_scale", to_tensor(
            np.zeros((), np.float32), place=inner.weight._data.device))

    def _quant_act(self, x):
        cur = x._data.detach().abs().max()
        prev = self.act_scale._data
        if self.training:
            r = self._cfg.moving_rate
            new = torch.where(prev > 0, prev * r + cur * (1 - r), cur)
            self.act_scale._data = new
        else:
            new = torch.where(prev > 0, prev, cur)
        return fake_quant(x, new, self._cfg.activation_bits)

    # per-channel scales on the output-channel axis: 1 for the (in, out)
    # Linear weight, 0 for the (out, in/g, kh, kw) Conv weight
    _channel_axis = None

    def _quant_weight(self, w):
        wd = w._data.detach()
        if self._cfg.weight_quantize_type == "channel_wise_abs_max":
            axes = tuple(i for i in range(wd.dim())
                         if i != self._channel_axis)
            return fake_quant(w, wd.abs().amax(dim=axes),
                              self._cfg.weight_bits,
                              channel_axis=self._channel_axis)
        return fake_quant(w, wd.abs().max(), self._cfg.weight_bits)


class QuantedLinear(_QuantedBase):
    _channel_axis = 1

    def forward(self, x):
        from ..nn import functional as F
        x = self._quant_act(x)
        w = self._quant_weight(self.inner.weight)
        return F.linear(x, w, self.inner.bias)


class QuantedConv2D(_QuantedBase):
    _channel_axis = 0

    def forward(self, x):
        from ..nn import functional as F
        x = self._quant_act(x)
        w = self._quant_weight(self.inner.weight)
        inner = self.inner
        return F.conv2d(x, w, inner.bias, stride=inner._stride,
                        padding=inner._padding, dilation=inner._dilation,
                        groups=inner._groups)


class ImperativeQuantAware:
    """QAT: `quantize(model)` swaps the supported sublayers in place."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9, quantizable_layer_type=None):
        self._cfg = QuantConfig(weight_bits, activation_bits,
                                weight_quantize_type,
                                activation_quantize_type, moving_rate)

    def quantize(self, model):
        from ..nn import Conv2D, Linear
        for parent in model.sublayers(include_self=True):
            if isinstance(parent, _QuantedBase):
                continue   # idempotent: never re-wrap a quantized twin
            for name, child in list(parent.named_children()):
                if isinstance(child, Linear):
                    setattr(parent, name, QuantedLinear(child, self._cfg))
                elif isinstance(child, Conv2D) and \
                        type(child).__name__ == "Conv2D":
                    setattr(parent, name, QuantedConv2D(child, self._cfg))
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        """jit.save of the quantized model in eval mode (a `torch.export`
        program the port's Predictor serves)."""
        from ..jit import save as jit_save
        model.eval()
        jit_save(model, path, input_spec=input_spec)


class PostTrainingQuantization:
    """PTQ: run sample batches, histogram each Linear / Conv2D input's
    |x|, derive the clip threshold with the chosen algorithm, and
    fake-quantize the weights (per channel or per tensor). `quantize`
    returns (model, scales)."""

    def __init__(self, model, algo="KL", weight_bits=8,
                 activation_bits=8, percentile=0.9999,
                 weight_quantize_type="channel_wise_abs_max"):
        self._model = model
        self._algo = algo
        self._bits = activation_bits
        self._wbits = weight_bits
        self._pct = percentile
        self._wtype = weight_quantize_type
        self._obs = {}       # layer name -> HistogramObserver
        self._hooks = []

    def _make_hook(self, name):
        def hook(layer, inputs, outputs=None):
            x = inputs[0] if isinstance(inputs, tuple) else inputs
            if isinstance(x, Tensor):
                self._obs.setdefault(name, HistogramObserver()).collect(
                    np.asarray(x.numpy(), np.float32))
        return hook

    def quantize(self, data_loader, batch_nums=8):
        from ..nn import Conv2D, Linear
        targets = [(n, l) for n, l in self._model.named_sublayers()
                   if isinstance(l, (Linear, Conv2D))]
        for n, l in targets:
            self._hooks.append(l.register_forward_pre_hook(
                self._make_hook(n)))
        self._model.eval()
        for i, batch in enumerate(data_loader):
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            self._model(x)
            if i + 1 >= batch_nums:
                break
        for h in self._hooks:
            h.remove()
        scales = {}
        for n, l in targets:
            obs = self._obs.get(n)
            act_scale = obs.threshold(self._algo, self._bits, self._pct) \
                if obs else 0.0
            w = l.weight._data.detach()
            if self._wtype == "channel_wise_abs_max":
                axis = 1 if isinstance(l, Linear) else 0
                w_scale = channel_abs_max(w.float().cpu().numpy(), axis)
                sc = torch.as_tensor(w_scale, dtype=torch.float32,
                                     device=w.device)
                l.weight._rebind(lambda d: fake_quant(
                    d, sc, self._wbits, channel_axis=axis), tracked=False)
                w_scale = w_scale.tolist()
            else:
                w_scale = float(w.abs().max())
                l.weight._rebind(lambda d: _fake_quant_raw(
                    d, w_scale, self._wbits), tracked=False)
            scales[n] = {"activation": float(act_scale), "weight": w_scale}
        return self._model, scales


def fuse_conv_bn(model):
    """Fold eval-mode BatchNorm into the preceding Conv2D: w' = w * g / s,
    b' = (b - mu) * g / s + beta with s = sqrt(var + eps), per output
    channel. Mutates `model` in place and replaces each BatchNorm by
    Identity."""
    from ..nn import BatchNorm2D, Conv2D, Identity
    for parent in model.sublayers(include_self=True):
        children = list(parent.named_children())
        for (n1, c1), (n2, c2) in zip(children, children[1:]):
            if not (isinstance(c1, Conv2D) and
                    type(c1).__name__ == "Conv2D" and
                    isinstance(c2, BatchNorm2D)):
                continue
            gamma = c2.weight._data.detach()
            beta = c2.bias._data.detach()
            mu = c2._mean._data.detach()
            s = torch.sqrt(c2._variance._data.detach() + c2._epsilon)
            f = (gamma / s).to(c1.weight._data.dtype)
            c1.weight._rebind(lambda d: d * f.reshape(-1, 1, 1, 1),
                              tracked=False)
            b = c1.bias._data.detach() if c1.bias is not None else 0.0
            new_b = (b - mu) * (gamma / s) + beta
            if c1.bias is None:
                c1.bias = c1.create_parameter(
                    (c1.weight._data.shape[0],), is_bias=True)
            c1.bias._rebind(lambda d: new_b.to(d), tracked=False)
            setattr(parent, n2, Identity())
    return model
