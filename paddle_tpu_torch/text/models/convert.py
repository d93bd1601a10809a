"""Carry weights between the JAX GPT (`paddle_tpu.text.models.gpt`) and
the PyTorch one: `load_jax_params` into the port, `to_jax_params` back
(what `serving.save_for_generation` writes into `.pdiparams`).

The JAX model's parameter names (`wte.weight`, `blocks.{i}.attn.qkv.weight`,
`blocks.{i}.mlp.fc1.bias`, `ln_f.weight`, ...) are the port's module paths
one for one. Paddle `Linear` weights are `[in, out]` and the port keeps
PyTorch's `[out, in]`, so every Linear weight is transposed on load;
embeddings, biases and LayerNorm parameters copy as they are. bf16 arrays
go through float32, which is exact.
"""
import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params", "to_jax_params"]


def load_jax_params(model, params):
    """Copy `params` ({jax name: numpy-convertible array}) into `model`
    in place. Every parameter must be present with the expected shape;
    extra or missing names raise. Returns the model."""
    linear_weights = {f"{name}.weight" for name, mod in model.named_modules()
                      if isinstance(mod, nn.Linear)}
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing[:4]}, "
                         f"unexpected {extra[:4]}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(params[name]).astype(np.float32)
            if name in linear_weights:
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} (after "
                                 f"layout) != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(p.dtype))
    return model


def to_jax_params(model):
    """The reverse of `load_jax_params`: {jax name: CPU tensor} of every
    parameter of `model`, Linear weights transposed to `[in, out]`
    (contiguous), in the model's dtype."""
    linear_weights = {f"{name}.weight" for name, mod in model.named_modules()
                      if isinstance(mod, nn.Linear)}
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = p.detach().to("cpu")
            out[name] = t.t().contiguous() if name in linear_weights \
                else t.clone()
    return out
