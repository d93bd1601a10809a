"""ASP, automatic n:m structured sparsity, of the port (counterpart of
`paddle_tpu/incubate/asp/`): `prune_model` computes n:m (default 2:4)
masks for every supported weight, `decorate(optimizer)` re-applies them
after every step so pruned weights stay zero, `check_sparsity` checks
the pattern.

The mask is the reference's numpy code, copied as it is: `np.argsort`
over |w| in groups of m along the last axis (not a stable sort), so ties
break as in the reference. The port's `nn.Linear` keeps the reference's
[in, out] weight, so the groups run along the same axis. The mask lives
on the parameter (`_asp_mask`), on the parameter's device, and is applied
through `_rebind` (value semantics, ROADMAP C.14).
"""
import numpy as np
import torch

__all__ = ["prune_model", "decorate", "check_sparsity", "calculate_density",
           "create_mask", "reset_excluded_layers", "set_excluded_layers",
           "add_supported_layer"]

_excluded = set()
_SUPPORTED_LAYERS = []


def _host(w):
    if hasattr(w, "_data"):
        w = w._data
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def set_excluded_layers(main_program=None, param_names=None):
    for n in (param_names or []):
        _excluded.add(n)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def add_supported_layer(layer, pruning_func=None):
    """Register a custom prunable layer type."""
    _SUPPORTED_LAYERS.append((layer, pruning_func))


def create_mask(weight, n=2, m=4):
    """n:m mask along the last axis: keep the n largest |w| of every m."""
    w = np.asarray(weight, np.float32)
    flat = w.reshape(-1, w.shape[-1])
    cols = flat.shape[1]
    pad = (-cols) % m
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    groups = flat.reshape(flat.shape[0], -1, m)          # (..., G, m)
    order = np.argsort(-np.abs(groups), axis=-1)
    mask = np.zeros_like(groups)
    np.put_along_axis(mask, order[..., :n], 1.0, axis=-1)
    mask = mask.reshape(flat.shape)[:, :cols].reshape(w.shape)
    return mask


def _supported(p):
    return p is not None and p._data.dim() >= 2 and \
        p._data.shape[-1] >= 4 and not p.stop_gradient


def _apply_mask(p, mask):
    p._rebind(lambda d: d * mask, tracked=False)


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Apply n:m masks to every supported weight of the model; the masks
    stay on the parameters for a `decorate`d optimizer to re-apply."""
    pruned = {}
    for name, p in model.named_parameters():
        if name in _excluded or not _supported(p):
            continue
        if name.endswith("bias"):
            continue
        mask = torch.as_tensor(create_mask(_host(p), n, m),
                               dtype=p._data.dtype, device=p._data.device)
        _apply_mask(p, mask)
        p._asp_mask = mask
        pruned[name] = mask
    return pruned


def decorate(optimizer):
    """Wrap an optimizer so that every step() re-applies the ASP masks."""

    class _ASPOptimizer:
        def __init__(self, inner):
            self._inner_opt = inner

        def __getattr__(self, item):
            return getattr(self._inner_opt, item)

        def step(self):
            self._inner_opt.step()
            for p in self._inner_opt._parameters:
                mask = getattr(p, "_asp_mask", None)
                if mask is not None:
                    _apply_mask(p, mask)

        def clear_grad(self, *a, **k):
            self._inner_opt.clear_grad()

        clear_gradients = clear_grad

        def minimize(self, loss, **kw):
            loss.backward()
            self.step()

    return _ASPOptimizer(optimizer)


def check_sparsity(weight, n=2, m=4):
    """True iff every group of m along the last axis has at most n
    nonzeros."""
    w = _host(weight)
    flat = w.reshape(-1, w.shape[-1])
    cols = flat.shape[1]
    pad = (-cols) % m
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    groups = flat.reshape(flat.shape[0], -1, m)
    return bool(((groups != 0).sum(-1) <= n).all())


def calculate_density(weight):
    return float((_host(weight) != 0).mean())
