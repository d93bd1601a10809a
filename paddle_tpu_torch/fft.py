"""paddle.fft for the port (counterpart of `paddle_tpu/fft.py`).

Every complex-to-complex and real transform is `torch.fft` on the tensor's
device, under the reference's `norm` names ("backward", "ortho",
"forward"; None is "backward"). The Hermitian 2-D and n-D transforms
(`hfft2`, `ihfft2`, `hfftn`, `ihfftn`) run on the host through scipy, as
the reference computes them, and their result is put on the input's
device (ROADMAP C.17); they record no gradient there either.
"""
import numpy as np
import torch

from .core.device import current_device
from .core.tensor import Tensor, apply_op, to_tensor

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft", "irfft",
           "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft", "hfft2",
           "ihfft2", "hfftn", "ihfftn", "fftshift", "ifftshift", "fftfreq",
           "rfftfreq"]


def _norm(norm):
    return {"backward": "backward", "ortho": "ortho",
            "forward": "forward"}[norm or "backward"]


def fft(x, n=None, axis=-1, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.fft(a, n=n, dim=axis,
                                            norm=_norm(norm)), x)


def ifft(x, n=None, axis=-1, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.ifft(a, n=n, dim=axis,
                                             norm=_norm(norm)), x)


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return apply_op(lambda a: torch.fft.fft2(a, s=s, dim=axes,
                                             norm=_norm(norm)), x)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return apply_op(lambda a: torch.fft.ifft2(a, s=s, dim=axes,
                                              norm=_norm(norm)), x)


def fftn(x, s=None, axes=None, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.fftn(a, s=s, dim=axes,
                                             norm=_norm(norm)), x)


def ifftn(x, s=None, axes=None, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.ifftn(a, s=s, dim=axes,
                                              norm=_norm(norm)), x)


def rfft(x, n=None, axis=-1, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.rfft(a, n=n, dim=axis,
                                             norm=_norm(norm)), x)


def irfft(x, n=None, axis=-1, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.irfft(a, n=n, dim=axis,
                                              norm=_norm(norm)), x)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return apply_op(lambda a: torch.fft.rfft2(a, s=s, dim=axes,
                                              norm=_norm(norm)), x)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return apply_op(lambda a: torch.fft.irfft2(a, s=s, dim=axes,
                                               norm=_norm(norm)), x)


def rfftn(x, s=None, axes=None, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.rfftn(a, s=s, dim=axes,
                                              norm=_norm(norm)), x)


def irfftn(x, s=None, axes=None, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.irfftn(a, s=s, dim=axes,
                                               norm=_norm(norm)), x)


def hfft(x, n=None, axis=-1, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.hfft(a, n=n, dim=axis,
                                             norm=_norm(norm)), x)


def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    # torch returns a conjugated view; materialise it as the reference's
    return apply_op(lambda a: torch.fft.ihfft(
        a, n=n, dim=axis, norm=_norm(norm)).resolve_conj(), x)


def fftshift(x, axes=None, name=None):
    return apply_op(lambda a: torch.fft.fftshift(a, dim=axes), x)


def ifftshift(x, axes=None, name=None):
    return apply_op(lambda a: torch.fft.ifftshift(a, dim=axes), x)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor(torch.fft.fftfreq(n, d, device=current_device()))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return Tensor(torch.fft.rfftfreq(n, d, device=current_device()))


def _hermitian_host(scipy_name, x, s, axes, norm):
    """The Hermitian 2-D / n-D family on the host (scipy.fft backs the
    c2r / r2c pair; torch.fft has only the 1-D hfft / ihfft with the
    reference's conventions), put back on the input's device."""
    import scipy.fft as _scipy_fft
    d = x._data if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    fn = getattr(_scipy_fft, scipy_name)
    out = fn(d.detach().cpu().numpy(), s=s, axes=axes, norm=norm)
    return to_tensor(np.ascontiguousarray(out), place=d.device)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """Hermitian FFT over the last two axes (host scipy)."""
    return _hermitian_host("hfft2", x, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _hermitian_host("ihfft2", x, s, axes, norm)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    return _hermitian_host("hfftn", x, s, axes, norm)


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    return _hermitian_host("ihfftn", x, s, axes, norm)
