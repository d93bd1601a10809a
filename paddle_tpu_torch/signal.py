"""paddle.signal for the port (counterpart of `paddle_tpu/signal.py`):
`frame`, `overlap_add`, `stft` and `istft` with the reference's framing,
centring, padding, `onesided` and `normalized`.

Framing is one gather with a [frames, frame_length] index, the transforms
are `torch.fft`, and overlap-add is an `index_add` over the same index,
all on the tensor's device and differentiable.
"""
import torch
import torch.nn.functional as F

from .core.tensor import Tensor, apply_op

__all__ = ["frame", "overlap_add", "stft", "istft"]

# numpy pad mode names (the reference's) -> torch's
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def _frame_index(n_frames, length, hop, device):
    return (torch.arange(n_frames, device=device)[:, None] * hop
            + torch.arange(length, device=device)[None, :])


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice the signal into overlapping frames (the librosa layout):
    axis=-1 -> (..., frame_length, num_frames); axis=0 ->
    (num_frames, frame_length, ...)."""
    def fn(a):
        # for 1-D input axis=0 and axis=-1 name the same axis, but paddle
        # documents different output layouts: go by the literal value
        time_last = axis == -1 or (a.dim() > 1 and axis == a.dim() - 1)
        if not time_last:
            a = torch.movedim(a, 0, -1)
        n_frames = 1 + (a.shape[-1] - frame_length) // hop_length
        out = a[..., _frame_index(n_frames, frame_length, hop_length,
                                  a.device)]    # (..., n_frames, frame_len)
        out = out.transpose(-1, -2)             # (..., frame_len, n_frames)
        if not time_last:
            out = torch.movedim(torch.movedim(out, -1, 0), -1, 1)
        return out
    return apply_op(fn, x)


def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of `frame`: axis=-1 takes (..., frame_length, num_frames);
    axis=0 takes (num_frames, frame_length, ...)."""
    def fn(a):
        if axis == -1 or (a.dim() > 2 and axis == a.dim() - 1):
            fr = a.transpose(-1, -2)            # (..., n_frames, frame_len)
        else:
            fr = torch.movedim(torch.movedim(a, 1, -1), 0, -2)
        n_frames, fl = fr.shape[-2], fr.shape[-1]
        out_len = (n_frames - 1) * hop_length + fl
        idx = _frame_index(n_frames, fl, hop_length, a.device).reshape(-1)
        flat = fr.reshape(fr.shape[:-2] + (n_frames * fl,))
        out = torch.zeros(fr.shape[:-2] + (out_len,), dtype=a.dtype,
                          device=a.device).index_add(-1, idx, flat)
        if axis not in (-1, a.dim() - 1):
            out = torch.movedim(out, -1, 0)
        return out
    return apply_op(fn, x)


def _window(w, win_length, n_fft, device):
    """The analysis window in f32, centre-padded to n_fft."""
    win = w.float() if w is not None else torch.ones(
        win_length, dtype=torch.float32, device=device)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = F.pad(win, (lp, n_fft - win_length - lp))
    return win


def _with_window(fn, x, window):
    if window is None:
        return apply_op(fn, x)
    w = window if isinstance(window, Tensor) else Tensor(
        torch.as_tensor(window))
    return apply_op(fn, x, w)


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform. x: (B, T) or (T,). Returns complex
    (B, n_fft // 2 + 1, n_frames) when onesided."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def fn(a, w=None):
        if a.dim() not in (1, 2):
            raise ValueError(f"stft expects a (T,) or (B, T) signal, got "
                             f"shape {tuple(a.shape)}")
        squeeze = a.dim() == 1
        if squeeze:
            a = a[None]
        win = _window(w, win_length, n_fft, a.device)
        if center:
            a = F.pad(a[:, None], (n_fft // 2, n_fft // 2),
                      mode=_PAD_MODES[pad_mode])[:, 0]
        if a.shape[-1] < n_fft:
            raise ValueError(f"signal length {a.shape[-1]} < n_fft {n_fft} "
                             f"(set center=True or pad the input)")
        n_frames = 1 + (a.shape[-1] - n_fft) // hop_length
        frames = a[:, _frame_index(n_frames, n_fft, hop_length,
                                   a.device)] * win   # (B, n_frames, n_fft)
        spec = torch.fft.rfft(frames, dim=-1) if onesided else \
            torch.fft.fft(frames, dim=-1)
        if normalized:
            spec = spec / (float(n_fft) ** 0.5)
        spec = spec.transpose(-1, -2)                 # (B, freq, n_frames)
        return spec[0] if squeeze else spec
    return _with_window(fn, x, window)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT with the window-sum-squares normalisation."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft

    def fn(spec, w=None):
        if spec.dim() not in (2, 3):
            raise ValueError(f"istft expects (freq, frames) or (B, freq, "
                             f"frames), got shape {tuple(spec.shape)}")
        squeeze = spec.dim() == 2
        if squeeze:
            spec = spec[None]
        win = _window(w, win_length, n_fft, spec.device)
        spec = spec.transpose(-1, -2)                 # (B, n_frames, freq)
        if normalized:
            spec = spec * (float(n_fft) ** 0.5)
        if onesided:
            frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
        elif return_complex:
            frames = torch.fft.ifft(spec, dim=-1)
        else:
            frames = torch.fft.ifft(spec, dim=-1).real
        frames = frames * win                         # windowed overlap-add
        n_frames = frames.shape[-2]
        out_len = (n_frames - 1) * hop_length + n_fft
        idx = _frame_index(n_frames, n_fft, hop_length,
                           spec.device).reshape(-1)
        sig = torch.zeros(frames.shape[:-2] + (out_len,), dtype=frames.dtype,
                          device=spec.device).index_add(
            -1, idx, frames.reshape(frames.shape[:-2] + (-1,)))
        wss = torch.zeros((out_len,), dtype=torch.float32,
                          device=spec.device).index_add(
            0, idx, (win * win).repeat(n_frames))
        sig = sig / torch.clamp(wss, min=1e-10)
        if center:
            # trim the left pad; keep the right tail if `length` needs it
            right = out_len - n_fft // 2 if length is None \
                else n_fft // 2 + length
            sig = sig[..., n_fft // 2:right]
        if length is not None:
            if sig.shape[-1] < length:
                sig = F.pad(sig, (0, length - sig.shape[-1]))
            sig = sig[..., :length]
        return sig[0] if squeeze else sig
    return _with_window(fn, x, window)
