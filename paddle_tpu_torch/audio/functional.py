"""audio.functional for the port (counterpart of
`paddle_tpu/audio/functional.py`): windows, the mel scale (Slaney and
HTK), the mel filterbank and the DCT basis, each computed on the host in
numpy and put on the current device as one matrix, and `power_to_db` on
the tensor's device."""
import math

import numpy as np
import torch

from ..core.tensor import apply_op, to_tensor

__all__ = ["get_window", "hz_to_mel", "mel_to_hz", "mel_frequencies",
           "fft_frequencies", "compute_fbank_matrix", "create_dct",
           "power_to_db"]


def get_window(window, win_length, fftbins=True, dtype="float32"):
    """hann / hamming / blackman / boxcar / gaussian, periodic (fftbins)
    or symmetric."""
    n = win_length
    m = n if fftbins else n - 1
    t = np.arange(n) * (2 * math.pi / max(m, 1))
    if isinstance(window, tuple):
        name, *params = window
    else:
        name, params = window, []
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(t)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(t)
    elif name == "blackman":
        w = 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2 * t)
    elif name in ("boxcar", "rect", "ones"):
        w = np.ones(n)
    elif name == "gaussian":
        std = params[0] if params else 7.0
        k = np.arange(n) - (n - 1) / 2.0
        w = np.exp(-0.5 * (k / std) ** 2)
    else:
        raise ValueError(f"unsupported window {window!r}")
    return to_tensor(w.astype(dtype))


def hz_to_mel(freq, htk=False):
    f = np.asarray(freq, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3                      # Slaney
    out = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if np.ndim(f) == 0:
        if f >= min_log_hz:
            out = min_log_mel + math.log(f / min_log_hz) / logstep
    else:
        out = np.where(f >= min_log_hz, min_log_mel
                       + np.log(np.maximum(f, 1e-10) / min_log_hz)
                       / logstep, out)
    return out


def mel_to_hz(mel, htk=False):
    m = np.asarray(mel, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    out = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if np.ndim(m) == 0:
        if m >= min_log_mel:
            out = min_log_hz * math.exp(logstep * (m - min_log_mel))
    else:
        out = np.where(m >= min_log_mel,
                       min_log_hz * np.exp(logstep * (m - min_log_mel)), out)
    return out


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False):
    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels)
    return mel_to_hz(mels, htk)


def fft_frequencies(sr, n_fft):
    return np.linspace(0, sr / 2.0, 1 + n_fft // 2)


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32"):
    """(n_mels, 1 + n_fft // 2) triangular mel filterbank."""
    f_max = f_max or sr / 2.0
    fft_f = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, f_min, f_max, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    fb = np.zeros((n_mels, fft_f.size))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        fb *= enorm[:, None]
    return to_tensor(fb.astype(dtype))


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32"):
    """(n_mels, n_mfcc) DCT-II basis."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[None, :]
    basis = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        basis[:, 0] *= 1.0 / math.sqrt(2)
        basis *= math.sqrt(2.0 / n_mels)
    return to_tensor(basis.astype(dtype))


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    def fn(s):
        log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
        log_spec = log_spec - 10.0 * math.log10(max(ref_value, amin))
        if top_db is not None:
            log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
        return log_spec
    return apply_op(fn, spect)
