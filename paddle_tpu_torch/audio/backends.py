"""audio.backends for the port (counterpart of
`paddle_tpu/audio/backends.py`): `info`, `load` and `save` over the
stdlib `wave` module (PCM WAV), the reference's default backend. `load`
puts the samples on the current device.
"""
import wave as _wave

import numpy as np

from ..core.tensor import Tensor, to_tensor

__all__ = ["AudioInfo", "load", "save", "info", "list_available_backends",
           "get_current_audio_backend", "set_backend"]


class AudioInfo:
    """reference: audio/backends/backend.py AudioInfo."""

    def __init__(self, sample_rate, num_frames, num_channels,
                 bits_per_sample, encoding):
        self.sample_rate = sample_rate
        self.num_frames = num_frames
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def list_available_backends():
    return ["wave_backend"]


def get_current_audio_backend():
    return "wave_backend"


def set_backend(backend_name):
    if backend_name not in ("wave_backend",):
        raise NotImplementedError(
            f"backend {backend_name!r} unavailable: only the stdlib wave "
            f"backend is bundled (the reference's default, "
            f"wave_backend.py; soundfile is an optional pip extra there)")


def info(filepath):
    """reference: wave_backend.py:36 — WAV header info."""
    with _wave.open(str(filepath), "rb") as f:
        bits = f.getsampwidth() * 8
        return AudioInfo(f.getframerate(), f.getnframes(), f.getnchannels(),
                         bits, f"PCM_{'S' if bits > 8 else 'U'}")


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """reference: wave_backend.py:87 — PCM WAV -> float32 tensor in [-1, 1]
    (normalize=True) or raw integer dtype."""
    with _wave.open(str(filepath), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        f.setpos(min(frame_offset, n))
        count = n - frame_offset if num_frames < 0 else num_frames
        raw = f.readframes(count)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    arr = np.frombuffer(raw, dtype=dt).reshape(-1, ch)
    if normalize:
        if width == 1:
            arr = (arr.astype(np.float32) - 128.0) / 128.0
        else:
            arr = arr.astype(np.float32) / float(2 ** (width * 8 - 1))
    if channels_first:
        arr = arr.T
    return to_tensor(np.ascontiguousarray(arr)), sr


def save(filepath, src, sample_rate, channels_first=True,
         encoding="PCM_S", bits_per_sample=16):
    """reference: wave_backend.py:164 — float [-1,1] or int tensor -> WAV."""
    arr = (src._data.detach().cpu().numpy() if isinstance(src, Tensor)
           else np.asarray(src))
    if channels_first:
        arr = arr.T                       # -> (frames, channels)
    if arr.ndim == 1:
        arr = arr[:, None]
    width = bits_per_sample // 8
    if np.issubdtype(arr.dtype, np.floating):
        scale = float(2 ** (bits_per_sample - 1) - 1)
        arr = np.clip(arr, -1.0, 1.0)
        arr = (arr * scale).astype({2: np.int16, 4: np.int32}[width])
    with _wave.open(str(filepath), "wb") as f:
        f.setnchannels(arr.shape[1])
        f.setsampwidth(width)
        f.setframerate(int(sample_rate))
        f.writeframes(arr.tobytes())


def get_current_backend():
    """reference: audio/backends get_current_backend alias."""
    return get_current_audio_backend()
