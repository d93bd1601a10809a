"""audio.features for the port (counterpart of
`paddle_tpu/audio/features.py`): Spectrogram -> MelSpectrogram ->
LogMelSpectrogram -> MFCC, differentiable: stft, |.|^p, the filterbank
and DCT as matmuls, all on the input's device. The window, filterbank and
DCT are non-persistable buffers, so `Layer.to` moves them."""
import torch

from ..core.tensor import apply_op
from ..nn.layer.layers import Layer
from ..signal import stft
from . import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.window = AF.get_window(window, self.win_length, dtype=dtype)

    def forward(self, x):
        spec = stft(x, self.n_fft, self.hop_length, self.win_length,
                    window=self.window, center=self.center,
                    pad_mode=self.pad_mode)
        p = self.power
        return apply_op(lambda s: torch.abs(s) ** p, spec)


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 dtype="float32"):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                       power, center, pad_mode, dtype)
        self.fbank = AF.compute_fbank_matrix(sr, n_fft, n_mels, f_min, f_max,
                                             htk, norm, dtype)

    def forward(self, x):
        s = self.spectrogram(x)                   # (..., freq, time)
        return apply_op(lambda sp, m: torch.matmul(m, sp), s, self.fbank)


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 ref_value=1.0, amin=1e-10, top_db=None, dtype="float32"):
        super().__init__()
        self.mel = MelSpectrogram(sr, n_fft, hop_length, win_length, window,
                                  power, center, pad_mode, n_mels, f_min,
                                  f_max, htk, norm, dtype)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        return AF.power_to_db(self.mel(x), self.ref_value, self.amin,
                              self.top_db)


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32"):
        super().__init__()
        self.logmel = LogMelSpectrogram(sr, n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        n_mels, f_min, f_max, htk, norm,
                                        ref_value, amin, top_db, dtype)
        self.dct = AF.create_dct(n_mfcc, n_mels, dtype=dtype)

    def forward(self, x):
        lm = self.logmel(x)                      # (..., n_mels, time)
        return apply_op(lambda l, d: torch.matmul(d.transpose(0, 1), l),
                        lm, self.dct)
