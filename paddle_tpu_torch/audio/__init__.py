"""paddle.audio for the port (counterpart of `paddle_tpu/audio`): the
window, mel and DCT functions, the feature Layers, the stdlib `wave`
backend and the TESS / ESC-50 datasets from local copies. The filterbank
and the DCT are host matrices put on the device and applied as matmuls."""
from . import functional  # noqa: F401
from .features import LogMelSpectrogram, MFCC, MelSpectrogram, Spectrogram  # noqa: F401
from . import backends  # noqa: F401
from . import datasets  # noqa: F401
from .backends import info, load, save  # noqa: F401
