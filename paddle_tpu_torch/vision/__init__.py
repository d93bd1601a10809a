"""paddle.vision for the port (counterpart of `paddle_tpu/vision`): the
datasets, transforms, detection ops and the model zoo. PIL is imported
only where an image file is read or decoded."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .models import *  # noqa: F401,F403


_image_backend = "pil"


def set_image_backend(backend):
    """'pil' or 'numpy' (raw-array loading); cv2 is not bundled."""
    global _image_backend
    if backend not in ("pil", "numpy"):
        raise ValueError(f"image backend {backend!r} unavailable: "
                         f"'pil' or 'numpy' (cv2 is not bundled)")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image from disk: 'pil' returns a PIL Image, 'numpy' an HWC
    uint8 array."""
    from PIL import Image
    img = Image.open(path)
    if (backend or _image_backend) == "numpy":
        import numpy as np
        return np.asarray(img)
    return img
