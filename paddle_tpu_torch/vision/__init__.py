"""paddle.vision (counterpart of ``paddle_tpu/vision/__init__.py``):
``models`` (LeNet and the ResNet family), ``datasets``, ``transforms``,
``set_image_backend`` / ``get_image_backend`` and ``image_load``.  JAX's
``vision.ops`` (detection ops) is not ported yet (ROADMAP.md queue 1 item
10(b))."""

from . import models  # noqa: F401
from . import datasets  # noqa: F401
from . import transforms  # noqa: F401
from .models import *  # noqa: F401,F403
from .datasets import MNIST, Cifar10, Cifar100  # noqa: F401


_image_backend = "numpy"


def set_image_backend(backend):
    global _image_backend
    if backend not in ("numpy", "cv2", "pil"):
        raise ValueError(f"unsupported image backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image file to a numpy HWC array: ``.npy``, binary ``.ppm`` /
    ``.pgm`` natively, other formats through PIL where it is installed."""
    import numpy as _np
    import os as _os
    ext = _os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return _np.load(path)
    if ext in (".ppm", ".pgm"):
        with open(path, "rb") as f:
            magic = f.readline().strip()
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = map(int, line.split())
            maxv = int(f.readline())
            depth = 3 if magic == b"P6" else 1
            data = _np.frombuffer(f.read(), _np.uint8, w * h * depth)
            arr = data.reshape(h, w, depth)
            return arr if depth == 3 else arr[:, :, 0]
    try:
        from PIL import Image
        return _np.asarray(Image.open(path))
    except ImportError as e:
        raise RuntimeError(
            f"cannot load {ext!r} images without PIL; use .npy/.ppm/.pgm "
            f"or install pillow") from e
