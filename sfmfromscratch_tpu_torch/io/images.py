"""Host-side image decode (counterpart of ``sfmfromscratch_tpu/io/images.py``).

PIL is imported inside each function: the machine with the card may not
have it, and nothing else in the port needs it.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode to float32 RGB (or grayscale) in [0, 1]
    (reference Runner.py:551-563)."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img, dtype=np.float32)
    return arr / 255.0


def load_image_u8(path: str) -> np.ndarray:
    """Decode to uint8 (RGB or grayscale), deferring the [0,1] conversion to
    the device, where it is ``x * float32(1/255)``."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img, dtype=np.uint8)
