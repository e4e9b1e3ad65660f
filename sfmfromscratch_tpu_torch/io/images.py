"""Host-side image I/O: decode, save, dataset resize (counterpart of
``sfmfromscratch_tpu/io/images.py``).

PIL is imported inside each function: the machine with the card may not
have it, and nothing else in the port needs it.
"""

from __future__ import annotations

import os
from typing import Optional

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


def save_image(path: str, im: np.ndarray) -> None:
    """Save a float [0,1] array as an 8-bit image (reference Runner.py:566-578)."""
    from PIL import Image

    folder = os.path.split(path)[0]
    if folder and not os.path.exists(folder):
        os.makedirs(folder, exist_ok=True)
    arr = np.clip(im * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def fast_resize(
    input_folder: str, output_folder: str, ratio: float = 0.3, exif: bool = True
) -> None:
    """Batch-resize an image folder, preserving EXIF so intrinsics can still be
    derived from the resized files (reference Util.py:7-63)."""
    from PIL import Image

    os.makedirs(output_folder, exist_ok=True)
    for filename in sorted(os.listdir(input_folder)):
        in_path = os.path.join(input_folder, filename)
        if not (
            os.path.isfile(in_path)
            and filename.lower().endswith((".png", ".jpg", ".jpeg"))
        ):
            continue
        with Image.open(in_path) as img:
            exif_bytes: Optional[bytes] = img.info.get("exif") if exif else None
            new_size = (int(img.width * ratio), int(img.height * ratio))
            resized = img.resize(new_size, Image.LANCZOS)
        out_path = os.path.join(output_folder, os.path.basename(in_path))
        if exif_bytes:
            resized.save(out_path, format="JPEG", exif=exif_bytes)
        else:
            resized.save(out_path, format="JPEG")
