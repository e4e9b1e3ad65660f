"""Harris response (``csrc/harris.cu``): per pixel one float32 read and one
float32 write (8 bytes), and 16 + 12 G FLOPs for the Sobel products and the
separable G-tap Gaussian over the three structure-tensor maps (the count of
the repository's ``chip_smoke.py``). Counted from the algorithm, whatever
kernel runs it."""

from typing import Iterable, Tuple


def level_shapes(hw: Tuple[int, int], levels: int, factor: float):
    """(H, W) of each pyramid level: each from the one before by int division."""
    out = [tuple(hw)]
    for _ in range(1, levels):
        h, w = out[-1]
        out.append((int(h / factor), int(w / factor)))
    return out


def work(images: int, shapes: Iterable[Tuple[int, int]], gaussian_size: int):
    """(bytes, FLOPs) of the responses of ``images`` images at each shape."""
    px = sum(images * h * w for h, w in shapes)
    return 8.0 * px, px * (16.0 + 12.0 * gaussian_size)


def bound_s(nbytes: float, flops: float, peaks: dict) -> float:
    """Least time at the card's peaks: bytes or FLOPs, whichever binds."""
    return max(nbytes / peaks["bytes_per_s"], flops / peaks["fp32_flops"])
