"""Frozen copy of the photometric degradations (``degrade_sequence`` of the
repository's ``tests/render.py``), an imaging step applied after the
render: signal-dependent shot noise with a read-noise floor, a smooth
per-frame exposure and gamma drift, and a directional motion blur on every
``blur_every``-th frame. Its draws run through the frames in order, so it
runs in one process. ``portbench/tests/test_portbench_generators.py``
holds the copy to a checksum of the original's output.
"""

import numpy as np


def apply(
    rng,
    images,
    noise_sigma: float = 0.02,
    exposure_drift: float = 0.25,
    gamma_drift: float = 0.15,
    blur_len: int = 5,
    blur_every: int = 3,
):
    """The degraded frames, float32 in [0, 1]; the geometry is untouched."""
    from scipy.ndimage import convolve

    n = max(len(images) - 1, 1)
    out = []
    for i, img in enumerate(images):
        x = np.asarray(img, np.float32)
        gain = 1.0 + exposure_drift * np.sin(2 * np.pi * i / n)
        gamma = 1.0 + gamma_drift * np.cos(2 * np.pi * i / n)
        x = np.clip(x * gain, 0.0, 1.0) ** gamma
        if blur_len > 1 and blur_every > 0 and i % blur_every == blur_every - 1:
            ang = rng.uniform(0, np.pi)
            k = np.zeros((blur_len, blur_len), np.float32)
            c = blur_len // 2
            for s in np.linspace(-c, c, 4 * blur_len):
                r = int(round(c + s * np.sin(ang)))
                q = int(round(c + s * np.cos(ang)))
                k[r, q] = 1.0
            x = convolve(x, k / k.sum(), mode="nearest")
        shot = noise_sigma * np.sqrt(np.clip(x, 0.0, 1.0))
        read = 0.5 * noise_sigma
        x = x + rng.standard_normal(x.shape).astype(np.float32) * (shot + read)
        out.append(np.clip(x, 0.0, 1.0).astype(np.float32))
    return out
