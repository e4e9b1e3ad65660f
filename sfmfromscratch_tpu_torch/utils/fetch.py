"""Packed device-to-host fetch (counterpart of
``sfmfromscratch_tpu/utils/fetch.py``).

``device_get_packed`` copies several tensors to the host in one transfer:
each is flattened into one float64 buffer (exact for float32, bool and
integers below 2**53), and the host cuts it back into numpy arrays of each
tensor's shape and dtype. ``sync_device`` waits for a tensor's work to
finish. The JAX module packs into two buffers and rejects 64-bit dtypes;
float64 carries every dtype the port fetches this way.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def sync_device(x: torch.Tensor) -> None:
    """Wait until the work producing ``x`` has finished (a no-op on the
    CPU)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def device_get_packed(*tensors: torch.Tensor) -> List[np.ndarray]:
    """``tensors`` as host numpy arrays with their shapes and dtypes, in
    order, copied in one transfer."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[o:o + t.numel()].reshape(tuple(t.shape)).astype(dtype))
        o += t.numel()
    return out
