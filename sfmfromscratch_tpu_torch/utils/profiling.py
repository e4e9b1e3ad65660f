"""Profiling: ``torch.profiler`` traces and stage timers (counterpart of
``sfmfromscratch_tpu/utils/profiling.py``).

``trace`` wraps a code region in a ``torch.profiler`` trace, written as a
Chrome/TensorBoard trace into a directory; ``annotate`` names a span inside
it; ``StageTimer`` gives wall times that end at a device synchronize.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region (host
    activity, and the card's when there is one) into ``log_dir``:

        with profiling.trace("/tmp/sfm_trace"):
            engine.run()

    Open the ``*.pt.trace.json`` file with Perfetto, ``chrome://tracing`` or
    TensorBoard's profile plugin.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-span inside a trace (shows up in the timeline)."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Wall-clock stage timing; a stage given a tensor ends at a synchronize
    of that tensor's device."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on: Optional[torch.Tensor] = None) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            if sync_on is not None and sync_on.is_cuda:
                torch.cuda.synchronize(sync_on.device)
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def summary(self) -> str:
        return ", ".join(f"{k}={v:.3f}s" for k, v in self.times.items())
