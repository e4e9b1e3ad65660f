"""Profiling: ``torch.profiler`` traces and the engines' span recorder
(counterpart of ``sfmfromscratch_tpu/utils/profiling.py``).

``trace`` wraps a code region in a ``torch.profiler`` trace, written as a
Chrome/TensorBoard trace into a directory; ``annotate`` names a span inside
it. ``StageTimer`` records spans: each has a name, its parent, the engine run
it belongs to, a start and an end in integer nanoseconds on the clock of
``torch.profiler``'s events (``time.time_ns``), and counters that ``count``
adds to. Its ``times`` sums the spans' durations by name on a steady clock;
a span closed with a device ends at that device's synchronize. While a
profiler runs, every open span is also a ``torch.profiler.record_function``
range, so a trace shows the stages by name; otherwise no profiler call is
made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

# Ids of engine runs, unique in the process.
_RUN_IDS = itertools.count(1)
# Per thread, the open spans of every recorder, innermost last: entries
# (recorder, index in its spans, steady-clock start, record_function or None).
_OPEN = threading.local()


def _open_stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


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


@dataclasses.dataclass
class Span:
    """One recorded region. ``parent`` is the index of the enclosing span
    in the same recorder's ``spans``; ``end_ns`` stays None for a span that
    an exception left open."""

    name: str
    parent: Optional[int]
    run: int
    start_ns: int
    end_ns: Optional[int] = None
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of the current thread's innermost open
    span; nothing when no span is open."""
    stack = _open_stack()
    if stack:
        rec, i = stack[-1][:2]
        c = rec.spans[i].counters
        c[key] = c.get(key, 0) + n


class StageTimer:
    """Span recorder. ``times`` maps a name to the summed seconds of the
    spans closed into it; ``spans`` holds every span of the current run, in
    the order they opened."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.spans: List[Span] = []
        self.run_id = next(_RUN_IDS)

    def open(self, name: str) -> Span:
        """Open span ``name`` inside this recorder's innermost open span."""
        stack = _open_stack()
        parent = next((e[1] for e in reversed(stack) if e[0] is self), None)
        span = Span(name, parent, self.run_id, time.time_ns())
        self.spans.append(span)
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        stack.append((self, len(self.spans) - 1, time.perf_counter(), rf))
        return span

    def close(self, span: Span, device: Optional[torch.device] = None,
              time_as: Optional[str] = "") -> None:
        """Close ``span``, the innermost open span, after a synchronize of
        ``device`` when it is a CUDA device; its seconds add to
        ``times[time_as]`` (``""``: its name; None: nowhere)."""
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        rec, i, t0, rf = _open_stack().pop()
        assert rec is self and rec.spans[i] is span, (span.name, rec.spans[i].name)
        if rf is not None:
            rf.__exit__(None, None, None)
        t = time.perf_counter()
        span.end_ns = time.time_ns()
        if time_as is not None:
            key = time_as or span.name
            self.times[key] = self.times.get(key, 0.0) + t - t0

    @contextlib.contextmanager
    def stage(self, name: str, sync_on: Optional[torch.Tensor] = None) -> Iterator[Span]:
        """A span around the block, ending at a synchronize of ``sync_on``'s
        device when it is on the card."""
        with self._unwinding():
            span = self.open(name)
            yield span
            self.close(span, sync_on.device if sync_on is not None else None)

    @contextlib.contextmanager
    def run(self) -> Iterator[None]:
        """One engine run: clears ``times`` and ``spans``, takes a new run id
        and records the root span ``run`` (its seconds as ``times["total"]``)."""
        self.times.clear()
        self.spans.clear()
        self.run_id = next(_RUN_IDS)
        with self._unwinding():
            span = self.open("run")
            yield
            self.close(span, time_as="total")

    @contextlib.contextmanager
    def _unwinding(self) -> Iterator[None]:
        """Where the block raises, drop the spans it left open from the
        thread's stack (their ``end_ns`` stays None)."""
        depth = len(_open_stack())
        try:
            yield
        except BaseException:
            stack = _open_stack()
            while len(stack) > depth:
                rf = stack.pop()[3]
                if rf is not None:
                    rf.__exit__(None, None, None)
            raise

    def summary(self) -> str:
        return ", ".join(f"{k}={v:.3f}s" for k, v in self.times.items())
