"""The device trace of the traced run's profiled job: the window's first
job again, run once the window has closed.

``torch.profiler`` with CUDA activity only (a global job launches millions
of kernels, too many for the host-side event tree) and no trace file: the
kernel and copy intervals come from the raw kineto events. The device's busy
time is the union of those intervals; the idle gaps are the spaces between
them, each named by the engine stage whose span holds it. The spans are
host clocks that end at a device synchronize and carry no start time, so a
gap's stage is placed by the spans' cumulative times, counted back from the
job's last device interval.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

_NOT_WORK = ("Buffer Flush", "Activity Buffer Request")


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # the traced job, start to end
    busy_s: float                        # union of device intervals
    by_name: Dict[str, Tuple[float, int]]  # kernel name -> (seconds, launches)
    gaps: List[Tuple[float, float]]      # (start, end) in seconds from the first interval
    intervals: int
    span_s: float                        # first interval's start to last interval's end

    def kernel_seconds(self, needle: str) -> Tuple[float, int]:
        """Device seconds and launches of every kernel whose name holds ``needle``."""
        s = n = 0
        for name, (sec, cnt) in self.by_name.items():
            if needle in name:
                s += sec
                n += cnt
        return s, n


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def idle_gaps(intervals) -> List[Tuple[float, float]]:
    """The spaces between the union's pieces, in time order."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def summarize(prof, window_s: float) -> TraceSummary:
    """Busy time, per-kernel time and idle gaps of a finished profiler."""
    from torch.autograd import DeviceType

    iv, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name in _NOT_WORK:
            continue
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        iv.append((s, s + d))
        sec, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + d, cnt + 1)
    t0 = min((s for s, _ in iv), default=0.0)
    iv = [(s - t0, e - t0) for s, e in iv]
    return TraceSummary(window_s=window_s, busy_s=busy_union(iv), by_name=by_name,
                        gaps=idle_gaps(iv), intervals=len(iv),
                        span_s=max((e for _, e in iv), default=0.0))


def stage_of(stage_times: Dict[str, float], last_end: float):
    """A function of a time (from the first device interval) to the stage
    whose span holds it, the spans laid end to end in their order and the
    job's end put at ``last_end``."""
    spans = [(k, v) for k, v in stage_times.items() if k != "total"]
    start = last_end - sum(v for _, v in spans)
    bounds, t = [], start
    for k, v in spans:
        bounds.append((t, t + v, k))
        t += v

    def find(x: float) -> str:
        for a, b, k in bounds:
            if a <= x < b:
                return k
        return "between stages"

    return find


def breakdown(summary: TraceSummary, stage_times: Dict[str, float], top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each gap named by its stage."""
    ops = sorted(((sec, name) for name, (sec, _) in summary.by_name.items()), reverse=True)
    find = stage_of(stage_times, summary.span_s)
    gaps = [(b - a, f"idle in {find(0.5 * (a + b))} at {a:.6f} s") for a, b in summary.gaps]
    # Host time outside the first and last device operation (the decode
    # before the first kernel, the host's last reads after the last).
    gaps.append((max(summary.window_s - summary.span_s, 0.0),
                 "idle before the first or after the last device operation"))
    gaps = sorted(gaps, reverse=True)[:top]
    return {"device_ops": [[name[:160], sec] for sec, name in ops[:top]],
            "idle_gaps": [[name, d] for d, name in gaps]}
