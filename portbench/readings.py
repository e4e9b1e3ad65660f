"""What the per-layer readers read: the window's job records (their spans
and counters) and the traced job's device trace, with the shapes that job
ran at."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from portbench.roofline.peaks import peaks


@dataclasses.dataclass
class Readings:
    jobs: list                    # the jobs whose spans are read
    config: dict
    card: str
    trace: object = None          # trace.TraceSummary of the traced job, or None
    traced: object = None         # its jobs.JobRecord

    @property
    def peaks(self) -> dict:
        return peaks(self.card)

    def _done(self) -> List:
        return [j for j in self.jobs if not j.failed]

    def ms_per_view(self, *stages: str) -> Optional[float]:
        """The spans ``stages`` summed over the completed jobs, in ms, over
        those jobs' views; None where no job has any of them."""
        jobs = self._done()
        if not any(s in j.stage_times for j in jobs for s in stages):
            return None
        views = sum(j.views for j in jobs)
        return 1e3 * sum(j.stage_times.get(s, 0.0) for j in jobs for s in stages) / views

    def filter_jobs(self) -> List:
        """The completed jobs whose F-filter evaluated some hypothesis."""
        return [j for j in self._done() if j.hyps is not None and int(j.hyps.sum()) > 0]

    def kernel_share(self, needle: str, nbytes: float, flops: float, bound) -> Optional[float]:
        """The traced kernels' least time over their device time, in %."""
        if self.trace is None or self.traced is None or self.traced.failed:
            return None
        sec, launches = self.trace.kernel_seconds(needle)
        if not launches or sec <= 0:
            return None
        return 100.0 * bound(nbytes, flops, self.peaks) / sec
