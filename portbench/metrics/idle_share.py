"""Device: the share of a job's wall time in which no kernel or copy ran on
the card, 100 x (1 - union of the traced job's device intervals / the wall
time of the window's first job), in %. That job has the traced job's scene
and seed and runs unprofiled, so the profiler's host overhead is not
counted as idle time."""


def read(r):
    if r.trace is None or r.traced is None or r.traced.failed or not r.jobs:
        return None
    same = r.jobs[0]
    wall = same.end - same.start
    if same.failed or same.scene != r.traced.scene or same.seed != r.traced.seed or wall <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / wall)
