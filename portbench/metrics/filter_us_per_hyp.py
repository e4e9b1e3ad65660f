"""F-RANSAC filter: the ``filter`` span over the hypotheses its pairs
evaluated (``filter_hyps_used``, each one 8x9 null-space solve and its
scoring), us a hypothesis; independent of how many adaptive stages the data
needs."""


def read(r):
    jobs = r.filter_jobs()
    if not jobs:
        return None
    hyps = sum(int(j.hyps.sum()) for j in jobs)
    return 1e6 * sum(j.stage_times.get("filter", 0.0) for j in jobs) / hyps
