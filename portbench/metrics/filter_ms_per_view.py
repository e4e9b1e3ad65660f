"""F-RANSAC filter (``geometry/ransac.py`` through ``SfmEngine._filter``):
the ``filter`` span, ms a view, over the jobs that filtered a pair."""


def read(r):
    jobs = r.filter_jobs()
    if not jobs:
        return None
    return 1e3 * sum(j.stage_times.get("filter", 0.0) for j in jobs) / sum(j.views for j in jobs)
