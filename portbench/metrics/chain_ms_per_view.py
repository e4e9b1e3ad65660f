"""Incremental chain (``pipeline/incremental.py``: the bootstrap's essential
RANSAC and triangulation, P3P PnP over the frames, the track table): the
``bootstrap`` and ``chain`` spans, ms a view."""


def read(r):
    return r.ms_per_view("bootstrap", "chain")
