"""Front end (``ops/harris.py``, ``ops/sift.py``, ``ops/matcher.py`` through
``SfmEngine._extract_all_features`` and the matching stage): the
``features`` and ``matching`` spans, ms a view."""


def read(r):
    return r.ms_per_view("features", "matching")
