"""Bundle adjustment (``ba/lm.py``: dense Schur at up to 32 cameras, PCG
above): the ``ba`` span, ms a view."""


def read(r):
    return r.ms_per_view("ba")
