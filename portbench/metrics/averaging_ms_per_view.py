"""Global engine's relative poses and motion averaging
(``pipeline/global_sfm.py``, ``geometry/averaging.py``): the
``relative_poses`` and ``motion_averaging`` spans, ms a view."""


def read(r):
    return r.ms_per_view("relative_poses", "motion_averaging")
