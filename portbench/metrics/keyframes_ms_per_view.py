"""Keyframe selection of the global engine's video path
(``pipeline/global_sfm.py::_select_keyframes``: one matcher launch over
every consecutive pair, their median flows): the ``keyframes`` span, ms a
view."""


def read(r):
    return r.ms_per_view("keyframes")
