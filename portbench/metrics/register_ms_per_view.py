"""Registration of the non-keyframes (``pipeline/global_sfm.py::
_register_nonkeyframes``: one matcher launch and one F-filter batch over
the registration pairs, the host's linking to the keyframes' tracks, P3P
RANSAC vmapped over the frames): the ``register`` span, ms a view."""


def read(r):
    return r.ms_per_view("register")
