"""The sprite renderer (``render.render_sequence``), found by name: textured
3-D point sprites with ground-truth poses, on a path or an orbit. Its views
draw their background noise one after another from one stream, so it
renders in one process."""

from portbench.scenes.render import render_sequence as render  # noqa: F401
