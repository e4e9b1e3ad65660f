"""Interactive 3-D point-cloud viewer (reference Visualizer.py:7-72 ``V3D``;
counterpart of ``sfmfromscratch_tpu/viz/scatter3d.py``, host code on numpy
and matplotlib, imported inside each method).

Points are colored per observing frame with a rainbow colormap; a button
toggles between per-frame colors and uniform blue. Headless-safe: pass
``show=False`` (or set MPLBACKEND=Agg) to render without blocking, and use
``save(path)`` to write a PNG.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class V3D:
    def __init__(
        self,
        points_3d,
        frame_indices,
        point_indices,
        show: bool = True,
        save_path: Optional[str] = None,
    ):
        self.points_3d = np.asarray(points_3d)
        self.frame_indices = np.asarray(frame_indices)
        self.point_indices = np.asarray(point_indices)
        self.unique_frames = np.unique(self.frame_indices)
        self.with_perspective = True
        self.scatter_plot = []
        self._fig = None
        self.plot(show=show, save_path=save_path)

    def _colors(self):
        from matplotlib import cm

        if not self.with_perspective:
            return ["blue"] * len(self.unique_frames)
        return cm.rainbow(np.linspace(0, 1, len(self.unique_frames)))

    def plot(self, show: bool = True, save_path: Optional[str] = None):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button

        fig = plt.figure(figsize=(12, 8))
        self._fig = fig
        ax = fig.add_subplot(111, projection="3d")
        colors = self._colors()

        for k, frame_idx in enumerate(self.unique_frames):
            mask = self.frame_indices == frame_idx
            pts = self.points_3d[np.unique(self.point_indices[mask])]
            self.scatter_plot.append(
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=[colors[k]],
                           label=f"Frame {frame_idx}", s=0.8)
            )

        ax.set_xlabel("X")
        ax.set_ylabel("Y")
        ax.set_zlabel("Z")
        ax.set_title("3D structure")
        ax.legend()

        ax_button = plt.axes([0.8, 0.02, 0.15, 0.075])
        button = Button(ax_button, "Toggle Perspective")

        def on_click(event):
            self.with_perspective = not self.with_perspective
            self.change_color()
            plt.draw()

        button.on_clicked(on_click)
        self._button = button  # keep alive

        if save_path:
            fig.savefig(save_path, dpi=120)
        if show:
            plt.show()
        return fig

    def change_color(self):
        colors = self._colors()
        for k in range(len(self.unique_frames)):
            self.scatter_plot[k].set_facecolor(colors[k])

    def save(self, path: str):
        if self._fig is not None:
            self._fig.savefig(path, dpi=120)
