"""Global map / track store for incremental SfM, numpy only (copy of
``sfmfromscratch_tpu/pipeline/tracks.py``).

Track identity is explicit: callers add new tracks and attach observations to
known track ids. Storage is chunked numpy with vectorized appends;
``observations()``/``points()`` materialize contiguous views.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class MapStore:
    """Tracks (3-D points) + observations (frame, track, 2-D pixel)."""

    def __init__(self):
        self._point_chunks: List[np.ndarray] = []
        self._obs_frame_chunks: List[np.ndarray] = []
        self._obs_track_chunks: List[np.ndarray] = []
        self._obs_xy_chunks: List[np.ndarray] = []
        self._num_tracks = 0
        self._num_obs = 0
        self._points_cache: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(cls, points_3d: np.ndarray, frames: np.ndarray, tracks: np.ndarray,
                    xy: np.ndarray) -> "MapStore":
        """A store holding these tracks and observations, in this order."""
        m = cls()
        m.append_points_raw(points_3d)
        if len(frames):
            m._obs_frame_chunks.append(np.asarray(frames, np.int32).reshape(-1))
            m._obs_track_chunks.append(np.asarray(tracks, np.int32).reshape(-1))
            m._obs_xy_chunks.append(np.asarray(xy, np.float64).reshape(-1, 2))
            m._num_obs = len(frames)
        return m

    # -- building ---------------------------------------------------------

    def add_tracks(self, points_3d: np.ndarray, points_2d: np.ndarray, frame_idx: int,
                   mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Register new tracks with their first observation; returns track ids
        (-1 for masked-out rows)."""
        points_3d = np.asarray(points_3d, dtype=np.float64).reshape(-1, 3)
        points_2d = np.asarray(points_2d, dtype=np.float64).reshape(-1, 2)
        n = len(points_3d)
        sel = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        cnt = int(sel.sum())
        ids = np.full(n, -1, dtype=np.int64)
        if cnt == 0:
            return ids
        ids[sel] = self._num_tracks + np.arange(cnt)
        self._point_chunks.append(points_3d[sel])
        self._obs_frame_chunks.append(np.full(cnt, frame_idx, np.int32))
        self._obs_track_chunks.append(ids[sel].astype(np.int32))
        self._obs_xy_chunks.append(points_2d[sel])
        self._num_tracks += cnt
        self._num_obs += cnt
        self._points_cache = None
        return ids

    def append_points_raw(self, points_3d: np.ndarray) -> int:
        """Register tracks without observations (the observation stream is
        appended separately, as the device chain does). Returns the first new
        track id."""
        points_3d = np.asarray(points_3d, dtype=np.float64).reshape(-1, 3)
        first = self._num_tracks
        if len(points_3d):
            self._point_chunks.append(points_3d)
            self._num_tracks += len(points_3d)
            self._points_cache = None
        return first

    def add_observations(self, track_ids: np.ndarray, points_2d: np.ndarray,
                         frame_idx: int, mask: Optional[np.ndarray] = None) -> None:
        """Attach observations of existing tracks in a new frame (rows with
        track id < 0 or masked out are skipped)."""
        track_ids = np.asarray(track_ids, dtype=np.int64).reshape(-1)
        points_2d = np.asarray(points_2d, dtype=np.float64).reshape(-1, 2)
        sel = track_ids >= 0
        if mask is not None:
            sel = sel & np.asarray(mask, bool)
        cnt = int(sel.sum())
        if cnt == 0:
            return
        self._obs_frame_chunks.append(np.full(cnt, frame_idx, np.int32))
        self._obs_track_chunks.append(track_ids[sel].astype(np.int32))
        self._obs_xy_chunks.append(points_2d[sel])
        self._num_obs += cnt

    def update_points(self, points_3d: np.ndarray) -> None:
        """Overwrite all track positions (e.g. after bundle adjustment)."""
        points_3d = np.asarray(points_3d, dtype=np.float64).reshape(-1, 3)
        if len(points_3d) != self._num_tracks:
            raise ValueError(f"{len(points_3d)} points for {self._num_tracks} tracks")
        self._point_chunks = [points_3d.copy()]
        self._points_cache = None

    # -- views ------------------------------------------------------------

    @property
    def num_tracks(self) -> int:
        return self._num_tracks

    @property
    def num_observations(self) -> int:
        return self._num_obs

    def points(self) -> np.ndarray:
        if self._points_cache is None:
            self._points_cache = (
                np.concatenate(self._point_chunks)
                if self._point_chunks else np.zeros((0, 3))
            )
        return self._points_cache

    def observations(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(frame_indices, track_indices, xy) in insertion order."""
        if not self._obs_track_chunks:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 2)))
        return (
            np.concatenate(self._obs_frame_chunks),
            np.concatenate(self._obs_track_chunks),
            np.concatenate(self._obs_xy_chunks),
        )

    def nearest_track(self, p3d: np.ndarray, threshold: float = 1e-6) -> int:
        """Id of the track within ``threshold`` of p3d, else -1."""
        if self._num_tracks == 0:
            return -1
        pts = self.points()
        d = np.linalg.norm(pts - np.asarray(p3d)[None, :], axis=1)
        i = int(np.argmin(d))
        return i if d[i] < threshold else -1
