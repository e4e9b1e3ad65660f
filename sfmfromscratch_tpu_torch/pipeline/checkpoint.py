"""Full-state checkpoint and resume of the incremental engine (counterpart of
``sfmfromscratch_tpu/pipeline/checkpoint.py``).

The map, observations, poses, intrinsics, per-image keypoint->track tables,
random state and progress cursor round-trip through one npz with the JAX
package's keys, but one: the port writes its ``torch.Generator`` state under
``rng_state`` where the JAX package writes its threefry ``rng_key``. A
JAX-written file loads everything else and leaves the generator as it is.

``AsyncCheckpointer`` keeps the JAX class's interface (``save(engine,
next_frame, step)``, ``restore(engine, step)``, ``wait()``) and its
``<directory>/step_<n>`` layout: the state is snapshotted on the caller's
thread and one writer thread writes it as ``step_<n>/state.npz``, so a save
overlaps the reconstruction. The JAX class writes Orbax directories; the
port does not read them.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore

CHECKPOINT_VERSION = 1


def _state(engine, next_frame: int) -> dict:
    """The engine's state as host arrays, copied: a later change to the
    engine does not reach a snapshot."""
    frames, tracks, xy = engine.map.observations()
    kp_imgs = sorted(engine._kp_tracks.keys())
    return dict(
        version=CHECKPOINT_VERSION,
        next_frame=next_frame,
        points=np.array(engine.map.points()),
        obs_frame=np.array(frames),
        obs_track=np.array(tracks),
        obs_xy=np.array(xy),
        poses=np.array([np.hstack([rv, t]) for rv, t in engine.global_poses])
        if engine.global_poses else np.zeros((0, 6)),
        K=np.stack(engine.global_K) if engine.global_K else np.zeros((0, 3, 3)),
        kp_track_images=np.asarray(kp_imgs, dtype=np.int64),
        kp_tracks=np.stack([engine._kp_tracks[i] for i in kp_imgs])
        if kp_imgs else np.zeros((0, 0), np.int64),
        rng_state=engine._generator.get_state().numpy(),
    )


def save_checkpoint(engine, path: str, next_frame: int) -> str:
    """Snapshot ``engine`` after frame ``next_frame - 1`` is fully integrated."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_state(engine, next_frame))
    return path


def load_checkpoint(engine, path: str) -> int:
    """Restore ``engine``'s state from ``path``; returns the frame to resume
    from. A file with no ``rng_state`` (the JAX package's) leaves the
    generator as it is and says so in ``engine.warnings``."""
    with np.load(path) as z:
        if int(z["version"]) != CHECKPOINT_VERSION:
            raise ValueError(f"{path}: checkpoint version {int(z['version'])}, "
                             f"want {CHECKPOINT_VERSION}")
        engine.map = MapStore.from_arrays(
            np.asarray(z["points"], np.float64).reshape(-1, 3), z["obs_frame"], z["obs_track"],
            np.asarray(z["obs_xy"], np.float64).reshape(-1, 2))
        engine.global_poses = [(p[:3].copy(), p[3:].copy()) for p in z["poses"]]
        engine.global_K = [k for k in z["K"]]
        engine._kp_tracks = {int(i): kt.copy()
                             for i, kt in zip(z["kp_track_images"], z["kp_tracks"])}
        if "rng_state" in z.files:
            engine._generator.set_state(torch.from_numpy(z["rng_state"].copy()))
        else:
            engine.warnings.append(f"checkpoint {path}: no rng_state (a JAX rng_key); "
                                   "the random generator was left as it is")
        return int(z["next_frame"])


class AsyncCheckpointer:
    """Checkpoints written by one background thread, so a save overlaps the
    reconstruction (``checkpoint.py:49-113``); ``wait()`` blocks until every
    save has been written and raises the first writer error."""

    def __init__(self, directory: str):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: List[Future] = []

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}")

    def save(self, engine, next_frame: int, step: int) -> str:
        """Snapshot ``engine`` now and write it to ``step_<step>`` in the
        background (replacing an earlier save of that step); returns the
        step's directory."""
        path = self._path(step)
        self._pending.append(self._pool.submit(_write_step, path, _state(engine, next_frame)))
        return path

    def restore(self, engine, step: int) -> int:
        """Wait for every save, then load ``step_<step>`` into ``engine``;
        returns the frame to resume from."""
        self.wait()
        return load_checkpoint(engine, os.path.join(self._path(step), "state.npz"))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()


def _write_step(path: str, state: dict) -> None:
    """Write ``state`` as ``path/state.npz`` through a temporary file and one
    rename, so a reader never sees a partial file."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"state.{os.getpid()}.tmp.npz")
    np.savez(tmp, **state)
    os.replace(tmp, os.path.join(path, "state.npz"))
