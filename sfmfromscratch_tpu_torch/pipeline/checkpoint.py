"""Full-state checkpoint and resume of the incremental engine (counterpart of
``sfmfromscratch_tpu/pipeline/checkpoint.py``).

The map, observations, poses, intrinsics, per-image keypoint->track tables,
random state and progress cursor round-trip through one npz with the JAX
package's keys, but one: the port writes its ``torch.Generator`` state under
``rng_state`` where the JAX package writes its threefry ``rng_key``. A
JAX-written file loads everything else and leaves the generator as it is.
The Orbax-backed ``AsyncCheckpointer`` is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore

CHECKPOINT_VERSION = 1


def save_checkpoint(engine, path: str, next_frame: int) -> str:
    """Snapshot ``engine`` after frame ``next_frame - 1`` is fully integrated."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames, tracks, xy = engine.map.observations()
    kp_imgs = sorted(engine._kp_tracks.keys())
    np.savez(
        path,
        version=CHECKPOINT_VERSION,
        next_frame=next_frame,
        points=engine.map.points(),
        obs_frame=frames,
        obs_track=tracks,
        obs_xy=xy,
        poses=np.array([np.hstack([rv, t]) for rv, t in engine.global_poses])
        if engine.global_poses else np.zeros((0, 6)),
        K=np.stack(engine.global_K) if engine.global_K else np.zeros((0, 3, 3)),
        kp_track_images=np.asarray(kp_imgs, dtype=np.int64),
        kp_tracks=np.stack([engine._kp_tracks[i] for i in kp_imgs])
        if kp_imgs else np.zeros((0, 0), np.int64),
        rng_state=engine._generator.get_state().numpy(),
    )
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
