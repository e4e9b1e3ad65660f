"""Reconstruction export: PLY point clouds and COLMAP-format text models
(copy of ``sfmfromscratch_tpu/io/export.py``, numpy only, so both packages
write the same text for the same engine state).

* ``save_ply`` — ASCII PLY of the 3-D points, colored per first observing
  frame with the same rainbow map as the JAX package's viewer, with the
  camera centers appended as white vertices;
* ``save_colmap`` — COLMAP sparse-model text triple (``cameras.txt``,
  ``images.txt``, ``points3D.txt``: PINHOLE cameras, world-to-camera
  quaternions, per-point track lists).
"""

from __future__ import annotations

import os

import numpy as np


def _rainbow(n: int) -> np.ndarray:
    """(n, 3) uint8 rainbow colors (matplotlib-free)."""
    t = np.linspace(0.0, 1.0, max(n, 2))
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


def _rvec_to_R(rvec: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = rvec / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _R_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion of a rotation matrix (COLMAP convention)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            0.25 * s, (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def save_ply(engine, path: str) -> str:
    """ASCII PLY of the reconstruction: points colored per first observing
    frame (V3D's coloring) + camera centers as white vertices."""
    frames, tracks, _ = engine.map.observations()
    pts = engine.map.points()
    n_frames = max(len(engine.global_poses), 1)
    colors = _rainbow(n_frames)
    first_frame = np.zeros(len(pts), np.int64)
    if len(tracks):
        order = np.argsort(tracks, kind="stable")
        tr_sorted = tracks[order]
        first_idx = np.searchsorted(tr_sorted, np.arange(len(pts)), side="left")
        first_idx = np.clip(first_idx, 0, len(order) - 1)
        first_frame = frames[order][first_idx]
    col = colors[np.clip(first_frame, 0, n_frames - 1)]

    centers = []
    for rvec, t in engine.global_poses:
        R = _rvec_to_R(np.asarray(rvec, np.float64))
        centers.append(-R.T @ np.asarray(t, np.float64).reshape(3))
    centers = np.asarray(centers).reshape(-1, 3)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        total = len(pts) + len(centers)
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {total}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, col):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        for p in centers:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 255 255 255\n")
    return path


def save_colmap(engine, out_dir: str) -> str:
    """COLMAP sparse text model (cameras.txt / images.txt / points3D.txt)."""
    os.makedirs(out_dir, exist_ok=True)
    frames, tracks, xy = engine.map.observations()
    pts = engine.map.points()

    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[fx fy cx cy]\n")
        for c, K in enumerate(engine.global_K):
            K = np.asarray(K, np.float64)
            w, h = int(round(2 * K[0, 2])), int(round(2 * K[1, 2]))
            f.write(f"{c + 1} PINHOLE {w} {h} "
                    f"{K[0, 0]:.6f} {K[1, 1]:.6f} {K[0, 2]:.6f} {K[1, 2]:.6f}\n")

    # Observations grouped ONCE by frame (images.txt) and once by track
    # (points3D.txt): argsort + slicing, O(O log O) — a per-frame/per-point
    # boolean scan would be O(C*O)/O(P*O), minutes at headline scale.
    O = len(frames)
    by_frame = np.argsort(frames, kind="stable")
    frame_starts = np.searchsorted(frames[by_frame],
                                   np.arange(len(engine.global_poses) + 1))
    # Running per-frame 2-D index (order of the POINTS2D lines below).
    pt2d_idx = np.zeros(O, np.int64)
    for c in range(len(engine.global_poses)):
        sl = by_frame[frame_starts[c]:frame_starts[c + 1]]
        pt2d_idx[sl] = np.arange(len(sl))

    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n"
                "# POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for c, (rvec, t) in enumerate(engine.global_poses):
            R = _rvec_to_R(np.asarray(rvec, np.float64))
            q = _R_to_quat(R)
            t = np.asarray(t, np.float64).reshape(3)
            f.write(f"{c + 1} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                    f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {c + 1} frame_{c + 1}.jpg\n")
            sl = by_frame[frame_starts[c]:frame_starts[c + 1]]
            parts = [
                f"{xy[o, 0]:.3f} {xy[o, 1]:.3f} {int(tracks[o]) + 1}"
                for o in sl
            ]
            f.write(" ".join(parts) + "\n")

    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        by_track = np.argsort(tracks, kind="stable")
        track_starts = np.searchsorted(tracks[by_track],
                                       np.arange(len(pts) + 1))
        for p in range(len(pts)):
            sl = by_track[track_starts[p]:track_starts[p + 1]]
            track_items = " ".join(
                f"{int(frames[o]) + 1} {int(pt2d_idx[o])}" for o in sl
            )
            x, y, z = pts[p]
            f.write(f"{p + 1} {x:.6f} {y:.6f} {z:.6f} 128 128 128 1.0 {track_items}\n")
    return out_dir
