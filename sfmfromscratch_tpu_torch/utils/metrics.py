"""Metrics, numpy only (copy of ``sfmfromscratch_tpu/utils/metrics.py``):
a JSON-lines sink and the trajectory accuracy measures.

Monocular reconstructions are defined up to a similarity, so trajectories are
compared after Umeyama alignment.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, Tuple

import numpy as np


class MetricsLogger:
    """Append-only JSON-lines metrics sink (stderr or file), one
    ``{"ts", "event", **fields}`` object a line (``metrics.py:15-31``)."""

    def __init__(self, path: Optional[str] = None):
        self._fh = open(path, "a") if path else sys.stderr
        self._owns = path is not None

    def log(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Similarity transform (R, t, s) minimizing ||dst - (s R src + t)||^2."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def absolute_trajectory_error(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """RMSE of camera centers after similarity alignment (the standard ATE)."""
    R, t, s = umeyama_alignment(est_centers, gt_centers)
    aligned = (s * (est_centers @ R.T)) + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_centers) ** 2, axis=1))))


def rotvec_to_matrix(rvecs: np.ndarray) -> np.ndarray:
    """(N, 3) axis-angle vectors -> (N, 3, 3) rotations (Rodrigues, float64)."""
    rvecs = np.asarray(rvecs, np.float64).reshape(-1, 3)
    theta = np.linalg.norm(rvecs, axis=1)
    safe = np.where(theta > 1e-12, theta, 1.0)
    k = rvecs / safe[:, None]
    Kx = np.zeros((len(rvecs), 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
    Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
    Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s = np.where(theta > 1e-12, np.sin(theta), 0.0)[:, None, None]
    c = np.where(theta > 1e-12, 1.0 - np.cos(theta), 0.0)[:, None, None]
    return np.eye(3)[None] + s * Kx + c * (Kx @ Kx)


def camera_centers(rvecs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """World-space camera centers C = -R^T t from world-to-camera poses."""
    Rs = rotvec_to_matrix(rvecs)
    return np.einsum("nij,nj->ni", np.transpose(Rs, (0, 2, 1)), -np.asarray(ts, np.float64))
