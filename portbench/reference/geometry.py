"""Plain NumPy reference of the geometry a reconstruction is judged by:
rotation vectors, the ground-truth epipolar geometry of a pair, the
reprojection error of a map, and pose errors against the ground truth after
a similarity alignment. Everything in float64; it imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a rotation vector."""
    r = np.asarray(rvec, np.float64).reshape(3)
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * (Kx @ Kx)


def rotation_angle_deg(R) -> float:
    """Angle of a rotation matrix, degrees."""
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def fundamental(K1, K2, R1, t1, R2, t2) -> np.ndarray:
    """F with x2^T F x1 = 0 for world-to-camera poses (R1, t1), (R2, t2)."""
    R = R2 @ R1.T
    t = t2 - R @ t1
    tx = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]])
    return np.linalg.inv(K2).T @ tx @ R @ np.linalg.inv(K1)


def epipolar_px(F, p1, p2) -> np.ndarray:
    """Symmetric epipolar distance of each match, pixels: the larger of the
    distances of x2 from F x1's line and of x1 from F^T x2's line."""
    x1 = np.hstack([np.asarray(p1, np.float64), np.ones((len(p1), 1))])
    x2 = np.hstack([np.asarray(p2, np.float64), np.ones((len(p2), 1))])
    l2 = x1 @ F.T
    l1 = x2 @ F
    num = np.abs(np.sum(x2 * l2, axis=1))
    d2 = num / np.maximum(np.hypot(l2[:, 0], l2[:, 1]), 1e-300)
    d1 = num / np.maximum(np.hypot(l1[:, 0], l1[:, 1]), 1e-300)
    return np.maximum(d1, d2)


def reprojection_px(rvecs, tvecs, Ks, points, frames, tracks, xy) -> np.ndarray:
    """Pixel distance of every observation from its point's projection."""
    R = np.stack([rodrigues(r) for r in rvecs])
    t = np.asarray(tvecs, np.float64)
    K = np.asarray(Ks, np.float64)
    X = np.asarray(points, np.float64)[tracks]
    cam = np.einsum("nij,nj->ni", R[frames], X) + t[frames]
    pix = np.einsum("nij,nj->ni", K[frames], cam)
    uv = pix[:, :2] / pix[:, 2:3]
    return np.linalg.norm(uv - np.asarray(xy, np.float64), axis=1)


def similarity_ate(est_centres, gt_centres):
    """(RMSE of the camera centres after the least-squares similarity that
    maps the estimate onto the ground truth (Umeyama), the ground truth's
    extent: the diagonal of its bounding box)."""
    A = np.asarray(est_centres, np.float64)
    B = np.asarray(gt_centres, np.float64)
    extent = float(np.linalg.norm(B.max(0) - B.min(0)))
    if len(A) < 2:
        return 0.0, extent
    ma, mb = A.mean(0), B.mean(0)
    a, b = A - ma, B - mb
    U, S, Vt = np.linalg.svd(b.T @ a / len(A))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    var = np.sum(a * a) / len(A)
    s = float(np.trace(np.diag(S) @ D) / var) if var > 0 else 1.0
    fit = s * a @ R.T + mb
    return float(np.sqrt(np.mean(np.sum((fit - B) ** 2, axis=1)))), extent


def pose_errors(est_poses, gt_poses):
    """(worst rotation error in degrees, ATE over extent) of estimated
    world-to-camera poses against the ground truth's for the same images.
    Both are taken relative to the first image's camera, so the gauge
    (the world frame and, for ATE, the scale) does not count."""
    R0e, t0e = est_poses[0]
    R0g, t0g = gt_poses[0]
    worst = 0.0
    ce, cg = [], []
    for (Re, te), (Rg, tg) in zip(est_poses, gt_poses):
        worst = max(worst, rotation_angle_deg((Re @ R0e.T) @ (Rg @ R0g.T).T))
        ce.append(-Re.T @ te)
        cg.append(-Rg.T @ tg)
    ate, extent = similarity_ate(np.stack(ce), np.stack(cg))
    return worst, (ate / extent if extent > 0 else 0.0)


def depths(rvecs, tvecs, points, frames, tracks) -> np.ndarray:
    """Depth of every observation's point in the camera that observes it:
    a point at depth 0 or less lies behind that camera."""
    R = np.stack([rodrigues(r) for r in rvecs])
    t = np.asarray(tvecs, np.float64)
    X = np.asarray(points, np.float64)[tracks]
    return np.einsum("nj,nj->n", R[frames][:, 2], X) + t[frames][:, 2]


def first_camera_px(K, points, xy) -> np.ndarray:
    """Pixel distance of each point's projection through the first image's
    camera (the world's: identity pose) from ``xy`` in that image."""
    X = np.asarray(points, np.float64)
    pix = X @ np.asarray(K, np.float64).T
    uv = pix[:, :2] / pix[:, 2:3]
    return np.linalg.norm(uv - np.asarray(xy, np.float64), axis=1)
