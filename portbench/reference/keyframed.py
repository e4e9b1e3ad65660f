"""Plain NumPy reference of the keyframed video path: flow-selected
keyframes, the linking of registration matches to the keyframes' tracks,
and each registered frame's pose by P3P RANSAC from given uniforms.

It starts from the inputs the program's stages take (matched pixels and
masks, the keyframes' surviving observations, the map's points, the
registration pairs' indices and filtered inliers, the RANSAC uniforms) and
recomputes each stage's output from its definition, in float64, with no
kernel and nothing of the program. No ``torch`` matmul runs here, so the
TF32 switch has nothing to act on.

Departures from the program's solver, each noted where it is made: the
quartic's roots come from the companion matrix's eigenvalues (the program
uses Ferrari's closed form and Newton steps in float32); the absolute
orientation of each P3P solution is an SVD (the program: polar Newton
steps); the winner's polish is Levenberg-Marquardt on the inliers run to
convergence in float64 (the program: 10 Levenberg-Marquardt steps in
float32). So the reference's pose is the least-squares pose of its inlier
set, where the program's stops after 10 steps: in a frame whose cost valley
is long and flat (rotation traded against translation) the two poses may lie
a degree apart at nearly the same cost, and a tie between two hypotheses of
equal support may start them from different winners.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


# ---------------------------------------------------------------- keyframes

def median_flow(p1, p2, mask) -> np.ndarray:
    """Each consecutive pair's median displacement of its matches, pixels;
    0 for a pair with no match. ``p1``, ``p2`` (P, M, 2), ``mask`` (P, M)."""
    d = np.linalg.norm(np.asarray(p2, np.float64) - np.asarray(p1, np.float64), axis=-1)
    m = np.asarray(mask, bool)
    return np.array([float(np.median(d[i][m[i]])) if m[i].any() else 0.0 for i in range(len(d))])


def select_keyframes(flows, target_px: float) -> List[int]:
    """1-based keyframe ids of a sequence of ``len(flows) + 1`` frames:
    image 1, then each image at which the flow accumulated since the last
    keyframe reaches ``target_px`` (the accumulator restarts there), and the
    last image."""
    n = len(flows) + 1
    kfs, acc = [1], 0.0
    for f in range(2, n + 1):
        acc += float(flows[f - 2])
        if acc >= target_px:
            kfs.append(f)
            acc = 0.0
    if kfs[-1] != n:
        kfs.append(n)
    return kfs


# ---------------------------------------------------------------- linking

class Links(NamedTuple):
    """One frame's candidate 2D-3D correspondences in the order they were
    found: its registration pairs in the given order, each pair's rows in
    order. ``keep`` marks a track's first occurrence."""

    tracks: np.ndarray   # (n,) track ids
    xy: np.ndarray       # (n, 2) the frame's pixels
    keep: np.ndarray     # (n,) bool


def keyframe_tracks(obs_image, obs_slot, obs_track) -> Dict[int, Dict[int, int]]:
    """{keyframe image id: {keypoint slot: track id}} from the surviving
    observations (1-based image id, keypoint slot, track id each). A slot
    observed twice keeps its last observation."""
    out: Dict[int, Dict[int, int]] = {}
    for img, slot, tr in zip(np.asarray(obs_image).tolist(), np.asarray(obs_slot).tolist(),
                             np.asarray(obs_track).tolist()):
        out.setdefault(int(img), {})[int(slot)] = int(tr)
    return out


def link_frames(kf_tracks, results, frames) -> Dict[int, Links]:
    """The correspondences of each frame of ``frames``. ``results`` maps a
    registration pair (keyframe, frame) to (indices (M, 2): the keyframe's
    slot, the frame's slot; the F-filter's inliers (M,); the frame's pixels
    (M, 2)). A row is a candidate when it is an inlier and its keyframe slot
    belongs to a track."""
    out = {}
    for f in frames:
        tracks, xy, keep, seen = [], [], [], set()
        for (k, g), (idx, inl, pix) in results.items():
            if g != f:
                continue
            lookup = kf_tracks.get(k, {})
            for r in range(len(inl)):
                tr = lookup.get(int(idx[r, 0]), -1)
                if not inl[r] or tr < 0:
                    continue
                tracks.append(tr)
                xy.append(np.asarray(pix[r], np.float64))
                keep.append(tr not in seen)
                seen.add(tr)
        out[f] = Links(np.asarray(tracks, np.int64), np.asarray(xy, np.float64).reshape(-1, 2),
                       np.asarray(keep, bool))
    return out


# ---------------------------------------------------------------- P3P RANSAC

def sample_indices(u, valid) -> np.ndarray:
    """(B, s) slot indices of the hypotheses drawn by uniforms ``u`` (B, s)
    over ``n`` slots with validity ``valid`` (n,): slot j lies in bucket
    j mod s (the first s * (n // s) slots only); uniform (b, i) takes the
    r-th valid member of bucket i, r = floor(u * count) clipped to the
    bucket's last, and the bucket's last position where it has none."""
    u = np.asarray(u, np.float64)
    B, s = u.shape
    m = len(valid) // s
    out = np.zeros((B, s), np.int64)
    for i in range(s):
        members = np.nonzero(np.asarray(valid[: m * s], bool)[i::s])[0]   # positions in the bucket
        cnt = len(members)
        r = np.minimum(np.floor(u[:, i].astype(np.float32) * np.float32(max(cnt, 1))),
                       max(cnt - 1, 0)).astype(np.int64)
        pos = members[r] if cnt else np.full(B, m - 1)
        out[:, i] = pos * s + i
    return out


def _quartic_real_roots(c) -> Tuple[np.ndarray, np.ndarray]:
    """Real roots of c[0] x^4 + ... + c[4], (N, 5) -> (N, 4) values and
    validity, from the companion matrix's eigenvalues and two Newton steps."""
    c = np.asarray(c, np.float64)
    N = len(c)
    lead = np.abs(c[:, 0]) > 1e-12 * np.maximum(np.abs(c).max(1), 1e-300)
    a = c[:, 1:] / np.where(lead, c[:, 0], 1.0)[:, None]
    comp = np.zeros((N, 4, 4))
    comp[:, 0, :] = -a
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    ev = np.linalg.eigvals(comp)
    x = ev.real
    ok = lead[:, None] & (np.abs(ev.imag) <= 1e-6 * (1.0 + np.abs(x)))
    for _ in range(2):
        f = (((x + a[:, :1]) * x + a[:, 1:2]) * x + a[:, 2:3]) * x + a[:, 3:4]
        fp = ((4.0 * x + 3.0 * a[:, :1]) * x + 2.0 * a[:, 1:2]) * x + a[:, 2:3]
        x = np.where(np.abs(fp) > 1e-300, x - f / np.where(fp == 0, 1.0, fp), x)
    return x, ok & np.isfinite(x)


def _absolute_orientation(P, Y):
    """(R, t) with Y ~ R P + t for (N, 3, 3) point triples, by the SVD of
    their cross-covariance."""
    Pm, Ym = P.mean(1, keepdims=True), Y.mean(1, keepdims=True)
    H = np.einsum("nki,nkj->nij", P - Pm, Y - Ym)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(np.einsum("nji,nkj->nik", Vt, U)))
    D = np.zeros((len(P), 3, 3))
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = np.where(d == 0, 1.0, d)
    R = np.einsum("nji,njk,nlk->nil", Vt, D, U)
    t = Ym[:, 0] - np.einsum("nij,nj->ni", R, Pm[:, 0])
    return R, t


def p3p(X, x, K):
    """Grunert's P3P (Haralick et al., IJCV 1994, section 2): world points
    ``X`` (B, 3, 3) and pixels ``x`` (B, 3, 2) -> world-to-camera poses
    R (B, 4, 3, 3), t (B, 4, 3) and their validity (B, 4)."""
    X = np.asarray(X, np.float64)
    B = len(X)
    rays = np.concatenate([np.asarray(x, np.float64), np.ones((B, 3, 1))], -1) \
        @ np.linalg.inv(np.asarray(K, np.float64)).T
    j = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    ca = np.sum(j[:, 1] * j[:, 2], -1)
    cb = np.sum(j[:, 0] * j[:, 2], -1)
    cg = np.sum(j[:, 0] * j[:, 1], -1)
    a2 = np.sum((X[:, 1] - X[:, 2]) ** 2, -1)
    b2 = np.sum((X[:, 0] - X[:, 2]) ** 2, -1)
    c2 = np.sum((X[:, 0] - X[:, 1]) ** 2, -1)
    good = b2 > 1e-12
    b2s = np.where(good, b2, 1.0)
    q = (a2 - c2) / b2s
    p = (a2 + c2) / b2s
    A4 = (q - 1.0) ** 2 - 4.0 * c2 / b2s * ca ** 2
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - p) * ca * cg + 2.0 * c2 / b2s * ca ** 2 * cb)
    A2 = 2.0 * (q ** 2 - 1.0 + 2.0 * q ** 2 * cb ** 2 + 2.0 * (b2s - c2) / b2s * ca ** 2
                - 4.0 * p * ca * cb * cg + 2.0 * (b2s - a2) / b2s * cg ** 2)
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * a2 / b2s * cg ** 2 * cb - (1.0 - p) * ca * cg)
    A0 = (1.0 + q) ** 2 - 4.0 * a2 / b2s * cg ** 2
    v, ok = _quartic_real_roots(np.stack([A4, A3, A2, A1, A0], 1))
    den = 2.0 * (cg[:, None] - v * ca[:, None])
    u = ((q[:, None] - 1.0) * v ** 2 - 2.0 * q[:, None] * cb[:, None] * v + 1.0 + q[:, None]) \
        / np.where(np.abs(den) > 1e-12, den, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):   # degenerate samples: not ok below
        s1sq = b2s[:, None] / (1.0 + v ** 2 - 2.0 * v * cb[:, None])
    ok &= good[:, None] & (np.abs(den) > 1e-12) & (s1sq > 0) & np.isfinite(s1sq)
    s1 = np.sqrt(np.where(ok, s1sq, 1.0))
    s = np.stack([s1, u * s1, v * s1], -1)                      # (B, 4, 3) distances
    ok &= np.all(s > 0, -1)
    Y = s[..., None] * j[:, None]                               # (B, 4, 3, 3) camera points
    R, t = _absolute_orientation(np.repeat(X, 4, 0), Y.reshape(-1, 3, 3))
    return R.reshape(B, 4, 3, 3), t.reshape(B, 4, 3), ok


def reprojection_px(R, t, K, X, x) -> np.ndarray:
    """(H, n) pixel errors of points ``X`` (n, 3) against ``x`` (n, 2) under
    poses R (H, 3, 3), t (H, 3). No cheirality test, as in the program's
    scoring."""
    P = np.einsum("ij,hjk->hik", np.asarray(K, np.float64),
                  np.concatenate([R, t[..., None]], -1))
    h = np.einsum("hij,nj->hni", P[..., :3], X) + P[:, None, :, 3]
    z = np.where(np.abs(h[..., 2]) < 1e-12, 1e-12, h[..., 2])
    return np.linalg.norm(h[..., :2] / z[..., None] - x[None], axis=-1)


def rodrigues(w) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * (Kx @ Kx)


def polish(R, t, K, X, x, iters: int = 100):
    """Levenberg-Marquardt on the pixel reprojection error of every given
    correspondence, over a left rotation increment and t, run until a step
    no longer lowers the cost by a relative 1e-12 (the least-squares pose
    from the start's basin): a step that raises the cost is refused and the
    damping raised."""
    K = np.asarray(K, np.float64)

    def residual(R, t):
        c = X @ R.T + t
        h = c @ K.T
        return (h[:, :2] / h[:, 2:3] - x).reshape(-1), c

    r, c = residual(R, t)
    cost, lam = r @ r, 1e-3
    for _ in range(iters):
        Z = c[:, 2]
        du = np.stack([K[0, 0] / Z, K[0, 1] / Z,
                       -(K[0, 0] * c[:, 0] + K[0, 1] * c[:, 1]) / Z ** 2], 1)
        dv = np.stack([np.zeros_like(Z), K[1, 1] / Z, -(K[1, 1] * c[:, 1]) / Z ** 2], 1)
        dc = np.stack([du, dv], 1)                    # (n, 2, 3) d pixel / d camera point
        q = c - t                                     # R X
        skew = np.zeros((len(q), 3, 3))               # d(exp(w) R X)/dw = -[R X]x
        skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = q[:, 2], -q[:, 1], q[:, 0]
        skew[:, 1, 0], skew[:, 2, 0], skew[:, 2, 1] = -q[:, 2], q[:, 1], -q[:, 0]
        J = np.concatenate([dc @ skew, dc], -1).reshape(-1, 6)
        H = J.T @ J
        step = np.linalg.solve(H + lam * np.diag(np.diag(H) + 1e-9), -(J.T @ r))
        R2, t2 = rodrigues(step[:3]) @ R, t + step[3:]
        r2, c2 = residual(R2, t2)
        if not r2 @ r2 < cost:
            lam *= 4.0
            if lam > 1e10:
                break
            continue
        done = cost - r2 @ r2 <= 1e-12 * cost
        R, t, r, c, cost, lam = R2, t2, r2, c2, r2 @ r2, lam * 0.5
        if done:
            break
    return R, t


class Pose(NamedTuple):
    registered: bool
    R: np.ndarray
    t: np.ndarray
    inliers: np.ndarray   # (n,) bool over the slots


def pnp_ransac(X, x, valid, K, u, threshold: float, min_points: int = 4,
               min_links: int = 6) -> Pose:
    """One frame's pose from its slots (world points ``X`` (n, 3), pixels
    ``x`` (n, 2), ``valid`` (n,)) and uniforms ``u`` (B, 3): every P3P
    solution of every sample scored by the number of valid slots under
    ``threshold`` pixels, the first best polished on its inliers and kept
    unless the polish loses inliers. The frame is registered when it has at
    least ``min_links`` valid slots and ``min_points`` inliers."""
    X, x = np.asarray(X, np.float64), np.asarray(x, np.float64)
    valid = np.asarray(valid, bool)
    idx = sample_indices(u, valid)
    R, t, ok = p3p(X[idx], x[idx], K)
    R, t, ok = R.reshape(-1, 3, 3), t.reshape(-1, 3), ok.reshape(-1)
    R = np.where(ok[:, None, None], R, np.eye(3))
    t = np.where(ok[:, None], t, 0.0)
    vi = np.nonzero(valid)[0]     # only valid slots can be inliers
    inl = (reprojection_px(R, t, K, X[vi], x[vi]) < threshold) & ok[:, None]
    best = int(np.argmax(inl.sum(1)))
    Rb, tb = R[best], t[best]
    ib = np.zeros(len(valid), bool)
    ib[vi] = inl[best]
    if ib.sum() >= 3:
        Rp, tp = polish(Rb, tb, K, X[ib], x[ib])
        ip = (reprojection_px(Rp[None], tp[None], K, X, x)[0] < threshold) & valid
        if ip.sum() >= ib.sum():
            Rb, tb, ib = Rp, tp, ip
    registered = valid.sum() >= min_links and ib.sum() >= min_points
    return Pose(bool(registered), Rb, tb, ib)


def padded(links: Links, points, slots: int):
    """A frame's correspondences laid into ``slots`` slots in order, as the
    RANSAC draws over them: (X (slots, 3), x (slots, 2), valid (slots,));
    a repeated track's slot is not valid."""
    n = len(links.tracks)
    X, x, v = np.zeros((slots, 3)), np.zeros((slots, 2)), np.zeros(slots, bool)
    X[:n] = np.asarray(points, np.float64)[links.tracks]
    x[:n] = links.xy
    v[:n] = links.keep
    return X, x, v


def register(links: Dict[int, Links], points, K, uniforms, slots: int,
             threshold: float) -> Dict[int, Pose]:
    """Every frame's pose (``uniforms`` (F, B, 3) in the frames' order)."""
    out = {}
    for fi, f in enumerate(links):
        X, x, v = padded(links[f], points, slots)
        out[f] = pnp_ransac(X, x, v, K, uniforms[fi], threshold)
    return out


def pose_gap(R1, t1, R2, t2) -> Tuple[float, float]:
    """(rotation angle between two world-to-camera poses, degrees; distance
    between their camera centres)."""
    c = (np.trace(R1 @ R2.T) - 1.0) / 2.0
    ang = float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return ang, float(np.linalg.norm(-R1.T @ t1 + R2.T @ t2))
