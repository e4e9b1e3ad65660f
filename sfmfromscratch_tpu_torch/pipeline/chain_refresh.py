"""Post-chain pose refresh by motion averaging: de-bending the PnP chain
(counterpart of ``sfmfromscratch_tpu/pipeline/chain_refresh.py``).

On low-parallax orbits the incremental chain bends, and the final BA
converges inside the bent basin. The refresh re-initialises the poses from
measurements that never passed through the chain: for every frame pair
within ``max_span`` of each other, the map's co-observed track observations
give relative poses by batched 8-point + Sampson GN; rotation averaging,
per-edge baseline scales from measured two-view depth ratios, and
translation averaging give new poses; every track is re-triangulated. The
engine's final BA then polishes in the right basin.

Host numpy is copied as it stands in the JAX module. The device stages run
on the engine's device. ``_solve_scales_cg`` keeps the JAX ``while_loop``'s
data-dependent stop with one host read per CG step.
"""

from __future__ import annotations

import numpy as np
import torch

from sfmfromscratch_tpu_torch.ba.schur import segment_sum
from sfmfromscratch_tpu_torch.geometry.averaging import (
    chain_initial_centers,
    chordal_rotation_init,
    rotation_averaging,
    translation_averaging,
)
from sfmfromscratch_tpu_torch.geometry.epipolar import (
    eight_point_fundamental,
    essential_from_fundamental,
)
from sfmfromscratch_tpu_torch.geometry.triangulation import triangulate_multiview, two_view_depths
from sfmfromscratch_tpu_torch.geometry.two_view import refine_relative_pose
from sfmfromscratch_tpu_torch.ops.harris import _median
from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_log
from sfmfromscratch_tpu_torch.ops.smallsvd import decompose_essential
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def collect_edge_correspondences(
    frames: np.ndarray, tracks: np.ndarray, xy: np.ndarray,
    num_cams: int, max_span: int, cap: int, min_corr: int,
):
    """(edge_i, edge_j, p1, p2, mask, tid): co-observed track coordinates and
    their track ids for every frame pair (f, f+s), s in [1, max_span], capped
    at ``cap`` points per edge; edges with fewer than ``min_corr`` are
    dropped. A ``searchsorted`` join on (track, frame) keys
    (chain_refresh.py:88-159)."""
    key = tracks.astype(np.int64) * num_cams + frames.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    xy_s = xy[order]
    frames_s = frames[order]
    tracks_s = tracks[order]

    e_i, e_j, e_p1, e_p2, e_t = [], [], [], [], []
    for s in range(1, max_span + 1):
        want = key_s + s
        pos = np.searchsorted(key_s, want)
        pos_c = np.clip(pos, 0, len(key_s) - 1)
        hit = (key_s[pos_c] == want) & (frames_s + s < num_cams)
        if not hit.any():
            continue
        o1 = np.nonzero(hit)[0]
        o2 = pos_c[o1]
        e_i.append(frames_s[o1])
        e_j.append(frames_s[o1] + s)
        e_p1.append(xy_s[o1])
        e_p2.append(xy_s[o2])
        e_t.append(tracks_s[o1])

    if not e_i:
        z = np.zeros(0, np.int32)
        return z, z, np.zeros((0, cap, 2), np.float32), \
            np.zeros((0, cap, 2), np.float32), np.zeros((0, cap), bool), \
            np.full((0, cap), -1, np.int64)

    fi = np.concatenate(e_i)
    fj = np.concatenate(e_j)
    P1 = np.concatenate(e_p1)
    P2 = np.concatenate(e_p2)
    Tid = np.concatenate(e_t)

    eid = fi.astype(np.int64) * (max_span + 1) + (fj - fi)
    order = np.argsort(eid, kind="stable")
    eid_s = eid[order]
    uniq, starts, counts = np.unique(eid_s, return_index=True, return_counts=True)
    keep = counts >= min_corr
    uniq, starts, counts = uniq[keep], starts[keep], counts[keep]
    E = len(uniq)
    p1 = np.zeros((E, cap, 2), np.float32)
    p2 = np.zeros((E, cap, 2), np.float32)
    mask = np.zeros((E, cap), bool)
    tid = np.full((E, cap), -1, np.int64)
    for e in range(E):
        sl = order[starts[e]: starts[e] + min(counts[e], cap)]
        n = len(sl)
        p1[e, :n] = P1[sl]
        p2[e, :n] = P2[sl]
        tid[e, :n] = Tid[sl]
        mask[e, :n] = True
    edge_i = (uniq // (max_span + 1)).astype(np.int32)
    edge_j = (edge_i + (uniq % (max_span + 1))).astype(np.int32)
    return edge_i, edge_j, p1, p2, mask, tid


@mm_f32
def _edge_poses(p1, p2, mask, K1, K2, gn_iters: int = 8):
    """Batched two-view pose per edge from pre-filtered (track)
    correspondences: 8-point F on all points -> E -> the cheirality-selected
    candidate -> Sampson GN (chain_refresh.py:162-189). Returns (R_rel with
    R_ij = R_j R_i^T, unit t_rel, rms, n, z1, z2), the last two the
    unit-baseline depths at the refined pose."""
    m = mask
    F = eight_point_fundamental(p1, p2, m)
    E_ = essential_from_fundamental(F, K1, K2)
    R1, R2, t = decompose_essential(E_)
    Rc = torch.stack([R1, R1, R2, R2], dim=1)               # (E, 4, 3, 3)
    tc = torch.stack([t, -t, t, -t], dim=1)                 # (E, 4, 3)
    z1, z2 = two_view_depths(Rc, tc, p1[:, None], p2[:, None], K1[:, None], K2[:, None])
    front = (z1 > 1e-6) & (z2 > 1e-6) & m[:, None, :]
    cnt = torch.sum(front, dim=-1)
    best = torch.argmax(cnt, dim=-1)
    ar = torch.arange(Rc.shape[0], device=Rc.device)
    R, tdir, rms = refine_relative_pose(Rc[ar, best], tc[ar, best], p1, p2, K1, K2, m,
                                        num_iters=gn_iters)
    z1r, z2r = two_view_depths(R, tdir, p1, p2, K1, K2)
    return R, tdir, rms, torch.sum(m, dim=-1), z1r, z2r


def solve_edge_scales(
    edge_i: np.ndarray, edge_j: np.ndarray, tid: np.ndarray,
    mask: np.ndarray, z1: np.ndarray, z2: np.ndarray,
    lam_init: np.ndarray, device=None,
) -> np.ndarray:
    """Per-edge baseline scales from two-view depth ratios, without the
    chain's structure (chain_refresh.py:192-245): a track seen from camera m
    through edges e1, e2 pins ``lam_e1 z^(e1) = lam_e2 z^(e2)``; in
    ``x = log lam`` this is a group-consistency least squares solved by CG on
    ``device`` (``None``: the CUDA card, raising without one; ``"cpu"``: the
    CPU). The gauge matches ``mean(log lam_init)``; edges with no usable
    depth keep their ``lam_init``."""
    device = resolve_device(device)
    E, cap = tid.shape
    eidx = np.tile(np.arange(E, dtype=np.int64)[:, None], (1, cap))
    gi = edge_i[:, None].astype(np.int64) * (tid.max() + 2) + tid
    gj = edge_j[:, None].astype(np.int64) * (tid.max() + 2) + tid
    z_ok1 = mask & (z1 > 1e-4) & np.isfinite(z1)
    z_ok2 = mask & (z2 > 1e-4) & np.isfinite(z2)
    eidx_f = np.concatenate([eidx[z_ok1], eidx[z_ok2]])
    g_f = np.concatenate([gi[z_ok1], gj[z_ok2]])
    logz_f = np.concatenate([np.log(z1[z_ok1]), np.log(z2[z_ok2])])
    _, g_f = np.unique(g_f, return_inverse=True)
    G = int(g_f.max()) + 1 if len(g_f) else 0
    if G == 0:
        return lam_init
    lam = _solve_scales_cg(
        torch.as_tensor(eidx_f, device=device), torch.as_tensor(g_f, device=device),
        torch.as_tensor(logz_f, dtype=torch.float32, device=device), E, G,
    )
    x = lam.cpu().numpy().astype(np.float64)
    x = x - x.mean() + np.log(np.maximum(lam_init, 1e-9)).mean()
    out = np.exp(x).astype(np.float32)
    nconstr = np.bincount(eidx_f, minlength=E)
    out[nconstr == 0] = np.asarray(lam_init, np.float32)[nconstr == 0]
    return out


@mm_f32
def _solve_scales_cg(eidx, gidx, logz, E: int, G: int, cg_iters: int = 400,
                     irls_rounds: int = 3):
    """Weighted group-consistency LS by CG with Huber IRLS outer rounds
    (chain_refresh.py:248-316). The CG stops as the JAX ``while_loop`` does:
    after ``cg_iters`` steps or once ||r||^2 <= 1e-10 ||b||^2, tested on the
    host before each step; a degenerate search direction freezes the
    iterate."""
    eidx, gidx = eidx.long(), gidx.long()

    def solve_weighted(wf, x0):
        sw_g = torch.clamp_min(segment_sum(wf, gidx, G), 1e-9)

        def op(x, z):
            s = x[eidx] + z
            mu = segment_sum(wf * s, gidx, G) / sw_g
            return segment_sum(wf * (s - mu[gidx]), eidx, E)

        b = -op(torch.zeros(E, dtype=logz.dtype, device=logz.device), logz)
        b = b - torch.mean(b)

        def hvp(v):
            h = op(v, torch.zeros_like(logz))
            return h - torch.mean(h)

        bb = torch.dot(b, b)
        x = x0
        rv = b - hvp(x0)
        p = rv
        rs = torch.dot(rv, rv)
        it = 0
        while it < cg_iters and bool(torch.dot(rv, rv) > 1e-10 * bb):
            Ap = hvp(p)
            denom = torch.dot(p, Ap)
            ok = denom > 1e-12 * torch.clamp_min(torch.dot(p, p), 1e-20)
            alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
            x = x + alpha * p
            rv = rv - alpha * Ap
            rs_new = torch.dot(rv, rv)
            beta = torch.where(ok, rs_new / torch.where(rs < 1e-20, 1e-20, rs), 0.0)
            p = rv + beta * p
            rs = rs_new
            it += 1
        return x

    x = solve_weighted(torch.ones_like(logz), torch.zeros(E, dtype=logz.dtype, device=logz.device))
    ones = torch.ones_like(logz)
    for _ in range(irls_rounds):
        s = x[eidx] + logz
        sw_g = torch.clamp_min(segment_sum(ones, gidx, G), 1.0)
        mu = segment_sum(s, gidx, G) / sw_g
        r = torch.abs(s - mu[gidx])
        delta = torch.clamp_min(2.0 * 1.4826 * _median(r), 0.05)
        wf = torch.clamp_max(delta / torch.clamp_min(r, 1e-9), 1.0)
        x = solve_weighted(wf, x)
    return x


@mm_f32
def _average_poses(R_rel, edge_i, edge_j, w, R_init, lam, t_rel, num_cameras: int):
    """Rotation + translation averaging given per-edge measurements; the
    translation init is a spanning walk over the measured scaled edges
    (chain_refresh.py:319-353). Returns (rvecs (C, 3), ts (C, 3), R, c)."""
    C = num_cameras
    R0 = chordal_rotation_init(R_rel, edge_i, edge_j, R_init, edge_w=w,
                               num_cameras=C, cg_iters=min(max(128, 2 * C), 4096))
    R = rotation_averaging(R_rel, edge_i, edge_j, R0, edge_w=w, num_cameras=C,
                           eps_final=0.02)
    u = torch.einsum("eji,ej->ei", R[edge_j.long()], t_rel)
    u = u / torch.clamp_min(torch.linalg.norm(u, dim=-1, keepdim=True), 1e-9)
    su = u * lam[:, None]
    nz = (w > 1e-3).cpu().numpy()
    c0 = chain_initial_centers(su.cpu().numpy()[nz], edge_i.cpu().numpy()[nz],
                               edge_j.cpu().numpy()[nz], C, device=u.device)
    c = translation_averaging(u, edge_i, edge_j, c0, edge_w=w, num_cameras=C, edge_s=lam)
    rvecs = so3_log(R)
    ts = -torch.einsum("cij,cj->ci", R, c)
    return rvecs, ts, R, c


def averaging_refresh(eng, max_span: int = 6, cap: int = 192, min_corr: int = 24) -> None:
    """Refresh ``eng``'s chain poses by motion averaging over the map's own
    track correspondences, then re-triangulate (chain_refresh.py:356-467).
    Mutates ``eng.global_poses`` and the map's points on ``eng.device``; the
    caller runs the final global BA afterwards. Its time goes to
    ``eng.stage_times["chain_refresh"]``, the edge-scale solve's (host
    bookkeeping and the CG with its host reads) to its child span
    ``chain_refresh.scales``; a skipped refresh leaves neither."""
    span = eng._stage("chain_refresh")
    if _refresh(eng, max_span, cap, min_corr):
        eng._stage_end(span)
    else:
        eng._timer.close(span, time_as=None)
        eng.spans.remove(span)


def _refresh(eng, max_span: int, cap: int, min_corr: int) -> bool:
    """``averaging_refresh``'s work; False where it skipped the refresh."""
    dev = eng.device
    frames, tracks, xy = eng.map.observations()
    C = len(eng.global_poses)
    if C < 3 or len(frames) == 0:
        return False
    edge_i, edge_j, p1, p2, mask, tid = collect_edge_correspondences(
        np.asarray(frames), np.asarray(tracks), np.asarray(xy, np.float64),
        C, max_span, cap, min_corr,
    )
    E = len(edge_i)
    if E < C - 1:
        eng.warnings.append(f"chain_refresh: only {E} usable edges for {C} cameras; skipped")
        return False
    # A cut component would get a free gauge from the averaging Laplacian:
    # keep the chain instead.
    parent = np.arange(C)

    def _find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(edge_i, edge_j):
        parent[_find(a)] = _find(b)
    if len({_find(c) for c in range(C)}) > 1:
        eng.warnings.append(
            "chain_refresh: track-derived edge graph is disconnected; "
            "keeping the chain solution"
        )
        return False

    def dt(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    Ks = np.stack([np.asarray(K, np.float64) for K in eng.global_K])
    R_rel, t_rel, rms, n, z1, z2 = _edge_poses(
        dt(p1), dt(p2), dt(mask, torch.bool), dt(Ks[edge_i]), dt(Ks[edge_j]))

    # Edge weights: support-weighted, Sampson-rms damped.
    n_np, rms_np = n.cpu().numpy(), rms.cpu().numpy()
    w = np.sqrt(np.maximum(n_np.astype(np.float64), 1.0) / cap)
    w = w / (1.0 + np.asarray(rms_np, np.float64))
    w = (w / max(w.max(), 1e-9)).astype(np.float32)

    # Chain state as the averaging init and gauge anchor.
    rv = dt(np.stack([r for r, _ in eng.global_poses]))
    tv = np.stack([t for _, t in eng.global_poses])
    R_chain = so3_exp(rv)
    c_chain = -np.einsum("cij,ci->cj", R_chain.cpu().numpy().astype(np.float64), tv)
    lam_chain = np.maximum(np.linalg.norm(c_chain[edge_i] - c_chain[edge_j], axis=1), 1e-6)
    z1_np, z2_np = z1.cpu().numpy(), z2.cpu().numpy()
    scales = eng._timer.open("chain_refresh.scales")   # the fetches above end the device's queue
    lam = solve_edge_scales(edge_i, edge_j, tid, mask, z1_np, z2_np, lam_chain, device=dev)
    eng._timer.close(scales, time_as=None)

    rvecs, ts, R, _c = _average_poses(
        R_rel, dt(edge_i, torch.int64), dt(edge_j, torch.int64), dt(w), R_chain, dt(lam),
        t_rel, num_cameras=C,
    )
    rvecs_np, ts_np, R_np = rvecs.cpu().numpy(), ts.cpu().numpy(), R.cpu().numpy()
    eng.global_poses = [
        (np.asarray(rvecs_np[i], np.float64), np.asarray(ts_np[i], np.float64))
        for i in range(C)
    ]

    # Re-triangulate every track under the refreshed poses, on the JAX
    # package's padded observation list.
    T = eng.map.num_tracks
    P_all = np.einsum(
        "cij,cjk->cik", Ks,
        np.concatenate([np.asarray(R_np, np.float64),
                        np.stack([t for _, t in eng.global_poses])[:, :, None]], axis=2),
    )
    O = len(frames)
    Ob = _round_up(O, 4096)
    Tb = _round_up(T, 1024)
    obs_cam = np.zeros(Ob, np.int64); obs_cam[:O] = frames
    obs_pt = np.full(Ob, Tb - 1, np.int64); obs_pt[:O] = tracks
    obs_xy = np.zeros((Ob, 2), np.float32); obs_xy[:O] = xy
    ww = np.zeros(Ob, np.float32); ww[:O] = 1.0
    X, _nobs = triangulate_multiview(dt(P_all), dt(obs_cam, torch.int64),
                                     dt(obs_pt, torch.int64), dt(obs_xy), num_points=Tb,
                                     obs_w=dt(ww), gn_iters=8)
    eng.map.update_points(X.cpu().numpy().astype(np.float64)[:T])
    eng.warnings.append(f"chain_refresh: averaged {E} track-derived edges over {C} cameras")
    return True
