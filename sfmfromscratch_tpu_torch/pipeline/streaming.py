"""Advancing-window map-block streaming: out-of-core bundle adjustment over
a map partitioned into contiguous camera blocks (counterpart of
``sfmfromscratch_tpu/pipeline/streaming.py``).

The map lives in a :class:`MapBlockStore` on disk, in the JAX package's
layout (a JSON index and per-block ``.npz`` files), so a store written by one
package is read by the other. The solver advances a window of blocks:

1. load the blocks of the current window (cameras, their observations and
   the window's track copies),
2. solve the window with the port's Schur LM (``ba/lm.py``) on the device,
   sharded by observation over a mesh's ``data`` axis when one is given
   (``parallel/sharded_ba.py``), with boundary cameras (already refined by an earlier window) and boundary
   tracks (observed outside the window) frozen through ``cam_fixed`` and
   ``pt_fixed``,
3. write the refined cameras and interior tracks back to the resident
   blocks, evict the blocks that leave the window, advance.

Peak host map memory is bounded by the window, not by the sequence length.
A track is optimised only in a window that holds all of its blocks, and
windows overlap by at least the largest track span, so every copy of a
track is resident whenever it moves and copies never diverge.

Gauge: camera 0 of the first window is frozen; each later window is
anchored by its frozen overlap cameras. The store and the regate are numpy
on the host, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


# --------------------------------------------------------------------------
# Block store
# --------------------------------------------------------------------------


class MapBlockStore:
    """Disk-backed map partitioned into contiguous camera blocks.

    Layout under ``root/``::

        meta.json          num_blocks, block_cams, num_cameras, max_span_blocks
        block_0000.npz     cam0, cams (b,6), K (b,3,3),
                           obs_cam (global), obs_pt (global), obs_xy
        pts_0000.npz       pt_ids, pt_xyz, pt_first, pt_last, pt_ver

    ``pt_first`` / ``pt_last`` are the first/last *block* index observing each
    track — the window solver's locality index (8 B/track; the O(N) payload is
    the observations, which never all co-reside).
    """

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "meta.json")) as f:
            m = json.load(f)
        self.num_blocks: int = m["num_blocks"]
        self.block_cams: int = m["block_cams"]
        self.num_cameras: int = m["num_cameras"]
        self.max_span_blocks: int = m["max_span_blocks"]
        # resident-set bookkeeping (the out-of-core contract being tested)
        self._resident: Dict[int, dict] = {}
        self.peak_resident_obs = 0
        self.peak_resident_bytes = 0
        self.total_obs: int = m["total_obs"]

    # -------------------------------------------------------------- build
    @classmethod
    def create(cls, root: str, block_cams: int) -> "_StoreBuilder":
        return _StoreBuilder(root, block_cams)

    @classmethod
    def build_from_arrays(
        cls, root: str, cam_params: np.ndarray, K: np.ndarray,
        points: np.ndarray, obs_cam: np.ndarray, obs_pt: np.ndarray,
        obs_xy: np.ndarray, block_cams: int,
    ) -> "MapBlockStore":
        """Partition an in-memory map (the engine hand-off path). For builds
        that must never materialize the whole map, use :meth:`create` and
        append block by block."""
        b = cls.create(root, block_cams)
        C = cam_params.shape[0]
        first_block = np.full(points.shape[0], -1, np.int64)
        for blk, c0 in enumerate(range(0, C, block_cams)):
            sel = (obs_cam >= c0) & (obs_cam < c0 + block_cams)
            new = np.unique(obs_pt[sel])
            new = new[first_block[new] < 0]
            first_block[new] = blk
            b.append_block(
                cam_params[c0 : c0 + block_cams], K[c0 : c0 + block_cams],
                obs_cam[sel], obs_pt[sel], obs_xy[sel],
                new_pt_ids=new, new_pt_xyz=points[new],
            )
        return b.finalize()

    # -------------------------------------------------------------- access
    def _load(self, blk: int) -> dict:
        if blk in self._resident:
            return self._resident[blk]
        d = dict(np.load(os.path.join(self.root, f"block_{blk:04d}.npz")))
        d.update(np.load(os.path.join(self.root, f"pts_{blk:04d}.npz")))
        self._resident[blk] = d
        self._update_peaks()
        return d

    def _evict(self, blk: int) -> None:
        d = self._resident.pop(blk, None)
        if d is None:
            return
        if d.pop("_dirty", False):
            np.savez(
                os.path.join(self.root, f"block_{blk:04d}.npz"),
                **{k: d[k] for k in ("cam0", "cams", "K", "obs_cam",
                                     "obs_pt", "obs_xy")},
            )
            np.savez(
                os.path.join(self.root, f"pts_{blk:04d}.npz"),
                **{k: d[k] for k in ("pt_ids", "pt_xyz", "pt_first",
                                     "pt_last", "pt_ver")},
            )

    def evict_all(self) -> None:
        for blk in list(self._resident):
            self._evict(blk)

    def _update_peaks(self) -> None:
        obs = sum(int(d["obs_cam"].shape[0]) for d in self._resident.values())
        by = sum(
            sum(a.nbytes for a in d.values() if isinstance(a, np.ndarray))
            for d in self._resident.values()
        )
        self.peak_resident_obs = max(self.peak_resident_obs, obs)
        self.peak_resident_bytes = max(self.peak_resident_bytes, by)

    # ------------------------------------------------------------ reading
    def read_cameras(self) -> tuple:
        """Stream out all cameras (one block resident at a time).
        Returns (cam_params (C,6), K (C,3,3))."""
        cams, Ks = [], []
        for blk in range(self.num_blocks):
            d = self._load(blk)
            cams.append(d["cams"].copy())
            Ks.append(d["K"].copy())
            self._evict(blk)
        return np.concatenate(cams), np.concatenate(Ks)

    def read_points(self) -> tuple:
        """Stream out all tracks: (pt_ids, pt_xyz), deduplicated (copies are
        consistent by the window-overlap invariant; verified by pt_ver in
        tests)."""
        seen: Dict[int, np.ndarray] = {}
        for blk in range(self.num_blocks):
            d = self._load(blk)
            for i, t in enumerate(d["pt_ids"]):
                seen[int(t)] = d["pt_xyz"][i]
            self._evict(blk)
        ids = np.fromiter(seen.keys(), np.int64, len(seen))
        order = np.argsort(ids)
        xyz = np.stack([seen[int(t)] for t in ids[order]]) if len(ids) else (
            np.zeros((0, 3)))
        return ids[order], xyz

    def mean_reprojection_error(self) -> float:
        """Weighted mean pixel error over ALL observations, computed one
        block at a time (each block is self-contained: its cameras, its
        observations, its track copies)."""
        tot, n = 0.0, 0
        for blk in range(self.num_blocks):
            d = self._load(blk)
            if d["obs_cam"].shape[0]:
                tot += _block_reproj_sum(d)
                n += int(d["obs_cam"].shape[0])
            self._evict(blk)
        return tot / max(n, 1)


def _block_residuals(d: dict) -> np.ndarray:
    """(O_b,) per-observation pixel errors of one resident block (negative
    where the point is behind the camera)."""
    from scipy.spatial.transform import Rotation

    if d["obs_cam"].shape[0] == 0:
        return np.zeros(0)
    c0 = int(d["cam0"])
    lc = d["obs_cam"] - c0
    cams = d["cams"][lc]
    K = d["K"][lc]
    id2row = {int(t): i for i, t in enumerate(d["pt_ids"])}
    rows = np.asarray([id2row[int(t)] for t in d["obs_pt"]])
    X = d["pt_xyz"][rows]
    R = Rotation.from_rotvec(cams[:, :3]).as_matrix()
    p = np.einsum("oij,oj->oi", R, X) + cams[:, 3:]
    h = np.einsum("oij,oj->oi", K, p)
    z = np.where(np.abs(h[:, 2]) < 1e-12, 1e-12, h[:, 2])
    err = np.linalg.norm(h[:, :2] / z[:, None] - d["obs_xy"], axis=1)
    return np.where(h[:, 2] > 1e-6, err, -err)


def _block_reproj_sum(d: dict) -> float:
    return float(np.abs(_block_residuals(d)).sum())


class _StoreBuilder:
    """Streaming store construction: blocks append one at a time; only the
    per-track locality index (id -> first/last block, xyz; O(P) * ~40 B) is
    held across appends — never two blocks' payload."""

    def __init__(self, root: str, block_cams: int):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.block_cams = block_cams
        self.blk = 0
        self.num_cameras = 0
        self.total_obs = 0
        self._track: Dict[int, list] = {}  # id -> [xyz, first_blk, last_blk]
        self._blk_tracks: List[np.ndarray] = []

    def append_block(
        self, cams: np.ndarray, K: np.ndarray, obs_cam: np.ndarray,
        obs_pt: np.ndarray, obs_xy: np.ndarray,
        new_pt_ids: np.ndarray, new_pt_xyz: np.ndarray,
    ) -> None:
        """Append the next ``block_cams`` cameras with their observations.
        ``obs_cam`` is GLOBAL camera indices (must lie in this block);
        ``new_pt_ids``/``new_pt_xyz`` are tracks first observed here."""
        c0 = self.num_cameras
        assert cams.shape[0] <= self.block_cams
        if obs_cam.shape[0]:
            assert obs_cam.min() >= c0
            assert obs_cam.max() < c0 + cams.shape[0]
        for t, xyz in zip(np.asarray(new_pt_ids), np.asarray(new_pt_xyz)):
            self._track[int(t)] = [xyz, self.blk, self.blk]
        tids = np.unique(np.asarray(obs_pt))
        for t in tids:
            rec = self._track.get(int(t))
            if rec is None:
                raise ValueError(
                    f"track {int(t)} observed in block {self.blk} but never "
                    "declared via new_pt_ids"
                )
            rec[2] = self.blk
        np.savez(
            os.path.join(self.root, f"block_{self.blk:04d}.npz"),
            cam0=np.int64(c0),
            cams=np.asarray(cams, np.float64),
            K=np.asarray(K, np.float64),
            obs_cam=np.asarray(obs_cam, np.int32),
            obs_pt=np.asarray(obs_pt, np.int64),
            obs_xy=np.asarray(obs_xy, np.float64),
        )
        self._blk_tracks.append(tids)
        self.num_cameras += cams.shape[0]
        self.total_obs += int(obs_cam.shape[0])
        self.blk += 1

    def finalize(self) -> MapBlockStore:
        max_span = 0
        for blk, tids in enumerate(self._blk_tracks):
            first = np.asarray([self._track[int(t)][1] for t in tids], np.int32)
            last = np.asarray([self._track[int(t)][2] for t in tids], np.int32)
            xyz = (np.stack([self._track[int(t)][0] for t in tids])
                   if len(tids) else np.zeros((0, 3)))
            if len(tids):
                max_span = max(max_span, int((last - first).max()))
            np.savez(
                os.path.join(self.root, f"pts_{blk:04d}.npz"),
                pt_ids=np.asarray(tids, np.int64),
                pt_xyz=np.asarray(xyz, np.float64),
                pt_first=first, pt_last=last,
                pt_ver=np.zeros(len(tids), np.int64),
            )
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump(
                dict(num_blocks=self.blk, block_cams=self.block_cams,
                     num_cameras=self.num_cameras, max_span_blocks=max_span,
                     total_obs=self.total_obs), f,
            )
        self._track.clear()
        return MapBlockStore(self.root)


# --------------------------------------------------------------------------
# Advancing-window solver
# --------------------------------------------------------------------------


def stream_regate(store: MapBlockStore, regate_px: float) -> int:
    """Drop observations with residual > ``regate_px`` under the CURRENT
    model, and any observation whose track is left with < 2 — the streaming
    analogue of GlobalSfmEngine._regate_observations, two block-at-a-time
    passes (per-track surviving counts are the only cross-block state: an
    O(P) int32 index array, like the solver's cam_done)."""
    # pass 1: count surviving observations per track
    counts: Dict[int, int] = {}
    for blk in range(store.num_blocks):
        d = store._load(blk)
        r = _block_residuals(d)
        for t in d["obs_pt"][(r >= 0) & (r < regate_px)]:
            counts[int(t)] = counts.get(int(t), 0) + 1
        store._evict(blk)
    # pass 2: rewrite each block's observation table
    dropped = 0
    for blk in range(store.num_blocks):
        d = store._load(blk)
        r = _block_residuals(d)
        keep = (r >= 0) & (r < regate_px)
        if keep.size:
            keep &= np.asarray(
                [counts.get(int(t), 0) >= 2 for t in d["obs_pt"]], bool)
        dropped += int((~keep).sum())
        if (~keep).any():
            d["obs_cam"] = d["obs_cam"][keep]
            d["obs_pt"] = d["obs_pt"][keep]
            d["obs_xy"] = d["obs_xy"][keep]
            d["_dirty"] = True
        store._evict(blk)
    store.total_obs -= dropped
    return dropped


@dataclass
class StreamStats:
    windows_run: int = 0
    sweeps: int = 0
    clamped_tracks: int = 0       # span > window: never fully resident, frozen
    peak_resident_obs: int = 0
    peak_resident_bytes: int = 0
    total_obs: int = 0
    initial_error: float = 0.0
    final_error: float = 0.0
    window_errors: List[float] = field(default_factory=list)


def stream_bundle_adjust(
    store: MapBlockStore,
    window_blocks: int = 4,
    mesh=None,
    sweeps: int = 1,
    max_iters: int = 20,
    cg_iters: int = 50,
    ftol: float = 1e-4,
    huber_delta: float = 0.0,
    regate_px: float = 0.0,
    verbose: bool = False,
    device=None,
) -> StreamStats:
    """Advance a ``window_blocks``-wide window over the store, solving each
    window on ``device`` (the CUDA card unless ``"cpu"``) with boundary
    cameras and tracks frozen (see the module docstring). Several ``sweeps``
    re-run the window schedule forward with every camera freed again
    (Gauss-Seidel), with a regate between sweeps when ``regate_px > 0``.
    With ``mesh`` (a ``DeviceMesh`` with a ``data`` axis) each window solve
    is ``bundle_adjust_sharded`` (``streaming.py:431-436``): every rank
    holds its own store and runs the same window schedule; the solves are
    mesh-wide."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import make_problem, pad_problem
    from sfmfromscratch_tpu_torch.parallel.mesh import mesh_axis
    from sfmfromscratch_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded
    from sfmfromscratch_tpu_torch.utils.device import resolve_device

    sharded = mesh_axis(mesh, "data") is not None
    device = resolve_device(device)
    B = store.num_blocks
    window_blocks = max(1, min(window_blocks, B))
    overlap = min(store.max_span_blocks, window_blocks - 1)
    stride = max(1, window_blocks - overlap)
    stats = StreamStats(total_obs=store.total_obs)
    stats.initial_error = store.mean_reprojection_error()

    cam_done = np.zeros(store.num_cameras, bool)
    clamped: set = set()

    for sweep in range(sweeps):
        cam_done[:] = False
        starts = list(range(0, max(B - window_blocks, 0) + 1, stride))
        if starts[-1] != B - window_blocks:
            starts.append(B - window_blocks)
        for a in starts:
            blocks = list(range(a, a + window_blocks))
            resident = [store._load(b) for b in blocks]

            # ---- the window problem (local, contiguous cameras)
            cam_lo = int(resident[0]["cam0"])
            cam_hi = int(resident[-1]["cam0"]) + resident[-1]["cams"].shape[0]
            cams = np.concatenate([d["cams"] for d in resident])
            Ks = np.concatenate([d["K"] for d in resident])
            obs_cam = np.concatenate([d["obs_cam"] for d in resident])
            obs_pt = np.concatenate([d["obs_pt"] for d in resident])
            obs_xy = np.concatenate([d["obs_xy"] for d in resident])

            # window tracks: first copy per id and its span
            id2local: Dict[int, int] = {}
            xyz_rows, first_rows, last_rows = [], [], []
            for d in resident:
                for i, t in enumerate(d["pt_ids"]):
                    t = int(t)
                    if t not in id2local:
                        id2local[t] = len(xyz_rows)
                        xyz_rows.append(d["pt_xyz"][i])
                        first_rows.append(d["pt_first"][i])
                        last_rows.append(d["pt_last"][i])
            pts = np.stack(xyz_rows) if xyz_rows else np.zeros((0, 3))
            pt_first = np.asarray(first_rows, np.int32)
            pt_last = np.asarray(last_rows, np.int32)

            local_pt = np.asarray([id2local[int(t)] for t in obs_pt], np.int32)
            local_cam = (obs_cam - cam_lo).astype(np.int32)

            cam_fixed = cam_done[cam_lo:cam_hi].copy()
            if cam_lo == 0:
                cam_fixed[0] = True  # gauge anchor
            # boundary tracks frozen: observations extend outside the window
            interior = (pt_first >= blocks[0]) & (pt_last <= blocks[-1])
            pt_fixed = ~interior
            for t, li in id2local.items():
                if int(pt_last[li] - pt_first[li]) >= window_blocks:
                    clamped.add(t)

            problem = pad_problem(make_problem(
                cams, pts, local_cam, local_pt, obs_xy, Ks,
                cam_fixed=cam_fixed, pt_fixed=pt_fixed, device=device,
            ))
            kw = dict(max_iters=max_iters, cg_iters=cg_iters, ftol=ftol, huber_delta=huber_delta)
            if sharded:
                res = bundle_adjust_sharded(problem, mesh, **kw)
            else:
                res = bundle_adjust(problem, **kw)
            new_cams = res.cam_params[: cams.shape[0]].cpu().numpy().astype(np.float64)
            new_pts = res.points[: pts.shape[0]].cpu().numpy().astype(np.float64)
            stats.window_errors.append(float(res.final_mean_error))
            if verbose:
                print(
                    f"stream: sweep {sweep} window {blocks[0]}-{blocks[-1]}: "
                    f"err {float(res.initial_mean_error):.3f} -> "
                    f"{float(res.final_mean_error):.3f}", flush=True,
                )

            # ---- write back into every resident copy
            for d in resident:
                c0 = int(d["cam0"])
                nb = d["cams"].shape[0]
                upd = ~cam_done[c0 : c0 + nb]
                if c0 == 0:
                    upd[0] = False
                d["cams"][upd] = new_cams[c0 - cam_lo : c0 - cam_lo + nb][upd]
                rows = np.asarray([id2local[int(t)] for t in d["pt_ids"]], np.int64)
                if rows.shape[0]:
                    free = interior[rows]
                    d["pt_xyz"][free] = new_pts[rows[free]]
                    d["pt_ver"][free] += 1
                d["_dirty"] = True
            cam_done[cam_lo:cam_hi] = True
            stats.windows_run += 1

            # ---- evict blocks that leave the next window
            last_window = a == starts[-1]
            keep_from = B if last_window else a + stride
            for b in blocks:
                if b < keep_from:
                    store._evict(b)
            if last_window:
                break
        store.evict_all()
        stats.sweeps += 1
        if regate_px > 0 and sweep < sweeps - 1:
            # BA -> drop gross-residual observations -> BA again, the
            # monolithic engine's ba_rounds/regate loop, block at a time.
            stream_regate(store, regate_px)

    stats.clamped_tracks = len(clamped)
    stats.peak_resident_obs = store.peak_resident_obs
    stats.peak_resident_bytes = store.peak_resident_bytes
    stats.final_error = store.mean_reprojection_error()
    return stats
