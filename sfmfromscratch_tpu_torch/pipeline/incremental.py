"""Incremental Structure-from-Motion engine on the default path of the JAX
package's ``SfmEngine`` (counterpart of
``sfmfromscratch_tpu/pipeline/incremental.py``).

The stages run back to back on the device, with their state there:

* features: every image decoded once, one batch for the whole sequence, so
  the Harris kernel runs once per pyramid level;
* matching: the N-1 consecutive pairs in one launch of the matcher kernel;
* filter: adaptive F-RANSAC on every pair but (1, 2);
* bootstrap: adaptive essential RANSAC on pair (1, 2) with its raw
  ratio-test mask, DLT, 8 Gauss-Newton steps;
* chain: P3P PnP RANSAC over frames 3..N with the keypoint->track table and
  the points buffer on the device (the JAX ``lax.scan`` becomes a loop over
  frames with no host read);
* one fetch of the front's results to the host map, then one global LM
  bundle adjustment.

With ``chain_refresh="averaging"`` the chain's poses are refreshed by motion
averaging over the map's own tracks (``pipeline/chain_refresh.py``) before
the BA. The host reads values only where control needs them: the adaptive
RANSAC and LM stopping rules, and the fetches. Options the JAX engine offers
off these paths raise ``NotImplementedError``.

``_candidate_pairs``, ``_match_pairs`` and ``_global_ba(freeze_before=...)``
serve ``GlobalSfmEngine`` (``pipeline/global_sfm.py``), which inherits them.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
from sfmfromscratch_tpu_torch.ba.problem import make_problem, pad_problem
from sfmfromscratch_tpu_torch.config import PipelineConfig
from sfmfromscratch_tpu_torch.geometry.camera import SensorType, intrinsics_from_exif, projection_matrix
from sfmfromscratch_tpu_torch.geometry.pnp import pnp_ransac
from sfmfromscratch_tpu_torch.geometry.ransac import (
    ransac_essential_pose_adaptive,
    ransac_fundamental_adaptive_batch,
)
from sfmfromscratch_tpu_torch.geometry.triangulation import refine_points_gn, triangulate_dlt
from sfmfromscratch_tpu_torch.io.images import load_image_u8
from sfmfromscratch_tpu_torch.ops.lie import so3_log
from sfmfromscratch_tpu_torch.ops.matcher import match_pairs_batch
from sfmfromscratch_tpu_torch.pipeline.chain_refresh import averaging_refresh
from sfmfromscratch_tpu_torch.pipeline.frontend import extract_features_batch, preprocess_image_batch
from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore
from sfmfromscratch_tpu_torch.types import Features, PairGeometry
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.utils.precision import f32_precision


def scatter_last(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``table`` with ``table[idx[r]] = vals[r]`` applied for rows r in order,
    so the last row naming a slot wins, as XLA's ``.at[].set`` and numpy's
    fancy assignment settle duplicates. Rows with ``idx == len(table)`` are
    dropped. CUDA's ``index_put_`` keeps an arbitrary duplicate, so the
    winner is chosen explicitly: the largest row per slot."""
    n = table.shape[0]
    rows = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(0, idx.long(), rows, reduce="amax")[:n]
    return torch.where(winner >= 0, vals[winner.clamp_min(0)].to(table.dtype), table)


def bootstrap(
    generator: Optional[torch.Generator],
    p1: torch.Tensor, p2: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor,
    mask: torch.Tensor, max_hypotheses: int, threshold: float, stage_size: int = 512,
    uniforms: Optional[torch.Tensor] = None,
):
    """Bootstrap of pair (1, 2) (``incremental.py:100-122``): adaptive
    essential RANSAC in stages of ``stage_size`` (``uniforms`` (stages, S, 8)
    replaces the draws), DLT and 8 Gauss-Newton steps on its inliers.
    Returns (inliers, X, rvec, t, P2)."""
    with f32_precision():
        pose = ransac_essential_pose_adaptive(
            generator, p1, p2, K1, K2, mask, max_hypotheses=max_hypotheses,
            stage_size=stage_size, threshold=threshold, min_cheirality_frac=0.75,
            uniforms=uniforms,
        )
        P1 = projection_matrix(torch.eye(3, device=p1.device), torch.zeros(3, device=p1.device), K1)
        P2 = projection_matrix(pose.R, pose.t, K2)
        X = triangulate_dlt(p1, p2, P1, P2)
        X = refine_points_gn(X, p1, p2, P1, P2, mask=pose.inliers, num_iters=8)
        return pose.inliers, X, so3_log(pose.R), pose.t, P2


def chain_scan(
    generator: Optional[torch.Generator],
    p1_all: torch.Tensor,      # (F, M, 2)
    p2_all: torch.Tensor,      # (F, M, 2)
    idx1_all: torch.Tensor,    # (F, M) keypoint index in the frame's left image
    idx2_all: torch.Tensor,    # (F, M) keypoint index in the frame's right image
    mask_all: torch.Tensor,    # (F, M) bool
    K2_all: torch.Tensor,      # (F, 3, 3)
    kp_tracks0: torch.Tensor,  # (kp_capacity,) track per keypoint of image 2
    points0: torch.Tensor,     # (max_points, 3) bootstrap tracks at the front
    n_points0,                 # () int
    P2_0: torch.Tensor,        # (3, 4) bootstrap projection
    num_hypotheses: int,
    reproj_threshold: float,
    uniforms: Optional[torch.Tensor] = None,   # (F, num_hypotheses, 3)
):
    """The sequential PnP chain over F frames with the track table on the
    device (``_chain_scan_device``, ``incremental.py:129-226``).

    Per frame: link matches whose left keypoint carries a track, PnP RANSAC
    on those 2D-3D pairs, triangulate and refine the unlinked matches against
    the previous projection, keep those in front of both cameras as new
    tracks (ids by prefix sum; past ``max_points`` they are dropped), and
    build the next frame's keypoint->track table from the PnP inliers, then
    the new tracks, the last write of a keypoint winning. Every gather index
    is clamped.

    Returns (rvecs (F, 3), ts (F, 3), oks (F,), num_inliers (F,),
    obs_track (F, 2M), obs_xy (F, 2M, 2), points, n_points): observation
    slots [0, M) re-observe linked tracks, [M, 2M) are first observations
    of new tracks (-1 = none).
    """
    F, M = mask_all.shape
    dev = p1_all.device
    kp_capacity = kp_tracks0.shape[0]
    max_points = points0.shape[0]
    # One extra row takes the writes that are dropped.
    points = torch.cat([points0, points0.new_zeros((1, 3))])
    n_points = torch.as_tensor(n_points0, device=dev).to(torch.int64)
    kp_tracks = kp_tracks0.to(torch.int64)
    P_prev = P2_0
    if uniforms is None:
        uniforms = torch.rand((F, num_hypotheses, 3), generator=generator, device=dev)
    outs = []
    with f32_precision():
        for f in range(F):
            p1, p2, mask, K2 = p1_all[f], p2_all[f], mask_all[f], K2_all[f]
            idx1 = idx1_all[f].long().clamp(0, kp_capacity - 1)
            idx2 = idx2_all[f].long()
            linked = torch.where(mask, kp_tracks[idx1], -1)
            sel = linked >= 0
            X_known = points[linked.clamp(0, max_points - 1)]

            pose = pnp_ransac(None, X_known, p2, K2, mask=sel, num_hypotheses=num_hypotheses,
                              reproj_threshold=reproj_threshold, uniforms=uniforms[f])
            pnp_inl = pose.inliers & sel

            P2 = projection_matrix(pose.R, pose.t, K2)
            X_new = triangulate_dlt(p1, p2, P_prev, P2)
            new_sel = mask & ~sel
            X_new = refine_points_gn(X_new, p1, p2, P_prev, P2, mask=new_sel, num_iters=8)
            Xh = torch.cat([X_new, torch.ones_like(X_new[:, :1])], dim=1)
            z1 = (Xh @ P_prev.T)[:, 2]
            z2 = (Xh @ P2.T)[:, 2]
            ok_new = new_sel & (z1 > 1e-6) & (z2 > 1e-6)

            new_id = n_points + torch.cumsum(ok_new.to(torch.int64), 0) - 1
            in_cap = ok_new & (new_id < max_points)
            points = points.index_put((torch.where(in_cap, new_id, max_points),), X_new)
            n_points = torch.clamp_max(n_points + torch.sum(ok_new), max_points)

            # Next frame's table: re-observations, then new tracks.
            valid_idx2 = (idx2 >= 0) & (idx2 < kp_capacity)
            table = torch.full((kp_capacity,), -1, dtype=torch.int64, device=dev)
            table = scatter_last(table, torch.where(pnp_inl & valid_idx2, idx2, kp_capacity), linked)
            kp_tracks = scatter_last(table, torch.where(in_cap & valid_idx2, idx2, kp_capacity), new_id)

            obs_track = torch.cat([torch.where(pnp_inl, linked, -1), torch.where(in_cap, new_id, -1)])
            outs.append((so3_log(pose.R), pose.t, pose.ok, pose.num_inliers, obs_track,
                         torch.cat([p2, p2])))
            P_prev = P2
    rvecs, ts, oks, ninl, obs_track, obs_xy = (torch.stack(v) for v in zip(*outs))
    return rvecs, ts, oks, ninl, obs_track, obs_xy, points[:max_points], n_points


class SfmEngine:
    """Incremental SfM over an ordered image sequence ``1.jpg..N.jpg`` under
    ``img_path`` (the reference CLI contract, Runner.py:134-141, 340-346).

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU. RANSAC draws come from a
    ``torch.Generator`` on that device seeded with ``config.seed``, so a run
    differs from the JAX engine's as one RANSAC seed differs from another.
    """

    # Window pairs (pair_window > 1) need the host chain's window linking;
    # the global engine, which has no chain, takes them.
    _window_pairs_ported = False

    def __init__(
        self,
        img_path: str,
        max_img: int,
        config: Optional[PipelineConfig] = None,
        single_K: Optional[np.ndarray] = None,
        camera_sensor: Optional[SensorType] = None,
        model_name: Optional[str] = None,
        output_dir: str = "output",
        assoc_mode: str = "index",
        on_pose_failure: str = "raise",
        checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        mesh=None,
        chain_mode: str = "auto",
        pair_window: int = 1,
        local_ba_every: Optional[int] = None,
        local_ba_window: int = 5,
        feature_extractor=None,
        pair_cache_dir: Optional[str] = None,
        refine_focal: bool = False,
        chain_refresh: Optional[str] = None,
        auto_run: bool = True,
        device=None,
    ):
        off_path = {
            "assoc_mode": assoc_mode != "index",
            "on_pose_failure": on_pose_failure != "raise",
            "checkpoint_every": checkpoint_every is not None or checkpoint_path is not None,
            "mesh": mesh is not None,
            "chain_mode": chain_mode == "host",
            "pair_window": int(pair_window) != 1 and not self._window_pairs_ported,
            "local_ba_every": local_ba_every is not None,
            "feature_extractor": feature_extractor is not None,
            "pair_cache_dir": bool(pair_cache_dir),
            "refine_focal": bool(refine_focal),
        }
        for name, set_ in off_path.items():
            if set_:
                raise NotImplementedError(
                    f"{type(self).__name__} option {name!r} is off the ported paths")
        if chain_mode not in ("auto", "scan"):
            raise ValueError(f"chain_mode must be 'auto', 'scan' or 'host', got {chain_mode!r}")
        if chain_refresh not in (None, "averaging"):
            raise ValueError(f"chain_refresh must be None or 'averaging', got {chain_refresh!r}")
        if max_img < 3:
            raise NotImplementedError(
                "the port's engine needs 3 images or more; reconstruct_two_view covers 2")
        self.img_path = img_path
        self.max_img = max_img
        self.config = config or PipelineConfig()
        self._check_config()
        self.pair_window = max(1, int(pair_window))
        self.chain_refresh = chain_refresh
        self.single_K = single_K
        self.camera_sensor = camera_sensor
        self.model_name = model_name
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self.warnings: List[str] = []

        self.map = MapStore()
        self.global_poses: List[Tuple[np.ndarray, np.ndarray]] = []  # (rvec, t) per BA camera
        self.global_K: List[np.ndarray] = []
        self.pair_geometry: Dict[Tuple[int, int], PairGeometry] = {}
        self.errors_before_after_ba: Tuple[float, float] = (np.nan, np.nan)
        self.stage_times: Dict[str, float] = {}
        # The padded problem and the result of the last bundle adjustment.
        self.ba_problem = None
        self.ba_result = None
        self.filter_hyps_used = None   # (N-2,) hypotheses per filtered pair

        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.config.seed)
        self._num_hyp = self.config.ransac.num_iterations()
        self._pnp_hyp = self.config.ransac.pnp_num_iterations()

        if auto_run:
            self.run()

    def _check_config(self) -> None:
        if self.config.ransac.pnp_solver != "p3p":
            raise NotImplementedError("only the P3P PnP solver is ported")
        if not self.config.ransac.adaptive:
            raise NotImplementedError("only the adaptive RANSAC stages are ported")

    # ------------------------------------------------------------------ utils

    def _image_file(self, idx: int) -> str:
        return os.path.join(self.img_path, f"{idx}.jpg")

    def _intrinsics(self, idx: int) -> np.ndarray:
        if self.single_K is not None:
            return np.asarray(self.single_K, dtype=np.float64)
        K = intrinsics_from_exif(self._image_file(idx), self.camera_sensor)
        # Features live on images prescaled by scale_factor, so K is too.
        s = self.config.scale_factor
        return np.diag([s, s, 1.0]) @ K

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage_end(self, name: str, t0: float) -> float:
        """Close stage ``name`` at a device synchronize (its time adds to an
        earlier one of the same name); returns the time."""
        self._sync()
        t = time.perf_counter()
        self.stage_times[name] = self.stage_times.get(name, 0.0) + t - t0
        return t

    # ------------------------------------------------------------------ stages

    def _extract_all_features(self) -> Features:
        """Features of every image, extracted once, with a leading image axis:
        the decodes go up as one uint8 stack and run as one batch."""
        t0 = time.perf_counter()
        raws = [load_image_u8(self._image_file(i)) for i in range(1, self.max_img + 1)]
        if len({r.shape for r in raws}) != 1:
            raise NotImplementedError("the port's engine takes images of one size and mode")
        stacked = preprocess_image_batch(
            torch.as_tensor(np.stack(raws), device=self.device), self.config.scale_factor)
        feats = extract_features_batch(stacked, self.config.extractor)
        self._stage_end("features", t0)
        return feats

    def _run_front(self, feats: Features) -> None:
        """Matching, pair filter, bootstrap and the PnP chain on the device,
        then one fetch into the host map (``_front_full_device`` and
        ``_front_finish``, ``incremental.py:290-352, 1058-1119``)."""
        dev = self.device
        rcfg = self.config.ransac
        mcfg = self.config.matcher
        gen = self._generator
        N = self.max_img
        t0 = time.perf_counter()

        ar = torch.arange(N - 1, device=dev)
        res, p1, p2 = match_pairs_batch(
            feats.descriptors, feats.keypoints.mask, feats.keypoints.xf, feats.keypoints.yf,
            ar, ar + 1, ratio_threshold=mcfg.ratio_threshold, max_matches=mcfg.max_matches,
        )
        t0 = self._stage_end("matching", t0)

        # Every pair but (1, 2) is F-filtered; the bootstrap takes (1, 2)'s
        # raw ratio-test mask (incremental.py:799-802).
        hyp = rcfg.max_hypotheses()
        fres = ransac_fundamental_adaptive_batch(
            gen, p1[1:], p2[1:], res.mask[1:], max_hypotheses=hyp, stage_size=rcfg.stage_size,
            threshold=rcfg.epipolar_threshold, confidence=rcfg.prob_success,
        )
        self.filter_hyps_used = fres.hyps_used.cpu().numpy()
        filt = torch.cat([res.mask[:1], fres.inliers])
        t0 = self._stage_end("filter", t0)

        K_host = [self._intrinsics(i) for i in range(1, N + 1)]
        Kt = torch.as_tensor(np.stack(K_host), dtype=torch.float32, device=dev)
        inl, X, rvec0, tvec0, P2_0 = bootstrap(
            gen, p1[0], p2[0], Kt[0], Kt[1], res.mask[0], hyp, rcfg.epipolar_threshold,
            stage_size=rcfg.stage_size,
        )
        # Device twin of MapStore.add_tracks and of image 2's keypoint table.
        kp_capacity = int(feats.keypoints.capacity)
        max_points = self.config.max_points
        tid = torch.cumsum(inl.to(torch.int64), 0) - 1
        in_cap = inl & (tid < max_points)
        points0 = X.new_zeros((max_points + 1, 3)).index_put(
            (torch.where(in_cap, tid, max_points),), X)[:max_points]
        n0 = torch.clamp_max(torch.sum(inl), max_points)
        idx2_0 = res.indices[0, :, 1].long()
        kp_tracks0 = scatter_last(
            torch.full((kp_capacity,), -1, dtype=torch.int64, device=dev),
            torch.where(in_cap, idx2_0, kp_capacity), tid)
        t0 = self._stage_end("bootstrap", t0)

        chain = chain_scan(
            gen, p1[1:], p2[1:], res.indices[1:, :, 0], res.indices[1:, :, 1], filt[1:],
            Kt[2:], kp_tracks0, points0, n0, P2_0, self._pnp_hyp, rcfg.pnp_reproj_threshold,
        )
        t0 = self._stage_end("chain", t0)

        # One fetch of everything the host map needs.
        rvecs, ts, oks, _ninl, obs_track, obs_xy, points, n_points = chain
        n_live = int(n_points)
        host = [v.cpu().numpy() for v in (
            res.indices, res.mask, p1, p2, filt, inl, X, rvec0, tvec0,
            rvecs, ts, oks, obs_track, obs_xy, points[:n_live])]
        self._front_finish(K_host, *host)
        self._stage_end("fetch", t0)

    def _front_finish(self, K_host, idx_np, raw_np, p1_np, p2_np, filt_np, inl_np, X_np,
                      rvec0, tvec0, rvecs, ts, oks, obs_track, obs_xy, points) -> None:
        """Host bookkeeping: pair geometry, the bootstrap's tracks and pose,
        and the chain's tracks, observations and poses."""
        for e in range(self.max_img - 1):
            i1, i2 = e + 1, e + 2
            mask = raw_np[e] if e == 0 else filt_np[e]
            K1 = np.asarray(K_host[i1 - 1], np.float32)
            K2 = np.asarray(K_host[i2 - 1], np.float32)
            idx1 = idx_np[e, :, 0].astype(np.int32)
            idx2 = idx_np[e, :, 1].astype(np.int32)
            self.pair_geometry[(i1, i2)] = PairGeometry(
                p1=p1_np[e], p2=p2_np[e], idx1=idx1, idx2=idx2, mask=mask, K1=K1, K2=K2)
            self.pair_geometry[(i2, i1)] = PairGeometry(
                p1=p2_np[e], p2=p1_np[e], idx1=idx2, idx2=idx1, mask=mask, K1=K2, K2=K1)

        self.map.add_tracks(np.asarray(X_np, np.float64), np.asarray(p2_np[0], np.float64),
                            frame_idx=0, mask=inl_np)
        self.global_poses.append((np.asarray(rvec0, np.float64), np.asarray(tvec0, np.float64)))
        self.global_K.append(np.asarray(K_host[1], np.float64))
        n0 = self.map.num_tracks

        bad = np.nonzero(~np.asarray(oks, bool))[0]
        if len(bad):
            raise RuntimeError(
                f"Cannot determine pose for pair ({int(bad[0]) + 2}, {int(bad[0]) + 3})")
        self.map.append_points_raw(points[n0:])
        for f in range(len(oks)):
            self.map.add_observations(obs_track[f], obs_xy[f], len(self.global_poses))
            self.global_poses.append((np.asarray(rvecs[f], np.float64), np.asarray(ts[f], np.float64)))
            self.global_K.append(np.asarray(K_host[f + 2], np.float64))

    def _candidate_pairs(self, feats: Features) -> List[Tuple[int, int]]:
        """Image pairs to match: the sequential window of ``pair_window``
        (``incremental.py:640-648``)."""
        return [
            (i1, i2)
            for i1 in range(1, self.max_img)
            for i2 in range(i1 + 1, min(i1 + self.pair_window, self.max_img) + 1)
        ]

    def _match_pairs(self, feats: Features) -> None:
        """Matching and F-RANSAC filtering of every candidate pair
        (``incremental.py:666-840`` without the pair cache and the shards):
        one matcher launch for all pairs, the batched adaptive F-RANSAC
        filter on the device, one fetch, then ``pair_geometry`` of numpy
        arrays in both directions, each pair's mask the filter's
        (``global_sfm.py:107-115``)."""
        dev = self.device
        rcfg = self.config.ransac
        mcfg = self.config.matcher
        t0 = time.perf_counter()
        pairs = self._candidate_pairs(feats)
        pi = torch.tensor([k[0] - 1 for k in pairs], device=dev)
        pj = torch.tensor([k[1] - 1 for k in pairs], device=dev)
        res, p1, p2 = match_pairs_batch(
            feats.descriptors, feats.keypoints.mask, feats.keypoints.xf, feats.keypoints.yf,
            pi, pj, ratio_threshold=mcfg.ratio_threshold, max_matches=mcfg.max_matches,
        )
        t0 = self._stage_end("matching", t0)
        fres = ransac_fundamental_adaptive_batch(
            self._generator, p1, p2, res.mask, max_hypotheses=rcfg.max_hypotheses(),
            stage_size=rcfg.stage_size, threshold=rcfg.epipolar_threshold,
            confidence=rcfg.prob_success,
        )
        self.filter_hyps_used = fres.hyps_used.cpu().numpy()
        idx_np, p1_np, p2_np, filt_np = (
            v.cpu().numpy() for v in (res.indices, p1, p2, fres.inliers))
        for row, (i1, i2) in enumerate(pairs):
            mask = filt_np[row]   # the global engine filters every pair
            K1 = np.asarray(self._intrinsics(i1), np.float32)
            K2 = np.asarray(self._intrinsics(i2), np.float32)
            idx1 = idx_np[row, :, 0].astype(np.int32)
            idx2 = idx_np[row, :, 1].astype(np.int32)
            self.pair_geometry[(i1, i2)] = PairGeometry(
                p1=p1_np[row], p2=p2_np[row], idx1=idx1, idx2=idx2, mask=mask, K1=K1, K2=K2)
            self.pair_geometry[(i2, i1)] = PairGeometry(
                p1=p2_np[row], p2=p1_np[row], idx1=idx2, idx2=idx1, mask=mask, K1=K2, K2=K1)
        self._stage_end("filter", t0)

    def _global_ba(self, freeze_before: int = 0) -> None:
        """Bundle adjustment on the device over every camera and track
        (``incremental.py:1381-1469``), cameras [0, freeze_before) frozen, on
        the JAX package's padded problem so the same Schur backend is
        chosen. Its time adds to ``stage_times["ba"]``."""
        t0 = time.perf_counter()
        frames, tracks, xy = self.map.observations()
        cam_params = np.array([np.hstack([rv, t]) for rv, t in self.global_poses])
        num_cams = len(cam_params)
        num_pts = self.map.num_tracks
        problem = pad_problem(make_problem(
            cam_params, self.map.points(), frames, tracks, xy, np.stack(self.global_K),
            cam_fixed=np.arange(num_cams) < freeze_before, device=self.device,
        ))
        ba = self.config.ba
        res = bundle_adjust(
            problem, max_iters=ba.max_lm_iters, cg_iters=60, init_damping=ba.init_damping,
            damping_up=ba.damping_up, damping_down=ba.damping_down, ftol=ba.ftol,
            huber_delta=ba.huber_delta,
        )
        pts = res.points[:num_pts].cpu().numpy()
        cams = res.cam_params[:num_cams].cpu().numpy()
        self.errors_before_after_ba = (float(res.initial_mean_error), float(res.final_mean_error))
        self.map.update_points(np.asarray(pts, np.float64))
        self.global_poses = [(np.asarray(c[:3], np.float64), np.asarray(c[3:], np.float64))
                             for c in cams]
        self.ba_problem, self.ba_result = problem, res
        self._stage_end("ba", t0)

    # ------------------------------------------------------------------ driver

    def run(self) -> "SfmEngine":
        t0 = time.perf_counter()
        feats = self._extract_all_features()
        self._run_front(feats)
        if self.chain_refresh == "averaging":
            averaging_refresh(self)
        self._global_ba()
        self.stage_times["total"] = time.perf_counter() - t0
        if self.model_name is not None:
            self.save_data()
        return self

    # ------------------------------------------------------------------ persistence

    def save_data(self) -> str:
        """Persist the reconstruction in the JAX engine's npz layout
        (``incremental.py:1583-1600``): the reference's p3d / frame_idx /
        pt_idx plus observations, poses, K and the BA errors."""
        os.makedirs(self.output_dir, exist_ok=True)
        frames, tracks, xy = self.map.observations()
        path = os.path.join(self.output_dir, f"{self.model_name}.npz")
        np.savez(
            path,
            p3d=self.map.points(),
            frame_idx=frames,
            pt_idx=tracks,
            obs_xy=xy,
            poses=np.array([np.hstack([rv, t]) for rv, t in self.global_poses]),
            K=np.stack(self.global_K) if self.global_K else np.zeros((0, 3, 3)),
            errors_ba=np.array(self.errors_before_after_ba),
        )
        return path

    @staticmethod
    def load(model_name: str, output_dir: str = "output", show: bool = False):
        """Load a saved model as a dict of arrays. The 3-D viewer of the JAX
        engine (``show=True``) is not ported."""
        if show:
            raise NotImplementedError("the 3-D viewer is not ported; call load(show=False)")
        with np.load(os.path.join(output_dir, f"{model_name}.npz")) as npz:
            return dict(npz)
