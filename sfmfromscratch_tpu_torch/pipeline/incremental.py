"""Incremental Structure-from-Motion engine (counterpart of
``sfmfromscratch_tpu/pipeline/incremental.py``).

The default configuration runs the fused front, its stages back to back on
the device with their state there:

* features: every image decoded once, one batch for the whole sequence, so
  the Harris kernel runs once per pyramid level;
* matching: the N-1 consecutive pairs in one launch of the matcher kernel;
* filter: adaptive F-RANSAC on every pair but (1, 2) (fixed-count with
  ``RansacConfig(adaptive=False)``, as every RANSAC stage below);
* bootstrap: adaptive essential RANSAC on pair (1, 2) with its raw
  ratio-test mask, DLT, 8 Gauss-Newton steps;
* chain: P3P PnP RANSAC over frames 3..N with the keypoint->track table and
  the points buffer on the device (the JAX ``lax.scan`` becomes a loop over
  frames with no host read);
* one fetch of the front's results to the host map, then one global LM
  bundle adjustment.

Any other configuration takes the staged path (``incremental.py:1561-1569``):
``_match_pairs`` (window pairs, the pair cache, match-graph shards) fetches
the pair geometry, ``_bootstrap`` fills the host keypoint->track tables, and
the chain runs either as the device scan above or as the host chain
(``_chain``): one device step and one packed fetch per frame, with distance
association, window linking, pose recovery, local BA and checkpoints. With
a fresh generator the staged path draws the same uniforms in the same order
as the fused front.

With ``chain_refresh="averaging"`` the chain's poses are refreshed by motion
averaging over the map's own tracks (``pipeline/chain_refresh.py``) before
the BA. With ``refine_focal`` the final BA optimises one focal scale shared
by every camera (``ba/selfcal.py``) and rescales ``global_K``. A
``feature_extractor`` (``make_dog_extractor``, ``SuperPointExtractor``,
``make_hybrid_extractor`` or any callable of a grayscale image to
``Features``) replaces the built-in SIFT front end. The chain's PnP is P3P
whatever ``RansacConfig.pnp_solver`` says: the JAX engine passes no solver
to its PnP calls, so ``"dlt"`` only raises the hypothesis count to
``num_iterations()``.

With a ``mesh`` (a ``DeviceMesh`` of ``parallel/mesh.py``) every rank runs
the whole engine on the full host state, and the engine shards where the
JAX engine does, over the mesh's ``data`` axis: the feature batch by image
(each rank extracts its block of images and the Features are all-gathered)
and every bundle adjustment by observation (``parallel/sharded_ba.py``,
with the selfcal border in the final BA). Only the mesh's first rank writes
``save_data`` and checkpoints.

``_candidate_pairs``, ``_match_pairs`` and ``_global_ba(freeze_before=...)``
serve ``GlobalSfmEngine`` (``pipeline/global_sfm.py``), which inherits them.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
from sfmfromscratch_tpu_torch.ba.problem import make_problem, pad_problem
from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal
from sfmfromscratch_tpu_torch.config import PipelineConfig
from sfmfromscratch_tpu_torch.geometry.camera import SensorType, intrinsics_from_exif, projection_matrix
from sfmfromscratch_tpu_torch.geometry.pnp import pnp_ransac
from sfmfromscratch_tpu_torch.geometry.ransac import (  # noqa: F401  (ransac_fundamental: JAX's name)
    ransac_essential_pose,
    ransac_essential_pose_adaptive,
    ransac_fundamental,
    ransac_fundamental_adaptive_batch,
    ransac_fundamental_batch,
)
from sfmfromscratch_tpu_torch.geometry.triangulation import refine_points_gn, triangulate_dlt
from sfmfromscratch_tpu_torch.io import export
from sfmfromscratch_tpu_torch.io.images import load_image, load_image_u8
from sfmfromscratch_tpu_torch.ops.cuda import nullvec_kernel
from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_log
from sfmfromscratch_tpu_torch.ops.matcher import match_pairs_batch, match_ratio_test  # noqa: F401
from sfmfromscratch_tpu_torch.parallel.mesh import all_gather_cat, is_writer, mesh_axis
from sfmfromscratch_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded
from sfmfromscratch_tpu_torch.pipeline.chain_refresh import averaging_refresh
from sfmfromscratch_tpu_torch.pipeline.checkpoint import save_checkpoint
from sfmfromscratch_tpu_torch.pipeline.frontend import (
    extract_features,
    extract_features_batch,
    preprocess_image,
    preprocess_image_batch,
)
from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore
from sfmfromscratch_tpu_torch.types import Features, Keypoints, PairGeometry
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.utils.fetch import device_get_packed
from sfmfromscratch_tpu_torch.utils.precision import f32_precision
from sfmfromscratch_tpu_torch.utils.profiling import Span, StageTimer


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
    uniforms: Optional[torch.Tensor] = None, adaptive: bool = True,
):
    """Bootstrap of pair (1, 2) (``incremental.py:100-122``): adaptive
    essential RANSAC in stages of ``stage_size`` (``uniforms`` (stages, S, 8)
    replaces the draws), or with ``adaptive=False`` fixed-count essential
    RANSAC of ``max_hypotheses`` (``uniforms`` (max_hypotheses, 8)); then
    DLT and 8 Gauss-Newton steps on its inliers. Returns (inliers, X, rvec,
    t, P2)."""
    with f32_precision():
        if adaptive:
            pose = ransac_essential_pose_adaptive(
                generator, p1, p2, K1, K2, mask, max_hypotheses=max_hypotheses,
                stage_size=stage_size, threshold=threshold, min_cheirality_frac=0.75,
                uniforms=uniforms,
            )
        else:
            pose = ransac_essential_pose(
                generator, p1, p2, K1, K2, mask, num_hypotheses=max_hypotheses,
                threshold=threshold, min_cheirality_frac=0.75, uniforms=uniforms,
            )
        P1 = projection_matrix(torch.eye(3, device=p1.device), torch.zeros(3, device=p1.device), K1)
        P2 = projection_matrix(pose.R, pose.t, K2)
        X = triangulate_dlt(p1, p2, P1, P2)
        X = refine_points_gn(X, p1, p2, P1, P2, mask=pose.inliers, num_iters=8)
        return pose.inliers, X, so3_log(pose.R), pose.t, P2


def chain_step(
    generator: Optional[torch.Generator],
    X_known: torch.Tensor,     # (M, 3) the linked tracks' points
    sel: torch.Tensor,         # (M,) bool: the match is linked
    p1: torch.Tensor,          # (M, 2)
    p2: torch.Tensor,          # (M, 2)
    K2: torch.Tensor,          # (3, 3)
    P1: torch.Tensor,          # (3, 4) the previous frame's projection
    num_hypotheses: int,
    reproj_threshold: float,
    new_sel: torch.Tensor,     # (M,) bool: the matches to triangulate
    uniforms: Optional[torch.Tensor] = None,   # (num_hypotheses, 3)
):
    """One frame of the PnP chain (``_chain_step_device``,
    ``incremental.py:71-93``): PnP RANSAC on the linked matches, the
    frame's projection, DLT and 8 Gauss-Newton steps of the ``new_sel``
    matches against ``P1``, and their cheirality gate. ``uniforms``
    replaces the PnP draw from ``generator``. Returns (ok, inliers, rvec, t,
    P2, X_new, ok_new)."""
    with f32_precision():
        pose = pnp_ransac(generator, X_known, p2, K2, mask=sel, num_hypotheses=num_hypotheses,
                          reproj_threshold=reproj_threshold, uniforms=uniforms)
        P2 = projection_matrix(pose.R, pose.t, K2)
        X_new = triangulate_dlt(p1, p2, P1, P2)
        X_new = refine_points_gn(X_new, p1, p2, P1, P2, mask=new_sel, num_iters=8)
        Xh = torch.cat([X_new, torch.ones_like(X_new[:, :1])], dim=1)
        z1 = (Xh @ P1.T)[:, 2]
        z2 = (Xh @ P2.T)[:, 2]
        ok_new = new_sel & (z1 > 1e-6) & (z2 > 1e-6)
        return pose.ok, pose.inliers, so3_log(pose.R), pose.t, P2, X_new, ok_new


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

    Per frame: link matches whose left keypoint carries a track, then
    ``chain_step`` (PnP on those 2D-3D pairs, triangulation of the unlinked
    matches); keep the triangulated points in front of both cameras as new
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
    for f in range(F):
        p1, p2, mask = p1_all[f], p2_all[f], mask_all[f]
        idx1 = idx1_all[f].long().clamp(0, kp_capacity - 1)
        idx2 = idx2_all[f].long()
        linked = torch.where(mask, kp_tracks[idx1], -1)
        sel = linked >= 0
        X_known = points[linked.clamp(0, max_points - 1)]
        ok, inliers, rvec, t, P2, X_new, ok_new = chain_step(
            None, X_known, sel, p1, p2, K2_all[f], P_prev, num_hypotheses, reproj_threshold,
            mask & ~sel, uniforms=uniforms[f])
        pnp_inl = inliers & sel

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
        outs.append((rvec, t, ok, torch.sum(inliers), obs_track, torch.cat([p2, p2])))
        P_prev = P2
    rvecs, ts, oks, ninl, obs_track, obs_xy = (torch.stack(v) for v in zip(*outs))
    return rvecs, ts, oks, ninl, obs_track, obs_xy, points[:max_points], n_points


def _stack_features(per: List[Features]) -> Features:
    """Fixed-capacity Features of single images stacked on a leading image
    axis."""
    return Features(
        keypoints=Keypoints(*(torch.stack(v) for v in zip(*(f.keypoints for f in per)))),
        descriptors=torch.stack([f.descriptors for f in per]))


class SfmEngine:
    """Incremental SfM over an ordered image sequence ``1.jpg..N.jpg`` under
    ``img_path`` (the reference CLI contract, Runner.py:134-141, 340-346).

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU. RANSAC draws come from a
    ``torch.Generator`` on that device seeded with ``config.seed``, so a run
    differs from the JAX engine's as one RANSAC seed differs from another.
    The other options are the JAX engine's, with its names, defaults and
    meaning.
    """

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
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh).__name__}")
        choices = {"assoc_mode": (assoc_mode, ("index", "distance")),
                   "on_pose_failure": (on_pose_failure, ("raise", "recover")),
                   "chain_mode": (chain_mode, ("auto", "host", "scan")),
                   "chain_refresh": (chain_refresh, (None, "averaging"))}
        for name, (value, allowed) in choices.items():
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        self.img_path = img_path
        self.max_img = max_img
        self.config = config or PipelineConfig()
        self.single_K = single_K
        self.camera_sensor = camera_sensor
        self.model_name = model_name
        self.output_dir = output_dir
        self.assoc_mode = assoc_mode
        self.on_pose_failure = on_pose_failure
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self.chain_mode = chain_mode
        # A DeviceMesh: every rank runs the engine (SPMD); features shard by
        # image and BA by observation over its "data" axis.
        self.mesh = mesh
        # pair_window=1 is the reference's consecutive-only match graph; w>1
        # also matches (i, i+2..i+w) and links those observations into
        # existing tracks.
        self.pair_window = max(1, int(pair_window))
        # Every local_ba_every cameras, re-optimise the last local_ba_window
        # cameras and every point, earlier cameras frozen.
        self.local_ba_every = local_ba_every
        self.local_ba_window = local_ba_window
        self.chain_refresh = chain_refresh
        # Called once per image on its preprocessed grayscale; None runs the
        # built-in SIFT front end.
        self.feature_extractor = feature_extractor
        # Focal self-calibration: the final BA optimises one focal scale
        # shared by every camera (ba/selfcal.py); focal_scale accumulates it.
        self.refine_focal = bool(refine_focal)
        self.focal_scale: float = 1.0
        # Each matched pair persists here; a later run resumes the pairs
        # written under the same configuration (one file per pair).
        self.pair_cache_dir = pair_cache_dir
        self.device = resolve_device(device)
        # (shard, num_shards): this process matches every num_shards-th pair
        # (match_graph_shard).
        self._pair_shard: Optional[Tuple[int, int]] = None
        self._track_seen_frame = np.full(0, -1, dtype=np.int64)
        self.warnings: List[str] = []

        self.map = MapStore()
        self.global_poses: List[Tuple[np.ndarray, np.ndarray]] = []  # (rvec, t) per BA camera
        self.global_K: List[np.ndarray] = []
        self.pair_geometry: Dict[Tuple[int, int], PairGeometry] = {}
        # Track id per keypoint slot, per image (index association).
        self._kp_tracks: Dict[int, np.ndarray] = {}
        self.errors_before_after_ba: Tuple[float, float] = (np.nan, np.nan)
        self._timer = StageTimer()
        # The padded problem and the result of the last bundle adjustment.
        self.ba_problem = None
        self.ba_result = None
        self.filter_hyps_used = None   # hypotheses per filtered pair

        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.config.seed)
        self._num_hyp = self.config.ransac.num_iterations()
        self._pnp_hyp = self.config.ransac.pnp_num_iterations()

        if auto_run:
            self.run()

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

    def _dev(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    @property
    def stage_times(self) -> Dict[str, float]:
        """Seconds by stage name: the durations of the run's spans summed by
        name (the root span ``run`` as ``"total"``; the child spans
        ``decode``, ``filter.ransac``, ``relpose_ransac``, ``relpose_refine``,
        ``register.match``, ``register.link``, ``register.pnp`` and
        ``chain_refresh.scales`` are left out)."""
        return self._timer.times

    @stage_times.setter
    def stage_times(self, times: Dict[str, float]) -> None:
        # A fresh recorder holding ``times`` (for engines built without
        # __init__).
        self._timer = StageTimer()
        self._timer.times.update(times)

    @property
    def spans(self) -> List[Span]:
        """The last run's spans (``utils/profiling.Span``), in the order they
        opened: name, parent, run id, start and end on the profiler's clock,
        counters."""
        return self._timer.spans

    def _stage(self, name: str) -> Span:
        """Open stage ``name`` inside the innermost open one."""
        return self._timer.open(name)

    def _stage_end(self, span: Span, then: Optional[str] = None,
                   time_as: Optional[str] = "") -> Optional[Span]:
        """Close ``span`` at a device synchronize (its time adds to
        ``stage_times`` under its name, or under ``time_as``; None keeps it
        out), then open stage ``then`` if one is given."""
        self._timer.close(span, self.device, time_as)
        return self._stage(then) if then else None

    def _decode(self, load, files: List[str]) -> list:
        """``load`` of every file, in the host span ``decode``."""
        span = self._timer.open("decode")
        out = [load(f) for f in files]
        self._timer.close(span, time_as=None)
        return out

    # ------------------------------------------------------------------ stages

    def _extract_all_features(self) -> Features:
        """Features of every image, extracted once, with a leading image axis
        (``incremental.py:488-632``). The built-in front end runs images of
        one size as one batch, so the Harris kernel runs once per pyramid
        level: the decodes go up as one uint8 stack, or, where the files
        differ in mode (RGB and grayscale), each is preprocessed from float
        on its own and the grays are stacked; preprocessing and extraction
        stay separate steps, as in the JAX engine, whose fusion boundary
        moves SIFT orientation ties. Images of different sizes (or a single
        image) are extracted one by one and their fixed-capacity Features
        stacked. A ``feature_extractor`` is called once per image on its
        float grayscale (``incremental.py:518-522``). On a mesh with a
        ``data`` axis the batch shards by image (``incremental.py:543-595``):
        padded with copies of the first image to a multiple of the axis,
        each rank extracts its contiguous block and the Features are
        all-gathered."""
        span = self._stage("features")
        scale, dev = self.config.scale_factor, self.device
        files = [self._image_file(i) for i in range(1, self.max_img + 1)]
        if self.feature_extractor is not None:
            feats = _stack_features([
                self.feature_extractor(preprocess_image(img, scale, dev))
                for img in self._decode(load_image, files)])
        else:
            raws = self._decode(load_image_u8, files)
            if len({r.shape[:2] for r in raws}) == 1 and self.max_img > 1:
                ax = mesh_axis(self.mesh, "data")
                rank, size = (ax.rank, ax.size) if ax is not None else (0, 1)
                per = -(-len(raws) // size)
                block = [raws[i if i < len(raws) else 0] for i in range(rank * per, (rank + 1) * per)]
                if len({r.shape for r in raws}) == 1:
                    stacked = preprocess_image_batch(torch.as_tensor(np.stack(block), device=dev),
                                                     scale)
                else:
                    stacked = torch.stack([
                        preprocess_image(r.astype(np.float32) / 255.0, scale, dev) for r in block])
                feats = extract_features_batch(stacked, self.config.extractor)
                if ax is not None:
                    gather = lambda t: all_gather_cat(t, ax)[:self.max_img]
                    feats = Features(keypoints=Keypoints(*(gather(t) for t in feats.keypoints)),
                                     descriptors=gather(feats.descriptors))
            else:
                feats = _stack_features([
                    extract_features(preprocess_image(r.astype(np.float32) / 255.0, scale, dev),
                                     self.config.extractor)
                    for r in raws])
        cap = feats.keypoints.capacity
        self._kp_tracks = {i: np.full(cap, -1, dtype=np.int64) for i in range(1, self.max_img + 1)}
        self._stage_end(span)
        return feats

    def _use_scan_chain(self) -> bool:
        """The device scan covers the chain unless an option needs the host
        loop (``incremental.py:1471-1485``)."""
        if self.chain_mode != "auto":
            return self.chain_mode == "scan"
        return (self.assoc_mode == "index" and self.pair_window == 1
                and self.local_ba_every is None and self.checkpoint_every is None
                and self.on_pose_failure == "raise")

    def _fused_front_eligible(self, feats: Features) -> bool:
        """The fused front covers the scan chain over three images or more,
        consecutive pairs, no shard and no pair cache
        (``incremental.py:859-867``)."""
        return (self._pair_shard is None and not self.pair_cache_dir
                and self._use_scan_chain() and self.max_img >= 3
                and self._candidate_pairs(feats) == [(i, i + 1) for i in range(1, self.max_img)])

    def _run_front(self, feats: Features) -> None:
        """Matching, pair filter, bootstrap and the PnP chain on the device,
        then one fetch into the host map (``_front_full_device`` and
        ``_front_finish``, ``incremental.py:290-352, 1058-1119``)."""
        dev = self.device
        rcfg = self.config.ransac
        mcfg = self.config.matcher
        gen = self._generator
        N = self.max_img
        span = self._stage("matching")

        ar = torch.arange(N - 1, device=dev)
        res, p1, p2 = match_pairs_batch(
            feats.descriptors, feats.keypoints.mask, feats.keypoints.xf, feats.keypoints.yf,
            ar, ar + 1, ratio_threshold=mcfg.ratio_threshold, max_matches=mcfg.max_matches,
        )
        span = self._stage_end(span, then="filter")

        # Every pair but (1, 2) is F-filtered; the bootstrap takes (1, 2)'s
        # raw ratio-test mask (incremental.py:799-802).
        hyp = rcfg.max_hypotheses() if rcfg.adaptive else self._num_hyp
        filt_rows = self._filter(p1[1:], p2[1:], res.mask[1:])
        filt = torch.cat([res.mask[:1], filt_rows])
        span = self._stage_end(span, then="bootstrap")

        K_host = [self._intrinsics(i) for i in range(1, N + 1)]
        Kt = torch.as_tensor(np.stack(K_host), dtype=torch.float32, device=dev)
        inl, X, rvec0, tvec0, P2_0 = bootstrap(
            gen, p1[0], p2[0], Kt[0], Kt[1], res.mask[0], hyp, rcfg.epipolar_threshold,
            stage_size=rcfg.stage_size, adaptive=rcfg.adaptive,
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
        span = self._stage_end(span, then="chain")

        chain = chain_scan(
            gen, p1[1:], p2[1:], res.indices[1:, :, 0], res.indices[1:, :, 1], filt[1:],
            Kt[2:], kp_tracks0, points0, n0, P2_0, self._pnp_hyp, rcfg.pnp_reproj_threshold,
        )
        span = self._stage_end(span, then="fetch")

        # One fetch of everything the host map needs.
        rvecs, ts, oks, _ninl, obs_track, obs_xy, points, n_points = chain
        n_live = int(n_points)
        (idx_np, raw_np, p1_np, p2_np, filt_np, inl_np, X_np, rvec0_np, tvec0_np, rvecs_np, ts_np,
         oks_np, obs_track_np, obs_xy_np, points_np) = [v.cpu().numpy() for v in (
            res.indices, res.mask, p1, p2, filt, inl, X, rvec0, tvec0,
            rvecs, ts, oks, obs_track, obs_xy, points[:n_live])]
        for e in range(N - 1):
            self._set_pair(e + 1, e + 2, p1_np[e], p2_np[e], idx_np[e, :, 0], idx_np[e, :, 1],
                           filt_np[e], K_host[e], K_host[e + 1])
        self.map.add_tracks(np.asarray(X_np, np.float64), np.asarray(p2_np[0], np.float64),
                            frame_idx=0, mask=inl_np)
        self.global_poses.append((np.asarray(rvec0_np, np.float64), np.asarray(tvec0_np, np.float64)))
        self.global_K.append(np.asarray(K_host[1], np.float64))
        self._finish_chain(rvecs_np, ts_np, oks_np, obs_track_np, obs_xy_np, points_np, K_host[2:])
        self._stage_end(span)

    def _filter(self, p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Epipolar inlier masks of P matched pairs (the JAX engine's filter
        branches, ``incremental.py:318-327, 706-722``): adaptive F-RANSAC in
        stages up to ``max_hypotheses()``, or with ``adaptive=False``
        fixed-count F-RANSAC of ``num_iterations()``. Records the hypotheses
        each pair used in ``filter_hyps_used`` and their sum as the counter
        ``hyps`` of the span ``filter.ransac``, which ends at the adaptive
        filter's fetch of those counts; its counter ``nullvec_launches`` is
        the null-vector kernel's launches inside it (its host-side count)."""
        rcfg = self.config.ransac
        span = self._timer.open("filter.ransac")
        launches0 = nullvec_kernel.launches
        if rcfg.adaptive:
            fres = ransac_fundamental_adaptive_batch(
                self._generator, p1, p2, mask, max_hypotheses=rcfg.max_hypotheses(),
                stage_size=rcfg.stage_size, threshold=rcfg.epipolar_threshold,
                confidence=rcfg.prob_success,
            )
            self.filter_hyps_used = fres.hyps_used.cpu().numpy()
        else:
            fres = ransac_fundamental_batch(self._generator, p1, p2, mask,
                                            num_hypotheses=self._num_hyp,
                                            threshold=rcfg.epipolar_threshold)
            self.filter_hyps_used = np.full(p1.shape[0], self._num_hyp)
        span.counters["hyps"] = int(self.filter_hyps_used.sum())
        span.counters["nullvec_launches"] = nullvec_kernel.launches - launches0
        self._timer.close(span, time_as=None)
        return fres.inliers

    def _set_pair(self, i1: int, i2: int, p1, p2, idx1, idx2, mask, K1, K2) -> None:
        """``pair_geometry`` of numpy arrays, both directions."""
        p1, p2 = np.asarray(p1, np.float32), np.asarray(p2, np.float32)
        idx1, idx2 = np.asarray(idx1, np.int32), np.asarray(idx2, np.int32)
        mask = np.asarray(mask, bool)
        K1, K2 = np.asarray(K1, np.float32), np.asarray(K2, np.float32)
        self.pair_geometry[(i1, i2)] = PairGeometry(
            p1=p1, p2=p2, idx1=idx1, idx2=idx2, mask=mask, K1=K1, K2=K2)
        self.pair_geometry[(i2, i1)] = PairGeometry(
            p1=p2, p2=p1, idx1=idx2, idx2=idx1, mask=mask, K1=K2, K2=K1)

    def _finish_chain(self, rvecs, ts, oks, obs_track, obs_xy, points, K2s) -> None:
        """Host map of a device chain: its new tracks (``points``, every live
        track after the bootstrap's), per frame the observation records, the
        pose and K (``incremental.py:1101-1119, 1538-1556``)."""
        bad = np.nonzero(~np.asarray(oks, bool))[0]
        if len(bad):
            raise RuntimeError(
                f"Cannot determine pose for pair ({int(bad[0]) + 2}, {int(bad[0]) + 3})")
        self.map.append_points_raw(points[self.map.num_tracks:])
        for f in range(len(oks)):
            self.map.add_observations(obs_track[f], obs_xy[f], len(self.global_poses))
            self.global_poses.append((np.asarray(rvecs[f], np.float64), np.asarray(ts[f], np.float64)))
            self.global_K.append(np.asarray(K2s[f], np.float64))

    def _candidate_pairs(self, feats: Features) -> List[Tuple[int, int]]:
        """Image pairs to match: the sequential window of ``pair_window``
        (``incremental.py:640-648``)."""
        return [
            (i1, i2)
            for i1 in range(1, self.max_img)
            for i2 in range(i1 + 1, min(i1 + self.pair_window, self.max_img) + 1)
        ]

    def _prepare_pair_selection(self, feats: Features) -> None:
        """Hook before pair selection, run by ``run()`` and by
        ``match_graph_shard()`` alike (``incremental.py:634-638``)."""

    def _pair_cache_tag(self) -> str:
        """Fingerprint of everything that determines a pair's staged
        geometry (``incremental.py:650-661``); the port's configs have the
        JAX configs' ``repr``, so each package reads the other's cache."""
        c = self.config
        sig = repr((
            c.extractor, c.matcher, c.ransac, c.scale_factor, c.seed,
            bool(getattr(self, "_filter_all_pairs", False)),
            bool(getattr(self, "_filter_pairs", True)),
        ))
        return hashlib.sha1(sig.encode()).hexdigest()[:16]

    def _pair_cache_file(self, i1: int, i2: int) -> str:
        return os.path.join(self.pair_cache_dir, f"pair_{i1}_{i2}.npz")

    def _load_cached_pairs(self, pairs, tag: str) -> Dict[Tuple[int, int], dict]:
        """The pairs the cache holds under ``tag``; an unreadable or partial
        file counts as missing."""
        cached = {}
        for k in pairs:
            f = self._pair_cache_file(*k)
            if not os.path.exists(f):
                continue
            try:
                with np.load(f) as z:
                    if str(z["tag"]) == tag:
                        cached[k] = {n: z[n] for n in ("p1", "p2", "idx1", "idx2", "mask")}
            except (OSError, ValueError, KeyError, EOFError):
                pass
        return cached

    def _match_pair_list(self, feats: Features, pairs):
        """Ratio-test matches of ``pairs`` (1-based image ids) in one matcher
        launch; returns ``(MatchResult, p1, p2)`` on the device. The JAX
        engines split this into memory-budgeted chunks of pairs; the card
        takes every pair at once."""
        mcfg = self.config.matcher
        pi = torch.tensor([p[0] - 1 for p in pairs], device=self.device)
        pj = torch.tensor([p[1] - 1 for p in pairs], device=self.device)
        return match_pairs_batch(
            feats.descriptors, feats.keypoints.mask, feats.keypoints.xf, feats.keypoints.yf,
            pi, pj, ratio_threshold=mcfg.ratio_threshold, max_matches=mcfg.max_matches)

    def _match_pairs(self, feats: Features) -> None:
        """Matching and F-RANSAC filtering of the candidate pairs
        (``incremental.py:727-840``): this shard's pairs, less those the pair
        cache resumes, in one matcher launch, then the batched F-RANSAC
        filter (``_filter``) on every pair but (1, 2) (every pair when the class
        sets ``_filter_all_pairs``), one fetch, ``pair_geometry`` of numpy
        arrays in both directions, and one atomic write per computed pair.
        A resumed run draws fewer uniforms, so it is deterministic given its
        restart point but differs from an uninterrupted one."""
        dev = self.device
        span = self._stage("matching")
        filter_all = bool(getattr(self, "_filter_all_pairs", False))
        pairs = self._candidate_pairs(feats)
        if self._pair_shard is not None:
            s, n = self._pair_shard
            pairs = [k for e, k in enumerate(sorted(pairs)) if e % n == s]
        cached: Dict[Tuple[int, int], dict] = {}
        if self.pair_cache_dir:
            os.makedirs(self.pair_cache_dir, exist_ok=True)
            tag = self._pair_cache_tag()
            cached = self._load_cached_pairs(pairs, tag)
            if cached:
                self.warnings.append(f"pair cache: resumed {len(cached)}/{len(pairs)} pairs")
        todo = [k for k in pairs if k not in cached]
        self._last_match_computed = len(todo)
        if not todo:
            span.name = "filter"   # nothing to match: the whole stage is the filter's

        results = {}
        if todo:
            res, p1, p2 = self._match_pair_list(feats, todo)
            span = self._stage_end(span, then="filter")
            rows = [r for r, k in enumerate(todo) if filter_all or k != (1, 2)]
            filt = res.mask
            if rows:
                ri = torch.tensor(rows, device=dev)
                filt = res.mask.index_put((ri,), self._filter(p1[ri], p2[ri], res.mask[ri]))
            idx_np, p1_np, p2_np, filt_np = (
                v.cpu().numpy() for v in (res.indices, p1, p2, filt))
            for row, k in enumerate(todo):
                results[k] = dict(p1=p1_np[row], p2=p2_np[row], idx1=idx_np[row, :, 0],
                                  idx2=idx_np[row, :, 1], mask=filt_np[row])
        for k in pairs:
            z = cached[k] if k in cached else results[k]
            self._set_pair(*k, z["p1"], z["p2"], z["idx1"], z["idx2"], z["mask"],
                           self._intrinsics(k[0]), self._intrinsics(k[1]))
        if self.pair_cache_dir:
            # One atomic rename per pair: a run killed mid-write leaves no
            # truncated entry for the next resume.
            for k in results:
                pg = self.pair_geometry[k]
                f = self._pair_cache_file(*k)
                # savez keeps a name that ends in .npz; the pid keeps ranks
                # that share the cache from writing one temporary file.
                tmp = f"{f}.{os.getpid()}.tmp.npz"
                np.savez(tmp, tag=tag, p1=pg.p1, p2=pg.p2, idx1=pg.idx1, idx2=pg.idx2, mask=pg.mask)
                os.replace(tmp, f)
        self._stage_end(span)

    def _bootstrap(self):
        """Pair (1, 2): pose and triangulation (``incremental.py:1121-1153``)
        with one fetch; the bootstrap's tracks go into the map and image 2's
        keypoint table. Returns the inlier points, their image-2 pixels and
        track ids, and the second camera's projection (on the device)."""
        span = self._stage("bootstrap")
        pg = self.pair_geometry[(1, 2)]
        rcfg = self.config.ransac
        inl, X, rvec, t, P2 = bootstrap(
            self._generator, self._dev(pg.p1), self._dev(pg.p2), self._dev(pg.K1),
            self._dev(pg.K2), self._dev(pg.mask, torch.bool),
            rcfg.max_hypotheses() if rcfg.adaptive else self._num_hyp,
            rcfg.epipolar_threshold, stage_size=rcfg.stage_size, adaptive=rcfg.adaptive,
        )
        inl_np, X_np, rvec_np, t_np = device_get_packed(inl, X, rvec, t)
        X_np = X_np.astype(np.float64)
        p2_np = np.asarray(pg.p2, np.float64)
        # Camera 0 of the BA problem observes through image 2 (the identity
        # base camera never enters BA).
        track_ids = self.map.add_tracks(X_np, p2_np, frame_idx=0, mask=inl_np)
        self._kp_tracks[2][pg.idx2[inl_np]] = track_ids[inl_np]
        self.global_poses.append((rvec_np.astype(np.float64), t_np.astype(np.float64)))
        self.global_K.append(np.asarray(pg.K2, np.float64))
        self._stage_end(span)
        return X_np[inl_np], p2_np[inl_np], track_ids[inl_np], P2

    def _chain_scan(self, P2: torch.Tensor) -> None:
        """The device scan chain on the staged path's pair geometry and
        keypoint table (``incremental.py:1487-1557``); with two images there
        is no frame to chain."""
        span = self._stage("chain")
        pgs = [self.pair_geometry[(i, i + 1)] for i in range(2, self.max_img)]
        if not pgs:
            self._stage_end(span)
            return
        stack = lambda f, dt=torch.float32: self._dev(np.stack([getattr(pg, f) for pg in pgs]), dt)
        max_points = self.config.max_points
        n0 = self.map.num_tracks
        points0 = torch.zeros((max_points, 3), device=self.device)
        points0[:n0] = self._dev(self.map.points())
        chain = chain_scan(
            self._generator, stack("p1"), stack("p2"), stack("idx1", torch.int64),
            stack("idx2", torch.int64), stack("mask", torch.bool), stack("K2"),
            self._dev(self._kp_tracks[2], torch.int64), points0, n0, P2, self._pnp_hyp,
            self.config.ransac.pnp_reproj_threshold,
        )
        rvecs, ts, oks, _ninl, obs_track, obs_xy, points, n_points = chain
        host = [v.cpu().numpy() for v in (rvecs, ts, oks, obs_track, obs_xy, points[:int(n_points)])]
        self._finish_chain(*host, [pg.K2 for pg in pgs])
        self._stage_end(span)

    @staticmethod
    def _associate_by_distance(prev_obs_2d: np.ndarray, pair_p1: np.ndarray,
                               dist_threshold: float) -> np.ndarray:
        """Reference-faithful association: nearest established observation in
        the shared frame within the gate (Runner.py:241-247), vectorized."""
        if len(prev_obs_2d) == 0 or len(pair_p1) == 0:
            return np.full(len(pair_p1), -1, np.int64)
        d = np.linalg.norm(pair_p1[:, None, :] - prev_obs_2d[None, :, :], axis=2)
        nearest = np.argmin(d, axis=1)
        ok = d[np.arange(len(pair_p1)), nearest] < dist_threshold
        return np.where(ok, nearest, -1)

    def _chain(self, p3d: np.ndarray, p2_obs: np.ndarray, track_ids: np.ndarray,
               P2: torch.Tensor, uniforms: Optional[torch.Tensor] = None) -> None:
        """The host chain over frames 3..N (``incremental.py:1166-1301``).

        Per frame: associate the pair's matches with tracks (by keypoint
        index, or by distance to the previous frame's new observations),
        ``chain_step`` on the device and one packed fetch, pose recovery
        where PnP fails (``on_pose_failure="recover"``), the map and
        keypoint-table updates, window linking, a local BA every
        ``local_ba_every`` cameras and a checkpoint every
        ``checkpoint_every`` images. The PnP uniforms of every frame are
        drawn at once, as the scan chain draws them; ``uniforms`` (F,
        num_hypotheses, 3) replaces the draw."""
        span = self._stage("chain")
        rcfg = self.config.ransac
        if uniforms is None:
            uniforms = torch.rand((self.max_img - 2, self._pnp_hyp, 3), generator=self._generator,
                                  device=self.device)
        pair_host = {k: (pg.mask, pg.p1, pg.p2, pg.idx1, pg.idx2)
                     for k, pg in self.pair_geometry.items() if k[0] < k[1] and k[1] >= 3}
        for i in range(2, self.max_img):
            j = i + 1
            pg = self.pair_geometry[(i, j)]
            mask_np, p1_h, p2_h, idx1_np, idx2_np = pair_host[(i, j)]
            p1_np = np.asarray(p1_h, dtype=np.float64)
            p2_np = np.asarray(p2_h, dtype=np.float64)

            if self.assoc_mode == "index":
                # A match whose image-i keypoint carries a track links the
                # new frame to that track's 3-D point.
                linked = np.where(mask_np, self._kp_tracks[i][idx1_np], -1)
                sel = linked >= 0
                known_tracks = np.where(sel, linked, 0)
                X_known = self.map.points()[known_tracks]
            else:
                assoc = self._associate_by_distance(p2_obs, p1_np, self.config.dist_threshold)
                assoc = np.where(mask_np, assoc, -1)
                sel = assoc >= 0
                known_tracks = np.where(sel, track_ids[np.where(sel, assoc, 0)], 0)
                X_known = p3d[np.where(sel, assoc, 0)]

            if sel.sum() < 6 and self.on_pose_failure == "raise":
                # The reference's behaviour: a failed pose ends the run.
                raise RuntimeError(f"Cannot determine pose for pair ({i}, {j}): "
                                   f"only {int(sel.sum())} 2D-3D associations")

            # Distance association triangulates every match again as a new
            # track, as the reference does.
            new_sel = mask_np & ~sel if self.assoc_mode == "index" else mask_np
            K2 = self._dev(pg.K2)
            p1_t, p2_t = self._dev(p1_np), self._dev(p2_np)
            ok, inl_t, rvec_t, t_t, P2_new, X_new_t, ok_new_t = chain_step(
                None, self._dev(X_known), self._dev(sel, torch.bool), p1_t, p2_t, K2, P2,
                self._pnp_hyp, rcfg.pnp_reproj_threshold, self._dev(new_sel, torch.bool),
                uniforms=uniforms[i - 2])
            ok, inliers, rvec, tvec, X_new_np, ok_new = device_get_packed(
                ok, inl_t, rvec_t, t_t, X_new_t, ok_new_t)

            if not bool(ok) or sel.sum() < 6:
                if self.on_pose_failure == "raise":
                    raise RuntimeError(f"Cannot determine pose for pair ({i}, {j})")
                R, t = self._recover_pose(pg, i, j)
                sel = np.zeros(len(p1_np), bool)
                inliers = np.zeros(len(p1_np), bool)
                rvec, tvec = so3_log(R).cpu().numpy(), t.cpu().numpy()
                P1 = P2
                with f32_precision():
                    P2 = projection_matrix(R, t, K2)
                    X_new_np = triangulate_dlt(p1_t, p2_t, P1, P2).cpu().numpy()
                ok_new = new_sel & self._cheirality_np(
                    X_new_np.astype(np.float64), P1.cpu().numpy(), P2.cpu().numpy())
            else:
                P2 = P2_new

            current_frame = len(self.global_poses)   # the next BA camera
            # Re-observe the linked tracks in the new frame.
            pnp_inl = inliers & sel
            self.map.add_observations(np.where(pnp_inl, known_tracks, -1), p2_np, current_frame)
            self._kp_tracks[j][idx2_np[pnp_inl]] = known_tracks[pnp_inl]

            X_new_np = np.asarray(X_new_np, dtype=np.float64)
            new_ids = self.map.add_tracks(X_new_np, p2_np, current_frame, mask=ok_new)
            self._kp_tracks[j][idx2_np[ok_new]] = new_ids[ok_new]

            self._grow_seen()
            self._track_seen_frame[known_tracks[pnp_inl]] = current_frame
            self._track_seen_frame[new_ids[ok_new]] = current_frame
            if self.pair_window > 1:
                self._link_window_pairs(j, current_frame, pair_host)

            p3d = X_new_np[ok_new]
            p2_obs = p2_np[ok_new]
            track_ids = new_ids[ok_new]
            self.global_poses.append((np.asarray(rvec, np.float64), np.asarray(tvec, np.float64)))
            self.global_K.append(np.asarray(pg.K2, np.float64))

            if self.local_ba_every and len(self.global_poses) % self.local_ba_every == 0:
                # After the frame's camera is registered: its observations
                # must name an existing BA camera.
                freeze = max(0, len(self.global_poses) - self.local_ba_window)
                self._global_ba(freeze_before=freeze, stage="local_ba")
                # The chained projection follows the re-optimised last pose.
                rv_l, t_l = self.global_poses[-1]
                P2 = projection_matrix(so3_exp(self._dev(rv_l)), self._dev(t_l), K2)

            if self.checkpoint_every and j % self.checkpoint_every == 0 and is_writer(self.mesh):
                path = self.checkpoint_path or os.path.join(self.output_dir, "checkpoint.npz")
                save_checkpoint(self, path, next_frame=j + 1)
        self._stage_end(span)

    def _recover_pose(self, pg: PairGeometry, i: int, j: int,
                      uniforms: Optional[torch.Tensor] = None):
        """Pose of image j when PnP fails (``incremental.py:1303-1340``): the
        pair's relative pose by fixed-count essential RANSAC
        (``_num_hyp`` hypotheses, ``min_cheirality_frac=0.5``; ``uniforms``
        (``_num_hyp``, 8) replaces the draw), chained onto the previous
        absolute pose with the unit translation scaled to the previous step
        length. Returns (R, t) on the device."""
        self.warnings.append(f"pose recovery engaged for pair ({i}, {j})")
        rel = ransac_essential_pose(
            self._generator, self._dev(pg.p1), self._dev(pg.p2), self._dev(pg.K1),
            self._dev(pg.K2), self._dev(pg.mask, torch.bool), num_hypotheses=self._num_hyp,
            threshold=self.config.ransac.epipolar_threshold, min_cheirality_frac=0.5,
            uniforms=uniforms,
        )
        rv_prev, t_prev = self.global_poses[-1]
        R_prev = so3_exp(self._dev(rv_prev)).cpu().numpy().astype(np.float64)
        if len(self.global_poses) >= 2:
            rv_pp, t_pp = self.global_poses[-2]
            R_pp = so3_exp(self._dev(rv_pp)).cpu().numpy().astype(np.float64)
            c_prev = -R_prev.T @ np.asarray(t_prev)
            c_pp = -R_pp.T @ np.asarray(t_pp)
            step = float(np.linalg.norm(c_prev - c_pp))
        else:
            step = 1.0
        R_rel, t_rel = (v.cpu().numpy().astype(np.float64) for v in (rel.R, rel.t))
        R_new = R_rel @ R_prev
        t_new = R_rel @ np.asarray(t_prev) + t_rel * max(step, 1e-6)
        return self._dev(R_new), self._dev(t_new)

    def _grow_seen(self) -> None:
        n = self.map.num_tracks
        if len(self._track_seen_frame) < n:
            grown = np.full(n, -1, dtype=np.int64)
            grown[: len(self._track_seen_frame)] = self._track_seen_frame
            self._track_seen_frame = grown

    def _link_window_pairs(self, j: int, current_frame: int, pair_host) -> None:
        """Attach observations of mapped tracks seen again through the
        non-consecutive pairs (i, j), i < j-1 (``incremental.py:1349-1371``);
        a track gets at most one observation per frame."""
        for i in range(max(1, j - self.pair_window), j - 1):
            if (i, j) not in pair_host:
                continue
            mask_np, _p1h, p2h, idx1_np, idx2_np = pair_host[(i, j)]
            linked = np.where(mask_np, self._kp_tracks[i][idx1_np], -1)
            sel = linked >= 0
            if not sel.any():
                continue
            tids = linked[sel]
            self._grow_seen()
            fresh = self._track_seen_frame[tids] != current_frame
            if not fresh.any():
                continue
            tids_f = tids[fresh]
            xy = np.asarray(p2h, dtype=np.float64)[sel][fresh]
            self.map.add_observations(tids_f, xy, current_frame)
            self._kp_tracks[j][idx2_np[sel][fresh]] = tids_f
            self._track_seen_frame[tids_f] = current_frame

    @staticmethod
    def _cheirality_np(X: np.ndarray, P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
        P1n, P2n = np.asarray(P1, np.float64), np.asarray(P2, np.float64)
        Xh = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        return ((Xh @ P1n.T)[:, 2] > 1e-6) & ((Xh @ P2n.T)[:, 2] > 1e-6)

    def _global_ba(self, freeze_before: int = 0, stage: str = "ba") -> None:
        """Bundle adjustment on the device over every camera and track
        (``incremental.py:1381-1469``), cameras [0, freeze_before) frozen, on
        the JAX package's padded problem so the same Schur backend is
        chosen. Its time adds to ``stage_times[stage]``: ``"ba"``, or
        ``"local_ba"`` for the chain's windowed solves."""
        span = self._stage(stage)
        frames, tracks, xy = self.map.observations()
        cam_params = np.array([np.hstack([rv, t]) for rv, t in self.global_poses])
        num_cams = len(cam_params)
        num_pts = self.map.num_tracks
        problem = pad_problem(make_problem(
            cam_params, self.map.points(), frames, tracks, xy, np.stack(self.global_K),
            cam_fixed=np.arange(num_cams) < freeze_before, device=self.device,
        ))
        ba = self.config.ba
        kw = dict(max_iters=ba.max_lm_iters, cg_iters=60, init_damping=ba.init_damping,
                  damping_up=ba.damping_up, damping_down=ba.damping_down, ftol=ba.ftol,
                  huber_delta=ba.huber_delta)
        # The final BA only: a scaled K in a local BA would leave the chain
        # registering later frames at the unscaled K. On a mesh every BA
        # shards by observation, the selfcal border too (incremental.py:1412-1428).
        selfcal = self.refine_focal and stage == "ba"
        if mesh_axis(self.mesh, "data") is not None:
            out = bundle_adjust_sharded(problem, self.mesh, selfcal=selfcal, **kw)
            res, s_dev = out if selfcal else (out, None)
        elif selfcal:
            res, s_dev = bundle_adjust_selfcal(problem, **kw)
        else:
            res, s_dev = bundle_adjust(problem, **kw), None
        if selfcal:
            s = float(s_dev)
            self.focal_scale *= s
            for i in range(len(self.global_K)):
                Kn = np.asarray(self.global_K[i], np.float64).copy()
                Kn[0, 0] *= s
                Kn[1, 1] *= s
                self.global_K[i] = Kn
            self.warnings.append(
                f"focal self-calibration: cumulative scale {self.focal_scale:.4f}")
        pts = res.points[:num_pts].cpu().numpy()
        cams = res.cam_params[:num_cams].cpu().numpy()
        self.errors_before_after_ba = (float(res.initial_mean_error), float(res.final_mean_error))
        self.map.update_points(np.asarray(pts, np.float64))
        self.global_poses = [(np.asarray(c[:3], np.float64), np.asarray(c[3:], np.float64))
                             for c in cams]
        self.ba_problem, self.ba_result = problem, res
        self._stage_end(span)

    # ------------------------------------------------------------------ driver

    def run(self) -> "SfmEngine":
        with self._timer.run():
            feats = self._extract_all_features()
            if self._fused_front_eligible(feats):
                self._run_front(feats)
            else:
                self._match_pairs(feats)
                p3d, p2_obs, track_ids, P2 = self._bootstrap()
                if self._use_scan_chain():
                    self._chain_scan(P2)
                else:
                    self._chain(p3d, p2_obs, track_ids, P2)
            if self.chain_refresh == "averaging":
                averaging_refresh(self)
            self._global_ba()
        if self.model_name is not None and is_writer(self.mesh):
            self.save_data()
        return self

    @classmethod
    def match_graph_shard(cls, img_path: str, max_img: int, shard: int, num_shards: int,
                          pair_cache_dir: str, **kwargs) -> int:
        """Match and persist this process's shard of the pair graph
        (``incremental.py:1602-1635``): every ``num_shards``-th pair of the
        sorted candidate list, written into ``pair_cache_dir``, so that a
        later run with the same configuration resumes the whole graph.
        Returns the number of pairs this call computed (0 when the cache
        already held the shard)."""
        eng = cls(img_path, max_img, pair_cache_dir=pair_cache_dir, auto_run=False, **kwargs)
        eng._pair_shard = (shard, num_shards)
        feats = eng._extract_all_features()
        eng._prepare_pair_selection(feats)
        eng._match_pairs(feats)
        return eng._last_match_computed

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

    def save_ply(self, path: str) -> str:
        """Export the reconstruction as a colored ASCII PLY (io/export.py)."""
        return export.save_ply(self, path)

    def save_colmap(self, out_dir: str) -> str:
        """Export a COLMAP sparse text model (io/export.py)."""
        return export.save_colmap(self, out_dir)

    @staticmethod
    def load(model_name: str, output_dir: str = "output", show: bool = True):
        """Load a saved model (reference Runner.py:403-416): with ``show`` the
        3-D viewer on its points (a ``V3D``), else a dict of its arrays."""
        with np.load(os.path.join(output_dir, f"{model_name}.npz")) as npz:
            data = dict(npz)
        if show:
            from sfmfromscratch_tpu_torch.viz.scatter3d import V3D

            return V3D(data["p3d"], data["frame_idx"], data["pt_idx"])
        return data
