"""Global Structure-from-Motion engine: motion averaging instead of a chain
(counterpart of ``sfmfromscratch_tpu/pipeline/global_sfm.py``).

Stages, each batched over the whole sequence:

1. features (one Harris launch per pyramid level for all images); with
   ``keyframe_step="auto"``, keyframes chosen by the median flow of every
   consecutive pair (one matcher launch);
2. matching of the candidate pairs (one matcher launch for all of them) and
   the F-RANSAC filter on every pair. Candidates are window pairs
   over the keyframes (every image unless ``keyframe_step`` > 1), VLAD
   retrieval proposals (``pair_mode="retrieval"``), or both;
3. relative poses of every pair by batched essential RANSAC (adaptive, or
   fixed-count with ``RansacConfig(adaptive=False)``), then
   Sampson refinement of every edge, and the planar-degeneracy fix;
4. the cycle filter and connectivity repair, chordal + IRLS rotation
   averaging, translation directions refit under the averaged rotations,
   per-edge baseline scales from two-view depth ratios, and scaled
   translation averaging;
5. union-find tracks over every pair's inlier matches;
6. multiview triangulation of every track with observation gating;
7. the map; the non-keyframes, if any, register against it: each frame is
   matched to its two nearest keyframes (one matcher launch for all of
   them), F-filtered, linked to the keyframes' tracks, and every frame's
   pose comes from one vmapped P3P RANSAC;
8. ``ba_rounds`` bundle adjustments with camera 0 frozen and re-gating
   between them, or with ``stream_ba_window`` the out-of-core streaming BA
   (``pipeline/streaming.py``).

The host numpy of the view-graph stages is the JAX module's, copied as it
stands. Device stages run on the engine's device on edge lists padded to the
JAX engine's buckets (``_bucket(E, 128)``): rotation averaging normalises its
weights by their mean over the padded list, so the padding is part of the
result. Camera c observes through image c+1; camera 0 is the gauge anchor.

On a ``mesh`` the engine shards where the JAX engine does: the features and
every BA as :class:`SfmEngine` (the streaming BA's window solves too), and
the relative-pose RANSAC by pair over the ``data`` axis, each lane with the
uniforms an unsharded run gives it (``_sharded_relative_poses``).
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from sfmfromscratch_tpu_torch.config import PipelineConfig
from sfmfromscratch_tpu_torch.geometry.averaging import (
    chain_initial_centers,
    chain_initial_rotations,
    chordal_rotation_init,
    relative_translations_known_rotations,
    rotation_averaging,
    translation_averaging,
)
from sfmfromscratch_tpu_torch.geometry.homography import (
    _transfer_err2,
    candidate_epipolar_rms_batch,
    fit_homography,
    pose_from_homography_batch,
)
from sfmfromscratch_tpu_torch.geometry.pnp import pnp_ransac
from sfmfromscratch_tpu_torch.geometry.ransac import (
    ransac_essential_pose_adaptive_batch,
    ransac_essential_pose_batch,
    ransac_fundamental_adaptive_batch,
)
from sfmfromscratch_tpu_torch.geometry.triangulation import triangulate_multiview, two_view_depths
from sfmfromscratch_tpu_torch.geometry.two_view import refine_relative_pose
from sfmfromscratch_tpu_torch.native.bindings import build_tracks
from sfmfromscratch_tpu_torch.ops.cuda import transavg_kernel
from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_log
from sfmfromscratch_tpu_torch.ops.matcher import match_pairs_batch  # noqa: F401  (JAX's name)
from sfmfromscratch_tpu_torch.ops.retrieval import retrieval_similarity
from sfmfromscratch_tpu_torch.parallel.mesh import MeshAxis, all_gather_cat, is_writer, mesh_axis
from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine
from sfmfromscratch_tpu_torch.pipeline.streaming import MapBlockStore, stream_bundle_adjust
from sfmfromscratch_tpu_torch.types import Features


def _bucket(n: int, q: int = 1024) -> int:
    return max(q, ((n + q - 1) // q) * q)


def _pad_edges(a: torch.Tensor, num_padded: int, template=0.0) -> torch.Tensor:
    """Pad an (E, ...)-leading tensor to ``num_padded`` rows of ``template``
    (zero weight, all-false masks, identity rotations: inert rows)."""
    pad = num_padded - a.shape[0]
    if pad <= 0:
        return a
    t = torch.as_tensor(np.asarray(template), dtype=a.dtype, device=a.device)
    return torch.cat([a, t.expand((pad,) + tuple(a.shape[1:]))], dim=0)


def nanmedian_rows(d: torch.Tensor) -> torch.Tensor:
    """Median of each row over its non-NaN entries, the two middle values
    averaged for an even count (``jnp.nanmedian`` and ``np.nanmedian``;
    ``torch.nanmedian`` returns the lower one). NaN for an all-NaN row."""
    return torch.nanquantile(d, 0.5, dim=-1)


# Frames per vmapped PnP launch of the registration: the hypothesis scores
# take (frames x 4 x hypotheses x points) floats a temporary.
_REGISTER_CHUNK = 64


class GlobalSfmEngine(SfmEngine):
    """Global SfM over an image sequence, with :class:`SfmEngine`'s result
    contract (map, global_poses, global_K, errors, save_data).

    ``device=None`` runs on the CUDA card and raises without one. The pair
    cache, the match-graph shards and ``refine_focal`` work as in
    :class:`SfmEngine` (every BA round self-calibrates), and so does a
    ``mesh``. The registration's F-filter is adaptive whatever
    ``RansacConfig.adaptive`` says, as in the JAX engine
    (``global_sfm.py:1350``).
    """

    # Every window pair feeds the view graph, pair (1, 2) included.
    _filter_all_pairs = True

    def __init__(
        self,
        img_path: str,
        max_img: int,
        pair_window: int = 3,
        rel_num_hypotheses: int = 1024,
        min_edge_inliers: int = 15,
        obs_gate_px: float = 8.0,
        rot_avg_iters: int = 64,
        trans_avg_iters: int = 12,
        ba_rounds: int = 2,
        regate_px: float = 3.0,
        pair_mode: str = "window",
        retrieval_k: int = 6,
        keyframe_step: int = 1,
        keyframe_flow_px: Optional[float] = None,
        stream_ba_window: Optional[int] = None,
        stream_ba_block_cams: int = 32,
        **kwargs,
    ):
        if pair_mode not in ("window", "retrieval", "both"):
            raise ValueError(f"pair_mode must be 'window', 'retrieval' or 'both', got {pair_mode!r}")
        # With stream_ba_window the final BA runs out of core: the map
        # spills to a block store and a window of stream_ba_window blocks of
        # stream_ba_block_cams cameras is resident per solve.
        self.stream_ba_window = stream_ba_window
        self.stream_ba_block_cams = stream_ba_block_cams
        self.stream_stats = None
        # keyframe_step k > 1: the view graph runs on every k-th image and
        # the rest register by batched PnP; "auto" picks keyframes from the
        # measured flow (keyframe_flow_px, default 5% of the image diagonal).
        self.keyframe_step = "auto" if keyframe_step == "auto" else max(1, int(keyframe_step))
        self.keyframe_flow_px = keyframe_flow_px
        self._auto_kfs: Optional[List[int]] = None
        # "window" pairs an ordered sequence; "retrieval" proposes each
        # image's retrieval_k most similar images (VLAD); "both" unions them.
        self.pair_mode = pair_mode
        self.retrieval_k = retrieval_k
        self.rel_num_hypotheses = rel_num_hypotheses
        self.min_edge_inliers = min_edge_inliers
        self.obs_gate_px = obs_gate_px
        self.rot_avg_iters = rot_avg_iters
        self.trans_avg_iters = trans_avg_iters
        self.ba_rounds = max(1, ba_rounds)
        self.regate_px = regate_px
        self._edges: List[tuple] = []          # (i, j) 1-based image ids, i < j
        self._edge_R: Optional[np.ndarray] = None
        self._edge_t: Optional[np.ndarray] = None
        self._edge_w: Optional[np.ndarray] = None
        self._edge_inl: Dict[tuple, np.ndarray] = {}
        self._edge_alt: Dict[int, tuple] = {}
        self._kp_xy: Dict[int, np.ndarray] = {}
        self.R_cams: Optional[np.ndarray] = None   # (C, 3, 3)
        self.c_cams: Optional[np.ndarray] = None   # (C, 3) centres
        # Huber BA unless the caller set a delta (global_sfm.py:191-204).
        cfg = kwargs.get("config") or PipelineConfig()
        if cfg.ba.huber_delta == 0.0:
            cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, huber_delta=3.0))
        kwargs["config"] = cfg
        super().__init__(img_path, max_img, pair_window=max(2, pair_window), **kwargs)

    # ------------------------------------------------------------------ pairs

    @property
    def keyframed(self) -> bool:
        return self.keyframe_step == "auto" or self.keyframe_step > 1

    @property
    def keyframes(self) -> List[int]:
        """1-based keyframe image ids: every image at ``keyframe_step`` 1,
        every k-th and the last at k, the flow-selected ones at "auto"
        (after feature extraction)."""
        if self.keyframe_step == "auto":
            return self._auto_kfs or list(range(1, self.max_img + 1))
        kfs = list(range(1, self.max_img + 1, self.keyframe_step))
        if kfs[-1] != self.max_img:
            kfs.append(self.max_img)
        return kfs

    def _select_keyframes(self, feats: Features) -> None:
        """Flow-adaptive keyframes (``global_sfm.py:252-289``): match every
        consecutive pair, take each pair's median displacement of its
        matches, and start a new keyframe whenever the flow accumulated since
        the last one reaches the target; the last image is always one."""
        span = self._stage("keyframes")
        C = self.max_img
        res, p1, p2 = self._match_pair_list(feats, [(i, i + 1) for i in range(1, C)])
        d = torch.linalg.norm(p2 - p1, dim=-1)
        d = torch.where(res.mask, d, float("nan"))
        flows = np.nan_to_num(nanmedian_rows(d).cpu().numpy().astype(np.float64), nan=0.0)

        tau = self.keyframe_flow_px
        if tau is None:
            K1 = self._intrinsics(1)
            tau = 0.05 * 2.0 * float(np.hypot(K1[0, 2], K1[1, 2]))
        kfs = [1]
        acc = 0.0
        for f in range(2, C + 1):
            acc += flows[f - 2]
            if acc >= tau:
                kfs.append(f)
                acc = 0.0
        if kfs[-1] != C:
            kfs.append(C)
        self._auto_kfs = kfs
        self.warnings.append(f"auto keyframes: {len(kfs)}/{C} at flow target {tau:.1f} px")
        span.counters.update(frames=C - 1, keyframes=len(kfs))
        self._stage_end(span)

    def _prepare_pair_selection(self, feats: Features) -> None:
        if self.keyframe_step == "auto" and self._auto_kfs is None:
            self._select_keyframes(feats)

    def _candidate_pairs(self, feats: Features):
        """Window pairs over the keyframe subsequence (every image when not
        keyframed), VLAD retrieval proposals among the keyframes, or both
        (``global_sfm.py:291-336``)."""
        if self.keyframed:
            kfs = self.keyframes
            pairs = set()
            if self.pair_mode in ("window", "both"):
                for a in range(len(kfs) - 1):
                    for d in range(1, self.pair_window + 1):
                        if a + d < len(kfs):
                            pairs.add((kfs[a], kfs[a + d]))
        else:
            pairs = (set(super()._candidate_pairs(feats))
                     if self.pair_mode in ("window", "both") else set())
        if self.pair_mode in ("retrieval", "both"):
            pairs |= self._retrieval_pairs(feats)
        return sorted(pairs)

    def _retrieval_pairs(self, feats: Features, scores: Optional[torch.Tensor] = None) -> set:
        """Each (key)frame's ``retrieval_k`` most similar (key)frames by VLAD
        cosine, as (min, max) image pairs. A stable descending sort breaks
        ties toward the lower index, as ``lax.top_k`` does; proposals of
        itself or of a masked image (score <= -1.5) are dropped. ``scores``
        replaces the vocabulary's random init (a test feeds JAX's)."""
        C = self.max_img
        S = retrieval_similarity(self._generator, feats.descriptors, feats.keypoints.mask,
                                 scores=scores)
        if self.keyframed:
            kf = torch.zeros(C, dtype=torch.bool, device=S.device)
            kf[[k - 1 for k in self.keyframes]] = True
            S = torch.where(kf[None, :], S, -2.0)
            S = torch.where(kf[:, None], S, -2.0)
        k = min(self.retrieval_k, C - 1)
        vals, nbr = torch.sort(S, dim=1, descending=True, stable=True)
        vals, nbr = vals[:, :k].cpu().numpy(), nbr[:, :k].cpu().numpy()
        pairs = set()
        for i in range(C):
            for col, j in enumerate(nbr[i]):
                if int(j) == i or vals[i, col] <= -1.5:
                    continue
                a, b = i + 1, int(j) + 1
                pairs.add((min(a, b), max(a, b)))
        return pairs

    # ------------------------------------------------------------------ stages

    def _relative_poses(self) -> None:
        """Relative pose of every matched pair by batched essential RANSAC
        (adaptive, or fixed-count at ``rel_num_hypotheses``), Sampson refinement of every edge over its inlier set, the
        planar-degeneracy fix, then edge weights and inlier sets
        (global_sfm.py:338-476)."""
        span = self._stage("relative_poses")
        pairs = sorted([k for k in self.pair_geometry if k[0] < k[1]],
                       key=lambda k: (k[1] - k[0], k[0]))   # consecutive edges first
        pgs_all = [self.pair_geometry[k] for k in pairs]
        E = len(pairs)
        self._edges = pairs
        if E:
            child = self._timer.open("relpose_ransac")
            stack = lambda f, dt=torch.float32: self._dev(np.stack([getattr(pg, f) for pg in pgs_all]), dt)
            p1, p2, K1, K2 = stack("p1"), stack("p2"), stack("K1"), stack("K2")
            mask = stack("mask", torch.bool)
            ax = mesh_axis(self.mesh, "data")
            if ax is None:
                res = self._relative_pose_batch(p1, p2, K1, K2, mask)
            else:
                res = self._sharded_relative_poses(ax, p1, p2, K1, K2, mask)
            inl_dev = res.inliers
            R_np, t_np, inl_np, ninl_np, che_np = (
                v.cpu().numpy() for v in (res.R, res.t, res.inliers, res.num_inliers,
                                          res.cheirality_ok))
            child = self._stage_end(child, then="relpose_refine", time_as=None)
            inl_masks = list(inl_np)
            ninl = ninl_np.astype(np.float64)
            che = che_np.astype(bool)

            # Sampson refinement of every edge, on the bucketed edge list.
            Eb = _bucket(E, 128)
            eye = np.eye(3, dtype=np.float32)
            R_ref, t_ref, rms = refine_relative_pose(
                _pad_edges(self._dev(R_np), Eb, eye),
                _pad_edges(self._dev(t_np), Eb, np.asarray([0, 0, 1], np.float32)),
                _pad_edges(p1, Eb), _pad_edges(p2, Eb),
                _pad_edges(K1, Eb, eye), _pad_edges(K2, Eb, eye),
                _pad_edges(inl_dev.to(torch.float32), Eb),
            )
            self._edge_R = R_ref[:E].cpu().numpy().astype(np.float64)
            self._edge_t = t_ref[:E].cpu().numpy().astype(np.float64)
            che = che & (rms[:E].cpu().numpy() < 4.0)
            self._timer.close(child, time_as=None)
            self._fix_planar_degenerate_edges(pairs, pgs_all, inl_masks, ninl, Eb)
        else:
            self._edge_R, self._edge_t = np.zeros((0, 3, 3)), np.zeros((0, 3))
            inl_masks, ninl, che = [], np.zeros(0), np.zeros(0, bool)
        good = (ninl >= self.min_edge_inliers) & che
        if not good.any() and len(pairs):
            good = ninl >= max(self.min_edge_inliers, 1)
        self._edge_w = np.where(good, ninl, 0.0)
        for e, k in enumerate(pairs):
            self._edge_inl[k] = inl_masks[e] if good[e] else np.zeros_like(inl_masks[e])
        self._stage_end(span)

    def _relative_pose_batch(self, p1, p2, K1, K2, mask, draw=None, uniforms=None):
        """Essential RANSAC of a batch of pairs: adaptive (``draw`` may
        replace its draws), or fixed-count at ``rel_num_hypotheses``
        (``uniforms`` may replace its draws)."""
        rcfg = self.config.ransac
        if rcfg.adaptive:
            # Early-terminating stages; these pair masks are already
            # epipolar-RANSAC inliers, so almost every lane stops after the
            # first stage.
            return ransac_essential_pose_adaptive_batch(
                self._generator, p1, p2, K1, K2, mask,
                max_hypotheses=self.rel_num_hypotheses,
                stage_size=min(128, self.rel_num_hypotheses),
                threshold=rcfg.epipolar_threshold,
                confidence=rcfg.prob_success, min_cheirality_frac=0.75, draw=draw,
            )
        return ransac_essential_pose_batch(
            self._generator, p1, p2, K1, K2, mask,
            num_hypotheses=self.rel_num_hypotheses,
            threshold=rcfg.epipolar_threshold, min_cheirality_frac=0.75, uniforms=uniforms,
        )

    def _sharded_relative_poses(self, ax: MeshAxis, p1, p2, K1, K2, mask):
        """The relative-pose RANSAC sharded by pair over ``ax``
        (``global_sfm.py:353-386``): the E pairs are padded with the last pair
        to a multiple of the axis, each rank runs its contiguous block, and
        the results are all-gathered. Each lane takes the uniforms of the
        unsharded call, and the generator ends where that call leaves it:
        the fixed-count path draws the whole (E, hypotheses, 8) block on
        every rank and takes its rows; the adaptive path agrees on the
        active lanes of every rank at each stage (an ``all_gather``), draws
        the whole stage for them, and gives each of its lanes that lane's
        rows. Padding lanes draw nothing and are dropped. On the CPU the
        result is the unsharded call's bits; on the card its integer fields
        are, and R, t and F agree to float32 rounding (CUDA's batched
        kernels split their sums by the batch's shape)."""
        E, dev, gen = p1.shape[0], p1.device, self._generator
        per = -(-E // ax.size)
        lanes = torch.arange(ax.rank * per, (ax.rank + 1) * per)
        real = lanes < E
        rows = lanes.clamp_max(E - 1).to(dev)
        local = [a[rows] for a in (p1, p2, K1, K2, mask)]
        rcfg = self.config.ransac
        if rcfg.adaptive:
            stage_size = min(128, self.rel_num_hypotheses)

            def draw(go, stage):
                go = go & real
                go_all = all_gather_cat(go.to(dev), ax).cpu()[:E]
                active = int(go_all.sum())
                if active == 0:
                    return go, None
                u = torch.rand((active, stage_size, 8), generator=gen, device=dev,
                               dtype=torch.float32)
                slot = torch.cumsum(go_all.to(torch.int64), 0) - 1
                return go, u[slot[lanes[go]].to(dev)]

            res = self._relative_pose_batch(*local, draw=draw)
        else:
            u = torch.rand((E, self.rel_num_hypotheses, 8), generator=gen, device=dev,
                           dtype=torch.float32)
            res = self._relative_pose_batch(*local, uniforms=u[rows])
        return type(res)(*(all_gather_cat(v, ax)[:E] for v in res))

    def _fix_planar_degenerate_edges(self, pairs, pgs_all, inl_masks, ninl, Eb) -> None:
        """Replace the pose of every edge whose epipolar inliers are >= 0.8x
        explained by one homography with its homography decomposition;
        off-plane points pick between the two interpretations, else the
        cheirality vote, else candidate 0 with the runner-up stashed in
        ``_edge_alt`` for the averaging loop (global_sfm.py:478-549)."""
        E = len(pairs)
        self._edge_alt = {}
        if E == 0:
            return
        eye = np.eye(3, dtype=np.float32)
        stack = lambda f: self._dev(np.stack([getattr(pg, f) for pg in pgs_all]))
        p1s = _pad_edges(stack("p1"), Eb)
        p2s = _pad_edges(stack("p2"), Eb)
        K1s = _pad_edges(stack("K1"), Eb, eye)
        K2s = _pad_edges(stack("K2"), Eb, eye)
        inls = _pad_edges(self._dev(np.stack(inl_masks), torch.bool), Eb, False)

        hfit = fit_homography(p1s, p2s, inls, threshold=2.0)
        hp = pose_from_homography_batch(hfit.H, K1s, K2s, p1s, p2s, inls)
        e2 = _transfer_err2(hfit.H, p1s, p2s)
        off = inls & (e2 > 4.0)
        rms2, off_cnt = candidate_epipolar_rms_batch(hp.R, hp.t, K1s, K2s, p1s, p2s, off)
        h_num, h_ok, R2, t2, votes, rms2_np, cnt_np = (
            v[:E].cpu().numpy() for v in (hfit.num_inliers, hp.ok, hp.R, hp.t, hp.num_pos,
                                          rms2, off_cnt))
        h_num = np.asarray(h_num, np.float64)
        degen = np.asarray(h_ok, bool) & (h_num >= 0.8 * np.maximum(ninl, 1)) & (ninl >= 12)
        replaced, deferred = [], []
        for e in np.nonzero(degen)[0]:
            r = np.asarray(rms2_np[e], np.float64)
            if cnt_np[e] >= 6 and (r.min() < 2.0) and (r.max() > 2.0 * r.min() + 1.0):
                c = int(np.argmin(r))          # off-plane points separate
            elif votes[e][0] > 1.05 * max(votes[e][1], 1):
                c = 0                          # cheirality vote separates
            else:
                c = 0                          # ambiguous: stash the runner-up
                self._edge_alt[e] = (np.asarray(R2[e][1], np.float64),
                                     np.asarray(t2[e][1], np.float64))
                deferred.append(self._edges[e])
            self._edge_R[e] = np.asarray(R2[e][c], np.float64)
            self._edge_t[e] = np.asarray(t2[e][c], np.float64)
            replaced.append(self._edges[e])
        if replaced:
            self.warnings.append(
                f"planar-degenerate pose-from-H on {len(replaced)} edges"
                + (f" ({len(deferred)} twofold-ambiguous)" if deferred else "")
            )

    def _filter_edges_by_cycles(self, tau_deg: float = 3.0) -> None:
        """Triangle (cycle) consistency filter on relative rotations with
        greedy eviction, quarantine of unverifiable non-bridge edges, damped
        bridges and the bridge-vs-casualties test (global_sfm.py:551-804)."""
        E = len(self._edges)
        if E == 0:
            return
        idx = {k: e for e, k in enumerate(self._edges)}
        alive = self._edge_w > 0

        def rel(e, a, b):
            # rotation mapping frame a -> frame b along edge e=(i,j)
            i, j = self._edges[e]
            R = self._edge_R[e]
            return R if (a, b) == (i, j) else R.T

        succ: Dict[int, list] = {}
        for (i, j) in idx:
            succ.setdefault(i, []).append(j)
        tris = []
        for (i, j), e1 in idx.items():
            for k in succ.get(j, ()):
                e3 = idx.get((i, k))
                if e3 is None:
                    continue
                tris.append((e1, idx[(j, k)], e3))

        def tri_angle(t):
            e1, e2, e3 = t   # (i,j), (j,k), (i,k)
            i, j = self._edges[e1]
            _, k = self._edges[e2]
            M = rel(e3, i, k).T @ (rel(e2, j, k) @ rel(e1, i, j))
            return np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1)))

        def live_residuals():
            return [(t, tri_angle(t)) for t in tris if all(alive[e] for e in t)]

        rr = [a for _, a in live_residuals()]
        tpe: Dict[int, int] = {}
        for t in tris:
            if all(alive[e] for e in t):
                for e in t:
                    tpe[e] = tpe.get(e, 0) + 1
        n_alive = int(alive.sum())
        redundant = (
            n_alive >= 24
            and len(tpe) >= 0.6 * n_alive
            and float(np.median(list(tpe.values()) or [0])) >= 3
        )
        if not rr:
            tau_eff = tau_deg
        elif redundant:
            tau_eff = max(tau_deg, 2.0 * float(np.percentile(rr, 25)))
        else:
            tau_eff = max(tau_deg, 1.5 * float(np.median(rr)))

        removed = []
        removed_idx: set = set()
        accused: set = set()      # ever sat in a violated triangle
        while True:
            live = live_residuals()
            if not any(a >= tau_eff for _, a in live):
                break
            per_edge: Dict[int, list] = {}
            for t, a in live:
                for e in t:
                    per_edge.setdefault(e, []).append(a)
            in_bad = set()
            for t, a in live:
                if a >= tau_eff:
                    in_bad.update(t)
            accused |= in_bad

            def score(e):
                return float(np.median(per_edge[e])) * np.sqrt(
                    1.0 / max(self._edge_w[e], 1.0)
                )

            worst = min(in_bad, key=lambda e: (-score(e), self._edge_w[e]))
            alive[worst] = False
            removed.append(self._edges[worst])
            removed_idx.add(worst)

        in_tri = np.zeros(E, bool)
        for t in tris:
            if all(alive[e] for e in t):
                for e in t:
                    in_tri[e] = True
        unverifiable = alive & ~in_tri & (self._edge_w > 0)

        parent = np.arange(self.max_img)

        def _find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for e in np.nonzero(alive & in_tri)[0]:
            i, j = self._edges[e]
            parent[_find(i - 1)] = _find(j - 1)
        damped = np.zeros(E, bool)
        for e in sorted(np.nonzero(unverifiable)[0], key=lambda e: -self._edge_w[e]):
            i, j = self._edges[e]
            ri, rj = _find(i - 1), _find(j - 1)
            if ri != rj:
                parent[ri] = rj
                damped[e] = True
            else:
                alive[e] = False
                removed.append(self._edges[e])
                removed_idx.add(e)

        for b in np.nonzero(damped)[0]:
            if b not in accused or not removed_idx:
                continue
            alive2 = alive.copy()
            alive2[list(removed_idx)] = True
            alive2[b] = False
            clean_restored, bridge_clean = 0, 0
            for t in tris:
                a_ok = all(alive2[e] for e in t)
                if a_ok and any(e in removed_idx for e in t):
                    if tri_angle(t) < tau_eff:
                        clean_restored += 1
                if b in t and all(alive2[e] or e == b for e in t):
                    if tri_angle(t) < tau_eff:
                        bridge_clean += 1
            if clean_restored >= 2 and bridge_clean == 0:
                p2 = np.arange(self.max_img)

                def _f2(x):
                    while p2[x] != x:
                        p2[x] = p2[p2[x]]
                        x = p2[x]
                    return x

                for e in np.nonzero(alive2 | damped)[0]:
                    if e == b:
                        continue
                    i, j = self._edges[e]
                    p2[_f2(i - 1)] = _f2(j - 1)
                if len({_f2(c) for c in range(self.max_img)}) == 1:
                    restored = []
                    for e in sorted(removed_idx):
                        in_clean = any(
                            e in t and all(alive2[x] for x in t)
                            and tri_angle(t) < tau_eff
                            for t in tris
                        )
                        if in_clean:
                            alive[e] = True
                            restored.append(self._edges[e])
                    if restored:
                        for k in restored:
                            removed.remove(k)
                        removed_idx -= {x for x in removed_idx if alive[x]}
                        alive[b] = False
                        damped[b] = False
                        removed.append(self._edges[b])
                        self.warnings.append(
                            "bridge-vs-casualties flip: dropped "
                            f"{self._edges[b]}, restored "
                            + ", ".join(map(str, restored))
                        )

        if removed:
            self.warnings.append(
                f"cycle filter dropped {len(removed)} edges: "
                + ", ".join(map(str, removed))
            )
            for e in range(E):
                if self._edge_w[e] > 0 and not alive[e]:
                    self._edge_inl[self._edges[e]] = np.zeros_like(
                        self._edge_inl[self._edges[e]]
                    )
            self._edge_w = np.where(alive, self._edge_w, 0.0)
        self._edge_w = np.where(damped, 0.25 * self._edge_w, self._edge_w)

    def _connected(self, alive: np.ndarray) -> bool:
        C = self.max_img
        parent = np.arange(C)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for e in np.nonzero(alive)[0]:
            i, j = self._edges[e]
            parent[find(i - 1)] = find(j - 1)
        return len({find(c) for c in range(C)}) == 1

    def _repair_connectivity(self, w_prev: np.ndarray, inl_prev, context: str) -> None:
        """Edge dropping must never disconnect the view graph: restore the
        highest-prior-weight zeroed edges that bridge components, at 0.25x
        weight (global_sfm.py:821-860)."""
        alive = np.asarray(self._edge_w) > 0
        if self._connected(alive):
            return
        C = self.max_img
        parent = np.arange(C)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for e in np.nonzero(alive)[0]:
            i, j = self._edges[e]
            parent[find(i - 1)] = find(j - 1)
        cand = np.nonzero(~alive & (np.asarray(w_prev) > 0))[0]
        cand = cand[np.argsort(-np.asarray(w_prev)[cand])]
        restored = []
        for e in cand:
            i, j = self._edges[e]
            ri, rj = find(i - 1), find(j - 1)
            if ri != rj:
                parent[ri] = rj
                self._edge_w[e] = 0.25 * w_prev[e]
                if inl_prev is not None:
                    self._edge_inl[self._edges[e]] = inl_prev[self._edges[e]].copy()
                restored.append(self._edges[e])
        if restored:
            self.warnings.append(
                f"connectivity repair ({context}): restored damped edges "
                + ", ".join(map(str, restored))
            )

    def _motion_averaging(self) -> None:
        """Absolute rotations and camera centres from the view graph
        (global_sfm.py:862-1091): cycle filter and repair, chain walk +
        chordal init, up to 4 rounds of IRLS rotation averaging with the
        homography-ambiguity swap, cycle-casualty redemption and the
        rotation gate, repair again, translation directions refit under the
        averaged rotations, edge scales, walk init and translation
        averaging. The span's counter ``transavg_launches`` is the
        translation-averaging kernel's launches inside it (its host-side
        count, no sync); the child span ``motion_averaging.translation``
        runs from the solve's call to the host copy of its centres, out of
        ``stage_times``."""
        span = self._stage("motion_averaging")
        launches0 = transavg_kernel.launches
        C = self.max_img
        dev = self.device
        w_pre = np.asarray(self._edge_w, np.float64).copy()
        inl_pre = {k: self._edge_inl[k].copy() for k in self._edges}
        self._filter_edges_by_cycles()
        self._repair_connectivity(w_pre, inl_pre, "cycle filter")
        ei = np.asarray([i - 1 for i, _ in self._edges], np.int64)
        ej = np.asarray([j - 1 for _, j in self._edges], np.int64)
        w = np.asarray(self._edge_w, np.float32)
        nz = w > 0

        parent = np.arange(C)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in zip(ei[nz], ej[nz]):
            parent[find(a)] = find(b)
        roots = {find(c) for c in range(C)}
        if len(roots) > 1:
            self.warnings.append(
                f"view graph has {len(roots)} components; "
                "unreached cameras keep identity poses"
            )

        E = len(self._edges)
        Eb = _bucket(E, 128) if E else 0
        eye = np.eye(3, dtype=np.float32)
        ei_j = _pad_edges(self._dev(ei, torch.int64), Eb)
        ej_j = _pad_edges(self._dev(ej, torch.int64), Eb)

        def weights(w):
            return _pad_edges(self._dev((w / max(w.max(), 1e-9)).astype(np.float32)), Eb)

        w_j = weights(w)
        R_rel = _pad_edges(self._dev(self._edge_R), Eb, eye)

        R0 = chain_initial_rotations(self._edge_R[nz].astype(np.float32), ei[nz], ej[nz], C,
                                     device=dev)
        R0 = chordal_rotation_init(R_rel, ei_j, ej_j, R0, edge_w=w_j, num_cameras=C,
                                   cg_iters=min(max(128, 2 * C), 4096))

        R = R0
        banned = np.zeros(E, bool)   # dropped by residual => never restored
        for _round in range(4):
            R = rotation_averaging(R_rel, ei_j, ej_j, R, edge_w=w_j, num_cameras=C,
                                   num_iters=self.rot_avg_iters, eps_final=0.02)
            R_np = R.cpu().numpy().astype(np.float64)
            r_edge = np.linalg.norm(
                np.einsum("eij,ejk->eik", self._edge_R, R_np[ei]) - R_np[ej], axis=(1, 2))
            if not nz.any():
                break
            swapped = []
            for e, (R_a, t_a) in list(self._edge_alt.items()):
                r_alt = np.linalg.norm(R_a @ R_np[ei[e]] - R_np[ej[e]])
                if r_alt < 0.7 * r_edge[e]:
                    self._edge_R[e] = R_a
                    self._edge_t[e] = t_a
                    r_edge[e] = r_alt
                    del self._edge_alt[e]
                    swapped.append(self._edges[e])
            if swapped:
                R_rel = _pad_edges(self._dev(self._edge_R), Eb, eye)
                self.warnings.append(
                    "homography-ambiguity swap on edges: " + ", ".join(map(str, swapped)))
            med = np.median(r_edge[nz])
            gate = max(4.0 * med, 0.15)
            cand = (~nz) & (w_pre > 0) & (r_edge < 0.5 * gate) & ~banned
            bad = nz & (r_edge > gate)
            if not bad.any() and not cand.any():
                break
            if cand.any():
                self.warnings.append(
                    f"restored {int(cand.sum())} cycle-filter casualties: "
                    + ", ".join(str(self._edges[e]) for e in np.nonzero(cand)[0])
                )
                w = np.where(cand, w_pre, w)
                for e in np.nonzero(cand)[0]:
                    k = self._edges[e]
                    self._edge_inl[k] = inl_pre[k]
                self._edge_w = np.where(cand, w_pre, self._edge_w)
            if bad.any():
                self.warnings.append(
                    f"dropped {int(bad.sum())} rotation-inconsistent edges: "
                    + ", ".join(str(self._edges[e]) for e in np.nonzero(bad)[0])
                )
                banned |= bad
                w = np.where(bad, 0.0, w)
                for e in np.nonzero(bad)[0]:
                    k = self._edges[e]
                    self._edge_inl[k] = np.zeros_like(self._edge_inl[k])
                self._edge_w = np.where(bad, 0.0, self._edge_w)
            nz = w > 0
            w_j = weights(w)

        self._repair_connectivity(w_pre, inl_pre, "rotation gate")
        w = np.asarray(self._edge_w, np.float64)
        nz = w > 0
        w_j = weights(w)

        t_pad = None
        if E:
            R_ij_avg = R[ej_j] @ R[ei_j].transpose(-1, -2)
            pgs = [self.pair_geometry[k] for k in self._edges]
            stack = lambda f: self._dev(np.stack([getattr(pg, f) for pg in pgs]))
            p1s = _pad_edges(stack("p1"), Eb)
            p2s = _pad_edges(stack("p2"), Eb)
            K1s = _pad_edges(stack("K1"), Eb, eye)
            K2s = _pad_edges(stack("K2"), Eb, eye)
            inls = _pad_edges(
                self._dev(np.stack([self._edge_inl[k] for k in self._edges]), torch.bool),
                Eb, False)
            t_new, conf = relative_translations_known_rotations(R_ij_avg, p1s, p2s, K1s, K2s, inls)
            self._edge_t = t_new[:E].cpu().numpy()
            w = w * np.clip(conf[:E].cpu().numpy().astype(np.float64), 0.0, 1.0)
            nz = w > 0
            w_j = weights(w)

        Rj = R[ej_j]
        t_pad = _pad_edges(self._dev(self._edge_t), Eb, np.asarray([0, 0, 1], np.float32))
        u = torch.einsum("eji,ej->ei", Rj, t_pad)
        u = u / torch.clamp_min(torch.linalg.norm(u, dim=-1, keepdim=True), 1e-9)
        u_np = u.cpu().numpy()[:E]

        if E:
            z1, z2 = two_view_depths(R_ij_avg, t_pad, p1s, p2s, K1s, K2s)
            lam = self._edge_scales(z1.cpu().numpy()[:E], z2.cpu().numpy()[:E], nz)
        else:
            lam = np.ones(0)

        su = u_np * lam[:, None]
        c0 = chain_initial_centers(su[nz].astype(np.float32), ei[nz], ej[nz], C, device=dev)
        child = self._timer.open("motion_averaging.translation")
        c = translation_averaging(
            u, ei_j, ej_j, c0, edge_w=w_j, num_cameras=C, num_iters=self.trans_avg_iters,
            edge_s=_pad_edges(self._dev(lam), Eb, 1.0),
        )
        self.R_cams, self.c_cams = R.cpu().numpy(), c.cpu().numpy()
        self._timer.close(child, time_as=None)   # the host copy waited for the device
        span.counters["transavg_launches"] = transavg_kernel.launches - launches0
        self._stage_end(span)

    def _edge_scales(self, z1: np.ndarray, z2: np.ndarray, nz: np.ndarray) -> np.ndarray:
        """Relative baseline length per edge from two-view depth ratios along
        shared keypoints: median log-ratios, spanning-tree propagation and
        Gauss-Seidel smoothing; weighted mean 1 (global_sfm.py:1093-1170)."""
        E = len(self._edges)
        pair_idx = {k: (self.pair_geometry[k].idx1, self.pair_geometry[k].idx2)
                    for k in self._edges}
        incident: Dict[int, list] = {}
        for e, k in enumerate(self._edges):
            if not nz[e]:
                continue
            inl = self._edge_inl[k]
            if not inl.any():
                continue
            i, j = k
            idx1, idx2 = pair_idx[k]
            incident.setdefault(i, []).append((e, np.asarray(idx1)[inl], z1[e][inl]))
            incident.setdefault(j, []).append((e, np.asarray(idx2)[inl], z2[e][inl]))

        ratios: list = []          # (e1, e2, median log(z_e1 / z_e2), support)
        for m, lst in incident.items():
            for a in range(len(lst)):
                ea, kpa, za = lst[a]
                for b in range(a + 1, len(lst)):
                    eb, kpb, zb = lst[b]
                    common, ia, ib = np.intersect1d(kpa, kpb, return_indices=True)
                    if len(common) < 5:
                        continue
                    r = za[ia] / np.where(np.abs(zb[ib]) < 1e-9, 1e-9, zb[ib])
                    r = r[np.isfinite(r) & (r > 0)]
                    if len(r) < 5:
                        continue
                    ratios.append((ea, eb, float(np.median(np.log(r))), len(r)))

        log_lam = np.zeros(E)
        if ratios:
            adj: Dict[int, list] = {}
            for ea, eb, lr, wgt in ratios:
                adj.setdefault(ea, []).append((eb, lr, wgt))
                adj.setdefault(eb, []).append((ea, -lr, wgt))
            seen = set()
            order = sorted(adj, key=lambda e: -self._edge_w[e])
            for root in order:
                if root in seen:
                    continue
                seen.add(root)
                queue = [root]
                while queue:
                    cur = queue.pop()
                    for nxt, lr, _ in adj[cur]:
                        if nxt not in seen:
                            log_lam[nxt] = log_lam[cur] + lr
                            seen.add(nxt)
                            queue.append(nxt)
            for _sweep in range(10):   # weighted Gauss-Seidel on the ratio graph
                acc = np.zeros(E)
                wacc = np.zeros(E)
                for ea, eb, lr, wgt in ratios:
                    acc[eb] += wgt * (log_lam[ea] + lr)
                    wacc[eb] += wgt
                    acc[ea] += wgt * (log_lam[eb] - lr)
                    wacc[ea] += wgt
                upd = wacc > 0
                log_lam[upd] = acc[upd] / wacc[upd]

        lam = np.exp(np.clip(log_lam, -6.0, 6.0))
        wsum = self._edge_w[nz].sum()
        if wsum > 0:
            lam /= max((lam[nz] * self._edge_w[nz]).sum() / wsum, 1e-9)
        return lam

    def _build_tracks(self, feats: Features) -> None:
        """Union-find tracks over every pair's inlier matches, then flat
        observation lists from the keypoint table (global_sfm.py:1172-1234)."""
        span = self._stage("tracks")
        C = self.max_img
        cap = feats.keypoints.capacity
        xf_np, yf_np = feats.keypoints.xf.cpu().numpy(), feats.keypoints.yf.cpu().numpy()
        self._kp_xy = {i: np.stack([xf_np[i - 1], yf_np[i - 1]], axis=1).astype(np.float64)
                       for i in range(1, C + 1)}

        ea, eb = [], []
        for k in self._edges:
            inl = self._edge_inl[k]
            if not inl.any():
                continue
            i, j = k
            pg = self.pair_geometry[k]
            ea.append((i - 1) * cap + np.asarray(pg.idx1)[inl])
            eb.append((j - 1) * cap + np.asarray(pg.idx2)[inl])
        ea = np.concatenate(ea) if ea else np.zeros(0, np.int64)
        eb = np.concatenate(eb) if eb else np.zeros(0, np.int64)

        node_image = np.repeat(np.arange(C, dtype=np.int64), cap)
        track_per_node, num_tracks, valid = build_tracks(ea, eb, C * cap, node_image=node_image)

        touched = np.zeros(C * cap, bool)
        touched[ea] = True
        touched[eb] = True
        nodes = np.nonzero(touched)[0]
        tids = track_per_node[nodes]
        keep = valid[tids] if valid is not None else np.ones(len(nodes), bool)
        counts = np.bincount(tids[keep], minlength=num_tracks)
        keep &= counts[tids] >= 2
        nodes, tids = nodes[keep], tids[keep]

        uniq, tids_c = np.unique(tids, return_inverse=True)
        self._num_points = len(uniq)
        self._obs_cam = (nodes // cap).astype(np.int32)
        self._obs_kp = (nodes % cap).astype(np.int32)
        self._obs_pt = tids_c.astype(np.int32)
        xy = np.empty((len(nodes), 2), np.float64)
        for i in range(1, C + 1):
            m = self._obs_cam == (i - 1)
            xy[m] = self._kp_xy[i][self._obs_kp[m]]
        self._obs_xy = xy
        self._stage_end(span)

    def _triangulate(self) -> None:
        """Every track triangulated at once by multiview DLT + GN on the
        device (on the JAX engine's bucketed lists), then observations gated
        on the host by cheirality and reprojection error
        (global_sfm.py:1236-1288)."""
        span = self._stage("triangulate")
        C = self.max_img
        K = np.stack([self._intrinsics(i) for i in range(1, C + 1)])
        R = np.asarray(self.R_cams, np.float64)
        tvec = -np.einsum("cij,cj->ci", R, np.asarray(self.c_cams, np.float64))
        P = K @ np.concatenate([R, tvec[:, :, None]], axis=2)   # (C, 3, 4)
        self._P_all = P
        self._K_all = K
        self._t_cams = tvec

        O = len(self._obs_pt)
        T = self._num_points
        if T == 0:
            self._X = np.zeros((0, 3))
            self._stage_end(span)
            return
        Ob, Tb = _bucket(O), _bucket(T)
        obs_cam = np.zeros(Ob, np.int64); obs_cam[:O] = self._obs_cam
        obs_pt = np.full(Ob, Tb - 1, np.int64); obs_pt[:O] = self._obs_pt
        obs_xy = np.zeros((Ob, 2), np.float32); obs_xy[:O] = self._obs_xy
        w = np.zeros(Ob, np.float32); w[:O] = 1.0
        X, _nobs = triangulate_multiview(
            self._dev(P), self._dev(obs_cam, torch.int64), self._dev(obs_pt, torch.int64),
            self._dev(obs_xy), num_points=Tb, obs_w=self._dev(w), gn_iters=8,
        )
        X = X.cpu().numpy().astype(np.float64)[:T]

        Xo = X[self._obs_pt]
        Ph = P[self._obs_cam]
        h = np.einsum("oij,oj->oi", Ph[:, :, :3], Xo) + Ph[:, :, 3]
        z = h[:, 2]
        uv = h[:, :2] / np.where(np.abs(z[:, None]) < 1e-12, 1e-12, z[:, None])
        err = np.linalg.norm(uv - self._obs_xy, axis=1)
        ok = (z > 1e-6) & (err < self.obs_gate_px)
        cnt = np.bincount(self._obs_pt[ok], minlength=T)
        ok &= cnt[self._obs_pt] >= 2

        uniq, pt_c = np.unique(self._obs_pt[ok], return_inverse=True)
        self._obs_cam = self._obs_cam[ok]
        self._obs_kp = self._obs_kp[ok]
        self._obs_pt = pt_c.astype(np.int32)
        self._obs_xy = self._obs_xy[ok]
        self._X = X[uniq]
        self._num_points = len(uniq)
        self._stage_end(span)

    def _populate_map(self) -> None:
        """Fill the map and pose lists with the incremental engine's result
        contract (global_sfm.py:1290-1308)."""
        C = self.max_img
        self.map.append_points_raw(self._X)
        for c in range(C):
            m = self._obs_cam == c
            if m.any():
                self.map.add_observations(self._obs_pt[m].astype(np.int64), self._obs_xy[m], c)
        rvecs = so3_log(self._dev(self.R_cams)).cpu().numpy().astype(np.float64)
        for c in range(C):
            self.global_poses.append((rvecs[c], self._t_cams[c]))
            self.global_K.append(self._K_all[c])

    def _register_nonkeyframes(self, feats: Features) -> None:
        """Register every non-keyframe against the keyframe map
        (``global_sfm.py:1310-1465``): match each frame to its two nearest
        keyframes and F-filter those pairs, link the inliers to the
        keyframes' tracks, and solve every frame's pose at once; inlier
        observations join the map before the final BA."""
        kfs = self.keyframes
        kf_set = set(kfs)
        non_kf = [f for f in range(1, self.max_img + 1) if f not in kf_set]
        if not non_kf:
            return
        span = self._stage("register")
        reg_pairs = []
        for f in non_kf:
            below = max((k for k in kfs if k < f), default=None)
            above = min((k for k in kfs if k > f), default=None)
            for k in (below, above):
                if k is not None:
                    reg_pairs.append((k, f))
        counts = self._register_frames(feats.keypoints.capacity, non_kf,
                                       self._registration_matches(feats, reg_pairs))
        span.counters.update(frames=len(non_kf), pairs=len(reg_pairs), **counts)
        self._stage_end(span)

    def _registration_matches(self, feats: Features, reg_pairs) -> Dict[tuple, tuple]:
        """(keyframe, frame) pairs matched in one launch and F-filtered in
        one batch; ``{pair: (indices (M, 2), filtered mask (M,), frame
        pixels (M, 2))}`` on the host."""
        rcfg = self.config.ransac
        child = self._timer.open("register.match")
        res, p1, p2 = self._match_pair_list(feats, reg_pairs)
        fres = ransac_fundamental_adaptive_batch(
            self._generator, p1, p2, res.mask, max_hypotheses=rcfg.max_hypotheses(),
            stage_size=rcfg.stage_size, threshold=rcfg.epipolar_threshold,
            confidence=rcfg.prob_success,
        )
        idx_np, filt_np, p2_np = (v.cpu().numpy() for v in (res.indices, fres.inliers, p2))
        self._timer.close(child, time_as=None)   # the host copy waited for the device
        return {k: (idx_np[r], filt_np[r], p2_np[r]) for r, k in enumerate(reg_pairs)}

    def _link_registration(self, capacity: int, non_kf, results: Dict[tuple, tuple]):
        """2D-3D correspondences of the frames ``non_kf`` from their
        registration matches ``results``: each pair's filtered inliers whose
        keyframe keypoint has a surviving track, laid out frame by frame in
        the order of its pairs and their rows, a track seen twice in a frame
        kept at its first occurrence. Returns (X, x, track ids, mask, K),
        each (F, 2M, ...) on the host."""
        kfs = self.keyframes
        # slot -> compacted track id per keyframe (-1: no surviving track)
        slot_track = {k: np.full(capacity, -1, np.int64) for k in kfs}
        obs_img = np.asarray(self._obs_cam, np.int64) + 1
        for k in kfs:
            m = obs_img == k
            if m.any():
                slot_track[k][np.asarray(self._obs_kp)[m]] = np.asarray(self._obs_pt, np.int64)[m]

        M2 = 2 * int(next(iter(results.values()))[0].shape[0])
        F = len(non_kf)
        pts = self.map.points()
        X_all = np.zeros((F, M2, 3), np.float32)
        x_all = np.zeros((F, M2, 2), np.float32)
        t_all = np.full((F, M2), -1, np.int64)
        m_all = np.zeros((F, M2), bool)
        K_all = np.zeros((F, 3, 3), np.float32)
        pairs_of_frame: Dict[int, list] = {}
        for p in results:
            pairs_of_frame.setdefault(p[1], []).append(p)
        for fi, f in enumerate(non_kf):
            K_all[fi] = self._intrinsics(f)
            off = 0
            for k in pairs_of_frame.get(f, ()):
                idx, inl, p2c = results[k]
                tr = slot_track[k[0]][idx[:, 0]]
                sel = inl & (tr >= 0)
                n = int(sel.sum())
                if n:
                    sl = slice(off, off + n)
                    X_all[fi, sl] = pts[tr[sel]]
                    x_all[fi, sl] = p2c[sel]
                    t_all[fi, sl] = tr[sel]
                    m_all[fi, sl] = True
                    off += n
        # Two keyframes can contribute the same track: keep the first.
        for fi in range(F):
            _, first = np.unique(t_all[fi], return_index=True)
            keep = np.zeros(M2, bool)
            keep[first] = True
            m_all[fi] &= keep
        return X_all, x_all, t_all, m_all, K_all

    def _register_frames(self, capacity: int, non_kf, results: Dict[tuple, tuple],
                         uniforms: Optional[torch.Tensor] = None) -> Dict[str, int]:
        """Poses of the frames ``non_kf`` from their registration matches
        ``results``: the 2D-3D pairs of ``_link_registration``, then P3P
        RANSAC at min(512, the PnP hypotheses) vmapped over the frames.
        ``uniforms`` (F, hypotheses, 3) replaces the draw from the engine's
        generator. A frame whose registration fails keeps its nearest
        keyframe's pose. Returns the counts of the ``register`` span: the
        correspondences (``links``), the P3P samples (``pnp_hyps``) and the
        frames that kept a keyframe's pose (``failed``)."""
        kfs = self.keyframes
        child = self._timer.open("register.link")
        X_all, x_all, t_all, m_all, K_all = self._link_registration(capacity, non_kf, results)
        self._timer.close(child, time_as=None)
        F = len(non_kf)

        child = self._timer.open("register.pnp")
        reg_hyp = min(512, self._pnp_hyp)
        if uniforms is None:
            uniforms = torch.rand((F, reg_hyp, 3), generator=self._generator, device=self.device)
        thr = self.config.ransac.pnp_reproj_threshold

        def one(X, x, K, m, u):
            out = pnp_ransac(None, X, x, K, mask=m, num_hypotheses=reg_hyp,
                             reproj_threshold=thr, uniforms=u)
            return so3_log(out.R), out.t, out.inliers, out.ok

        parts = []
        for c0 in range(0, F, _REGISTER_CHUNK):
            sl = slice(c0, c0 + _REGISTER_CHUNK)
            parts.append(torch.func.vmap(one)(
                self._dev(X_all[sl]), self._dev(x_all[sl]), self._dev(K_all[sl]),
                self._dev(m_all[sl], torch.bool), uniforms[sl].to(self.device)))
        rv_np, t_np, inl_np, ok_np = (torch.cat([p[i] for p in parts]).cpu().numpy()
                                      for i in range(4))
        self._timer.close(child, time_as=None)   # the host copy waited for the device
        failed = 0
        for fi, f in enumerate(non_kf):
            cam = f - 1
            if bool(ok_np[fi]) and m_all[fi].sum() >= 6:
                rvec = rv_np[fi].astype(np.float64)
                tv = t_np[fi].astype(np.float64)
                good = inl_np[fi] & m_all[fi]
                self.map.add_observations(np.where(good, t_all[fi], -1),
                                          x_all[fi].astype(np.float64), cam)
            else:
                near = min(kfs, key=lambda k: abs(k - f))
                rvec, tv = self.global_poses[near - 1]
                self.warnings.append(f"frame {f}: PnP registration failed, keyframe pose kept")
                failed += 1
            self.global_poses[cam] = (np.asarray(rvec), np.asarray(tv))
        return dict(links=int(m_all.sum()), pnp_hyps=F * reg_hyp, failed=failed)

    def _stream_ba(self) -> None:
        """The final BA through the advancing-window block store
        (``global_sfm.py:1502-1549``): spill the map to camera blocks in a
        temporary directory, sweep the window over them ``max(2,
        ba_rounds)`` times with a regate between sweeps, read the refined
        state back, each window solve sharded over ``mesh`` when there is
        one. Every rank keeps its own store. No focal self-calibration on
        this path."""
        span = self._stage("ba(stream)")
        frames, tracks, xy = self.map.observations()
        cam_params = np.array([np.hstack([rv, t]) for rv, t in self.global_poses])
        root = tempfile.mkdtemp(prefix="mapblocks_")
        try:
            store = MapBlockStore.build_from_arrays(
                root, cam_params, np.stack(self.global_K).astype(np.float64),
                self.map.points(), frames, tracks, xy, block_cams=self.stream_ba_block_cams)
            ba = self.config.ba
            stats = stream_bundle_adjust(
                store, window_blocks=self.stream_ba_window, sweeps=max(2, self.ba_rounds),
                max_iters=ba.max_lm_iters, cg_iters=60, ftol=ba.ftol,
                huber_delta=ba.huber_delta, regate_px=self.regate_px, device=self.device,
                mesh=self.mesh)
            cams, _ = store.read_cameras()
            ids, xyz = store.read_points()
            pts = self.map.points().copy()
            pts[ids] = xyz
            self.map.update_points(pts)
            self.global_poses = [(np.asarray(c[:3], np.float64), np.asarray(c[3:], np.float64))
                                 for c in cams]
            self.errors_before_after_ba = (stats.initial_error, stats.final_error)
            self.stream_stats = stats
        finally:
            shutil.rmtree(root, ignore_errors=True)
        self._stage_end(span)

    def _ba_rounds(self) -> None:
        """Up to ``ba_rounds`` bundle adjustments with camera 0 frozen (the
        averaging gauge, R = I and c = 0), re-gating the observations
        between them; stops early when a regate drops nothing."""
        err_before = None
        for r in range(self.ba_rounds):
            span = self._stage(f"ba.round{r + 1}")
            self._global_ba(freeze_before=1)
            self._timer.close(span)   # _global_ba's span ended at a synchronize
            if err_before is None:
                err_before = self.errors_before_after_ba[0]
            if r < self.ba_rounds - 1 and self._regate_observations() == 0:
                break
        self.errors_before_after_ba = (err_before, self.errors_before_after_ba[1])

    def _regate_observations(self) -> int:
        """Drop observations whose residual under the post-BA model exceeds
        ``regate_px`` and tracks left with < 2 observations, then rebuild the
        map; returns the number dropped (global_sfm.py:1551-1593)."""
        frames, tracks, xy = self.map.observations()
        pts = self.map.points()
        rvs = np.stack([rv for rv, _ in self.global_poses])
        Rs = so3_exp(self._dev(rvs)).cpu().numpy().astype(np.float64)
        P = np.empty((len(self.global_poses), 3, 4))
        for c, (rv, t) in enumerate(self.global_poses):
            P[c] = self.global_K[c] @ np.concatenate([Rs[c], np.asarray(t)[:, None]], 1)
        Po = P[frames]
        h = np.einsum("oij,oj->oi", Po[:, :, :3], pts[tracks]) + Po[:, :, 3]
        z = np.where(np.abs(h[:, 2]) < 1e-12, 1e-12, h[:, 2])
        err = np.linalg.norm(h[:, :2] / z[:, None] - xy, axis=1)
        ok = (h[:, 2] > 1e-6) & (err < self.regate_px)
        cnt = np.bincount(tracks[ok], minlength=len(pts))
        ok &= cnt[tracks] >= 2
        dropped = int((~ok).sum())
        if dropped == 0:
            return 0
        uniq, tr_c = np.unique(tracks[ok], return_inverse=True)
        new_map = type(self.map)()
        new_map.append_points_raw(pts[uniq])
        fr = frames[ok]
        xy_k = xy[ok]
        for c in range(len(self.global_poses)):
            m = fr == c
            if m.any():
                new_map.add_observations(tr_c[m].astype(np.int64), xy_k[m], c)
        self.map = new_map
        return dropped

    # ------------------------------------------------------------------ run

    def run(self) -> "GlobalSfmEngine":
        with self._timer.run():
            feats = self._extract_all_features()
            self._prepare_pair_selection(feats)
            self._match_pairs(feats)
            self._relative_poses()
            self._motion_averaging()
            self._build_tracks(feats)
            self._triangulate()
            self._populate_map()
            if self.keyframed:
                self._register_nonkeyframes(feats)
            if self.stream_ba_window is not None:
                self._stream_ba()
            else:
                self._ba_rounds()
        if self.model_name is not None and is_writer(self.mesh):
            self.save_data()
        return self
