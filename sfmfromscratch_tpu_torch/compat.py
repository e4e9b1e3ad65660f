"""Reference-compatible class API (counterpart of
``sfmfromscratch_tpu/compat.py``).

numpy-in/numpy-out equivalents of every public class the reference exposes,
with the reference's signatures, implemented on the port's engine:

    from sfmfromscratch_tpu_torch.compat import (
        SFMRunner, FeatureRunner, CameraPose, SensorType, BundleAdjustment,
        NNRatioFeatureMatcher, NaiveSIFT, ScaleRotInvSIFT,
        PoseEstimator, PnPRansac, PnP, V3D,
    )

A user of reesque/SfmFromScratch can switch imports and keep their calling
code; each method cites the reference signature it mirrors. The work runs
on the CUDA card unless the caller passes ``device="cpu"`` (a keyword every
class and function that computes takes): the extractors launch the Harris
kernel, the matcher the matcher kernel. Nothing moves to the CPU on its own.

Where the JAX package takes ``jax.random.key(seed)``, the port seeds a
``torch.Generator`` on the device with the same ``seed``; the RANSAC calls
also take ``uniforms=``, which replaces the draw (a test hands them the
uniforms JAX draws, so both packages score the same hypotheses).
"""

from __future__ import annotations

import abc
import os
from typing import Optional, Tuple

import numpy as np
import torch

from sfmfromscratch_tpu_torch.config import ExtractorConfig, MatcherConfig, PipelineConfig
from sfmfromscratch_tpu_torch.geometry import epipolar as _epi
from sfmfromscratch_tpu_torch.geometry import triangulation as _tri
from sfmfromscratch_tpu_torch.geometry.camera import SensorType, intrinsics_from_exif
from sfmfromscratch_tpu_torch.geometry.pnp import pnp as _pnp, pnp_ransac as _pnp_ransac
from sfmfromscratch_tpu_torch.geometry.ransac import (
    ransac_essential_pose as _ransac_pose,
    ransac_fundamental as _ransac_f,
)
from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_log  # noqa: F401  (so3_log: JAX's name)
from sfmfromscratch_tpu_torch.ops.matcher import match_ratio_test
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.viz.scatter3d import V3D  # re-export (Visualizer.py:7)

__all__ = [
    "SensorType", "CameraPose", "BundleAdjustment", "NNRatioFeatureMatcher",
    "FeatureExtractor", "NaiveSIFT", "ScaleRotInvSIFT",
    "PoseEstimator", "PnPRansac", "PnP", "FeatureRunner", "SFMRunner", "V3D",
    "Matches", "print_reprojection_error", "fast_resize",
]


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``."""
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _np(x: torch.Tensor, dtype=np.float64) -> np.ndarray:
    return x.detach().cpu().numpy().astype(dtype)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


# =============================================================== CameraPose

class CameraPose:
    """Two-view geometry toolbox (reference SFM.py:22-402)."""

    def __init__(self, pts1, pts2, K1, K2, device=None):
        self.pts1 = np.asarray(pts1, dtype=np.float64)
        self.pts2 = np.asarray(pts2, dtype=np.float64)
        self.K1 = np.asarray(K1, dtype=np.float64)
        self.K2 = np.asarray(K2, dtype=np.float64)
        self.device = resolve_device(device)

    # -- robust relative pose (reference SFM.py:38-103) --------------------

    def ransac_camera_motion(self, R_base, T_base, threshold=1.0, max_iterations=1000,
                             seed: int = 5, uniforms=None):
        """Every hypothesis scored at once instead of the reference's loop.
        Accepts any base pose, like the reference signature (SFM.py:38-44):
        the base enters only the cheirality check (SFM.py:105-124). Runs
        ``max_iterations`` hypotheses with every point of the cheirality
        subset in front (``min_cheirality_frac=1.0``). Returns (R, t,
        inlier_pts1, inlier_pts2)."""
        if len(self.pts1) < 8:
            return None, None, None, None
        dev = self.device
        R_base = np.asarray(R_base, dtype=np.float64)
        T_base = np.asarray(T_base, dtype=np.float64).reshape(3)
        canonical = np.allclose(R_base, np.eye(3)) and np.allclose(T_base, 0)
        base_kw = {} if canonical else dict(R_base=_f32(R_base, dev), t_base=_f32(T_base, dev))
        res = _ransac_pose(
            _generator(seed, dev), _f32(self.pts1, dev), _f32(self.pts2, dev),
            _f32(self.K1, dev), _f32(self.K2, dev),
            num_hypotheses=int(max_iterations), threshold=float(threshold),
            min_cheirality_frac=1.0, uniforms=uniforms, **base_kw,
        )
        inl = res.inliers.cpu().numpy()
        return _np(res.R), _np(res.t), self.pts1[inl], self.pts2[inl]

    # -- static helpers ----------------------------------------------------

    @staticmethod
    def find_inliers(p1, p2, threshold=1.0, max_iterations=1000, seed: int = 5,
                     device=None, uniforms=None):
        """Robust F-based inlier filter (reference SFM.py:126-160)."""
        p1 = np.asarray(p1, dtype=np.float64)
        p2 = np.asarray(p2, dtype=np.float64)
        if len(p1) < 8:
            return None, None, None, None
        dev = resolve_device(device)
        res = _ransac_f(_generator(seed, dev), _f32(p1, dev), _f32(p2, dev),
                        num_hypotheses=int(max_iterations), threshold=float(threshold),
                        uniforms=uniforms)
        inl = res.inliers.cpu().numpy()
        return p1[inl], p2[inl]

    @staticmethod
    def normalize_points(points, device=None):
        """Hartley normalization of (N, 3) homogeneous points
        (reference SFM.py:162-178)."""
        pts = np.asarray(points, dtype=np.float64)
        pn, T = _epi.hartley_normalize(_f32(pts[:, :2], resolve_device(device)))
        return _np(pn), _np(T)

    @staticmethod
    def unnormalize_F(F_norm, T_a, T_b):
        """T_b^T F T_a (reference SFM.py:180-182)."""
        return np.asarray(T_b).T @ np.asarray(F_norm) @ np.asarray(T_a)

    @staticmethod
    def calculate_num_ransac_iterations(prob_success, sample_size, ind_prob_correct):
        """(reference SFM.py:184-187)"""
        n = np.log(1 - prob_success) / np.log(1 - ind_prob_correct ** sample_size)
        return int(n)

    @staticmethod
    def _compute_fundamental_matrix(p1, p2, device=None):
        """Normalized 8-point F (reference SFM.py:190-236)."""
        dev = resolve_device(device)
        return _np(_epi.eight_point_fundamental(_f32(p1, dev), _f32(p2, dev)))

    compute_fundamental_matrix = _compute_fundamental_matrix

    @staticmethod
    def triangulate_point(x1, x2, P1, P2, device=None):
        """Single-point DLT (reference SFM.py:238-253). x1/x2 homogeneous 3-vectors."""
        dev = resolve_device(device)
        X = _tri.triangulate_dlt(_f32(np.asarray(x1)[:2], dev)[None],
                                 _f32(np.asarray(x2)[:2], dev)[None],
                                 _f32(P1, dev), _f32(P2, dev))
        return _np(X[0])

    @staticmethod
    def triangulate_points(x1, x2, P1, P2, device=None):
        """Batched Hartley-normalized DLT (reference SFM.py:291-305)."""
        dev = resolve_device(device)
        return _np(_tri.triangulate_normalized(_f32(x1, dev), _f32(x2, dev),
                                               _f32(P1, dev), _f32(P2, dev)))

    @staticmethod
    def non_linear_triangulation(p3d, p1, p2, P1, P2, device=None):
        """Point-only nonlinear refinement (reference SFM.py:255-289), by the
        batched Gauss-Newton of ``refine_points_gn`` instead of scipy LM."""
        dev = resolve_device(device)
        X = _tri.refine_points_gn(_f32(p3d, dev), _f32(p1, dev), _f32(p2, dev),
                                  _f32(P1, dev), _f32(P2, dev), num_iters=10)
        return _np(X)

    @staticmethod
    def calculate_projection_matrix(R, t, K):
        """K [R | t] (reference SFM.py:307-309)."""
        return np.asarray(K) @ np.hstack([np.asarray(R), np.asarray(t).reshape(-1, 1)])

    @staticmethod
    def construct_K(image_path, sensor_type: SensorType):
        """EXIF intrinsics (reference SFM.py:311-374)."""
        return intrinsics_from_exif(image_path, sensor_type)

    @staticmethod
    def compute_euclidean_distance(arr1, arr2):
        """(reference SFM.py:376-382)"""
        arr1 = np.asarray(arr1)
        arr2 = np.asarray(arr2)
        if arr2.shape[0] == 1:
            return np.linalg.norm(arr1 - arr2, axis=1)
        return np.linalg.norm(arr1[:, np.newaxis] - arr2, axis=2)

    @staticmethod
    def project_point(point_3d, R, t, K, device=None):
        """Project one point; R may be a Rodrigues 3-vector
        (reference SFM.py:384-392)."""
        R = np.asarray(R, dtype=np.float64)
        if R.shape == (3,):
            R = _np(so3_exp(_f32(R, resolve_device(device))))
        P = CameraPose.calculate_projection_matrix(R, np.asarray(t).reshape(3), K)
        ph = P @ np.append(np.asarray(point_3d, dtype=np.float64), 1.0)
        return ph[:2] / ph[2]

    @staticmethod
    def compute_reprojection_error(points_3d, points_2d, R, t, K, device=None):
        """Mean pixel error (reference SFM.py:394-402)."""
        proj = np.array([
            CameraPose.project_point(p, R, t, K, device=device) for p in np.asarray(points_3d)
        ])
        return float(np.mean(np.linalg.norm(np.asarray(points_2d) - proj, axis=1)))


# ========================================================= BundleAdjustment

class BundleAdjustment:
    """Global BA (reference SFM.py:405-464), running the engine's LM+Schur."""

    def __init__(self, num_cameras, num_points, camera_indices, point_indices,
                 points_2d, camera_params, points_3d, K_list, device=None):
        self.num_cameras = num_cameras
        self.num_points = num_points
        self.camera_indices = np.asarray(camera_indices)
        self.point_indices = np.asarray(point_indices)
        self.points_2d = np.asarray(points_2d)
        self.camera_params = np.asarray(camera_params)
        self.points_3d = np.asarray(points_3d)
        self.K_list = np.asarray(K_list)
        self.device = resolve_device(device)

    def sparse_bundle_adjustment(self, ftol: float = 1e-2, max_iters: int = 30):
        """Returns (optimized_camera_params (C, 6), optimized_points (P, 3)) —
        the reference's contract (SFM.py:416-435)."""
        from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
        from sfmfromscratch_tpu_torch.ba.problem import make_problem

        problem = make_problem(
            self.camera_params, self.points_3d, self.camera_indices,
            self.point_indices, self.points_2d, self.K_list, device=self.device,
        )
        res = bundle_adjust(problem, max_iters=max_iters, cg_iters=60, ftol=ftol)
        return _np(res.cam_params), _np(res.points)

    @staticmethod
    def project_point(point_3d, R, t, K):
        """(reference SFM.py:437-440)"""
        pc = np.asarray(R) @ np.asarray(point_3d) + np.asarray(t)
        ph = np.asarray(K) @ pc
        return ph[:2] / ph[2]

    def compute_residuals(self, params, num_cameras, num_points, camera_indices,
                          point_indices, points_2d, K_list):
        """Residual vector in the reference's layout (SFM.py:442-464)."""
        from sfmfromscratch_tpu_torch.ba.problem import make_problem, residuals

        cam = params[: num_cameras * 6].reshape(num_cameras, 6)
        pts = params[num_cameras * 6:].reshape(num_points, 3)
        problem = make_problem(cam, pts, camera_indices, point_indices, points_2d, K_list,
                               device=self.device)
        return _np(residuals(problem, problem.cam_params, problem.points)).reshape(-1)


# ===================================================== NNRatioFeatureMatcher

class NNRatioFeatureMatcher:
    """Lowe's-ratio matcher (reference NNRatioFeatureMatcher.py:4-59)."""

    def __init__(self, ratio_threshold=0.8, device=None):
        self.ratio_threshold = ratio_threshold
        self.device = resolve_device(device)

    def match_features_ratio_test(self, features1, features2):
        """Returns (matches (k, 2), confidences (k,)) sorted best-first, the
        reference's contract; one launch of the matcher kernel on the card."""
        res = match_ratio_test(_f32(features1, self.device), _f32(features2, self.device),
                               ratio_threshold=float(self.ratio_threshold))
        n = int(res.mask.sum())
        return _np(res.indices[:n], np.int64), _np(res.confidence[:n])


# ========================================================= FeatureExtractors

class FeatureExtractor(abc.ABC):
    """Strategy interface (reference FeatureExtractor/FeatureExtractor.py:4-21)."""

    def __init__(self, image: np.ndarray, extractor_params: Optional[dict] = None,
                 device=None):
        self.image = np.asarray(image)
        params = dict(extractor_params or {})
        self.num_interest_points = params.get("num_interest_points", 2500)
        self._params = params
        self.device = resolve_device(device)

    @abc.abstractmethod
    def detect_keypoints(self) -> Tuple[np.ndarray, np.ndarray]: ...

    @abc.abstractmethod
    def extract_descriptors(self) -> np.ndarray: ...


class NaiveSIFT(FeatureExtractor):
    """Single-scale Harris + RootSIFT (reference NaiveSIFT.py:9-213): one
    Harris launch on the card."""

    _ROTATION_INVARIANT = False

    def __init__(self, image_bw, extractor_params: Optional[dict] = None, device=None):
        super().__init__(image_bw, extractor_params, device)
        defaults = ExtractorConfig()
        p = self._params
        self._cfg = ExtractorConfig(
            num_interest_points=self.num_interest_points,
            ksize=p.get("ksize", defaults.ksize),
            gaussian_size=p.get("gaussian_size", defaults.gaussian_size),
            sigma=p.get("sigma", defaults.sigma),
            alpha=p.get("alpha", defaults.alpha),
            feature_width=p.get("feature_width", defaults.feature_width),
            pyramid_level=p.get("pyramid_level", defaults.pyramid_level),
            pyramid_scale_factor=p.get("pyramid_scale_factor", defaults.pyramid_scale_factor),
        )
        self._feats = None

    def _compute(self):
        if self._feats is None:
            from sfmfromscratch_tpu_torch.pipeline.frontend import extract_features_single_scale

            self._feats = extract_features_single_scale(
                _f32(self.image, self.device), self._cfg,
                rotation_invariant=self._ROTATION_INVARIANT,
            )
        return self._feats

    def detect_keypoints(self):
        f = self._compute()
        n = int(f.keypoints.mask.sum())
        return _np(f.keypoints.x[:n], np.int64), _np(f.keypoints.y[:n], np.int64)

    def extract_descriptors(self):
        f = self._compute()
        n = int(f.keypoints.mask.sum())
        return _np(f.descriptors[:n])


class ScaleRotInvSIFT(NaiveSIFT):
    """Pyramid + rotation-invariant SIFT (reference ScaleRotInvSIFT.py:8-115),
    one Harris launch per pyramid level; computes eagerly in the constructor
    like the reference (:15-16)."""

    _ROTATION_INVARIANT = True

    def __init__(self, image_bw, extractor_params: Optional[dict] = None, device=None):
        super().__init__(image_bw, extractor_params, device)
        self._compute()

    def _compute(self):
        if self._feats is None:
            from sfmfromscratch_tpu_torch.pipeline.frontend import extract_features

            self._feats = extract_features(_f32(self.image, self.device), self._cfg)
        return self._feats


# ============================================================ PoseEstimators

class PoseEstimator(abc.ABC):
    """2D-3D pose strategy (reference PoseEstimator.py:7-29): estimates in the
    constructor, exposes .R/.t/.inliers. ``device`` is taken from the
    keywords (the card when absent)."""

    def __init__(self, points3d: np.ndarray, points2d: np.ndarray, **kwargs):
        self._points3d = np.asarray(points3d)
        self._points2d = np.asarray(points2d)
        self.device = resolve_device(kwargs.pop("device", None))
        self.R = None
        self.t = None
        self.inliers = None
        self._estimate(**kwargs)

    @abc.abstractmethod
    def _estimate(self, **kwargs): ...


class PnPRansac(PoseEstimator):
    """Robust PnP (reference PoseEstimator.py:32-69): P3P hypotheses,
    reprojection gate 8 px, ``ransac_max_it`` hypotheses (100 by default)."""

    def _estimate(self, **kwargs):
        if self._points3d.shape[0] < 4 or self._points2d.shape[0] < 4:
            return
        dev = self.device
        res = _pnp_ransac(
            _generator(kwargs.get("seed", 5), dev),
            _f32(self._points3d, dev), _f32(self._points2d, dev), _f32(kwargs.get("K"), dev),
            num_hypotheses=int(kwargs.get("ransac_max_it", 100)),
            reproj_threshold=float(kwargs.get("reprojection_error", 8.0)),
            uniforms=kwargs.get("uniforms"),
        )
        if not bool(res.ok):
            return
        self.R = _np(res.R)
        self.t = _np(res.t).reshape(3, 1)
        self.inliers = np.nonzero(res.inliers.cpu().numpy())[0].reshape(-1, 1)


class PnP(PoseEstimator):
    """Non-robust PnP (reference PoseEstimator.py:71-105)."""

    def _estimate(self, **kwargs):
        if self._points3d.shape[0] < 4 or self._points2d.shape[0] < 4:
            return
        dev = self.device
        res = _pnp(_f32(self._points3d, dev), _f32(self._points2d, dev),
                   _f32(kwargs.get("K"), dev))
        if not bool(res.ok):
            return
        self.R = _np(res.R)
        self.t = _np(res.t).reshape(3, 1)


# ================================================================= Runners

def FeatureRunner(im1_path, im2_path, scale_factor: float = 0.5,
                  feature_extractor_class=None, extractor_params: Optional[dict] = None,
                  match_threshold: float = 0.8, print_img: bool = False,
                  print_features: bool = False, print_matches: bool = False,
                  output_dir: str = "output", device=None, **_ignored):
    """Two-view pipeline (reference Runner.py:22-115): both images through
    the pyramid front end, one matcher launch. Returns the engine's
    FeatureRunner dataclass, which carries .matches/.features1/.features2.

    The debug-render flags mirror the reference (Runner.py:68-73): they write
    the grayscale inputs, the interest-point figure, and the correspondence
    figure into ``output_dir``."""
    from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner as _FR

    cfg = ExtractorConfig.from_params_dict(extractor_params or {})
    fr = _FR.run(
        im1_path, im2_path, cfg,
        MatcherConfig(ratio_threshold=match_threshold, max_matches=cfg.num_interest_points),
        scale_factor=scale_factor, device=device,
    )
    if print_img or print_features or print_matches:
        from sfmfromscratch_tpu_torch.io.images import save_image
        from sfmfromscratch_tpu_torch.viz.overlays import save_feature_figure, save_match_figure

        os.makedirs(output_dir, exist_ok=True)
        g1 = fr.image1_bw.cpu().numpy()
        g2 = fr.image2_bw.cpu().numpy()
        if print_img:          # reference print_image (Runner.py:75-81)
            save_image(os.path.join(output_dir, "image1_bw.jpg"), g1)
            save_image(os.path.join(output_dir, "image2_bw.jpg"), g2)
        if print_features:     # reference print_features (Runner.py:83-98)
            save_feature_figure(os.path.join(output_dir, "features.jpg"),
                                g1, g2, fr.features1, fr.features2)
        if print_matches:      # reference print_matches (Runner.py:100-115)
            save_match_figure(os.path.join(output_dir, "matches.jpg"),
                              g1, g2, fr.features1, fr.features2, fr.matches)
    return fr


class SFMRunner:
    """Incremental SfM pipeline (reference Runner.py:128-416): runs the whole
    reconstruction in the constructor (``SfmEngine`` on ``device``, at the
    reference's fixed 0.5 prescale), saving ``output/<model>.npz`` when
    ``model_name`` is given; ``SFMRunner.load`` re-opens the viewer.
    ``pose_estimator`` and ``feature_extractor_class`` are accepted and
    ignored, as in the JAX package."""

    def __init__(self, img_path, max_img, extractor_params, match_threshold=0.85,
                 pose_estimator=None, feature_extractor_class=None,
                 dist_threshold=5.0, single_K=None, camera_sensor=None,
                 model_name=None, output_dir="output", device=None):
        from sfmfromscratch_tpu_torch.config import BundleAdjustConfig, RansacConfig
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        ecfg = ExtractorConfig.from_params_dict(extractor_params or {})
        cfg = PipelineConfig(
            extractor=ecfg,
            matcher=MatcherConfig(ratio_threshold=match_threshold,
                                  max_matches=ecfg.num_interest_points),
            ransac=RansacConfig(),
            ba=BundleAdjustConfig(),
            scale_factor=0.5,
            dist_threshold=dist_threshold,
        )
        self.engine = SfmEngine(
            img_path, max_img, config=cfg, single_K=single_K,
            camera_sensor=camera_sensor, model_name=model_name,
            output_dir=output_dir, device=device,
        )
        frames, tracks, xy = self.engine.map.observations()
        self.global_points_3D = self.engine.map.points().tolist()
        self.global_points_2D = xy.tolist()
        self.frame_indices = frames.tolist()
        self.point_indices = tracks.tolist()
        self.global_poses = [
            (np.asarray(rv).reshape(3, 1), np.asarray(t)) for rv, t in self.engine.global_poses
        ]
        self.global_K = list(self.engine.global_K)

    def save_data(self):
        return self.engine.save_data()

    @staticmethod
    def load(model_name, output_dir="output", show=True):
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        return SfmEngine.load(model_name, output_dir=output_dir, show=show)


# =============================================================== Matches, Util

class Matches:
    """Per-pair match container (reference Runner.py:118-125)."""

    def __init__(self, matches, confidences, p1, p2, K1=None, K2=None):
        self.matches = np.asarray(matches)
        self.confidences = np.asarray(confidences)
        self.p1 = np.asarray(p1)
        self.p2 = np.asarray(p2)
        self.K1 = K1
        self.K2 = K2


def print_reprojection_error(points_3d, pts1, pts2, P1, P2, device=None) -> float:
    """Mean two-view reprojection error, printed (reference Util.py:65-82);
    also returns the value."""
    from sfmfromscratch_tpu_torch.geometry.camera import two_view_reprojection_error

    dev = resolve_device(device)
    err = float(two_view_reprojection_error(
        _f32(points_3d, dev), _f32(pts1, dev), _f32(pts2, dev), _f32(P1, dev), _f32(P2, dev)))
    print(f"Mean reprojection error: {err}")
    return err


def fast_resize(input_folder, output_folder, ratio=0.3, exif=True):
    """Batch dataset resize with EXIF transfer (reference Util.py:7-63)."""
    from sfmfromscratch_tpu_torch.io.images import fast_resize as _fr

    return _fr(input_folder, output_folder, ratio=ratio, exif=exif)
