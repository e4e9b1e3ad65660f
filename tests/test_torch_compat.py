"""The port's reference class API (``compat.py``) against the JAX package's,
on the CPU.

Every class and function of the JAX ``compat.__all__`` runs in both packages
on the same numpy inputs made from a seed. RANSAC calls take the uniforms
JAX draws from ``jax.random.key(seed)`` through the port's ``uniforms=``, so
both packages score the same hypotheses. Each tolerance is stated where it
is used.
"""

import numpy as np
import jax
import pytest
import torch

from sfmfromscratch_tpu import compat as J
from sfmfromscratch_tpu_torch import compat as T
from tests.conftest import synthetic_scene

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _u(seed, shape):
    """The uniforms JAX's RANSAC draws from ``jax.random.key(seed)``."""
    return torch.as_tensor(np.array(jax.random.uniform(jax.random.key(seed), shape)))


def _angle_deg(Ra, Rb):
    dR = np.asarray(Ra) @ np.asarray(Rb).T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


def test_compat_names_match_jax():
    """Every name of the JAX ``compat.__all__`` has a counterpart of the same
    kind in the port's."""
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        assert isinstance(getattr(T, name), type) == isinstance(getattr(J, name), type), name


def _noncanonical_scene(rng, n=60):
    """``tests/test_compat.py::test_camera_pose_ransac_noncanonical_base``'s
    scene: a base camera rotated by ``Rb``, points in front of both."""
    from scipy.spatial.transform import Rotation

    Rb = Rotation.from_rotvec([0.05, 0.3, -0.04]).as_matrix()
    R2 = Rotation.from_rotvec([0.02, 0.55, 0.01]).as_matrix()
    t2 = np.array([-0.9, 0.06, 0.12])
    K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(5.0, 9.0, n)], axis=1)

    def project(R, t):
        p = (X @ R.T + t) @ K.T
        return p[:, :2] / p[:, 2:3]

    return dict(p1=project(Rb, np.zeros(3)), p2=project(R2, t2), K=K, Rb=Rb, tb=np.zeros(3),
                R2=R2, t2=t2)


@pytest.mark.parametrize("base", ["canonical", "noncanonical"])
def test_ransac_camera_motion_matches_jax(base, rng):
    """``CameraPose.ransac_camera_motion`` with the canonical base and with a
    rotated one (the base enters only the cheirality check): on the JAX
    uniforms the same inlier set, R and the unit t within 1e-4 of JAX's
    (float32 SVDs of the same systems); both within 2 degrees of the truth
    (the relative rotation R2 R_base^T for the rotated base)."""
    if base == "canonical":
        sc = synthetic_scene(rng)
        Rb, tb, R_true = np.eye(3), np.zeros(3), sc["R2"]
    else:
        sc = _noncanonical_scene(rng)
        Rb, tb, R_true = sc["Rb"], sc["tb"], sc["R2"] @ sc["Rb"].T
    ref = J.CameraPose(sc["p1"], sc["p2"], sc["K"], sc["K"]).ransac_camera_motion(
        Rb, tb, max_iterations=400, seed=5)
    got = T.CameraPose(sc["p1"], sc["p2"], sc["K"], sc["K"], device="cpu").ransac_camera_motion(
        Rb, tb, max_iterations=400, seed=5, uniforms=_u(5, (400, 8)))
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    assert _angle_deg(got[0], R_true) < 2.0 and len(got[2]) > 40
    short = T.CameraPose(np.zeros((5, 2)), np.zeros((5, 2)), np.eye(3), np.eye(3), device="cpu")
    assert short.ransac_camera_motion(np.eye(3), np.zeros(3)) == (None, None, None, None)


def test_ransac_essential_pose_base_matches_jax(rng):
    """``geometry/ransac.py::ransac_essential_pose`` with ``R_base`` and
    ``t_base`` (a base with a translation too) against JAX's on the same
    uniforms: the same inliers and cheirality flag, R and t within 1e-4."""
    from sfmfromscratch_tpu.geometry.ransac import ransac_essential_pose as jpose
    from sfmfromscratch_tpu_torch.geometry.ransac import ransac_essential_pose as tpose

    sc = _noncanonical_scene(rng)
    tb = np.array([0.2, -0.1, 0.05])
    kw = dict(num_hypotheses=256, threshold=1.0, min_cheirality_frac=0.9)
    f = lambda a: np.asarray(a, np.float32)
    ref = jpose(jax.random.key(3), f(sc["p1"]), f(sc["p2"]), f(sc["K"]), f(sc["K"]),
                R_base=f(sc["Rb"]), t_base=f(tb), **kw)
    t = lambda a: torch.as_tensor(f(a))
    got = tpose(None, t(sc["p1"]), t(sc["p2"]), t(sc["K"]), t(sc["K"]), R_base=t(sc["Rb"]),
                t_base=t(tb), uniforms=_u(3, (256, 8)), **kw)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert bool(got.cheirality_ok) == bool(ref.cheirality_ok)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)


def test_find_inliers_matches_jax(scene):
    """F-RANSAC inlier filter with 20 outliers, on the JAX uniforms: the same
    inlier points."""
    p2 = scene["p2"].copy()
    p2[-20:] += 80.0
    ref = J.CameraPose.find_inliers(scene["p1"], p2, max_iterations=400)
    got = T.CameraPose.find_inliers(scene["p1"], p2, max_iterations=400, device="cpu",
                                    uniforms=_u(5, (400, 8)))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert 30 <= len(got[0]) <= len(scene["p1"]) - 15
    assert T.CameraPose.find_inliers(scene["p1"][:5], p2[:5], device="cpu") == (None,) * 4


def test_eight_point_and_normalization_match_jax(scene):
    """Hartley normalization (points and T) within 1e-5; the 8-point F on
    eight correspondences, scaled to unit Frobenius norm and sign, within
    1e-3 of JAX's (``test_torch_geometry.py``'s batched tolerance: a minimal
    8x9 system in float32), with the ninth point's epipolar distance under
    2 px; ``unnormalize_F`` bit-equal (numpy in both)."""
    pts = np.hstack([scene["p1"], np.ones((len(scene["p1"]), 1))])
    for g, r in zip(T.CameraPose.normalize_points(pts, device="cpu"),
                    J.CameraPose.normalize_points(pts)):
        np.testing.assert_allclose(g, r, atol=1e-5)
    ref = J.CameraPose._compute_fundamental_matrix(scene["p1"][:8], scene["p2"][:8])
    got = T.CameraPose.compute_fundamental_matrix(scene["p1"][:8], scene["p2"][:8], device="cpu")
    unit = lambda F: F / np.linalg.norm(F) * np.sign(F[2, 2])
    np.testing.assert_allclose(unit(got), unit(ref), atol=1e-3)
    line = got @ np.append(scene["p1"][8], 1.0)
    assert abs(line @ np.append(scene["p2"][8], 1.0)) / np.hypot(line[0], line[1]) < 2.0
    Ta, Tb = np.diag([2.0, 3.0, 1.0]), np.eye(3) * 0.5
    np.testing.assert_array_equal(T.CameraPose.unnormalize_F(ref, Ta, Tb),
                                  J.CameraPose.unnormalize_F(ref, Ta, Tb))


def test_triangulation_matches_jax(scene):
    """``triangulate_point`` (DLT), ``triangulate_points`` (the Hartley-
    normalized DLT, ``geometry/triangulation.py::triangulate_normalized``) and
    ``non_linear_triangulation`` (10 Gauss-Newton steps) within 1e-4 of
    JAX's on exact projections (float32 SVDs, points 4-9 units away), and
    within 0.05 of the truth."""
    P1 = T.CameraPose.calculate_projection_matrix(scene["R1"], scene["t1"], scene["K"])
    P2 = T.CameraPose.calculate_projection_matrix(scene["R2"], scene["t2"], scene["K"])
    np.testing.assert_array_equal(
        P2, J.CameraPose.calculate_projection_matrix(scene["R2"], scene["t2"], scene["K"]))
    x1, x2 = np.append(scene["p1"][0], 1), np.append(scene["p2"][0], 1)
    np.testing.assert_allclose(T.CameraPose.triangulate_point(x1, x2, P1, P2, device="cpu"),
                               J.CameraPose.triangulate_point(x1, x2, P1, P2), atol=1e-4)
    X = T.CameraPose.triangulate_points(scene["p1"], scene["p2"], P1, P2, device="cpu")
    np.testing.assert_allclose(X, J.CameraPose.triangulate_points(scene["p1"], scene["p2"], P1, P2),
                               atol=1e-4)
    np.testing.assert_allclose(X, scene["X"], atol=0.05)
    noisy = X + np.random.default_rng(4).normal(0, 0.02, X.shape)
    got = T.CameraPose.non_linear_triangulation(noisy, scene["p1"], scene["p2"], P1, P2,
                                                device="cpu")
    ref = J.CameraPose.non_linear_triangulation(noisy, scene["p1"], scene["p2"], P1, P2)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, scene["X"], atol=0.05)


def test_projection_helpers_match_jax(scene, tmp_path):
    """The numpy helpers give JAX's values bit for bit; ``project_point``
    with a Rodrigues vector (``so3_exp`` in float32) within 1e-3 px, and
    ``compute_reprojection_error`` within 1e-4 px; ``construct_K`` reads the
    same EXIF intrinsics."""
    from scipy.spatial.transform import Rotation

    from tests.render import write_sequence

    assert T.CameraPose.calculate_num_ransac_iterations(0.98, 8, 0.4) == \
        J.CameraPose.calculate_num_ransac_iterations(0.98, 8, 0.4) == 5967
    a, b = scene["p1"][:5], scene["p2"][:7]
    np.testing.assert_array_equal(T.CameraPose.compute_euclidean_distance(a, b),
                                  J.CameraPose.compute_euclidean_distance(a, b))
    np.testing.assert_array_equal(T.CameraPose.compute_euclidean_distance(a, b[:1]),
                                  J.CameraPose.compute_euclidean_distance(a, b[:1]))
    rv = Rotation.from_matrix(scene["R2"]).as_rotvec()
    for R in (rv, scene["R2"]):
        got = T.CameraPose.project_point(scene["X"][0], R, scene["t2"], scene["K"], device="cpu")
        ref = J.CameraPose.project_point(scene["X"][0], R, scene["t2"], scene["K"])
        np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got, scene["p2"][0], atol=0.1)
    got = T.CameraPose.compute_reprojection_error(scene["X"], scene["p2"], rv, scene["t2"],
                                                  scene["K"], device="cpu")
    ref = J.CameraPose.compute_reprojection_error(scene["X"], scene["p2"], rv, scene["t2"],
                                                  scene["K"])
    assert abs(got - ref) <= 1e-4 and got < 0.1
    np.testing.assert_array_equal(
        T.BundleAdjustment.project_point(scene["X"][0], scene["R2"], scene["t2"], scene["K"]),
        J.BundleAdjustment.project_point(scene["X"][0], scene["R2"], scene["t2"], scene["K"]))
    write_sequence(str(tmp_path), [np.zeros((40, 60), np.float32)], exif_focal_mm=24.0)
    path = str(tmp_path / "1.jpg")
    np.testing.assert_array_equal(T.CameraPose.construct_K(path, T.SensorType.CROP_FRAME),
                                  J.CameraPose.construct_K(path, J.SensorType.CROP_FRAME))


def test_bundle_adjustment_matches_jax(rng):
    """``sparse_bundle_adjustment`` on ``tests/test_ba.py``'s 3-camera,
    40-point problem (2% perturbation), unpadded in both packages: the
    reprojection RMS of both results within 1e-3 px, and cameras and points
    within 1e-3 of JAX's (float32 LM to ftol 1e-6); ``compute_residuals`` on
    the same parameters within 1e-4 px."""
    from tests.test_ba import _multi_view_problem

    problem, _, _ = _multi_view_problem(rng, num_cams=3, num_pts=40, perturb=0.02)
    args = dict(num_cameras=problem.num_cameras, num_points=problem.num_points,
                camera_indices=np.asarray(problem.obs_cam), point_indices=np.asarray(problem.obs_pt),
                points_2d=np.asarray(problem.obs_xy), camera_params=np.asarray(problem.cam_params),
                points_3d=np.asarray(problem.points), K_list=np.asarray(problem.K))
    ba_t, ba_j = T.BundleAdjustment(**args, device="cpu"), J.BundleAdjustment(**args)
    cams_t, pts_t = ba_t.sparse_bundle_adjustment(ftol=1e-6)
    cams_j, pts_j = ba_j.sparse_bundle_adjustment(ftol=1e-6)
    assert cams_t.shape == (3, 6) and pts_t.shape == (40, 3)
    rest = (3, 40, args["camera_indices"], args["point_indices"], args["points_2d"], args["K_list"])
    r_t = ba_t.compute_residuals(np.hstack([cams_t.ravel(), pts_t.ravel()]), *rest)
    r_j = ba_j.compute_residuals(np.hstack([cams_j.ravel(), pts_j.ravel()]), *rest)
    assert r_t.shape == (2 * len(args["camera_indices"]),)
    rms_t, rms_j = np.sqrt(np.mean(r_t ** 2)), np.sqrt(np.mean(r_j ** 2))
    assert abs(rms_t - rms_j) <= 1e-3 and rms_t < 2.0, (rms_t, rms_j)
    np.testing.assert_allclose(cams_t, cams_j, atol=1e-3)
    np.testing.assert_allclose(pts_t, pts_j, atol=1e-3)
    same = np.hstack([cams_j.ravel(), pts_j.ravel()])
    np.testing.assert_allclose(ba_t.compute_residuals(same, *rest),
                               ba_j.compute_residuals(same, *rest), atol=1e-4)


def test_matcher_matches_jax():
    """``match_features_ratio_test`` on RootSIFT-like descriptors: the same
    matches in the same order, confidences within 1e-5."""
    r = np.random.default_rng(12)
    d1 = r.uniform(0, 1, (60, 128)).astype(np.float32)
    d2 = np.concatenate([d1[:30] + r.normal(0, 0.05, (30, 128)),
                         r.uniform(0, 1, (40, 128))]).astype(np.float32)
    got = T.NNRatioFeatureMatcher(0.82, device="cpu").match_features_ratio_test(d1, d2)
    ref = J.NNRatioFeatureMatcher(0.82).match_features_ratio_test(d1, d2)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    assert got[0].dtype == np.int64 and len(got[0]) >= 25 and (np.diff(got[1]) >= -1e-6).all()


def _extractor_image():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 0.2, (80, 100)).astype(np.float32)
    img[30:42, 40:52] += 0.7
    img[10:18, 70:80] += 0.5
    return img


@pytest.mark.parametrize("cls, params", [
    ("NaiveSIFT", {"num_interest_points": 50, "ksize": 3, "feature_width": 16}),
    ("ScaleRotInvSIFT", {"num_interest_points": 60, "pyramid_level": 2,
                         "pyramid_scale_factor": 1.3, "ksize": 3}),
])
def test_extractors_match_jax(cls, params):
    """``detect_keypoints`` and ``extract_descriptors``: the same keypoints
    (Harris responses agree to ~1e-7 of their range), and at least 97% of
    the descriptor rows within 1e-4 of JAX's (``test_torch_ops.py``'s SIFT
    share: an ulp in ``arctan2`` moves a pixel to the next bin)."""
    img = _extractor_image()
    got = getattr(T, cls)(img, params, device="cpu")
    ref = getattr(J, cls)(img, params)
    (xg, yg), (xr, yr) = got.detect_keypoints(), ref.detect_keypoints()
    np.testing.assert_array_equal(xg, xr)
    np.testing.assert_array_equal(yg, yr)
    assert xg.dtype == np.int64 and len(xg) > 10
    dg, dr = got.extract_descriptors(), ref.extract_descriptors()
    assert dg.shape == dr.shape == (len(xg), 128)
    assert np.all(np.abs(dg - dr) <= 1e-4, axis=1).mean() >= 0.97


def test_pnp_matches_jax(scene):
    """``PnPRansac`` (P3P, 300 hypotheses on the JAX uniforms) and ``PnP``
    (DLT + LM): R and t within 1e-3 of JAX's (float32 LM polish), the same
    inliers; R within 1 degree of the truth. Fewer than 4 points leave the
    pose unset, the reference's contract (PoseEstimator.py:50-51)."""
    X, x = scene["X"].astype(np.float32), scene["p2"].astype(np.float32)
    got = T.PnPRansac(X, x, K=scene["K"], ransac_max_it=300, device="cpu",
                      uniforms=_u(5, (300, 3)))
    ref = J.PnPRansac(X, x, K=scene["K"], ransac_max_it=300)
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=1e-3)
    np.testing.assert_array_equal(got.inliers, ref.inliers)
    assert got.t.shape == (3, 1) and _angle_deg(got.R, scene["R2"]) < 1.0
    got, ref = T.PnP(X, x, K=scene["K"], device="cpu"), J.PnP(X, x, K=scene["K"])
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=1e-3)
    few = T.PnPRansac(np.zeros((3, 3), np.float32), np.zeros((3, 2), np.float32), K=np.eye(3),
                      device="cpu")
    assert few.R is None and few.t is None and few.inliers is None


def test_feature_runner_matches_jax(tmp_path, rng):
    """The compat ``FeatureRunner`` on two files: the same match set as
    JAX's (Jaccard at least 0.95: a ratio near the threshold may flip on SIFT
    ulps), and the reference's debug renders written (Runner.py:68-73)."""
    from PIL import Image

    img = (rng.uniform(0, 0.3, (64, 80, 3)) * 255).astype(np.uint8)
    img[20:30, 30:40] += 150
    img[40:50, 10:22] += 90
    p1, p2 = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    Image.fromarray(img).save(p1)
    Image.fromarray(np.roll(img, 3, axis=1)).save(p2)
    kw = dict(scale_factor=1.0, match_threshold=0.99,
              extractor_params={"num_interest_points": 40, "ksize": 3, "pyramid_level": 1,
                                "feature_width": 16, "sigma": 3.0})
    out = tmp_path / "out"
    got = T.FeatureRunner(p1, p2, print_img=True, print_features=True, print_matches=True,
                          output_dir=str(out), device="cpu", **kw)
    ref = J.FeatureRunner(p1, p2, **kw)

    def match_set(fr):
        idx, m = np.asarray(fr.matches.indices), np.asarray(fr.matches.mask)
        return {tuple(r) for r, v in zip(idx.tolist(), m) if v}

    a, b = match_set(got), match_set(ref)
    assert len(a) > 5 and len(a & b) >= 0.95 * len(a | b)
    for name in ("image1_bw.jpg", "image2_bw.jpg", "features.jpg", "matches.jpg"):
        assert (out / name).exists(), name


@pytest.fixture(scope="module")
def runner_seq(tmp_path_factory):
    """``tests/test_compat.py::test_sfmrunner_compat_end_to_end``'s 3-view
    sequence (160x220, f=300), and K at the 0.5 prescale."""
    from tests.render import render_sequence, write_sequence

    images, K, poses, _ = render_sequence(
        np.random.default_rng(21), num_views=3, num_points=90, img_hw=(160, 220), f=300.0,
        step_t=(-0.2, 0.02, 0.03), step_r=(0.008, -0.02, 0.005))
    d = tmp_path_factory.mktemp("seq")
    write_sequence(str(d), images)
    K_half = K.copy()
    K_half[:2] *= 0.5
    return str(d), K_half


def test_sfmrunner_matches_jax(runner_seq, tmp_path):
    """``SFMRunner`` with the reference constructor at that test's settings
    in both packages (each draws its own RANSAC samples at seed 5): the same
    reference-style attributes; 2 poses each, track counts within 15% and
    post-BA errors within 0.08 px of each other (``test_torch_engine.py``'s
    spreads on this scene); the saved model loads as the same arrays, and
    ``load(show=True)`` opens the viewer."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    d, K = runner_seq
    params = {"num_interest_points": 300, "ksize": 3, "feature_width": 16,
              "pyramid_level": 2, "pyramid_scale_factor": 1.2, "sigma": 3.0}
    got = T.SFMRunner(d, 3, params, match_threshold=0.85, single_K=K, model_name="t",
                      output_dir=str(tmp_path), device="cpu")
    ref = J.SFMRunner(d, 3, params, match_threshold=0.85, single_K=K, model_name="j",
                      output_dir=str(tmp_path))
    assert len(got.global_poses) == len(ref.global_poses) == 2
    assert got.global_poses[0][0].shape == (3, 1)
    assert len(got.global_points_2D) == len(got.frame_indices) == len(got.point_indices)
    n_t, n_j = len(got.global_points_3D), len(ref.global_points_3D)
    assert abs(n_t - n_j) <= 0.15 * n_j, (n_t, n_j)
    e_t, e_j = got.engine.errors_before_after_ba[1], ref.engine.errors_before_after_ba[1]
    assert abs(e_t - e_j) <= 0.08, (e_t, e_j)
    dt = T.SFMRunner.load("t", output_dir=str(tmp_path), show=False)
    dj = J.SFMRunner.load("j", output_dir=str(tmp_path), show=False)
    assert sorted(dt) == sorted(dj) and dt["p3d"].shape == (n_t, 3)
    viewer = T.SFMRunner.load("t", output_dir=str(tmp_path))
    assert isinstance(viewer, T.V3D) and viewer.points_3d.shape == (n_t, 3)


def test_matches_record_and_util_match_jax(scene, capsys, tmp_path):
    """``Matches`` keeps the same fields; ``print_reprojection_error`` prints
    and returns JAX's value within 1e-5 px; ``fast_resize`` writes the same
    image sizes."""
    from PIL import Image

    args = (np.array([[0, 1]]), np.array([0.9]), np.array([[1.0, 2.0]]), np.array([[3.0, 4.0]]))
    mt, mj = T.Matches(*args), J.Matches(*args)
    for f in ("matches", "confidences", "p1", "p2", "K1", "K2"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
    K = scene["K"]
    P1 = K @ np.concatenate([scene["R1"], scene["t1"][:, None]], axis=1)
    P2 = K @ np.concatenate([scene["R2"], scene["t2"][:, None]], axis=1)
    noisy = scene["X"] + np.random.default_rng(6).normal(0, 0.01, scene["X"].shape)
    got = T.print_reprojection_error(noisy, scene["p1"], scene["p2"], P1, P2, device="cpu")
    ref = J.print_reprojection_error(noisy, scene["p1"], scene["p2"], P1, P2)
    assert "Mean reprojection error" in capsys.readouterr().out
    assert abs(got - ref) <= 1e-5 and got > 0.1
    src = tmp_path / "in"
    src.mkdir()
    Image.new("RGB", (100, 80)).save(src / "a.jpg")
    T.fast_resize(str(src), str(tmp_path / "t"), ratio=0.5, exif=False)
    J.fast_resize(str(src), str(tmp_path / "j"), ratio=0.5, exif=False)
    with Image.open(tmp_path / "t" / "a.jpg") as a, Image.open(tmp_path / "j" / "a.jpg") as b:
        assert a.size == b.size == (50, 40)


def test_compat_runs_on_the_card_unless_cpu(monkeypatch, scene):
    """Without a CUDA card every compat entry point that computes raises
    unless it is given ``device="cpu"``; none moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _extractor_image()
    calls = [
        lambda: T.CameraPose(scene["p1"], scene["p2"], scene["K"], scene["K"]),
        lambda: T.CameraPose.find_inliers(scene["p1"], scene["p2"]),
        lambda: T.CameraPose.triangulate_points(scene["p1"], scene["p2"], np.eye(3, 4),
                                                np.eye(3, 4)),
        lambda: T.NNRatioFeatureMatcher(0.8),
        lambda: T.NaiveSIFT(img),
        lambda: T.ScaleRotInvSIFT(img),
        lambda: T.PnP(scene["X"], scene["p2"], K=scene["K"]),
        lambda: T.BundleAdjustment(1, 1, [0], [0], [[0.0, 0.0]], np.zeros((1, 6)),
                                   np.ones((1, 3)), np.eye(3)[None]),
        lambda: T.SFMRunner("nowhere", 3, {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
