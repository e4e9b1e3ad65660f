"""The PyTorch port's geometry against the JAX package, on the CPU.

Correspondences come from the seeded two-view scene of ``tests/conftest.py``
and are handed to both packages as numpy arrays. Null vectors and singular
vectors have arbitrary signs, so F and E are compared up to sign and scale
and poses through the selected candidate. Each tolerance is stated where it
is used.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.geometry import camera as jcam
from sfmfromscratch_tpu.geometry import epipolar as jepi
from sfmfromscratch_tpu.geometry import ransac as jransac
from sfmfromscratch_tpu.geometry import triangulation as jtri

from sfmfromscratch_tpu_torch.geometry import camera as tcam
from sfmfromscratch_tpu_torch.geometry import epipolar as tepi
from sfmfromscratch_tpu_torch.geometry import ransac as transac
from sfmfromscratch_tpu_torch.geometry import triangulation as ttri
from sfmfromscratch_tpu_torch.ops.lie import so3_log

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _f32(*arrays):
    return tuple(np.asarray(a, np.float32) for a in arrays)


def _unit_frobenius(F):
    """F scaled to unit Frobenius norm with a fixed sign (largest entry > 0)."""
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)[..., None, None]
    flat = F.reshape(F.shape[:-2] + (9,))
    s = np.sign(np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1))
    return F * s[..., None]


def _rot_deg(Ra, Rb):
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


# --- geometry/epipolar.py ---------------------------------------------------

def test_hartley_normalize_matches_jax(scene):
    p1, = _f32(scene["p1"])
    mask = np.arange(len(p1)) % 5 != 0
    for m in (None, mask):
        got_p, got_T = tepi.hartley_normalize(_t(p1), None if m is None else _t(m, torch.bool))
        ref_p, ref_T = jepi.hartley_normalize(jnp.asarray(p1), None if m is None else jnp.asarray(m))
        # Means and radii of a few hundred float32 pixels: 1e-5 relative.
        np.testing.assert_allclose(_np(got_T), _np(ref_T), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(got_p), _np(ref_p), rtol=1e-5, atol=1e-5)


def test_eight_point_matches_jax(scene):
    """The normalized 8-point F on all 64 noiseless correspondences and on
    batches of minimal 8-point samples: equal up to sign and scale to 1e-4,
    and both satisfy the epipolar constraint."""
    p1, p2 = _f32(scene["p1"], scene["p2"])
    got = _np(tepi.eight_point_fundamental(_t(p1), _t(p2)))
    ref = _np(jepi.eight_point_fundamental(jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(_unit_frobenius(got), _unit_frobenius(ref), atol=1e-4)
    d = _np(tepi.epipolar_distances(_t(got), _t(p1), _t(p2)))
    assert d.max() < 0.05   # px, noiseless scene
    r = np.random.default_rng(20)
    idx = np.stack([r.choice(len(p1), 8, replace=False) for _ in range(32)])
    got_b = _np(tepi.eight_point_fundamental(_t(p1[idx]), _t(p2[idx])))
    ref_b = _np(jepi.eight_point_fundamental(jnp.asarray(p1[idx]), jnp.asarray(p2[idx])))
    np.testing.assert_allclose(_unit_frobenius(got_b), _unit_frobenius(ref_b), atol=1e-3)
    mask = np.arange(len(p1)) < 40
    got_m = _np(tepi.eight_point_fundamental(_t(p1), _t(p2), _t(mask, torch.bool)))
    ref_m = _np(jepi.eight_point_fundamental(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask)))
    np.testing.assert_allclose(_unit_frobenius(got_m), _unit_frobenius(ref_m), atol=1e-4)


def test_epipolar_distances_and_essential_match_jax(scene):
    p1, p2, K = _f32(scene["p1"], scene["p2"], scene["K"])
    r = np.random.default_rng(21)
    F = r.standard_normal((5, 3, 3)).astype(np.float32) * np.float32(1e-3)
    for fn in ("epipolar_distances", "symmetric_epipolar_distances"):
        got = _np(getattr(tepi, fn)(_t(F), _t(p1), _t(p2)))
        ref = _np(getattr(jepi, fn)(jnp.asarray(F), jnp.asarray(p1), jnp.asarray(p2)))
        assert got.shape == ref.shape == (5, len(p1))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(tepi.essential_from_fundamental(_t(F), _t(K), _t(K))),
                               _np(jepi.essential_from_fundamental(jnp.asarray(F), jnp.asarray(K),
                                                                   jnp.asarray(K))),
                               rtol=1e-5, atol=1e-6)


# --- geometry/camera.py -----------------------------------------------------

def test_camera_projection_matches_jax(scene):
    X, p1, p2, K = _f32(scene["X"], scene["p1"], scene["p2"], scene["K"])
    R2, t2 = _f32(scene["R2"], scene["t2"])
    rvec = _np(so3_log(_t(R2)))
    P1 = _np(tcam.projection_matrix(_t(np.eye(3)), _t(np.zeros(3)), _t(K)))
    P2 = _np(tcam.projection_matrix(_t(R2), _t(t2), _t(K)))
    np.testing.assert_allclose(P2, _np(jcam.projection_matrix(jnp.asarray(R2), jnp.asarray(t2),
                                                              jnp.asarray(K))), rtol=1e-6)
    # Pixel coordinates of a few hundred: 1e-3 px in float32.
    got = _np(tcam.project_points(_t(X), _t(rvec), _t(t2), _t(K)))
    ref = _np(jcam.project_points(jnp.asarray(X), jnp.asarray(rvec), jnp.asarray(t2), jnp.asarray(K)))
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got, p2, atol=1e-2)
    np.testing.assert_allclose(_np(tcam.project_homogeneous(_t(X), _t(P2))),
                               _np(jcam.project_homogeneous(jnp.asarray(X), jnp.asarray(P2))), atol=1e-3)
    mask = np.arange(len(X)) % 3 != 0
    obs = p2 + np.float32(0.5)
    for m in (None, mask):
        e_t, mean_t = tcam.reprojection_errors(_t(X), _t(obs), _t(rvec), _t(t2), _t(K),
                                               None if m is None else _t(m, torch.bool))
        e_j, mean_j = jcam.reprojection_errors(jnp.asarray(X), jnp.asarray(obs), jnp.asarray(rvec),
                                               jnp.asarray(t2), jnp.asarray(K),
                                               None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(_np(e_t), _np(e_j), atol=1e-3)
        assert abs(float(mean_t) - float(mean_j)) < 1e-4
        got2 = float(tcam.two_view_reprojection_error(_t(X), _t(p1), _t(obs), _t(P1), _t(P2),
                                                      None if m is None else _t(m, torch.bool)))
        ref2 = float(jcam.two_view_reprojection_error(jnp.asarray(X), jnp.asarray(p1), jnp.asarray(obs),
                                                      jnp.asarray(P1), jnp.asarray(P2),
                                                      None if m is None else jnp.asarray(m)))
        assert abs(got2 - ref2) < 1e-4


def test_intrinsics_from_exif_matches_jax(tmp_path):
    from PIL import Image

    path = str(tmp_path / "a.jpg")
    exif = Image.Exif()
    exif[0x920A] = 26.0   # FocalLength, mm
    Image.fromarray(np.zeros((312, 472, 3), np.uint8)).save(path, exif=exif)
    for sensor in tcam.SensorType:
        got = tcam.intrinsics_from_exif(path, sensor)
        ref = jcam.intrinsics_from_exif(path, jcam.SensorType[sensor.name])
        np.testing.assert_array_equal(got, ref)
    assert tcam.focal_length_from_exif({0x920A: (44, 10)}) == pytest.approx(4.4)
    assert tcam.focal_length_from_exif({0x010F: "maker"}) is None


# --- geometry/triangulation.py ---------------------------------------------

def test_triangulation_matches_jax(scene):
    """DLT (SVD null vector) and 8 Gauss-Newton steps with 1 px noise: the
    refined points agree to 1e-3 of their depth (float32 SVD and LU by two
    LAPACK paths), and the port's refinement lowers the reprojection error
    as much as the JAX one does."""
    X, K, R2, t2 = _f32(scene["X"], scene["K"], scene["R2"], scene["t2"])
    r = np.random.default_rng(22)
    p1 = (scene["p1"] + r.normal(0, 1.0, scene["p1"].shape)).astype(np.float32)
    p2 = (scene["p2"] + r.normal(0, 1.0, scene["p2"].shape)).astype(np.float32)
    P1 = np.asarray(K @ np.hstack([np.eye(3), np.zeros((3, 1))]), np.float32)
    P2 = np.asarray(K @ np.hstack([R2, t2[:, None]]), np.float32)
    Xt = _np(ttri.triangulate_dlt(_t(p1), _t(p2), _t(P1), _t(P2)))
    Xj = _np(jtri.triangulate_dlt(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(P1), jnp.asarray(P2)))
    depth = X[:, 2:3]
    np.testing.assert_allclose(Xt / depth, Xj / depth, atol=1e-3)
    mask = np.arange(len(X)) % 4 != 0
    Rt = _np(ttri.refine_points_gn(_t(Xt), _t(p1), _t(p2), _t(P1), _t(P2), _t(mask, torch.bool), num_iters=8))
    Rj = _np(jtri.refine_points_gn(jnp.asarray(Xj), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(P1),
                                   jnp.asarray(P2), jnp.asarray(mask), num_iters=8))
    np.testing.assert_allclose(Rt / depth, Rj / depth, atol=1e-3)
    np.testing.assert_array_equal(Rt[~mask], Xt[~mask])   # masked points are not moved

    def err(Xs):
        return float(tcam.two_view_reprojection_error(_t(Xs), _t(p1), _t(p2), _t(P1), _t(P2)))

    assert err(Rt) <= err(Xt) + 1e-6
    assert abs(err(Rt) - err(Rj)) < 1e-3


def test_two_view_depths_matches_jax(scene):
    p1, p2, K, R2, t2 = _f32(scene["p1"], scene["p2"], scene["K"], scene["R2"], scene["t2"])
    Rc = np.stack([R2, R2.T, R2, R2.T]).astype(np.float32)
    tc = np.stack([t2, t2, -t2, -t2]).astype(np.float32)
    z1t, z2t = ttri.two_view_depths(_t(Rc), _t(tc), _t(p1), _t(p2), _t(K), _t(K))
    z1j, z2j = jtri.two_view_depths(jnp.asarray(Rc), jnp.asarray(tc), jnp.asarray(p1),
                                    jnp.asarray(p2), jnp.asarray(K), jnp.asarray(K))
    np.testing.assert_allclose(_np(z1t), _np(z1j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(z2t), _np(z2j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(z1t)[0], scene["X"][:, 2], rtol=1e-3)   # the true pose


# --- geometry/ransac.py -----------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_sample_indices_from_jax_uniforms(masked):
    """The uniforms JAX draws for a key, mapped to minimal samples by the
    port, give exactly the JAX package's samples."""
    n, B, s = 203, 64, 8
    r = np.random.default_rng(23)
    mask = (r.uniform(size=n) > 0.35) if masked else None
    key = jax.random.key(3)
    ref = _np(jransac.sample_minimal_indices(key, n, None if mask is None else jnp.asarray(mask), B, s))
    u = _np(jax.random.uniform(key, (B, s)))
    got = _np(transac.uniforms_to_indices(_t(u), n, None if mask is None else _t(mask, torch.bool), s))
    np.testing.assert_array_equal(got, ref)
    assert np.all(np.sort(got, 1)[:, 1:] != np.sort(got, 1)[:, :-1])   # distinct
    if masked:
        assert mask[got].all()
    g = torch.Generator().manual_seed(0)
    drawn = transac.sample_minimal_indices(g, n, None if mask is None else _t(mask, torch.bool), B, s)
    assert drawn.shape == (B, s) and int(drawn.max()) < n


def test_ransac_essential_pose_with_jax_uniforms(scene):
    """Relative-pose RANSAC on the same correspondences and the same
    hypotheses (the JAX-drawn uniforms handed to the port): the same winner,
    so the same inlier set. The pose comes from the LO refit, a float32 SVD
    of the 45-inlier system by another LAPACK path, which moves it by a few
    hundredths of a degree: rotation within 0.1 deg, translation direction
    within 2e-3. A quarter of the matches are replaced by outliers."""
    r = np.random.default_rng(24)
    p1 = (scene["p1"] + r.normal(0, 0.3, scene["p1"].shape)).astype(np.float32)
    p2 = (scene["p2"] + r.normal(0, 0.3, scene["p2"].shape)).astype(np.float32)
    out = r.choice(len(p1), 16, replace=False)
    p2[out] = r.uniform(0, 480, (16, 2)).astype(np.float32)
    K, = _f32(scene["K"])
    mask = np.ones(len(p1), bool)
    mask[-3:] = False
    key = jax.random.key(7)
    kw = dict(num_hypotheses=300, threshold=1.0, min_cheirality_frac=0.75)
    ref = jransac.ransac_essential_pose(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(K),
                                        jnp.asarray(K), jnp.asarray(mask), **kw)
    u = _t(_np(jax.random.uniform(key, (300, 8))))
    got = transac.ransac_essential_pose(None, _t(p1), _t(p2), _t(K), _t(K), _t(mask, torch.bool),
                                        uniforms=u, **kw)
    assert int(got.num_inliers) == int(ref.num_inliers) >= 40
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    assert _rot_deg(_np(got.R), _np(ref.R)) < 0.1
    np.testing.assert_allclose(_np(got.t), _np(ref.t), atol=2e-3)
    assert bool(got.cheirality_ok) == bool(ref.cheirality_ok)
    np.testing.assert_allclose(_unit_frobenius(_np(got.F)), _unit_frobenius(_np(ref.F)), atol=1e-3)
    assert _rot_deg(_np(got.R), scene["R2"]) < 1.0
    # Drawn from a torch.Generator instead: another sample, the same answer.
    own = transac.ransac_essential_pose(torch.Generator().manual_seed(1), _t(p1), _t(p2), _t(K),
                                        _t(K), _t(mask, torch.bool), **kw)
    assert _rot_deg(_np(own.R), scene["R2"]) < 1.0
    assert abs(int(own.num_inliers) - int(ref.num_inliers)) <= 3


# --- geometry/ransac.py: fixed-count and adaptive F-RANSAC, adaptive pose --

def _noisy_pairs(outlier_fracs, n=200, noise=0.3, seed=25):
    """Correspondences of the conftest two-view scene (n points, ``noise`` px)
    with a share of each lane's matches replaced by outliers; the last rows
    of every lane are masked out."""
    from tests.conftest import synthetic_scene

    sc = synthetic_scene(np.random.default_rng(seed), num_points=n, noise=noise)
    r = np.random.default_rng(seed + 1)
    p1s, p2s, masks = [], [], []
    for frac in outlier_fracs:
        p1 = sc["p1"].astype(np.float32).copy()
        p2 = sc["p2"].astype(np.float32).copy()
        out = r.choice(n, int(frac * n), replace=False)
        p2[out] = r.uniform(0, 480, (len(out), 2)).astype(np.float32)
        m = np.ones(n, bool)
        m[-7:] = False
        p1s.append(p1)
        p2s.append(p2)
        masks.append(m)
    return np.stack(p1s), np.stack(p2s), np.stack(masks), sc


def _jax_stage_uniforms(key, stages, stage_size, s):
    """The uniforms the JAX adaptive while-loop draws for one lane: each
    stage splits the carried key and draws from the second half."""
    out = []
    for _ in range(stages):
        key, sub = jax.random.split(key)
        out.append(_np(jax.random.uniform(sub, (stage_size, s))))
    return np.stack(out)


def test_ransac_fundamental_batch_with_jax_uniforms():
    """Fixed-count F-RANSAC of 3 pairs on the JAX-drawn hypotheses: the same
    winner per pair, so identical inlier masks and counts."""
    p1, p2, m, _ = _noisy_pairs([0.1, 0.3, 0.5])
    keys = jax.random.split(jax.random.key(11), 3)
    ref = jransac.ransac_fundamental_batch(keys, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m),
                                           num_hypotheses=256, threshold=1.0)
    u = np.stack([_np(jax.random.uniform(k, (256, 8))) for k in keys])
    got = transac.ransac_fundamental_batch(None, _t(p1), _t(p2), _t(m, torch.bool),
                                           num_hypotheses=256, threshold=1.0, uniforms=_t(u))
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    np.testing.assert_array_equal(_np(got.num_inliers), _np(ref.num_inliers))
    np.testing.assert_allclose(_unit_frobenius(_np(got.F)), _unit_frobenius(_np(ref.F)), atol=1e-3)
    one = transac.ransac_fundamental(None, _t(p1[1]), _t(p2[1]), _t(m[1], torch.bool),
                                     num_hypotheses=256, uniforms=_t(u[1]))
    np.testing.assert_array_equal(_np(one.inliers), _np(ref.inliers[1]))


def test_ransac_fundamental_adaptive_batch_with_jax_uniforms():
    """Adaptive F-RANSAC of 4 pairs with 5-75% outliers, each lane on the
    uniforms its JAX key draws stage by stage: every lane stops after the
    same number of hypotheses (``hyps_used``), and after the LO refit the
    inlier masks are identical. The lanes stop at different stages, so the
    per-lane stopping and freezing are exercised; the 75% lane also meets
    the futility rule's region."""
    p1, p2, m, _ = _noisy_pairs([0.05, 0.3, 0.55, 0.75])
    P, S, cap = 4, 64, 1024
    keys = jax.random.split(jax.random.key(12), P)
    kw = dict(max_hypotheses=cap, stage_size=S, threshold=1.0, confidence=0.98)
    ref = jransac.ransac_fundamental_adaptive_batch(
        keys, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m), **kw)
    u = np.stack([_jax_stage_uniforms(k, cap // S, S, 8) for k in keys])
    got = transac.ransac_fundamental_adaptive_batch(
        None, _t(p1), _t(p2), _t(m, torch.bool), uniforms=_t(u), **kw)
    used = _np(ref.hyps_used)
    np.testing.assert_array_equal(_np(got.hyps_used), used)
    assert len(set(used.tolist())) >= 2, used          # lanes stop at different stages
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    np.testing.assert_array_equal(_np(got.num_inliers), _np(ref.num_inliers))
    one = transac.ransac_fundamental_adaptive(None, _t(p1[2]), _t(p2[2]), _t(m[2], torch.bool),
                                              uniforms=_t(u[2]), **kw)
    assert int(one.hyps_used) == int(used[2])
    np.testing.assert_array_equal(_np(one.inliers), _np(ref.inliers[2]))


@pytest.mark.parametrize("frac", [0.2, 0.4])
def test_ransac_essential_pose_adaptive_with_jax_uniforms(frac):
    """Adaptive relative-pose RANSAC on the JAX-drawn stage uniforms: the
    same inlier set and strictness; the pose comes from the LO refit's
    float32 SVD, so rotation within 0.1 deg and translation direction within
    2e-3, as for the fixed-count program."""
    p1, p2, m, sc = _noisy_pairs([frac])
    K, = _f32(sc["K"])
    key = jax.random.key(13)
    kw = dict(max_hypotheses=1024, stage_size=64, threshold=1.0, min_cheirality_frac=0.75)
    ref = jransac.ransac_essential_pose_adaptive(
        key, jnp.asarray(p1[0]), jnp.asarray(p2[0]), jnp.asarray(K), jnp.asarray(K),
        jnp.asarray(m[0]), **kw)
    u = _jax_stage_uniforms(key, 1024 // 64, 64, 8)
    got = transac.ransac_essential_pose_adaptive(
        None, _t(p1[0]), _t(p2[0]), _t(K), _t(K), _t(m[0], torch.bool), uniforms=_t(u), **kw)
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    assert bool(got.cheirality_ok) == bool(ref.cheirality_ok)
    assert _rot_deg(_np(got.R), _np(ref.R)) < 0.1
    np.testing.assert_allclose(_np(got.t), _np(ref.t), atol=2e-3)
    assert _rot_deg(_np(got.R), sc["R2"]) < 1.0


def test_hypotheses_needed_matches_jax():
    """The stopping rule in float32, across inlier ratios and the clamps."""
    cnt = np.array([0, 1, 12, 40, 99, 150, 199, 200], np.int32)
    nv = np.int32(200)
    ref = _np(jransac._hypotheses_needed(jnp.asarray(cnt), jnp.asarray(nv), 8, 0.98))
    got = _np(transac._hypotheses_needed(_t(cnt), _t(nv), 8, 0.98))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_ransac_essential_pose_adaptive_batch_with_jax_uniforms():
    """The batched adaptive relative-pose RANSAC of the global engine, 4
    pairs with 5-55% outliers and each its own intrinsics, every lane on the
    uniforms its JAX key draws stage by stage: identical inlier sets and
    strictness per lane; the pose from the LO refit's float32 SVD, rotation
    within 0.1 deg and translation direction within 2e-3. The lanes stop at
    different stages, so finished lanes must freeze while others draw: the
    55% lane finds no support beyond the minimal sample and ends by the
    futility rule, in both packages."""
    p1, p2, m, sc = _noisy_pairs([0.05, 0.2, 0.4, 0.55])
    K, = _f32(sc["K"])
    # Per-lane intrinsics: the same camera, the pixels rescaled per lane.
    s = np.array([1.0, 0.9, 1.1, 1.05], np.float32)
    Ks = np.stack([np.diag([f, f, 1.0]).astype(np.float32) @ K for f in s])
    p1, p2 = p1 * s[:, None, None], p2 * s[:, None, None]
    P, S, cap = 4, 64, 1024
    keys = jax.random.split(jax.random.key(14), P)
    kw = dict(max_hypotheses=cap, stage_size=S, threshold=1.0, min_cheirality_frac=0.75)
    ref = jransac.ransac_essential_pose_adaptive_batch(
        keys, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(Ks), jnp.asarray(Ks), jnp.asarray(m),
        **kw)
    u = np.stack([_jax_stage_uniforms(k, cap // S, S, 8) for k in keys])
    got = transac.ransac_essential_pose_adaptive_batch(
        None, _t(p1), _t(p2), _t(Ks), _t(Ks), _t(m, torch.bool), uniforms=_t(u), **kw)
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    np.testing.assert_array_equal(_np(got.num_inliers), _np(ref.num_inliers))
    np.testing.assert_array_equal(_np(got.cheirality_ok), _np(ref.cheirality_ok))
    for b in range(P):
        assert _rot_deg(_np(got.R)[b], _np(ref.R)[b]) < 0.1
        np.testing.assert_allclose(_np(got.t)[b], _np(ref.t)[b], atol=2e-3)
    assert max(_rot_deg(_np(got.R)[b], sc["R2"]) for b in range(3)) < 1.0
    assert int(got.num_inliers[3]) < 12
    # The stage counts differ between lanes: a lane run alone stops as in the batch.
    one = transac.ransac_essential_pose_adaptive(
        None, _t(p1[3]), _t(p2[3]), _t(Ks[3]), _t(Ks[3]), _t(m[3], torch.bool), uniforms=_t(u[3]),
        cheirality_subset=512, **kw)
    np.testing.assert_array_equal(_np(one.inliers), _np(ref.inliers)[3])


# --- geometry/two_view.py ----------------------------------------------------

def _rand_rot(r, scale):
    ax = r.normal(size=3)
    ax /= np.linalg.norm(ax)
    th = r.uniform(0, scale)
    W = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W


def _edge_set(E=6, N=80, seed=40):
    """E two-view edges with 0.5 px noise, perturbed initial poses (about 1
    deg, 3 deg of direction) and a tenth of each mask off; one edge with 4
    correspondences (left unchanged) and one padded edge (all-false mask)."""
    r = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    R0, t0, P1, P2, M = [], [], [], [], []
    for _ in range(E):
        R = _rand_rot(r, 0.15)
        t = r.normal(size=3)
        t /= np.linalg.norm(t)
        X = np.column_stack([r.uniform(-2, 2, N), r.uniform(-2, 2, N), r.uniform(4, 8, N)])
        x1 = X @ K.T
        x2 = (X @ R.T + t) @ K.T
        P1.append(x1[:, :2] / x1[:, 2:] + r.normal(0, 0.5, (N, 2)))
        P2.append(x2[:, :2] / x2[:, 2:] + r.normal(0, 0.5, (N, 2)))
        R0.append(_rand_rot(r, 0.02) @ R)
        tp = t + 0.05 * r.normal(size=3)
        t0.append(tp / np.linalg.norm(tp))
        M.append(r.uniform(size=N) > 0.1)
    M[-2][:] = False
    M[-2][:4] = True
    M[-1][:] = False
    return _f32(R0, t0, P1, P2, [K] * E, [K] * E) + (np.array(M),)


def test_refine_relative_pose_matches_jax():
    """Batched Sampson Gauss-Newton (8 steps, jacfwd Jacobians vmapped over
    edges) from the same start: R, t and the final RMS within 1e-4 (float32
    5x5 solves by two LAPACK paths; measured 5e-5); an edge with under 5
    correspondences and a padded edge pass through unchanged."""
    from sfmfromscratch_tpu.geometry import two_view as jtv
    from sfmfromscratch_tpu_torch.geometry import two_view as ttv

    args = _edge_set()
    ref = jtv.refine_relative_pose(*(jnp.asarray(a) for a in args))
    got = ttv.refine_relative_pose(*(_t(a, torch.bool if a.dtype == bool else torch.float32)
                                     for a in args))
    assert all(g.dtype == torch.float32 for g in got)
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(rf), atol=1e-4)
    np.testing.assert_array_equal(_np(got[0])[-2:], args[0][-2:])
    np.testing.assert_array_equal(_np(got[1])[-2:], args[1][-2:])
    e1, e2 = ttv._tangent_basis(_t(args[1][0]))
    basis = np.stack([args[1][0], _np(e1), _np(e2)])
    np.testing.assert_allclose(basis @ basis.T, np.eye(3), atol=1e-6)


# --- geometry/triangulation.py: multiview -----------------------------------

def test_triangulate_multiview_matches_jax():
    """Multiview DLT + 8 GN steps over a flat observation list of 5 cameras
    (tracks of 1 to 5 observations, 0.5 px noise) padded as the global engine
    pads it (zero-weight observations on a spare track): points within 1e-4
    of the scene scale (the farthest depth), observation counts equal, a
    1-observation track left at its DLT point."""
    r = np.random.default_rng(41)
    C, T = 5, 120
    K = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]])
    P = []
    for c in range(C):
        R = _rand_rot(r, 0.1)
        t = np.array([-0.3 * c, 0.05 * r.normal(), 0.02 * r.normal()])
        P.append(K @ np.hstack([R, t[:, None]]))
    P = np.stack(P)
    X = np.column_stack([r.uniform(-2, 2, T), r.uniform(-1.5, 1.5, T), r.uniform(5, 9, T)])
    cam, pt, xy = [], [], []
    for k in range(T):
        for c in sorted(r.choice(C, 1 + k % C, replace=False)):
            h = P[c] @ np.append(X[k], 1.0)
            cam.append(c)
            pt.append(k)
            xy.append(h[:2] / h[2] + r.normal(0, 0.5, 2))
    O, Ob, Tb = len(cam), 1024, T + 8
    obs_cam = np.zeros(Ob, np.int32); obs_cam[:O] = cam
    obs_pt = np.full(Ob, Tb - 1, np.int32); obs_pt[:O] = pt
    obs_xy = np.zeros((Ob, 2), np.float32); obs_xy[:O] = xy
    w = np.zeros(Ob, np.float32); w[:O] = 1.0
    P32 = P.astype(np.float32)
    Xj, nj = jtri.triangulate_multiview(jnp.asarray(P32), jnp.asarray(obs_cam), jnp.asarray(obs_pt),
                                        jnp.asarray(obs_xy), num_points=Tb, obs_w=jnp.asarray(w),
                                        gn_iters=8)
    Xt, nt = ttri.triangulate_multiview(_t(P32), _t(obs_cam, torch.int64), _t(obs_pt, torch.int64),
                                        _t(obs_xy), num_points=Tb, obs_w=_t(w), gn_iters=8)
    np.testing.assert_array_equal(_np(nt), _np(nj))
    scale = float(X[:, 2].max())
    multi = _np(nj)[:T] >= 2
    np.testing.assert_allclose(_np(Xt)[:T][multi] / scale, _np(Xj)[:T][multi] / scale, atol=1e-4)
    assert np.median(np.abs(_np(Xt)[:T][multi] - X[multi])) < 0.05   # 0.5 px noise at 5-9 m
    single = np.nonzero(~multi[:T])[0]
    assert len(single) > 0
    X1, _ = ttri.triangulate_multiview(_t(P32), _t(obs_cam, torch.int64), _t(obs_pt, torch.int64),
                                       _t(obs_xy), num_points=Tb, obs_w=_t(w), gn_iters=0)
    np.testing.assert_array_equal(_np(Xt)[single], _np(X1)[single])


# --- geometry/homography.py -------------------------------------------------

def _planar_edges(seed=42):
    from tests.test_homography import K, _scene

    r = np.random.default_rng(seed)
    scenes = [_scene(r, n_plane=130 - n_off, n_off=n_off, noise=0.2) for n_off in (0, 30, 15)]
    p1 = np.stack([s[0] for s in scenes]).astype(np.float32)
    p2 = np.stack([s[1] for s in scenes]).astype(np.float32)
    m = np.ones(p1.shape[:2], bool)
    m[2, -10:] = False
    return p1, p2, m, np.stack([K] * 3).astype(np.float32)


def test_homography_matches_jax():
    """The planar-degeneracy tools of the global engine on 3 noisy
    plane-dominant edges (0, 30 and 15 of 130 points off the plane): H within 1e-4 up to
    scale and sign (unit Frobenius norm), the same symmetric-transfer inlier
    counts; the 8 Faugeras candidates equal as sets (SVD signs order them
    freely); the two selected poses within 1e-3 rad with the same votes and
    ``ok``; the off-plane epipolar RMS within 1e-3 px of JAX's."""
    from sfmfromscratch_tpu.geometry import homography as jh
    from sfmfromscratch_tpu_torch.geometry import homography as th

    p1, p2, m, Ks = _planar_edges()
    fj = jh.fit_homography(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m))
    ft = th.fit_homography(_t(p1), _t(p2), _t(m, torch.bool))
    np.testing.assert_allclose(_unit_frobenius(_np(ft.H)), _unit_frobenius(_np(fj.H)), atol=1e-4)
    np.testing.assert_array_equal(_np(ft.num_inliers), _np(fj.num_inliers))
    np.testing.assert_array_equal(_np(ft.ok), _np(fj.ok))

    H = _np(fj.H)
    pj = jh.pose_from_homography_batch(jnp.asarray(H), jnp.asarray(Ks), jnp.asarray(Ks),
                                       jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m))
    pt = th.pose_from_homography_batch(_t(H), _t(Ks), _t(Ks), _t(p1), _t(p2), _t(m, torch.bool))
    np.testing.assert_array_equal(_np(pt.num_pos), _np(pj.num_pos))
    np.testing.assert_array_equal(_np(pt.ok), _np(pj.ok))
    for e in range(3):
        for c in range(2):
            assert np.radians(_rot_deg(_np(pt.R)[e, c], _np(pj.R)[e, c])) < 1e-3
            np.testing.assert_allclose(_np(pt.t)[e, c], _np(pj.t)[e, c], atol=1e-3)
        single = th.pose_from_homography(_t(H[e]), _t(Ks[e]), _t(Ks[e]), _t(p1[e]), _t(p2[e]),
                                         _t(m[e], torch.bool))
        np.testing.assert_allclose(_np(single.R), _np(pt.R)[e], atol=1e-6)

    Hc = np.linalg.solve(Ks[0], H[0] @ Ks[0]).astype(np.float32)
    Rj, tj, _ = jh._faugeras_candidates(jnp.asarray(Hc))
    Rt, tt, _ = th._faugeras_candidates(_t(Hc))
    for R_, t_ in zip(_np(Rj), _np(tj)):
        gaps = [np.abs(R_ - Rb).max() + np.abs(t_ - tb).max() for Rb, tb in zip(_np(Rt), _np(tt))]
        assert min(gaps) < 1e-4, gaps

    e2 = _np(jh._transfer_err2(jnp.asarray(H), jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(_np(th._transfer_err2(_t(H), _t(p1), _t(p2))), e2, rtol=1e-4, atol=1e-4)
    off = (e2 > 4.0) & m
    rj, cj = jh.candidate_epipolar_rms_batch(pj.R, pj.t, jnp.asarray(Ks), jnp.asarray(Ks),
                                             jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(off))
    rt, ct = th.candidate_epipolar_rms_batch(_t(_np(pj.R)), _t(_np(pj.t)), _t(Ks), _t(Ks), _t(p1),
                                             _t(p2), _t(off, torch.bool))
    np.testing.assert_array_equal(_np(ct), _np(cj))
    np.testing.assert_allclose(_np(rt), _np(rj), atol=1e-3)
