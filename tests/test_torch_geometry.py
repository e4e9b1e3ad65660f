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
