"""The port's fixed-count RANSAC and DLT PnP against the JAX package, on the CPU.

Function tests hand the port the uniforms JAX draws for its key, so both
packages score the same hypotheses. Engine tests run both packages'
engines with ``RansacConfig(adaptive=False, pnp_solver="dlt")`` on the same
files, each with its own draws, and hold the port to gates set beside the
two packages' spreads over ``config.seed``. Each tolerance is stated where
it is used.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.config import RansacConfig as JRansacConfig
from sfmfromscratch_tpu.geometry import pnp as jpnp
from sfmfromscratch_tpu.geometry import ransac as jransac
from sfmfromscratch_tpu.ops import smallsvd as jsvd
from sfmfromscratch_tpu.pipeline import incremental as jinc
from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine as JGlobal

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.config import PipelineConfig, RansacConfig
from sfmfromscratch_tpu_torch.geometry import pnp as tpnp
from sfmfromscratch_tpu_torch.geometry import ransac as transac
from sfmfromscratch_tpu_torch.ops import smallsvd as tsvd
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error, camera_centers
from tests import test_global_sfm, test_pipeline
from tests.conftest import synthetic_scene
from tests.render import render_sequence, write_sequence

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _rot_deg(Ra, Rb):
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


def _pnp_scene(n=120, noise=0.5, outliers=0.25, seed=31):
    """World points, their pixels in camera 2 with ``noise`` px and a share
    of outliers, K and the true pose; the last rows are masked out."""
    sc = synthetic_scene(np.random.default_rng(seed), num_points=n, noise=noise)
    r = np.random.default_rng(seed + 1)
    X = sc["X"].astype(np.float32)
    x = sc["p2"].astype(np.float32).copy()
    out = r.choice(n, int(outliers * n), replace=False)
    x[out] = r.uniform(0, 480, (len(out), 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-5:] = False
    return X, x, sc["K"].astype(np.float32), mask, sc


# --- ops/smallsvd.py ----------------------------------------------------------

@pytest.mark.parametrize("m", [12, 40])
def test_nullvec_normal_eq_matches_jax(m):
    """The eigh null vector of (B, m, 12) systems, rank-deficient ones with
    an exact null vector and noisy full-rank ones: unit vectors equal to
    JAX's up to sign within 1e-4 where the two smallest eigenvalues of
    A^T A are at least 1e-2 of the largest apart (a float32 eigenvector
    moves by about eps ||A^T A|| / gap), and ||A v|| equal to JAX's within
    1e-4 of ||A|| everywhere."""
    r = np.random.default_rng(40)
    A = r.normal(size=(64, m, 12)).astype(np.float32)
    v_true = r.normal(size=(16, 12))
    A[:16] -= (A[:16] @ v_true[..., None]) * v_true[:, None, :] / (v_true * v_true).sum(-1)[:, None, None]
    ref = _np(jsvd.nullvec_normal_eq(jnp.asarray(A)))
    got = _np(tsvd.nullvec_normal_eq(_t(A)))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    lam = np.linalg.eigvalsh(A.astype(np.float64).transpose(0, 2, 1) @ A)
    apart = (lam[:, 1] - lam[:, 0]) >= 1e-2 * lam[:, -1]
    assert apart.sum() >= 16
    sign = np.sign((got * ref).sum(-1, keepdims=True))
    np.testing.assert_allclose((got * sign)[apart], ref[apart], atol=1e-4)
    res = np.linalg.norm(A @ got[..., None], axis=(-2, -1))
    res_ref = np.linalg.norm(A @ ref[..., None], axis=(-2, -1))
    np.testing.assert_allclose(res, res_ref, atol=1e-4 * np.linalg.norm(A, axis=(-2, -1)).max())
    np.testing.assert_allclose(res[:16], 0.0, atol=1e-3)
    u = _np(tsvd.smallest_eigvec_sym(_t(A.transpose(0, 2, 1) @ A)))
    np.testing.assert_allclose(np.abs((u * got).sum(-1)), 1.0, atol=1e-5)


def test_nullvec_normal_eq_non_finite_gives_nan():
    """A system with an inf or a NaN gives a NaN vector where
    ``torch.linalg.eigh`` may raise, as XLA's eigh gives NaN; the other
    systems of the batch keep their vectors."""
    A = np.random.default_rng(41).normal(size=(3, 12, 12)).astype(np.float32)
    A[1, 2, 3] = np.inf
    A[2, 0, 0] = np.nan
    ref = _np(jsvd.nullvec_normal_eq(jnp.asarray(A)))
    got = _np(tsvd.nullvec_normal_eq(_t(A)))
    np.testing.assert_array_equal(np.isfinite(got).all(-1), np.isfinite(ref).all(-1))
    assert np.isnan(got[1:]).all() and np.isfinite(got[0]).all()


# --- geometry/pnp.py: the DLT generator and pnp() ---------------------------

def test_dlt_projection_and_pose_match_jax():
    """The normalising transforms exactly as JAX's (to 1e-5 relative), and
    on 256 JAX-sampled 6-point sets the DLT projection (up to scale and
    sign) and the factored pose: 90% of the hypotheses within 1e-3, every
    rotation within 0.5 deg. Ill-conditioned samples amplify the eigh's
    float32 rounding (measured: median 1e-5, worst 3e-3 in P)."""
    X, x, K, mask, _ = _pnp_scene(outliers=0.1)
    w = mask.astype(np.float32)
    for fj, ft, a in ((jpnp._normalize_2d, tpnp._normalize_2d, x),
                      (jpnp._normalize_3d, tpnp._normalize_3d, X)):
        for ww in (None, w):
            rj = fj(jnp.asarray(a), None if ww is None else jnp.asarray(ww))
            rt = ft(_t(a), None if ww is None else _t(ww))
            for u, v in zip(rj, rt):
                np.testing.assert_allclose(_np(v), _np(u), rtol=1e-5, atol=1e-5)
    key = jax.random.key(42)
    idx = _np(jransac.sample_minimal_indices(key, len(X), jnp.asarray(mask), 256, 6))
    Pj = _np(jpnp._dlt_projection(jnp.asarray(X)[idx], jnp.asarray(x)[idx], precise=False))
    Pt = _np(tpnp._dlt_projection(_t(X)[idx], _t(x)[idx], precise=False))
    unit = lambda P: P / np.linalg.norm(P.reshape(len(P), -1), axis=1)[:, None, None] \
        * np.sign(P[:, 2:3, 3:4])
    err = np.abs(unit(Pj) - unit(Pt)).reshape(len(Pj), -1).max(1)
    assert (err <= 1e-3).mean() >= 0.9, np.sort(err)[-5:]
    Rj, _ = jpnp._pose_from_projection(jnp.asarray(Pj), jnp.asarray(K))
    Rt, _ = tpnp._pose_from_projection(_t(Pj), _t(K))
    assert max(_rot_deg(a, b) for a, b in zip(_np(Rj), _np(Rt))) < 0.5


def test_dlt_degenerate_samples_do_not_raise():
    """A sample of six copies of one point, one with a NaN and a coplanar
    one: the port gives finite and non-finite projections and poses exactly
    where JAX does, and raises nowhere (``torch.linalg`` raises on a
    non-finite SVD input where XLA returns NaN)."""
    r = np.random.default_rng(43)
    X = r.uniform(-1, 1, (4, 6, 3)).astype(np.float32)
    X[..., 2] += 5
    x = r.uniform(0, 400, (4, 6, 2)).astype(np.float32)
    X[1], x[1] = X[1, 0], x[1, 0]
    X[2, 3, 0] = np.nan
    X[3, :, 2] = 5.0
    K = np.array([[500, 0, 240], [0, 500, 180], [0, 0, 1]], np.float32)
    Pj = _np(jpnp._dlt_projection(jnp.asarray(X), jnp.asarray(x), precise=False))
    Pt = _np(tpnp._dlt_projection(_t(X), _t(x), precise=False))
    np.testing.assert_array_equal(np.isfinite(Pt).all((1, 2)), np.isfinite(Pj).all((1, 2)))
    Rj, tj = jpnp._pose_from_projection(jnp.asarray(Pj), jnp.asarray(K))
    Rt, tt = tpnp._pose_from_projection(_t(Pj), _t(K))
    np.testing.assert_array_equal(np.isfinite(_np(Rt)).all((1, 2)), np.isfinite(_np(Rj)).all((1, 2)))
    assert not np.isfinite(_np(Rt)[2]).any()


@pytest.mark.parametrize("outliers", [0.1, 0.4])
def test_pnp_ransac_dlt_with_jax_uniforms(outliers):
    """DLT PnP RANSAC on the JAX-drawn 6-point samples: identical inlier
    masks, the same ``ok``, and the LM-polished pose within 1e-4 (rotation
    entries and translation); within 0.5 deg of the truth."""
    X, x, K, mask, sc = _pnp_scene(outliers=outliers)
    key = jax.random.key(44)
    kw = dict(num_hypotheses=256, reproj_threshold=8.0, solver="dlt")
    ref = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(K), jnp.asarray(mask), **kw)
    u = _np(jax.random.uniform(key, (256, 6)))
    got = tpnp.pnp_ransac(None, _t(X), _t(x), _t(K), _t(mask, torch.bool), uniforms=_t(u), **kw)
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert bool(got.ok) == bool(ref.ok)
    np.testing.assert_allclose(_np(got.R), _np(ref.R), atol=1e-4)
    np.testing.assert_allclose(_np(got.t), _np(ref.t), atol=1e-4)
    assert _rot_deg(_np(got.R), sc["R2"]) < 0.5
    own = tpnp.pnp_ransac(torch.Generator().manual_seed(2), _t(X), _t(x), _t(K),
                          _t(mask, torch.bool), **kw)
    assert abs(int(own.num_inliers) - int(ref.num_inliers)) <= 2
    with pytest.raises(ValueError):
        tpnp.pnp_ransac(None, _t(X), _t(x), _t(K), solver="epnp", uniforms=_t(u))


@pytest.mark.parametrize("masked", [False, True])
def test_pnp_matches_jax(masked):
    """Non-robust PnP (the SVD DLT on every valid point, 15 LM steps) on
    outlier-free points with 0.5 px noise: the pose within 1e-4 of JAX's,
    the same inliers under 8 px, and within 0.2 deg of the truth."""
    X, x, K, mask, sc = _pnp_scene(outliers=0.0)
    m = mask if masked else None
    ref = jpnp.pnp(jnp.asarray(X), jnp.asarray(x), jnp.asarray(K), None if m is None else jnp.asarray(m))
    got = tpnp.pnp(_t(X), _t(x), _t(K), None if m is None else _t(m, torch.bool))
    np.testing.assert_allclose(_np(got.R), _np(ref.R), atol=1e-4)
    np.testing.assert_allclose(_np(got.t), _np(ref.t), atol=1e-4)
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    assert bool(got.ok) and bool(ref.ok)
    assert _rot_deg(_np(got.R), sc["R2"]) < 0.2


# --- geometry/ransac.py: batched fixed-count relative poses -----------------

def test_ransac_essential_pose_batch_with_jax_uniforms():
    """Fixed-count essential RANSAC of 3 pairs with 10-50% outliers, each on
    the uniforms its JAX key draws: identical inlier masks and counts, the
    same cheirality flags, poses within 1e-4 (the LO refit's SVD by another
    LAPACK path), and a leading pair axis on every field. The pairs with
    10% and 30% outliers are within 1 deg of the truth."""
    sc = synthetic_scene(np.random.default_rng(45), num_points=200, noise=0.3)
    r = np.random.default_rng(46)
    p1s, p2s, ms = [], [], []
    for frac in (0.1, 0.3, 0.5):
        p2 = sc["p2"].astype(np.float32).copy()
        out = r.choice(200, int(frac * 200), replace=False)
        p2[out] = r.uniform(0, 480, (len(out), 2)).astype(np.float32)
        m = np.ones(200, bool)
        m[-6:] = False
        p1s.append(sc["p1"].astype(np.float32))
        p2s.append(p2)
        ms.append(m)
    p1, p2, m = np.stack(p1s), np.stack(p2s), np.stack(ms)
    K = np.broadcast_to(sc["K"].astype(np.float32), (3, 3, 3)).copy()
    keys = jax.random.split(jax.random.key(47), 3)
    kw = dict(num_hypotheses=256, threshold=1.0, min_cheirality_frac=0.75)
    ref = jransac.ransac_essential_pose_batch(keys, *(jnp.asarray(a) for a in (p1, p2, K, K, m)), **kw)
    u = np.stack([_np(jax.random.uniform(k, (256, 8))) for k in keys])
    got = transac.ransac_essential_pose_batch(None, *(_t(a) for a in (p1, p2, K, K)),
                                              _t(m, torch.bool), uniforms=_t(u), **kw)
    np.testing.assert_array_equal(_np(got.inliers), _np(ref.inliers))
    np.testing.assert_array_equal(_np(got.num_inliers), _np(ref.num_inliers))
    np.testing.assert_array_equal(_np(got.cheirality_ok), _np(ref.cheirality_ok))
    np.testing.assert_allclose(_np(got.R), _np(ref.R), atol=1e-4)
    np.testing.assert_allclose(_np(got.t), _np(ref.t), atol=1e-4)
    assert all(_rot_deg(R, sc["R2"]) < 1.0 for R in _np(got.R)[:2])
    own = transac.ransac_essential_pose_batch(torch.Generator().manual_seed(3),
                                              *(_t(a) for a in (p1, p2, K, K)),
                                              _t(m, torch.bool), **kw)
    assert own.R.shape == (3, 3, 3) and all(_rot_deg(R, sc["R2"]) < 1.0 for R in _np(own.R)[:2])


def test_fixed_count_bootstrap_matches_jax():
    """The engine's bootstrap with ``adaptive=False`` (fixed-count essential
    RANSAC, DLT, 8 Gauss-Newton steps) against ``_bootstrap_device(...,
    adaptive=False)`` on the JAX-drawn uniforms: identical inliers, the pose
    within 1e-4, points within 1e-3 of their depth."""
    sc = synthetic_scene(np.random.default_rng(48), num_points=150, noise=0.3)
    r = np.random.default_rng(49)
    p1 = sc["p1"].astype(np.float32)
    p2 = sc["p2"].astype(np.float32).copy()
    out = r.choice(150, 30, replace=False)
    p2[out] = r.uniform(0, 480, (30, 2)).astype(np.float32)
    m = np.ones(150, bool)
    K = sc["K"].astype(np.float32)
    key = jax.random.key(50)
    ref = jinc._bootstrap_device(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(K),
                                 jnp.asarray(K), jnp.asarray(m), 300, 1.0, adaptive=False)
    u = _np(jax.random.uniform(key, (300, 8)))
    got = tinc.bootstrap(None, _t(p1), _t(p2), _t(K), _t(K), _t(m, torch.bool), 300, 1.0,
                         uniforms=_t(u), adaptive=False)
    inl = _np(ref[0])
    np.testing.assert_array_equal(_np(got[0]), inl)
    np.testing.assert_allclose(_np(got[2]), _np(ref[2]), atol=1e-4)
    np.testing.assert_allclose(_np(got[3]), _np(ref[3]), atol=1e-4)
    Xg, Xr = _np(got[1])[inl], _np(ref[1])[inl]
    d = np.abs(Xr[:, 2:3]) + 1e-6
    assert np.abs(Xg / d - Xr / d).max() <= 1e-3


# --- the engines with fixed-count RANSAC ------------------------------------

def test_dlt_solver_means_p3p_at_the_full_hypothesis_count(tmp_path, monkeypatch):
    """``pnp_solver="dlt"`` changes only the PnP hypothesis count, as in the
    JAX engine, whose PnP calls pass no solver: ``pnp_num_iterations()`` is
    ``num_iterations()`` = 5,967 in both packages (P3P: 512), and the
    chain's ``pnp_ransac`` runs at that count with its default (P3P)
    solver."""
    for solver, want in (("dlt", 5967), ("p3p", 512)):
        assert JRansacConfig(pnp_solver=solver).pnp_num_iterations() == want
        assert RansacConfig(pnp_solver=solver).pnp_num_iterations() == want
    cfg = dataclasses.replace(PipelineConfig(), ransac=RansacConfig(adaptive=False, pnp_solver="dlt"))
    eng = tinc.SfmEngine(str(tmp_path), 3, config=cfg, device="cpu", auto_run=False)
    assert eng._pnp_hyp == 5967 and eng._num_hyp == 5967
    calls = []
    real = tinc.pnp_ransac
    monkeypatch.setattr(tinc, "pnp_ransac", lambda *a, **k: calls.append(k) or real(*a, **k))
    X, x, K, mask, _ = _pnp_scene(outliers=0.1)
    P1 = torch.cat([_t(K), torch.zeros(3, 1)], dim=1)
    tinc.chain_step(torch.Generator().manual_seed(0), _t(X), _t(mask, torch.bool), _t(x), _t(x),
                    _t(K), P1, eng._pnp_hyp, 8.0, _t(~mask, torch.bool))
    assert len(calls) == 1 and calls[0]["num_hypotheses"] == 5967 and "solver" not in calls[0]


@pytest.fixture(scope="module")
def scene4(tmp_path_factory):
    """``tests/test_pipeline.py``'s 4-view scene."""
    images, K, poses, _ = render_sequence(np.random.default_rng(42), num_views=4, num_points=110)
    d = tmp_path_factory.mktemp("seq4")
    write_sequence(str(d), images)
    return dict(dir=str(d), K=K, poses=poses, n=4)


def _ate_over_extent(global_poses, gt_poses, first_image):
    est = camera_centers(np.stack([rv for rv, _ in global_poses]),
                         np.stack([t for _, t in global_poses]))
    gt = np.stack([-(R.T @ t) for R, t in gt_poses[first_image - 1:first_image - 1 + len(est)]])
    return absolute_trajectory_error(est, gt) / float(np.linalg.norm(gt.max(0) - gt.min(0)))


def test_engine_fixed_count_within_jax_spread(scene4, tmp_path):
    """``SfmEngine`` with ``adaptive=False, pnp_solver="dlt"`` at
    ``tests/test_pipeline.py::_small_config`` (384 hypotheses) on that
    file's 4-view scene, both packages on the same files. The scene has two
    modes in both packages (a bootstrap a little off, which the chain
    follows): over ``config.seed`` 0-19 JAX gives 0.055-0.257 px after BA,
    ATE over extent 0.004-0.025 and 126-167 tracks, the port 0.058-0.255
    px, 0.0035-0.027 and 124-169. So: every camera registered, BA lowers the
    error, at most 0.35 px, ATE at most 0.05, tracks at least three quarters
    of JAX's; each filtered pair ran all 384 hypotheses."""
    jcfg = dataclasses.replace(test_pipeline._small_config(),
                               ransac=JRansacConfig(max_iterations=384, adaptive=False,
                                                    pnp_solver="dlt"))
    ref = jinc.SfmEngine(scene4["dir"], 4, config=jcfg, single_K=scene4["K"])
    eng = tinc.SfmEngine(scene4["dir"], 4, config=interop.config_from_dict(dataclasses.asdict(jcfg)),
                         single_K=scene4["K"], device="cpu")
    assert len(eng.global_poses) == len(ref.global_poses) == 3
    e0, e1 = eng.errors_before_after_ba
    assert e1 < e0 and e1 <= 0.35, (e0, e1, ref.errors_before_after_ba)
    assert _ate_over_extent(eng.global_poses, scene4["poses"], 2) <= 0.05
    assert eng.map.num_tracks >= 0.75 * ref.map.num_tracks
    assert eng._pnp_hyp == ref._pnp_hyp == 384
    assert eng.filter_hyps_used.tolist() == [384, 384]


@pytest.fixture(scope="module")
def orbit6(tmp_path_factory):
    """``tests/test_global_sfm.py``'s 6-view 5 deg/view orbit."""
    images, K, poses, _ = render_sequence(np.random.default_rng(7), num_views=6, num_points=160,
                                          orbit_step_deg=5.0)
    d = tmp_path_factory.mktemp("orbit6")
    write_sequence(str(d), images)
    return dict(dir=str(d), K=K, poses=poses, n=6)


def test_global_engine_fixed_count_within_jax_spread(orbit6, tmp_path):
    """``GlobalSfmEngine`` with fixed-count RANSAC (the window filter at 384
    hypotheses, relative poses at 512 by ``ransac_essential_pose_batch``) at
    ``tests/test_global_sfm.py``'s configuration, both packages on the same
    files. Over ``config.seed`` 0-4 JAX gives 0.192-0.413 px after BA, ATE
    over extent 0.003-0.054 and 186-221 tracks; the port 0.178-0.246 px,
    0.0015-0.012 and 181-209. So: every camera, camera 0 the identity, at
    most 0.6 px, ATE at most 0.08 (the JAX fixture's gate), tracks at
    least 80% of JAX's."""
    jcfg = test_global_sfm._small_config()
    jcfg = dataclasses.replace(jcfg, ransac=dataclasses.replace(jcfg.ransac, adaptive=False))
    kw = dict(single_K=orbit6["K"], pair_window=3, rel_num_hypotheses=512)
    ref = JGlobal(orbit6["dir"], 6, config=jcfg, output_dir=str(tmp_path), **kw)
    eng = TGlobal(orbit6["dir"], 6, config=interop.config_from_dict(dataclasses.asdict(jcfg)),
                  device="cpu", **kw)
    assert len(eng.global_poses) == len(ref.global_poses) == 6
    assert np.allclose(np.hstack(eng.global_poses[0]), 0.0, atol=1e-5)
    assert eng.errors_before_after_ba[1] <= 0.6, (eng.errors_before_after_ba,
                                                  ref.errors_before_after_ba)
    assert _ate_over_extent(eng.global_poses, orbit6["poses"], 1) <= 0.08
    assert eng.map.num_tracks >= 0.8 * ref.map.num_tracks
    assert set(eng.filter_hyps_used.tolist()) == {384}
