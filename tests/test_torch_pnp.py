"""The port's P3P solver and PnP RANSAC against the JAX package, on the CPU.

2D-3D correspondences come from the seeded two-view scene of
``tests/conftest.py``. RANSAC runs on the uniforms JAX draws for its key, so
both packages score the same samples. Each tolerance is stated where it is
used.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.geometry import p3p as jp3p
from sfmfromscratch_tpu.geometry import pnp as jpnp
from sfmfromscratch_tpu.ops.lie import so3_log as jso3_log

from sfmfromscratch_tpu_torch.geometry import p3p as tp3p
from sfmfromscratch_tpu_torch.geometry import pnp as tpnp
from tests.conftest import synthetic_scene

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _rot_deg(Ra, Rb):
    dR = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


def _scene(n=120, noise=0.5, outliers=0.25, seed=31):
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


def test_quartic_roots_match_jax():
    """Quartics with four, two and no real roots: the same validity flags,
    and roots within 1e-4 (relative to 1). Near-double roots (1e-4 apart)
    are ill-conditioned in float32, where Newton converges only linearly:
    there the flags agree and the roots only to 2e-2."""
    r = np.random.default_rng(30)
    roots = r.uniform(-3, 3, (64, 4))
    roots[:8, 1] = roots[:8, 0] + 1e-4                      # near-double
    c = np.stack([np.poly(rt) for rt in roots])             # four real roots
    c2 = np.stack([np.polymul([1, 0, 1.0 + k], np.poly(rt[:2])) for k, rt in enumerate(roots[8:24])])
    c0 = np.stack([np.polymul([1, 0, 1.0], [1, 0, 2.0 + k]) for k in range(8)])
    coeffs = np.concatenate([c, c2, c0]).astype(np.float32)
    got_x, got_v = tp3p.quartic_roots(_t(coeffs))
    ref_x, ref_v = jp3p.quartic_roots(jnp.asarray(coeffs))
    np.testing.assert_array_equal(_np(got_v), _np(ref_v))
    np.testing.assert_allclose(_np(got_x)[8:], _np(ref_x)[8:], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(got_x)[:8], _np(ref_x)[:8], atol=2e-2)
    assert _np(got_v)[:64].all() and not _np(got_v)[80:].any()
    assert _np(got_v)[64:80].sum(-1).min() >= 2


def test_p3p_poses_match_jax():
    """Grunert P3P on 256 noiseless three-point samples: identical validity
    flags, and poses within 1e-4 (rotation entries, and translation relative
    to the scene's depth of ~6) on at least 97% of the valid candidates. The
    rest are ill-conditioned samples (near-double quartic roots), where
    float32 ``cbrt``/``arccos`` one ulp apart move the root: measured 8 of
    518 candidates, on either side the better one."""
    X, x, K, _, sc = _scene(outliers=0.0, noise=0.0)
    r = np.random.default_rng(33)
    idx = np.stack([r.choice(len(X), 3, replace=False) for _ in range(256)])
    Rg, tg, vg = tp3p.p3p_poses(_t(X[idx]), _t(x[idx]), _t(K))
    Rj, tj, vj = jp3p.p3p_poses(jnp.asarray(X[idx]), jnp.asarray(x[idx]), jnp.asarray(K))
    vg, vj = _np(vg), _np(vj)
    np.testing.assert_array_equal(vg, vj)
    assert vg.sum() >= 256                    # at least one pose per sample on average
    close = ((np.abs(_np(Rg) - _np(Rj)).max((-2, -1)) <= 1e-4)
             & (np.abs(_np(tg) - _np(tj)).max(-1) / 6.0 <= 1e-4))
    assert close[vj].mean() >= 0.97, close[vj].mean()
    # Noiseless samples: some candidate of most samples is the true pose.
    best = [min(_rot_deg(R, sc["R2"]) for R, ok in zip(_np(Rg)[b], vg[b]) if ok)
            for b in range(256) if vg[b].any()]
    assert np.median(best) < 1e-2


def test_kabsch_matches_jax():
    """The closed-form polar Newton rotation of 3-point sets: within 1e-5."""
    r = np.random.default_rng(34)
    Xw = r.uniform(-2, 2, (50, 3, 3)).astype(np.float32)
    from scipy.spatial.transform import Rotation

    Rt = Rotation.from_rotvec(r.uniform(-1, 1, (50, 3))).as_matrix().astype(np.float32)
    Yc = np.einsum("bij,bkj->bki", Rt, Xw) + r.uniform(-1, 1, (50, 1, 3)).astype(np.float32)
    Rg, tg = tp3p._kabsch(_t(Xw), _t(Yc))
    Rj, tj = jp3p._kabsch(jnp.asarray(Xw), jnp.asarray(Yc))
    np.testing.assert_allclose(_np(Rg), _np(Rj), atol=1e-5)
    np.testing.assert_allclose(_np(tg), _np(tj), atol=1e-5)
    np.testing.assert_allclose(_np(Rg), Rt, atol=1e-4)


def test_reproj_errors_and_lm_refine_match_jax():
    """Reprojection errors to 1e-3 px; the 10-step LM polish from a
    perturbed pose to 1e-4 in the rotation vector and translation."""
    X, x, K, mask, sc = _scene(outliers=0.0)
    R = sc["R2"].astype(np.float32)
    t = sc["t2"].astype(np.float32)
    e_g = tpnp._reproj_errors(_t(R), _t(t), _t(K), _t(X), _t(x))
    e_j = jpnp._reproj_errors(jnp.asarray(R), jnp.asarray(t), jnp.asarray(K), jnp.asarray(X),
                              jnp.asarray(x))
    np.testing.assert_allclose(_np(e_g), _np(e_j), atol=1e-3)
    rv0 = _np(jso3_log(jnp.asarray(R))) + np.float32(0.01)
    t0 = t + np.float32(0.05)
    w = mask.astype(np.float32)
    rv_g, t_g = tpnp._lm_refine(_t(rv0), _t(t0), _t(K), _t(X), _t(x), _t(w))
    rv_j, t_j = jpnp._lm_refine(jnp.asarray(rv0), jnp.asarray(t0), jnp.asarray(K), jnp.asarray(X),
                                jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_np(rv_g), _np(rv_j), atol=1e-4)
    np.testing.assert_allclose(_np(t_g), _np(t_j), atol=1e-4)


@pytest.mark.parametrize("outliers", [0.1, 0.4])
def test_pnp_ransac_with_jax_uniforms(outliers):
    """P3P RANSAC on the JAX-drawn samples: identical inlier masks, the same
    ``ok``, and the LM-polished pose within 1e-4 (rotation entries and
    translation)."""
    X, x, K, mask, sc = _scene(outliers=outliers)
    key = jax.random.key(35)
    kw = dict(num_hypotheses=128, reproj_threshold=8.0)
    ref = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(K), jnp.asarray(mask), **kw)
    u = _np(jax.random.uniform(key, (128, 3)))
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
    # The DLT generator runs too (its parity: tests/test_torch_fixed_ransac.py).
    u6 = _np(jax.random.uniform(key, (128, 6)))
    dlt = tpnp.pnp_ransac(None, _t(X), _t(x), _t(K), _t(mask, torch.bool), solver="dlt",
                          uniforms=_t(u6), **kw)
    assert bool(dlt.ok) and _rot_deg(_np(dlt.R), sc["R2"]) < 0.5
