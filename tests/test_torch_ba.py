"""The port's bundle adjustment against the JAX package, on the CPU.

Problems come from ``tests/test_ba.py::_multi_view_problem`` (a seeded
synthetic multi-view scene, first camera fixed) and reach the port through
``interop.ba_problem_from_numpy``. Each tolerance is stated where it is used.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.ba import lm as jlm
from sfmfromscratch_tpu.ba import problem as jprob
from sfmfromscratch_tpu.ba import schur as jschur

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ba import lm as tlm
from sfmfromscratch_tpu_torch.ba import problem as tprob
from sfmfromscratch_tpu_torch.ba import schur as tschur
from tests.test_ba import _multi_view_problem

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _problems(seed=3, num_cams=5, num_pts=60, noise=0.5, perturb=0.02):
    jp, cams_gt, X_gt = _multi_view_problem(np.random.default_rng(seed), num_cams=num_cams,
                                            num_pts=num_pts, noise=noise, perturb=perturb)
    return jp, interop.ba_problem_from_numpy(jp), cams_gt, X_gt


def test_problem_residuals_and_padding_match_jax():
    """Residuals and costs to float32 rounding (1e-4 px, 1e-5 relative), the
    mean error to 1e-5 px, and ``pad_problem`` pads to the same shapes, so
    the dense gate sees the same counts."""
    jp, tp, cams_gt, X_gt = _problems(noise=0.3)
    np.testing.assert_allclose(_np(tprob.residuals(tp, tp.cam_params, tp.points)),
                               _np(jprob.residuals(jp, jp.cam_params, jp.points)), atol=1e-4)
    assert float(tprob.total_cost(tp, tp.cam_params, tp.points)) == pytest.approx(
        float(jprob.total_cost(jp, jp.cam_params, jp.points)), rel=1e-5)
    assert float(tprob.mean_reprojection_error(tp)) == pytest.approx(
        float(jprob.mean_reprojection_error(jp)), abs=1e-5)
    jpp, tpp = jprob.pad_problem(jp), tprob.pad_problem(tp)
    for a, b in zip(jpp, tpp):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
    assert bool(tpp.cam_fixed[tp.num_cameras:].all()) and float(tpp.obs_w[tp.num_obs:].abs().sum()) == 0
    assert float(tprob.mean_reprojection_error(tpp)) == pytest.approx(
        float(tprob.mean_reprojection_error(tp)), abs=1e-6)
    made = tprob.make_problem(_np(jp.cam_params), _np(jp.points), _np(jp.obs_cam), _np(jp.obs_pt),
                              _np(jp.obs_xy), _np(jp.K), cam_fixed=_np(jp.cam_fixed))
    for a, b in zip(made, tp):
        if a is not None:
            assert torch.equal(a, b)


def test_jacobian_blocks_match_jax():
    """Forward-mode Jacobian blocks: camera blocks to 5e-4 and point blocks
    to 5e-5 (entries of order 100 and 10: float32 rounding of two AD
    programs), residuals to 1e-4 px; a fixed camera's blocks are zero."""
    jp, tp, _, _ = _problems()
    Jc, Jp, r = jprob.jacobian_blocks(jp, jp.cam_params, jp.points)
    tJc, tJp, tr = tprob.jacobian_blocks(tp, tp.cam_params, tp.points)
    assert tJc.dtype == tJp.dtype == tr.dtype == torch.float32
    np.testing.assert_allclose(_np(tJc), _np(Jc), atol=5e-4, rtol=1e-5)
    np.testing.assert_allclose(_np(tJp), _np(Jp), atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tr), _np(r), atol=1e-4)
    fixed = _np(tp.cam_fixed)[_np(tp.obs_cam)]
    assert fixed.any() and np.all(_np(tJc)[fixed] == 0)


def _operands(jp, tp, lam=1e-3):
    Jc, Jp, r = jprob.jacobian_blocks(jp, jp.cam_params, jp.points)
    jop = jschur.build_normal_blocks(Jc, Jp, r, jp.obs_cam, jp.obs_pt, jp.num_cameras,
                                     jp.num_points, jnp.asarray(lam, jnp.float32))
    # Both sides from the same blocks, so the assembly alone is compared.
    top = tschur.build_normal_blocks(torch.as_tensor(np.array(Jc)), torch.as_tensor(np.array(Jp)),
                                     torch.as_tensor(np.array(r)), tp.obs_cam, tp.obs_pt,
                                     tp.num_cameras, tp.num_points, torch.tensor(lam))
    return jop, top


def test_build_normal_blocks_matches_jax():
    """Damped U, V^-1, W, gc, gp from the same Jacobian blocks: 1e-5
    relative to each block's scale (float32 segment sums in another order;
    V^-1 through the closed-form SPD Cholesky on both sides)."""
    jp, tp, _, _ = _problems()
    jop, top = _operands(jp, tp)
    for name in ("U", "Vinv", "W", "gc", "gp"):
        a, b = _np(getattr(top, name)), _np(getattr(jop, name))
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=1e-4, err_msg=name)


def test_schur_solvers_match_each_other_and_jax():
    """The dense Cholesky solve and 200-step PCG of the port agree with each
    other to 1e-3 of the step's scale (PCG converges to float32 noise), and
    each with its JAX counterpart on the same operands to 1e-3; the
    matrix-free matvec equals the dense S to 1e-4 relative."""
    jp, tp, _, _ = _problems(perturb=0.05)
    jop, top = _operands(jp, tp, lam=1e-2)
    dc_d, dp_d = tschur.solve_schur_dense(top)
    dc_c, dp_c = tschur.solve_schur(top, cg_iters=200)
    jdc_d, jdp_d = jschur.solve_schur_dense(jop)
    jdc_c, jdp_c = jschur.solve_schur(jop, cg_iters=200)
    sc = np.abs(_np(dc_d)).max()
    sp = np.abs(_np(dp_d)).max()
    np.testing.assert_allclose(_np(dc_c), _np(dc_d), atol=1e-3 * sc)
    np.testing.assert_allclose(_np(dp_c), _np(dp_d), atol=1e-3 * sp)
    np.testing.assert_allclose(_np(dc_d), _np(jdc_d), atol=1e-3 * sc)
    np.testing.assert_allclose(_np(dp_d), _np(jdp_d), atol=1e-3 * sp)
    np.testing.assert_allclose(_np(dc_c), _np(jdc_c), atol=1e-3 * sc)
    C = tp.num_cameras
    S = tschur.dense_schur_from_blocks(top.U, top.Vinv, tschur.point_cam_blocks(
        top.W, top.obs_cam, top.obs_pt, C, tp.num_points))
    x = torch.as_tensor(np.random.default_rng(40).standard_normal((C, 6)).astype(np.float32))
    mv = _np(tschur.schur_matvec(top, x)).reshape(-1)
    np.testing.assert_allclose(mv, _np(S @ x.reshape(-1)), atol=1e-4 * np.abs(mv).max())
    assert tschur.dense_gate(16, 1024) and not tschur.dense_gate(64, 128)
    assert not tschur.dense_gate(16, 10_000_000)


@pytest.mark.parametrize("use_dense,huber_delta", [(True, 0.0), (False, 0.0), (True, 1.0)])
def test_bundle_adjust_matches_jax(use_dense, huber_delta, monkeypatch):
    """LM on a perturbed 5-camera scene, on each Schur backend: the same
    ``iterations_used`` and final cost within 1e-4 relative, cameras within
    1e-3. The PCG run turns Eisenstat-Walker forcing off
    (``SFM_NO_CG_FORCING``, read by both packages): with forcing on, the
    solve may stop only after a step solved to eta <= 2e-3, which happens
    once relative decreases fall to ~4e-6, the float32 noise floor of the
    cost, so the stopping iteration there is decided by rounding. The
    forcing path is held to JAX iteration by iteration below. The Huber case
    (delta 1 px) reweights the residuals by IRLS on both sides."""
    if not use_dense:
        monkeypatch.setenv("SFM_NO_CG_FORCING", "1")
    jp, tp, cams_gt, _ = _problems(seed=4, perturb=0.05, noise=0.3)
    kw = dict(ftol=1e-3, use_dense=use_dense, huber_delta=huber_delta)
    a = jlm.bundle_adjust(jp, **kw)
    b = tlm.bundle_adjust(tp, **kw)
    assert b.iterations_used == int(a.iterations_used) >= 3
    assert float(b.final_cost) == pytest.approx(float(a.final_cost), rel=1e-4)
    assert float(b.final_mean_error) == pytest.approx(float(a.final_mean_error), rel=1e-4)
    assert float(b.initial_mean_error) == pytest.approx(float(a.initial_mean_error), rel=1e-5)
    np.testing.assert_allclose(_np(b.cam_params), _np(a.cam_params), atol=1e-3)
    assert float(b.final_mean_error) < 0.5 * float(b.initial_mean_error)


def test_bundle_adjust_forcing_trajectory_matches_jax():
    """PCG with forcing (the default), stopped after k = 1..6 iterations:
    the cost after each prefix agrees with JAX's to 1e-4 relative, so both
    take the same accept/reject and eta path until the noise floor."""
    jp, tp, _, _ = _problems(seed=5)
    for k in range(1, 7):
        a = jlm.bundle_adjust(jp, ftol=1e-6, use_dense=False, max_iters=k)
        b = tlm.bundle_adjust(tp, ftol=1e-6, use_dense=False, max_iters=k)
        assert b.iterations_used == int(a.iterations_used) == k
        assert float(b.final_cost) == pytest.approx(float(a.final_cost), rel=1e-4), k


def test_bundle_adjust_on_padded_problem_and_resolve(monkeypatch):
    """The padded problem (frozen cameras, zero-weight observations) gives
    the unpadded result; the backend resolves as in the JAX package."""
    jp, tp, _, _ = _problems(seed=6)
    a = tlm.bundle_adjust(tp, ftol=1e-3)
    b = tlm.bundle_adjust(tprob.pad_problem(tp), ftol=1e-3)
    assert a.iterations_used == b.iterations_used
    assert float(b.final_mean_error) == pytest.approx(float(a.final_mean_error), rel=1e-4)
    assert tlm.resolve_dense(None, 16, 1024) == jlm.resolve_dense(None, 16, 1024) is True
    monkeypatch.setenv("SFM_NO_DENSE_SCHUR", "1")
    assert tlm.resolve_dense(None, 16, 1024) is False and tlm.resolve_dense(True, 16, 1024)
