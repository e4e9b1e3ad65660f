"""The port's focal self-calibration against the JAX package, on the CPU.

The problem is ``tests/test_ba.py::_focal_observable_problem`` (8 cameras,
300 points, 0.3 px noise, K 6% too long), built from the same seed for both
packages. The engines run on small rendered sequences at
``tests/test_pipeline.py``'s small configuration. Each tolerance is stated
where it is used.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.ba import lm_core as jcore
from sfmfromscratch_tpu.ba import problem as jprob
from sfmfromscratch_tpu.ba import schur as jschur
from sfmfromscratch_tpu.ba.selfcal import bundle_adjust_selfcal as jselfcal
from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine as JGlobal
from sfmfromscratch_tpu.pipeline.incremental import SfmEngine as JEngine

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ba import lm_core as tcore
from sfmfromscratch_tpu_torch.ba import schur as tschur
from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust as tbundle_adjust
from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal as tselfcal
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine as TEngine
from tests.render import render_sequence, write_sequence
from tests.test_ba import _focal_observable_problem
from tests.test_pipeline import _small_config

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

KW = dict(max_iters=30, cg_iters=60, ftol=1e-12)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def problems():
    jp = _focal_observable_problem(np.random.default_rng(5))
    return jp, interop.ba_problem_from_numpy(jp)


@pytest.fixture(scope="module")
def jax_selfcal(problems):
    res, s = jselfcal(problems[0], **KW)
    return res, float(s)


def test_scale_focal_and_border_jacobian_match_jax(problems):
    """``scale_focal`` scales fx and fy only; the border Jacobian d r / d s
    agrees with JAX's to 1e-5 relative of its largest entry, stays float32
    (no promotion of the 0-dim ``s``), and is zero on padded observations."""
    jp, tp = problems
    s = 0.97
    jps = jcore.scale_focal(jp, jnp.float32(s))
    tps = tcore.scale_focal(tp, torch.tensor(s))
    np.testing.assert_allclose(_np(tps.K), np.asarray(jps.K), rtol=1e-7)
    assert torch.equal(tps.K[:, 0, 1:], tp.K[:, 0, 1:]) and torch.equal(tps.K[:, 2], tp.K[:, 2])
    _, _, jr = jprob.jacobian_blocks(jps, jp.cam_params, jp.points)
    _, _, tr = tcore.jacobian_blocks(tps, tp.cam_params, tp.points)
    j_js = np.asarray(jcore._selfcal_border_jacobian(jp, jps, jr, jnp.float32(s)))
    t_js = tcore._selfcal_border_jacobian(tp, tps, tr, torch.tensor(s))
    assert t_js.dtype == torch.float32
    np.testing.assert_allclose(_np(t_js), j_js, atol=1e-5 * np.abs(j_js).max())
    pad = tp._replace(obs_w=tp.obs_w.clone())
    pad.obs_w[:10] = 0.0
    border = tcore._selfcal_border_jacobian(pad, pad, tr, torch.tensor(s))
    assert float(border[:10].abs().max()) == 0.0


def test_solve_bordered_one_step_matches_jax(problems):
    """One bordered solve on the same operands (JAX's Jacobian blocks,
    residuals and border at s = 0.97, damping 1e-2, camera 0 frozen, PCG run
    to 200 iterations with no forcing): the camera step, point step and
    focal step agree with JAX's to rtol 1e-4 of each one's largest entry.
    At damping 1e-3 the system's conditioning leaves either float32 solve
    2e-4 from the float64 one, so the damping is 1e-2, where both are within
    5e-5 of it."""
    jp, tp = problems
    s = jnp.float32(0.97)
    jps = jcore.scale_focal(jp, s)
    Jc, Jp, r = jprob.jacobian_blocks(jps, jp.cam_params, jp.points)
    Js = jcore._selfcal_border_jacobian(jp, jps, r, s)
    lam, iters = 1e-2, 200
    C, P = jp.num_cameras, jp.num_points
    jop = jschur.build_normal_blocks(Jc, Jp, r, jp.obs_cam, jp.obs_pt, C, P, jnp.float32(lam))
    jdc, jdp, jds = jcore._solve_bordered(jop, Js, Jc, Jp, r, jnp.float32(lam), iters,
                                          jnp.float32(0.0), lambda x: x, jp.cam_fixed)
    t = lambda a: torch.as_tensor(np.array(a))
    top = tschur.build_normal_blocks(t(Jc), t(Jp), t(r),
                                     tschur.schur_plans(tp.obs_cam, tp.obs_pt, C, P),
                                     torch.tensor(lam))
    tdc, tdp, tds = tcore._solve_bordered(top, t(Js), t(Jc), t(Jp), t(r), torch.tensor(lam),
                                          iters, torch.tensor(0.0), tp.cam_fixed)
    for got, ref in ((tdc, jdc), (tdp, jdp), (tds, jds)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, atol=1e-4 * np.abs(ref).max())
    assert float(tdc[0].abs().max()) == 0.0   # the frozen camera does not move


def test_selfcal_matches_jax_and_recovers_focal(problems, jax_selfcal):
    """``bundle_adjust_selfcal`` on the focal problem: ``s`` within 2e-3 of
    JAX's (and within 0.01 of 1/1.06, the JAX test's gate), the final mean
    error within 1% of JAX's and under the 0.35 px noise floor, below the
    fixed-K solve's; ``s`` is a float32 0-dim tensor."""
    res_j, s_j = jax_selfcal
    res, s = tselfcal(problems[1], **KW)
    assert s.dtype == torch.float32 and s.dim() == 0
    assert abs(float(s) - s_j) < 2e-3
    assert abs(float(s) - 1 / 1.06) < 0.01
    e, e_j = float(res.final_mean_error), float(res_j.final_mean_error)
    assert abs(e - e_j) <= 0.01 * e_j
    assert e < 0.35
    assert e < float(tbundle_adjust(problems[1], **KW).final_mean_error)


def test_selfcal_has_no_dense_path(problems):
    """The bordered solve is PCG only: ``lm_run(selfcal=True,
    use_dense=True)`` raises, as in JAX, even where the dense gate passes."""
    with pytest.raises(ValueError):
        tcore.lm_run(problems[1], selfcal=True, use_dense=True, huber_delta=0.0, max_iters=1,
                     cg_iters=5, init_damping=1e-3, damping_up=4.0, damping_down=0.5, ftol=1e-2)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    images, K, poses, _ = render_sequence(np.random.default_rng(5), num_views=4, num_points=110)
    d = tmp_path_factory.mktemp("selfcal_seq")
    write_sequence(str(d), images)
    return str(d), K


@pytest.mark.parametrize("which", ["jax", "port"])
def test_engine_refine_focal(which, sequence):
    """``SfmEngine(refine_focal=True)`` at the true focal, each package held
    to ``tests/test_parallel.py::test_engine_selfcal_on_mesh``'s gates: the
    warning, BA not worse and under 3 px, and the scale within 5% of 1.
    The port also rescales every ``global_K`` by the scale."""
    d, K = sequence
    if which == "jax":
        eng = JEngine(d, 4, config=_small_config(), single_K=K, refine_focal=True)
    else:
        cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
        eng = TEngine(d, 4, config=cfg, single_K=K, refine_focal=True, device="cpu")
        for Kc in eng.global_K:
            np.testing.assert_allclose(Kc[:2, :2], K[:2, :2] * eng.focal_scale, rtol=1e-12)
            np.testing.assert_array_equal(Kc[:, 2], K[:, 2])
    assert [w for w in eng.warnings if w.startswith("focal self-calibration")] == [
        f"focal self-calibration: cumulative scale {eng.focal_scale:.4f}"]
    b, a = eng.errors_before_after_ba
    assert a <= b + 1e-6 and a < 3.0
    assert abs(eng.focal_scale - 1.0) < 0.05


def test_local_ba_does_not_self_calibrate(sequence):
    """Self-calibration runs in the final BA only, never in a local BA: the
    host chain with a local BA every camera warns once."""
    d, K = sequence
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    eng = TEngine(d, 4, config=cfg, single_K=K, refine_focal=True, local_ba_every=1,
                  device="cpu")
    assert "local_ba" in eng.stage_times
    assert sum(w.startswith("focal self-calibration") for w in eng.warnings) == 1


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    images, K, _, _ = render_sequence(np.random.default_rng(7), num_views=6, num_points=160,
                                      orbit_step_deg=5.0)
    d = tmp_path_factory.mktemp("selfcal_orbit")
    write_sequence(str(d), images)
    return str(d), K


def test_global_ba_rounds_self_calibrate_like_jax(orbit):
    """The global engine's BA rounds with ``refine_focal`` on JAX's map (the
    JAX engine's stages up to ``_populate_map`` on the 6-view 5 deg orbit,
    imported into the port): every round self-calibrates and rescales K
    (``global_sfm.py:1489-1495``), as in JAX, and the final error lands
    within 1% of JAX's. Here the shared focal is weakly determined: both
    solves stop at the 15-iteration cap, and the first round ends at
    scales 0.9847 (JAX) and 0.9690 (port) with mean errors 6e-6 px apart,
    so the cumulative scales are held to 0.05 of each other."""
    d, K = orbit
    jeng = JGlobal(d, 6, config=_small_config(), single_K=K, pair_window=3,
                   rel_num_hypotheses=512, refine_focal=True, auto_run=False)
    feats = jeng._extract_all_features()
    jeng._match_pairs(feats)
    jeng._relative_poses()
    jeng._motion_averaging()
    jeng._build_tracks(feats)
    jeng._triangulate()
    jeng._populate_map()
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    teng = TGlobal(d, 6, config=cfg, single_K=K, pair_window=3, rel_num_hypotheses=512,
                   refine_focal=True, device="cpu", auto_run=False)
    interop.import_engine_state(teng, jeng)
    err_before = None
    for r in range(jeng.ba_rounds):          # JGlobal.run()'s BA rounds
        jeng._global_ba(freeze_before=1)
        if err_before is None:
            err_before = jeng.errors_before_after_ba[0]
        if r < jeng.ba_rounds - 1 and jeng._regate_observations() == 0:
            break
    jeng.errors_before_after_ba = (err_before, jeng.errors_before_after_ba[1])
    teng._ba_rounds()
    jwarn = [w for w in jeng.warnings if w.startswith("focal self-calibration")]
    twarn = [w for w in teng.warnings if w.startswith("focal self-calibration")]
    rounds = [k for k in teng.stage_times if k.startswith("ba.round")]
    assert len(twarn) == len(jwarn) == len(rounds)
    assert abs(teng.focal_scale - jeng.focal_scale) < 0.05
    np.testing.assert_allclose(teng.global_K[0][0, 0], K[0, 0] * teng.focal_scale, rtol=1e-12)
    e, e_j = teng.errors_before_after_ba[1], jeng.errors_before_after_ba[1]
    assert abs(e - e_j) <= 0.01 * e_j


def test_global_engine_refine_focal(orbit):
    """``GlobalSfmEngine(refine_focal=True)`` runs to a result on the CPU:
    one self-calibration per BA round, BA not worse and under 2 px, and the
    cumulative scale finite and inside LM's [0.5, 2] clip per round. The
    scale's value is not gated here: on this 6-view orbit a shared focal is
    weakly observable, and over config.seed 0-7 JAX lands at 0.949-1.030
    and the port at 0.940-1.184 (both on the CPU), the port's seed 5 (the
    default) at 1.184 after a first round that starts at 0.69 px."""
    d, K = orbit
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    eng = TGlobal(d, 6, config=cfg, single_K=K, pair_window=3, rel_num_hypotheses=512,
                  refine_focal=True, device="cpu")
    rounds = [k for k in eng.stage_times if k.startswith("ba.round")]
    warns = [w for w in eng.warnings if w.startswith("focal self-calibration")]
    assert len(warns) == len(rounds) >= 1
    assert 0.5 ** len(rounds) <= eng.focal_scale <= 2.0 ** len(rounds)
    b, a = eng.errors_before_after_ba
    assert a <= b + 1e-6 and a < 2.0
    np.testing.assert_allclose(eng.global_K[0][0, 0], K[0, 0] * eng.focal_scale, rtol=1e-12)
