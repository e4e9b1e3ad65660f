"""The port's incremental ``SfmEngine`` against the JAX engine, on the CPU.

Scenes are ``tests/test_golden_e2e.py``'s: ``render_sequence(default_rng(21),
num_points=90, 160x220, f=300)`` at that test's configuration (300 keypoints,
2 levels x1.2, ratio 0.85, 1,024 hypotheses, 40 LM iterations, ftol 1e-5,
scale 0.5), with 3 views for the whole engine and 4 for the chain. The
stage tests feed the port the JAX engine's pair geometry, and hand it the
uniforms JAX draws, so both packages score the same hypotheses. Each
tolerance is stated where it is used.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu import config as jconfig
from sfmfromscratch_tpu.ba import lm as jlm
from sfmfromscratch_tpu.ba import problem as jprob
from sfmfromscratch_tpu.pipeline import incremental as jinc

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ba import lm as tlm
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error, camera_centers
from tests.render import render_sequence, write_sequence

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jax_config(seed=5):
    return jconfig.PipelineConfig(
        extractor=jconfig.ExtractorConfig(
            num_interest_points=300, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
            feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2),
        matcher=jconfig.MatcherConfig(ratio_threshold=0.85, max_matches=300),
        ransac=jconfig.RansacConfig(max_iterations=1024),
        ba=jconfig.BundleAdjustConfig(max_lm_iters=40, ftol=1e-5),
        scale_factor=0.5, seed=seed,
    )


def _port_config(seed=5):
    return interop.config_from_dict(dataclasses.asdict(_jax_config(seed)))


def _scene(tmp_path_factory, views):
    images, K, poses, _ = render_sequence(
        np.random.default_rng(21), num_views=views, num_points=90, img_hw=(160, 220), f=300.0,
        step_t=(-0.2, 0.02, 0.03), step_r=(0.008, -0.02, 0.005))
    d = tmp_path_factory.mktemp(f"seq{views}")
    write_sequence(str(d), images)
    K_half = K.copy()
    K_half[:2] *= 0.5   # features live on images at scale 0.5
    return dict(dir=str(d), K=K_half, poses=poses, n=views)


@pytest.fixture(scope="module")
def scene3(tmp_path_factory):
    return _scene(tmp_path_factory, 3)


@pytest.fixture(scope="module")
def scene4(tmp_path_factory):
    return _scene(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def jax_run(scene3):
    return jinc.SfmEngine(scene3["dir"], scene3["n"], config=_jax_config(), single_K=scene3["K"])


def _ate_over_extent(global_poses, gt_poses):
    """ATE over trajectory extent with the identity base camera (image 1)
    included: with 3 views there are only 2 BA cameras, and a similarity
    aligns any 2 centres exactly."""
    gp = [(np.zeros(3), np.zeros(3))] + list(global_poses)
    est = camera_centers(np.stack([rv for rv, _ in gp]), np.stack([t for _, t in gp]))
    gt = np.stack([-(R.T @ t) for R, t in gt_poses[:len(est)]])
    return absolute_trajectory_error(est, gt) / float(np.linalg.norm(gt.max(0) - gt.min(0)))


def test_engine_matches_jax_engine(scene3, jax_run, tmp_path):
    """The whole engine on the CPU against the JAX engine on the same files.
    Each draws its own RANSAC samples, so the gates are seed spreads
    measured on this scene over ``config.seed`` 0-4 (both packages):
    post-BA reprojection error JAX 0.059-0.104 px, port 0.068-0.115 px, so
    within 0.08 px of JAX's; ATE over extent JAX 0.087-0.333, port
    0.069-0.171, so at most JAX's plus 0.25; tracks JAX 62-68, port 58-64,
    so within 15% of JAX's. Every camera is registered by both."""
    eng = tinc.SfmEngine(scene3["dir"], scene3["n"], config=_port_config(), single_K=scene3["K"],
                         device="cpu", model_name="m", output_dir=str(tmp_path))
    assert len(eng.global_poses) == len(jax_run.global_poses) == scene3["n"] - 1
    e0, e1 = eng.errors_before_after_ba
    j0, j1 = jax_run.errors_before_after_ba
    assert np.isfinite([e0, e1]).all() and e1 < e0
    assert abs(e1 - j1) <= 0.08, (e1, j1)
    ate_p = _ate_over_extent(eng.global_poses, scene3["poses"])
    ate_j = _ate_over_extent(jax_run.global_poses, scene3["poses"])
    assert ate_p <= ate_j + 0.25, (ate_p, ate_j)
    assert abs(eng.map.num_tracks - jax_run.map.num_tracks) <= 0.15 * jax_run.map.num_tracks
    assert set(eng.pair_geometry) == set(jax_run.pair_geometry)
    assert set(eng.stage_times) >= {"features", "matching", "filter", "bootstrap", "chain", "ba"}
    assert eng.ba_result.iterations_used <= 40 and eng.filter_hyps_used.shape == (1,)

    # save_data writes the JAX engine's npz layout; load(show=False) reads it.
    jax_run.model_name, jax_run.output_dir = "j", str(tmp_path)
    jax_run.save_data()
    got = tinc.SfmEngine.load("m", str(tmp_path), show=False)
    ref = jinc.SfmEngine.load("j", str(tmp_path), show=False)
    assert sorted(got) == sorted(ref)
    for k in got:
        assert got[k].dtype == ref[k].dtype and got[k].shape[1:] == ref[k].shape[1:], k
    assert os.path.exists(tmp_path / "m.npz")
    # load() opens the 3-D viewer by default, as the JAX engine's does.
    import matplotlib

    from sfmfromscratch_tpu_torch.viz.scatter3d import V3D

    matplotlib.use("Agg", force=True)
    viewer = tinc.SfmEngine.load("m", str(tmp_path))
    assert isinstance(viewer, V3D)
    np.testing.assert_array_equal(viewer.points_3d, got["p3d"])
    assert len(viewer.scatter_plot) == len(np.unique(got["frame_idx"]))


def test_global_ba_on_jax_front(scene3):
    """The JAX engine's front (features to chain) imported into the port's
    engine, and the port's global BA against the JAX BA on the same padded
    problem. The engine fixes no camera, so the normal equations are damped
    only by LM along the 7-dof similarity gauge, and the steps along it are
    sensitive to float32 rounding: the accept/reject sequences of the two
    packages part after about 7 iterations (measured: iteration 8). So: the
    cost after each of the first 7 iterations agrees to 1e-3 relative, the
    starting error to 1e-4, and the engine's final error lies within 10% of
    JAX's after the full 40 iterations (measured 6%)."""
    jeng = jinc.SfmEngine(scene3["dir"], scene3["n"], config=_jax_config(), single_K=scene3["K"],
                          auto_run=False)
    jeng._try_run_front_fused(jeng._extract_all_features())
    teng = tinc.SfmEngine(scene3["dir"], scene3["n"], config=_port_config(), single_K=scene3["K"],
                          device="cpu", auto_run=False)
    interop.import_engine_state(teng, jeng)
    assert teng.map.num_observations == jeng.map.num_observations
    frames, tracks, xy = jeng.map.observations()
    cams = np.array([np.hstack([rv, t]) for rv, t in jeng.global_poses])
    jp = jprob.pad_problem(jprob.make_problem(cams, jeng.map.points(), frames, tracks, xy,
                                              np.stack(jeng.global_K)))
    tp = interop.ba_problem_from_numpy(jp)
    ba = _jax_config().ba
    kw = dict(cg_iters=60, ftol=ba.ftol)
    for k in range(1, 8):
        a = jlm.bundle_adjust(jp, max_iters=k, **kw)
        b = tlm.bundle_adjust(tp, max_iters=k, **kw)
        assert float(b.final_cost) == pytest.approx(float(a.final_cost), rel=1e-3), k
    ref = jlm.bundle_adjust(jp, max_iters=ba.max_lm_iters, **kw)
    teng._global_ba()
    assert teng.errors_before_after_ba[0] == pytest.approx(float(ref.initial_mean_error), rel=1e-4)
    assert teng.errors_before_after_ba[1] == pytest.approx(float(ref.final_mean_error), rel=0.1)
    assert teng.errors_before_after_ba[1] < teng.errors_before_after_ba[0]
    assert teng.map.num_tracks == jeng.map.num_tracks
    assert len(teng.global_poses) == len(jeng.global_poses)


def _points_close(got, ref):
    """Triangulated points relative to their depth: at least 90% within
    1e-3 and all within 2e-2. On these 80x110 images the far points have
    little parallax, so their depth amplifies the 1e-4 differences of the
    poses and the rounding of the DLT SVD and the Gauss-Newton LU solves
    (``test_triangulation_matches_jax``); measured: 93% within 1e-3, worst
    5.8e-3."""
    d = np.abs(ref[:, 2:3]) + 1e-6
    err = np.abs(got / d - ref / d).max(-1)
    assert (err <= 1e-3).mean() >= 0.90 and err.max() <= 2e-2, (np.sort(err)[-5:])


def _jax_stage_uniforms(key, stages, stage_size, s):
    out = []
    for _ in range(stages):
        key, sub = jax.random.split(key)
        out.append(_np(jax.random.uniform(sub, (stage_size, s))))
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_pairs(scene4):
    """The JAX engine's pair geometry on 4 views (matching and F-filter)."""
    jeng = jinc.SfmEngine(scene4["dir"], scene4["n"], config=_jax_config(), single_K=scene4["K"],
                          auto_run=False)
    jeng._match_pairs(jeng._extract_all_features())
    return jeng


def _bootstrap_tables(inl, X, idx2, kp_capacity, max_points):
    """The bootstrap's track table and points buffer, as the JAX engine
    builds them (numpy assignment: the last duplicate wins)."""
    tid = np.cumsum(inl) - 1
    keep = inl & (tid < max_points)
    points0 = np.zeros((max_points, 3), np.float32)
    points0[tid[keep]] = X[keep]
    kp0 = np.full(kp_capacity, -1, np.int32)
    kp0[idx2[keep]] = tid[keep]
    return kp0, points0, min(int(inl.sum()), max_points)


def _duplicate_keypoints(pg0, pg1, count=6):
    """idx2 of frame 0 with ``count`` extra rows pointed at keypoints of the
    shared image that frame 1 links through, so two accepted matches of
    frame 0 write one keypoint of the next table."""
    idx2 = pg0.idx2.copy()
    linked_next = set(pg1.idx1[pg1.mask].tolist())
    targets = [r for r in np.nonzero(pg0.mask)[0] if int(idx2[r]) in linked_next]
    donors = [r for r in np.nonzero(pg0.mask)[0] if int(idx2[r]) not in linked_next]
    pairs = list(zip(targets[:count], donors[:count]))
    for a, b in pairs:
        idx2[b] = idx2[a]
    return idx2, pairs


@pytest.mark.parametrize("case", ["plain", "duplicates", "capacity"])
def test_bootstrap_and_chain_scan_match_jax(scene4, jax_pairs, case):
    """Bootstrap and the 2-frame PnP chain on the JAX engine's pair geometry
    and the JAX-drawn uniforms. Bootstrap: identical inliers, pose within
    1e-4, points within 1e-3 of their depth. Chain: identical observation
    records (``obs_track``), the same ``n_points`` and ``ok`` flags, poses
    within 1e-4, points within 1e-3 of their depth. ``duplicates`` points
    extra matches of frame 0 at keypoints that frame 1 links through (the
    last write must win, as in XLA); ``capacity`` sets ``max_points`` just
    above the bootstrap's tracks, so new tracks are dropped."""
    rc = _jax_config().ransac
    K = scene4["K"].astype(np.float32)
    pg = jax_pairs.pair_geometry
    hyp = rc.max_hypotheses()
    boot_key = jax.random.key(51)
    ref_b = jinc._bootstrap_device(boot_key, pg[(1, 2)].p1, pg[(1, 2)].p2, K, K, pg[(1, 2)].mask,
                                   hyp, rc.epipolar_threshold, stage_size=rc.stage_size,
                                   adaptive=True)
    u = _jax_stage_uniforms(boot_key, hyp // rc.stage_size, rc.stage_size, 8)
    g12 = interop.pair_geometry_from_numpy(pg[(1, 2)])
    got_b = tinc.bootstrap(None, g12.p1, g12.p2, g12.K1, g12.K2, g12.mask, hyp,
                           rc.epipolar_threshold, stage_size=rc.stage_size, uniforms=_t(u))
    inl = _np(ref_b[0])
    np.testing.assert_array_equal(_np(got_b[0]), inl)
    _points_close(_np(got_b[1])[inl], _np(ref_b[1])[inl])
    np.testing.assert_allclose(_np(got_b[2]), _np(ref_b[2]), atol=1e-4)
    np.testing.assert_allclose(_np(got_b[3]), _np(ref_b[3]), atol=1e-4)

    kp_cap = len(jax_pairs._kp_tracks[2])
    max_points = 4096 if case != "capacity" else int(inl.sum()) + 15
    kp0, points0, n0 = _bootstrap_tables(inl, _np(ref_b[1]), pg[(1, 2)].idx2, kp_cap, max_points)
    frames = [pg[(2, 3)], pg[(3, 4)]]
    idx2 = [f.idx2 for f in frames]
    if case == "duplicates":
        idx2[0], dups = _duplicate_keypoints(frames[0], frames[1])
        assert len(dups) >= 3
    stack = lambda xs: np.stack(xs)
    args = (stack([f.p1 for f in frames]), stack([f.p2 for f in frames]),
            stack([f.idx1 for f in frames]), stack(idx2), stack([f.mask for f in frames]),
            np.stack([K, K]))
    pnp_hyp = rc.pnp_num_iterations()
    keys = jax.random.split(jax.random.key(52), 2)
    ref = jinc._chain_scan_device(
        keys, *(jnp.asarray(a) for a in args), jnp.ones(2, bool), jnp.asarray(kp0),
        jnp.asarray(points0), jnp.asarray(n0, jnp.int32), ref_b[4],
        pnp_hyp, rc.pnp_reproj_threshold, max_points, kp_cap)
    uc = np.stack([_np(jax.random.uniform(k, (pnp_hyp, 3))) for k in keys])
    got = tinc.chain_scan(None, *(_t(a) for a in args), _t(kp0), _t(points0), n0,
                          _t(_np(ref_b[4])), pnp_hyp, rc.pnp_reproj_threshold, uniforms=_t(uc))
    rv, ts, oks, ninl, obs_track, obs_xy, points, n_points = (_np(v) for v in got)
    np.testing.assert_array_equal(oks, _np(ref[2]))
    np.testing.assert_array_equal(obs_track, _np(ref[4]))
    np.testing.assert_array_equal(ninl, _np(ref[3]))
    assert int(n_points) == int(ref[7])
    # Frame 1's pose within 1e-4. Frame 2 registers on points that frame 1
    # triangulated, whose low-parallax depth error (``_points_close``) moves
    # its PnP pose: within 5e-4 (measured up to 1.9e-4).
    np.testing.assert_allclose(rv[0], _np(ref[0])[0], atol=1e-4)
    np.testing.assert_allclose(ts[0], _np(ref[1])[0], atol=1e-4)
    np.testing.assert_allclose(rv, _np(ref[0]), atol=5e-4)
    np.testing.assert_allclose(ts, _np(ref[1]), atol=5e-4)
    np.testing.assert_array_equal(obs_xy, _np(ref[5]))
    n = int(n_points)
    _points_close(points[:n], _np(ref[6])[:n])
    M = frames[0].mask.shape[0]
    new0 = obs_track[0, M:] >= 0
    assert oks.all() and new0.sum() > 0 and (obs_track[1, :M] >= 0).sum() > 0
    if case == "capacity":
        assert n == max_points
    if case == "duplicates":
        written = (obs_track[0, :M] >= 0) | new0
        assert any(written[a] and written[b] for a, b in dups)


def test_scatter_last_matches_numpy():
    """Duplicate slots keep the last row, the drop slot is ignored, and
    untouched slots keep the table's value: numpy fancy assignment."""
    r = np.random.default_rng(53)
    table = r.integers(-1, 50, 40)
    idx = r.integers(0, 41, 300)            # 40 = dropped
    vals = r.integers(0, 1000, 300)
    ref = table.copy()
    keep = idx < 40
    ref[idx[keep]] = vals[keep]
    got = tinc.scatter_last(_t(table), _t(idx), _t(vals))
    np.testing.assert_array_equal(_np(got), ref)
