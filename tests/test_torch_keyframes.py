"""The port's keyframe path of ``GlobalSfmEngine`` against the JAX engine, on
the CPU: flow-adaptive keyframe selection, keyframe window pairs, and the
batched PnP registration of the other frames.

Scene: ``tests/test_global_sfm.py::test_keyframed_registration``'s 20-view
1.5 deg/view orbit at 240x320 with 11-pixel patches, at that file's small
configuration and window 2. The JAX engine runs its stages once; the port's
stages run on the JAX stage before them. Each tolerance is stated where it is
used.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.pipeline import global_sfm as jglobal
from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine as JGlobal

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from sfmfromscratch_tpu_torch.pipeline.global_sfm import nanmedian_rows
from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore
from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error, camera_centers
from tests.render import render_sequence, write_sequence
from tests.test_global_sfm import _small_config

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

N = 20


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    images, K, poses, _ = render_sequence(np.random.default_rng(11), num_views=N,
                                          num_points=300, img_hw=(240, 320), patch=11,
                                          orbit_step_deg=1.5)
    d = tmp_path_factory.mktemp("kfseq")
    write_sequence(str(d), images)
    return dict(dir=str(d), K=K, poses=poses)


def _port(rendered, **kw):
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    return TGlobal(rendered["dir"], N, config=cfg, single_K=rendered["K"], pair_window=2,
                   device="cpu", **kw)


def _jax(rendered, **kw):
    return JGlobal(rendered["dir"], N, config=_small_config(), single_K=rendered["K"],
                   pair_window=2, **kw)


@pytest.fixture(scope="module")
def jax_features(rendered):
    return _jax(rendered, auto_run=False)._extract_all_features()


@pytest.fixture(scope="module")
def jax_registration(rendered, jax_features):
    """The JAX engine at ``keyframe_step=2`` up to ``_populate_map``, then
    ``_register_nonkeyframes`` with its registration matches, F-filter
    inliers and PnP key recorded."""
    eng = _jax(rendered, keyframe_step=2, auto_run=False)
    feats = jax_features
    eng._prepare_pair_selection(feats)
    eng._match_pairs(feats)
    eng._relative_poses()
    eng._motion_averaging()
    eng._build_tracks(feats)
    eng._triangulate()
    eng._populate_map()
    before = dict(points=eng.map.points().copy(), observations=eng.map.observations(),
                  poses=[(r.copy(), t.copy()) for r, t in eng.global_poses],
                  K=[k.copy() for k in eng.global_K])
    chunks, keys = [], []
    match_chunks = eng._match_pair_chunks
    filt = jglobal.ransac_fundamental_adaptive_batch
    next_key = eng._next_key

    def rec_chunks(f, pairs):
        for chunk, res, p1, p2 in match_chunks(f, pairs):
            chunks.append([chunk, res, p2, None])
            yield chunk, res, p1, p2

    def rec_filter(*a, **k):
        out = filt(*a, **k)
        chunks[-1][3] = out.inliers
        return out

    def rec_key():
        keys.append(next_key())
        return keys[-1]

    eng._match_pair_chunks, eng._next_key = rec_chunks, rec_key
    jglobal.ransac_fundamental_adaptive_batch = rec_filter
    try:
        eng._register_nonkeyframes(feats)
    finally:
        jglobal.ransac_fundamental_adaptive_batch = filt
    results = {}
    for chunk, res, p2, inl in chunks:
        idx, inl_np, p2_np = (np.asarray(v) for v in (res.indices, inl, p2))
        for r, k in enumerate(chunk):
            results[k] = (idx[r], inl_np[r], p2_np[r])
    return dict(eng=eng, feats=feats, before=before, results=results, pnp_key=keys[-1])


def test_nanmedian_rows_interpolates_like_numpy():
    """``nanmedian_rows`` is ``np.nanmedian`` (and ``jnp.nanmedian``) over
    rows with odd and even non-NaN counts and an all-NaN row; exact to
    float32 rounding (rtol 1e-6). ``torch.nanmedian`` alone returns the
    lower middle value at an even count."""
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 10, (5, 8)).astype(np.float32)
    d[0, :3] = np.nan             # 5 values: odd
    d[1, :2] = np.nan             # 6 values: even
    d[2, ::2] = np.nan            # 4 values: even
    d[4, :] = np.nan              # none
    got = nanmedian_rows(torch.as_tensor(d)).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the all-NaN row
        ref = np.nanmedian(d, axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got, np.asarray(jnp.nanmedian(jnp.asarray(d), axis=1)),
                               rtol=1e-6, equal_nan=True)
    assert float(torch.nanmedian(torch.as_tensor(d[1]))) != pytest.approx(float(ref[1]))


@pytest.mark.parametrize("flow_px", [3.0, 25.0])
def test_select_keyframes_matches_jax(rendered, jax_features, flow_px):
    """On the JAX engine's features, ``_select_keyframes`` picks JAX's exact
    keyframe list at a dense (3 px) and at the JAX test's (25 px) flow
    target, with the same warning; the last image is always a keyframe."""
    jeng = _jax(rendered, keyframe_step="auto", keyframe_flow_px=flow_px, auto_run=False)
    feats = jax_features
    jeng._select_keyframes(feats)
    teng = _port(rendered, keyframe_step="auto", keyframe_flow_px=flow_px, auto_run=False)
    teng._select_keyframes(interop.features_from_numpy(jax.device_get(feats)))
    assert teng._auto_kfs == jeng._auto_kfs
    assert teng.keyframes[0] == 1 and teng.keyframes[-1] == N
    assert teng.warnings == jeng.warnings
    if flow_px == 3.0:
        assert 5 < len(teng.keyframes) < N


def test_keyframe_lists_and_window_pairs(rendered):
    """``keyframes`` and ``_candidate_pairs`` at ``keyframe_step=3``: every
    third image plus the last, and window pairs over that subsequence, as
    the JAX engine lists them (``global_sfm.py:215-306``)."""
    teng = _port(rendered, keyframe_step=3, auto_run=False)
    jeng = _jax(rendered, keyframe_step=3, auto_run=False)
    assert teng.keyframed and teng.keyframes == jeng.keyframes == [1, 4, 7, 10, 13, 16, 19, 20]
    assert teng._candidate_pairs(None) == jeng._candidate_pairs(None)
    auto = _port(rendered, keyframe_step="auto", auto_run=False)
    assert auto.keyframed and auto.keyframes == list(range(1, N + 1))   # before selection


def test_register_nonkeyframes_matches_jax(rendered, jax_registration):
    """``_register_frames`` on JAX's map, registration matches and F-filter
    inliers, with the PnP uniforms JAX draws for its frame keys: every
    frame's pose lands on JAX's (rotation vectors within 2e-3 rad,
    translations within 2e-3 of the unit baseline scale), the same frames
    fail, and the same inlier observations join the map, up to 1% of them
    (a P3P hypothesis near a double root may pick a neighbouring inlier
    set)."""
    j = jax_registration
    jeng = j["eng"]
    teng = _port(rendered, keyframe_step=2, auto_run=False)
    interop.import_global_state(teng, jeng)
    teng.map = MapStore.from_arrays(j["before"]["points"], *j["before"]["observations"])
    teng.global_poses = [(r.copy(), t.copy()) for r, t in j["before"]["poses"]]
    teng.global_K = [k.copy() for k in j["before"]["K"]]
    non_kf = [f for f in range(1, N + 1) if f not in set(jeng.keyframes)]
    F = len(non_kf)
    reg_hyp = min(512, jeng._pnp_hyp)
    keys = jax.random.split(j["pnp_key"], F)
    u = np.stack([np.asarray(jax.random.uniform(keys[f], (reg_hyp, 3))) for f in range(F)])
    teng._register_frames(j["feats"].keypoints.capacity, non_kf, j["results"],
                          uniforms=torch.as_tensor(u))
    assert [w for w in teng.warnings if "registration failed" in w] == [
        w for w in jeng.warnings if "registration failed" in w]
    for f in non_kf:
        rt, tt = teng.global_poses[f - 1]
        rj, tj = jeng.global_poses[f - 1]
        np.testing.assert_allclose(rt, rj, atol=2e-3)
        np.testing.assert_allclose(tt, tj, atol=2e-3)
    t_obs, j_obs = teng.map.observations(), jeng.map.observations()
    n0 = len(j["before"]["observations"][0])
    jt = set(zip(j_obs[0][n0:].tolist(), j_obs[1][n0:].tolist()))
    tt_ = set(zip(t_obs[0][n0:].tolist(), t_obs[1][n0:].tolist()))
    assert len(jt ^ tt_) <= 0.01 * len(jt)


def _ate(eng, poses):
    rv = np.stack([r for r, _ in eng.global_poses])
    ts = np.stack([t for _, t in eng.global_poses])
    est = camera_centers(rv, ts)
    gt = np.stack([-R.T @ t for R, t in poses])
    return absolute_trajectory_error(est, gt) / np.linalg.norm(gt.max(0) - gt.min(0))


def test_keyframed_engine_passes_the_jax_gates(rendered):
    """``GlobalSfmEngine(keyframe_step=2)`` end to end on the CPU, held to
    ``test_keyframed_registration``'s gates: a pose for every frame, under
    2 px after BA, at most 2 failed registrations, ATE under 8% of the
    trajectory extent; the registration is timed as its own stage."""
    eng = _port(rendered, keyframe_step=2)
    assert len(eng.global_poses) == N
    assert eng.errors_before_after_ba[1] < 2.0
    assert sum("registration failed" in w for w in eng.warnings) <= 2
    assert 100 * _ate(eng, rendered["poses"]) < 8.0
    assert "register" in eng.stage_times


def test_auto_keyframed_engine_passes_the_jax_gates(rendered):
    """``keyframe_step="auto"`` at the JAX test's 25 px target, held to
    ``test_auto_keyframe_selection``'s gates: the selection warning, fewer
    keyframes than frames but more than 2, a pose for every frame, under
    2 px after BA."""
    eng = _port(rendered, keyframe_step="auto", keyframe_flow_px=25.0)
    assert any("auto keyframes" in w for w in eng.warnings)
    assert 2 < len(eng.keyframes) < N
    assert len(eng.global_poses) == N
    assert eng.errors_before_after_ba[1] < 2.0
