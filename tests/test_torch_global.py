"""The port's ``GlobalSfmEngine`` against the JAX engine, on the CPU.

Scene: ``tests/test_global_sfm.py``'s 6-view 5 deg/view orbit at that file's
configuration (400 keypoints, 2 levels x1.2, 384 hypotheses, 15 LM
iterations, window 3, 512 relative-pose hypotheses). The JAX engine runs once,
stage by stage, and each stage's state is kept, so the port's stages can be
run on the JAX stage before them (``interop.import_global_state``). Each
tolerance is stated where it is used.
"""

import copy
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.native.bindings import build_tracks as jbuild_tracks
from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine as JGlobal

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.native.bindings import build_tracks as tbuild_tracks
from sfmfromscratch_tpu_torch.ops.lie import so3_exp
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error
from tests.render import render_sequence, write_sequence
from tests.test_global_sfm import _small_config

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

_STATE = interop._GLOBAL_STATE + ("pair_geometry", "max_img", "warnings")


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    images, K, poses, X = render_sequence(np.random.default_rng(7), num_views=6,
                                          num_points=160, orbit_step_deg=5.0)
    d = tmp_path_factory.mktemp("gseq")
    write_sequence(str(d), images)
    return dict(dir=str(d), K=K, poses=poses, n=len(images))


def _snapshot(eng):
    return types.SimpleNamespace(**{k: copy.deepcopy(getattr(eng, k)) for k in _STATE
                                    if hasattr(eng, k)})


@pytest.fixture(scope="module")
def jax_stages(rendered, tmp_path_factory):
    """The JAX engine's ``run()``, stage by stage, with the state after each
    view-graph stage."""
    out = tmp_path_factory.mktemp("jout")
    eng = JGlobal(rendered["dir"], rendered["n"], config=_small_config(), single_K=rendered["K"],
                  model_name="jg", output_dir=str(out), pair_window=3, rel_num_hypotheses=512,
                  auto_run=False)
    feats = eng._extract_all_features()
    eng._match_pairs(feats)
    eng._relative_poses()
    stages = {"relative_poses": _snapshot(eng)}
    eng._motion_averaging()
    stages["motion_averaging"] = _snapshot(eng)
    eng._build_tracks(feats)
    stages["tracks"] = _snapshot(eng)
    eng._triangulate()
    stages["triangulate"] = _snapshot(eng)
    eng._populate_map()
    err_before = None
    for r in range(eng.ba_rounds):      # the rest of JGlobal.run()
        eng._global_ba(freeze_before=1)
        if err_before is None:
            err_before = eng.errors_before_after_ba[0]
        if r < eng.ba_rounds - 1 and eng._regate_observations() == 0:
            break
    eng.errors_before_after_ba = (err_before, eng.errors_before_after_ba[1])
    eng.save_data()
    stages["engine"] = eng
    return stages


@pytest.fixture(scope="module")
def port_engine(rendered, tmp_path_factory):
    out = tmp_path_factory.mktemp("tout")
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    return TGlobal(rendered["dir"], rendered["n"], config=cfg, single_K=rendered["K"],
                   model_name="tg", output_dir=str(out), pair_window=3, rel_num_hypotheses=512,
                   device="cpu")


def _port_bare(rendered, **kw):
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    return TGlobal(rendered["dir"], rendered["n"], config=cfg, single_K=rendered["K"],
                   pair_window=3, rel_num_hypotheses=512, device="cpu", auto_run=False, **kw)


def _rotations(poses):
    rv = torch.as_tensor(np.stack([r for r, _ in poses]), dtype=torch.float32)
    return so3_exp(rv).numpy().astype(np.float64)


def _rot_deg(A, B):
    return float(np.degrees(np.arccos(np.clip((np.trace(A @ B.T) - 1) / 2, -1, 1))))


@pytest.mark.parametrize("which", ["jax", "port"])
def test_engines_pass_the_global_fixture_gates(which, rendered, jax_stages, port_engine):
    """Both engines on the same files, each held to every gate of
    ``tests/test_global_sfm.py``: one pose per image with camera 0 the
    identity, BA not worse and under 2 px, rotations within 5 deg of the
    truth, ATE under 8% of the trajectory extent, over 40 tracks and over
    10 tracks of 3 views or more, and a saved model that loads. The port
    draws other RANSAC samples than JAX, so its numbers are another seed's."""
    eng = jax_stages["engine"] if which == "jax" else port_engine
    gt = rendered["poses"]
    assert len(eng.global_poses) == rendered["n"]
    rv0, t0 = eng.global_poses[0]
    assert np.allclose(rv0, 0, atol=1e-5) and np.allclose(t0, 0, atol=1e-5)
    err_before, err_after = eng.errors_before_after_ba
    assert err_after <= err_before + 1e-6 and err_after < 2.0
    R = _rotations(eng.global_poses)
    for c in range(len(R)):
        assert _rot_deg(R[c], gt[c][0] @ gt[0][0].T) < 5.0, c
    gt_c = np.stack([-Rg.T @ t for Rg, t in gt])
    est_c = np.stack([-Rc.T @ t for Rc, (_, t) in zip(R, eng.global_poses)])
    extent = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    assert absolute_trajectory_error(est_c, gt_c) / extent < 0.08
    assert eng.map.num_tracks > 40
    _, tracks, _ = eng.map.observations()
    assert (np.bincount(tracks, minlength=eng.map.num_tracks) >= 3).sum() > 10
    name = "jg" if which == "jax" else "tg"
    assert os.path.exists(os.path.join(eng.output_dir, f"{name}.npz"))
    if which == "port":
        data = TGlobal.load(name, output_dir=eng.output_dir, show=False)
        assert data["poses"].shape[0] == len(eng.global_poses) and data["p3d"].shape[1] == 3
        assert set(eng.stage_times) >= {"features", "matching", "filter", "relative_poses",
                                        "motion_averaging", "tracks", "triangulate", "ba",
                                        "ba.round1", "total"}
        assert len(eng.pair_geometry) == 2 * (5 + 4 + 3)


def test_motion_averaging_from_jax_relative_poses(rendered, jax_stages):
    """The port's cycle filter, repairs, rotation and translation averaging
    on the JAX engine's relative poses: the same edges dropped (identical
    weights and warnings), rotations within 0.05 deg and centres within 1e-3
    of the trajectory extent of JAX's (measured 0 deg and 5e-6)."""
    teng = _port_bare(rendered)
    interop.import_global_state(teng, jax_stages["relative_poses"])
    teng.warnings = list(jax_stages["relative_poses"].warnings)
    teng._motion_averaging()
    ref = jax_stages["motion_averaging"]
    np.testing.assert_array_equal(teng._edge_w, ref._edge_w)
    assert teng.warnings == ref.warnings
    for k in ref._edges:
        np.testing.assert_array_equal(teng._edge_inl[k], ref._edge_inl[k])
    Rr, Rg = np.asarray(ref.R_cams, np.float64), np.asarray(teng.R_cams, np.float64)
    gap = 2 * np.arcsin(np.clip(np.linalg.norm(Rr - Rg, axis=(1, 2)) / (2 * np.sqrt(2)), 0, 1))
    assert np.degrees(gap.max()) < 0.05
    cr = np.asarray(ref.c_cams, np.float64)
    extent = np.linalg.norm(cr.max(0) - cr.min(0))
    assert np.abs(np.asarray(teng.c_cams) - cr).max() <= 1e-3 * extent


def _bare_pair(C, seed=0, **graph_kw):
    """The doppelganger view graph of ``tests/test_graph_surgery.py`` in a
    bare JAX engine, and the same state in a bare port engine."""
    from tests.test_graph_surgery import _doppel_graph

    jeng, edges, poses = _doppel_graph(np.random.default_rng(seed), C=C, span=3,
                                       doppel=(5, 6), **graph_kw)
    teng = object.__new__(TGlobal)
    teng.max_img, teng.warnings, teng.stage_times = C, [], {}
    teng.rot_avg_iters, teng.trans_avg_iters = 64, 12
    teng.device = torch.device("cpu")
    interop.import_global_state(teng, jeng)
    return jeng, teng, poses


@pytest.mark.parametrize("graph", ["bridge_flip", "redemption_and_ban"])
def test_cycle_filter_and_repair_exact(graph):
    """The host view-graph surgery is the JAX code copied: on the
    doppelganger graphs of ``tests/test_graph_surgery.py`` the cycle filter
    leaves identical weights, inlier sets and warnings; then the whole
    averaging stage (redemption, rotation gate, repair) the same, with
    rotations within 0.05 deg of JAX's and the wrong edge dropped."""
    kw = dict(w_wrong=200.0) if graph == "bridge_flip" else dict(drop_edges=[(5, 7)],
                                                                  w_wrong=100.0)
    jeng, teng, poses = _bare_pair(10, **kw)
    jeng._filter_edges_by_cycles()
    teng._filter_edges_by_cycles()
    np.testing.assert_array_equal(teng._edge_w, jeng._edge_w)
    assert teng.warnings == jeng.warnings
    for k in jeng._edges:
        np.testing.assert_array_equal(teng._edge_inl[k], jeng._edge_inl[k])

    jeng, teng, poses = _bare_pair(10, **kw)
    jeng._motion_averaging()
    teng._motion_averaging()
    np.testing.assert_array_equal(teng._edge_w, jeng._edge_w)
    assert teng.warnings == jeng.warnings
    assert teng._edge_w[jeng._edges.index((5, 6))] == 0.0
    Rr, Rg = np.asarray(jeng.R_cams, np.float64), np.asarray(teng.R_cams, np.float64)
    gap = 2 * np.arcsin(np.clip(np.linalg.norm(Rr - Rg, axis=(1, 2)) / (2 * np.sqrt(2)), 0, 1))
    assert np.degrees(gap.max()) < 0.05


def test_connectivity_repair_restores_bridging_edges():
    """``tests/test_global_sfm.py``'s repair case on the port: the
    higher-prior-weight bridge comes back damped, a connected graph is left
    alone, and the JAX method gives the same weights on the same input."""
    def bare(cls):
        eng = object.__new__(cls)
        eng.max_img = 6
        eng._edges = [(1, 2), (2, 3), (4, 5), (5, 6), (3, 4), (2, 5)]
        eng._edge_w = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
        eng._edge_inl = {k: np.zeros(4, bool) for k in eng._edges}
        eng.warnings = []
        return eng

    inl_prev = {k: np.ones(4, bool) for k in bare(TGlobal)._edges}
    w_prev = np.array([1.0, 1.0, 1.0, 1.0, 0.4, 0.9])
    teng, jeng = bare(TGlobal), bare(JGlobal)
    teng._repair_connectivity(w_prev, inl_prev, "test")
    jeng._repair_connectivity(w_prev, inl_prev, "test")
    assert teng._edge_w[5] == pytest.approx(0.25 * 0.9) and teng._edge_w[4] == 0.0
    assert teng._edge_inl[(2, 5)].all()
    np.testing.assert_array_equal(teng._edge_w, jeng._edge_w)
    assert teng.warnings == jeng.warnings and "connectivity repair" in teng.warnings[0]
    before = teng._edge_w.copy()
    teng._repair_connectivity(w_prev, inl_prev, "test2")
    np.testing.assert_array_equal(teng._edge_w, before)


def _partition(track_of_node, nodes):
    """Tracks as a set of frozensets of nodes."""
    groups = {}
    for n in nodes:
        groups.setdefault(int(track_of_node[n]), set()).add(int(n))
    return {frozenset(g) for g in groups.values()}


def test_build_tracks_partitions_match_jax(rendered, jax_stages):
    """Union-find on the engine's inlier match edges and on random edges
    with conflicting duplicates: the same track ids (both packages run
    ``native/trackgraph.cpp``), hence the same partition of nodes into
    tracks, and the same tracks flagged invalid (two observations in one
    image) as the JAX bindings; then the port's ``_build_tracks`` stage on
    the JAX engine's averaged state gives the same observation lists and
    track ids."""
    r = np.random.default_rng(43)
    C, cap = 6, 50
    ea = r.integers(0, C * cap, 180)
    eb = r.integers(0, C * cap, 180)
    node_image = np.repeat(np.arange(C), cap)
    got = tbuild_tracks(ea, eb, C * cap, node_image=node_image)
    ref = jbuild_tracks(ea, eb, C * cap, node_image=node_image)
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    nodes = np.arange(C * cap)
    assert _partition(got[0], nodes) == _partition(ref[0], nodes)
    bad_got = _partition(got[0], nodes[~got[2][got[0]]])
    bad_ref = _partition(ref[0], nodes[~ref[2][ref[0]]])
    assert bad_got == bad_ref and len(bad_got) > 0

    teng = _port_bare(rendered)
    interop.import_global_state(teng, jax_stages["motion_averaging"])
    teng._build_tracks(teng._extract_all_features())
    ref = jax_stages["tracks"]
    assert teng._num_points == ref._num_points
    np.testing.assert_array_equal(teng._obs_cam, ref._obs_cam)
    np.testing.assert_array_equal(teng._obs_kp, ref._obs_kp)
    # Keypoint coordinates from the port's own features: ulps apart.
    np.testing.assert_allclose(teng._obs_xy, ref._obs_xy, rtol=0, atol=1e-4)
    obs = np.arange(len(ref._obs_pt))
    assert _partition(teng._obs_pt, obs) == _partition(ref._obs_pt, obs)
    np.testing.assert_array_equal(teng._obs_pt, ref._obs_pt)


def test_triangulate_from_jax_tracks(rendered, jax_stages):
    """Multiview triangulation and gating on the JAX engine's tracks and
    averaged poses: the same observations survive the gate; points of tracks
    seen 3 times or more agree within 1e-3 of their distance (measured
    1.4e-4), and every observation's reprojection error within 0.02 px
    (measured 0.0066). A 2-view track at this parallax is nearly free along
    its rays (its point moves up to 4% with equal error), so only its
    reprojection error is compared."""
    teng = _port_bare(rendered)
    interop.import_global_state(teng, jax_stages["tracks"])
    teng._triangulate()
    ref = jax_stages["triangulate"]
    jeng = jax_stages["engine"]
    np.testing.assert_array_equal(teng._obs_cam, ref._obs_cam)
    np.testing.assert_array_equal(teng._obs_pt, ref._obs_pt)
    X = np.asarray(jeng._X)
    rel = np.linalg.norm(teng._X - X, axis=1) / np.linalg.norm(X, axis=1)
    nobs = np.bincount(ref._obs_pt, minlength=len(X))
    assert rel[nobs >= 3].max() < 1e-3, np.sort(rel[nobs >= 3])[-3:]

    def reproj(Xs):
        P = teng._P_all[ref._obs_cam]
        h = np.einsum("oij,oj->oi", P[:, :, :3], Xs[ref._obs_pt]) + P[:, :, 3]
        return np.linalg.norm(h[:, :2] / h[:, 2:] - ref._obs_xy, axis=1)

    assert np.abs(reproj(teng._X) - reproj(X)).max() < 0.02


def test_planar_degenerate_fix_matches_jax():
    """``_fix_planar_degenerate_edges`` on three edges of the homography
    tests' plane scene (0.2 px noise): fully planar (130 plane points; the
    twofold ambiguity, so candidate 0 and a stashed runner-up), planar with
    15 of 115 points off the plane (the off-plane points choose), and a
    general scene of 100 off-plane points (left alone). The port replaces
    the same edges with poses within 1e-3 rad and stashes the same
    runner-up, within 1e-3 rad, with the same warning."""
    from sfmfromscratch_tpu.types import PairGeometry as JPairGeometry
    from tests.test_homography import K, _scene

    r = np.random.default_rng(44)
    scenes = [_scene(r, n_plane=130, n_off=0, noise=0.2),
              _scene(r, n_plane=115 - 15, n_off=15, noise=0.2)]
    p1, p2 = _scene(r, n_plane=30, n_off=100, noise=0.2)
    scenes.append((p1, p2))
    N = 130
    pgs, masks = [], []
    for a, b in scenes:
        m = np.zeros(N, bool)
        m[:len(a)] = True
        pad = np.zeros((N - len(a), 2))
        pgs.append(JPairGeometry(p1=np.vstack([a, pad]).astype(np.float32),
                                 p2=np.vstack([b, pad]).astype(np.float32),
                                 idx1=np.arange(N, dtype=np.int32), idx2=np.arange(N, dtype=np.int32),
                                 mask=m, K1=K.astype(np.float32), K2=K.astype(np.float32)))
        masks.append(m)
    pairs = [(1, 2), (2, 3), (3, 4)]
    ninl = np.array([m.sum() for m in masks], np.float64)

    def bare(cls):
        eng = object.__new__(cls)
        eng._edges = list(pairs)
        eng._edge_R = np.tile(np.eye(3), (3, 1, 1))
        eng._edge_t = np.tile([1.0, 0.0, 0.0], (3, 1))
        eng.warnings = []
        eng.device = torch.device("cpu")
        return eng

    jeng, teng = bare(JGlobal), bare(TGlobal)
    jeng._fix_planar_degenerate_edges(pairs, pgs, masks, ninl, 128)
    teng._fix_planar_degenerate_edges(pairs, pgs, masks, ninl, 128)
    assert teng.warnings == jeng.warnings and "planar-degenerate" in jeng.warnings[0]

    def gap(A, B):
        return 2 * np.arcsin(min(np.linalg.norm(A - B) / (2 * np.sqrt(2)), 1.0))

    for e in range(3):
        assert gap(teng._edge_R[e], jeng._edge_R[e]) < 1e-3, e
        np.testing.assert_allclose(teng._edge_t[e], jeng._edge_t[e], atol=1e-3)
    np.testing.assert_array_equal(teng._edge_R[2], np.eye(3))         # general: untouched
    assert set(teng._edge_alt) == set(jeng._edge_alt) == {0}
    assert gap(teng._edge_alt[0][0], jeng._edge_alt[0][0]) < 1e-3
    assert not np.allclose(jeng._edge_R[1], np.eye(3))                  # replaced
