"""The port's staged front, host chain and its options against the JAX engine,
on the CPU: window linking, distance association, pose recovery, local BA,
the pair cache, match-graph shards, checkpoints, export and the CLI.

Scene and configuration are ``test_torch_engine.py``'s (160x220,
``default_rng(21)``, 90 points, 300 keypoints, 1,024 hypotheses), at 5 views.
The chain tests run the JAX engine's ``_match_pairs`` and ``_bootstrap``, copy
that state into the port's engine, and hand the port the uniforms that the
keys of the JAX ``_chain`` draw, so both packages score the same hypotheses.
Each tolerance is stated where it is used.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmfromscratch_tpu import cli as jcli
from sfmfromscratch_tpu.ba import lm as jlm
from sfmfromscratch_tpu.ba import problem as jprob
from sfmfromscratch_tpu.geometry.ransac import ransac_essential_pose as jess
from sfmfromscratch_tpu.io import export as jexport
from sfmfromscratch_tpu.pipeline import checkpoint as jckpt
from sfmfromscratch_tpu.pipeline import global_sfm as jglobal
from sfmfromscratch_tpu.pipeline import incremental as jinc

from sfmfromscratch_tpu_torch import cli as tcli
from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ba import lm as tlm
from sfmfromscratch_tpu_torch.geometry.ransac import ransac_essential_pose as tess
from sfmfromscratch_tpu_torch.pipeline import checkpoint as tckpt
from sfmfromscratch_tpu_torch.pipeline import global_sfm as tglobal
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from tests.render import render_sequence, write_sequence
from tests.test_torch_engine import _jax_config, _port_config

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

VIEWS = 5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    images, K, poses, _ = render_sequence(
        np.random.default_rng(21), num_views=VIEWS, num_points=90, img_hw=(160, 220), f=300.0,
        step_t=(-0.2, 0.02, 0.03), step_r=(0.008, -0.02, 0.005))
    d = tmp_path_factory.mktemp("hseq")
    write_sequence(str(d), images)
    K_half = K.copy()
    K_half[:2] *= 0.5   # features live on images at scale 0.5
    return dict(dir=str(d), K=K_half, poses=poses, n=VIEWS)


@pytest.fixture(scope="module")
def jax_pairs(scene, tmp_path_factory):
    """The JAX engine's window-3 pair geometry (matching and F-filter), with
    the pair cache it wrote."""
    cache = str(tmp_path_factory.mktemp("jcache"))
    jeng = jinc.SfmEngine(scene["dir"], scene["n"], config=_jax_config(), single_K=scene["K"],
                          pair_window=3, pair_cache_dir=cache, auto_run=False)
    jeng._match_pairs(jeng._extract_all_features())
    return dict(engine=jeng, cache=cache, capacity=len(jeng._kp_tracks[1]))


def _engines(scene, jax_pairs, clear_image2=False, **options):
    """A JAX engine bootstrapped on the JAX pair geometry (a fixed key), and a
    port engine holding a copy of that state. Returns (jeng, teng, chain
    arguments)."""
    jeng = jinc.SfmEngine(scene["dir"], scene["n"], config=_jax_config(), single_K=scene["K"],
                          auto_run=False, **options)
    jeng.pair_geometry = jax_pairs["engine"].pair_geometry
    jeng._kp_tracks = {i: np.full(jax_pairs["capacity"], -1, np.int64)
                       for i in range(1, scene["n"] + 1)}
    jeng._rng_key = jax.random.key(61)
    p3d, p2_obs, track_ids, P2 = jeng._bootstrap()
    if clear_image2:
        jeng._kp_tracks[2][:] = -1     # frame 3 links no track: PnP fails
    teng = tinc.SfmEngine(scene["dir"], scene["n"], config=_port_config(), single_K=scene["K"],
                          device="cpu", auto_run=False, **options)
    interop.import_engine_state(teng, jeng)
    teng._kp_tracks = {i: v.copy() for i, v in jeng._kp_tracks.items()}
    return jeng, teng, (p3d, p2_obs, track_ids, np.array(P2))


def _run_both_chains(jeng, teng, args):
    """JAX ``_chain`` with its keys recorded, then the port's ``_chain`` on
    the uniforms those keys draw (PnP: (hyp, 3) per frame; recovery:
    (``_num_hyp``, 8) per recovered frame)."""
    keys, recover_at = [], []
    next_key, recover = jeng._next_key, jeng._recover_pose

    def record():
        keys.append(next_key())
        return keys[-1]

    def mark(*a):
        recover_at.append(len(keys))   # the next key is the recovery's
        return recover(*a)

    jeng._next_key, jeng._recover_pose = record, mark
    jeng._chain(*args[:3], jax.numpy.asarray(args[3]))
    chain_keys = [k for e, k in enumerate(keys) if e not in recover_at]
    hyp = jeng._pnp_hyp
    u = np.stack([_np(jax.random.uniform(k, (hyp, 3))) for k in chain_keys])
    ur = iter([torch.as_tensor(_np(jax.random.uniform(keys[e], (jeng._num_hyp, 8))))
               for e in recover_at])
    t_recover = teng._recover_pose
    teng._recover_pose = lambda pg, i, j: t_recover(pg, i, j, uniforms=next(ur))
    teng._chain(*args[:3], torch.as_tensor(args[3]), uniforms=torch.as_tensor(u))
    return len(recover_at)


def _assert_same_map(jeng, teng, depth_share=0.8):
    """Identical observation records and keypoint tables; the bootstrap
    camera exact (it was copied) and every chain camera within 5e-4 (the
    chain frames register on points triangulated at low parallax, whose
    depth error moves their PnP pose: measured up to 1.2e-4 on the first
    chain frame); the points by ``_chain_points_close``."""
    jf, jt, jxy = jeng.map.observations()
    tf, tt, txy = teng.map.observations()
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(txy, jxy, atol=1e-6)
    for i in jeng._kp_tracks:
        np.testing.assert_array_equal(teng._kp_tracks[i], jeng._kp_tracks[i])
    assert len(teng.global_poses) == len(jeng.global_poses) == VIEWS - 1
    for c, ((rv_t, t_t), (rv_j, t_j)) in enumerate(zip(teng.global_poses, jeng.global_poses)):
        tol = 0.0 if c == 0 else 5e-4
        np.testing.assert_allclose(rv_t, rv_j, atol=tol, err_msg=f"camera {c}")
        np.testing.assert_allclose(t_t, t_j, atol=tol, err_msg=f"camera {c}")
    _chain_points_close(jeng, teng, depth_share)


def _project(eng, frames, tracks):
    """Pixel of each observation's track under its camera, in float64."""
    from sfmfromscratch_tpu_torch.ops.lie import so3_exp

    rv = torch.as_tensor(np.stack([p[0] for p in eng.global_poses]), dtype=torch.float64)
    R = _np(so3_exp(rv))[frames]
    t = np.stack([p[1] for p in eng.global_poses])[frames]
    K = np.stack(eng.global_K)[frames]
    x = np.einsum("nij,nj->ni", K, np.einsum("nij,nj->ni", R, eng.map.points()[tracks]) + t)
    return x[:, :2] / x[:, 2:]


def _chain_points_close(jeng, teng, depth_share):
    """Each observation's reprojection (the port's point under the port's
    camera against JAX's under JAX's) within 0.05 px, and ``depth_share``
    of the points within 1e-3 of their depth. Points are compared in the
    images: the chain triangulates at low parallax (80x110 px, 0.2 per
    step), where the 1e-4 pose differences move a point along its ray by up
    to 3.6% of its depth with index association and 34% with distance
    association, whose misassociations leave points at a tenth of the
    scene's depth (38% within 1e-3). The reprojections differ by at most
    0.042 px (measured; 0.01 px with index association, where 85-89% of
    the points lie within 1e-3)."""
    frames, tracks, _ = jeng.map.observations()
    diff = np.abs(_project(teng, frames, tracks) - _project(jeng, frames, tracks)).max(-1)
    got, ref = teng.map.points(), jeng.map.points()
    d = np.abs(ref[:, 2:3]) + 1e-6
    err = np.abs(got / d - ref / d).max(-1)
    assert diff.max() <= 0.05 and (err <= 1e-3).mean() >= depth_share, (
        diff.max(), (err <= 1e-3).mean())


@pytest.mark.parametrize("mode", ["index", "distance", "window", "recover"])
def test_host_chain_matches_jax(scene, jax_pairs, mode):
    """The host chain on the JAX pair geometry, bootstrap and uniforms.
    ``window`` links the (i, j) pairs with i < j-1 into existing tracks
    (``pair_window=3``); ``recover`` clears image 2's keypoint table, so
    frame 3 links nothing, its PnP fails and its pose comes from the pair's
    essential matrix on the JAX uniforms."""
    options = {"index": {}, "distance": dict(assoc_mode="distance", chain_mode="host"),
               "window": dict(pair_window=3),
               "recover": dict(on_pose_failure="recover", chain_mode="host")}[mode]
    jeng, teng, args = _engines(scene, jax_pairs, clear_image2=mode == "recover",
                                **({"chain_mode": "host"} if mode == "index" else options))
    assert not teng._use_scan_chain()
    recovered = _run_both_chains(jeng, teng, args)
    assert recovered == (1 if mode == "recover" else 0)
    assert teng.warnings == jeng.warnings
    _assert_same_map(jeng, teng, depth_share=0.3 if mode == "distance" else 0.8)
    assert "chain" in teng.stage_times
    if mode != "distance":
        # Index association observes a track at most once per frame;
        # distance association may link two matches to one observation, as
        # the reference does.
        frames, tracks, _ = teng.map.observations()
        assert len({(f, t) for f, t in zip(frames, tracks)}) == len(frames)
    if mode == "window":
        # The window pairs add observations to tracks already mapped.
        base, _, base_args = _engines(scene, jax_pairs, chain_mode="host")
        base._chain(*base_args[:3], jax.numpy.asarray(base_args[3]))
        assert teng.map.num_observations > base.map.num_observations


def test_local_ba_matches_jax(scene, jax_pairs):
    """``local_ba_every=2``: the first local BA (after two cameras, none
    frozen, the similarity gauge free) sees the same problem in both
    packages, and on that problem the costs after each of the first 3 LM
    iterations agree to 1e-3 relative (the gauge makes iteration counts
    fragile, ``test_torch_engine.py::test_global_ba_on_jax_front``)."""
    jeng, teng, args = _engines(scene, jax_pairs, local_ba_every=2)
    seen = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        ba = eng._global_ba

        def first(freeze_before=0, stage="ba", eng=eng, ba=ba, name=name):
            if name not in seen:
                frames, tracks, xy = eng.map.observations()
                seen[name] = (np.array([np.hstack(p) for p in eng.global_poses]),
                              eng.map.points().copy(), frames, tracks, xy,
                              np.stack(eng.global_K), freeze_before, stage)
            return ba(freeze_before=freeze_before, stage=stage)

        eng._global_ba = first
    _run_both_chains(jeng, teng, args)
    assert "local_ba" in teng.stage_times and "local_ba" in jeng.stage_times
    cams, pts, frames, tracks, xy, Ks, freeze, stage = seen["jax"]
    assert (freeze, stage) == (0, "local_ba") and seen["port"][6:] == (0, "local_ba")
    np.testing.assert_array_equal(seen["port"][2], frames)
    np.testing.assert_array_equal(seen["port"][3], tracks)
    np.testing.assert_allclose(seen["port"][0], cams, atol=1e-4)
    jp = jprob.pad_problem(jprob.make_problem(cams, pts, frames, tracks, xy, Ks,
                                              cam_fixed=np.zeros(len(cams), bool)))
    tp = interop.ba_problem_from_numpy(jp)
    kw = dict(cg_iters=60, ftol=_jax_config().ba.ftol)
    for k in range(1, 4):
        a = jlm.bundle_adjust(jp, max_iters=k, **kw)
        b = tlm.bundle_adjust(tp, max_iters=k, **kw)
        assert float(b.final_cost) == pytest.approx(float(a.final_cost), rel=1e-3), k
    # After the local BA the chain follows the re-optimised last pose.
    assert len(teng.global_poses) == VIEWS - 1
    assert np.isfinite(teng.map.points()).all()


def test_recover_pose_matches_jax(scene, jax_pairs):
    """``_recover_pose`` on the JAX pair (3, 4) and the JAX uniforms, chained
    onto two cameras (step length from the last two centres): R and t within
    1e-4, and the same warning."""
    jeng, teng, _ = _engines(scene, jax_pairs)
    extra = (np.array([0.01, -0.02, 0.005]), np.array([-0.3, 0.02, 0.05]))
    jeng.global_poses.append(extra)
    teng.global_poses.append(tuple(v.copy() for v in extra))
    key = jax.random.key(71)
    jeng._next_key = lambda: key
    ref = jeng._recover_pose(jeng.pair_geometry[(3, 4)], 3, 4)
    u = torch.as_tensor(_np(jax.random.uniform(key, (jeng._num_hyp, 8))))
    R, t = teng._recover_pose(teng.pair_geometry[(3, 4)], 3, 4, uniforms=u)
    np.testing.assert_allclose(_np(R), _np(ref.R), atol=1e-4)
    np.testing.assert_allclose(_np(t), _np(ref.t), atol=1e-4)
    assert teng.warnings == jeng.warnings == ["pose recovery engaged for pair (3, 4)"]


def _port_engine(scene, **kw):
    return tinc.SfmEngine(scene["dir"], scene["n"], config=kw.pop("config", _port_config()),
                          single_K=scene["K"], device="cpu", **kw)


def _same_reconstruction(a, b):
    """Bitwise: the same observation records, points and poses."""
    for x, y in zip(a.map.observations(), b.map.observations()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.map.points(), b.map.points())
    for (rv_a, t_a), (rv_b, t_b) in zip(a.global_poses, b.global_poses, strict=True):
        np.testing.assert_array_equal(rv_a, rv_b)
        np.testing.assert_array_equal(t_a, t_b)
    assert a.errors_before_after_ba == b.errors_before_after_ba


def test_host_chain_matches_scan_chain(scene):
    """The port's host chain draws every frame's PnP uniforms at once, as its
    scan chain does, so on the CPU the two give the same reconstruction
    bitwise (the JAX package's chains draw different streams and agree only
    in quality, ``tests/test_pipeline.py::test_scan_chain_matches_host_chain``)."""
    scan = _port_engine(scene, chain_mode="scan")
    host = _port_engine(scene, chain_mode="host")
    assert "fetch" in scan.stage_times and "fetch" not in host.stage_times
    _same_reconstruction(scan, host)


def test_staged_front_matches_fused_front(scene, tmp_path):
    """A fresh pair cache sends the engine down the staged path
    (``_match_pairs``, ``_bootstrap``, ``_chain_scan``), which draws the same
    uniforms in the same order as the fused front: the same reconstruction
    bitwise on the CPU."""
    fused = _port_engine(scene)
    staged = _port_engine(scene, pair_cache_dir=str(tmp_path / "cache"))
    assert "fetch" in fused.stage_times and "fetch" not in staged.stage_times
    _same_reconstruction(fused, staged)
    for k, pg in fused.pair_geometry.items():
        np.testing.assert_array_equal(staged.pair_geometry[k].mask, pg.mask)


def test_pair_cache_resume(scene, tmp_path):
    """A full resume matches nothing and keeps every pair's geometry; a
    partial one computes only the missing pair; a cache written under
    another configuration is invisible."""
    cache = str(tmp_path / "cache")
    first = _port_engine(scene, pair_window=2, pair_cache_dir=cache, auto_run=False)
    first._match_pairs(first._extract_all_features())
    files = sorted(os.listdir(cache))
    assert len(files) == 7 and first._last_match_computed == 7
    assert not first.warnings

    again = _port_engine(scene, pair_window=2, pair_cache_dir=cache)
    assert again._last_match_computed == 0
    assert again.warnings == ["pair cache: resumed 7/7 pairs"]
    for k, pg in first.pair_geometry.items():
        for f in ("p1", "p2", "idx1", "idx2", "mask"):
            np.testing.assert_array_equal(getattr(again.pair_geometry[k], f), getattr(pg, f))
    assert len(again.global_poses) == VIEWS - 1

    os.remove(os.path.join(cache, "pair_2_4.npz"))
    with open(os.path.join(cache, "pair_3_4.npz"), "wb") as f:
        f.write(b"truncated")                     # an unreadable entry counts as missing
    part = _port_engine(scene, pair_window=2, pair_cache_dir=cache, auto_run=False)
    part._match_pairs(part._extract_all_features())
    assert part._last_match_computed == 2
    assert part.warnings == ["pair cache: resumed 5/7 pairs"]
    assert sorted(os.listdir(cache)) == files

    other = _port_engine(scene, pair_window=2, pair_cache_dir=cache, auto_run=False,
                         config=_port_config(seed=6))
    other._match_pairs(other._extract_all_features())
    assert other._last_match_computed == 7 and not other.warnings


def test_pair_cache_shared_with_jax(scene, jax_pairs):
    """The port's configs print as the JAX configs do, so the cache tags are
    equal (for both engines) and the port resumes a JAX-written cache whole,
    with the JAX pair geometry."""
    jeng = jax_pairs["engine"]
    teng = _port_engine(scene, pair_window=3, pair_cache_dir=jax_pairs["cache"], auto_run=False)
    assert teng._pair_cache_tag() == jeng._pair_cache_tag()
    jg = jglobal.GlobalSfmEngine(scene["dir"], scene["n"], config=_jax_config(), auto_run=False)
    tg = tglobal.GlobalSfmEngine(scene["dir"], scene["n"], config=_port_config(), device="cpu",
                                 auto_run=False)
    assert tg._pair_cache_tag() == jg._pair_cache_tag() != jeng._pair_cache_tag()
    teng._match_pairs(teng._extract_all_features())
    assert teng._last_match_computed == 0
    assert teng.warnings == ["pair cache: resumed 9/9 pairs"]
    assert set(teng.pair_geometry) == set(jeng.pair_geometry)
    for k, pg in jeng.pair_geometry.items():
        for f in ("p1", "p2", "idx1", "idx2", "mask", "K1", "K2"):
            np.testing.assert_array_equal(getattr(teng.pair_geometry[k], f), _np(getattr(pg, f)))


@pytest.mark.parametrize("engine", ["incremental", "global"])
def test_match_graph_shards(scene, tmp_path, engine):
    """Two shards write complementary halves of the pair graph into one
    cache; a later run resumes them all and matches nothing."""
    cache = str(tmp_path / "cache")
    cls = tinc.SfmEngine if engine == "incremental" else tglobal.GlobalSfmEngine
    kw = dict(config=_port_config(), single_K=scene["K"], device="cpu", pair_window=3)
    n0 = cls.match_graph_shard(scene["dir"], scene["n"], 0, 2, cache, **kw)
    files0 = set(os.listdir(cache))
    n1 = cls.match_graph_shard(scene["dir"], scene["n"], 1, 2, cache, **kw)
    files1 = set(os.listdir(cache)) - files0
    assert (n0, n1) == (5, 4) and len(files0) == 5 and len(files1) == 4
    assert cls.match_graph_shard(scene["dir"], scene["n"], 1, 2, cache, **kw) == 0
    eng = cls(scene["dir"], scene["n"], pair_cache_dir=cache, auto_run=False, **kw)
    eng._match_pairs(eng._extract_all_features())
    assert eng._last_match_computed == 0 and eng.warnings == ["pair cache: resumed 9/9 pairs"]


def test_checkpoint_round_trip(scene, tmp_path):
    """A checkpoint written every 2 images holds the state after image 4:
    loading it into a fresh engine restores the map, the poses, K, the
    keypoint tables and the generator's state."""
    path = str(tmp_path / "ckpt.npz")
    eng = _port_engine(scene, checkpoint_every=2, checkpoint_path=path, auto_run=False)
    saved = {}
    save = tckpt.save_checkpoint

    def keep(engine, p, next_frame):
        save(engine, p, next_frame)
        saved[next_frame] = (engine.map.points().copy(), len(engine.global_poses),
                             engine._generator.get_state().clone())

    tinc.save_checkpoint, orig = keep, tinc.save_checkpoint
    try:
        eng.run()
    finally:
        tinc.save_checkpoint = orig
    assert sorted(saved) == [5]
    fresh = _port_engine(scene, auto_run=False)
    before = fresh._generator.get_state().clone()
    assert tckpt.load_checkpoint(fresh, path) == 5
    points, cams, state = saved[5]
    np.testing.assert_array_equal(fresh.map.points(), points)
    assert len(fresh.global_poses) == len(fresh.global_K) == cams == 3   # images 2-4
    assert torch.equal(fresh._generator.get_state(), state)
    assert not torch.equal(state, before)
    assert not fresh.warnings
    # Saving the fresh engine again writes the same arrays.
    again = str(tmp_path / "again.npz")
    tckpt.save_checkpoint(fresh, again, next_frame=5)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_checkpoint_loads(scene, jax_pairs, tmp_path):
    """A JAX-written checkpoint (``rng_key``, no ``rng_state``) loads the map,
    observations, poses, K and keypoint tables, leaves the generator as it
    is and says so."""
    jeng, _, args = _engines(scene, jax_pairs, chain_mode="host")
    jeng._chain(*args[:3], jax.numpy.asarray(args[3]))
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(jeng, path, next_frame=VIEWS + 1)
    teng = _port_engine(scene, auto_run=False)
    state = teng._generator.get_state().clone()
    assert tckpt.load_checkpoint(teng, path) == VIEWS + 1
    for a, b in zip(teng.map.observations(), jeng.map.observations()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(teng.map.points(), jeng.map.points())
    for (rv_a, t_a), (rv_b, t_b) in zip(teng.global_poses, jeng.global_poses, strict=True):
        np.testing.assert_array_equal(rv_a, rv_b)
        np.testing.assert_array_equal(t_a, t_b)
    np.testing.assert_array_equal(np.stack(teng.global_K), np.stack(jeng.global_K))
    for i, kt in jeng._kp_tracks.items():
        np.testing.assert_array_equal(teng._kp_tracks[i], kt)
    assert torch.equal(teng._generator.get_state(), state)
    assert len(teng.warnings) == 1 and "rng_state" in teng.warnings[0]


def _aux_state(engine, rng):
    """``tests/test_aux.py::test_async_checkpointer_roundtrip``'s state: 6
    tracks seen by 2 frames, one pose, K, one keypoint table."""
    from sfmfromscratch_tpu.config import PipelineConfig

    engine.config = PipelineConfig()
    ids = engine.map.add_tracks(rng.standard_normal((6, 3)), rng.uniform(0, 50, (6, 2)), 0)
    engine.map.add_observations(ids, rng.uniform(0, 50, (6, 2)), 1)
    engine.global_poses = [(rng.standard_normal(3), rng.standard_normal(3))]
    engine.global_K = [np.eye(3)]
    engine._kp_tracks = {1: np.arange(10, dtype=np.int64)}


def test_async_checkpointer_round_trip(tmp_path):
    """``AsyncCheckpointer`` against the JAX (Orbax) one on
    ``test_aux.py:132``'s round trip: save step 1, ``wait``, restore into an
    empty engine; both restore the same points, observations, poses, K and
    keypoint table, exactly. The port's state is snapshotted at ``save``
    (a later change to the engine does not reach the file), it lands as
    ``step_<n>/state.npz``, a restore waits for pending saves, and a writer's
    error is raised by ``wait``."""
    from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore as TMap
    from sfmfromscratch_tpu.pipeline.tracks import MapStore as JMap

    jeng = jinc.SfmEngine.__new__(jinc.SfmEngine)
    jeng.map = JMap()
    _aux_state(jeng, np.random.default_rng(5))
    jeng._rng_key = jax.random.key(9)
    teng = tinc.SfmEngine.__new__(tinc.SfmEngine)
    teng.map = TMap()
    _aux_state(teng, np.random.default_rng(5))
    teng._generator = torch.Generator().manual_seed(9)
    state = teng._generator.get_state().clone()

    jck = jckpt.AsyncCheckpointer(str(tmp_path / "j"))
    jck.save(jeng, next_frame=5, step=1)
    jck.wait()
    tck = tckpt.AsyncCheckpointer(str(tmp_path / "t"))
    path = tck.save(teng, next_frame=5, step=1)
    assert path == str(tmp_path / "t" / "step_1")
    teng.map.add_observations(np.arange(6), np.zeros((6, 2)), 2)   # after the snapshot
    tck.save(teng, next_frame=7, step=2)
    tck.wait()
    assert sorted(os.listdir(tmp_path / "t" / "step_1")) == ["state.npz"]

    jback = jinc.SfmEngine.__new__(jinc.SfmEngine)
    jback.config = teng.config
    tback = tinc.SfmEngine.__new__(tinc.SfmEngine)
    tback._generator = torch.Generator()
    assert jck.restore(jback, step=1) == tck.restore(tback, step=1) == 5
    np.testing.assert_array_equal(tback.map.points(), jback.map.points())
    for a, b in zip(tback.map.observations(), jback.map.observations()):
        np.testing.assert_array_equal(a, b)
    assert tback.map.num_observations == jback.map.num_observations == 12
    np.testing.assert_array_equal(np.hstack(tback.global_poses[0]), np.hstack(jback.global_poses[0]))
    np.testing.assert_array_equal(np.stack(tback.global_K), np.stack(jback.global_K))
    np.testing.assert_array_equal(tback._kp_tracks[1], jback._kp_tracks[1])
    assert torch.equal(tback._generator.get_state(), state)
    assert tck.restore(tback, step=2) == 7 and tback.map.num_observations == 18

    (tmp_path / "t" / "step_3").write_text("a file where the step's folder goes")
    tck.save(teng, next_frame=9, step=3)
    with pytest.raises(OSError):
        tck.wait()


def test_export_matches_jax(scene, jax_pairs, tmp_path):
    """PLY and COLMAP text written by the port for a state imported from the
    JAX engine is the JAX package's text, byte for byte."""
    jeng, _, args = _engines(scene, jax_pairs, chain_mode="host", pair_window=3)
    jeng._chain(*args[:3], jax.numpy.asarray(args[3]))
    teng = _port_engine(scene, auto_run=False)
    interop.import_engine_state(teng, jeng)
    jexport.save_ply(jeng, str(tmp_path / "j.ply"))
    teng.save_ply(str(tmp_path / "t.ply"))
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()
    jexport.save_colmap(jeng, str(tmp_path / "jc"))
    teng.save_colmap(str(tmp_path / "tc"))
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "tc" / name).read_text() == (tmp_path / "jc" / name).read_text()
    assert (tmp_path / "t.ply").read_text().count("\n") > jeng.map.num_tracks


def test_cli_help_and_resize(tmp_path):
    """``--help`` exits; ``resize`` writes the images at the ratio
    (``tests/test_aux.py::test_cli_help_and_resize``); ``show`` of a model
    that was never saved raises, as the JAX CLI's does."""
    from PIL import Image

    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    Image.new("RGB", (100, 80)).save(src / "a.jpg")
    assert tcli.main(["resize", str(src), str(dst), "--ratio", "0.5", "--no-exif"]) == 0
    with Image.open(dst / "a.jpg") as im:
        assert im.size == (50, 40)
    with pytest.raises(FileNotFoundError):
        tcli.main(["show", "model", "--output-dir", str(tmp_path / "none")])


def test_save_image_matches_jax(tmp_path):
    """``save_image`` writes the JAX package's file, byte for byte, for a
    float image with values outside [0, 1] (clipped), into a folder it
    creates."""
    from sfmfromscratch_tpu.io.images import save_image as jsave
    from sfmfromscratch_tpu_torch.io.images import save_image as tsave

    im = np.random.default_rng(3).uniform(-0.2, 1.2, (30, 40, 3)).astype(np.float32)
    jsave(str(tmp_path / "j" / "a.png"), im)
    tsave(str(tmp_path / "t" / "a.png"), im)
    assert (tmp_path / "t" / "a.png").read_bytes() == (tmp_path / "j" / "a.png").read_bytes()


def _cli_argv(scene, out, *extra):
    """``reconstruct`` at the test configuration: f = 150 at scale 0.5 is the
    scene's K at the working scale."""
    return ["reconstruct", scene["dir"], "--max-img", str(scene["n"]), "--focal", "150",
            "--scale-factor", "0.5", "--num-interest-points", "300", "--sigma", "3",
            "--feature-width", "16", "--pyramid-level", "2", "--pyramid-scale-factor", "1.2",
            "--ransac-iterations", "1024", "--output-dir", str(out), "--model-name", "m", *extra]


_LINES = [r"tracks=\d+ observations=\d+", r"mean reprojection error: \d+\.\d{4} -> \d+\.\d{4} px"]


@pytest.mark.parametrize("pipeline", ["incremental", "global"])
def test_cli_reconstruct(scene, tmp_path, capsys, pipeline):
    """``reconstruct --device cpu`` runs each pipeline, prints the JAX CLI's
    two lines, saves the model and writes the exports it was asked for."""
    extra = ["--pipeline", pipeline, "--device", "cpu", "--pair-window", "2",
             "--export-ply", str(tmp_path / "m.ply"), "--export-colmap", str(tmp_path / "colmap")]
    if pipeline == "incremental":
        extra += ["--local-ba-every", "2", "--pair-cache-dir", str(tmp_path / "cache")]
    assert tcli.main(_cli_argv(scene, tmp_path, *extra)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(re.fullmatch(p, s) for p, s in zip(_LINES, lines)), lines
    data = tinc.SfmEngine.load("m", str(tmp_path), show=False)
    cams = VIEWS - 1 if pipeline == "incremental" else VIEWS
    assert data["poses"].shape == (cams, 6) and np.isfinite(data["p3d"]).all()
    assert (tmp_path / "m.ply").exists()
    assert {p.name for p in (tmp_path / "colmap").iterdir()} == {
        "cameras.txt", "images.txt", "points3D.txt"}
    if pipeline == "incremental":
        assert len(os.listdir(tmp_path / "cache")) == 7


def test_cli_prints_the_jax_lines(scene, tmp_path, capsys):
    """On the same flags the two CLIs print lines of one format; the track
    counts differ only by the RANSAC draws (within 15%, as in
    ``test_torch_engine.py``)."""
    argv = _cli_argv(scene, tmp_path, "--pair-window", "3")
    assert jcli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(ref) == 2
    for p, g, r in zip(_LINES, got, ref):
        assert re.fullmatch(p, g) and re.fullmatch(p, r), (g, r)
    count = lambda s: int(re.match(r"tracks=(\d+)", s).group(1))
    assert abs(count(got[0]) - count(ref[0])) <= 0.15 * count(ref[0])


@pytest.mark.parametrize("flags", [
    ["--refine-focal"], ["--pipeline", "global", "--pair-mode", "retrieval"],
    ["--pipeline", "global", "--keyframe-step", "2"],
    ["--pipeline", "global", "--stream-ba-window", "4"],
])
def test_cli_flags_not_ported_raise(scene, tmp_path, flags, monkeypatch):
    """Every ``reconstruct`` flag of the JAX CLI now runs in the port's: each
    of these reaches the engine as its option (the engine's ``run`` is
    stubbed here; the options' runs are tested in ``test_torch_selfcal``,
    ``test_torch_keyframes``, ``test_torch_retrieval`` and
    ``test_torch_streaming``)."""
    GlobalSfmEngine = tglobal.GlobalSfmEngine
    built = []

    def run(self):
        built.append(self)
        self.errors_before_after_ba = (1.0, 0.5)
        return self

    monkeypatch.setattr(tinc.SfmEngine, "run", run)
    monkeypatch.setattr(GlobalSfmEngine, "run", run)
    assert tcli.main(_cli_argv(scene, tmp_path, "--device", "cpu", *flags)) == 0
    (eng,) = built
    want = {"--refine-focal": ("refine_focal", True), "--pair-mode": ("pair_mode", "retrieval"),
            "--keyframe-step": ("keyframe_step", 2), "--stream-ba-window": ("stream_ba_window", 4)}
    name, value = want[next(f for f in flags if f in want)]
    assert getattr(eng, name) == value
    assert isinstance(eng, GlobalSfmEngine) is ("--pipeline" in flags)


def test_cli_defaults_match_jax():
    """Every flag of the JAX CLI's ``reconstruct`` exists in the port's with
    the same default; the port adds ``--device``."""
    def defaults(main):
        import argparse

        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            ns = orig(self, args, namespace)
            seen.update(vars(ns))
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main(["reconstruct", "seq", "--max-img", "3"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    ref, got = defaults(jcli.main), defaults(tcli.main)
    assert set(got) - set(ref) == {"device"} and got["device"] is None
    assert {k: got[k] for k in ref} == ref


def test_profiling_trace_annotate_and_stage_timer(tmp_path):
    """``trace`` writes a ``torch.profiler`` trace that holds the spans named
    by ``annotate``; ``StageTimer`` adds up a stage's wall time."""
    import json

    from sfmfromscratch_tpu_torch.utils import profiling

    timer = profiling.StageTimer()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("sfm_span"), timer.stage("work", sync_on=torch.ones(1)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.stage("work"):
        pass
    files = [p for p in tmp_path.rglob("*.json")]
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sfm_span" for e in events)
    assert set(timer.times) == {"work"} and timer.times["work"] > 0
    assert timer.summary().startswith("work=")


def test_nullvec_of_non_finite_system_is_nan():
    """A DLT system with a non-finite entry (a failed PnP pose) gives a NaN
    null vector, as XLA's SVD does, and leaves the rest of the batch as the
    JAX package computes it (1e-5). ``torch.linalg.svd`` alone raises on
    such input, or on the CPU may not return."""
    from sfmfromscratch_tpu.ops.smallsvd import nullvec_lstsq as jnull
    from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq as tnull

    A = np.random.default_rng(5).normal(size=(4, 4, 4)).astype(np.float32)
    A[1, 2, 3] = np.nan
    A[3, 0, 0] = np.nan   # (XLA's CPU SVD does not return on an inf)
    got, ref = _np(tnull(torch.as_tensor(A))), _np(jnull(A))
    assert np.isnan(got[[1, 3]]).all() and np.isnan(ref[[1, 3]]).all()
    for b in (0, 2):   # the sign of a null vector is free
        np.testing.assert_allclose(got[b] * np.sign(got[b] @ ref[b]), ref[b], atol=1e-5)


def test_scan_chain_is_chosen_only_without_host_options(scene):
    """``_use_scan_chain`` follows the JAX engine's rule for every option."""
    cases = [dict(), dict(chain_mode="host"), dict(chain_mode="scan", pair_window=3),
             dict(assoc_mode="distance"), dict(pair_window=2), dict(local_ba_every=3),
             dict(checkpoint_every=2), dict(on_pose_failure="recover")]
    for kw in cases:
        j = jinc.SfmEngine(scene["dir"], scene["n"], config=_jax_config(), auto_run=False, **kw)
        t = _port_engine(scene, auto_run=False, **kw)
        assert t._use_scan_chain() == j._use_scan_chain(), kw
    assert dataclasses.asdict(_port_config()) == dataclasses.asdict(_jax_config())


def test_recover_pose_of_a_pair_without_matches():
    """The stage where the recovery run parts between the packages (the
    port's ATE over extent 0.123-0.179 over config.seed 0-4 on the CPU
    against JAX's 0.292-0.319; ``tools/host_pins.py``). A flat frame's pairs
    have no valid match, so every slot holds the padded correspondence of
    keypoint 0 and every 8-point sample of the essential RANSAC is that one
    point eight times: the 8x9 system has rank 1 and the relative pose is
    whichever vector of its 8-dimensional null space the SVD returns. Each
    package's pick is fixed by its SVD, not by its draws (the same R for two
    unrelated sets of uniforms, to 1e-6), so the recovered poses of the flat
    frame and the one after it are arbitrary and differ between the
    packages whatever the seed. On a pair with matches the two agree
    (``test_recover_pose_matches_jax``)."""
    n = 600
    K = np.array([[520.0, 0, 240], [0, 520.0, 180], [0, 0, 1]], np.float32)
    p1 = np.tile(np.float32([9.0, 9.0]), (n, 1))
    p2 = np.tile(np.float32([242.38538, 113.41611]), (n, 1))
    mask = np.zeros(n, bool)
    x1, x2 = np.c_[p1[:8], np.ones(8)], np.c_[p2[:8], np.ones(8)]
    A = np.einsum("ni,nj->nij", x2, x1).reshape(8, 9)
    assert np.linalg.matrix_rank(A) == 1
    kw = dict(num_hypotheses=256, threshold=1.0, min_cheirality_frac=0.5)
    jR, tR = [], []
    for seed in (1, 2):
        key = jax.random.key(seed)
        jR.append(np.asarray(jess(key, *(jnp.asarray(a) for a in (p1, p2, K, K, mask)),
                                  **kw).R))
        u = torch.as_tensor(np.asarray(jax.random.uniform(key, (256, 8))))
        tR.append(tess(None, *(torch.as_tensor(a) for a in (p1, p2, K, K, mask)),
                       uniforms=u, **kw).R.numpy())
    for R in (jR, tR):
        np.testing.assert_allclose(R[0], R[1], atol=1e-6)
        np.testing.assert_allclose(R[0] @ R[0].T, np.eye(3), atol=1e-5)
