"""The ladder phase of ``chip_smoke.py`` against the JAX package, on the CPU.

The phase runs the JAX package's scale ladder (``benchmarks/ladder.py``) on
the card at the ladder's own settings. Here: every rung's configuration,
engine call and scene equal the ladder's own (``ladder.py`` is loaded by
path and its calls recorded), and both engines run their final bundle
adjustment on the PCG backend, which every rung past 32 cameras takes
(``ba/schur.py::dense_gate``), against the JAX engines on the same scenes
with ``SFM_NO_DENSE_SCHUR=1`` set for both packages. Each tolerance is
stated where it is used.
"""

import dataclasses
import importlib.util
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from sfmfromscratch_tpu.ba import lm as jlm
from sfmfromscratch_tpu.ba import problem as jprob
from sfmfromscratch_tpu.pipeline import global_sfm as jglobal
from sfmfromscratch_tpu.pipeline import incremental as jinc
from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ba import lm as tlm
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from tests import render
from tests.test_torch_engine import _jax_config as engine_jax_config
from tests.test_torch_engine import _scene as engine_scene

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = Path(__file__).resolve().parents[1]


def _load_ladder():
    spec = importlib.util.spec_from_file_location("sfm_ladder", ROOT / "benchmarks" / "ladder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def ladder_calls():
    """Every run of ``ladder.py``'s ``main`` (``--config5``: configs 2-5, and
    ``--hires``), each driven to its engine call: the renderer's name,
    generator state and keywords, and the engine's class, views and keywords,
    in the order ``main`` runs them. The renderers return blank images, no
    file is written and no engine runs."""
    ladder = _load_ladder()
    calls, current = [], {}

    def fake_renderer(name):
        def draw(rng, **kw):
            current.update(renderer=name, rng_state=rng.bit_generator.state, scene=kw)
            n, hw = kw["num_views"], kw.get("img_hw", (240, 320))
            poses = [(np.eye(3), np.zeros(3))] * n
            return [np.zeros(hw)] * n, np.eye(3), poses, np.zeros((1, 3))
        return draw

    def fake_engine(name):
        def run(img_dir, num_views, config, **kw):
            calls.append(dict(current, engine=name, views=num_views, config=config, kw=kw))
            raise _Stop
        return run

    # ladder.tempfile is the loaded module's own name, replaced by a stand-in:
    # the stdlib module itself stays untouched.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(render, "render_sequence", fake_renderer("render_sequence"))
        mp.setattr(render, "render_planes", fake_renderer("render_planes"))
        mp.setattr(render, "write_sequence", lambda *a, **k: None)
        mp.setattr(jinc, "SfmEngine", fake_engine("SfmEngine"))
        mp.setattr(jglobal, "GlobalSfmEngine", fake_engine("GlobalSfmEngine"))
        mp.setattr(ladder, "tempfile", types.SimpleNamespace(mkdtemp=lambda prefix="": "unused"))
        for runner in ("run_incremental", "run_global", "run_incremental_planes"):
            real = getattr(ladder, runner)

            def guarded(*args, _real=real, **kw):
                try:
                    _real(*args, **kw)
                except _Stop:
                    pass
            mp.setattr(ladder, runner, guarded)
        for flags in (["--config5"], ["--hires"]):   # --config5 runs configs 2-4 first
            mp.setattr(sys, "argv", ["ladder.py", *flags])
            ladder.main()
    return calls


def test_recording_the_ladder_leaves_tempfile_alone(ladder_calls):
    """Recording ``ladder.py``'s calls patches nothing that outlives it: the
    stdlib ``tempfile`` still makes directories for the tests after it, and
    the renderer and the JAX engines are the modules' own again."""
    assert len(ladder_calls) >= len(LADDER_PY_RUNGS)
    assert tempfile.mkdtemp.__module__ == "tempfile"
    with tempfile.TemporaryDirectory(prefix="ladder_check_") as d:
        assert Path(d).is_dir()
    assert render.render_sequence.__module__ == render.__name__
    assert jinc.SfmEngine.__module__ == jinc.__name__


def _ladder_call(calls, engine, views, scene):
    """The ladder's calls of ``engine`` at ``views`` views whose scene has
    ``scene``'s orbit step."""
    return [c for c in calls if c["engine"] == engine and c["views"] == views
            and c["scene"]["orbit_step_deg"] == scene["orbit_step_deg"]]


# The ladder's own runs, by rung; L4r is L4 in docs/PERFORMANCE.md:159's
# accuracy configuration, which ladder.py does not run.
LADDER_PY_RUNGS = ("L3", "L4", "L2h", "L3h", "L3g", "L5")


@pytest.mark.parametrize("name", LADDER_PY_RUNGS)
def test_rung_equals_the_ladders_run(name, ladder_calls):
    """The rung's engine, views, keypoints, engine keywords, renderer,
    generator and scene keywords are those of ``ladder.py``'s own call, and
    its configuration equals ``_cfg(kp)`` field for field."""
    engine, n, kp, kw, renderer, scene = chip_smoke.LADDER_RUNGS[name]
    found = _ladder_call(ladder_calls, engine, n, scene)
    assert len(found) == 1, [(c["engine"], c["views"]) for c in ladder_calls]
    call = found[0]
    assert call["renderer"] == renderer
    assert call["scene"] == scene
    assert call["rng_state"] == np.random.default_rng(7).bit_generator.state
    assert call["kw"].pop("single_K") is not None
    assert call["kw"] == kw
    api = chip_smoke.port_ladder_api(torch.device("cpu"))
    assert dataclasses.asdict(call["config"]) == dataclasses.asdict(chip_smoke.ladder_config(api, kp))
    assert call["config"].extractor.num_interest_points == kp


def test_refreshed_rung_is_config_4_with_averaging():
    """``L4r`` is ``L4`` with ``chain_refresh="averaging"`` and nothing else."""
    l4, l4r = chip_smoke.LADDER_RUNGS["L4"], chip_smoke.LADDER_RUNGS["L4r"]
    assert l4r[:3] == l4[:3] and l4r[4:] == l4[4:]
    assert l4r[3] == dict(l4[3], chain_refresh="averaging")
    assert set(chip_smoke.LADDER_DEFAULT) | set(chip_smoke.LADDER_GLOBAL) == set(
        chip_smoke.LADDER_RUNGS)
    assert set(chip_smoke.PIN_LADDER) == set(chip_smoke.LADDER_RUNGS) == set(
        chip_smoke.LADDER_LAUNCHES)


def _row(**kw):
    row = dict(cameras=46, want_cameras=46, finite=True, ate_over_extent=0.2,
               reproj_after_px=0.5, tracks=4000, max_points=200_000)
    return dict(row, **kw)


@pytest.mark.parametrize("bad", [
    dict(cameras=45), dict(finite=False), dict(ate_over_extent=0.417),
    dict(reproj_after_px=0.913), dict(tracks=2653), dict(tracks=200_000, max_points=200_000),
    dict(ate_over_extent=float("nan")),
], ids=["camera", "finite", "ate", "px", "tracks", "table_full", "nan"])
def test_ladder_failures_flag_each_pin(bad):
    """``chip_smoke.ladder_failures`` passes a row inside ``L3``'s pins and
    flags each pin it breaks, a NaN included."""
    assert chip_smoke.ladder_failures("L3", _row()) == []
    fails = chip_smoke.ladder_failures("L3", _row(**bad))
    assert len(fails) == 1 and fails[0].startswith("L3: "), fails


@pytest.mark.parametrize("kp", sorted({r[2] for r in chip_smoke.LADDER_RUNGS.values()}))
def test_ladder_config_equals_cfg(kp):
    """``chip_smoke.ladder_config`` in the JAX package's classes is
    ``ladder.py``'s ``_cfg(kp)`` itself, and in the port's the same values."""
    ladder = _load_ladder()
    from sfmfromscratch_tpu import config as jconfig

    jax_api = type("api", (), {"config": jconfig})
    port_api = chip_smoke.port_ladder_api(torch.device("cpu"))
    assert chip_smoke.ladder_config(jax_api, kp) == ladder._cfg(kp)
    assert dataclasses.asdict(chip_smoke.ladder_config(port_api, kp)) == dataclasses.asdict(
        ladder._cfg(kp))


# ---------------------------------------------------------------- PCG engines


@pytest.fixture(scope="module")
def scene3(tmp_path_factory):
    """``tests/test_torch_engine.py``'s 3-view scene."""
    return dict(engine_scene(tmp_path_factory, 3), render_s=0.0)


@pytest.fixture(scope="module")
def orbit6(tmp_path_factory):
    """``tests/test_torch_global.py``'s 6-view 5 deg/view orbit."""
    images, K, poses, _ = render.render_sequence(np.random.default_rng(7), num_views=6,
                                                 num_points=160, orbit_step_deg=5.0)
    d = tmp_path_factory.mktemp("orbit6")
    render.write_sequence(str(d), images)
    return dict(dir=str(d), K=K, poses=poses, n=6)


def _rung(monkeypatch, engine, views, kw, config):
    """Rung ``T`` for ``chip_smoke.ladder_run``: ``engine`` at ``views`` views
    with ``kw``, at ``config`` (the JAX config; the port's is its copy)."""
    monkeypatch.setitem(chip_smoke.LADDER_RUNGS, "T", (engine, views, 0, kw, None, None))

    def cfg(api, kp, seed=None):
        if api.config.__name__.startswith("sfmfromscratch_tpu_torch"):
            return interop.config_from_dict(dataclasses.asdict(config))
        return config
    monkeypatch.setattr(chip_smoke, "ladder_config", cfg)


def _jax_api(monkeypatch):
    from tools.ladder_pins import jax_ladder_api

    monkeypatch.setattr(jinc, "bundle_adjust", jinc.bundle_adjust)   # restored after the test
    return jax_ladder_api()


# The engine class and keywords; the global engine's are those of
# tests/test_torch_global.py.
ENGINES = {
    "incremental": ("SfmEngine", {}),
    "global": ("GlobalSfmEngine", dict(pair_window=3, rel_num_hypotheses=512)),
}


# JAX's track counts over config.seed 0-4 where one seed's count is a draw.
TRACKS_SPREAD = {"global": (36, 61)}


@pytest.mark.parametrize("which", ENGINES)
def test_engine_on_pcg_matches_jax(which, scene3, monkeypatch):
    """Both packages' engine on ``tests/test_torch_engine.py``'s 3-view
    scene at its configuration, with the dense Schur path switched off
    (``SFM_NO_DENSE_SCHUR=1``), through ``chip_smoke.ladder_run``: each row
    reports the PCG backend, and the port's row is held to JAX's with the
    gates of ``test_engine_matches_jax_engine`` (each package draws its own
    RANSAC samples): every camera, the post-BA error within 0.08 px of
    JAX's, ATE over extent at most JAX's plus 0.25, tracks within 15% of
    JAX's. The global engine's track count on this scene is bimodal in both
    packages (about 40 or about 60: over ``config.seed`` 0-4 on the dense
    path JAX 36-61, the port 40-62), so its tracks are held within 15% of
    JAX's seed range (``TRACKS_SPREAD``)."""
    monkeypatch.setenv("SFM_NO_DENSE_SCHUR", "1")
    engine, kw = ENGINES[which]
    _rung(monkeypatch, engine, scene3["n"], kw, engine_jax_config())
    jax_row = chip_smoke.ladder_run("T", _jax_api(monkeypatch), scene3)
    row = chip_smoke.ladder_run("T", chip_smoke.port_ladder_api(torch.device("cpu")), scene3)
    assert jax_row["final_ba"]["backend"] == row["final_ba"]["backend"] == "pcg"
    assert row["cameras"] == jax_row["cameras"] == row["want_cameras"]
    assert row["finite"] and row["reproj_after_px"] < row["reproj_before_px"]
    assert abs(row["reproj_after_px"] - jax_row["reproj_after_px"]) <= 0.08, (row, jax_row)
    assert row["ate_over_extent"] <= jax_row["ate_over_extent"] + 0.25
    lo, hi = TRACKS_SPREAD.get(which, (jax_row["tracks"], jax_row["tracks"]))
    assert 0.85 * lo <= row["tracks"] <= 1.15 * hi, (row["tracks"], jax_row["tracks"])
    monkeypatch.delenv("SFM_NO_DENSE_SCHUR")
    assert tlm.resolve_dense(None, *row["final_ba"]["padded"][:2])   # dense without the switch


def test_launch_shapes_follow_the_timed_rule(scene3, monkeypatch):
    """``chip_smoke.ladder_launch_shapes`` records the port's incremental
    engine's Harris and matcher calls on ``tests/test_torch_engine.py``'s
    3-view scene: one Harris stack of all views per pyramid level and one
    matcher batch of the chain's pairs at the keypoint capacity with a
    masked database, the rule by which ``chip_smoke.ladder_kernels`` sets
    ``L3h``'s timed shapes. Leaving it puts both wrappers back."""
    from sfmfromscratch_tpu_torch.ops import matcher
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.image import pyramid_shapes

    harris, match = HK.harris_response_fused, matcher.match_top2_fused
    cfg = engine_jax_config()
    _rung(monkeypatch, "SfmEngine", scene3["n"], {}, cfg)
    with chip_smoke.ladder_launch_shapes() as shapes:
        row = chip_smoke.ladder_run("T", chip_smoke.port_ladder_api(torch.device("cpu")), scene3)
    assert HK.harris_response_fused is harris and matcher.match_top2_fused is match
    ex, n, cap = cfg.extractor, scene3["n"], row["kp_capacity"]
    hw = (80, 110)   # the scene's 160x220 at the configuration's scale_factor 0.5
    want = {("harris", (n, H, W), ex.gaussian_size, float(ex.sigma), float(ex.alpha))
            for H, W in pyramid_shapes(hw, ex.pyramid_level, ex.pyramid_scale_factor)}
    want.add(("match", (n - 1, cap, cap, 128), True, False))
    assert cap == ex.num_interest_points // ex.pyramid_level * ex.pyramid_level
    assert shapes == want, sorted(shapes)


def test_stage_tool_measures_the_phase_run(scene3, monkeypatch):
    """``tools/ladder_stages.py`` runs the rung as ``chip_smoke.ladder_run``
    does: on ``tests/test_torch_engine.py``'s 3-view scene the same errors,
    LM iterations, ATE and tracks, with every image's keypoints and each
    consecutive pair's filtered matches reported."""
    from tools import ladder_stages

    _rung(monkeypatch, "SfmEngine", scene3["n"], {}, engine_jax_config())
    api = chip_smoke.port_ladder_api(torch.device("cpu"))
    row = chip_smoke.ladder_run("T", api, scene3)
    st = ladder_stages.stages("T", api, scene3, seed=None)
    assert st["reproj_before_px"] == row["reproj_before_px"]
    assert st["reproj_after_px"] == row["reproj_after_px"]
    assert st["iterations"] == row["final_ba"]["iterations"]
    assert st["ate_over_extent"] == row["ate_over_extent"] and st["tracks"] == row["tracks"]
    assert len(st["keypoints"]) == scene3["n"] and min(st["keypoints"]) > 0
    assert len(st["filtered"]) == scene3["n"] - 1 and min(st["filtered"]) > 0
    assert len(st["rel_rot_deg"]) == row["cameras"] - 1


@pytest.mark.parametrize("freeze_before", [0, 1], ids=["free_gauge", "camera0_fixed"])
def test_final_ba_on_pcg_matches_jax(freeze_before, orbit6, monkeypatch):
    """The JAX incremental engine's front on the 6-view orbit (at
    ``tests/test_global_sfm.py``'s configuration) imported into the port's
    engine, and the final BA of both packages on PCG
    (``SFM_NO_DENSE_SCHUR=1``) on the same padded problem: with no camera
    fixed (the incremental engine's) and with camera 0 fixed (the global
    engine's ``_ba_rounds``). The cost after each of the first 5 iterations
    agrees to 1e-3 relative (measured at most 5.7e-4; the free-gauge LM
    paths part at iteration 6, 6.9e-3, and the dense paths of the two
    packages on this problem at iteration 3-4); the starting error to 1e-4;
    the final cost and error within 1% of JAX's (measured 0.2% and 0.3%); the
    points of tracks of 3 or more views, after a similarity onto JAX's,
    within 2% of the cloud's radius (measured 0.3-0.4%; the float64 solve
    of the same problem lies 1.0-1.1% from JAX's float32 one). On
    ``tests/test_torch_engine.py``'s 4-view scene no point comparison can
    hold: its BA stops at the 40-iteration cap unconverged, and the float32
    and float64 solves of one problem part by 40-77% of that radius."""
    from tests.test_global_sfm import _small_config

    monkeypatch.setenv("SFM_NO_DENSE_SCHUR", "1")
    cfg = _small_config()
    jeng = jinc.SfmEngine(orbit6["dir"], orbit6["n"], config=cfg, single_K=orbit6["K"],
                          auto_run=False)
    jeng._try_run_front_fused(jeng._extract_all_features())
    teng = tinc.SfmEngine(orbit6["dir"], orbit6["n"],
                          config=interop.config_from_dict(dataclasses.asdict(cfg)),
                          single_K=orbit6["K"], device="cpu", auto_run=False)
    interop.import_engine_state(teng, jeng)
    frames, tracks, xy = jeng.map.observations()
    cams = np.array([np.hstack([rv, t]) for rv, t in jeng.global_poses])
    fixed = np.arange(len(cams)) < freeze_before
    jp = jprob.pad_problem(jprob.make_problem(cams, jeng.map.points(), frames, tracks, xy,
                                              np.stack(jeng.global_K), cam_fixed=fixed))
    tp = interop.ba_problem_from_numpy(jp)
    kw = dict(cg_iters=60, ftol=cfg.ba.ftol)
    for k in range(1, 6):
        a = jlm.bundle_adjust(jp, max_iters=k, **kw)
        b = tlm.bundle_adjust(tp, max_iters=k, **kw)
        assert float(b.final_cost) == pytest.approx(float(a.final_cost), rel=1e-3), k
    ref = jlm.bundle_adjust(jp, max_iters=cfg.ba.max_lm_iters, **kw)
    teng._global_ba(freeze_before=freeze_before)
    assert chip_smoke.port_ladder_api(torch.device("cpu")).final_ba(teng)["backend"] == "pcg"
    e0, e1 = teng.errors_before_after_ba
    assert e0 == pytest.approx(float(ref.initial_mean_error), rel=1e-4)
    assert e1 == pytest.approx(float(ref.final_mean_error), rel=1e-2)
    assert float(teng.ba_result.final_cost) == pytest.approx(float(ref.final_cost), rel=1e-2)
    n_pts = teng.map.num_tracks
    multi = np.bincount(tracks, minlength=n_pts) >= 3
    assert multi.sum() >= 10
    want = np.asarray(ref.points)[:n_pts][multi].astype(np.float64)
    aligned = chip_smoke._similarity_align(teng.map.points()[multi], want)
    radius = np.linalg.norm(want - want.mean(0), axis=1).max()
    assert np.abs(aligned - want).max() <= 0.02 * radius, np.abs(aligned - want).max() / radius
