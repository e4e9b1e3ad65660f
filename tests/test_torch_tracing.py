"""The engines' spans (``utils/profiling.py``'s ``StageTimer``) on the CPU:
their nesting, run ids, counters and clock, ``stage_times`` as their sums,
the profiler ranges they open only while a profiler runs, and the span
arithmetic of ``tools/profile_engine.py``.

Scenes: ``tests/test_torch_engine.py``'s 160x220 sequence
(``render_sequence(default_rng(21), 90 points, f=300)``) at that file's
configuration (300 keypoints, 2 levels, 1,024 hypotheses, 40 LM
iterations, scale 0.5), 4 views for the fused front, the staged front
(``pair_window=2``) and ``GlobalSfmEngine`` (window 2, 256 relative-pose
hypotheses, two BA rounds), 2 views for the profiler cases.
"""

import json

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu_torch.config import (
    BundleAdjustConfig,
    ExtractorConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine
from sfmfromscratch_tpu_torch.utils import profiling
from tests.render import render_sequence, write_sequence
from tools import profile_engine

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

# Spans that are children only: ``stage_times`` leaves them out.
CHILD_ONLY = {"decode", "filter.ransac", "relpose_ransac", "relpose_refine",
              "motion_averaging.translation", "chain_refresh.scales"}


def _config():
    return PipelineConfig(
        extractor=ExtractorConfig(num_interest_points=300, ksize=3, gaussian_size=7, sigma=3.0,
                                  alpha=0.05, feature_width=16, pyramid_level=2,
                                  pyramid_scale_factor=1.2),
        matcher=MatcherConfig(ratio_threshold=0.85, max_matches=300),
        ransac=RansacConfig(max_iterations=1024),
        ba=BundleAdjustConfig(max_lm_iters=40, ftol=1e-5), scale_factor=0.5, seed=5)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    images, K, _, _ = render_sequence(
        np.random.default_rng(21), num_views=4, num_points=90, img_hw=(160, 220), f=300.0,
        step_t=(-0.2, 0.02, 0.03), step_r=(0.008, -0.02, 0.005))
    d = tmp_path_factory.mktemp("seq4")
    write_sequence(str(d), images)
    K_half = K.copy()
    K_half[:2] *= 0.5   # features live on images at scale 0.5
    return str(d), K_half


def _engine(kind, scene, views=4):
    d, K = scene
    if kind == "global":
        return GlobalSfmEngine(d, views, config=_config(), single_K=K, device="cpu",
                               pair_window=2, rel_num_hypotheses=256)
    kw = {"pair_window": 2} if kind == "staged" else {}
    return SfmEngine(d, views, config=_config(), single_K=K, device="cpu", **kw)


@pytest.fixture(scope="module")
def engines(scene):
    return {kind: _engine(kind, scene) for kind in ("fused", "staged", "global")}


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("kind", ["fused", "staged", "global"])
def test_spans_nest_and_sum_to_stage_times(kind, engines):
    """One run id; the root span ``run`` first; every span closed and inside
    its parent; the top-level stages disjoint, in order, inside ``run``;
    ``stage_times`` the spans' summed durations by name (``run`` as
    ``total``, the child-only spans left out), the three child-only keys of
    old gone from it."""
    eng = engines[kind]
    spans = eng.spans
    assert spans[0].name == "run" and spans[0].parent is None
    assert len({s.run for s in spans}) == 1
    for s in spans[1:]:
        assert s.end_ns is not None and s.parent is not None and s.parent < spans.index(s)
        assert _inside(s, spans[s.parent]), s
    top = [s for s in spans if s.parent == 0]
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns, (a, b)
    names = [s.name for s in top]
    want = {"fused": ["features", "matching", "filter", "bootstrap", "chain", "fetch", "ba"],
            "staged": ["features", "matching", "filter", "bootstrap", "chain", "ba"],
            "global": ["features", "matching", "filter", "relative_poses", "motion_averaging",
                       "tracks", "triangulate", "ba.round1"]}[kind]
    assert names[:len(want)] == want, names
    children = {spans[s.parent].name + ">" + s.name for s in spans if s.parent}
    assert {"features>decode", "filter>filter.ransac"} <= children
    if kind == "global":
        assert {"relative_poses>relpose_ransac", "relative_poses>relpose_refine",
                "motion_averaging>motion_averaging.translation", "ba.round1>ba"} <= children
    sums = {}
    for s in spans:
        if s.name not in CHILD_ONLY:
            key = "total" if s.name == "run" else s.name
            sums[key] = sums.get(key, 0.0) + 1e-9 * (s.end_ns - s.start_ns)
    assert set(eng.stage_times) == set(sums)
    assert not set(eng.stage_times) & CHILD_ONLY
    for k, v in sums.items():
        assert eng.stage_times[k] == pytest.approx(v, rel=1e-3, abs=1e-3), k


@pytest.mark.parametrize("kind", ["fused", "staged", "global"])
def test_span_counters(kind, engines):
    """``filter.ransac``'s ``hyps`` sum to ``filter_hyps_used`` (every
    ``_filter`` call counted once), and its ``nullvec_launches`` are 0 on
    the CPU (the plain QR launches no kernel); the global engine's
    ``motion_averaging`` counts ``transavg_launches``, 0 on the CPU (the
    plain loops); the last ``ba`` span's ``lm_iters`` are the last BA's
    ``iterations_used``."""
    eng = engines[kind]
    hyps = [s.counters["hyps"] for s in eng.spans if s.name == "filter.ransac"]
    assert len(hyps) == 1 and hyps[0] == int(eng.filter_hyps_used.sum()) > 0
    assert [s.counters["nullvec_launches"] for s in eng.spans if s.name == "filter.ransac"] == [0]
    averaging = [s.counters.get("transavg_launches") for s in eng.spans
                 if s.name == "motion_averaging"]
    assert averaging == ([0] if kind == "global" else [])
    ba = [s for s in eng.spans if s.name == "ba"]
    assert ba and ba[-1].counters["lm_iters"] == eng.ba_result.iterations_used > 0


def test_spans_share_the_profilers_clock(scene):
    """Under ``torch.profiler`` (CPU activity) every span opens a
    ``record_function`` range of its name whose kineto event lies inside
    the span, and every op the run launched lies inside ``run``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng = _engine("fused", scene, views=2)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    run = eng.spans[0]
    ops = [e for e in events if e[0].startswith("aten::")]
    assert ops and all(run.start_ns <= a <= b <= run.end_ns for _, a, b in ops)
    for s in eng.spans:
        ranges = [e for e in events if e[0] == s.name and s.start_ns <= e[1] <= e[2] <= s.end_ns]
        assert len(ranges) >= 1, s


def test_trace_file_names_every_stage(scene, tmp_path):
    """``profiling.trace`` (the CLI's ``--profile_dir``) writes a trace that
    holds each span's name."""
    with profiling.trace(str(tmp_path)):
        eng = _engine("staged", scene, views=2)
    files = list(tmp_path.rglob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {s.name for s in eng.spans} <= names


def test_no_profiler_range_without_a_profiler(scene, monkeypatch):
    """With no profiler running the recorder makes no profiler call."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eng = _engine("fused", scene, views=2)
    assert [s.name for s in eng.spans if s.parent == 0][0] == "features"


def test_bare_engine_stage_times():
    """``stage_times = {...}`` on an engine built without ``__init__`` gives it
    a fresh recorder holding those times, whose stages then add to them."""
    eng = object.__new__(GlobalSfmEngine)
    eng.device = torch.device("cpu")
    eng.stage_times = {}
    assert eng.stage_times == {} and eng.spans == []
    span = eng._stage("motion_averaging")
    assert eng._stage_end(span) is None
    assert set(eng.stage_times) == {"motion_averaging"} and eng.spans == [span]
    eng.stage_times = {"tracks": 1.5}
    assert eng.stage_times == {"tracks": 1.5} and eng.spans == []


def test_count_and_unwinding():
    """``count`` adds to the innermost open span and does nothing with none
    open; a run that raises leaves its open spans unclosed and off the
    thread's stack, and the next run starts clean with a new id."""
    profiling.count("x")   # no span open: nothing happens
    timer = profiling.StageTimer()
    with pytest.raises(RuntimeError):
        with timer.run():
            outer = timer.open("outer")
            profiling.count("n", 2)
            inner = timer.open("inner")
            profiling.count("n")
            timer.close(inner, time_as=None)
            profiling.count("n", 3)
            raise RuntimeError("stage failed")
    assert outer.counters == {"n": 5} and inner.counters == {"n": 1}
    assert outer.end_ns is None and inner.end_ns is not None
    assert timer.times == {}
    first = timer.run_id
    with timer.run():
        with timer.stage("work", sync_on=torch.ones(1)):
            profiling.count("k")
    assert [s.name for s in timer.spans] == ["run", "work"] and timer.run_id != first
    assert timer.spans[1].parent == 0 and timer.spans[1].counters == {"k": 1}
    assert set(timer.times) == {"total", "work"}
    profiling.count("x")
    assert all("x" not in s.counters for s in timer.spans)


def _span(name, start, end, parent=0, **counters):
    return profiling.Span(name, parent, 1, start, end, dict(counters))


def test_profile_engine_span_arithmetic():
    """``tools/profile_engine.py``'s readings on hand-made spans and device
    intervals (ns): the union, the busy time inside a span, each stage's
    idle share against the unprofiled run's span lengths (None where the
    two runs' spans differ), the per-count times and the busy share inside
    the top-level stages."""
    pieces = profile_engine.union_pieces([(0, 10), (5, 20), (30, 40), (40, 45), (60, 70)])
    assert pieces == ([0, 30, 60], [20, 45, 70])
    assert profile_engine.busy_inside(pieces, 10, 65) == 10 + 15 + 5
    assert profile_engine.busy_inside(pieces, 20, 30) == 0
    traced = [_span("run", 0, 100, parent=None), _span("filter", 0, 25), _span("ba", 25, 40),
              _span("filter", 55, 100), _span("filter.ransac", 60, 65, parent=3, hyps=10)]
    plain = [_span("run", 0, 80, parent=None), _span("filter", 0, 20), _span("ba", 20, 40),
             _span("filter", 40, 80)]
    # filter: busy 20 + 10 of 20 + 40 ns unprofiled
    assert profile_engine.stage_idle_share(traced, plain, pieces, ("filter",)) == \
        pytest.approx(100 * (1 - 30 / 60))
    assert profile_engine.stage_idle_share(traced, plain, pieces, ("ba",)) == \
        pytest.approx(100 * (1 - 10 / 20))
    assert profile_engine.stage_idle_share(traced, plain[:3], pieces, ("filter",)) is None
    assert profile_engine.stage_idle_share(traced, plain, pieces, ("chain",)) is None
    runs = [[_span("ba", 0, 4_000_000, lm_iters=4), _span("decode", 0, 1_000_000, parent=None)],
            [_span("ba", 0, 2_000_000, lm_iters=2), _span("filter.ransac", 0, 3000, hyps=6)]]
    assert profile_engine.per_count(runs, "ba", "lm_iters", 1e3) == pytest.approx(1.0)
    assert profile_engine.per_count(runs, "filter.ransac", "hyps", 1e6) == pytest.approx(0.5)
    assert profile_engine.per_count(runs, "chain", "x", 1.0) is None
    runs[1].append(_span("filter.ransac", 0, 1000, hyps=2, nullvec_launches=3))
    assert profile_engine.counter_ratio(runs, "filter.ransac", "nullvec_launches", "hyps") == \
        pytest.approx(3 / 8)
    assert profile_engine.counter_ratio(runs, "ba", "nullvec_launches", "hyps") is None
    assert profile_engine.span_readings(traced, plain, pieces, runs, views=4)[
        "filter_nullvec_launches_per_hyp"] == pytest.approx(3 / 8)
    runs[1].pop()
    got = profile_engine.span_readings(traced, plain, pieces, runs, views=4)
    assert got["decode_ms_per_view"] == pytest.approx(0.25)
    assert got["chain_idle_share"] is None and got["ba_ms_per_lm_iter"] == pytest.approx(1.0)
    stages, inside = profile_engine.stage_busy(traced, pieces)
    assert list(stages) == ["filter", "ba"]
    assert stages["filter"] == pytest.approx((70e-9, 30e-9))
    assert inside == pytest.approx((20 + 10 + 10) / 45)   # [40, 45] lies in no stage
    assert profile_engine.stage_busy([], ([], [])) == ({}, None)


def test_profile_engine_registration_readings():
    """The keyframed engine's readings of ``tools/profile_engine.py`` on
    hand-made spans (ns): ``register.pnp`` and ``register.link`` over the
    ``register`` spans' ``frames``, the ``failed`` frames a run over the runs
    that registered, and the ``keyframes`` and ``register`` idle shares."""
    pieces = profile_engine.union_pieces([(0, 10), (30, 60)])
    runs = [[_span("run", 0, 9_000_000, parent=None),
             _span("keyframes", 0, 1_000_000, frames=149, keyframes=10),
             _span("register", 1_000_000, 8_000_000, frames=140, pairs=280, failed=1),
             _span("register.link", 1_000_000, 1_700_000, parent=2),
             _span("register.pnp", 2_000_000, 6_200_000, parent=2)],
            [_span("run", 0, 5_000_000, parent=None),
             _span("register", 0, 4_000_000, frames=60, failed=2),
             _span("register.link", 0, 100_000, parent=1),
             _span("register.pnp", 0, 1_400_000, parent=1)],
            [_span("run", 0, 100, parent=None)]]
    assert profile_engine.per_count(runs, "register.pnp", "frames", 1e6, of="register") == \
        pytest.approx(1e6 * 5.6e-3 / 200)
    assert profile_engine.per_count(runs, "register.link", "frames", 1e3, of="register") == \
        pytest.approx(1e3 * 0.8e-3 / 200)
    assert profile_engine.per_count(runs, "register.pnp", "x", 1.0, of="keyframes") is None
    assert profile_engine.per_run(runs, "register", "failed") == pytest.approx(1.5)
    assert profile_engine.per_run(runs[2:], "register", "failed") is None
    traced = [_span("run", 0, 100, parent=None), _span("keyframes", 0, 20),
              _span("register", 20, 80)]
    plain = [_span("run", 0, 90, parent=None), _span("keyframes", 0, 40),
             _span("register", 40, 90)]
    got = profile_engine.span_readings(traced, plain, pieces, runs, views=300)
    assert got["keyframes_idle_share"] == pytest.approx(100 * (1 - 10 / 40))
    assert got["register_idle_share"] == pytest.approx(100 * (1 - 30 / 50))
    assert got["register_pnp_us_per_frame"] == pytest.approx(28.0)
    assert got["register_link_ms_per_frame"] == pytest.approx(0.004)
    assert got["register_failed_per_job"] == pytest.approx(1.5)


def test_profile_engine_segsum_readings():
    """The BA's segment-sum readings of ``tools/profile_engine.py`` on
    hand-made spans (ns): planned sums an LM iteration, plans a ``ba`` span
    (None where no span counts them, as on a tree before the plans), and
    named kernels' device time inside the traced ``ba`` spans."""
    runs = [[_span("run", 0, 9_000_000, parent=None),
             _span("ba", 0, 4_000_000, lm_iters=10, segsum_plans=2, segsum_launches=700)],
            [_span("run", 0, 5_000_000, parent=None),
             _span("ba", 0, 1_000_000, lm_iters=4, segsum_plans=3, segsum_launches=28),
             _span("ba", 1_000_000, 2_000_000, lm_iters=6, segsum_plans=2,
                   segsum_launches=200)]]
    assert profile_engine.counter_ratio(runs, "ba", "segsum_launches", "lm_iters") == \
        pytest.approx(928 / 20)
    assert profile_engine.per_span(runs, "ba", "segsum_plans") == pytest.approx(7 / 3)
    assert profile_engine.per_span([[_span("ba", 0, 10, lm_iters=3)]], "ba",
                                   "segsum_plans") is None
    traced = [_span("run", 0, 100, parent=None), _span("ba", 10, 50), _span("ba", 60, 90)]
    pieces = profile_engine.union_pieces([(0, 100)])
    kernels = {"ba_index_put_ms": profile_engine.union_pieces([(0, 20), (45, 70)]),
               "ba_segsum_kernel_ms": ([], [])}
    got = profile_engine.span_readings(traced, traced, pieces, runs, views=10,
                                       kernel_pieces=kernels)
    assert got["ba_segsum_launches_per_lm_iter"] == pytest.approx(928 / 20)
    assert got["segsum_plans_per_ba"] == pytest.approx(7 / 3)
    assert got["ba_index_put_ms"] == pytest.approx(1e-6 * (10 + 5 + 10))
    assert got["ba_segsum_kernel_ms"] == 0


def test_profile_engine_transavg_readings():
    """The global engine's translation-averaging readings of
    ``tools/profile_engine.py`` on hand-made spans (ns): the kernel's
    launches a run from the ``motion_averaging`` spans' counter (None where
    no span counts them, as on a tree before the kernel) and the
    ``motion_averaging.translation`` spans' ms a run that has one."""
    runs = [[_span("run", 0, 9_000_000, parent=None),
             _span("motion_averaging", 0, 5_000_000, transavg_launches=1, segsum_plans=6),
             _span("motion_averaging.translation", 4_000_000, 4_600_000, parent=1)],
            [_span("run", 0, 9_000_000, parent=None),
             _span("motion_averaging", 0, 3_000_000, transavg_launches=1),
             _span("motion_averaging.translation", 2_000_000, 2_200_000, parent=1)]]
    pieces = profile_engine.union_pieces([(0, 10)])
    got = profile_engine.span_readings(runs[0], runs[0], pieces, runs, views=40)
    assert got["transavg_launches_per_job"] == pytest.approx(1.0)
    assert got["averaging_translation_ms_per_job"] == pytest.approx(0.4)
    before = [[_span("run", 0, 9_000_000, parent=None),
               _span("motion_averaging", 0, 5_000_000, segsum_plans=6)]]
    got = profile_engine.span_readings(before[0], before[0], pieces, before, views=20)
    assert got["transavg_launches_per_job"] is None
    assert got["averaging_translation_ms_per_job"] is None
