"""End-to-end and per-layer arithmetic on hand-made job records and traces."""

import math

import numpy as np
import pytest

from portbench import check, jobs as J, trace as T
from portbench.readings import Readings
from portbench.roofline import harris, k3
from portbench.roofline.peaks import peaks
from portbench.spec import Bench

from test_portbench_layout import ROOT


def _rec(i, start, end, views=10, error=None, cameras=9, stages=None, hyps=None):
    r = J.JobRecord(index=i, scene=i, seed=i, views=views, start=start, end=end, error=error,
                    cameras=cameras, want_cameras=views - 1)
    r.stage_times = stages or {}
    r.hyps = None if hyps is None else np.asarray(hyps)
    return r


def test_frames_per_s_counts_all_time_and_the_views_of_jobs_that_did_not_fail():
    jobs = [_rec(0, 0.0, 2.0), _rec(1, 2.0, 4.5, error="boom", cameras=0),
            _rec(2, 4.5, 6.0, cameras=8),        # registered too few cameras: failed
            _rec(3, 6.0, 11.0)]                  # started before a 10 s window closed: overruns
    e2e = J.end_to_end(jobs)
    assert e2e["window_s"] == pytest.approx(11.0)
    assert e2e["frames_per_s"] == pytest.approx(20 / 11.0)
    assert [j.failed for j in jobs] == [False, True, True, False]


def test_the_window_starts_jobs_until_its_seconds_pass_and_runs_each_to_its_end(monkeypatch):
    clock = iter(float(t) for t in range(0, 100))
    monkeypatch.setattr(J.time, "perf_counter", lambda: next(clock))
    calls = []

    def fake_job(i, k, scene, cfg, seed, device, sync):
        calls.append((i, k))
        return _rec(i, 0.0, 1.0)

    monkeypatch.setattr(J, "run_job", fake_job)
    jobs = J.window(["a", "b", "c"], {}, 1, 4.5, None, None)
    # clock: t0=0; checks at 1, 2, 3, 4 start jobs; the check at 5 stops
    assert [c[0] for c in calls] == [0, 1, 2, 3, 4] and len(jobs) == 5
    assert [c[1] for c in calls] == [0, 1, 2, 0, 1]      # the pool in order, wrapping


def test_the_traced_window_profiles_its_first_job_again_once_it_has_closed(monkeypatch):
    import contextlib

    now = [0.0]
    monkeypatch.setattr(J.time, "perf_counter", lambda: now[0])
    seen = []

    @contextlib.contextmanager
    def profiler():
        seen.append("on")
        yield
        now[0] += 100.0        # the trace's processing, after the window
        seen.append("off")

    def fake_job(i, k, scene, cfg, seed, device, sync):
        seen.append((i, k))
        now[0] += 1.0
        return _rec(i, now[0] - 1.0, now[0])

    monkeypatch.setattr(J, "run_job", fake_job)
    jobs = J.window(["a", "b"], {}, 1, 2.5, None, None, trace_after=profiler())
    # the window's jobs, then its first job (scene and seed) again under the profiler
    assert seen == [(0, 0), (1, 1), (2, 0), "on", (0, 0), "off"] and len(jobs) == 4


def test_span_readers_sum_spans_over_views_and_leave_out_failed_jobs():
    bench = Bench(ROOT)
    jobs = [_rec(0, 0, 1, stages={"features": 0.2, "matching": 0.1, "filter": 0.3, "ba": 0.5,
                                  "bootstrap": 0.05, "chain": 0.45}, hyps=[512, 1024]),
            _rec(1, 1, 2, stages={"features": 0.4, "matching": 0.1, "filter": 0.1, "ba": 0.3,
                                  "bootstrap": 0.05, "chain": 0.25}, hyps=[512]),
            _rec(2, 2, 3, error="x", stages={"features": 9.0})]
    r = Readings(jobs=jobs, config={}, card="NVIDIA H100 80GB HBM3")
    assert bench.reader("frontend_ms_per_view")(r) == pytest.approx(1e3 * 0.8 / 20)
    assert bench.reader("filter_ms_per_view")(r) == pytest.approx(1e3 * 0.4 / 20)
    assert bench.reader("filter_us_per_hyp")(r) == pytest.approx(1e6 * 0.4 / 2048)
    assert bench.reader("chain_ms_per_view")(r) == pytest.approx(1e3 * 0.8 / 20)
    assert bench.reader("ba_ms_per_view")(r) == pytest.approx(1e3 * 0.8 / 20)
    assert bench.reader("averaging_ms_per_view")(r) is None     # no such span: nothing read
    assert bench.reader("harris_roofline")(r) is None           # no trace: nothing read
    assert bench.reader("idle_share")(r) is None


def test_filter_readers_read_nothing_where_no_pair_was_filtered():
    bench = Bench(ROOT)
    jobs = [_rec(0, 0, 1, views=2, cameras=1, stages={"filter": 0.001, "features": 0.1})]
    r = Readings(jobs=jobs, config={}, card="x")
    assert bench.reader("filter_ms_per_view")(r) is None
    assert bench.reader("filter_us_per_hyp")(r) is None


def test_trace_union_gaps_and_breakdown():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (4.0, 4.5), (6.0, 7.0)]
    assert T.busy_union(iv) == pytest.approx(4.5)
    assert T.idle_gaps(iv) == [(2.0, 3.0), (4.5, 6.0)]
    s = T.TraceSummary(window_s=8.0, busy_s=4.5, by_name={"harris_kernel<7>": (0.5, 3),
                       "match_f32_kernel": (2.0, 1), "copy": (3.0, 10)},
                       gaps=T.idle_gaps(iv), intervals=5, span_s=7.0)
    b = T.breakdown(s, {"features": 3.0, "filter": 2.5, "ba": 1.5, "total": 7.5})
    assert [n for n, _ in b["device_ops"]] == ["copy", "match_f32_kernel", "harris_kernel<7>"]
    gaps = b["idle_gaps"]
    assert gaps[0][1] == pytest.approx(1.5) and "idle in filter" in gaps[0][0]
    assert "idle in features" in gaps[1][0] and gaps[1][1] == pytest.approx(1.0)
    assert "before the first" in gaps[2][0] and gaps[2][1] == pytest.approx(1.0)
    assert s.kernel_seconds("harris") == (0.5, 3)


def test_roofline_and_idle_readers_against_hand_counts():
    bench = Bench(ROOT)
    cfg = bench.config("incremental_upstream")
    traced = _rec(0, 0, 1, views=10)
    traced.pair_geometry = {(i, i + 1): None for i in range(1, 10)}
    traced.pair_geometry.update({(i + 1, i): None for i in range(1, 10)})
    s = T.TraceSummary(window_s=2.0, busy_s=0.1, by_name={"harris_kernel<7>": (1e-4, 3),
                       "match_f32_kernel": (5e-4, 1)}, gaps=[], intervals=4, span_s=1.0)
    r = Readings(jobs=[traced], config=cfg, card="NVIDIA H100 80GB HBM3", trace=s, traced=traced)
    p = peaks("NVIDIA H100 80GB HBM3")
    px = 10 * (360 * 480 + 327 * 436 + 297 * 396)
    want_h = max(8.0 * px / 3.35e12, px * (16 + 12 * 7) / 67e12)
    assert bench.reader("harris_roofline")(r) == pytest.approx(100 * want_h / 1e-4)
    fl = 2.0 * 9 * 2499 * 2499 * 128
    by = 4.0 * (9 * 2499 * 128 * 2 + 9 * 2499) + 12.0 * 9 * 2499
    assert bench.reader("k3_roofline")(r) == pytest.approx(100 * max(fl / 67e12, by / 3.35e12) / 5e-4)
    # busy 0.1 s of the same job's unprofiled 1 s (the window's first job)
    assert bench.reader("idle_share")(r) == pytest.approx(90.0)
    other = _rec(1, 0, 0.5, views=10)
    r2 = Readings(jobs=[other], config=cfg, card="NVIDIA H100 80GB HBM3", trace=s, traced=traced)
    assert bench.reader("idle_share")(r2) is None     # another scene: no same work to set it against
    assert p["variant"] == "SXM"


def test_roofline_counts_by_hand():
    assert harris.level_shapes((360, 480), 3, 1.1) == [(360, 480), (327, 436), (297, 396)]
    nb, fl = harris.work(2, [(10, 20)], 7)
    assert nb == 8.0 * 400 and fl == 400 * (16 + 84)
    nb, fl = k3.work(B=2, n1=3, n2=5, D=4)
    assert fl == 2 * 2 * 3 * 5 * 4
    assert nb == 4 * (2 * 3 * 4 + 2 * 5 * 4 + 2 * 5) + 12 * 2 * 3
    pk = {"bytes_per_s": 1.0, "fp32_flops": 2.0}
    assert harris.bound_s(3.0, 4.0, pk) == 3.0 and k3.bound_s(1.0, 4.0, pk) == 2.0


def test_verdict_takes_the_worst_job_and_fails_on_a_failed_job_or_a_missing_number():
    per_job = [{"kp_off": 0.001, "rot_deg": 0.2}, {"kp_off": 0.003, "rot_deg": 0.1}]
    ok, table = check.verdict(per_job, {"kp_off": 0.01, "rot_deg": 0.5}, failed=0)
    assert ok and table["kp_off"]["value"] == 0.003 and table["failed_jobs"]["value"] == 0
    assert not check.verdict(per_job, {"kp_off": 0.002}, failed=0)[0]
    assert not check.verdict(per_job, {"kp_off": 0.01}, failed=1)[0]
    assert not check.verdict(per_job, {"epi_bad": 0.01}, failed=0)[0]
    assert not check.verdict([{"kp_off": math.nan}], {"kp_off": 0.01}, failed=0)[0]
    assert not check.verdict([], {"kp_off": 0.01}, failed=0)[0]


def test_the_judged_sample_is_drawn_from_the_seed_and_holds_the_first_job():
    assert check.sample_jobs(5, 8, 3) == [0, 1, 2, 3, 4]
    a = check.sample_jobs(100, 10, 2 ** 31 + 7)
    assert a == check.sample_jobs(100, 10, 2 ** 31 + 7) and len(a) == 10 and a[0] == 0
    assert a != check.sample_jobs(100, 10, 8)


def test_front_counts_by_hand():
    ref_xy = np.array([[[10.0, 10.0], [20.0, 20.0], [30.0, 30.0]],
                       [[11.0, 10.0], [21.0, 20.0], [31.0, 30.0]]])
    ref_mask = np.array([[True, True, True], [True, True, True]])
    ref_matches = {(1, 2): (np.array([0, 1, 2]), np.array([True, True, False]))}
    kept = {(1, 2): (np.array([[10.0, 10.0], [20.0, 20.0], [30.0, 30.0], [40.0, 40.0]]),
                     np.array([[11.0, 10.0], [31.0, 30.0], [31.0, 30.0], [11.0, 10.0]]))}
    c = check.front_counts(ref_xy, ref_mask, ref_matches, kept)
    # endpoint (40, 40) is no reference keypoint; match 2 pairs the wrong partner;
    # match 3's reference query is not accepted by the ratio test
    assert (c["ends"], c["ends_off"], c["kept"], c["kept_off"]) == (8, 1, 4, 3)
