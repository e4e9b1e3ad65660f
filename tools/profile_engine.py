"""Where the time of one engine run goes on a CUDA card.

Builds the port's kernels, warms the engine at the bench configuration
(``chip_smoke.engine_config``) on its scene, then

1. times ``--runs`` warm runs with a host clock (the engine ends in host
   fetches) and keeps each run's ``stage_times`` (each stage ends at a
   device synchronize), the null-vector kernel's launches and systems
   (its wrapper's counters), and the segment-sum kernel's launches beside
   the planned sums and the plans its spans counted (``segsum_launches``,
   ``segsum_plans``), and the global engine's translation-averaging kernel
   launches and host ms (the ``motion_averaging`` spans' counter
   ``transavg_launches`` and the ``motion_averaging.translation`` spans);
2. traces the first timed run's scene and seed once more with
   ``torch.profiler`` (CUDA activity): the kernels with the most device
   time, the device's busy time (the union of its kernel and copy
   intervals), its idle share of the run's wall time, the device-to-host
   copies and the device time of ``index_put_``'s
   ``indexing_backward_kernel*``; and, from the engine's spans (``eng.spans``, on the profiler's
   clock), each top-level stage's device busy time, the share of the busy
   time inside the top-level stages, and the span readings below.

The engine is ``SfmEngine`` on ``bench.py``'s 10-view sequence
(``chip_smoke.bench_sequence``); with ``--engine host`` the same run with the
host chain (``chain_mode="host"``: one synchronising fetch per frame) in
place of the scan chain; with ``--engine global`` ``GlobalSfmEngine`` on the
20-view 4 deg/view orbit of ``chip_smoke.py``'s global phase; with
``--engine scale`` the scale phase's keyframes run (the 47-view 1.5 deg/view
orbit, auto keyframes at ``chip_smoke.SCALE_FLOW_PX``, window 2, the CLI's
default BA) with no pair cache; with ``--engine ladder --rung L4`` a rung of
``chip_smoke.py``'s ladder phase (``chip_smoke.LADDER_RUNGS``) at the
ladder's configuration and scene. With ``--workload <cell> --seed <n>`` the
runs are a benchmark cell's first jobs (``portbench/``): its configuration,
the scenes of its pool in order, each with its job's RANSAC seed, after a
warm-up job on the cell's warm-up scene.

Span readings (``span_readings``; None where the engine records no spans):
``<stage>_idle_share``, 100 (1 - device busy time inside the traced run's
spans of the stage / the length of the same spans in the first timed run,
the same scene and seed unprofiled), matched by name and order, for
``filter``, ``chain`` (``bootstrap`` and ``chain``), ``ba``, ``keyframes``,
``register`` and ``motion_averaging``;
``ba_ms_per_lm_iter`` (the ``ba`` spans over their ``lm_iters``),
``filter_ransac_us_per_hyp`` (the ``filter.ransac`` spans over their
``hyps``), ``filter_nullvec_launches_per_hyp`` (their counter
``nullvec_launches`` over their ``hyps``: the null-vector kernel's
launches a hypothesis; 0 where no span counts them),
``ba_segsum_launches_per_lm_iter`` (the ``ba`` spans' ``segsum_launches``,
the planned segment sums of ``ba/schur.py``, over their ``lm_iters``) and
``segsum_plans_per_ba`` (their ``segsum_plans`` a ``ba`` span; None on a
tree whose BA builds no plans), ``ba_index_put_ms`` and
``ba_segsum_kernel_ms`` (device time inside the traced run's ``ba`` spans
of ``index_put_``'s ``indexing_backward_kernel*`` and of the segment-sum
kernel), ``decode_ms_per_view`` (the ``decode`` spans over the views); for the
keyframed global engine ``register_pnp_us_per_frame`` and
``register_link_ms_per_frame`` (the ``register.pnp`` and ``register.link``
spans over the ``register`` spans' ``frames``) and
``register_failed_per_job`` (the ``register`` spans' ``failed``, frames
that kept a keyframe's pose, a run); for the global engine
``transavg_launches_per_job`` (the ``motion_averaging`` spans'
``transavg_launches``, the translation-averaging kernel's launches, a run;
None on a tree whose spans do not count them) and
``averaging_translation_ms_per_job`` (the ``motion_averaging.translation``
spans, from the solve's call to its host copy, a run), each over the timed
runs. Prints one
JSON line per part as it is measured and, with ``--out``, appends it to
that file (JSON lines).

    python3 tools/profile_engine.py [--engine host|global|scale|ladder] [--rung L4] [--runs 3]
        [--workload inc10_bench --seed 3200000021] [--out profile_engine.json]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the bench sequence and configuration)

# The stages each span reading reads.
IDLE_STAGES = {"filter_idle_share": ("filter",), "chain_idle_share": ("bootstrap", "chain"),
               "ba_idle_share": ("ba",), "keyframes_idle_share": ("keyframes",),
               "register_idle_share": ("register",),
               "motion_averaging_idle_share": ("motion_averaging",)}


def union_pieces(intervals):
    """The union of (start, end) intervals as the sorted starts and ends of
    its disjoint pieces."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def busy_inside(pieces, a, b):
    """Length of the union ``pieces`` (``union_pieces``) inside [a, b]."""
    starts, ends = pieces
    i = bisect.bisect_right(ends, a)
    busy = 0
    while i < len(starts) and starts[i] < b:
        busy += min(b, ends[i]) - max(a, starts[i])
        i += 1
    return busy


def _closed(spans, names):
    return [s for s in spans if s.name in names and s.end_ns is not None]


def stage_idle_share(traced, plain, pieces, names):
    """100 (1 - device busy time inside ``traced``'s spans named ``names`` /
    the length of ``plain``'s spans of those names), in %; None where the
    two runs' sequences of those spans differ."""
    a, b = _closed(traced, names), _closed(plain, names)
    length = sum(s.end_ns - s.start_ns for s in b)
    if not a or [s.name for s in a] != [s.name for s in b] or length <= 0:
        return None
    return 100.0 * (1.0 - sum(busy_inside(pieces, s.start_ns, s.end_ns) for s in a) / length)


def per_count(runs, name, counter, scale, of=None):
    """The spans ``name`` of ``runs`` (lists of spans) over the sum of
    counter ``counter`` of the spans ``of`` (default: the same spans), times
    ``scale`` per second; None where that sum is 0."""
    n = sum(s.counters.get(counter, 0) for spans in runs for s in _closed(spans, (of or name,)))
    sec = 1e-9 * sum(s.end_ns - s.start_ns for spans in runs for s in _closed(spans, (name,)))
    return scale * sec / n if n else None


def counter_ratio(runs, name, num, den):
    """The sum of counter ``num`` over the sum of counter ``den`` on the
    spans ``name`` of ``runs``; None where the latter is 0."""
    spans = [s for spans in runs for s in _closed(spans, (name,))]
    d = sum(s.counters.get(den, 0) for s in spans)
    return sum(s.counters.get(num, 0) for s in spans) / d if d else None


def per_span(runs, name, counter):
    """Counter ``counter`` of the spans ``name`` of ``runs``, over those
    spans; None where none of them has it."""
    spans = [s for spans in runs for s in _closed(spans, (name,))]
    if not any(counter in s.counters for s in spans):
        return None
    return sum(s.counters.get(counter, 0) for s in spans) / len(spans)


def per_run(runs, name, counter):
    """Counter ``counter`` of the spans ``name`` summed over the runs that
    have such a span, over those runs; None where none has."""
    having = [_closed(spans, (name,)) for spans in runs]
    having = [ss for ss in having if ss]
    return (sum(s.counters.get(counter, 0) for ss in having for s in ss) / len(having)
            if having else None)


def span_ms_per_run(runs, name):
    """The spans ``name`` in ms, summed over the runs that have such a
    span, over those runs; None where none has."""
    having = [_closed(spans, (name,)) for spans in runs]
    having = [ss for ss in having if ss]
    return (1e-6 * sum(s.end_ns - s.start_ns for ss in having for s in ss) / len(having)
            if having else None)


def span_readings(traced, plain, pieces, runs, views, kernel_pieces=None):
    """The span readings of a traced run's spans ``traced`` against the
    first timed run's ``plain``, the device's union ``pieces`` (ns on the
    spans' clock) and the timed runs' spans ``runs`` of ``views`` views in
    all; ``kernel_pieces`` maps a reading's name to the union of some
    kernels' intervals, read as their ms inside the traced ``ba`` spans."""
    out = {k: stage_idle_share(traced, plain, pieces, v) for k, v in IDLE_STAGES.items()}
    out["ba_ms_per_lm_iter"] = per_count(runs, "ba", "lm_iters", 1e3)
    out["ba_segsum_launches_per_lm_iter"] = counter_ratio(runs, "ba", "segsum_launches",
                                                          "lm_iters")
    out["segsum_plans_per_ba"] = per_span(runs, "ba", "segsum_plans")
    for key, kp in (kernel_pieces or {}).items():
        out[key] = 1e-6 * sum(busy_inside(kp, s.start_ns, s.end_ns)
                              for s in _closed(traced, ("ba",)))
    out["filter_ransac_us_per_hyp"] = per_count(runs, "filter.ransac", "hyps", 1e6)
    out["filter_nullvec_launches_per_hyp"] = counter_ratio(runs, "filter.ransac",
                                                           "nullvec_launches", "hyps")
    out["register_pnp_us_per_frame"] = per_count(runs, "register.pnp", "frames", 1e6, of="register")
    out["register_link_ms_per_frame"] = per_count(runs, "register.link", "frames", 1e3,
                                                  of="register")
    out["register_failed_per_job"] = per_run(runs, "register", "failed")
    counted = any("transavg_launches" in s.counters
                  for spans in runs for s in _closed(spans, ("motion_averaging",)))
    out["transavg_launches_per_job"] = (per_run(runs, "motion_averaging", "transavg_launches")
                                        if counted else None)
    out["averaging_translation_ms_per_job"] = span_ms_per_run(runs, "motion_averaging.translation")
    decode = [s for spans in runs for s in _closed(spans, ("decode",))]
    out["decode_ms_per_view"] = (1e-6 * sum(s.end_ns - s.start_ns for s in decode) / views
                                 if decode else None)
    return out


def stage_busy(spans, pieces):
    """Per top-level stage (a child of the root span ``run``), in the order
    of first opening: its seconds and the device's busy seconds inside it;
    and the share of the whole busy time inside those stages."""
    root = next((i for i, s in enumerate(spans) if s.name == "run" and s.parent is None), None)
    stages, inside = {}, 0
    for s in spans:
        if root is None or s.parent != root or s.end_ns is None:
            continue
        busy = busy_inside(pieces, s.start_ns, s.end_ns)
        inside += busy
        sec, b = stages.get(s.name, (0.0, 0.0))
        stages[s.name] = (sec + 1e-9 * (s.end_ns - s.start_ns), b + 1e-9 * busy)
    total = sum(pieces[1]) - sum(pieces[0])
    return stages, (inside / total if total else None)


def _cell_runs(name, seed, root):
    """A benchmark cell's engine, configuration, keywords, warm-up scene and
    pool (``portbench/``), and the RANSAC seed of each job (-1: the warm-up
    job's, as ``portbench/run.py`` draws it)."""
    from portbench import jobs as J
    from portbench.scenes.pool import job_seed, make_pool
    from portbench.spec import Bench

    bench = Bench(ROOT)
    cfg_doc = bench.config(bench.workload(name)["config"])
    pool, warm = make_pool(bench.cell(name), cfg_doc, seed, root)
    return (J.engine_class(cfg_doc["engine"]), lambda s: J.pipeline_config(cfg_doc, s),
            cfg_doc.get("engine_kwargs", {}), warm, pool,
            lambda i: job_seed(seed ^ 0x5EED, 0) if i < 0 else job_seed(seed, i))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("incremental", "host", "global", "scale", "ladder"),
                    default="incremental")
    ap.add_argument("--rung", choices=tuple(chip_smoke.LADDER_RUNGS), default="L4",
                    help="the ladder rung of --engine ladder")
    ap.add_argument("--workload", default=None, help="a benchmark cell's jobs in place of --engine")
    ap.add_argument("--seed", type=int, default=1, help="the cell's run seed (--workload)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the parts to this JSON file")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device available", file=sys.stderr)
        return 2
    from sfmfromscratch_tpu_torch.native.build import build_all as native_build_all
    from sfmfromscratch_tpu_torch.ops.cuda import nullvec_kernel, segsum_kernel
    from sfmfromscratch_tpu_torch.ops.cuda.build import build_all
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    dev = torch.device("cuda")
    build_all()
    native_build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = chip_smoke.engine_config()
    kw = {"chain_mode": "host"} if args.engine == "host" else {}
    with tempfile.TemporaryDirectory(prefix="profile_engine_") as seq:
        if args.workload:
            engine, cell_cfg, kw, warm, pool, seed_of = _cell_runs(args.workload, args.seed, seq)

            def job(i):
                sc = pool[i % len(pool)] if i >= 0 else warm
                return len(sc.files), engine(sc.dir, len(sc.files), config=cell_cfg(seed_of(i)),
                                             single_K=sc.K, device=dev, **kw)
        else:
            if args.engine == "global":
                n = chip_smoke.GLOBAL_VIEWS
                K, _ = chip_smoke.orbit_sequence(seq, n, 4.0)
                engine = GlobalSfmEngine
            elif args.engine == "scale":
                import dataclasses

                from sfmfromscratch_tpu_torch.config import BundleAdjustConfig

                n = chip_smoke.SCALE_VIEWS
                K, _ = chip_smoke.orbit_sequence(seq, n, chip_smoke.SCALE_STEP_DEG)
                engine = GlobalSfmEngine
                cfg = dataclasses.replace(cfg, ba=BundleAdjustConfig())   # the CLI's BA
                kw = dict(pair_window=2, keyframe_step="auto",
                          keyframe_flow_px=chip_smoke.SCALE_FLOW_PX)
            elif args.engine == "ladder":
                name, n, kp, kw = chip_smoke.LADDER_RUNGS[args.rung][:4]
                K = chip_smoke.ladder_scene(args.rung, seq)["K"]
                engine = {"SfmEngine": SfmEngine, "GlobalSfmEngine": GlobalSfmEngine}[name]
                cfg = chip_smoke.ladder_config(chip_smoke.port_ladder_api(dev), kp)
            else:
                n = 10
                K, _ = chip_smoke.bench_sequence(seq)
                engine = SfmEngine

            def job(i):
                return n, engine(seq, n, config=cfg, single_K=K, device=dev, **kw)

        def emit(part):
            # Each part as soon as it is measured: a run cut by its time limit
            # keeps what it finished.
            print(json.dumps(part), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(part) + "\n")

        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            open(args.out, "w").close()
        emit({"card": smi, "torch": torch.__version__, "engine": args.engine,
              "rung": args.rung if args.engine == "ladder" else None,
              "workload": args.workload, "seed": args.seed if args.workload else None})
        job(-1)
        torch.cuda.synchronize()
        walls, stages, runs, views, nullvec, segsum, transavg = [], [], [], 0, [], [], []
        for i in range(args.runs):
            n0, s0 = nullvec_kernel.launches, nullvec_kernel.systems
            k0 = segsum_kernel.launches
            t0 = time.perf_counter()
            n_views, eng = job(i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stages.append(dict(eng.stage_times))
            runs.append(list(getattr(eng, "spans", None) or []))
            nullvec.append([nullvec_kernel.launches - n0, nullvec_kernel.systems - s0])
            segsum.append([segsum_kernel.launches - k0] +
                          [sum(s.counters.get(k, 0) for s in runs[-1])
                           for k in ("segsum_launches", "segsum_plans")])
            transavg.append([sum(s.counters.get("transavg_launches", 0) for s in runs[-1]),
                             span_ms_per_run(runs[-1:], "motion_averaging.translation")])
            views += n_views
        median = sorted(walls)[len(walls) // 2]
        emit({"part": "engine_warm_s", "runs": walls, "median": median,
              "frames_per_s_median": views / len(walls) / median,
              "nullvec_launches_systems": nullvec,
              "segsum_kernel_launches_span_launches_plans": segsum,
              "transavg_launches_translation_ms": transavg})
        emit({"part": "stage_times_s", "runs": stages,
              "filter_hyps_used_last_run": (None if eng.filter_hyps_used is None
                                            else [int(h) for h in eng.filter_hyps_used])})

        # The first timed run's scene and seed again, device activity only.
        # The intervals come from the raw kineto events (a global run
        # launches about a million kernels, too many for the profiler's
        # Python event tree); the tracer's own "Buffer Flush" and "Activity
        # Buffer Request" entries are not program work and are left out.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, eng = job(0)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    intervals, by_name, d2h = [], {}, 0
    # The BA's segment sums: index_put_'s kernels, and the kernel that took
    # their place.
    ba_kernels = {"ba_index_put_ms": "indexing_backward_kernel",
                  "ba_segsum_kernel_ms": "segment_sum_kernel"}
    ba_intervals = {k: [] for k in ba_kernels}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name in ("Buffer Flush", "Activity Buffer Request"):
            continue
        start, dur = e.start_ns(), e.duration_ns()
        intervals.append((start, start + dur))
        for k, part in ba_kernels.items():
            if part in name:
                ba_intervals[k].append((start, start + dur))
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + dur / 1e3, cnt + 1)
        d2h += "DtoH" in name
    pieces = union_pieces(intervals)
    busy = (sum(pieces[1]) - sum(pieces[0])) / 1e3
    top = sorted(((us, name, cnt) for name, (us, cnt) in by_name.items()), reverse=True)
    spans = list(getattr(eng, "spans", None) or [])
    per_stage, inside = stage_busy(spans, pieces) if spans else ({}, None)
    emit({"part": "trace", "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": (1.0 - busy / wall_us) if wall_us else None,
          "kernel_launches": len(intervals), "dtoh_copies": d2h,
          "indexing_backward_ms": sum(us for name, (us, _) in by_name.items()
                                      if "indexing_backward" in name) / 1e3,
          "traced_stage_times_s": eng.stage_times,
          "top_device_kernels_ms": [[k[:120], c, us / 1e3] for us, k, c in top[:15]],
          "busy_share_in_stages": inside,
          "stages_s_busy_s": {k: list(v) for k, v in per_stage.items()},
          "span_readings": (span_readings(spans, runs[0], pieces, runs, views,
                                          {k: union_pieces(v) for k, v in ba_intervals.items()})
                            if spans and runs and runs[0] else None)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
