"""Reference numbers for the scale phase of the port's chip smoke test.

Runs the JAX package on the CPU for ``config.seed`` 0-4 in the four runs of
the scale phase, at the bench widths:

* keyframes: the global engine as ``chip_smoke.scale_cli_argv`` makes the CLI
  build it (window 2, ``keyframe_step="auto"`` at ``SCALE_FLOW_PX``, the CLI's
  default BA, focal 520, scale 1.0, a pair cache) on the 47-view 1.5 deg/view orbit
  (``chip_smoke.orbit_sequence(..., SCALE_VIEWS, SCALE_STEP_DEG)``), with
  the seed replaced;
* stream: the same engine with ``chip_smoke.SCALE_STREAM``'s streaming BA,
  resumed from the keyframes run's cache;
* retrieval: ``GlobalSfmEngine(**chip_smoke.RETRIEVAL_ENGINE)`` at the bench
  configuration on ``chip_smoke.shuffled_planes``;
* selfcal: the incremental engine as ``chip_smoke.SELFCAL_CLI`` makes the CLI
  build it (``refine_focal=True``) on ``chip_smoke.selfcal_sequence``;
* selfcal_bench (not by default): the same at the CLI's bench-width
  defaults (focal 520, scale 1.0) on the bench sequence, where a shared
  focal is weakly observable.

Also solves ``chip_smoke.focal_observable_arrays(default_rng(5))`` with
``bundle_adjust_selfcal`` once (it draws no RANSAC sample). Prints one JSON
line per run with the gates of the JAX tests it passes, and a summary of
each quantity's range. ``chip_smoke.py`` pins its scale tolerances beside
these numbers.

    JAX_PLATFORMS=cpu python tools/scale_pins.py [--seeds 0 1 2 3 4] [--flow-px 7.5]
        [--runs keyframes stream retrieval selfcal selfcal_bench]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the scenes and settings, no JAX)

_KEYS = ("cameras", "ate_over_extent", "reproj_before_px", "reproj_after_px", "tracks")


def _row(eng, gt, first_image, **extra):
    ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt, first_image)
    e0, e1 = eng.errors_before_after_ba
    return dict(extra, cameras=len(eng.global_poses), ate_over_extent=ate / extent,
                reproj_before_px=float(e0), reproj_after_px=float(e1),
                tracks=int(eng.map.num_tracks), observations=int(eng.map.num_observations),
                warnings=list(eng.warnings),
                stage_times_s={k: float(v) for k, v in eng.stage_times.items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--runs", nargs="+", default=["keyframes", "stream", "retrieval", "selfcal"])
    ap.add_argument("--flow-px", type=float, default=chip_smoke.SCALE_FLOW_PX,
                    help="keyframe flow target; 0 for the engine's default (5%% of the "
                         "image diagonal)")
    args = ap.parse_args()

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from sfmfromscratch_tpu.ba.problem import make_problem
    from sfmfromscratch_tpu.ba.selfcal import bundle_adjust_selfcal
    from sfmfromscratch_tpu.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )
    from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu.pipeline.incremental import SfmEngine

    bench = PipelineConfig(
        extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
        matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER), ransac=RansacConfig(),
        ba=BundleAdjustConfig(**chip_smoke.BENCH_BA), scale_factor=1.0,
    )
    # cli.py's PipelineConfig for these flags: the extractor defaults,
    # max_matches = num_interest_points, the default BA.
    cli_cfg = dataclasses.replace(bench, ba=BundleAdjustConfig())
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if "selfcal" in args.runs:
        pos, kw = chip_smoke.focal_observable_arrays(np.random.default_rng(5))
        t0 = time.perf_counter()
        res, s = bundle_adjust_selfcal(make_problem(*pos, **kw), max_iters=30, cg_iters=60,
                                       ftol=1e-12)
        print(json.dumps({"run": "selfcal_ba", "s": float(s),
                          "s_gate": abs(float(s) - 1 / 1.06) < 0.01,
                          "final_mean_error": float(res.final_mean_error),
                          "iterations": int(res.iterations_used),
                          "wall_s": time.perf_counter() - t0}), flush=True)

    with tempfile.TemporaryDirectory(prefix="scale_pins_") as tmp:
        if {"keyframes", "stream"} & set(args.runs):
            seq = os.path.join(tmp, "dense")
            os.makedirs(seq)
            n = chip_smoke.SCALE_VIEWS
            K, gt = chip_smoke.orbit_sequence(seq, n, chip_smoke.SCALE_STEP_DEG)
            for seed in args.seeds:
                cache = os.path.join(tmp, f"cache_{seed}")
                kw = dict(config=dataclasses.replace(cli_cfg, seed=seed), single_K=K,
                          pair_window=2, keyframe_step="auto",
                          keyframe_flow_px=args.flow_px if args.flow_px > 0 else None,
                          pair_cache_dir=cache)
                e_kf = None
                for label, extra in (("keyframes", {}),
                                     ("stream", dict(stream_ba_window=2, stream_ba_block_cams=16))):
                    if label not in args.runs:
                        continue
                    t0 = time.perf_counter()
                    eng = GlobalSfmEngine(seq, n, **kw, **extra)
                    row = _row(eng, gt, 1, run=label, seed=seed, wall_s=time.perf_counter() - t0,
                               keyframes=len(eng.keyframes),
                               failed=sum("registration failed" in w for w in eng.warnings))
                    row["gates"] = (row["cameras"] == n and 3 < row["keyframes"] < n
                                    and row["failed"] <= 2 and row["reproj_after_px"] < 2.0)
                    if label == "keyframes":
                        e_kf = row["reproj_after_px"]
                    else:
                        st = eng.stream_stats
                        row.update(windows_run=st.windows_run, sweeps=st.sweeps,
                                   peak_resident_obs=st.peak_resident_obs,
                                   total_obs=st.total_obs)
                        if e_kf is not None:
                            row["gates"] = bool(
                                row["gates"] and st.windows_run >= 2
                                and st.peak_resident_obs < st.total_obs
                                and abs(row["reproj_after_px"] - e_kf) < max(0.35 * e_kf, 0.1))
                    emit(row)
        if "retrieval" in args.runs:
            seq = os.path.join(tmp, "planes")
            os.makedirs(seq)
            K, gt = chip_smoke.shuffled_planes(seq)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = GlobalSfmEngine(seq, chip_smoke.PLANES_VIEWS,
                                      config=dataclasses.replace(bench, seed=seed), single_K=K,
                                      **chip_smoke.RETRIEVAL_ENGINE)
                row = _row(eng, gt, 1, run="retrieval", seed=seed,
                           wall_s=time.perf_counter() - t0, edges=len(eng._edges))
                row["gates"] = (row["reproj_after_px"] < 2.0 and row["tracks"] > 40
                                and row["ate_over_extent"] < 0.08)
                emit(row)
        if "selfcal" in args.runs:
            seq = os.path.join(tmp, "selfcal")
            os.makedirs(seq)
            n = chip_smoke.SELFCAL_VIEWS
            K, gt = chip_smoke.selfcal_sequence(seq)
            # cli.py's PipelineConfig for chip_smoke.SELFCAL_CLI's flags.
            small = PipelineConfig(
                extractor=ExtractorConfig(num_interest_points=400, ksize=3, gaussian_size=7,
                                          sigma=3.0, alpha=0.05, feature_width=16,
                                          pyramid_level=2, pyramid_scale_factor=1.2),
                matcher=MatcherConfig(ratio_threshold=0.85, max_matches=400),
                ransac=RansacConfig(max_iterations=384), scale_factor=1.0)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = SfmEngine(seq, n, config=dataclasses.replace(small, seed=seed),
                                single_K=K, refine_focal=True)
                row = _row(eng, gt, 2, run="selfcal", seed=seed, wall_s=time.perf_counter() - t0,
                           focal_scale=float(eng.focal_scale))
                row["gates"] = (any(w.startswith("focal self-calibration") for w in eng.warnings)
                                and row["reproj_after_px"] <= row["reproj_before_px"]
                                and abs(row["focal_scale"] - 1.0) < 0.05)
                emit(row)
        if "selfcal_bench" in args.runs:
            seq = os.path.join(tmp, "bench")
            os.makedirs(seq)
            n = chip_smoke.HOST_VIEWS
            K, gt = chip_smoke.bench_sequence(seq, n)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = SfmEngine(seq, n, config=dataclasses.replace(cli_cfg, seed=seed),
                                single_K=K, refine_focal=True)
                row = _row(eng, gt, 2, run="selfcal_bench", seed=seed,
                           wall_s=time.perf_counter() - t0, focal_scale=float(eng.focal_scale))
                row["gates"] = abs(row["focal_scale"] - 1.0) < 0.05
                emit(row)
    summary = {}
    for run in sorted({r["run"] for r in rows}):
        sel = [r for r in rows if r["run"] == run]
        keys = _KEYS + tuple(k for k in ("keyframes", "failed", "focal_scale", "windows_run",
                                         "peak_resident_obs", "total_obs") if k in sel[0])
        summary[run] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)] for k in keys}
        summary[run]["all_gates"] = all(r["gates"] for r in sel)
    print(json.dumps({"seeds": args.seeds, "jax_cpu_range": summary}))


if __name__ == "__main__":
    main()
