"""Reference numbers for the host phase of the port's chip smoke test.

Runs the JAX package on the CPU on ``bench.py``'s 10-view sequence
(``chip_smoke.bench_sequence``) in the three configurations of the host
phase, for ``config.seed`` 0-4:

* cli: the configuration that ``chip_smoke.host_cli_argv`` gives the CLI
  (bench widths, which are the CLI's defaults; BA at the CLI's default
  ftol; scale 1.0; ``--focal 520``; window 3; a local BA every 3 cameras; a
  pair cache), built as ``sfmfromscratch_tpu/cli.py`` builds it with the seed
  replaced, cold and then resumed from its own cache. The CLI itself runs
  once at its own seed (5) and prints its two lines;
* distance: ``SfmEngine(chain_mode="host", assoc_mode="distance")`` at the
  bench configuration (``chip_smoke.engine_config``);
* recover: the bench configuration with ``on_pose_failure="recover"``,
  window 3 and a checkpoint every 3 frames, image
  ``chip_smoke.HOST_FLAT_IMAGE`` replaced by a flat gray frame.

Prints one JSON line per run (with its stage times and warnings) and a
summary of each quantity's range: cameras, ATE over trajectory extent,
mean reprojection error before and after bundle adjustment (px), tracks,
observations and observations per track. ``chip_smoke.py`` pins its host
tolerances beside these numbers.

With ``--package port`` the same runs go through the PyTorch port on the CPU
(``device="cpu"``; its RANSAC draws come from a ``torch.Generator`` seeded
with ``config.seed``), so the two packages' spreads can be set side by side.

    JAX_PLATFORMS=cpu python tools/host_pins.py [--seeds 0 1 2 3 4] [--runs cli distance recover]
    python tools/host_pins.py --package port --runs recover
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

import chip_smoke  # noqa: E402  (the scene and settings, no JAX)

_KEYS = ("cameras", "ate_over_extent", "reproj_before_px", "reproj_after_px", "tracks",
         "observations", "obs_per_track")


def _row(eng, gt, **extra):
    ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt)
    e0, e1 = eng.errors_before_after_ba
    return dict(extra, cameras=len(eng.global_poses), ate_over_extent=ate / extent,
                reproj_before_px=float(e0), reproj_after_px=float(e1),
                tracks=int(eng.map.num_tracks), observations=int(eng.map.num_observations),
                obs_per_track=eng.map.num_observations / max(eng.map.num_tracks, 1),
                warnings=list(eng.warnings), stage_times_s=dict(eng.stage_times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--runs", nargs="+", default=["cli", "distance", "recover"])
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    args = ap.parse_args()

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfmfromscratch_tpu import cli
        from sfmfromscratch_tpu.config import (
            BundleAdjustConfig,
            ExtractorConfig,
            MatcherConfig,
            PipelineConfig,
            RansacConfig,
        )
        from sfmfromscratch_tpu.pipeline.incremental import SfmEngine
    else:
        import functools

        from sfmfromscratch_tpu_torch import cli
        from sfmfromscratch_tpu_torch.config import (
            BundleAdjustConfig,
            ExtractorConfig,
            MatcherConfig,
            PipelineConfig,
            RansacConfig,
        )
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        SfmEngine = functools.partial(SfmEngine, device="cpu")

    bench = PipelineConfig(
        extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
        matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER), ransac=RansacConfig(),
        ba=BundleAdjustConfig(**chip_smoke.BENCH_BA), scale_factor=1.0,
    )
    # cli.py's PipelineConfig for the host phase's flags: the extractor
    # defaults, max_matches = num_interest_points, the default BA.
    cli_cfg = dataclasses.replace(bench, ba=BundleAdjustConfig())
    n = chip_smoke.HOST_VIEWS
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory(prefix="host_pins_") as tmp:
        seq = os.path.join(tmp, "seq")
        os.makedirs(seq)
        K, gt = chip_smoke.bench_sequence(seq, n)
        if "cli" in args.runs:
            out = os.path.join(tmp, "cli_out")
            argv = chip_smoke.host_cli_argv(seq, os.path.join(tmp, "cli_cache"), out)
            if args.package == "port":
                argv += ["--device", "cpu"]
            for label in ("cli_main_cold", "cli_main_resume"):
                t0 = time.perf_counter()
                assert cli.main(argv) == 0
                print(json.dumps({"run": label, "wall_s": time.perf_counter() - t0}), flush=True)
        for seed in args.seeds:
            if "cli" in args.runs:
                cfg = dataclasses.replace(cli_cfg, seed=seed)
                cache = os.path.join(tmp, f"cache_{seed}")
                for label in ("cli", "cli_resume"):
                    t0 = time.perf_counter()
                    eng = SfmEngine(seq, n, config=cfg, single_K=K, pair_window=3,
                                    local_ba_every=3, pair_cache_dir=cache)
                    emit(_row(eng, gt, run=label, seed=seed, wall_s=time.perf_counter() - t0))
            if "distance" in args.runs:
                t0 = time.perf_counter()
                eng = SfmEngine(seq, n, config=dataclasses.replace(bench, seed=seed), single_K=K,
                                chain_mode="host", assoc_mode="distance")
                emit(_row(eng, gt, run="distance", seed=seed, wall_s=time.perf_counter() - t0))
        if "recover" in args.runs:
            chip_smoke.flat_frame(seq, chip_smoke.HOST_FLAT_IMAGE)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = SfmEngine(seq, n, config=dataclasses.replace(bench, seed=seed), single_K=K,
                                on_pose_failure="recover", pair_window=3, checkpoint_every=3,
                                checkpoint_path=os.path.join(tmp, f"ckpt_{seed}.npz"))
                emit(_row(eng, gt, run="recover", seed=seed, wall_s=time.perf_counter() - t0))
    summary = {}
    for run in sorted({r["run"] for r in rows}):
        sel = [r for r in rows if r["run"] == run]
        summary[run] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)] for k in _KEYS}
    print(json.dumps({"seeds": args.seeds, f"{args.package}_cpu_range": summary}))


if __name__ == "__main__":
    main()
