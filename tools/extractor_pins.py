"""Reference numbers for the extractors phase of the port's chip smoke test.

Runs the JAX package on the CPU for ``config.seed`` 0-4 in the four engine
runs of the extractors phase, at the bench configuration
(``chip_smoke.engine_config``'s settings):

* dog: ``SfmEngine(feature_extractor=make_dog_extractor(cfg.extractor))`` on
  the 10-view bench sequence (``chip_smoke.bench_sequence``);
* hybrid: ``SfmEngine(feature_extractor=make_hybrid_extractor(k=HYBRID_K))``
  (the TinyPoint checkpoint) on the bench sequence;
* fixed: ``SfmEngine`` with ``RansacConfig(**FIXED_RANSAC)`` (fixed-count
  RANSAC, ``pnp_solver="dlt"``: P3P at 5,967 hypotheses) on the bench
  sequence;
* global_fixed: ``GlobalSfmEngine`` (class defaults) with the same RANSAC
  settings on the global phase's 4 deg/view orbit cut to
  ``GLOBAL_FIXED_VIEWS`` views.

Prints one JSON line per run and a summary of each quantity's range.
``chip_smoke.py`` pins its extractors tolerances beside these numbers, over
seeds 0-29 for dog and hybrid and 0-14 for fixed and global_fixed (``--seeds``): seeds 0-4
miss the tail of the adaptive bootstrap on the bench's short first baseline
(``tools/bootstrap_spread.py``). With
``--package port`` the same runs go through the PyTorch port on the CPU (its
own RANSAC draws), so the two packages' spreads can be set side by side.

    JAX_PLATFORMS=cpu python tools/extractor_pins.py [--seeds 0 1 2 3 4]
        [--runs dog hybrid fixed global_fixed] [--package jax|port]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
    ap.add_argument("--runs", nargs="+", default=["dog", "hybrid", "fixed", "global_fixed"])
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    args = ap.parse_args()

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfmfromscratch_tpu.config import (
            BundleAdjustConfig,
            ExtractorConfig,
            MatcherConfig,
            PipelineConfig,
            RansacConfig,
        )
        from sfmfromscratch_tpu.ops.superpoint import make_hybrid_extractor
        from sfmfromscratch_tpu.pipeline.frontend import make_dog_extractor
        from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine
        from sfmfromscratch_tpu.pipeline.incremental import SfmEngine
    else:
        from sfmfromscratch_tpu_torch.config import (
            BundleAdjustConfig,
            ExtractorConfig,
            MatcherConfig,
            PipelineConfig,
            RansacConfig,
        )
        from sfmfromscratch_tpu_torch.ops.superpoint import make_hybrid_extractor
        from sfmfromscratch_tpu_torch.pipeline.frontend import make_dog_extractor
        from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        SfmEngine = functools.partial(SfmEngine, device="cpu")
        GlobalSfmEngine = functools.partial(GlobalSfmEngine, device="cpu")

    bench = PipelineConfig(
        extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
        matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER), ransac=RansacConfig(),
        ba=BundleAdjustConfig(**chip_smoke.BENCH_BA), scale_factor=1.0,
    )
    fixed = dataclasses.replace(bench, ransac=RansacConfig(**chip_smoke.FIXED_RANSAC))
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory(prefix="extractor_pins_") as tmp:
        seq = os.path.join(tmp, "bench")
        os.makedirs(seq)
        n = chip_smoke.EXTRACTOR_VIEWS
        K, gt = chip_smoke.bench_sequence(seq, n)
        extractors = {"dog": lambda: make_dog_extractor(bench.extractor),
                      "hybrid": lambda: make_hybrid_extractor(k=chip_smoke.HYBRID_K)}
        for label in ("dog", "hybrid", "fixed"):
            if label not in args.runs:
                continue
            for seed in args.seeds:
                cfg = dataclasses.replace(fixed if label == "fixed" else bench, seed=seed)
                ext = extractors[label]() if label in extractors else None
                t0 = time.perf_counter()
                eng = SfmEngine(seq, n, config=cfg, single_K=K, feature_extractor=ext)
                emit(_row(eng, gt, 2, run=label, seed=seed, wall_s=time.perf_counter() - t0,
                          pnp_hypotheses=int(eng._pnp_hyp)))
        if "global_fixed" in args.runs:
            orbit = os.path.join(tmp, "orbit")
            os.makedirs(orbit)
            n = chip_smoke.GLOBAL_FIXED_VIEWS
            K, gt = chip_smoke.orbit_sequence(orbit, n, 4.0)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = GlobalSfmEngine(orbit, n, config=dataclasses.replace(fixed, seed=seed),
                                      single_K=K)
                emit(_row(eng, gt, 1, run="global_fixed", seed=seed,
                          wall_s=time.perf_counter() - t0, edges=len(eng._edges)))
    summary = {}
    for run in sorted({r["run"] for r in rows}):
        sel = [r for r in rows if r["run"] == run]
        summary[run] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)] for k in _KEYS}
    print(json.dumps({"seeds": args.seeds, f"{args.package}_cpu_range": summary}))


if __name__ == "__main__":
    main()
