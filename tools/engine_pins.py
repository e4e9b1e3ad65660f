"""Reference numbers for the engine phase of the port's chip smoke test.

Runs the JAX package's ``SfmEngine`` on the CPU on ``bench.py``'s 10-view
sequence (``chip_smoke.bench_sequence``: ``default_rng(7)``, 360x480, 600
points, f=520) at the bench's configuration (``bench.py::engine_config``:
the extractor and matcher settings, 5,967 RANSAC hypotheses, BA ftol 1e-3,
scale 1.0) for ``config.seed`` 0-4, and prints one JSON line per seed and a
summary: ATE over trajectory extent, mean reprojection error before and
after bundle adjustment (px), and the track count. ``chip_smoke.py`` pins
its engine tolerances beside these numbers.

    JAX_PLATFORMS=cpu python tools/engine_pins.py [--seeds 0 1 2 3 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench sequence and settings, no JAX)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sfmfromscratch_tpu.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )
    from sfmfromscratch_tpu.pipeline.incremental import SfmEngine

    rows = []
    with tempfile.TemporaryDirectory(prefix="engine_pins_") as seq:
        K, gt = chip_smoke.bench_sequence(seq)
        for seed in args.seeds:
            cfg = PipelineConfig(
                extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
                matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER),
                ransac=RansacConfig(), ba=BundleAdjustConfig(**chip_smoke.BENCH_BA),
                scale_factor=1.0, seed=seed,
            )
            eng = SfmEngine(seq, 10, config=cfg, single_K=K)
            ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt)
            e0, e1 = eng.errors_before_after_ba
            row = dict(seed=seed, cameras=len(eng.global_poses), ate_over_extent=ate / extent,
                       reproj_before_px=float(e0), reproj_after_px=float(e1),
                       tracks=int(eng.map.num_tracks))
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
               for k in ("cameras", "ate_over_extent", "reproj_before_px", "reproj_after_px",
                         "tracks")}
    print(json.dumps({"seeds": args.seeds, "jax_cpu_range": summary}))


if __name__ == "__main__":
    main()
