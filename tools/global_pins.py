"""Reference numbers for the global and orbit phases of the port's chip smoke
test.

Runs the JAX package on the CPU for ``config.seed`` 0-4 on the two scenes of
``chip_smoke.py``:

* global: ``GlobalSfmEngine`` (class defaults: window 3, 1,024 relative-pose
  hypotheses, 2 BA rounds, Huber 3.0) on ``chip_smoke.orbit_sequence(...,
  GLOBAL_VIEWS, 4.0)`` at the bench widths (``BENCH_EXTRACTOR``,
  ``BENCH_MATCHER``, 5,967 hypotheses, BA ftol 1e-3, scale 1.0);
* orbit: ``SfmEngine`` plain and with ``chain_refresh="averaging"`` on
  ``chip_smoke.orbit_sequence(..., ORBIT_VIEWS, 0.8)`` at the settings of
  ``tests/test_pipeline.py::test_chain_refresh_de_bends_orbit``.

Prints one JSON line per run and a summary of each quantity's range:
cameras, ATE over trajectory extent, mean reprojection error before and after
bundle adjustment (px), tracks and tracks of 3 or more views.
``chip_smoke.py`` pins its global and orbit tolerances beside these numbers.

    JAX_PLATFORMS=cpu python tools/global_pins.py [--seeds 0 1 2 3 4] [--scenes global orbit]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the scenes and settings, no JAX)


def _row(eng, gt, first_image):
    import numpy as np

    ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt, first_image)
    e0, e1 = eng.errors_before_after_ba
    _, tracks, _ = eng.map.observations()
    counts = np.bincount(tracks, minlength=eng.map.num_tracks)
    return dict(cameras=len(eng.global_poses), ate_over_extent=ate / extent,
                reproj_before_px=float(e0), reproj_after_px=float(e1),
                tracks=int(eng.map.num_tracks), tracks_3plus=int((counts >= 3).sum()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--scenes", nargs="+", default=["global", "orbit"])
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
    from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu.pipeline.incremental import SfmEngine

    rows = {}
    if "global" in args.scenes:
        n = chip_smoke.GLOBAL_VIEWS
        with tempfile.TemporaryDirectory(prefix="global_pins_") as seq:
            K, gt = chip_smoke.orbit_sequence(seq, n, 4.0)
            for seed in args.seeds:
                cfg = PipelineConfig(
                    extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
                    matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER),
                    ransac=RansacConfig(), ba=BundleAdjustConfig(**chip_smoke.BENCH_BA),
                    scale_factor=1.0, seed=seed,
                )
                t0 = time.perf_counter()
                eng = GlobalSfmEngine(seq, n, config=cfg, single_K=K)
                row = dict(scene="global", seed=seed, cpu_s=time.perf_counter() - t0,
                           **_row(eng, gt, 1))
                rows.setdefault("global", []).append(row)
                print(json.dumps(row), flush=True)
    if "orbit" in args.scenes:
        n = chip_smoke.ORBIT_VIEWS
        with tempfile.TemporaryDirectory(prefix="orbit_pins_") as seq:
            K, gt = chip_smoke.orbit_sequence(seq, n, 0.8)
            for seed in args.seeds:
                cfg = PipelineConfig(
                    extractor=ExtractorConfig(**chip_smoke.ORBIT_EXTRACTOR),
                    matcher=MatcherConfig(**chip_smoke.ORBIT_MATCHER),
                    ransac=RansacConfig(), ba=BundleAdjustConfig(), scale_factor=1.0, seed=seed,
                )
                for label, kw in (("orbit_plain", {}), ("orbit_refresh",
                                                        {"chain_refresh": "averaging"})):
                    eng = SfmEngine(seq, n, config=cfg, single_K=K, **kw)
                    row = dict(scene=label, seed=seed, **_row(eng, gt, 2))
                    rows.setdefault(label, []).append(row)
                    print(json.dumps(row), flush=True)
    keys = ("cameras", "ate_over_extent", "reproj_before_px", "reproj_after_px", "tracks",
            "tracks_3plus")
    for scene, rs in rows.items():
        summary = {k: [min(r[k] for r in rs), max(r[k] for r in rs)] for k in keys}
        print(json.dumps({"scene": scene, "seeds": args.seeds, "jax_cpu_range": summary}))


if __name__ == "__main__":
    main()
