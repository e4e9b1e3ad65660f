"""Reference numbers for the port's two-view chip smoke test.

Runs the JAX package's ``reconstruct_two_view`` on the CPU on views 1 and 2
of the bench scene (``chip_smoke.bench_pair``: ``bench.py::build_sequence``,
``default_rng(7)``, 10 views at 360x480, 600 points, f=520) at the bench's
extractor, matcher and RANSAC settings, for RANSAC seeds 0-8, and prints one
JSON line per seed and a summary: rotation and translation-direction errors
against ground truth (degrees), inlier count and mean reprojection error
(px). ``chip_smoke.py`` pins its tolerances beside these numbers.

    JAX_PLATFORMS=cpu python tools/two_view_pins.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench pair and settings, no JAX)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sfmfromscratch_tpu.config import ExtractorConfig, MatcherConfig, RansacConfig
    from sfmfromscratch_tpu.pipeline.two_view import reconstruct_two_view

    im1, im2, K, R_gt, t_gt = chip_smoke.bench_pair()
    rows = []
    for seed in range(9):
        r = reconstruct_two_view(
            im1, im2, K, extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
            matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER),
            ransac=RansacConfig(), scale_factor=1.0, seed=seed,
        )
        rot, tdir = chip_smoke.pose_errors(r.R, r.t, R_gt, t_gt)
        row = dict(seed=seed, rot_err_deg=rot, t_err_deg=tdir,
                   num_inliers=int(r.num_inliers), reproj_px=float(r.mean_reproj_error))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
               for k in ("rot_err_deg", "t_err_deg", "num_inliers", "reproj_px")}
    print(json.dumps({"jax_cpu_range_over_seeds_0_8": summary}))


if __name__ == "__main__":
    main()
