"""Reference numbers for the mesh phase of the port's chip smoke test.

Runs the JAX package's engines on its 8-device virtual CPU mesh (the
``--xla_force_host_platform_device_count=8`` stand-in of its own tests) for
``config.seed`` 0-4, at the bench configuration (``chip_smoke.engine_config``'s
settings):

* engine: ``SfmEngine(mesh=make_mesh(8, model_parallel=1))`` on the 10-view
  bench sequence (``chip_smoke.bench_sequence``): features sharded by image,
  every BA by observation;
* global_stream: ``GlobalSfmEngine(mesh=make_mesh(8), **chip_smoke.MESH_STREAM)``
  (class defaults otherwise) on the global phase's 4 deg/view orbit cut to
  ``chip_smoke.MESH_GLOBAL_VIEWS`` views: relative poses sharded by pair,
  the streaming BA's window solves by observation.

Prints one JSON line per run and a summary of each quantity's range.
``chip_smoke.py`` pins the mesh phase's global gates beside these numbers
(its engine run keeps the engine phase's pins). The JAX tests that run these
engines on the mesh are ``slow``-marked, so no tier-1 run gives this spread.

    python tools/mesh_pins.py [--seeds 0 1 2 3 4] [--runs engine global_stream]
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
    ap.add_argument("--runs", nargs="+", default=["engine", "global_stream"])
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sfmfromscratch_tpu.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )
    from sfmfromscratch_tpu.parallel.mesh import make_mesh
    from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu.pipeline.incremental import SfmEngine

    if len(jax.devices()) != 8:
        raise SystemExit(f"needs 8 virtual CPU devices, jax sees {len(jax.devices())}")

    def config(seed):
        return PipelineConfig(
            extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
            matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER),
            ransac=RansacConfig(), ba=BundleAdjustConfig(**chip_smoke.BENCH_BA),
            scale_factor=1.0, seed=seed)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory(prefix="mesh_pins_") as tmp:
        if "engine" in args.runs:
            seq = os.path.join(tmp, "bench")
            os.makedirs(seq)
            K, gt = chip_smoke.bench_sequence(seq)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = SfmEngine(seq, 10, config=config(seed), single_K=K,
                                mesh=make_mesh(8, model_parallel=1))
                emit(_row(eng, gt, 2, run="engine", seed=seed,
                          wall_s_cpu=time.perf_counter() - t0))
        if "global_stream" in args.runs:
            orbit = os.path.join(tmp, "orbit")
            os.makedirs(orbit)
            n = chip_smoke.MESH_GLOBAL_VIEWS
            K, gt = chip_smoke.orbit_sequence(orbit, n, 4.0)
            for seed in args.seeds:
                t0 = time.perf_counter()
                eng = GlobalSfmEngine(orbit, n, config=config(seed), single_K=K,
                                      mesh=make_mesh(8), **chip_smoke.MESH_STREAM)
                st = eng.stream_stats
                emit(_row(eng, gt, 1, run="global_stream", seed=seed,
                          wall_s_cpu=time.perf_counter() - t0, windows=st.windows_run,
                          resident=st.peak_resident_obs / max(st.total_obs, 1)))
    summary = {run: {k: [min(r[k] for r in rows if r["run"] == run),
                         max(r[k] for r in rows if r["run"] == run)] for k in _KEYS}
               for run in args.runs}
    print(json.dumps({"seeds": args.seeds, "jax_cpu_mesh8_range": summary}))


if __name__ == "__main__":
    main()
