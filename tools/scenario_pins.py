"""Reference numbers for the scenarios phase of the port's chip smoke test.

Runs every scenario of ``chip_smoke.SCENARIOS`` (the JAX package's scenario
tests at their own scenes and configurations, ``chip_smoke.scenario_run``,
and the bench sequence with per-image K from EXIF) for ``config.seed`` 0-4
through the JAX package on the CPU, or with ``--package port`` through the
PyTorch port (``--device cpu`` by default, ``cuda`` for the card). Prints one
JSON line per run with its numbers and the gates it fails, then one line per
scenario with each gated quantity's range over the seeds beside its gate
(``chip_smoke.SCENARIO_GATES``, the JAX tests' own assertions). The
20-degree pair runs no RANSAC, so its seeds give one result.

About 25 min for the JAX package on 8 CPU cores (the bench EXIF run ~1 min
a seed); the port on the CPU takes about as long.

    JAX_PLATFORMS=cpu python tools/scenario_pins.py [--seeds 0 1 2 3 4]
        [--scenarios exif_bench featureless ...] [--package jax|port] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the scenarios, their gates and the scenes; no JAX)


def jax_scenario_api():
    """The JAX package's names that the scenarios call, under the keys of
    ``chip_smoke.port_scenario_api``."""
    import types

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from sfmfromscratch_tpu import config
    from sfmfromscratch_tpu.geometry.camera import SensorType, intrinsics_from_exif
    from sfmfromscratch_tpu.geometry.epipolar import (
        eight_point_fundamental,
        epipolar_distances,
        symmetric_epipolar_distances,
    )
    from sfmfromscratch_tpu.geometry.ransac import ransac_fundamental
    from sfmfromscratch_tpu.pipeline.frontend import FeatureRunner, matches_to_coords
    from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu.pipeline.incremental import SfmEngine

    def asarray(a):
        return jnp.asarray(np.asarray(a, np.float32))

    def ransac_f(seed, p1, p2, **kw):
        res = ransac_fundamental(jax.random.key(seed), asarray(p1), asarray(p2), **kw)
        return res.F, res.inliers

    return types.SimpleNamespace(
        config=config, SensorType=SensorType, intrinsics_from_exif=intrinsics_from_exif,
        SfmEngine=SfmEngine, GlobalSfmEngine=GlobalSfmEngine,
        global_engine_class=GlobalSfmEngine, feature_runner=FeatureRunner.run,
        matches_to_coords=matches_to_coords, eight_point_fundamental=eight_point_fundamental,
        epipolar_distances=epipolar_distances,
        symmetric_epipolar_distances=symmetric_epipolar_distances, ransac_fundamental=ransac_f,
        asarray=asarray, host=np.asarray)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--scenarios", nargs="+", default=list(chip_smoke.SCENARIOS),
                    choices=chip_smoke.SCENARIOS)
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    args = ap.parse_args()
    if args.package == "jax":
        if args.device != "cpu":
            ap.error("--device applies to --package port")
        api = jax_scenario_api()
    else:
        import torch

        api = chip_smoke.port_scenario_api(torch.device(args.device))

    for name in args.scenarios:
        rows = []
        for seed in args.seeds:
            with tempfile.TemporaryDirectory(prefix=f"scenario_pins_{name}_") as work:
                row = chip_smoke.scenario_run(name, api, work, seed=seed)
            row.update(scenario=name, package=args.package, seed=seed,
                       failed=chip_smoke.scenario_failures(name, row))
            rows.append(row)
            print(json.dumps(row), flush=True)
        ranges = {}
        for key, op, limit in chip_smoke.SCENARIO_GATES[name]:
            vals = [r[key] for r in rows]
            ranges[key] = dict(min=min(vals), max=max(vals), gate=[op, limit])
        print(json.dumps({"scenario": name, "package": args.package, "device": args.device,
                          "seeds": args.seeds, "ranges": ranges,
                          "failed_seeds": [r["seed"] for r in rows if r["failed"]]}), flush=True)


if __name__ == "__main__":
    main()
