"""Reference numbers for the ladder phase of the port's chip smoke test.

Runs the rungs of ``chip_smoke.LADDER_RUNGS`` (the JAX package's scale
ladder, ``benchmarks/ladder.py``, at its own configurations and scenes;
``chip_smoke.ladder_scene`` and ``chip_smoke.ladder_run``) over
``config.seed`` through the JAX package on the CPU, or with ``--package
port`` through the PyTorch port: on the CPU, or with ``--device cuda`` on
the card, where the RANSAC draws come from the card's generator, so that
each seed is a draw of its own (the port's card spread); each card run's
final BA problem is then solved again on the CPU (``final_ba_on_cpu``),
which tells the card's BA apart from the problem it was given. Each scene is
rendered once and every seed runs on it. Prints one JSON line per run (its
numbers, the pins it fails, its seconds), then one line per rung with each
pinned quantity's range over the seeds and the pins that the house rule
gives from them: incremental rungs 1.6x the worst ATE over extent and
post-BA error and two thirds of the fewest tracks, global rungs 5x, 1.25x
and 85%.

On two CPU cores a JAX run takes 13-30 s (``L3``), 26-40 s (``L4``,
``L4r``), 32-63 s (``L2h``), 109-159 s (``L3h``), 28-57 s (``L3g``) and
222-269 s (``L5``, after a ~200 s render); the port on the CPU about as
long. Several processes may run at once, one set of rungs each.

    JAX_PLATFORMS=cpu python tools/ladder_pins.py [--rungs L3 L4 ...]
        [--seeds 0 1 2] [--package jax|port] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the rungs, their scenes and pins; no JAX)

# (ATE and error factor, tracks share) of the house rule, by engine.
MARGINS = {"SfmEngine": (1.6, 1.6, 2.0 / 3.0), "GlobalSfmEngine": (5.0, 1.25, 0.85)}


def jax_ladder_api():
    """The JAX package's names that the rungs call, under the keys of
    ``chip_smoke.port_ladder_api``. The JAX engines keep no BA problem, so
    ``final_ba`` reads the last ``bundle_adjust`` call of the engines'
    module, which this wraps to record it."""
    import types

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from sfmfromscratch_tpu import config
    from sfmfromscratch_tpu.ba import lm
    from sfmfromscratch_tpu.pipeline import incremental
    from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine

    last = {}
    solve = incremental.bundle_adjust

    def recording_bundle_adjust(problem, **kw):
        res = solve(problem, **kw)
        dense = lm.resolve_dense(kw.get("use_dense"), problem.num_cameras, problem.num_points)
        last.update(backend="dense" if dense else "pcg",
                    iterations=int(np.asarray(res.iterations_used)),
                    padded=[problem.num_cameras, problem.num_points, problem.num_obs])
        return res

    incremental.bundle_adjust = recording_bundle_adjust
    return types.SimpleNamespace(
        config=config, SfmEngine=incremental.SfmEngine, GlobalSfmEngine=GlobalSfmEngine,
        final_ba=lambda eng: dict(last), sync=lambda: None, peak_reset=lambda: None,
        peak_bytes=lambda: None)


def final_ba_on_cpu(eng):
    """The card's final BA problem of ``eng`` solved again on the CPU at the
    engine's settings: in float32 (``chip_smoke._resolve_ba_on_cpu``, with
    the costs after each of the first 6 iterations on the card and on the
    CPU) and in float64."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem

    b = eng.config.ba
    prefix, res32, s32 = chip_smoke._resolve_ba_on_cpu(eng, b)
    prob64 = chip_smoke._float64_problem(
        BAProblem(*(None if v is None else v.cpu() for v in eng.ba_problem)))
    res64 = bundle_adjust(prob64, max_iters=b.max_lm_iters, **chip_smoke._engine_ba_kw(b))
    return dict(card_px=float(eng.errors_before_after_ba[1]),
                card_iterations=int(eng.ba_result.iterations_used),
                cpu32_px=float(res32.final_mean_error), cpu32_iterations=res32.iterations_used,
                cpu32_s=s32, cpu64_px=float(res64.final_mean_error),
                cpu64_iterations=res64.iterations_used, first_costs_card_cpu32=prefix)


def pins(engine, rows):
    """The house rule's pins from ``rows``' spread."""
    ate_f, err_f, share = MARGINS[engine]
    return dict(ate_over_extent=ate_f * max(r["ate_over_extent"] for r in rows),
                reproj_px=err_f * max(r["reproj_after_px"] for r in rows),
                min_tracks=int(math.floor(share * min(r["tracks"] for r in rows))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rungs", nargs="+", default=list(chip_smoke.LADDER_DEFAULT),
                    choices=list(chip_smoke.LADDER_RUNGS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu",
                    help="the port's device")
    args = ap.parse_args()
    if args.package == "jax":
        if args.device != "cpu":
            ap.error("the JAX package's rungs run on the CPU")
        api = jax_ladder_api()
    else:
        import torch

        api = chip_smoke.port_ladder_api(torch.device(args.device))

    for name in args.rungs:
        rows = []
        with tempfile.TemporaryDirectory(prefix=f"ladder_pins_{name}_") as work:
            scene = chip_smoke.ladder_scene(name, work)
            for seed in args.seeds:
                t0 = time.perf_counter()
                keep = {} if args.device == "cuda" else None
                row = chip_smoke.ladder_run(name, api, scene, seed=seed, keep=keep)
                if keep:
                    row["final_ba_on_cpu"] = final_ba_on_cpu(keep.pop("engine"))
                row.update(package=args.package, device=args.device,
                           seconds=time.perf_counter() - t0,
                           failed=chip_smoke.ladder_failures(name, row))
                rows.append(row)
                print(json.dumps(row), flush=True)
        keys = ("ate_over_extent", "reproj_after_px", "tracks", "tracks_3plus", "wall_s")
        print(json.dumps({
            "rung": name, "package": args.package, "device": args.device, "seeds": args.seeds,
            "render_s": scene["render_s"],
            "cameras": sorted({r["cameras"] for r in rows}),
            "ranges": {k: [min(r[k] for r in rows), max(r[k] for r in rows)] for k in keys},
            "backends": sorted({r["final_ba"]["backend"] for r in rows}),
            "pins": pins(rows[0]["engine"], rows)}), flush=True)


if __name__ == "__main__":
    main()
