"""Where the time of one engine run goes on a CUDA card.

Builds the port's kernels, warms the engine at the bench configuration
(``chip_smoke.engine_config``) on its scene, then

1. times ``--runs`` warm runs with a host clock (the engine ends in host
   fetches) and keeps each run's ``stage_times`` (each stage ends at a
   device synchronize);
2. samples ``nvidia-smi``'s utilization every 100 ms during those runs;
3. traces one warm run with ``torch.profiler`` (CUDA activity): the kernels
   with the most device time, the device's busy time (the union of its
   kernel intervals) and its idle share of the run's wall time.

The engine is ``SfmEngine`` on ``bench.py``'s 10-view sequence
(``chip_smoke.bench_sequence``); with ``--engine host`` the same run with the
host chain (``chain_mode="host"``: one synchronising fetch per frame) in
place of the scan chain; with ``--engine global`` ``GlobalSfmEngine`` on the
20-view 4 deg/view orbit of ``chip_smoke.py``'s global phase; with
``--engine scale`` the scale phase's keyframes run (the 47-view 1.5 deg/view
orbit, auto keyframes at ``chip_smoke.SCALE_FLOW_PX``, window 2, the CLI's
default BA) with no pair cache; with ``--engine ladder --rung L4`` a rung of
``chip_smoke.py``'s ladder phase (``chip_smoke.LADDER_RUNGS``) at the
ladder's configuration and scene. Prints one JSON line per part as it is
measured and, with ``--out``, appends it to that file (JSON lines).

    python3 tools/profile_engine.py [--engine host|global|scale|ladder] [--rung L4] [--runs 3]
        [--out profile_engine.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the bench sequence and configuration)
from tools.profile_two_view import _busy_us  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("incremental", "host", "global", "scale", "ladder"),
                    default="incremental")
    ap.add_argument("--rung", choices=tuple(chip_smoke.LADDER_RUNGS), default="L4",
                    help="the ladder rung of --engine ladder")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the parts to this JSON file")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device available", file=sys.stderr)
        return 2
    from sfmfromscratch_tpu_torch.ops.cuda.build import build_all
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    dev = torch.device("cuda")
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = chip_smoke.engine_config()
    kw = {"chain_mode": "host"} if args.engine == "host" else {}
    with tempfile.TemporaryDirectory(prefix="profile_engine_") as seq:
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

        def run():
            return engine(seq, n, config=cfg, single_K=K, device=dev, **kw)

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
              "rung": args.rung if args.engine == "ladder" else None})
        run()
        # nvidia-smi's utilization sampler (share of each 100 ms sample in
        # which a kernel ran) over the timed runs: a second, coarse reading of
        # the device's busy share, free of the tracer's overhead.
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        walls, stages = [], []
        try:
            for _ in range(args.runs):
                t0 = time.perf_counter()
                eng = run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                stages.append(eng.stage_times)
        finally:
            sampler.terminate()
            samples = [[float(x) for x in line.split(",")]
                       for line in sampler.communicate()[0].splitlines() if line.strip()]
        emit({"part": "engine_warm_s", "runs": walls, "median": sorted(walls)[len(walls) // 2],
              "frames_per_s_median": n / sorted(walls)[len(walls) // 2]})
        emit({"part": "stage_times_s", "runs": stages,
              "filter_hyps_used_last_run": (None if eng.filter_hyps_used is None
                                            else [int(h) for h in eng.filter_hyps_used])})
        emit({"part": "nvidia_smi_samples", "count": len(samples),
              "utilization_gpu_mean": (sum(r[0] for r in samples) / len(samples)
                                       if samples else None),
              "sm_clock_mhz_mean": sum(r[1] for r in samples) / len(samples) if samples else None,
              "power_draw_w_mean": sum(r[2] for r in samples) / len(samples) if samples else None})

        # One traced run, device activity only. The kernel intervals come
        # from the raw kineto events (a global run launches about a million
        # kernels, too many for the profiler's Python event tree); the
        # tracer's own "Buffer Flush" and "Activity Buffer Request" entries
        # are not program work and are left out.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng = run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name in ("Buffer Flush", "Activity Buffer Request"):
            continue
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        kernels.append((start, start + dur))
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + dur, cnt + 1)
    busy = _busy_us(kernels)
    top = sorted(((us, name, cnt) for name, (us, cnt) in by_name.items()), reverse=True)
    emit({"part": "trace", "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": (1.0 - busy / wall_us) if wall_us else None,
          "kernel_launches": len(kernels), "traced_stage_times_s": eng.stage_times,
          "top_device_kernels_ms": [[k[:120], c, us / 1e3] for us, k, c in top[:15]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
