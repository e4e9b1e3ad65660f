"""Where the time of one ``SfmEngine`` run goes on a CUDA card.

Builds the port's kernels, warms the engine on ``bench.py``'s 10-view
sequence at its configuration (``chip_smoke.bench_sequence`` and
``chip_smoke.engine_config``), then

1. times ``--runs`` warm runs with a host clock (the engine ends in host
   fetches) and keeps each run's ``stage_times`` (each stage ends at a
   device synchronize);
2. traces one warm run with ``torch.profiler`` (CPU and CUDA activities):
   the ops with the most device time, the device's busy time (the union of
   its kernel intervals) and its idle share of the run's wall time.

Prints one JSON line per part and, with ``--out``, writes them all to that
file.

    python3 tools/profile_engine.py [--runs 3] [--out profile_engine.json]
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
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the parts to this JSON file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device available", file=sys.stderr)
        return 2
    from sfmfromscratch_tpu_torch.ops.cuda.build import build_all
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    dev = torch.device("cuda")
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = chip_smoke.engine_config()
    results = [{"card": smi, "torch": torch.__version__}]
    with tempfile.TemporaryDirectory(prefix="profile_engine_") as seq:
        K, _ = chip_smoke.bench_sequence(seq)

        def run():
            return SfmEngine(seq, 10, config=cfg, single_K=K, device=dev)

        run()
        walls, stages = [], []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            eng = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stages.append(eng.stage_times)
        results.append({"part": "engine_warm_s", "runs": walls,
                        "median": sorted(walls)[len(walls) // 2],
                        "frames_per_s_median": 10 / sorted(walls)[len(walls) // 2]})
        results.append({"part": "stage_times_s", "runs": stages})

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng = run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if getattr(e.device_type, "name", "") == "CUDA" and e.name != "Buffer Flush"]
    busy = _busy_us(kernels)
    top = []
    for ka in prof.key_averages():
        if ka.key == "Buffer Flush":   # the tracer's own activity, not the program's
            continue
        dev_us = getattr(ka, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ka, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            top.append((dev_us, ka.key, ka.count))
    top.sort(reverse=True)
    results.append({"part": "trace", "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                    "device_idle_share": (1.0 - busy / wall_us) if wall_us else None,
                    "kernel_launches": len(kernels), "traced_stage_times_s": eng.stage_times,
                    "top_self_device_ms": [[k, c, us / 1e3] for us, k, c in top[:20]]})
    for r in results:
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
