"""Where the time of one two-view reconstruction goes on a CUDA card.

Builds the port's kernels, warms ``reconstruct_two_view`` on the bench pair
at the bench settings (``chip_smoke.bench_pair`` and ``BENCH_*``), then

1. times ``--runs`` warm runs with a host clock ended by a synchronize;
2. times the slice's stages one by one, each ended by a synchronize;
3. traces one warm run with ``torch.profiler`` (CPU and CUDA activities):
   the ops with the most device time, the device's busy time (the union of
   its kernel intervals) and its idle share of the run's wall time.

Prints one JSON line per part and, with ``--out``, writes them all to that
file.

    python3 tools/profile_two_view.py [--runs 5] [--out profile_two_view.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the bench pair and settings)


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the parts to this JSON file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_two_view: no CUDA device available", file=sys.stderr)
        return 2
    from sfmfromscratch_tpu_torch.config import ExtractorConfig, MatcherConfig, RansacConfig
    from sfmfromscratch_tpu_torch.geometry.camera import (
        projection_matrix, two_view_reprojection_error)
    from sfmfromscratch_tpu_torch.geometry.ransac import ransac_essential_pose
    from sfmfromscratch_tpu_torch.geometry.triangulation import refine_points_gn, triangulate_dlt
    from sfmfromscratch_tpu_torch.ops.cuda.build import build_all
    from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner, matches_to_coords
    from sfmfromscratch_tpu_torch.pipeline.two_view import reconstruct_two_view
    from sfmfromscratch_tpu_torch.utils.precision import f32_precision

    dev = torch.device("cuda")
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    im1, im2, K, _, _ = chip_smoke.bench_pair()
    ecfg = ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR)
    mcfg = MatcherConfig(**chip_smoke.BENCH_MATCHER)
    rcfg = RansacConfig()

    def run():
        out = reconstruct_two_view(im1, im2, K, extractor=ecfg, matcher=mcfg, ransac=rcfg,
                                   scale_factor=1.0, seed=chip_smoke.BENCH_SEED, device=dev)
        torch.cuda.synchronize()
        return out

    results = [{"card": smi, "torch": torch.__version__}]
    for _ in range(2):
        run()
    walls = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    results.append({"part": "two_view_warm_ms", "runs": walls,
                    "median": sorted(walls)[len(walls) // 2]})

    # Stages of reconstruct_two_view, as pipeline/two_view.py runs them.
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    stages = {}
    fr, stages["feature_runner"] = timed(lambda: FeatureRunner.run(
        im1, im2, ecfg, mcfg, scale_factor=1.0, device=dev))
    (p1, p2, mask), stages["matches_to_coords"] = timed(lambda: matches_to_coords(
        fr.matches, fr.features1, fr.features2, mcfg.max_matches))
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.BENCH_SEED)
    with f32_precision():
        pose, stages["ransac_essential_pose"] = timed(lambda: ransac_essential_pose(
            gen, p1, p2, Kt, Kt, mask, num_hypotheses=rcfg.num_iterations(),
            threshold=rcfg.epipolar_threshold, min_cheirality_frac=0.75))
        P1 = projection_matrix(torch.eye(3, device=dev), torch.zeros(3, device=dev), Kt)
        P2 = projection_matrix(pose.R, pose.t, Kt)
        X, stages["triangulate_dlt"] = timed(lambda: triangulate_dlt(p1, p2, P1, P2))
        X, stages["refine_points_gn"] = timed(lambda: refine_points_gn(
            X, p1, p2, P1, P2, mask=pose.inliers, num_iters=8))
        _, stages["reprojection_error"] = timed(lambda: two_view_reprojection_error(
            X, p1, p2, P1, P2, mask=pose.inliers))
    results.append({"part": "stages_ms", **stages})

    # One traced warm run.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
                    "kernel_launches": len(kernels),
                    "top_self_device_ms": [[k, c, us / 1e3] for us, k, c in top[:15]]})
    for r in results:
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
