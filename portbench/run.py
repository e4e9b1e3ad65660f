"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from this file's first line to the window's
start): imports, the program's CUDA and C++ builds (built once per
checkout into the program's own ``_build/`` directory), the cell's pool of
scenes rendered from ``--seed`` (or from the cell's fixed ``scene_seed``)
by the generator the cell names (``scenes/<renderer>.py``; its views in
worker processes that end before the window, where it allows) and written
as JPEG files under ``TMPDIR``, and one warm-up job on a scene outside the
pool. The window: a closed loop of one client, jobs back to back through
the configuration's engine until ``--seconds`` have passed, every started
job run to its end. After the
window, with no clock running: the end-to-end metrics (or, with
``--trace 1``, the per-layer ones), the comparison with the plain reference
that decides ``correct`` (``check.py``), and one JSON line on standard
output. Exits non-zero, printing no result, without a CUDA card, without
the program, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "sfmfromscratch_tpu"}


def _cache_env() -> None:
    """Every kernel cache a library might keep, at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _fail(code: int, why: str) -> int:
    print(f"portbench: {why}", file=sys.stderr, flush=True)
    return code


def _card_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def measure(bench, name: str, seed: int, seconds: float, traced: bool, device, sync,
            card: str, t_start: float, tmp: str):
    """Set-up, window and readings of one run; returns (result dict,
    compared-number table). ``device`` and ``sync`` let the tests drive a
    run on the CPU."""
    import numpy as np
    import torch

    from portbench import check, jobs as J, trace as T
    from portbench.readings import Readings
    from portbench.scenes.pool import make_pool

    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    cell = bench.cell(name)
    t_pool = time.perf_counter()
    pool, warm = make_pool(cell, cfg, seed, tmp, bench.scenes)
    t_warm = time.perf_counter()
    J.run_job(0, -1, warm, cfg, seed ^ 0x5EED, device, sync)
    sync()
    print(f"portbench: set-up {t_pool - t_start:.3f} s to the pool, pool {t_warm - t_pool:.3f} s, "
          f"warm-up job {time.perf_counter() - t_warm:.3f} s", file=sys.stderr, flush=True)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
    records = J.window(pool, cfg, seed, seconds, device, sync, trace_after=prof)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = None
    if prof is not None:
        summary = T.summarize(prof, records[-1].end - records[-1].start)
        del prof
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(1 for r in records if r.failed)
    done = [r for r in records if not r.failed]
    judged = check.sample_jobs(len(records), cell["check_jobs"], seed)
    per_job = []
    for k in judged:
        r = records[k]
        if not r.failed:
            per_job.append(check.judge_job(r, pool[r.scene], cfg, device))
    reproj = [float(e.mean()) for e in map(check.reprojection_px, done) if len(e)]
    correct, table = check.verdict(per_job, cell["limits"], failed)

    e2e = J.end_to_end(records[:-1] if traced else records)
    values = {"frames_per_s": e2e["frames_per_s"],
              "reproj_px": float(np.mean(reproj)) if reproj else float("nan"),
              "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
    metrics = {}
    if not traced:
        for m in bench.metrics_for("end_to_end", name):
            # a quantity split by cell group (``reproj_px.global``) reads its base
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
    else:
        spans = records[:-1]        # the window: the jobs before the profiled one
        rd = Readings(jobs=spans, config=cfg, card=card, trace=summary, traced=records[-1])
        for m in bench.metrics_for("per_layer", name):
            v = bench.reader(m["name"])(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics}
    device_block = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": wl["chips"],
                    "memory_peak_bytes": int(peak)}
    if summary is not None:
        device_block.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = T.breakdown(summary, records[-1].stage_times)
    result["device"] = device_block
    result["window"] = {"seconds": e2e["window_s"], "jobs": len(records), "judged": len(per_job),
                        "job_s": [r.end - r.start for r in records],
                        "errors": [r.error for r in records if r.error][:2]}
    return result, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_env()
    sys.path.insert(0, ROOT)
    try:
        import torch
    except ImportError as e:
        return _fail(2, f"PyTorch is not installed ({e})")
    try:
        from portbench.spec import Bench

        bench = Bench(ROOT)
        chips = bench.workload(args.workload)["chips"]
        import sfmfromscratch_tpu_torch  # noqa: F401  (the program under test)
        from sfmfromscratch_tpu_torch.native import build as native_build
        from sfmfromscratch_tpu_torch.ops.cuda import build as cuda_build
    except (ImportError, OSError, KeyError, ValueError) as e:
        return _fail(3, f"the benchmark or the program is missing from this checkout ({e!r})")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(2, f"the cell needs {chips} CUDA card(s); "
                        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")

    device = torch.device("cuda", 0)
    t_build = time.perf_counter()
    cuda_build.build_all()
    native_build.build_all()
    print(f"portbench: imports {t_build - T_START:.3f} s, builds {time.perf_counter() - t_build:.3f} s",
          file=sys.stderr, flush=True)
    card = torch.cuda.get_device_name(0)
    limit = _card_limit()
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        result, table = measure(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                                device, lambda: torch.cuda.synchronize(device), card,
                                T_START, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        return _fail(4, f"JAX or the JAX package was loaded in this process: {found}")
    result["device"]["power_limit"] = limit
    result["checks"] = table
    for k, v in table.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
