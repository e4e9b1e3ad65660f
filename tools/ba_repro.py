"""Is the port's bundle adjustment reproducible on the card?

Builds the kernels, renders ``chip_smoke.py``'s 10-view bench sequence and
runs ``SfmEngine`` on it at the bench configuration ``--runs`` times, then
solves the last run's final BA problem ``--runs`` more times on the card
and once on the CPU. It does this twice: with ``ba/schur.py::segment_sum`` as
it is (sorted, fixed-order adds on the card) and with the atomic
``index_add_`` it replaced. Prints the card's name and power limit, then one
JSON line per variant: each run's final mean reprojection error, LM
iterations and BA seconds, and the CPU's.

    python3 tools/ba_repro.py [--runs 4]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _atomic_segment_sum(x, idx, num_segments):
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add_(0, idx, x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ba_repro: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sfmfromscratch_tpu_torch.ba import schur
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem
    from sfmfromscratch_tpu_torch.ops.cuda.build import build_all
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    print(cs._nvidia_smi(), flush=True)
    build_all()
    dev = torch.device("cuda")
    cfg = cs.engine_config()
    b = cfg.ba
    kw = dict(cg_iters=60, init_damping=b.init_damping, damping_up=b.damping_up,
              damping_down=b.damping_down, ftol=b.ftol, huber_delta=b.huber_delta)
    # segment_sum is imported by name in several modules: swap its code, so
    # every caller takes the variant under test.
    sorted_code = schur.segment_sum.__code__
    try:
        with tempfile.TemporaryDirectory(prefix="ba_repro_seq_") as seq:
            K, _ = cs.bench_sequence(seq, 10)
            SfmEngine(seq, 10, config=cfg, single_K=K, device=dev)   # warm-up
            for name, code in (("atomic", _atomic_segment_sum.__code__), ("sorted", sorted_code)):
                schur.segment_sum.__code__ = code
                engine_runs = []
                for _ in range(args.runs):
                    eng = SfmEngine(seq, 10, config=cfg, single_K=K, device=dev)
                    torch.cuda.synchronize()
                    engine_runs.append([float(eng.errors_before_after_ba[1]),
                                        eng.ba_result.iterations_used, eng.stage_times["ba"]])
                resolves = []
                for _ in range(args.runs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = bundle_adjust(eng.ba_problem, max_iters=b.max_lm_iters, **kw)
                    torch.cuda.synchronize()
                    resolves.append([float(r.final_mean_error), r.iterations_used,
                                     time.perf_counter() - t0])
                prob_cpu = BAProblem(*(None if v is None else v.cpu() for v in eng.ba_problem))
                cpu = bundle_adjust(prob_cpu, max_iters=b.max_lm_iters, **kw)
                print(json.dumps({"segment_sum": name,
                                  "engine_runs_error_px_iters_ba_s": engine_runs,
                                  "resolves_error_px_iters_s": resolves,
                                  "cpu_error_px": float(cpu.final_mean_error),
                                  "cpu_iters": cpu.iterations_used}), flush=True)
    finally:
        schur.segment_sum.__code__ = sorted_code
    return 0


if __name__ == "__main__":
    sys.exit(main())
