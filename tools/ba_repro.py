"""Is the port's bundle adjustment reproducible on the card?

Builds the kernels, renders ``chip_smoke.py``'s 10-view bench sequence and
runs ``SfmEngine`` on it at the bench configuration ``--runs`` times, then
solves the last run's final BA problem ``--runs`` more times on the card
and once on the CPU. It does this for three versions of
``ba/schur.py::segment_sum`` on the card: "planned" (as it is: every sum in
one launch of the segment-sum kernel over its plan, in a fixed order),
"sorted" (the sorted, fixed-order ``index_put_(accumulate=True)`` that the
kernel replaced) and "atomic" (the ``index_add_`` that one replaced). With
``--workload <cell> --seed <n>`` the engine runs are a benchmark cell's job 0
(``portbench/``, after its warm-up job), and the re-solved problem is that
job's last BA problem. Prints the card's name and power limit, then one JSON
line per version: each run's final mean reprojection error, LM iterations
and BA seconds, the re-solves' and the CPU's, and whether the card ended on
one final error across the runs.

    python3 tools/ba_repro.py [--runs 4] [--workload kf150_video --seed 3200000101]

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
sys.path.insert(0, os.path.join(ROOT, "tools"))


# The replaced versions, with segment_sum's signature; their code takes the
# place of segment_sum's own, so they read nothing outside their arguments.
def _atomic_segment_sum(x, plan):
    out = x.new_zeros((plan.offsets.shape[0] - 1,) + tuple(x.shape[1:]))
    return out.index_add_(0, plan.idx, x)


def _sorted_segment_sum(x, plan):
    out = x.new_zeros((plan.offsets.shape[0] - 1,) + tuple(x.shape[1:]))
    return out.index_put_((plan.idx,), x, accumulate=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--workload", default=None, help="a benchmark cell's job 0 in place of "
                                                     "the bench sequence")
    ap.add_argument("--seed", type=int, default=1, help="the cell's run seed (--workload)")
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
    # segment_sum is imported by name in several modules: swap its code, so
    # every caller takes the version under test.
    planned_code = schur.segment_sum.__code__
    try:
        with tempfile.TemporaryDirectory(prefix="ba_repro_seq_") as seq:
            if args.workload:
                from profile_engine import _cell_runs

                engine, cell_cfg, ekw, warm, pool, seed_of = _cell_runs(args.workload,
                                                                       args.seed, seq)
                cfg = cell_cfg(seed_of(0))

                def job(sc):
                    return engine(sc.dir, len(sc.files), config=cell_cfg(seed_of(0)),
                                  single_K=sc.K, device=dev, **ekw)

                job(warm)                                                  # warm-up
                scene = pool[0]
            else:
                cfg = cs.engine_config()
                K, _ = cs.bench_sequence(seq, 10)

                def job(_):
                    return SfmEngine(seq, 10, config=cfg, single_K=K, device=dev)

                job(None)                                                  # warm-up
                scene = None
            b = cfg.ba
            kw = dict(cg_iters=60, init_damping=b.init_damping, damping_up=b.damping_up,
                      damping_down=b.damping_down, ftol=b.ftol, huber_delta=b.huber_delta)
            for name, code in (("atomic", _atomic_segment_sum.__code__),
                               ("sorted", _sorted_segment_sum.__code__),
                               ("planned", planned_code)):
                schur.segment_sum.__code__ = code
                engine_runs = []
                for _ in range(args.runs):
                    eng = job(scene)
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
                errors = {r[0] for r in engine_runs} | {r[0] for r in resolves}
                print(json.dumps({"segment_sum": name, "workload": args.workload,
                                  "engine_runs_error_px_iters_ba_s": engine_runs,
                                  "resolves_error_px_iters_s": resolves,
                                  "one_final_error": len({r[0] for r in resolves}) == 1
                                  and len({r[0] for r in engine_runs}) == 1,
                                  "distinct_final_errors": len(errors),
                                  "cpu_error_px": float(cpu.final_mean_error),
                                  "cpu_iters": cpu.iterations_used}), flush=True)
    finally:
        schur.segment_sum.__code__ = planned_code
    return 0


if __name__ == "__main__":
    sys.exit(main())
