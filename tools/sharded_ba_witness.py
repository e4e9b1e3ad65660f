"""The mesh phase's sharded BA against the unsharded solve, on the CPU.

Runs ``SfmEngine`` on the bench sequence (``chip_smoke.bench_sequence``,
``chip_smoke.engine_config``) on the CPU and solves its final BA problem with
the engine phase's solver keywords four ways: unsharded and sharded by
observation over 2 gloo ranks (``bundle_adjust_sharded``), each in float32
and in float64. Prints, per precision, both solves' iterations, final
errors and costs, and the share of the points of 3 or more views that lie
within the mesh phase's check (rtol 0.05, atol 0.02 after a similarity
alignment), with the largest gap; then how far each float32 solve lands
from the float64 one. About 30 s:

    python tools/sharded_ba_witness.py
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (the bench scene, its configuration and the alignment)

DTYPES = (torch.float32, torch.float64)


def _in(problem, dtype):
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem

    return BAProblem(*(v.to(dtype) if v is not None and v.is_floating_point() else v
                       for v in problem))


def _row(res):
    return dict(iterations=int(res.iterations_used), reproj_after_px=float(res.final_mean_error),
                cost=float(res.final_cost), points=res.points.double().numpy())


def _rank(rank, work):
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel import bundle_adjust_sharded, make_mesh
    from sfmfromscratch_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"file://{os.path.join(work, 'store')}", 2, rank, device=torch.device("cpu"))
    saved = torch.load(os.path.join(work, "ba.pt"), weights_only=False)
    mesh = make_mesh()
    out = {str(dt): _row(bundle_adjust_sharded(_in(saved["problem"], dt), mesh, **saved["kw"]))
           for dt in DTYPES}
    if rank == 0:
        with open(os.path.join(work, "sharded.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    with tempfile.TemporaryDirectory(prefix="sharded_ba_witness_") as work:
        seq = os.path.join(work, "bench")
        os.makedirs(seq)
        K, _ = chip_smoke.bench_sequence(seq, 10)
        cfg = chip_smoke.engine_config()
        eng = SfmEngine(seq, 10, config=cfg, single_K=K, device="cpu")
        b = cfg.ba
        kw = dict(cg_iters=60, init_damping=b.init_damping, damping_up=b.damping_up,
                  damping_down=b.damping_down, ftol=b.ftol, huber_delta=b.huber_delta,
                  max_iters=b.max_lm_iters)
        problem = eng.ba_problem
        torch.save(dict(problem=problem, kw=kw), os.path.join(work, "ba.pt"))
        unsharded = {str(dt): _row(bundle_adjust(_in(problem, dt), **kw)) for dt in DTYPES}
        mp.spawn(_rank, args=(work,), nprocs=2)
        with open(os.path.join(work, "sharded.pkl"), "rb") as f:
            sharded = pickle.load(f)

    views = np.bincount(problem.obs_pt[problem.obs_w > 0].numpy(), minlength=problem.num_points)
    multi = views >= 3

    def close(a, ref):
        aligned = chip_smoke._similarity_align(a[multi], ref[multi])
        return dict(points_3plus_within_tol=float(np.isclose(aligned, ref[multi], rtol=0.05,
                                                             atol=0.02).all(1).mean()),
                    points_3plus_max_gap_aligned=float(np.abs(aligned - ref[multi]).max()))

    strip = lambda r: {k: v for k, v in r.items() if k != "points"}  # noqa: E731
    for dt in map(str, DTYPES):
        print(json.dumps(dict(dtype=dt, unsharded=strip(unsharded[dt]), sharded=strip(sharded[dt]),
                              sharded_vs_unsharded=close(sharded[dt]["points"],
                                                         unsharded[dt]["points"]))), flush=True)
    f64 = unsharded[str(torch.float64)]["points"]
    print(json.dumps(dict(points_3plus=int(multi.sum()),
                          float32_unsharded_vs_float64=close(unsharded[str(torch.float32)]["points"], f64),
                          float32_sharded_vs_float64=close(sharded[str(torch.float32)]["points"], f64))),
          flush=True)


if __name__ == "__main__":
    main()
