"""Readings that set the limits of ``check.py``: sound runs of the program,
the control, and the program with a fault planted.

* sound: the cell's jobs as a run makes them, judged by the reference;
* ``control``: the program at the precision below the one its
  configuration states, judged by the same comparison. The configuration
  states float32 with TF32 off: the program's matmuls and convolutions run
  with TF32 on (its ``f32_precision`` guard opened), and its two float32
  CUDA-core kernels take bfloat16, the next precision below plain float32:
  the matcher its own ``bf16=True`` path, the Harris response the plain
  reference's arithmetic in bfloat16 put in the kernel's place;
* faults, each planted in the timed path or in what it returns:
  ``ba_unchanged`` (bundle adjustment returns its input state),
  ``filter_unchanged`` (the F-filter returns the ratio test's mask as its
  inliers), ``half_left_out`` (the second half of a job's images left out
  of the feature batch: their keypoints masked), ``bootstrap_flipped``
  (the incremental bootstrap returns the decomposition that cheirality
  rejects: camera 2 at -t, the points mirrored through camera 1, which
  reproject as well as the right ones), ``bootstrap_pose_altered`` (the
  bootstrap returns camera 1's pose for camera 2, with the points it
  triangulated), ``pose_altered`` (one returned camera takes its
  neighbour's pose; the only one, camera 2, takes camera 1's),
  ``match_altered`` (one filtered pair's second endpoints moved one match
  along).

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 --jobs 2 [--variants control ...]

prints one JSON line per job and variant. Run on the card at the cell's own
size; ``tests/test_portbench_control.py`` runs it on the card at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` in the program for the duration of the block (the
    engines look these functions up in their module at call time)."""
    from sfmfromscratch_tpu_torch.pipeline import incremental as inc

    saved = {}

    def patch(name, fn):
        saved[(inc, name)] = getattr(inc, name)
        setattr(inc, name, fn)

    if fault == "control":
        import functools

        import torch

        from portbench.reference.frontend import harris_response, precision
        from sfmfromscratch_tpu_torch.ops import matcher
        from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel, match_kernel

        def bf16_harris(image, gaussian_size, sigma, alpha):
            return harris_response(image.to(torch.bfloat16), gaussian_size, sigma, alpha).float()

        def tf32():
            return precision(True)

        for mod_name, mod in list(sys.modules.items()):
            if mod_name.split(".")[0] == "sfmfromscratch_tpu_torch" and \
                    getattr(mod, "f32_precision", None) is not None:
                saved[(mod, "f32_precision")] = mod.f32_precision
                mod.f32_precision = tf32
        saved[(harris_kernel, "harris_response_fused")] = harris_kernel.harris_response_fused
        harris_kernel.harris_response_fused = bf16_harris
        saved[(matcher, "match_top2_fused")] = matcher.match_top2_fused
        matcher.match_top2_fused = functools.partial(match_kernel.match_top2_fused, bf16=True)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return
    if fault == "ba_unchanged":
        real = inc.bundle_adjust

        def ba_unchanged(problem, **kw):
            res = real(problem, **kw)
            return res._replace(cam_params=problem.cam_params, points=problem.points,
                                final_cost=res.initial_cost,
                                final_mean_error=res.initial_mean_error)

        patch("bundle_adjust", ba_unchanged)
    elif fault == "filter_unchanged":
        real_f = inc.ransac_fundamental_adaptive_batch

        def filter_unchanged(gen, p1, p2, mask, **kw):
            return real_f(gen, p1, p2, mask, **kw)._replace(inliers=mask)

        patch("ransac_fundamental_adaptive_batch", filter_unchanged)
    elif fault == "half_left_out":
        real_x = inc.extract_features_batch

        def half_left_out(images, cfg):
            feats = real_x(images, cfg)
            kp = feats.keypoints
            keep = kp.mask.new_ones(kp.mask.shape[0], 1).cumsum(0) <= (kp.mask.shape[0] + 1) // 2
            return feats._replace(keypoints=kp._replace(mask=kp.mask & keep))

        patch("extract_features_batch", half_left_out)
    elif fault in ("bootstrap_flipped", "bootstrap_pose_altered"):
        import torch

        real_b = inc.bootstrap

        def bootstrap_altered(gen, p1, p2, K1, K2, *a, **kw):
            inl, X, rvec, t, P2 = real_b(gen, p1, p2, K1, K2, *a, **kw)
            if fault == "bootstrap_flipped":
                return inl, -X, rvec, -t, torch.cat([P2[:, :3], -P2[:, 3:]], 1)
            eye = torch.eye(3, dtype=P2.dtype, device=P2.device)
            return (inl, X, torch.zeros_like(rvec), torch.zeros_like(t),
                    inc.projection_matrix(eye, torch.zeros_like(t), K2))

        patch("bootstrap", bootstrap_altered)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def alter(rec, fault: str):
    """Faults planted in what a job returns."""
    import numpy as np

    if rec.failed:
        return rec
    if fault == "pose_altered" and rec.poses:
        k = len(rec.poses) // 2
        rec.poses = list(rec.poses)
        rec.poses[k] = rec.poses[k - 1] if k else (np.zeros(3), np.zeros(3))
    elif fault == "match_altered":
        pg = dict(rec.pair_geometry)
        for key in sorted(k for k in pg if k[0] < k[1]):
            g = pg[key]
            m = np.asarray(g.mask, bool)
            if m.sum() > 1:
                p2 = np.asarray(g.p2).copy()
                p2[m] = np.roll(p2[m], 1, axis=0)
                pg[key] = g._replace(p2=p2)
                break
        rec.pair_geometry = pg
    return rec


PROGRAM_FAULTS = ("ba_unchanged", "filter_unchanged", "half_left_out")
BOOTSTRAP_FAULTS = ("bootstrap_flipped", "bootstrap_pose_altered")   # the incremental engine's
OUTPUT_FAULTS = ("pose_altered", "match_altered")


def readings(bench, name: str, seeds, jobs: int, variants, device, sync, tmp: str,
             emit=print):
    """Emit, for each seed, the sound numbers of ``jobs`` jobs, and each of
    ``variants`` (the control and the faults) on the first job."""
    from portbench import check
    from portbench import jobs as J
    from portbench.scenes.pool import make_pool

    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    cell = dict(bench.cell(name), pool=min(bench.cell(name)["pool"], jobs))
    for seed in seeds:
        root = os.path.join(tmp, str(seed))
        pool, warm = make_pool(cell, cfg, seed, root, bench.scenes)
        J.run_job(0, -1, warm, cfg, seed ^ 0x5EED, device, sync)
        for i in range(jobs):
            rec = J.run_job(i, i % len(pool), pool[i % len(pool)], cfg, seed, device, sync)
            row = dict(variant="sound", seed=seed, job=i, failed=rec.failed, error=rec.error,
                       wall_s=rec.end - rec.start, cameras=rec.cameras)
            if not rec.failed:
                row.update(check.judge_job(rec, pool[rec.scene], cfg, device))
            emit(row)
        for fault in variants:
            if fault in PROGRAM_FAULTS + BOOTSTRAP_FAULTS + ("control",):
                with planted(fault):
                    rec = J.run_job(0, 0, pool[0], cfg, seed, device, sync)
            else:
                rec = alter(J.run_job(0, 0, pool[0], cfg, seed, device, sync), fault)
            row = dict(variant=fault, seed=seed, job=0, failed=rec.failed,
                       error=None if rec.error is None else rec.error[-300:], cameras=rec.cameras)
            if not rec.failed:
                row.update(check.judge_job(rec, pool[rec.scene], cfg, device))
            emit(row)
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--variants", nargs="*",
                    default=["control", *PROGRAM_FAULTS, *BOOTSTRAP_FAULTS, *OUTPUT_FAULTS])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.spec import Bench

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from sfmfromscratch_tpu_torch.native import build as native_build
    from sfmfromscratch_tpu_torch.ops.cuda import build as cuda_build

    cuda_build.build_all()
    native_build.build_all()
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="portbench_control_")
    try:
        readings(Bench(ROOT), args.workload, args.seeds, args.jobs, args.variants, dev,
                 lambda: torch.cuda.synchronize(dev), tmp,
                 emit=lambda row: print(json.dumps(row, default=str), flush=True))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
