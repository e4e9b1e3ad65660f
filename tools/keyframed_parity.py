"""The keyframed video path of ``GlobalSfmEngine`` against its plain
reference (``portbench/reference/keyframed.py``), on a benchmark cell's own
jobs.

Each job runs through ``portbench/jobs.py::run_job``, as the harness runs
it, with the engine's keyframe and registration stages recorded: the
consecutive pairs' matches, the chosen keyframes, the keyframes' surviving
observations, the map's points, the registration pairs' matches and
F-filter inliers, the P3P uniforms (drawn from the engine's generator as the
stage draws them), the correspondences the stage linked and the poses it
registered, before bundle adjustment moves them, and each bundle
adjustment's Schur backend (``dense`` or ``pcg``) with its camera count.
The reference then recomputes from the recorded inputs:

* the keyframes, from the consecutive pairs' median flows: equal;
* each frame's correspondences (tracks, pixels, first occurrences): equal;
* each frame's pose: registered or not as the program says, and fitting
  the reference's inliers within ``FIT_TOL_PX`` of the reference's RMS
  reprojection error; the rotation and centre gaps (over the inliers'
  median depth) are reported beside it.

    python3 tools/keyframed_parity.py --workload kf150_video --seeds 11 12 13 [--jobs 1]
        [--device cuda] [--out parity.jsonl]

prints one JSON line per job.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import keyframed as ref  # noqa: E402

# A registered pose is judged by how well it fits: its RMS reprojection
# error over the reference's inliers may exceed the reference pose's by at
# most FIT_TOL_PX. Pose by pose the two agree to ~0.001-0.007 deg, but in 1-2
# frames of a job's ~140 they part by 0.2-2.4 deg: there a boundary point of
# the 8 px threshold flips, in float32 against float64, which P3P sample
# wins or whether the polish, which may lose no inlier, is kept, and one
# side keeps a raw three-point pose that fits 0.2-1.3 px worse (14 jobs on
# the card). The program with its polish removed fits 2.9-3.8 px worse (6
# jobs): the tolerance sits farther above the first than below the second.
# The pose gaps and the number of frames apart by more than 0.05 deg are
# reported beside it.
FIT_TOL_PX = 2.25
APART_DEG = 0.05


@contextlib.contextmanager
def recording():
    """Record the keyframe and registration stages of every
    ``GlobalSfmEngine`` run inside the block: ``with recording() as jobs``
    gives one dict a run in ``jobs``."""
    import torch

    from sfmfromscratch_tpu_torch.ba import lm
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as G

    jobs = []
    saved = {n: getattr(G, n) for n in ("_match_pair_list", "_select_keyframes",
                                        "_link_registration", "_register_frames")}
    resolve_dense = lm.resolve_dense

    def resolve(use_dense, num_cameras, num_points):
        dense = resolve_dense(use_dense, num_cameras, num_points)
        if jobs:
            jobs[-1].setdefault("ba", []).append(("dense" if dense else "pcg", num_cameras))
        return dense

    def match_pair_list(eng, feats, pairs):
        out = saved["_match_pair_list"](eng, feats, pairs)
        if pairs == [(i, i + 1) for i in range(1, eng.max_img)] and "flow" not in jobs[-1]:
            res, p1, p2 = out
            jobs[-1]["flow"] = tuple(v.cpu().numpy() for v in (p1, p2, res.mask))
        return out

    def select_keyframes(eng, feats):
        jobs.append({})
        saved["_select_keyframes"](eng, feats)
        jobs[-1]["keyframes"] = list(eng._auto_kfs)

    def link_registration(eng, capacity, non_kf, results):
        out = saved["_link_registration"](eng, capacity, non_kf, results)
        jobs[-1]["links"] = tuple(np.copy(v) for v in out)
        return out

    def register_frames(eng, capacity, non_kf, results, uniforms=None):
        if uniforms is None:   # the draw the stage makes
            uniforms = torch.rand((len(non_kf), min(512, eng._pnp_hyp), 3),
                                  generator=eng._generator, device=eng.device)
        job = jobs[-1]
        job.update(frames=list(non_kf),
                   results={k: tuple(np.copy(a) for a in v) for k, v in results.items()},
                   obs=(np.asarray(eng._obs_cam, np.int64) + 1, np.asarray(eng._obs_kp).copy(),
                        np.asarray(eng._obs_pt, np.int64).copy()),
                   points=eng.map.points().copy(), K=eng._intrinsics(non_kf[0]).copy(),
                   uniforms=uniforms.cpu().numpy(),
                   threshold=float(eng.config.ransac.pnp_reproj_threshold))
        n0 = len(eng.warnings)
        counts = saved["_register_frames"](eng, capacity, non_kf, results, uniforms)
        job["failed"] = {f for f in non_kf if any(
            w.startswith(f"frame {f}: PnP registration failed") for w in eng.warnings[n0:])}
        job["poses"] = {f: tuple(np.asarray(a, np.float64) for a in eng.global_poses[f - 1])
                        for f in non_kf}
        job["counts"] = dict(counts)
        return counts

    for n, fn in (("_match_pair_list", match_pair_list), ("_select_keyframes", select_keyframes),
                  ("_link_registration", link_registration), ("_register_frames", register_frames)):
        setattr(G, n, fn)
    lm.resolve_dense = resolve
    try:
        yield jobs
    finally:
        for n, fn in saved.items():
            setattr(G, n, fn)
        lm.resolve_dense = resolve_dense


def compare(job: dict, target_px: float) -> dict:
    """The reference's keyframes, links and poses against one recorded
    job's."""
    p1, p2, mask = job["flow"]
    kfs = ref.select_keyframes(ref.median_flow(p1, p2, mask), target_px)
    out = dict(keyframes=len(job["keyframes"]), keyframes_equal=kfs == job["keyframes"],
               frames=len(job.get("frames", [])), ba=job.get("ba", []))
    if "frames" not in job:      # every image a keyframe: nothing registered
        return out
    links = ref.link_frames(ref.keyframe_tracks(*job["obs"]), job["results"], job["frames"])
    X_all, x_all, t_all, m_all, _ = job["links"]
    slots = t_all.shape[1]
    equal = True
    for fi, f in enumerate(job["frames"]):
        lk = links[f]
        n = len(lk.tracks)
        equal &= bool(np.array_equal(t_all[fi, :n], lk.tracks) and np.all(t_all[fi, n:] == -1)
                      and np.array_equal(m_all[fi, :n], lk.keep) and not m_all[fi, n:].any()
                      and np.array_equal(x_all[fi, :n], lk.xy.astype(np.float32)))
    poses = ref.register(links, job["points"], job["K"], job["uniforms"], slots, job["threshold"])
    frames = []
    for f, pose in poses.items():
        if not pose.registered:
            continue
        R, t = ref.rodrigues(job["poses"][f][0]), job["poses"][f][1]
        X, x, valid = ref.padded(links[f], job["points"], slots)
        inl = pose.inliers
        rms = [float(np.sqrt(np.mean(ref.reprojection_px(Ra[None], ta[None], job["K"], X[inl],
                                                         x[inl])[0] ** 2)))
               for Ra, ta in ((pose.R, pose.t), (R, t))]
        a, c = ref.pose_gap(R, t, pose.R, pose.t)
        depth = float(np.median((X[inl] @ pose.R.T + pose.t)[:, 2]))
        frames.append(dict(frame=f, rot_deg=a, centre_rel=c / depth, links=int(valid.sum()),
                           inliers=int(inl.sum()), rms_ref=rms[0], rms_port=rms[1],
                           fit_gap_px=rms[1] - rms[0]))
    ref_failed = {f for f, pose in poses.items() if not pose.registered}
    fit_gap = max((d["fit_gap_px"] for d in frames), default=0.0)
    out.update(links=int(m_all.sum()), links_equal=equal, failed=len(job["failed"]),
               failed_counter=int(job["counts"]["failed"]),
               failed_equal=ref_failed == job["failed"],
               rot_deg=max((d["rot_deg"] for d in frames), default=0.0),
               centre_rel=max((d["centre_rel"] for d in frames), default=0.0),
               frames_apart=sum(d["rot_deg"] > APART_DEG for d in frames),
               fit_gap_px=fit_gap, poses_within=fit_gap <= FIT_TOL_PX,
               worst_frames=sorted(frames, key=lambda d: -d["fit_gap_px"])[:3])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="kf150_video")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=1, help="jobs of each seed's pool, in order")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)

    import torch

    from portbench import jobs as J
    from portbench.scenes.pool import make_pool
    from portbench.spec import Bench

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("keyframed_parity: no CUDA card", file=sys.stderr)
            return 2
        from sfmfromscratch_tpu_torch.native import build as native_build
        from sfmfromscratch_tpu_torch.ops.cuda import build as cuda_build

        cuda_build.build_all()
        native_build.build_all()
        sync = lambda: torch.cuda.synchronize(dev)   # noqa: E731
        card = torch.cuda.get_device_name(dev)
    else:
        sync = lambda: None   # noqa: E731
        card = "cpu"
    bench = Bench(ROOT)
    cfg = bench.config(bench.workload(args.workload)["config"])
    target = float(cfg["engine_kwargs"]["keyframe_flow_px"])
    cell = bench.cell(args.workload)
    tmp = tempfile.mkdtemp(prefix="keyframed_parity_")
    ok = True
    try:
        for seed in args.seeds:
            pool, _ = make_pool(dict(cell, pool=min(cell["pool"], args.jobs)), cfg, seed,
                                os.path.join(tmp, str(seed)))
            for i in range(args.jobs):
                with recording() as recorded:
                    rec = J.run_job(i, i % len(pool), pool[i % len(pool)], cfg, seed, dev, sync)
                row = dict(seed=seed, job=i, card=card, error=rec.error, cameras=rec.cameras)
                if rec.error is None and recorded:
                    row.update(compare(recorded[-1], target))
                    ok &= bool(row["keyframes_equal"] and row.get("links_equal", True)
                               and row.get("failed_equal", True) and row.get("poses_within", True))
                else:
                    ok = False
                line = json.dumps(row)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
