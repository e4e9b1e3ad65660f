"""Reference numbers for the compat phase of the port's chip smoke test.

Runs the JAX package on the CPU, for ``config.seed`` 0-4 (``--seeds``):

* ``sfmrunner``: ``SfmEngine`` at ``compat.SFMRunner``'s configuration (the
  bench extractor settings, ``match_threshold=0.85``, the default RANSAC and
  BA configs, the fixed 0.5 prescale) on the bench sequence rendered at
  720x960 with f=1040 (``chip_smoke.compat_sequence``). ``SFMRunner`` itself
  always runs at the default seed 5, so the engine is built with its
  configuration here to vary the seed;
* ``mixed``: ``SfmEngine`` at the bench configuration on the bench sequence
  with view 2 padded by 16 px (``chip_smoke.mixed_size_sequence``), which
  takes the per-image extraction path;
* ``two_image``: ``SfmEngine(max_img=2)`` at the bench configuration on the
  slice phase's pair (``chip_smoke.two_image_sequence``): the rotation and
  translation-direction errors of its one pose;
* ``two_view``: the compat class chain on that pair at the bench widths
  (``ScaleRotInvSIFT``, ``NNRatioFeatureMatcher``, then per RANSAC seed
  ``find_inliers`` and ``CameraPose.ransac_camera_motion`` on its inliers at
  5,967 hypotheses with the canonical base and with view 1's true pose as
  the base, the triangulated inliers' reprojection error, and
  ``PnPRansac``/``PnP`` on them against the RANSAC pose). ``raw_*`` is
  ``ransac_camera_motion`` on every match: its ``min_cheirality_frac=1.0``
  finds no hypothesis with every match in front while outliers remain, and
  it falls back to the one with the most points in front.

Prints one JSON line per run and seed, then a summary of each run's range.
``chip_smoke.py`` pins its compat-phase tolerances beside these numbers.

    JAX_PLATFORMS=cpu python tools/compat_pins.py [--runs sfmrunner mixed two_image two_view]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the sequences and settings, no JAX)

RUNS = ("sfmrunner", "mixed", "two_image", "two_view")


def _jax_config(port_cfg):
    """The JAX package's PipelineConfig with the fields of ``port_cfg``."""
    from sfmfromscratch_tpu import config as jc

    d = dataclasses.asdict(port_cfg)
    return jc.PipelineConfig(
        extractor=jc.ExtractorConfig(**d.pop("extractor")),
        matcher=jc.MatcherConfig(**d.pop("matcher")),
        ransac=jc.RansacConfig(**d.pop("ransac")),
        ba=jc.BundleAdjustConfig(**d.pop("ba")), **d)


def _engine_row(eng, gt, n):
    ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt)
    e0, e1 = eng.errors_before_after_ba
    return dict(cameras=len(eng.global_poses), views=n, ate_over_extent=ate / extent,
                reproj_before_px=float(e0), reproj_after_px=float(e1),
                tracks=int(eng.map.num_tracks))


def _two_view_rows(seeds):
    """The compat class chain of the JAX package on the bench pair, one row
    per RANSAC seed."""
    import numpy as np

    from sfmfromscratch_tpu import compat

    mod = chip_smoke._render_module()
    images, K, poses, _ = mod.render_sequence(
        np.random.default_rng(7), num_views=10, num_points=600, img_hw=(360, 480), f=520.0,
        step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004))
    _, _, _, R_gt, t_gt = chip_smoke.bench_pair()
    params = dict(chip_smoke.BENCH_EXTRACTOR)
    e1 = compat.ScaleRotInvSIFT(np.asarray(images[1], np.float32), params)
    e2 = compat.ScaleRotInvSIFT(np.asarray(images[2], np.float32), params)
    (x1, y1), (x2, y2) = e1.detect_keypoints(), e2.detect_keypoints()
    m, _ = compat.NNRatioFeatureMatcher(chip_smoke.BENCH_MATCHER["ratio_threshold"]) \
        .match_features_ratio_test(e1.extract_descriptors(), e2.extract_descriptors())
    p1 = np.stack([x1[m[:, 0]], y1[m[:, 0]]], 1).astype(np.float64)
    p2 = np.stack([x2[m[:, 1]], y2[m[:, 1]]], 1).astype(np.float64)
    out = []
    for seed in seeds:
        Rr, tr, _, _ = compat.CameraPose(p1, p2, K, K).ransac_camera_motion(
            np.eye(3), np.zeros(3), max_iterations=5967, seed=seed)
        f1, f2 = compat.CameraPose.find_inliers(p1, p2, max_iterations=5967, seed=seed)
        cp = compat.CameraPose(f1, f2, K, K)
        R, t, in1, in2 = cp.ransac_camera_motion(np.eye(3), np.zeros(3), max_iterations=5967,
                                                 seed=seed)
        Rb, tb, inb, _ = cp.ransac_camera_motion(*poses[1], max_iterations=5967, seed=seed)
        P1 = compat.CameraPose.calculate_projection_matrix(np.eye(3), np.zeros(3), K)
        P2 = compat.CameraPose.calculate_projection_matrix(R, t, K)
        X = compat.CameraPose.non_linear_triangulation(
            compat.CameraPose.triangulate_points(in1, in2, P1, P2), in1, in2, P1, P2)
        reproj = compat.print_reprojection_error(X, in1, in2, P1, P2)
        row = dict(run="two_view", seed=seed, matches=len(m))
        row["rot_err_deg"], row["t_err_deg"] = chip_smoke.pose_errors(R, t, R_gt, t_gt)
        row["base_rot_err_deg"], row["base_t_err_deg"] = chip_smoke.pose_errors(Rb, tb, R_gt, t_gt)
        row["raw_rot_err_deg"], row["raw_t_err_deg"] = chip_smoke.pose_errors(Rr, tr, R_gt, t_gt)
        row.update(inliers=len(in1), base_inliers=len(inb), f_inliers=len(f1),
                   canonical_vs_base_rot_deg=chip_smoke._rot_gap_deg(R, Rb), reproj_px=reproj)
        for name, est in (("pnp_ransac", compat.PnPRansac(X, in2, K=K, seed=seed)),
                          ("pnp", compat.PnP(X, in2, K=K))):
            row[f"{name}_rot_gap_deg"] = chip_smoke._rot_gap_deg(est.R, R)
            row[f"{name}_tdir_gap_deg"] = chip_smoke.pose_errors(est.R, est.t.ravel(), R, t)[1]
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    args = ap.parse_args()

    import jax
    import numpy as np
    from scipy.spatial.transform import Rotation

    jax.config.update("jax_platforms", "cpu")
    from sfmfromscratch_tpu.pipeline.incremental import SfmEngine

    rows = {r: [] for r in args.runs}
    if "two_view" in rows:
        rows["two_view"] = _two_view_rows(args.seeds)
    with tempfile.TemporaryDirectory(prefix="compat_pins_") as tmp:
        for run in args.runs:
            if run == "two_view":
                continue
            seq = os.path.join(tmp, run)
            os.makedirs(seq)
            if run == "sfmrunner":
                K, gt = chip_smoke.compat_sequence(seq)
                n = chip_smoke.COMPAT_VIEWS
            elif run == "mixed":
                K, gt = chip_smoke.mixed_size_sequence(seq)
                n = 10
            else:
                K, R_gt, t_gt = chip_smoke.two_image_sequence(seq)
                n = 2
            for seed in args.seeds:
                if run == "sfmrunner":
                    cfg = chip_smoke.compat_config(seed)
                else:
                    cfg = dataclasses.replace(chip_smoke.engine_config(), seed=seed)
                eng = SfmEngine(seq, n, config=_jax_config(cfg), single_K=K)
                if run == "two_image":
                    rv, t = eng.global_poses[0]
                    R = Rotation.from_rotvec(np.asarray(rv, np.float64)).as_matrix()
                    rot, tdir = chip_smoke.pose_errors(R, t, R_gt, t_gt)
                    e0, e1 = eng.errors_before_after_ba
                    row = dict(cameras=len(eng.global_poses), rot_err_deg=rot, t_err_deg=tdir,
                               reproj_before_px=float(e0), reproj_after_px=float(e1),
                               tracks=int(eng.map.num_tracks))
                else:
                    row = _engine_row(eng, gt, n)
                row = dict(run=run, seed=seed, **row)
                rows[run].append(row)
                print(json.dumps(row), flush=True)
    for run, rs in rows.items():
        keys = [k for k in rs[0] if k not in ("run", "seed")]
        print(json.dumps({"run": run, "seeds": args.seeds, "jax_cpu_range": {
            k: [min(r[k] for r in rs), max(r[k] for r in rs)] for k in keys}}), flush=True)


if __name__ == "__main__":
    main()
