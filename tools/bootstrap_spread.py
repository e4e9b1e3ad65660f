"""The adaptive bootstrap's error distribution in both packages, on the CPU.

Takes pair (1, 2) of the bench sequence with the DoG front end at the bench
configuration (``chip_smoke.engine_config``; the port's features, which match
JAX's, ``tests/test_torch_extractors.py``), and runs the engine's bootstrap
(adaptive essential RANSAC, DLT, Gauss-Newton) ``--draws`` times in each
package: JAX with ``jax.random.key(s)``, the port with
``torch.Generator().manual_seed(s)``. Prints the rotation and
translation-direction errors of the bootstrap pose against the ground truth
(percentiles, tail shares) and a two-sample Kolmogorov-Smirnov test of each:
with equal distributions, a run whose chain follows a bad bootstrap is a
draw, not a port fault.

    JAX_PLATFORMS=cpu python tools/bootstrap_spread.py [--draws 250] [--front dog|sift]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the scenes and settings, no JAX)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=250)
    ap.add_argument("--front", choices=["dog", "sift"], default="dog")
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch
    from scipy.stats import ks_2samp

    jax.config.update("jax_platforms", "cpu")
    from sfmfromscratch_tpu.pipeline import incremental as jinc
    from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
    from sfmfromscratch_tpu_torch.pipeline.frontend import make_dog_extractor
    from sfmfromscratch_tpu_torch.utils.metrics import rotvec_to_matrix

    cfg = chip_smoke.engine_config()
    rc = cfg.ransac
    with tempfile.TemporaryDirectory(prefix="bootstrap_spread_") as seq:
        K, gt = chip_smoke.bench_sequence(seq, 3)
        ext = make_dog_extractor(cfg.extractor) if args.front == "dog" else None
        eng = tinc.SfmEngine(seq, 3, config=cfg, single_K=K, device="cpu", auto_run=False,
                             feature_extractor=ext)
        eng._match_pairs(eng._extract_all_features())
    pg = eng.pair_geometry[(1, 2)]
    R_gt = gt[1][0] @ gt[0][0].T
    t_gt = gt[1][1] - R_gt @ gt[0][1]
    t_gt = t_gt / np.linalg.norm(t_gt)

    def errors(rvec, t):
        R = rotvec_to_matrix(np.asarray(rvec, np.float64)[None])[0]
        rot = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
        t = np.asarray(t, np.float64) / np.linalg.norm(t)
        return float(rot), float(np.degrees(np.arccos(np.clip(t @ t_gt, -1, 1))))

    Kf = np.asarray(K, np.float32)
    tt = lambda a, d=torch.float32: torch.as_tensor(np.asarray(a)).to(d)
    out = {"jax": [], "port": []}
    for s in range(args.draws):
        j = jinc._bootstrap_device(jax.random.key(s), pg.p1, pg.p2, Kf, Kf, pg.mask,
                                   rc.max_hypotheses(), rc.epipolar_threshold,
                                   stage_size=rc.stage_size, adaptive=True)
        out["jax"].append(errors(np.asarray(j[2]), np.asarray(j[3])))
        p = tinc.bootstrap(torch.Generator().manual_seed(s), tt(pg.p1), tt(pg.p2), tt(Kf), tt(Kf),
                           tt(pg.mask, torch.bool), rc.max_hypotheses(), rc.epipolar_threshold,
                           stage_size=rc.stage_size)
        out["port"].append(errors(p[2].numpy(), p[3].numpy()))
    res = {"front": args.front, "draws": args.draws, "matches": int(pg.mask.sum())}
    for k, name in ((0, "rotation_deg"), (1, "tdir_deg")):
        a = np.array([e[k] for e in out["jax"]])
        b = np.array([e[k] for e in out["port"]])
        ks = ks_2samp(a, b)
        res[name] = {
            "jax_p10_p50_p90_max": np.percentile(a, [10, 50, 90, 100]).round(3).tolist(),
            "port_p10_p50_p90_max": np.percentile(b, [10, 50, 90, 100]).round(3).tolist(),
            "ks_statistic": float(ks.statistic), "ks_pvalue": float(ks.pvalue)}
    thr = 10.0
    res["tdir_share_over_10_deg"] = {
        "jax": float(np.mean([e[1] > thr for e in out["jax"]])),
        "port": float(np.mean([e[1] > thr for e in out["port"]]))}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
