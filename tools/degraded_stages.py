"""Stage by stage, the degraded incremental scenario in both packages.

``tests/test_adversarial.py:47-73`` renders the 6-view planes scene at
3-degree steps, degrades it (``tests/render.py::degrade_sequence``) and
holds ``SfmEngine``'s ATE under 8% of the trajectory's extent. For each
``config.seed`` given, on the CPU, both packages get the same files and
this prints one JSON line per package with:

* ``keypoints``: valid keypoints per image (``FeatureRunner`` at the test's
  extractor on the rendered arrays, before the JPEG round trip; no random
  draw);
* ``matches``: ratio-test matches of each consecutive pair (no draw);
* ``ate_pct`` and ``camera_err_pct``: the engine's ATE and each camera
  centre's error after the similarity alignment, in percent of the extent;
* ``rel_rot_deg``: the rotation error of each consecutive pair of
  registered cameras against the ground truth (3 degrees a step); the
  first pair (images 2, 3) links the bootstrap pair (images 1, 2) to the
  chain.

    JAX_PLATFORMS=cpu python tools/degraded_stages.py --seeds 2 12
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (the scenes, the configuration and the metrics)


def _rodrigues(rvec):
    rvec = np.asarray(rvec, np.float64)
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = rvec / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def stages(api, images, K, poses, d, seed):
    """The row of one package on the degraded files in ``d``."""
    cfg = chip_smoke.small_config(api, seed)
    runs = [api.feature_runner(images[i], images[i + 1], cfg.extractor, scale_factor=1.0)
            for i in range(len(images) - 1)]
    keypoints = [int(api.host(runs[0].features1.keypoints.mask).sum())]
    keypoints += [int(api.host(r.features2.keypoints.mask).sum()) for r in runs]
    matches = [int(api.host(r.matches.mask).sum()) for r in runs]
    eng = api.SfmEngine(d, len(images), config=cfg, single_K=K)
    first = 1 if len(eng.global_poses) == len(poses) else 2
    est_R = [_rodrigues(rv) for rv, _ in eng.global_poses]
    est_t = [np.asarray(t, np.float64) for _, t in eng.global_poses]
    gt = poses[first - 1:first - 1 + len(est_R)]
    centers = np.stack([-R.T @ t for R, t in zip(est_R, est_t)])
    gt_centers = np.stack([-R.T @ t for R, t in gt])
    extent = float(np.linalg.norm(gt_centers.max(0) - gt_centers.min(0)))
    aligned = chip_smoke._similarity_align(centers, gt_centers)
    rel_rot = []
    for a in range(len(est_R) - 1):
        dR = (est_R[a + 1] @ est_R[a].T) @ (gt[a + 1][0] @ gt[a][0].T).T
        rel_rot.append(float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))))
    return dict(keypoints=keypoints, matches=matches, cameras=len(eng.global_poses),
                ate_pct=chip_smoke._ate_pct(eng, poses),
                camera_err_pct=(100 * np.linalg.norm(aligned - gt_centers, axis=1)
                                / extent).tolist(),
                rel_rot_deg=rel_rot,
                reproj_px=float(eng.errors_before_after_ba[1]), tracks=int(eng.map.num_tracks))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 12])
    args = ap.parse_args()
    import torch

    from tools.scenario_pins import jax_scenario_api

    apis = {"jax": jax_scenario_api(), "port": chip_smoke.port_scenario_api(torch.device("cpu"))}
    mod = chip_smoke._render_module()
    for seed in args.seeds:
        # tests/test_adversarial.py:47-60, the rng fixture (tests/conftest.py:89-92)
        rng = np.random.default_rng(5)
        images, K, poses, _ = mod.render_planes(rng, num_views=6, orbit_step_deg=3.0)
        degraded = mod.degrade_sequence(rng, images)
        with tempfile.TemporaryDirectory(prefix="degraded_stages_") as d:
            mod.write_sequence(d, degraded)
            for name, api in apis.items():
                row = stages(api, degraded, K, poses, d, seed)
                print(json.dumps(dict(seed=seed, package=name, **row)), flush=True)


if __name__ == "__main__":
    main()
