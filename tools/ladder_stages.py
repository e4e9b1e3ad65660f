"""Stage by stage, the ladder phase's ``L3`` rung on one device.

For each ``config.seed`` given, runs the port's ``SfmEngine`` on
``--device`` at ``L3``'s configuration and scene (``chip_smoke.LADDER_RUNGS``:
the 47-view chain) and prints one JSON line with:

* ``keypoints`` and ``keypoint_sum``: valid keypoints per image and the sum
  of their coordinates (no random draw: the card and the CPU agree up to
  rounding);
* ``filtered``: the F-filter's inliers on each consecutive pair (the
  bootstrap pair keeps its ratio-test matches);
* ``rel_rot_deg``: the rotation error of each consecutive pair of
  registered cameras against the ground truth;
* the errors before and after the final BA, its LM iterations, ATE over
  extent and tracks.

With ``--cpu-draws`` every RANSAC uniform of a card run comes from a CPU
generator seeded as the engine's own, so that the card draws what a CPU
run draws and the two runs differ only in their arithmetic.

    python tools/ladder_stages.py [--seeds 0 1 2] [--device cpu|cuda] [--cpu-draws]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (the rungs, their scenes and the metrics)
from tools.degraded_stages import _rodrigues  # noqa: E402


def cpu_draws(seed):
    """Make every ``torch.rand`` on a card generator draw from a CPU
    generator seeded with ``seed`` instead (the values moved to the card).
    Returns the function that puts ``torch.rand`` back."""
    import torch

    real = torch.rand
    gen = torch.Generator().manual_seed(seed)

    def rand(*size, generator=None, device=None, dtype=None, **kw):
        if generator is None or generator.device.type == "cpu":
            return real(*size, generator=generator, device=device, dtype=dtype, **kw)
        return real(*size, generator=gen, dtype=dtype, **kw).to(device or generator.device)

    torch.rand = rand
    return lambda: setattr(torch, "rand", real)


def stages(name, api, scene, seed):
    """The row of rung ``name`` at ``seed`` on ``scene``."""
    engine, n, kp, kw = chip_smoke.LADDER_RUNGS[name][:4]
    assert engine == "SfmEngine", f"{name} is not a chain rung"
    eng = api.SfmEngine(scene["dir"], n, config=chip_smoke.ladder_config(api, kp, seed),
                        single_K=scene["K"], auto_run=False, **kw)
    extract, seen = eng._extract_all_features, {}

    def recorded():
        seen["feats"] = feats = extract()
        return feats
    eng._extract_all_features = recorded
    t0 = time.perf_counter()
    eng.run()
    api.sync()
    wall = time.perf_counter() - t0
    k = seen["feats"].keypoints
    mask = k.mask.cpu().numpy()
    xy = np.stack([k.xf.cpu().numpy(), k.yf.cpu().numpy()], -1).astype(np.float64)
    first = 1 if len(eng.global_poses) == n else 2
    est_R = [_rodrigues(rv) for rv, _ in eng.global_poses]
    gt = scene["poses"][first - 1:first - 1 + len(est_R)]
    rel_rot = []
    for a in range(len(est_R) - 1):
        dR = (est_R[a + 1] @ est_R[a].T) @ (gt[a + 1][0] @ gt[a][0].T).T
        rel_rot.append(float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))))
    ate, extent = chip_smoke.trajectory_error(eng.global_poses, scene["poses"], first_image=first)
    e0, e1 = eng.errors_before_after_ba
    return dict(
        keypoints=mask.sum(1).tolist(), keypoint_sum=(xy * mask[..., None]).sum((1, 2)).tolist(),
        filtered=[int(eng.pair_geometry[(i, i + 1)].mask.sum()) for i in range(1, n)],
        rel_rot_deg=rel_rot, ate_over_extent=ate / extent, reproj_before_px=float(e0),
        reproj_after_px=float(e1), iterations=int(eng.ba_result.iterations_used),
        tracks=int(eng.map.num_tracks), wall_s=wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    ap.add_argument("--cpu-draws", action="store_true",
                    help="a card run draws its RANSAC uniforms from a CPU generator")
    args = ap.parse_args()
    import torch

    api = chip_smoke.port_ladder_api(torch.device(args.device))
    with tempfile.TemporaryDirectory(prefix="ladder_stages_L3_") as work:
        scene = chip_smoke.ladder_scene("L3", work)
        for seed in args.seeds:
            restore = cpu_draws(seed) if args.cpu_draws else (lambda: None)
            try:
                row = stages("L3", api, scene, seed)
            finally:
                restore()
            print(json.dumps(dict(rung="L3", seed=seed, device=args.device,
                                  cpu_draws=args.cpu_draws, **row)), flush=True)


if __name__ == "__main__":
    main()
