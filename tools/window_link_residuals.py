"""Residuals of window-linked observations against the rest, after BA.

Runs the port's ``SfmEngine`` on ``bench.py``'s 10-view sequence
(``chip_smoke.bench_sequence``) at the bench configuration with
``--keypoints`` keypoints, with the host chain at window 1 and at window 3
(without and with a local BA every 3 cameras), and records which
observations ``_link_window_pairs`` added. Prints one JSON line per run:
ATE over trajectory extent, the mean reprojection error before and after BA,
the count of window-linked observations, and for those and for the rest the
median reprojection residual (px) under the final poses and points and the
share above 3 px.

    python tools/window_link_residuals.py [--keypoints 1000] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the bench sequence and configuration)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keypoints", type=int, default=1000)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import torch

    from sfmfromscratch_tpu_torch.ops.lie import so3_exp
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    class Recording(SfmEngine):
        """``SfmEngine`` that keeps the observation ranges window linking adds."""

        def _link_window_pairs(self, j, current_frame, pair_host):
            start = self.map.num_observations
            super()._link_window_pairs(j, current_frame, pair_host)
            self.linked.append((start, self.map.num_observations))

    base = chip_smoke.engine_config()
    cfg = dataclasses.replace(
        base, extractor=dataclasses.replace(base.extractor, num_interest_points=args.keypoints),
        matcher=dataclasses.replace(base.matcher, max_matches=args.keypoints))
    with tempfile.TemporaryDirectory(prefix="window_link_") as seq:
        K, gt = chip_smoke.bench_sequence(seq, 10)
        for kw in (dict(pair_window=1), dict(pair_window=3),
                   dict(pair_window=3, local_ba_every=3)):
            eng = Recording(seq, 10, config=cfg, single_K=K, device=args.device,
                            chain_mode="host", auto_run=False, **kw)
            eng.linked = []
            eng.run()
            frames, tracks, xy = eng.map.observations()
            rv = torch.as_tensor(np.stack([p[0] for p in eng.global_poses]), dtype=torch.float64)
            R = so3_exp(rv).numpy()[frames]
            t = np.stack([p[1] for p in eng.global_poses])[frames]
            Ks = np.stack(eng.global_K)[frames]
            x = np.einsum("nij,nj->ni", Ks,
                          np.einsum("nij,nj->ni", R, eng.map.points()[tracks]) + t)
            res = np.linalg.norm(x[:, :2] / x[:, 2:] - xy, axis=1)
            win = np.zeros(len(frames), bool)
            for a, b in eng.linked:
                win[a:b] = True
            ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt)

            def stats(sel):
                return ([float(np.median(res[sel])), float((res[sel] > 3.0).mean())]
                        if sel.any() else None)

            print(json.dumps(dict(
                options=kw, keypoints=args.keypoints, device=args.device,
                ate_over_extent=ate / extent,
                reproj_before_after_px=list(map(float, eng.errors_before_after_ba)),
                observations=len(frames), window_linked=int(win.sum()),
                window_median_px_share_over_3px=stats(win),
                other_median_px_share_over_3px=stats(~win))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
