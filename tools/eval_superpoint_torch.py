"""Wide-baseline shootout of the PyTorch port: TinyPoint against the SIFT front end.

The port's counterpart of ``tools/eval_superpoint.py``, with its pairs,
extractors and scoring. For each orbit step (the baseline angle) it renders
a perspective-correct two-view pair (``tests/render.py::render_planes``,
noise textures), runs three extractors at k=600 (SIFT at 3 levels x1.2,
``SuperPointExtractor`` on a checkpoint, ``make_hybrid_extractor``: the
checkpoint's detector with RootSIFT descriptors), matches each with the
ratio test at 0.85 and scores the matches' epipolar inlier share at 2 px
against the ground-truth relative pose (no RANSAC in the loop: the metric is
match quality alone). Runs on the CUDA card unless given ``--device cpu``;
``--weights`` takes another ``save_flax_weights`` checkpoint than the
committed TinyPoint one.

    python tools/eval_superpoint_torch.py [steps_deg ...] [--device cpu|cuda]
        [--weights PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (this checkout's tests/render.py; no JAX)

STEPS = (8.0, 14.0, 20.0, 26.0, 32.0)
K_POINTS = 600
RATIO = 0.85
EXTRACTOR = dict(num_interest_points=K_POINTS, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
                 feature_width=16, pyramid_level=3, pyramid_scale_factor=1.2)
EXTRACTORS = ("sift", "tinypoint", "hybrid")


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def gt_epipolar_inliers(p1, p2, K, R1, t1, R2, t2, thresh=2.0):
    """Symmetric epipolar distance against the ground-truth relative pose."""
    R = R2 @ R1.T
    t = t2 - R @ t1
    E = _skew(t) @ R
    F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
    ph1 = np.concatenate([p1, np.ones((len(p1), 1))], 1)
    ph2 = np.concatenate([p2, np.ones((len(p2), 1))], 1)
    l2 = ph1 @ F.T
    l1 = ph2 @ F
    num = np.abs(np.sum(ph2 * l2, 1))
    d = 0.5 * (num / np.linalg.norm(l2[:, :2], axis=1)
               + num / np.linalg.norm(l1[:, :2], axis=1))
    return d <= thresh


def run_pair(step_deg, seed=0, device=None, weights="auto"):
    """The pair at ``step_deg`` through the three extractors on ``device``
    (None: the CUDA card, raising without one): ``{name: (matches,
    inlier share)}`` for ``EXTRACTORS``."""
    import torch

    from sfmfromscratch_tpu_torch.config import ExtractorConfig
    from sfmfromscratch_tpu_torch.ops.matcher import match_ratio_test
    from sfmfromscratch_tpu_torch.ops.superpoint import SuperPointExtractor, make_hybrid_extractor
    from sfmfromscratch_tpu_torch.pipeline.frontend import extract_features
    from sfmfromscratch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    images, K, poses = chip_smoke._render_module().render_planes(
        np.random.default_rng(seed), num_views=2, img_hw=(240, 320), f=400.0,
        orbit_step_deg=step_deg)[:3]
    (R1, t1), (R2, t2) = poses[0], poses[1]
    im1, im2 = (torch.as_tensor(np.asarray(im, np.float32), device=dev) for im in images)

    def score(feats1, feats2):
        res = match_ratio_test(feats1.descriptors, feats2.descriptors, feats1.keypoints.mask,
                               feats2.keypoints.mask, ratio_threshold=RATIO)
        n = int(res.mask.sum())
        if n < 8:
            return 0, 0.0
        idx = res.indices[:n].long()
        kp1, kp2 = feats1.keypoints, feats2.keypoints
        p1 = torch.stack([kp1.xf[idx[:, 0]], kp1.yf[idx[:, 0]]], 1).cpu().numpy()
        p2 = torch.stack([kp2.xf[idx[:, 1]], kp2.yf[idx[:, 1]]], 1).cpu().numpy()
        inl = gt_epipolar_inliers(p1.astype(np.float64), p2.astype(np.float64), K, R1, t1, R2, t2)
        return n, float(inl.mean())

    cfg = ExtractorConfig(**EXTRACTOR)
    out = {"sift": score(extract_features(im1, cfg), extract_features(im2, cfg))}
    ext = SuperPointExtractor(weights)
    out["tinypoint"] = score(ext(im1, k=K_POINTS), ext(im2, k=K_POINTS))
    hyb = make_hybrid_extractor(k=K_POINTS, weights_path=weights)
    out["hybrid"] = score(hyb(im1), hyb(im2))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=float, nargs="*", default=list(STEPS))
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the CUDA card)")
    ap.add_argument("--weights", default="auto",
                    help="a save_flax_weights checkpoint (default: the committed TinyPoint)")
    args = ap.parse_args(argv)
    print(f"{'step':>6} | {'SIFT n':>7} {'inl%':>6} | {'TinyPoint n':>11} "
          f"{'inl%':>6} | {'hybrid n':>8} {'inl%':>6}")
    for s in args.steps:
        r = run_pair(s, device=args.device, weights=args.weights)
        (n_s, r_s), (n_t, r_t), (n_h, r_h) = (r[k] for k in EXTRACTORS)
        print(f"{s:6.0f} | {n_s:7d} {100*r_s:5.1f}% | {n_t:11d} {100*r_t:5.1f}%"
              f" | {n_h:8d} {100*r_h:5.1f}%", flush=True)


if __name__ == "__main__":
    main()
