#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — card name, ``nvidia-smi`` name and power limit, kernel build time
             (every ``csrc/*.cu`` built from the checkout, one nvcc each, in
             parallel).
2. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the main path's shapes and the extra regimes below, timed warm
             with CUDA events beside its bound, the plain version and one
             library call.
3. slice   — ``reconstruct_two_view`` on views 1 and 2 of the bench scene at
             the bench settings, through both kernels (their launch counts are
             zeroed just before the timed run and read just after); the pose is
             held to tolerances pinned beside the JAX package's CPU result, the
             frontend to the port's own CPU run on the same images, and RANSAC
             to the port's CPU run on the same uniforms.

The line before last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result line. Without a CUDA card, or without the rest of the repository
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense, without sparsity): memory bytes/s
# and FP32 (non-tensor) flop/s, by the variant the card's name reports.
_PEAKS = {
    "PCIe": (2.0e12, 51.2e12),
    "NVL": (3.9e12, 60.0e12),
    "SXM": (3.35e12, 67.0e12),
}

# Pins from the JAX package's reconstruct_two_view on the CPU on the same
# images and settings (tools/two_view_pins.py, RANSAC seeds 0-8):
#   rotation error 0.116-0.463 deg, translation-direction error 0.96-33.3 deg,
#   inliers 481-489, mean reprojection error 0.195-0.995 px
# (seed 5, the bench seed: 0.463 deg, 33.3 deg, 485, 0.995 px). The port draws
# other RANSAC samples (torch.Generator on the card), so each tolerance covers
# that seed spread with margin: about twice the worst rotation, the worst
# translation direction plus a third, the inlier range widened by ~3%, and
# 1.5x the worst reprojection error. The two-view baseline here is short, so
# the translation direction is the loosest of the four.
PIN_ROT_DEG = 1.0
PIN_TDIR_DEG = 45.0
PIN_INLIERS = (470, 505)
PIN_REPROJ_PX = 1.5

HARRIS_TOL = 1e-5      # max |kernel - plain| <= HARRIS_TOL * max |plain R|
MATCH_RTOL = 1e-4      # squared distances, relative
MATCH_ATOL = 1e-6
MATCH_TIE = 1e-5       # index may differ only where (second - best) <= MATCH_TIE * |best|

# The slice on the card against the port's own CPU run on the same images.
# Response maps agree to ~1e-6 of their range, so keypoint sets agree all but
# exactly. Descriptors differ where arctan2 or a bin floor lands one ulp apart
# (a pixel moves to the next orientation bin). Matches then flip where a
# query's distance ratio lies within that noise of the 0.85 threshold: on
# ~650 accepted matches a few percent of the set may change. RANSAC sees the
# same correspondences and uniforms on both sides.
KP_JACCARD = 0.99
DESC_ATOL = 1e-3
DESC_SHARE = 0.97
MATCH_JACCARD = 0.93
RANSAC_ROT_GAP_DEG = 0.05
RANSAC_INLIER_GAP = 5


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def _peaks(name: str):
    for key, val in _PEAKS.items():
        if key in name:
            return key, val
    return "SXM", _PEAKS["SXM"]


def _nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` warm calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _render_module():
    """``tests/render.py`` of this checkout, loaded by path: a ``tests``
    package installed elsewhere would shadow the repository's (it has no
    ``__init__.py``)."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "render.py")
    spec = importlib.util.spec_from_file_location("sfm_bench_render", path)
    if spec is None or not os.path.isfile(path):
        raise ImportError(f"{path} not found")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The bench's settings (bench.py:87-112): extractor and matcher keywords, the
# RANSAC seed; RansacConfig() gives its 5,967 hypotheses.
BENCH_EXTRACTOR = dict(num_interest_points=2500, ksize=3, gaussian_size=7, sigma=6.0,
                       alpha=0.05, feature_width=18, pyramid_level=3,
                       pyramid_scale_factor=1.1)
BENCH_MATCHER = dict(ratio_threshold=0.85, max_matches=2500)
BENCH_SEED = 5


def bench_pair():
    """Views 1 and 2 of the bench scene (bench.py::build_sequence), K, and the
    ground-truth relative pose (R, unit t)."""
    import numpy as np

    render_sequence = _render_module().render_sequence
    rng = np.random.default_rng(7)
    images, K, poses, _ = render_sequence(
        rng, num_views=10, num_points=600, img_hw=(360, 480), f=520.0,
        step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004),
    )
    (R1, t1), (R2, t2) = poses[1], poses[2]
    R = R2 @ R1.T
    t = t2 - R @ t1
    return (np.stack([images[1]] * 3, -1), np.stack([images[2]] * 3, -1), K,
            R, t / np.linalg.norm(t))


def pose_errors(R, t, R_gt, t_gt):
    """(rotation error, translation-direction error) in degrees."""
    import numpy as np

    dR = np.asarray(R, np.float64) @ R_gt.T
    rot = np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    t = np.asarray(t, np.float64)
    cos_t = np.dot(t, t_gt) / max(np.linalg.norm(t), 1e-12)
    return float(rot), float(np.degrees(np.arccos(np.clip(cos_t, -1.0, 1.0))))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def harris_phase(dev, peaks):
    """Harris kernel vs plain at the pyramid levels (B=2) and the 960x1280
    regime; returns the numbers of the main path's six launches."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK

    G, sigma, alpha = 7, 6.0, 0.05
    bw, fl = peaks
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(2, 360, 480), (2, 327, 436), (2, 297, 396), (1, 960, 1280)]
    rows, worst = [], 0.0
    for B, H, W in cases:
        img = torch.rand((B, H, W), generator=gen, device=dev)
        got = HK.harris_response_fused(img, G, sigma, alpha)
        ref = HK.harris_response(img, G, sigma, alpha)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        _check(bool(torch.isfinite(got).all()), f"harris {B}x{H}x{W}: non-finite")
        _check(err <= HARRIS_TOL * scale, f"harris {B}x{H}x{W}: max err {err} > {HARRIS_TOL} * {scale}")
        worst = max(worst, err / scale)
        px = B * H * W
        rows.append(dict(
            shape=[B, H, W], max_abs_err=err, max_abs_R=scale,
            ms=_cuda_ms(lambda: HK.harris_response_fused(img, G, sigma, alpha)),
            plain_ms=_cuda_ms(lambda: HK.harris_response(img, G, sigma, alpha)),
            bound_ms=max(8.0 * px / bw, px * (16 + 12 * G) / fl) * 1e3,
        ))
    _print({"phase": "harris", "tol_rel": HARRIS_TOL, "cases": rows})

    # The main path launches the kernel once per image and pyramid level
    # (B=1): sum one B=1 launch of each level, twice for the two images.
    ms = plain_ms = bound_ms = 0.0
    max_err = 0.0
    for H, W in [(360, 480), (327, 436), (297, 396)]:
        img = torch.rand((1, H, W), generator=gen, device=dev)
        got = HK.harris_response_fused(img, G, sigma, alpha)
        ref = HK.harris_response(img, G, sigma, alpha)
        err = float((got - ref).abs().max())
        _check(err <= HARRIS_TOL * float(ref.abs().max()), f"harris 1x{H}x{W}: max err {err}")
        max_err = max(max_err, err)
        ms += 2 * _cuda_ms(lambda: HK.harris_response_fused(img, G, sigma, alpha))
        plain_ms += 2 * _cuda_ms(lambda: HK.harris_response(img, G, sigma, alpha))
        bound_ms += 2 * max(8.0 * H * W / bw, H * W * (16 + 12 * G) / fl) * 1e3
    return dict(
        name="harris_response_fused", route="cuda",
        source="sfmfromscratch_tpu_torch/csrc/harris.cu",
        replaces="sfmfromscratch_tpu/ops/pallas/harris_kernel.py:68 (_harris_kernel), "
                 "sfmfromscratch_tpu/ops/pallas/harris_kernel.py:150 (_harris_tiled_kernel)",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None,
        per="two-view run: 2 images x 3 levels (360x480, 327x436, 297x396), B=1",
    )


def match_phase(dev, peaks):
    """Matcher kernel vs plain at the main path's shape, a batch of 9 pairs
    and a 6000-row database; returns the numbers of the main path's launch."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
    from sfmfromscratch_tpu_torch.utils.precision import f32_precision

    bw, fl = peaks
    gen = torch.Generator(device=dev).manual_seed(1)
    D = 128
    cases = [(1, 2499, 2499), (9, 2499, 2499), (1, 2499, 6000)]
    rows, main = [], None
    for B, n1, n2 in cases:
        # RootSIFT-like descriptors: non-negative, unit L2 norm.
        d1 = torch.rand((B, n1, D), generator=gen, device=dev) ** 2
        d2 = torch.rand((B, n2, D), generator=gen, device=dev) ** 2
        d1 = torch.sqrt(d1 / d1.sum(-1, keepdim=True))
        d2 = torch.sqrt(d2 / d2.sum(-1, keepdim=True))
        mask2 = torch.rand((B, n2), generator=gen, device=dev) > 0.1
        n1sq, n2sq = MK._norms(d1, d2, mask2)
        k1, k2, ki = MK.match_top2_fused(d1, d2, mask2)
        p1r, p2r, pi = MK.match_top2_plain(d1, d2, n2sq)
        p1 = torch.clamp_min(p1r + n1sq, 0.0)
        p2 = torch.clamp_min(p2r + n1sq, 0.0)
        torch.cuda.synchronize()
        _check(bool(torch.allclose(k1, p1, rtol=MATCH_RTOL, atol=MATCH_ATOL)), f"match {B}x{n1}x{n2}: dist1")
        _check(bool(torch.allclose(k2, p2, rtol=MATCH_RTOL, atol=MATCH_ATOL)), f"match {B}x{n1}x{n2}: dist2")
        differ = ki != pi
        near_tie = (p2r - p1r) <= MATCH_TIE * p1r.abs()
        n_differ, n_unexcused = int(differ.sum()), int((differ & ~near_tie).sum())
        _check(n_unexcused == 0, f"match {B}x{n1}x{n2}: {n_unexcused} index disagreements off ties")
        err = float(torch.maximum((k1 - p1).abs().max(), (k2 - p2).abs().max()))
        flops = 2.0 * B * n1 * n2 * D
        nbytes = 4.0 * (B * n1 * D + B * n2 * D + B * n2) + 12.0 * B * n1

        def library():
            with f32_precision():
                return torch.cdist(d1, d2).topk(2, dim=-1, largest=False)

        row = dict(
            shape=[B, n1, n2, D], max_abs_err=err, index_disagreements=n_differ,
            index_disagreements_off_ties=n_unexcused,
            ms=_cuda_ms(lambda: MK.match_top2_fused(d1, d2, mask2)),
            plain_ms=_cuda_ms(lambda: MK.match_top2_plain(d1, d2, n2sq), reps=5),
            library_ms=_cuda_ms(library, reps=5),
            bound_ms=max(nbytes / bw, flops / fl) * 1e3,
        )
        rows.append(row)
        if main is None:
            main = row
    _print({"phase": "match", "rtol": MATCH_RTOL, "atol": MATCH_ATOL, "tie_rel": MATCH_TIE,
            "cases": rows})
    return dict(
        name="match_top2_fused", route="cuda",
        source="sfmfromscratch_tpu_torch/csrc/match_top2.cu",
        replaces="sfmfromscratch_tpu/ops/pallas/match_kernel.py:37 (_match_kernel)",
        max_abs_err=main["max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by="operations", library_ms=main["library_ms"],
        library="torch.cdist + topk(2)",
        per="two-view run: one launch, B=1, 2499 x 2499 x 128",
    )


def slice_phase(dev):
    """reconstruct_two_view at the bench settings; returns the launch counts
    of the timed run."""
    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.config import ExtractorConfig, MatcherConfig, RansacConfig
    from sfmfromscratch_tpu_torch.geometry.ransac import ransac_essential_pose
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
    from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq
    from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner, matches_to_coords
    from sfmfromscratch_tpu_torch.pipeline.two_view import reconstruct_two_view

    im1, im2, K, R_gt, t_gt = bench_pair()
    ecfg = ExtractorConfig(**BENCH_EXTRACTOR)
    mcfg = MatcherConfig(**BENCH_MATCHER)
    rcfg = RansacConfig()   # 5,967 hypotheses
    _check(rcfg.num_iterations() == 5967, "RANSAC hypothesis count")

    def run():
        return reconstruct_two_view(im1, im2, K, extractor=ecfg, matcher=mcfg, ransac=rcfg,
                                    scale_factor=1.0, seed=BENCH_SEED, device=dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    HK.launches = 0
    MK.launches = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {"harris_response_fused": HK.launches, "match_top2_fused": MK.launches}

    M = mcfg.max_matches
    _check(launches["harris_response_fused"] > 0, "harris kernel not launched by the slice")
    _check(launches["match_top2_fused"] > 0, "match kernel not launched by the slice")
    _check(tuple(res.R.shape) == (3, 3) and tuple(res.t.shape) == (3,), "pose shapes")
    _check(res.points.shape[-1] == 3 and res.points.shape[0] <= M, "points shape")
    for name in ("R", "t", "points", "mean_reproj_error"):
        _check(bool(torch.isfinite(getattr(res, name)).all()), f"non-finite {name}")
    rot, tdir = pose_errors(res.R.cpu().numpy(), res.t.cpu().numpy(), R_gt, t_gt)
    inl = int(res.num_inliers)
    reproj = float(res.mean_reproj_error)
    _check(rot <= PIN_ROT_DEG, f"rotation error {rot} deg > {PIN_ROT_DEG}")
    _check(tdir <= PIN_TDIR_DEG, f"translation-direction error {tdir} deg > {PIN_TDIR_DEG}")
    _check(PIN_INLIERS[0] <= inl <= PIN_INLIERS[1], f"inliers {inl} outside {PIN_INLIERS}")
    _check(reproj <= PIN_REPROJ_PX, f"reprojection error {reproj} px > {PIN_REPROJ_PX}")
    _print({"phase": "slice", "cold_s": cold_s, "warm_s": warm_s, "launches": launches,
            "rot_err_deg": rot, "t_err_deg": tdir, "num_inliers": inl, "reproj_px": reproj,
            "num_matches": int(res.p1.shape[0]),
            "pins": {"rot_deg": PIN_ROT_DEG, "tdir_deg": PIN_TDIR_DEG,
                     "inliers": PIN_INLIERS, "reproj_px": PIN_REPROJ_PX}})

    # Stage times of one warm run, each ended by a synchronize.
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    fr, fr_ms = timed(lambda: FeatureRunner.run(im1, im2, ecfg, mcfg, scale_factor=1.0,
                                                    device=dev))
    (p1, p2, mask), _ = timed(lambda: matches_to_coords(fr.matches, fr.features1, fr.features2, M))
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    u = torch.rand((rcfg.num_iterations(), 8), generator=torch.Generator().manual_seed(BENCH_SEED))
    pose, ransac_ms = timed(lambda: ransac_essential_pose(
        None, p1, p2, Kt, Kt, mask, num_hypotheses=rcfg.num_iterations(),
        threshold=rcfg.epipolar_threshold, min_cheirality_frac=0.75, uniforms=u))
    A = torch.rand((rcfg.num_iterations(), 8, 9), device=dev)
    nullvec_ms = _cuda_ms(lambda: nullvec_lstsq(A), reps=5, warm=1)
    _print({"phase": "stages", "feature_runner_ms": fr_ms, "ransac_essential_pose_ms": ransac_ms,
            "nullvec_qr_5967x8x9_ms": nullvec_ms, "two_view_warm_ms": warm_s * 1e3})

    # The card against the port's own CPU run on the same inputs: the
    # frontend (keypoints, descriptors, matches) and RANSAC on the same
    # correspondences and uniforms. Numbers first, then the checks.
    fr_cpu = FeatureRunner.run(im1, im2, ecfg, mcfg, scale_factor=1.0, device="cpu")
    kp_jaccard, desc_close = [], []
    for fg, fc in ((fr.features1, fr_cpu.features1), (fr.features2, fr_cpu.features2)):
        kg, kc = fg.keypoints, fc.keypoints
        xg, yg, mg_ = kg.x.cpu(), kg.y.cpu(), kg.mask.cpu()
        sg = {(int(x), int(y)) for x, y, m in zip(xg, yg, mg_) if m}
        sc = {(int(x), int(y)) for x, y, m in zip(kc.x, kc.y, kc.mask) if m}
        kp_jaccard.append(len(sg & sc) / max(len(sg | sc), 1))
        # Descriptors of the slots holding the same keypoint on both sides.
        same = (xg == kc.x) & (yg == kc.y) & mg_ & kc.mask
        dd = (fg.descriptors.cpu() - fc.descriptors).abs().amax(-1)[same]
        desc_close.append(float((dd <= DESC_ATOL).float().mean()) if dd.numel() else 0.0)
    mg = {tuple(r) for r, m in zip(fr.matches.indices.cpu().tolist(), fr.matches.mask.cpu()) if m}
    mc = {tuple(r) for r, m in zip(fr_cpu.matches.indices.tolist(), fr_cpu.matches.mask) if m}
    match_jaccard = len(mg & mc) / max(len(mg | mc), 1)
    p1c, p2c, maskc = (x.cpu() for x in (p1, p2, mask))
    pose_cpu = ransac_essential_pose(
        None, p1c, p2c, Kt.cpu(), Kt.cpu(), maskc, num_hypotheses=rcfg.num_iterations(),
        threshold=rcfg.epipolar_threshold, min_cheirality_frac=0.75, uniforms=u)
    dR = pose.R.cpu().double().numpy() @ pose_cpu.R.double().numpy().T
    r_gap = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
    inl_gap = abs(int(pose.num_inliers) - int(pose_cpu.num_inliers))
    _print({"phase": "card_vs_cpu", "keypoint_jaccard": kp_jaccard,
            "descriptor_rows_within_atol": desc_close, "desc_atol": DESC_ATOL,
            "match_jaccard": match_jaccard, "matches_card": len(mg), "matches_cpu": len(mc),
            "ransac_rot_gap_deg": r_gap, "ransac_inlier_gap": inl_gap})
    _check(min(kp_jaccard) >= KP_JACCARD, f"keypoint agreement card vs CPU {kp_jaccard} < {KP_JACCARD}")
    _check(min(desc_close) >= DESC_SHARE, f"descriptor agreement card vs CPU {desc_close} < {DESC_SHARE}")
    _check(match_jaccard >= MATCH_JACCARD, f"match agreement card vs CPU {match_jaccard} < {MATCH_JACCARD}")
    _check(r_gap <= RANSAC_ROT_GAP_DEG, f"RANSAC card vs CPU rotation gap {r_gap} deg > {RANSAC_ROT_GAP_DEG}")
    _check(inl_gap <= RANSAC_INLIER_GAP, f"RANSAC card vs CPU inlier gap {inl_gap} > {RANSAC_INLIER_GAP}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from sfmfromscratch_tpu_torch.ops.cuda.build import build_all
        _render_module()   # the bench scene renderer
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})", file=sys.stderr)
        return 2

    try:
        dev = torch.device("cuda")
        name = torch.cuda.get_device_name(0)
        smi = _nvidia_smi()
        t0 = time.perf_counter()
        build_all()
        build_s = time.perf_counter() - t0
        variant, peaks = _peaks(name)
        print(smi, flush=True)
        _print({"phase": "device", "name": name, "nvidia_smi": smi, "build_s": build_s,
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "peaks": {"variant": variant, "bytes_per_s": peaks[0], "fp32_flops": peaks[1]}})

        kernels = [harris_phase(dev, peaks), match_phase(dev, peaks)]
        launches = slice_phase(dev)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        print(smi, flush=True)
        _print({"kernels": kernels})
        _print({"ok": True, "device": {"platform": "gpu", "kind": name,
                                       "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 - top level: report and fail
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
