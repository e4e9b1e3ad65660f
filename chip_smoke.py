#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--only-kernels]

Phases, each printing JSON lines:

1. device  — card name, ``nvidia-smi`` name and power limit, kernel build time
             (every ``csrc/*.cu`` built from the checkout, one nvcc each, in
             parallel) and nvcc's register, shared-memory and spill report.
2. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the engine's shapes (Harris B=10 per pyramid level, matcher
             B=9 pairs, f32 and bf16 modes), the two-view shapes, the extra
             regimes below and an exact-tie case, beside its bound, the plain
             version and one library call. Three times per kernel and shape:
             ``device_ms``, the kernel's own time from ``torch.profiler``
             (its CUDA activity per call over a warm window; the number the
             kernel line reports as ``ms``); ``graph_ms``, a CUDA-graph
             replay of the bare launches, as a cross-check; and ``call_ms``,
             back-to-back wrapper calls between CUDA events, the time a
             caller pays per call (host path included). ``--only-kernels``
             stops after this phase and prints no result line.
3. slice   — ``reconstruct_two_view`` on views 1 and 2 of the bench scene at
             the bench settings, through both kernels (their launch counts are
             zeroed just before the timed run and read just after); the pose is
             held to tolerances pinned beside the JAX package's CPU result, the
             frontend to the port's own CPU run on the same images, and RANSAC
             to the port's CPU run on the same uniforms.
4. engine  — ``SfmEngine`` on ``bench.py``'s 10-view sequence at its
             configuration, once cold and once warm; the launch counts are
             zeroed before the warm run and read after it. The result is held
             to pins beside the JAX engine's CPU spread
             (``tools/engine_pins.py``), the card's final BA problem is
             solved again on the CPU, and the cold and warm runs must end
             BA at the same error.
5. global  — ``GlobalSfmEngine`` (window 3, 1,024 relative-pose hypotheses,
             2 BA rounds) on a 20-view 4 deg/view orbit at the bench widths,
             cold then warm, launches counted over the warm run; held to pins
             beside the JAX engine's CPU spread (``tools/global_pins.py``),
             its last BA problem solved again on the CPU.
6. orbit   — ``SfmEngine`` plain, then with ``chain_refresh="averaging"``,
             on the 20-view 0.8 deg/view orbit of
             ``tests/test_pipeline.py::test_chain_refresh_de_bends_orbit`` at
             that test's settings and gates; launches counted per run.
7. host    — the host chain and its options on the bench sequence:
             ``cli.py reconstruct`` at window 3 with local BA, a pair cache
             and PLY/COLMAP export, cold then resumed from the cache;
             distance association; pose recovery over a flat frame with
             checkpoints, the last loaded back. Launches counted per run;
             held to pins beside the JAX package's CPU spread
             (``tools/host_pins.py``).
8. scale   — the global engine's scale-out path and focal self-calibration:
             the CLI on a 47-view 1.5 deg/view orbit with auto keyframes
             (the other frames registered by batched PnP), then again with
             the final BA streamed through the block store, resumed from the
             first run's pair cache; retrieval pairs on a shuffled 12-view
             planes scene; ``bundle_adjust_selfcal`` on a focal-observable
             problem (card against CPU) and the CLI with ``--refine-focal``.
             Launches counted per run; held to the JAX tests' gates and to
             pins beside the JAX package's CPU spread
             (``tools/scale_pins.py``).

9. extractors — the engines' other front ends and fixed-count RANSAC at the
             bench widths: ``SfmEngine`` with the DoG front end, with the
             TinyPoint hybrid, and with ``RansacConfig(adaptive=False,
             pnp_solver="dlt")`` on the bench sequence; ``GlobalSfmEngine``
             with fixed-count RANSAC on the global phase's orbit cut to 10
             views; the full-width SuperPoint on the card against the CPU,
             with the matcher kernel at D=256 on its descriptors; DLT PnP
             card against CPU. Launches counted per run; held to pins beside
             the JAX package's CPU spread (``tools/extractor_pins.py``).
10. mesh   — ``parallel/`` on ``torch.distributed``: a 1-rank NCCL group,
             then 2 gloo ranks on the one card (sharded BA and selfcal,
             ``tp_match_ratio_test``, both engines with ``mesh=``); held to
             pins beside the JAX package's CPU mesh (``tools/mesh_pins.py``).
11. compat — the reference's class API (``compat.py``) at the bench widths:
             ``NaiveSIFT`` and ``ScaleRotInvSIFT`` (card against CPU),
             ``NNRatioFeatureMatcher``, ``FeatureRunner``, ``CameraPose``
             with the canonical and a non-canonical base, triangulation,
             ``PnPRansac``/``PnP``, ``BundleAdjustment`` on the engine
             phase's problem (card against CPU), ``SFMRunner`` on the bench
             sequence rendered at 720x960; the engine on images of two sizes
             and on two images; an ``AsyncCheckpointer`` round trip.
             Launches counted per run; held to pins beside the JAX package's
             CPU spread (``tools/compat_pins.py``). The global phase's line
             also says whether its tracks came from the C++ union-find
             (``native_tracks``), checked against the numpy one.

The line before last is ``{"kernels": [...]}``, with each kernel's launch
counts on every path (engine, two-view, global, orbit, host, scale, per
run of the extractors, mesh and compat phases), the f32 matcher's row with
its D=256 case (``superpoint_d256``); the last is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result line. Without a CUDA card, or without the rest of the repository
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense, without sparsity), by the
# variant the card's name reports: memory bytes/s, FP32 (non-tensor) flop/s,
# and bf16 tensor-core flop/s (half the data sheets' rates with sparsity).
_PEAKS = {
    "PCIe": (2.0e12, 51.2e12, 756.0e12),
    "NVL": (3.9e12, 60.0e12, 835.0e12),
    "SXM": (3.35e12, 67.0e12, 989.0e12),
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

# Engine pins from the JAX engine on the CPU on the same sequence and
# configuration (tools/engine_pins.py, config.seed 0-4, 9 cameras each):
#   ATE over trajectory extent 0.0049-0.0619, post-BA mean reprojection error
#   0.113-0.276 px, tracks 2967-3384.
# The port draws other RANSAC samples, so each pin covers that seed spread with
# margin: 1.6x the worst ATE and reprojection error, and two thirds of the
# fewest tracks (a chain that links badly loses tracks long before it loses
# cameras).
PIN_ENGINE_CAMERAS = 9
PIN_ENGINE_ATE = 0.10
PIN_ENGINE_REPROJ_PX = 0.45
PIN_ENGINE_MIN_TRACKS = 2000
# The warm run's launches: Harris once per pyramid level for the 10-image
# batch, the matcher once for the 9 pairs.
ENGINE_LAUNCHES = {"harris_response_fused": 3, "match_top2_fused": 1}
# The card's final BA problem solved again on the CPU. The engine fixes no
# camera, so LM damps a 7-dof similarity gauge, and its accept/reject path
# parts with rounding once steps along the gauge dominate: the first chip run
# (PR 2) stopped after 19 iterations on the card and 27 on the CPU, with final
# errors 1.3% apart (0.1188 and 0.1173 px). So the first BA_PREFIX iterations
# must agree in cost to BA_PREFIX_RTOL, and the full runs' final errors to
# BA_FINAL_RTOL. The card's segment sums add in a fixed order, so the card
# lands on the same final error in every run, and the cold and warm runs must
# agree exactly. With atomic adds the path was a draw: eight runs of one
# problem ended anywhere in 0.1174-0.1190 px (tools/ba_repro.py), and one
# run of this phase at 0.1243 px, 6% from the CPU.
BA_PREFIX = 3
BA_PREFIX_RTOL = 1e-3
BA_FINAL_RTOL = 0.05

# Global engine pins from the JAX engine on the CPU on the same scene and
# configuration (tools/global_pins.py, config.seed 0-4, 20 cameras each):
#   ATE over trajectory extent 0.00072-0.00094, post-BA mean reprojection
#   error 0.239-0.243 px, tracks 3451-3529, tracks of 3 views or more
#   1221-1250.
# The port draws other RANSAC samples. The spread is narrow here (every edge
# has hundreds of inliers), so the pins leave room for the draws and for the
# card's summation order: 5x the worst ATE (still 16x below the 8% gate of
# tests/test_global_sfm.py), 1.25x the worst error, and 85% of the fewest
# tracks and of the fewest 3-view tracks.
PIN_GLOBAL_CAMERAS = 20
PIN_GLOBAL_ATE = 0.005
PIN_GLOBAL_REPROJ_PX = 0.30
PIN_GLOBAL_MIN_TRACKS = 2900
PIN_GLOBAL_MIN_TRACKS_3 = 1030
# Warm run: Harris once per pyramid level for the 20-image batch, the
# matcher once for the 19 + 18 + 17 window pairs.
GLOBAL_LAUNCHES = {"harris_response_fused": 3, "match_top2_fused": 1}
# The orbit phase's gates are the JAX test's own: the plain chain bends
# (ATE over extent above 0.05; JAX on the CPU gives 0.081-0.223 over
# config.seed 0-4, tools/global_pins.py), the refresh removes the bend
# (below 0.03; JAX 0.0063-0.0131) at under 0.5 px after BA (JAX 0.160-0.177).
ORBIT_PLAIN_MIN_ATE = 0.05
ORBIT_REFRESH_MAX_ATE = 0.03
ORBIT_REFRESH_MAX_REPROJ_PX = 0.5
ORBIT_LAUNCHES = {"harris_response_fused": 2, "match_top2_fused": 1}

HARRIS_TOL = 1e-5      # max |kernel - plain| <= HARRIS_TOL * max |plain R|
MATCH_RTOL = 1e-4      # squared distances, relative
MATCH_ATOL = 1e-6
MATCH_TIE = 1e-5       # index may differ only where (second - best) <= MATCH_TIE * |best|
# Matcher shapes: the engine's 9 pairs, the two-view's pair, a 6000-row
# database, the global engine's 54 window pairs, the orbit's 19 pairs of 600,
# the host phase's 24 window pairs and the scale phase's 46 consecutive pairs
# of the keyframe flow selection; each in f32 and in the bf16 mode
# (bf16=True).
MATCH_CASES = [(9, 2499, 2499), (1, 2499, 2499), (1, 2499, 6000), (54, 2499, 2499),
               (19, 600, 600), (24, 2499, 2499), (46, 2499, 2499), (1, 2499, 1250)]
MATCH_MODES = (False, True)
# Checked only: a one-row database (second best is the sentinel), ragged
# tiles on both sides, and widths the wrapper pads to a multiple of 32.
MATCH_EDGE_CASES = [(2, 37, 1, 100), (3, 130, 129, 64), (1, 5, 300, 40)]

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


def _peaks(name: str) -> dict:
    variant = next((key for key in _PEAKS if key in name), "SXM")
    bw, fp32, bf16 = _PEAKS[variant]
    return {"variant": variant, "bytes_per_s": bw, "fp32_flops": fp32, "bf16_flops": bf16}


def _nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of one call of ``fn`` in ms over ``reps`` warm back-to-back
    calls, between two CUDA events. Where the host enqueues more slowly than
    the device runs, this is the host's time per call: the ``call_ms`` of a
    wrapper, as the engine pays it."""
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


def _profiled_ms(fn, kernels, reps: int = 20, warm: int = 3):
    """The kernel's own device time per call of ``fn`` in ms: the CUDA
    activity of every kernel whose name contains one of ``kernels``, traced by
    ``torch.profiler`` over ``reps`` warm calls, summed and divided by
    ``reps``. Returns (ms or None, kernel activities seen)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, seen = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(k in e.name for k in kernels):
            total_us += e.time_range.elapsed_us()
            seen += 1
    return (total_us / reps * 1e-3 if seen else None), seen


def _graph_ms(fn, reps: int = 20, replays: int = 5):
    """Device time per call of ``fn`` in ms from replays of one CUDA graph
    that holds ``reps`` calls, between two CUDA events: no host time between
    launches, so it cross-checks ``_profiled_ms`` (it also holds any small
    kernels ``fn`` launches besides the one under test). Returns (ms or None,
    error text or None)."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * replays), None
    except Exception as e:  # noqa: BLE001 - reported beside the other sources
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {e}"


def _kernel_times(wrapper, launch, kernels) -> dict:
    """``device_ms`` (profiler: the named kernels' time per wrapper call),
    ``graph_ms`` (CUDA-graph replay of ``launch``, the bare kernel launch) and
    ``call_ms`` (``_cuda_ms`` of ``wrapper``, the entry point the engine
    calls)."""
    device_ms, seen = _profiled_ms(wrapper, kernels)
    graph_ms, graph_error = _graph_ms(launch)
    out = dict(device_ms=device_ms, kernel_activities=seen, graph_ms=graph_ms,
               call_ms=_cuda_ms(wrapper))
    if graph_error:
        out["graph_error"] = graph_error
    return out


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
BENCH_BA = dict(ftol=1e-3)
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


def bench_sequence(out_dir: str, num_views: int = 10):
    """Write ``bench.py::build_sequence``'s scene as ``1.jpg..N.jpg`` into
    ``out_dir`` (``tests/render.write_sequence``); returns (K, ground-truth
    world-to-camera poses)."""
    import numpy as np

    mod = _render_module()
    images, K, poses, _ = mod.render_sequence(
        np.random.default_rng(7), num_views=num_views, num_points=600, img_hw=(360, 480),
        f=520.0, step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004),
    )
    mod.write_sequence(out_dir, images)
    return K, poses


# The global engine's drive: the orbit of the documented global drive (4
# deg/view, 300 points, 360x480, f=520) at a depth of 20 views.
GLOBAL_VIEWS = 20
# The orbit that bends the PnP chain (tests/test_pipeline.py::
# test_chain_refresh_de_bends_orbit): 20 views at 0.8 deg/view, at that
# test's extractor and matcher settings.
ORBIT_VIEWS = 20
ORBIT_EXTRACTOR = dict(num_interest_points=600, ksize=3, gaussian_size=7, sigma=3.0,
                       alpha=0.05, feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2)
ORBIT_MATCHER = dict(ratio_threshold=0.85, max_matches=600)


def orbit_sequence(out_dir: str, num_views: int, step_deg: float):
    """Write ``render_sequence(default_rng(7), num_views, 300 points, 360x480,
    f=520, orbit_step_deg=step_deg)`` as ``1.jpg..N.jpg`` into ``out_dir``;
    returns (K, ground-truth world-to-camera poses)."""
    import numpy as np

    mod = _render_module()
    images, K, poses, _ = mod.render_sequence(
        np.random.default_rng(7), num_views=num_views, num_points=300, img_hw=(360, 480),
        f=520.0, orbit_step_deg=step_deg,
    )
    mod.write_sequence(out_dir, images)
    return K, poses


# The host phase: the bench sequence through the CLI, whose defaults are the
# bench widths, at window 3 with a local BA every 3 cameras and a pair cache.
HOST_VIEWS = 10
HOST_CLI = ["--max-img", str(HOST_VIEWS), "--focal", "520", "--scale-factor", "1.0",
            "--pair-window", "3", "--local-ba-every", "3"]
# The pose-recovery run replaces this image with a flat gray frame: no
# keypoint, so the PnP of pairs (5, 6) and (6, 7) fails.
HOST_FLAT_IMAGE = 6
# Host pins from the JAX package on the CPU on the same sequence and
# configurations (tools/host_pins.py, config.seed 0-4, 9 cameras in every run):
#   cli (cold, then resumed from its cache): ATE over trajectory extent
#     0.083-0.244, post-BA mean reprojection error 0.404-1.288 px, tracks
#     2333-3231, observations per track 1.655-1.736;
#   distance: ATE/extent 0.060-0.243, 0.418-0.526 px, tracks 4131-4814,
#     1.641-1.660 observations per track;
#   recover (flat image 6, both pairs through it recovered): ATE/extent
#     0.292-0.319, 0.835-4.873 px after BA (16.3-28.4 px before), tracks
#     2246-2457, 1.479-1.550 observations per track.
# The margins are the engine pins': 1.6x the worst ATE and error, two thirds
# of the fewest tracks, and 85% of the fewest observations per track.
PIN_HOST = {
    "cli": dict(ate_over_extent=0.39, reproj_px=2.06, min_tracks=1555, min_obs_per_track=1.40),
    "distance": dict(ate_over_extent=0.39, reproj_px=0.84, min_tracks=2754,
                     min_obs_per_track=1.39),
    "recover": dict(ate_over_extent=0.51, reproj_px=7.80, min_tracks=1497,
                    min_obs_per_track=1.25),
}
# 10 views at window 3: 9 + 8 + 7 pairs in one matcher launch.
HOST_PAIRS = 24
HOST_LAUNCHES = {"harris_response_fused": 3, "match_top2_fused": 1,
                 "match_top2_fused(bf16=True)": 0}
HOST_RESUME_LAUNCHES = dict(HOST_LAUNCHES, match_top2_fused=0)


# The scale phase: the global engine's scale-out path at the bench widths.
# The dense orbit is the documented global drive's 47 views at 1.5 deg/view
# (TempleRing scale), reconstructed from flow-selected keyframes; the other
# frames register by batched PnP. The default flow target (5% of the
# diagonal, 30 px) picks 4 keyframes of 47, ~15 frames (22 deg) apart,
# beyond what the sprite renderer's patches match: JAX then fails the gates
# (19 failed registrations, ATE/extent 0.30 at seed 0; JAX, CPU;
# tools/scale_pins.py --flow-px 0). A 7.5 px target picks 13, a keyframe
# every ~4 frames (6 deg).
SCALE_VIEWS = 47
SCALE_STEP_DEG = 1.5
SCALE_FLOW_PX = 7.5
SCALE_CLI = ["--max-img", str(SCALE_VIEWS), "--pipeline", "global", "--keyframe-step", "auto",
             "--keyframe-flow-px", str(SCALE_FLOW_PX), "--focal", "520", "--scale-factor", "1.0"]
# The same command with the final BA streamed: 47 cameras in blocks of 16
# give 3 blocks, solved 2 at a time.
SCALE_STREAM = ["--stream-ba-window", "2", "--stream-ba-block-cams", "16"]
# The unordered set of tests/test_global_sfm.py::test_global_retrieval_unordered
# (12 planes views 10 deg apart, shuffled) at 360x480, matched by retrieval.
PLANES_VIEWS = 12
RETRIEVAL_ENGINE = dict(pair_mode="retrieval", retrieval_k=4, rel_num_hypotheses=512)
# The keyframes run launches Harris once per level for the 47 images and the
# matcher three times: the flow selection's consecutive pairs, the keyframe
# window pairs and the registration pairs (the stream run resumes the
# keyframe pairs from the cache: two). Retrieval and the selfcal CLI launch
# as the engine does: Harris once per pyramid level, the matcher once.
SCALE_LAUNCHES = {"harris_response_fused": 3, "match_top2_fused": 3}
SELFCAL_LAUNCHES = {"harris_response_fused": 2, "match_top2_fused": 1}   # 2 pyramid levels
# Scale pins from the JAX package on the CPU on the same scenes and
# configurations (tools/scale_pins.py, config.seed 0-4; every JAX run passed
# every gate of this phase):
#   keyframes: 47 cameras, 13 keyframes, no failed registration, ATE over
#     extent 0.00068-0.00087, 0.3313-0.3347 px after BA, tracks 1800-1822;
#   stream: ATE/extent 0.00109-0.00153, 0.3356-0.3575 px, tracks 1784-1835,
#     4 windows, peak resident observations 7968-8096 of 11651-11822;
#   retrieval: 12 cameras, 28-29 edges, ATE/extent 0.00048-0.00055,
#     0.2068-0.2099 px, tracks 4021-4058.
# The margins are the engine pins': 1.6x the worst ATE and error, two thirds
# of the fewest tracks.
PIN_SCALE = {
    "keyframes": dict(ate_over_extent=0.0014, reproj_px=0.54, min_tracks=1200),
    "stream": dict(ate_over_extent=0.0025, reproj_px=0.58, min_tracks=1189),
    "retrieval": dict(ate_over_extent=0.0009, reproj_px=0.34, min_tracks=2681),
}
# The incremental CLI with focal self-calibration at the true focal, on the
# scene of tests/test_parallel.py::test_engine_selfcal_on_mesh (4 views, 110
# points, 240x320, f=400) at that test's extractor and RANSAC settings. On
# the bench sequence a shared focal is weakly observable: JAX lands at
# scales 1.009-1.183 over config.seed 0-4, two of them outside the gate
# |s - 1| < 0.05 (JAX, CPU; tools/scale_pins.py --runs selfcal_bench).
SELFCAL_VIEWS = 4
SELFCAL_CLI = ["--max-img", str(SELFCAL_VIEWS), "--focal", "400", "--scale-factor", "1.0",
               "--num-interest-points", "400", "--sigma", "3", "--feature-width", "16",
               "--pyramid-level", "2", "--pyramid-scale-factor", "1.2",
               "--ransac-iterations", "384", "--refine-focal"]


# The extractors phase: the engines' other front ends and fixed-count
# RANSAC at the bench widths on the bench sequence, and the global engine's
# fixed-count relative poses on the global phase's orbit cut to 10 views (its
# 24 window pairs x 5,967 fixed-count F-RANSAC hypotheses; 20 views would
# take 51 pairs).
EXTRACTOR_VIEWS = 10
HYBRID_K = 2500
FIXED_RANSAC = dict(adaptive=False, pnp_solver="dlt")
GLOBAL_FIXED_VIEWS = 10
SUPERPOINT_K = 2500
EXTRACTOR_LAUNCHES = {
    "dog": {"harris_response_fused": 0, "match_top2_fused": 1},
    "hybrid": {"harris_response_fused": 0, "match_top2_fused": 1},
    "fixed": {"harris_response_fused": 3, "match_top2_fused": 1},
    "global_fixed": {"harris_response_fused": 3, "match_top2_fused": 1},
}
# JAX on the CPU (tools/extractor_pins.py, every camera in every run): ATE
# over extent, post-BA reprojection error, tracks
#   dog,    seeds 0-29: 0.0068-0.088,   0.132-0.249 px, 2014-2516
#   hybrid, seeds 0-29: 0.0075-0.135,   0.111-0.261 px,  919-1102
#   fixed,  seeds 0-14: 0.0039-0.050,   0.112-0.184 px, 2826-3368
#   global_fixed, 0-14: 0.0011-0.0018,  0.217-0.230 px, 1695-1757
# Seeds 0-4 alone missed the tail of the adaptive bootstrap's translation
# direction on the short first baseline (the port on the CPU reached 0.136
# and the card 0.078 where JAX's seeds 0-4 stopped at 0.039 and 0.036; JAX
# reaches 0.088 and 0.135 at seeds 22 and 18; tools/bootstrap_spread.py
# shows both packages draw from one distribution), so those runs are pinned
# over more seeds. The incremental runs take the engine phase's margins
# (1.6x the worst ATE and error, two thirds of the fewest tracks), the
# global run the global phase's (5x, 1.25x, 85%).
PIN_EXTRACTORS = {
    "dog": dict(ate_over_extent=0.141, reproj_px=0.40, min_tracks=1343),
    "hybrid": dict(ate_over_extent=0.217, reproj_px=0.42, min_tracks=613),
    "fixed": dict(ate_over_extent=0.081, reproj_px=0.294, min_tracks=1884),
    "global_fixed": dict(ate_over_extent=0.0089, reproj_px=0.287, min_tracks=1440),
}
# Full SuperPoint on the card against the CPU (TF32 off on both): the
# heatmaps agree to float32 rounding, so keypoint sets part only where two
# scores within that rounding straddle the top-k cut or an NMS window, and
# shared keypoints' descriptors agree to rounding.
SP_KP_JACCARD = 0.97
SP_DESC_COSINE = 0.999
# DLT PnP on the card against the CPU on the same 5,967 samples: eigh on the
# card and in LAPACK round differently, so a hypothesis at the 8 px gate may
# gain or lose a point and the winner may change; the polished poses agree.
DLT_INLIER_GAP = 3
DLT_CARD_CPU_ROT_DEG = 0.05
DLT_ROT_ERR_DEG = 0.5


# The mesh phase: ranks that share the one card over gloo (NCCL refuses two
# ranks on one GPU), plus a 1-rank NCCL group. The global run is the
# extractors phase's 10-view cut of the global orbit, its final BA streamed
# over 3 blocks of 4 cameras, 2 resident at a time.
MESH_RANKS = 2
MESH_GLOBAL_VIEWS = GLOBAL_FIXED_VIEWS
MESH_STREAM = dict(stream_ba_window=2, stream_ba_block_cams=4)
# JAX on its 8-device virtual CPU mesh (tools/mesh_pins.py, seeds 0-4), the
# global run with the stream: ATE over extent 0.0012-0.0103, 0.226-0.382 px
# after BA, 1711-1765 tracks, 4 windows (seed 0 the outlier of each); its
# engine run 0.0044-0.0597, 0.119-0.323 px, 2720-3368 tracks, inside the
# engine phase's pins, which the mesh engine run keeps. The global run takes
# the global phase's margins: 5x the worst ATE, 1.25x the worst error, 85%
# of the fewest tracks.
PIN_MESH_GLOBAL = dict(ate_over_extent=0.0515, reproj_px=0.478, min_tracks=1454)
MESH_LIMIT_S = 240              # the groups of ranks, spawn to exit
# The pair-sharded RANSAC against the unsharded call: on the CPU the same
# bits (tests/test_torch_parallel.py); on the card the inlier sets, counts,
# cheirality flags and the generator state are the same bits, and R, t and F
# agree to float32 rounding: CUDA's batched products and row reductions pick
# their split by the batch's shape, and a shard is a smaller batch (on an
# NVIDIA H100 80GB HBM3: at most 3.2e-6 in R, 2.3e-5 in the unit t, 2.5e-6
# in F).
MESH_RANSAC_FLOAT_GAP = 1e-4
MESH_COLLECTIVE_TIMEOUT_S = 120
# Launches per rank: the engine's features shard by image (B=5 per rank at
# each of 3 pyramid levels), its matcher runs whole on every rank; the
# global run likewise; tp_match launches the matcher on the rank's shard.
MESH_LAUNCHES = {
    "tp_match": {"harris_response_fused": 0, "match_top2_fused": 1,
                 "match_top2_fused(bf16=True)": 0},
    "engine": {"harris_response_fused": 3, "match_top2_fused": 1,
               "match_top2_fused(bf16=True)": 0},
    "global": {"harris_response_fused": 3, "match_top2_fused": 1,
               "match_top2_fused(bf16=True)": 0},
}


# The compat phase: the reference's class API (compat.py) and the engine's
# odd inputs at the bench widths.
COMPAT_VIEWS = 10
MIXED_PAD = 16
# Pins from the JAX package on the CPU (tools/compat_pins.py, 9 cameras in
# every run; config.seed 0-14 for sfmrunner and mixed: seeds 0-4 missed the
# bootstrap's tail, 0.158 and 0.121 of extent at seeds 11 and 5):
#   sfmrunner (SFMRunner's configuration on the bench sequence rendered at
#     720x960, f=1040, prescaled by 0.5): ATE over extent 0.0091-0.1578,
#     post-BA error 0.081-0.306 px, tracks 3033-3547;
#   mixed (the bench configuration, view 2 padded by 16 px, each image
#     extracted on its own): 0.0045-0.1215, 0.115-0.375 px, tracks 2829-3389;
#   two_image (SfmEngine(max_img=2) on the slice phase's pair, seeds 0-4):
#     rotation error 0.167-0.341 deg, translation direction 2.5-24.5 deg,
#     inside the slice phase's pins, which the two-image run keeps.
# The margins are the engine pins': 1.6x the worst ATE and error, two thirds
# of the fewest tracks.
PIN_COMPAT = {
    "sfmrunner": dict(ate_over_extent=0.253, reproj_px=0.489, min_tracks=2022),
    "mixed": dict(ate_over_extent=0.195, reproj_px=0.601, min_tracks=1886),
}
COMPAT_LAUNCHES = {
    "naive_sift": {"harris_response_fused": 1, "match_top2_fused": 0},
    "scale_rot_inv_sift": {"harris_response_fused": 3, "match_top2_fused": 0},
    "nn_ratio_matcher": {"harris_response_fused": 0, "match_top2_fused": 1},
    "feature_runner": {"harris_response_fused": 6, "match_top2_fused": 1},
    "sfmrunner": {"harris_response_fused": 3, "match_top2_fused": 1},
    "mixed": {"harris_response_fused": 30, "match_top2_fused": 1},
    "two_image": {"harris_response_fused": 3, "match_top2_fused": 1},
}
#   two_view (the compat chain on the slice phase's pair at the bench widths,
#     RANSAC seeds 0-8: find_inliers, then ransac_camera_motion on its
#     inliers): F inliers 471-485; canonical base rotation error 0.07-0.45
#     deg, translation direction 2.5-21.6 deg; base at view 1's true pose
#     0.07-0.76 deg, 6.0-21.6 deg, 0.00-0.51 deg from the canonical pose;
#     triangulated inliers 0.19-0.91 px; PnPRansac and PnP on them 0.003-0.097
#     deg and 0.7-6.1 deg (translation direction) from the RANSAC pose. On
#     every match instead of the F inliers, ransac_camera_motion's
#     min_cheirality_frac=1.0 finds no hypothesis with every match in front
#     and falls back to the most points in front: 8.5-49.9 deg in JAX too,
#     so the phase filters first.
# The poses keep the slice phase's pins (the canonical-to-base gap within
# twice PIN_ROT_DEG); the F inliers 85% of JAX's fewest; PnP 1.6x JAX's
# widest gaps.
COMPAT_MIN_F_INLIERS = 400
COMPAT_PNP_ROT_GAP_DEG = 0.16
COMPAT_PNP_TDIR_GAP_DEG = 10.0
COMPAT_TRI_RTOL = 1e-3


def scale_cli_argv(seq: str, cache: str, *extra):
    """The scale phase's global ``reconstruct`` command line (both packages'
    CLIs take it)."""
    return ["reconstruct", seq, *SCALE_CLI, "--pair-cache-dir", cache, *extra]


def shuffled_planes(out_dir: str):
    """Write ``render_planes(default_rng(3), 12 views, 10 deg/view)`` at
    360x480, shuffled by the permutation the same generator draws next, as
    ``1.jpg..12.jpg`` into ``out_dir``; returns (K, ground-truth poses in file
    order)."""
    import numpy as np

    mod = _render_module()
    rng = np.random.default_rng(3)
    images, K, poses, _ = mod.render_planes(rng, num_views=PLANES_VIEWS, img_hw=(360, 480),
                                            orbit_step_deg=10.0)
    perm = rng.permutation(len(images))
    mod.write_sequence(out_dir, [images[p] for p in perm])
    return K, [poses[p] for p in perm]


def selfcal_sequence(out_dir: str):
    """Write ``render_sequence(default_rng(5), 4 views, 110 points)`` (240x320,
    f=400) as ``1.jpg..4.jpg`` into ``out_dir``; returns (K, poses)."""
    import numpy as np

    mod = _render_module()
    images, K, poses, _ = mod.render_sequence(np.random.default_rng(5), num_views=SELFCAL_VIEWS,
                                              num_points=110)
    mod.write_sequence(out_dir, images)
    return K, poses


def focal_observable_arrays(rng, focal_error: float = 1.06):
    """``tests/test_ba.py::_focal_observable_problem`` as the arguments of
    ``make_problem``: 8 cameras with rotation and forward/lateral motion, 300
    points, 0.3 px noise, K wrong by ``focal_error``, camera 0 frozen."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    C, Pn = 8, 300
    K_true = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = np.stack([rng.uniform(-3, 3, Pn), rng.uniform(-2, 2, Pn),
                  rng.uniform(3, 12, Pn)], 1)
    cams = []
    for c in range(C):
        rv = np.array([0.05, -0.12, 0.03]) * c
        t = np.array([-0.5 * c, 0.05 * c, 0.3 * c])
        cams.append((Rotation.from_rotvec(rv).as_matrix(), t, rv))
    obs_cam, obs_pt, obs_xy = [], [], []
    for ci, (R, t, _) in enumerate(cams):
        pc = X @ R.T + t
        pix = pc @ K_true.T
        uv = pix[:, :2] / pix[:, 2:3]
        for pi in range(Pn):
            if pc[pi, 2] > 0.5 and 0 < uv[pi, 0] < 640 and 0 < uv[pi, 1] < 480:
                obs_cam.append(ci)
                obs_pt.append(pi)
                obs_xy.append(uv[pi] + rng.normal(0, 0.3, 2))
    cam_params = np.array([np.hstack([rv, t]) for (_, t, rv) in cams])
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    K_wrong = K_true.copy()
    K_wrong[0, 0] *= focal_error
    K_wrong[1, 1] *= focal_error
    return (cam_params, X, np.array(obs_cam), np.array(obs_pt), np.array(obs_xy),
            np.stack([K_wrong] * C)), dict(cam_fixed=cam_fixed)


def compat_sequence(out_dir: str):
    """Write the bench sequence rendered at twice its size (720x960, f=1040,
    texture patches of 17 px where the bench paints 9) as ``1.jpg..10.jpg``
    into ``out_dir``: ``SFMRunner``'s fixed 0.5 prescale gives the engine the
    bench's 360x480. Returns (K of the prescaled images, f=520; ground-truth
    world-to-camera poses)."""
    import numpy as np

    mod = _render_module()
    images, K, poses, _ = mod.render_sequence(
        np.random.default_rng(7), num_views=COMPAT_VIEWS, num_points=600, img_hw=(720, 960),
        patch=17, f=1040.0, step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004),
    )
    mod.write_sequence(out_dir, images)
    K_half = K.copy()
    K_half[:2] *= 0.5
    return K_half, poses


def mixed_size_sequence(out_dir: str):
    """The bench sequence with view 2 padded by ``MIXED_PAD`` px at the
    bottom and right by edge replication (``tests/test_pipeline.py::
    test_engine_mixed_image_shapes``), so its pixel coordinates and K stay
    valid. Returns (K, ground-truth poses)."""
    import numpy as np
    from PIL import Image

    K, poses = bench_sequence(out_dir)
    path = os.path.join(out_dir, "2.jpg")
    with Image.open(path) as im:
        arr = np.asarray(im)
    arr = np.pad(arr, ((0, MIXED_PAD), (0, MIXED_PAD), (0, 0)), mode="edge")
    Image.fromarray(arr).save(path, quality=95)
    return K, poses


def two_image_sequence(out_dir: str):
    """Views 1 and 2 of the bench scene (the slice phase's pair,
    ``bench_pair``) as ``1.jpg`` and ``2.jpg`` in ``out_dir``; returns (K,
    ground-truth relative rotation, unit translation)."""
    import numpy as np

    mod = _render_module()
    images, K, poses, _ = mod.render_sequence(
        np.random.default_rng(7), num_views=10, num_points=600, img_hw=(360, 480), f=520.0,
        step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004),
    )
    mod.write_sequence(out_dir, images[1:3])
    (R1, t1), (R2, t2) = poses[1], poses[2]
    R = R2 @ R1.T
    t = t2 - R @ t1
    return K, R, t / np.linalg.norm(t)


def compat_config(seed: int = 5):
    """``SFMRunner``'s configuration (``compat.py``) at the bench extractor
    settings and ``match_threshold=0.85``, in the port's config classes."""
    from sfmfromscratch_tpu_torch.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )

    ecfg = ExtractorConfig.from_params_dict(BENCH_EXTRACTOR)
    return PipelineConfig(
        extractor=ecfg, matcher=MatcherConfig(ratio_threshold=0.85,
                                              max_matches=ecfg.num_interest_points),
        ransac=RansacConfig(), ba=BundleAdjustConfig(), scale_factor=0.5, dist_threshold=5.0,
        seed=seed,
    )


def host_cli_argv(seq: str, cache: str, out: str):
    """The host phase's ``reconstruct`` command line (both packages' CLIs
    take it)."""
    return ["reconstruct", seq, *HOST_CLI, "--pair-cache-dir", cache, "--model-name", "host",
            "--output-dir", out, "--export-ply", os.path.join(out, "host.ply"),
            "--export-colmap", os.path.join(out, "colmap")]


def flat_frame(seq: str, idx: int) -> None:
    """Overwrite ``idx.jpg`` in ``seq`` with a flat gray frame of its size."""
    import numpy as np
    from PIL import Image

    path = os.path.join(seq, f"{idx}.jpg")
    with Image.open(path) as im:
        arr = np.full_like(np.asarray(im), 128)
    Image.fromarray(arr).save(path, quality=95)


def trajectory_error(global_poses, gt_poses, first_image: int = 2):
    """(ATE, trajectory extent) of an engine's ``global_poses`` against the
    ground truth, as ``bench.py::log_ate`` computes them: camera centres,
    similarity alignment, RMSE. The incremental engine's cameras start at
    image 2 (``first_image=2``), the global engine's at image 1."""
    import numpy as np

    from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error, camera_centers

    rvecs = np.stack([np.asarray(rv, np.float64) for rv, _ in global_poses])
    ts = np.stack([np.asarray(t, np.float64) for _, t in global_poses])
    est = camera_centers(rvecs, ts)
    first = first_image - 1
    gt = np.stack([-(R.T @ t) for R, t in gt_poses[first:first + len(est)]])
    return absolute_trajectory_error(est, gt), float(np.linalg.norm(gt.max(0) - gt.min(0)))


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


ENGINE_LEVELS = [(360, 480), (327, 436), (297, 396)]   # 3 levels x1.1 of 360x480
ORBIT_LEVELS = [(360, 480), (300, 400)]                 # 2 levels x1.2 of 360x480


def _path(rows, per, keys=("device_ms", "call_ms", "bound_ms", "plain_ms")):
    """One path's numbers: the sums over its launches (rows)."""
    return dict(per=per, **{k: _sum(rows, k) for k in keys})


def harris_phase(dev, peaks):
    """Harris kernel vs plain at the engine's pyramid levels (B=10), the
    two-view's (B=1), the global engine's and the orbit's (B=20), the
    960x1280 regime and a width off the 16-byte path; returns the numbers of
    the engine's three launches, with each other path's."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK

    G, sigma, alpha = 7, 6.0, 0.05
    bw, fl = peaks["bytes_per_s"], peaks["fp32_flops"]
    gen = torch.Generator(device=dev).manual_seed(0)
    # The last case's width is not a multiple of 4: the kernel's scalar path.
    cases = [(10, H, W) for H, W in ENGINE_LEVELS] + [(1, H, W) for H, W in ENGINE_LEVELS] \
        + [(20, H, W) for H, W in ENGINE_LEVELS] + [(20, *ORBIT_LEVELS[1])] \
        + [(1, 960, 1280), (2, 45, 61)] + [(SCALE_VIEWS, H, W) for H, W in ENGINE_LEVELS] \
        + [(10 // MESH_RANKS, H, W) for H, W in ENGINE_LEVELS]
    rows = []
    for B, H, W in cases:
        img = torch.rand((B, H, W), generator=gen, device=dev)
        got = HK.harris_response_fused(img, G, sigma, alpha)
        ref = HK.harris_response(img, G, sigma, alpha)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        _check(bool(torch.isfinite(got).all()), f"harris {B}x{H}x{W}: non-finite")
        _check(err <= HARRIS_TOL * scale, f"harris {B}x{H}x{W}: max err {err} > {HARRIS_TOL} * {scale}")
        px = B * H * W
        row = dict(shape=[B, H, W], max_abs_err=err, max_abs_R=scale)
        row.update(_kernel_times(lambda: HK.harris_response_fused(img, G, sigma, alpha),
                                 lambda: HK._launch(img, G, sigma, alpha), ("harris_kernel",)))
        row.update(plain_ms=_cuda_ms(lambda: HK.harris_response(img, G, sigma, alpha), reps=5),
                   bound_ms=max(8.0 * px / bw, px * (16 + 12 * G) / fl) * 1e3)
        rows.append(row)
    _print({"phase": "harris", "tol_rel": HARRIS_TOL, "cases": rows})

    engine, two_view, global_ = rows[:3], rows[3:6], rows[6:9]
    orbit = [rows[6], rows[9]]
    scale = rows[12:15]
    mesh = rows[15:18]
    return dict(
        name="harris_response_fused", route="cuda",
        source="sfmfromscratch_tpu_torch/csrc/harris.cu",
        replaces="sfmfromscratch_tpu/ops/pallas/harris_kernel.py:68 (_harris_kernel), "
                 "sfmfromscratch_tpu/ops/pallas/harris_kernel.py:150 (_harris_tiled_kernel)",
        max_abs_err=max(r["max_abs_err"] for r in engine),
        ms=_sum(engine, "device_ms"), device_ms=_sum(engine, "device_ms"),
        graph_ms=_sum(engine, "graph_ms"), call_ms=_sum(engine, "call_ms"),
        plain_ms=_sum(engine, "plain_ms"), bound_ms=_sum(engine, "bound_ms"),
        bound_by="bytes", library_ms=None,
        per="engine run: 3 launches, B=10 at 360x480, 327x436, 297x396",
        two_view=dict(per="2 images x 3 launches, B=1",
                      device_ms=2 * _sum(two_view, "device_ms"),
                      call_ms=2 * _sum(two_view, "call_ms"),
                      bound_ms=2 * _sum(two_view, "bound_ms"),
                      plain_ms=2 * _sum(two_view, "plain_ms")),
        global_path=_path(global_, "global run: 3 launches, B=20 at 360x480, 327x436, 297x396"),
        orbit_path=_path(orbit, "orbit run: 2 launches, B=20 at 360x480, 300x400"),
        host_path=_path(engine, "host CLI run: 3 launches, B=10 at 360x480, 327x436, 297x396"),
        scale_path=_path(scale, f"scale keyframes run: 3 launches, B={SCALE_VIEWS} at 360x480, "
                                "327x436, 297x396"),
        mesh_path=_path(mesh, f"mesh engine run, per rank: 3 launches, B={10 // MESH_RANKS} at "
                              "360x480, 327x436, 297x396"),
        compat_path=_path(two_view[:1], "compat NaiveSIFT: one launch, B=1 at 360x480 "
                                        "(ScaleRotInvSIFT: the two_view row's 3 launches per image)"),
    )


def _sum(rows, key):
    vals = [r[key] for r in rows]
    return None if any(v is None for v in vals) else sum(vals)


def _descriptors(gen, dev, B, n, D=128):
    """RootSIFT-like descriptors: non-negative rows of unit L2 norm."""
    import torch

    d = torch.rand((B, n, D), generator=gen, device=dev) ** 2
    return torch.sqrt(d / d.sum(-1, keepdim=True))


def _match_check(label, MK, d1, d2, mask2, kw):
    """Kernel against its plain version (same mode) on the same inputs:
    distances to MATCH_RTOL/MATCH_ATOL, indices equal off near-ties."""
    import torch

    n1sq, n2sq = MK._norms(d1, d2, mask2)
    k1, k2, ki = MK.match_top2_fused(d1, d2, mask2, **kw)
    p1r, p2r, pi = MK.match_top2_plain(d1, d2, n2sq, **kw)
    p1 = torch.clamp_min(p1r + n1sq, 0.0)
    p2 = torch.clamp_min(p2r + n1sq, 0.0)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(k1).all() and torch.isfinite(k2).all()), f"{label}: non-finite")
    _check(bool(torch.allclose(k1, p1, rtol=MATCH_RTOL, atol=MATCH_ATOL)), f"{label}: dist1")
    _check(bool(torch.allclose(k2, p2, rtol=MATCH_RTOL, atol=MATCH_ATOL)), f"{label}: dist2")
    differ = ki != pi
    near_tie = (p2r - p1r) <= MATCH_TIE * p1r.abs()
    n_differ, n_unexcused = int(differ.sum()), int((differ & ~near_tie).sum())
    _check(n_unexcused == 0, f"{label}: {n_unexcused} index disagreements off ties")
    err = float(torch.maximum((k1 - p1).abs().max(), (k2 - p2).abs().max()))
    return dict(max_abs_err=err, index_disagreements=n_differ,
                index_disagreements_off_ties=n_unexcused), (k1, k2, ki), n2sq


def _match_tie_case(dev, MK, kw):
    """Exact ties on the card: each query equals database rows placed in the
    same tile and in other tiles and segments of a 6144-row database; the
    nearest index must be the lowest duplicate, with dist2 == dist1."""
    import torch

    n2 = 6144
    d2 = _descriptors(torch.Generator(device=dev).manual_seed(2), dev, 1, n2)
    q = torch.tensor([5, 100, 2100, 4400, 6000], device=dev)
    dups = [q, q + 3, (q + 1000) % n2, (q + 3100) % n2]
    for j in dups[1:]:
        d2[0, j] = d2[0, q]
    d1 = d2[:, q].clone()
    label = f"match tie {'bf16' if kw else 'f32'}"
    row, (k1, k2, ki), _ = _match_check(label, MK, d1, d2, None, kw)
    want = torch.stack(dups).min(0).values.int()
    _check(bool(torch.equal(ki[0], want)), f"{label}: nearest {ki[0].tolist()} != lowest {want.tolist()}")
    _check(bool(torch.equal(k1, k2)), f"{label}: dist2 != dist1 on exact ties")
    row.update(shape=[1, len(q), n2, 128], nearest=ki[0].tolist())
    return row


def _match_row(label, MK, d1, d2, mask2, bf16, peaks):
    """The matcher kernel against its plain version (``_match_check``) on
    (B, n1, D) queries and a masked (B, n2, D) database, with its device,
    graph and call times, the plain version's and one library call's, and
    its bound."""
    import torch

    from sfmfromscratch_tpu_torch.utils.precision import f32_precision

    kw = {"bf16": True} if bf16 else {}
    fl = peaks["bf16_flops"] if bf16 else peaks["fp32_flops"]
    B, n1, D = d1.shape
    n2 = d2.shape[1]
    row, _, n2sq = _match_check(label, MK, d1, d2, mask2, kw)
    flops = 2.0 * B * n1 * n2 * D
    nbytes = 4.0 * (B * n1 * D + B * n2 * D + B * n2) + 12.0 * B * n1

    if bf16:
        def library():
            # The product is rounded to bf16 here, unlike the kernel's f32 sum.
            cross = torch.bmm(d1.bfloat16(), d2.bfloat16().transpose(1, 2))
            return (n2sq[:, None, :] - 2.0 * cross).topk(2, dim=-1, largest=False)
    else:
        def library():
            with f32_precision():
                return torch.cdist(d1, d2).topk(2, dim=-1, largest=False)

    row["shape"] = [B, n1, n2, D]
    row.update(_kernel_times(lambda: MK.match_top2_fused(d1, d2, mask2, **kw),
                             lambda: MK._launch(d1, d2, n2sq, **kw),
                             ("match_bf16_kernel" if bf16 else "match_f32_kernel",
                              "merge_segments_kernel")))
    row.update(plain_ms=_cuda_ms(lambda: MK.match_top2_plain(d1, d2, n2sq, **kw), reps=5),
               library_ms=_cuda_ms(library, reps=5),
               bound_ms=max(nbytes / peaks["bytes_per_s"], flops / fl) * 1e3)
    return row


def match_phase(dev, peaks):
    """Matcher kernel vs plain, f32 and bf16 modes, at the engine's shape (9
    pairs), the two-view's (one pair), a 6000-row database and an exact-tie
    case; returns the numbers of the engine's launch for each mode."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

    kernels = []
    for bf16 in MATCH_MODES:
        kw = {"bf16": True} if bf16 else {}
        gen = torch.Generator(device=dev).manual_seed(1)
        rows = []
        for B, n1, n2 in MATCH_CASES:
            d1 = _descriptors(gen, dev, B, n1)
            d2 = _descriptors(gen, dev, B, n2)
            mask2 = torch.rand((B, n2), generator=gen, device=dev) > 0.1
            label = f"match {'bf16' if bf16 else 'f32'} {B}x{n1}x{n2}"
            rows.append(_match_row(label, MK, d1, d2, mask2, bf16, peaks))
        tie = _match_tie_case(dev, MK, kw)
        edges = []
        for B, n1, n2, D_ in MATCH_EDGE_CASES:
            d1 = _descriptors(gen, dev, B, n1, D_)
            d2 = _descriptors(gen, dev, B, n2, D_)
            mask2 = torch.rand((B, n2), generator=gen, device=dev) > 0.1
            mask2[:, 0] = True
            label = f"match {'bf16' if bf16 else 'f32'} edge {B}x{n1}x{n2}x{D_}"
            edge, _, _ = _match_check(label, MK, d1, d2, mask2, kw)
            edges.append(dict(edge, shape=[B, n1, n2, D_]))
        _print({"phase": "match", "mode": "bf16" if bf16 else "f32", "rtol": MATCH_RTOL,
                "atol": MATCH_ATOL, "tie_rel": MATCH_TIE, "cases": rows, "tie_case": tie,
                "edge_cases": edges})
        main, two_view, global_, orbit, host, scale, shard = (rows[0], rows[1], rows[3], rows[4],
                                                              rows[5], rows[6], rows[7])
        path_keys = ("device_ms", "call_ms", "bound_ms", "plain_ms", "library_ms")
        kernels.append(dict(
            name="match_top2_fused(bf16=True)" if bf16 else "match_top2_fused", route="cuda",
            source="sfmfromscratch_tpu_torch/csrc/match_top2.cu",
            replaces="sfmfromscratch_tpu/ops/pallas/match_kernel.py:37 (_match_kernel"
                     + (", bf16=True: match_kernel.py:47-48, 56-57, 76-77)" if bf16 else ")"),
            max_abs_err=main["max_abs_err"], ms=main["device_ms"], device_ms=main["device_ms"],
            graph_ms=main["graph_ms"], call_ms=main["call_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by="operations", library_ms=main["library_ms"],
            library="torch.bmm on bf16 operands (product rounded to bf16) + topk(2)" if bf16
            else "torch.cdist + topk(2)",
            per="engine shape: one launch, B=9 pairs, 2499 x 2499 x 128",
            two_view={k: two_view[k] for k in path_keys},
            global_path=_path([global_], "global run: one launch, B=54 pairs, 2499 x 2499 x 128",
                              path_keys),
            orbit_path=_path([orbit], "orbit run: one launch, B=19 pairs, 600 x 600 x 128",
                             path_keys),
            host_path=_path([host], "host CLI cold run: one launch, B=24 window pairs, "
                            "2499 x 2499 x 128 (none when the pair cache resumes)", path_keys),
            scale_path=_path([scale], f"scale keyframes run: the flow selection's launch, "
                             f"B={SCALE_VIEWS - 1} consecutive pairs, 2499 x 2499 x 128 (the "
                             "run's other two launches, the keyframe pairs and the "
                             "registration pairs, are sized by the keyframes it picks; "
                             "the scale phase line gives them)", path_keys),
            mesh_path=_path([shard], "mesh tp_match, per rank: one launch on the rank's shard, "
                            "B=1, 2499 x 1250 x 128 (the mesh engine and global runs launch "
                            "the engine's and the global run's shapes on every rank)", path_keys),
            compat_path=_path([two_view], "compat NNRatioFeatureMatcher: one launch, B=1, "
                              "2499 x 2499 x 128", path_keys),
        ))
    return kernels


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
    MK.launches_bf16 = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {"harris_response_fused": HK.launches, "match_top2_fused": MK.launches,
                "match_top2_fused(bf16=True)": MK.launches_bf16}

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


def engine_config():
    """``bench.py::engine_config`` in the port's config classes."""
    from sfmfromscratch_tpu_torch.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )

    return PipelineConfig(
        extractor=ExtractorConfig(**BENCH_EXTRACTOR), matcher=MatcherConfig(**BENCH_MATCHER),
        ransac=RansacConfig(), ba=BundleAdjustConfig(**BENCH_BA), scale_factor=1.0,
    )


def engine_phase(dev):
    """``SfmEngine`` on the bench sequence at the bench configuration, cold
    then warm; returns the warm run's launch counts and its final BA problem
    (on the CPU, with the solver's keywords and the card's result)."""
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    cfg = engine_config()
    n = 10
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as seq:
        K, gt = bench_sequence(seq, n)
        t0 = time.perf_counter()
        cold = SfmEngine(seq, n, config=cfg, single_K=K, device=dev)
        cold_s = time.perf_counter() - t0
        cold_e1 = float(cold.errors_before_after_ba[1])

        HK.launches = 0
        MK.launches = 0
        MK.launches_bf16 = 0
        t0 = time.perf_counter()
        eng = SfmEngine(seq, n, config=cfg, single_K=K, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches = {"harris_response_fused": HK.launches, "match_top2_fused": MK.launches}
        launches_bf16 = MK.launches_bf16

    cams = len(eng.global_poses)
    ate, extent = trajectory_error(eng.global_poses, gt)
    e0, e1 = eng.errors_before_after_ba
    tracks = eng.map.num_tracks
    ba_iters = eng.ba_result.iterations_used

    # The card's final BA problem solved again on the CPU: the first
    # iterations one by one, then the full run.
    prob_cpu = BAProblem(*(None if v is None else v.cpu() for v in eng.ba_problem))
    b = cfg.ba
    kw = dict(cg_iters=60, init_damping=b.init_damping, damping_up=b.damping_up,
              damping_down=b.damping_down, ftol=b.ftol, huber_delta=b.huber_delta)
    prefix = []
    for k in range(1, 7):
        card = float(bundle_adjust(eng.ba_problem, max_iters=k, **kw).final_cost)
        cpu = float(bundle_adjust(prob_cpu, max_iters=k, **kw).final_cost)
        prefix.append([k, card, cpu, abs(card - cpu) / cpu])
    t0 = time.perf_counter()
    res_cpu = bundle_adjust(prob_cpu, max_iters=b.max_lm_iters, **kw)
    cpu_ba_s = time.perf_counter() - t0
    cpu_e1 = float(res_cpu.final_mean_error)

    _print({"phase": "engine", "views": n, "cold_s": cold_s, "warm_s": warm_s,
            "warm_frames_per_s": n / warm_s, "stage_times_s": eng.stage_times,
            "launches": launches, "launches_bf16_matcher": launches_bf16, "cameras": cams,
            "ate": ate, "extent": extent,
            "ate_over_extent": ate / extent, "reproj_before_px": e0, "reproj_after_px": e1,
            "cold_reproj_after_px": cold_e1,
            "tracks": tracks, "observations": eng.map.num_observations,
            "filter_hyps_used": np.asarray(eng.filter_hyps_used).tolist(),
            "ba_iterations": ba_iters, "ba_problem_padded": [eng.ba_problem.num_cameras,
                                                             eng.ba_problem.num_points,
                                                             eng.ba_problem.num_obs],
            "ba_cpu": {"iterations": res_cpu.iterations_used, "reproj_after_px": cpu_e1,
                       "seconds": cpu_ba_s, "prefix_k_card_cpu_cost_rel": prefix},
            "pins": {"cameras": PIN_ENGINE_CAMERAS, "ate_over_extent": PIN_ENGINE_ATE,
                     "reproj_px": PIN_ENGINE_REPROJ_PX, "min_tracks": PIN_ENGINE_MIN_TRACKS,
                     "launches": ENGINE_LAUNCHES, "ba_prefix": BA_PREFIX,
                     "ba_prefix_rtol": BA_PREFIX_RTOL, "ba_final_rtol": BA_FINAL_RTOL}})
    _check(launches == ENGINE_LAUNCHES, f"engine launches {launches} != {ENGINE_LAUNCHES}")
    _check(launches_bf16 == 0, f"engine launched the bf16 matcher {launches_bf16} times")
    _check(cams == PIN_ENGINE_CAMERAS, f"{cams} cameras registered, want {PIN_ENGINE_CAMERAS}")
    _check(bool(np.isfinite([ate, e0, e1]).all()), "non-finite ATE or reprojection error")
    _check(all(np.isfinite(np.hstack(p)).all() for p in eng.global_poses), "non-finite poses")
    _check(bool(np.isfinite(eng.map.points()).all()), "non-finite points")
    _check(ate / extent <= PIN_ENGINE_ATE, f"ATE over extent {ate / extent} > {PIN_ENGINE_ATE}")
    _check(e1 <= PIN_ENGINE_REPROJ_PX, f"post-BA reprojection {e1} px > {PIN_ENGINE_REPROJ_PX}")
    _check(tracks >= PIN_ENGINE_MIN_TRACKS, f"{tracks} tracks < {PIN_ENGINE_MIN_TRACKS}")
    for k, card, cpu, rel in prefix[:BA_PREFIX]:
        _check(rel <= BA_PREFIX_RTOL, f"BA cost after {k} iterations: card {card} vs CPU {cpu}")
    _check(abs(cpu_e1 - e1) <= BA_FINAL_RTOL * e1, f"BA final error card {e1} vs CPU {cpu_e1}")
    _check(cold_e1 == e1, f"BA final error not reproducible on the card: cold {cold_e1}, warm {e1}")
    engine_ba = dict(problem=prob_cpu, points=eng.ba_result.points.cpu().numpy(), e1=e1,
                     kw=dict(kw, max_iters=b.max_lm_iters), cameras=cams, tracks=tracks,
                     observations=eng.map.num_observations)
    return dict(launches, **{"match_top2_fused(bf16=True)": launches_bf16}), engine_ba


def _resolve_ba_on_cpu(eng, ba_cfg):
    """The card's last BA problem of ``eng`` solved again on the CPU: the
    costs after each of the first 6 iterations on both sides, and the CPU's
    full run."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem

    prob_cpu = BAProblem(*(None if v is None else v.cpu() for v in eng.ba_problem))
    kw = dict(cg_iters=60, init_damping=ba_cfg.init_damping, damping_up=ba_cfg.damping_up,
              damping_down=ba_cfg.damping_down, ftol=ba_cfg.ftol, huber_delta=ba_cfg.huber_delta)
    prefix = []
    for k in range(1, 7):
        card = float(bundle_adjust(eng.ba_problem, max_iters=k, **kw).final_cost)
        cpu = float(bundle_adjust(prob_cpu, max_iters=k, **kw).final_cost)
        prefix.append([k, card, cpu, abs(card - cpu) / cpu])
    t0 = time.perf_counter()
    res_cpu = bundle_adjust(prob_cpu, max_iters=ba_cfg.max_lm_iters, **kw)
    return prefix, res_cpu, time.perf_counter() - t0


def _launch_counts():
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

    return {"harris_response_fused": HK.launches, "match_top2_fused": MK.launches,
            "match_top2_fused(bf16=True)": MK.launches_bf16}


def _zero_launch_counts():
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

    HK.launches = 0
    MK.launches = 0
    MK.launches_bf16 = 0


def global_phase(dev):
    """``GlobalSfmEngine`` on the 20-view 4 deg/view orbit at the bench
    widths, cold then warm; returns the warm run's launch counts."""
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.native import bindings as NB
    from sfmfromscratch_tpu_torch.pipeline import global_sfm as G
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

    cfg = engine_config()
    n = GLOBAL_VIEWS
    track_calls = []

    def recording_build_tracks(ea, eb, num_nodes, node_image=None):
        out = NB.build_tracks(ea, eb, num_nodes, node_image=node_image)
        track_calls.append(((ea, eb, num_nodes, node_image), out))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_global_") as seq:
        K, gt = orbit_sequence(seq, n, 4.0)
        t0 = time.perf_counter()
        GlobalSfmEngine(seq, n, config=cfg, single_K=K, device=dev)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        _zero_launch_counts()
        G.build_tracks = recording_build_tracks   # the C++ union-find, its edges kept
        try:
            t0 = time.perf_counter()
            eng = GlobalSfmEngine(seq, n, config=cfg, single_K=K, device=dev)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        finally:
            G.build_tracks = NB.build_tracks
        launches = _launch_counts()
    # The C++ tracks against the numpy union-find on the same edges.
    _check(len(track_calls) == 1, f"build_tracks called {len(track_calls)} times, want 1")
    (args, (ids, num_tracks, valid)), = track_calls
    ids_plain, num_plain, valid_plain = NB.build_tracks_plain(*args)
    native_tracks = NB.native_available() and num_tracks == num_plain \
        and np.array_equal(ids, ids_plain) and np.array_equal(valid, valid_plain)

    cams = len(eng.global_poses)
    ate, extent = trajectory_error(eng.global_poses, gt, first_image=1)
    e0, e1 = eng.errors_before_after_ba
    _, tracks, _ = eng.map.observations()
    tracks_3 = int((np.bincount(tracks, minlength=eng.map.num_tracks) >= 3).sum())
    prefix, res_cpu, cpu_ba_s = _resolve_ba_on_cpu(eng, eng.config.ba)
    cpu_e1 = float(res_cpu.final_mean_error)
    want = dict(GLOBAL_LAUNCHES, **{"match_top2_fused(bf16=True)": 0})
    _print({"phase": "global", "views": n, "cold_s": cold_s, "warm_s": warm_s,
            "stage_times_s": eng.stage_times, "launches": launches, "cameras": cams,
            "ate": ate, "extent": extent, "ate_over_extent": ate / extent,
            "reproj_before_px": e0, "reproj_after_px": e1, "tracks": eng.map.num_tracks,
            "tracks_3plus": tracks_3, "observations": eng.map.num_observations,
            "native_tracks": bool(native_tracks), "union_find_tracks": [num_tracks, num_plain],
            "edges": len(eng._edges), "live_edges": int((eng._edge_w > 0).sum()),
            "warnings": eng.warnings, "filter_hyps_used": np.asarray(eng.filter_hyps_used).tolist(),
            "ba_iterations_last_round": eng.ba_result.iterations_used,
            "ba_problem_padded": [eng.ba_problem.num_cameras, eng.ba_problem.num_points,
                                  eng.ba_problem.num_obs],
            "ba_cpu": {"iterations": res_cpu.iterations_used, "reproj_after_px": cpu_e1,
                       "seconds": cpu_ba_s, "prefix_k_card_cpu_cost_rel": prefix},
            "pins": {"cameras": PIN_GLOBAL_CAMERAS, "ate_over_extent": PIN_GLOBAL_ATE,
                     "reproj_px": PIN_GLOBAL_REPROJ_PX, "min_tracks": PIN_GLOBAL_MIN_TRACKS,
                     "min_tracks_3plus": PIN_GLOBAL_MIN_TRACKS_3, "launches": want}})
    _check(launches == want, f"global launches {launches} != {want}")
    _check(native_tracks, f"C++ tracks {num_tracks} differ from the numpy union-find {num_plain}")
    _check(cams == PIN_GLOBAL_CAMERAS, f"{cams} cameras, want {PIN_GLOBAL_CAMERAS}")
    _check(bool(np.allclose(np.hstack(eng.global_poses[0]), 0.0, atol=1e-5)),
           "camera 0 is not the identity")
    _check(bool(np.isfinite([ate, e0, e1]).all()), "non-finite ATE or reprojection error")
    _check(all(np.isfinite(np.hstack(p)).all() for p in eng.global_poses), "non-finite poses")
    _check(bool(np.isfinite(eng.map.points()).all()), "non-finite points")
    _check(ate / extent <= PIN_GLOBAL_ATE, f"ATE over extent {ate / extent} > {PIN_GLOBAL_ATE}")
    _check(e1 <= PIN_GLOBAL_REPROJ_PX, f"post-BA reprojection {e1} px > {PIN_GLOBAL_REPROJ_PX}")
    _check(eng.map.num_tracks >= PIN_GLOBAL_MIN_TRACKS,
           f"{eng.map.num_tracks} tracks < {PIN_GLOBAL_MIN_TRACKS}")
    _check(tracks_3 >= PIN_GLOBAL_MIN_TRACKS_3,
           f"{tracks_3} tracks of 3+ views < {PIN_GLOBAL_MIN_TRACKS_3}")
    for k, card, cpu, rel in prefix[:BA_PREFIX]:
        _check(rel <= BA_PREFIX_RTOL, f"global BA cost after {k} iterations: card {card} vs CPU {cpu}")
    _check(abs(cpu_e1 - e1) <= BA_FINAL_RTOL * e1, f"global BA final error card {e1} vs CPU {cpu_e1}")
    return launches


def orbit_phase(dev):
    """``SfmEngine`` plain and with ``chain_refresh="averaging"`` on the
    0.8 deg/view orbit, each run's launches counted; returns the refreshed
    run's counts."""
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    cfg = PipelineConfig(extractor=ExtractorConfig(**ORBIT_EXTRACTOR),
                         matcher=MatcherConfig(**ORBIT_MATCHER), ransac=RansacConfig(),
                         ba=BundleAdjustConfig(), scale_factor=1.0)
    n = ORBIT_VIEWS
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbit_") as seq:
        K, gt = orbit_sequence(seq, n, 0.8)
        for label, kw in (("plain", {}), ("refresh", {"chain_refresh": "averaging"})):
            _zero_launch_counts()
            t0 = time.perf_counter()
            eng = SfmEngine(seq, n, config=cfg, single_K=K, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ate, extent = trajectory_error(eng.global_poses, gt)
            runs[label] = dict(wall_s=wall, launches=_launch_counts(),
                               cameras=len(eng.global_poses), ate_over_extent=ate / extent,
                               reproj_before_px=eng.errors_before_after_ba[0],
                               reproj_after_px=eng.errors_before_after_ba[1],
                               tracks=eng.map.num_tracks, stage_times_s=eng.stage_times,
                               warnings=eng.warnings,
                               finite=bool(np.isfinite(eng.map.points()).all()
                                           and all(np.isfinite(np.hstack(p)).all()
                                                   for p in eng.global_poses)))
    want = dict(ORBIT_LAUNCHES, **{"match_top2_fused(bf16=True)": 0})
    _print({"phase": "orbit", "views": n, "runs": runs,
            "chain_refresh_s": runs["refresh"]["stage_times_s"].get("chain_refresh"),
            "gates": {"plain_min_ate_over_extent": ORBIT_PLAIN_MIN_ATE,
                      "refresh_max_ate_over_extent": ORBIT_REFRESH_MAX_ATE,
                      "refresh_max_reproj_px": ORBIT_REFRESH_MAX_REPROJ_PX, "launches": want}})
    for label, r in runs.items():
        _check(r["launches"] == want, f"orbit {label} launches {r['launches']} != {want}")
        _check(r["cameras"] == n - 1, f"orbit {label}: {r['cameras']} cameras")
        _check(r["finite"], f"orbit {label}: non-finite poses or points")
    _check("chain_refresh" in runs["refresh"]["stage_times_s"], "chain refresh did not run")
    _check(runs["plain"]["ate_over_extent"] > ORBIT_PLAIN_MIN_ATE,
           f"plain chain ATE over extent {runs['plain']['ate_over_extent']} <= {ORBIT_PLAIN_MIN_ATE}")
    _check(runs["refresh"]["ate_over_extent"] < ORBIT_REFRESH_MAX_ATE,
           f"refreshed ATE over extent {runs['refresh']['ate_over_extent']} >= {ORBIT_REFRESH_MAX_ATE}")
    _check(runs["refresh"]["reproj_after_px"] < ORBIT_REFRESH_MAX_REPROJ_PX,
           f"refreshed post-BA error {runs['refresh']['reproj_after_px']} px")
    return runs["refresh"]["launches"]


def _host_row(eng, gt, wall_s, launches):
    """One host-phase run's numbers."""
    import numpy as np

    ate, extent = trajectory_error(eng.global_poses, gt)
    e0, e1 = eng.errors_before_after_ba
    return dict(wall_s=wall_s, launches=launches, cameras=len(eng.global_poses),
                ate_over_extent=ate / extent, reproj_before_px=e0, reproj_after_px=e1,
                tracks=eng.map.num_tracks, observations=eng.map.num_observations,
                obs_per_track=eng.map.num_observations / max(eng.map.num_tracks, 1),
                stage_times_s=eng.stage_times, warnings=eng.warnings,
                finite=bool(np.isfinite(eng.map.points()).all()
                            and all(np.isfinite(np.hstack(p)).all() for p in eng.global_poses)
                            and np.isfinite([e0, e1]).all()))


def _check_host_row(label, row, pins, launches):
    _check(row["launches"] == launches, f"host {label} launches {row['launches']} != {launches}")
    _check(row["cameras"] == HOST_VIEWS - 1, f"host {label}: {row['cameras']} cameras")
    _check(row["finite"], f"host {label}: non-finite poses, points or errors")
    _check(row["ate_over_extent"] <= pins["ate_over_extent"],
           f"host {label}: ATE over extent {row['ate_over_extent']} > {pins['ate_over_extent']}")
    _check(row["reproj_after_px"] <= pins["reproj_px"],
           f"host {label}: post-BA error {row['reproj_after_px']} px > {pins['reproj_px']}")
    _check(row["tracks"] >= pins["min_tracks"],
           f"host {label}: {row['tracks']} tracks < {pins['min_tracks']}")
    _check(row["obs_per_track"] >= pins["min_obs_per_track"],
           f"host {label}: {row['obs_per_track']} observations per track")


def _read_exports(out: str, cams: int, tracks: int) -> dict:
    """Parse the CLI's PLY and COLMAP text; returns their counts."""
    with open(os.path.join(out, "host.ply")) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    n_vertex = int(next(ln for ln in lines[:end] if ln.startswith("element vertex")).split()[2])
    body = lines[end + 1:]
    _check(n_vertex == len(body) == tracks + cams, f"PLY holds {len(body)} of {n_vertex} vertices")
    _check(all(len(ln.split()) == 6 for ln in body), "PLY vertex lines")
    _check(all(math.isfinite(float(v)) for ln in body for v in ln.split()[:3]),
           "PLY coordinates")
    colmap = {}
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(out, "colmap", name)) as f:
            colmap[name] = [ln for ln in f.read().splitlines() if not ln.startswith("#")]
    _check(len(colmap["cameras.txt"]) == cams, "COLMAP cameras")
    _check(len(colmap["images.txt"]) == 2 * cams, "COLMAP images")
    _check(len(colmap["points3D.txt"]) == tracks, "COLMAP points")
    for ln in colmap["images.txt"][::2]:
        q = [float(v) for v in ln.split()[1:5]]
        _check(abs(sum(v * v for v in q) - 1.0) < 1e-6, "COLMAP quaternion not unit")
    return {"ply_vertices": n_vertex, "colmap_cameras": len(colmap["cameras.txt"]),
            "colmap_points": len(colmap["points3D.txt"])}


def host_phase(dev):
    """The host chain and its options on the bench sequence at the bench
    widths, the first two runs through the port's CLI:

    1. ``cli.py reconstruct`` at window 3 with a local BA every 3 cameras,
       a fresh pair cache, and PLY and COLMAP export;
    2. the same command again: every pair resumes from the cache, so the
       matcher does not launch, and the pair masks are run 1's;
    3. ``SfmEngine(chain_mode="host")``: the engine phase's run with the
       host chain in place of the scan chain (the engine's pins);
    4. ``SfmEngine(chain_mode="host", assoc_mode="distance")``;
    5. ``SfmEngine(on_pose_failure="recover", pair_window=3,
       checkpoint_every=3)`` with image 6 replaced by a flat gray frame, whose
       pairs (5, 6) and (6, 7) take the pose recovery; the last checkpoint
       loads into a fresh engine with the state it was written from.

    Launches are counted per run. Returns run 1's counts."""
    import contextlib
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch import cli
    from sfmfromscratch_tpu_torch.pipeline import checkpoint, incremental
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    cfg = engine_config()
    n = HOST_VIEWS
    engines = []
    run = SfmEngine.run

    def keep(self):   # the engine the CLI builds
        engines.append(self)
        return run(self)

    def timed(fn):
        _zero_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _launch_counts()

    runs, extra = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        seq = os.path.join(tmp, "seq")
        os.makedirs(seq)
        K, gt = bench_sequence(seq, n)
        cache, out = os.path.join(tmp, "cache"), os.path.join(tmp, "out")
        # The CLI runs on the card unless told otherwise.
        argv = host_cli_argv(seq, cache, out) + ([] if dev.type == "cuda" else ["--device", str(dev)])
        for label in ("cli_cold", "cli_resume"):
            text = io.StringIO()
            SfmEngine.run = keep
            try:
                with contextlib.redirect_stdout(text):
                    rc, wall, launches = timed(lambda: cli.main(argv))
            finally:
                SfmEngine.run = run
            lines = text.getvalue().strip().splitlines()
            _check(rc == 0, f"CLI {label} exited {rc}")
            runs[label] = _host_row(engines[-1], gt, wall, launches)
            runs[label]["printed"] = lines
            _check(len(lines) == 2 and re.fullmatch(r"tracks=\d+ observations=\d+", lines[0])
                   and re.fullmatch(r"mean reprojection error: \d+\.\d{4} -> \d+\.\d{4} px",
                                    lines[1]), f"CLI {label} printed {lines}")
            saved = np.load(os.path.join(out, "host.npz"))
            _check(saved["poses"].shape == (n - 1, 6) and saved["p3d"].shape == (
                runs[label]["tracks"], 3), f"CLI {label}: saved model shapes")
            _check(bool(np.isfinite(saved["poses"]).all() and np.isfinite(saved["p3d"]).all()),
                   f"CLI {label}: non-finite saved model")
            runs[label]["exports"] = _read_exports(out, n - 1, runs[label]["tracks"])
            if label == "cli_cold":
                extra["cache_files"] = len([f for f in os.listdir(cache) if f.endswith(".npz")])
        cold, warm = engines
        extra["resumed_masks_equal"] = all(
            np.array_equal(warm.pair_geometry[k].mask, pg.mask) for k, pg in cold.pair_geometry.items())

        eng, wall, launches = timed(lambda: SfmEngine(
            seq, n, config=cfg, single_K=K, device=dev, chain_mode="host"))
        runs["host_index"] = _host_row(eng, gt, wall, launches)
        eng, wall, launches = timed(lambda: SfmEngine(
            seq, n, config=cfg, single_K=K, device=dev, chain_mode="host", assoc_mode="distance"))
        runs["distance"] = _host_row(eng, gt, wall, launches)

        flat_frame(seq, HOST_FLAT_IMAGE)
        ckpt = os.path.join(tmp, "checkpoint.npz")
        held = {}
        save = incremental.save_checkpoint

        def remember(engine, path, next_frame):   # the state each checkpoint holds
            save(engine, path, next_frame)
            held.update(next_frame=next_frame, points=engine.map.points().copy(),
                        observations=engine.map.observations(),
                        poses=np.array([np.hstack(p) for p in engine.global_poses]),
                        rng_state=engine._generator.get_state().clone())

        incremental.save_checkpoint = remember
        try:
            eng, wall, launches = timed(lambda: SfmEngine(
                seq, n, config=cfg, single_K=K, device=dev, on_pose_failure="recover",
                pair_window=3, checkpoint_every=3, checkpoint_path=ckpt))
        finally:
            incremental.save_checkpoint = save
        runs["recover"] = _host_row(eng, gt, wall, launches)
        fresh = SfmEngine(seq, n, config=cfg, single_K=K, device=dev, auto_run=False)
        resume_at = checkpoint.load_checkpoint(fresh, ckpt)
        extra["checkpoint"] = dict(next_frame=resume_at, tracks=fresh.map.num_tracks,
                                   cameras=len(fresh.global_poses))
        _check(resume_at == held["next_frame"] == n, f"checkpoint resumes at {resume_at}")
        _check(np.array_equal(fresh.map.points(), held["points"]), "checkpoint points")
        _check(all(np.array_equal(a, b) for a, b in zip(fresh.map.observations(),
                                                        held["observations"])),
               "checkpoint observations")
        _check(np.array_equal(np.array([np.hstack(p) for p in fresh.global_poses]), held["poses"]),
               "checkpoint poses")
        _check(torch.equal(fresh._generator.get_state(), held["rng_state"]),
               "checkpoint generator state")

    _print({"phase": "host", "views": n, "cli_argv": argv, "runs": runs, **extra,
            "pins": PIN_HOST, "launches": {"cli_cold": HOST_LAUNCHES,
                                           "cli_resume": HOST_RESUME_LAUNCHES}})
    _check_host_row("CLI cold", runs["cli_cold"], PIN_HOST["cli"], HOST_LAUNCHES)
    _check(extra["cache_files"] == HOST_PAIRS, f"{extra['cache_files']} pair cache files")
    _check(not runs["cli_cold"]["warnings"], f"CLI cold warnings {runs['cli_cold']['warnings']}")
    _check("local_ba" in runs["cli_cold"]["stage_times_s"], "CLI cold run ran no local BA")
    _check_host_row("CLI resume", runs["cli_resume"], PIN_HOST["cli"], HOST_RESUME_LAUNCHES)
    _check(runs["cli_resume"]["warnings"] == [f"pair cache: resumed {HOST_PAIRS}/{HOST_PAIRS} pairs"],
           f"CLI resume warnings {runs['cli_resume']['warnings']}")
    _check(extra["resumed_masks_equal"], "resumed pair masks differ from the cold run's")
    _check_host_row("host_index", runs["host_index"],
                    dict(ate_over_extent=PIN_ENGINE_ATE, reproj_px=PIN_ENGINE_REPROJ_PX,
                         min_tracks=PIN_ENGINE_MIN_TRACKS, min_obs_per_track=1.0), HOST_LAUNCHES)
    _check_host_row("distance", runs["distance"], PIN_HOST["distance"], HOST_LAUNCHES)
    _check_host_row("recover", runs["recover"], PIN_HOST["recover"], HOST_LAUNCHES)
    _check(any(w.startswith("pose recovery engaged") for w in runs["recover"]["warnings"]),
           "pose recovery did not engage")
    return runs["cli_cold"]["launches"]


def _global_row(eng, gt, wall_s, launches, first_image=1):
    """One engine run's numbers (the global engine's cameras start at image
    1, the incremental engine's at image 2)."""
    import numpy as np

    ate, extent = trajectory_error(eng.global_poses, gt, first_image=first_image)
    e0, e1 = eng.errors_before_after_ba
    return dict(wall_s=wall_s, launches=launches, cameras=len(eng.global_poses),
                ate_over_extent=ate / extent, reproj_before_px=float(e0),
                reproj_after_px=float(e1), tracks=eng.map.num_tracks,
                observations=eng.map.num_observations, stage_times_s=dict(eng.stage_times),
                warnings=list(eng.warnings),
                finite=bool(np.isfinite(eng.map.points()).all()
                            and all(np.isfinite(np.hstack(p)).all() for p in eng.global_poses)))


def _check_pins(label, row, pins):
    _check(row["finite"], f"{label}: non-finite poses or points")
    _check(row["ate_over_extent"] <= pins["ate_over_extent"],
           f"{label}: ATE over extent {row['ate_over_extent']} > {pins['ate_over_extent']}")
    _check(row["reproj_after_px"] <= pins["reproj_px"],
           f"{label}: post-BA reprojection {row['reproj_after_px']} px > {pins['reproj_px']}")
    _check(row["tracks"] >= pins["min_tracks"],
           f"{label}: {row['tracks']} tracks < {pins['min_tracks']}")


def scale_phase(dev):
    """The global engine's scale-out path and focal self-calibration at the
    bench widths, each run's launches counted:

    1. keyframes: the port's CLI, ``scale_cli_argv`` on the 47-view dense
       orbit (auto keyframes, window pairs over them, batched PnP
       registration of the rest), with a fresh pair cache;
    2. stream: the same command with ``SCALE_STREAM`` (3 blocks of 16
       cameras, 2 resident), resumed from run 1's cache;
    3. retrieval: ``GlobalSfmEngine(**RETRIEVAL_ENGINE)`` on the shuffled
       planes at the bench configuration;
    4. selfcal: ``bundle_adjust_selfcal`` on the card and on the CPU on
       ``focal_observable_arrays(default_rng(5))`` (6% focal error), then the
       incremental CLI with ``--refine-focal`` on ``selfcal_sequence``.

    Returns run 1's launch counts."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch import cli
    from sfmfromscratch_tpu_torch.ba.problem import make_problem
    from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    engines = []

    def keep(run):
        def wrapped(self):   # the engine the CLI builds
            engines.append(self)
            return run(self)
        return wrapped

    def timed(fn):
        _zero_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _launch_counts()

    def run_cli(argv):
        runs = (SfmEngine.run, GlobalSfmEngine.run)
        SfmEngine.run, GlobalSfmEngine.run = keep(runs[0]), keep(runs[1])
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc, wall, launches = timed(lambda: cli.main(argv))
        finally:
            SfmEngine.run, GlobalSfmEngine.run = runs
        _check(rc == 0, f"CLI {argv} exited {rc}")
        return engines[-1], wall, launches

    device_flag = [] if dev.type == "cuda" else ["--device", str(dev)]
    runs, extra = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        dense = os.path.join(tmp, "dense")
        os.makedirs(dense)
        K, gt = orbit_sequence(dense, SCALE_VIEWS, SCALE_STEP_DEG)
        cache = os.path.join(tmp, "cache")
        eng, wall, launches = run_cli(scale_cli_argv(dense, cache) + device_flag)
        runs["keyframes"] = _global_row(eng, gt, wall, launches)
        runs["keyframes"].update(
            keyframes=list(eng.keyframes), edges=len(eng._edges),
            failed=sum("registration failed" in w for w in eng.warnings),
            registration_pairs=2 * (SCALE_VIEWS - len(eng.keyframes)),
            filter_hyps_used=np.asarray(eng.filter_hyps_used).tolist(),
            cache_files=len([f for f in os.listdir(cache) if f.endswith(".npz")]))
        eng, wall, launches = run_cli(scale_cli_argv(dense, cache, *SCALE_STREAM) + device_flag)
        runs["stream"] = _global_row(eng, gt, wall, launches)
        st = eng.stream_stats
        runs["stream"].update(
            keyframes=list(eng.keyframes),
            failed=sum("registration failed" in w for w in eng.warnings),
            stream_stats=dict(windows_run=st.windows_run, sweeps=st.sweeps,
                              clamped_tracks=st.clamped_tracks,
                              peak_resident_obs=st.peak_resident_obs,
                              peak_resident_bytes=st.peak_resident_bytes,
                              total_obs=st.total_obs, initial_error=st.initial_error,
                              final_error=st.final_error, window_errors=st.window_errors))

        planes = os.path.join(tmp, "planes")
        os.makedirs(planes)
        Kp, gtp = shuffled_planes(planes)
        eng, wall, launches = timed(lambda: GlobalSfmEngine(
            planes, PLANES_VIEWS, config=engine_config(), single_K=Kp, device=dev,
            **RETRIEVAL_ENGINE))
        runs["retrieval"] = _global_row(eng, gtp, wall, launches)
        runs["retrieval"]["edges"] = [list(e) for e in eng._edges]
        runs["retrieval"]["filter_hyps_used"] = np.asarray(eng.filter_hyps_used).tolist()

        pos, kw = focal_observable_arrays(np.random.default_rng(5))
        ba_kw = dict(max_iters=30, cg_iters=60, ftol=1e-12)
        (res, s), wall, launches = timed(
            lambda: bundle_adjust_selfcal(make_problem(*pos, **kw, device=dev), **ba_kw))
        t0 = time.perf_counter()
        res_cpu, s_cpu = bundle_adjust_selfcal(make_problem(*pos, **kw, device="cpu"), **ba_kw)
        extra["selfcal_ba"] = dict(
            s=float(s), s_cpu=float(s_cpu), final_mean_error=float(res.final_mean_error),
            final_mean_error_cpu=float(res_cpu.final_mean_error),
            iterations=res.iterations_used, iterations_cpu=res_cpu.iterations_used,
            wall_s=wall, cpu_s=time.perf_counter() - t0, launches=launches)

        small = os.path.join(tmp, "selfcal")
        os.makedirs(small)
        _, gts = selfcal_sequence(small)
        eng, wall, launches = run_cli(["reconstruct", small, *SELFCAL_CLI] + device_flag)
        ate, extent = trajectory_error(eng.global_poses, gts)
        runs["selfcal"] = dict(
            wall_s=wall, launches=launches, cameras=len(eng.global_poses),
            ate_over_extent=ate / extent, focal_scale=eng.focal_scale,
            reproj_before_px=eng.errors_before_after_ba[0],
            reproj_after_px=eng.errors_before_after_ba[1], tracks=eng.map.num_tracks,
            stage_times_s=dict(eng.stage_times), warnings=list(eng.warnings))
    extra["phase_s"] = time.perf_counter() - t_phase

    want = {"keyframes": dict(SCALE_LAUNCHES), "stream": dict(SCALE_LAUNCHES, match_top2_fused=2),
            "retrieval": dict(ENGINE_LAUNCHES), "selfcal": dict(SELFCAL_LAUNCHES)}
    for w in want.values():
        w["match_top2_fused(bf16=True)"] = 0
    _print({"phase": "scale", "views": SCALE_VIEWS, "runs": runs, **extra, "pins": PIN_SCALE,
            "launches": want})
    for label, w in want.items():
        _check(runs[label]["launches"] == w, f"scale {label} launches {runs[label]['launches']} != {w}")
    _check(extra["selfcal_ba"]["launches"] == {k: 0 for k in w}, "selfcal BA launched a kernel")

    kf, sm = runs["keyframes"], runs["stream"]
    for label, r in (("keyframes", kf), ("stream", sm)):
        _check(r["cameras"] == SCALE_VIEWS, f"scale {label}: {r['cameras']} cameras")
        _check(3 < len(r["keyframes"]) < SCALE_VIEWS, f"scale {label}: keyframes {r['keyframes']}")
        _check(r["failed"] <= 2, f"scale {label}: {r['failed']} failed registrations")
        _check_pins(f"scale {label}", r, PIN_SCALE[label])
    _check(sm["keyframes"] == kf["keyframes"], "the resumed run picked other keyframes")
    _check(kf["cache_files"] == kf["edges"], f"{kf['cache_files']} cache files, {kf['edges']} edges")
    _check(any(w.startswith("pair cache: resumed") for w in sm["warnings"]), "stream run did not resume")
    st, e = sm["stream_stats"], kf["reproj_after_px"]
    _check(st["windows_run"] >= 2, f"stream: {st['windows_run']} windows")
    _check(st["peak_resident_obs"] < st["total_obs"],
           f"stream: peak resident {st['peak_resident_obs']} of {st['total_obs']} observations")
    _check(abs(sm["reproj_after_px"] - e) < max(0.35 * e, 0.1),
           f"stream error {sm['reproj_after_px']} px against {e} px")
    _check("ba(stream)" in sm["stage_times_s"] and "ba" not in sm["stage_times_s"],
           "the stream run did not stream its BA")

    rt = runs["retrieval"]
    _check(rt["reproj_after_px"] < 2.0, f"retrieval: {rt['reproj_after_px']} px after BA")
    _check(rt["tracks"] > 40, f"retrieval: {rt['tracks']} tracks")
    _check(rt["ate_over_extent"] < 0.08, f"retrieval: ATE over extent {rt['ate_over_extent']}")
    _check_pins("scale retrieval", rt, PIN_SCALE["retrieval"])

    sb, sc = extra["selfcal_ba"], runs["selfcal"]
    _check(abs(sb["s"] - 1 / 1.06) < 0.01, f"selfcal BA: s = {sb['s']}")
    _check(sb["final_mean_error"] < 0.35, f"selfcal BA: {sb['final_mean_error']} px")
    _check(abs(sb["s"] - sb["s_cpu"]) < 1e-3, f"selfcal BA: card s {sb['s']} vs CPU {sb['s_cpu']}")
    _check(f"focal self-calibration: cumulative scale {sc['focal_scale']:.4f}" in sc["warnings"],
           f"selfcal CLI warnings {sc['warnings']}")
    _check(sc["reproj_after_px"] <= sc["reproj_before_px"], "selfcal CLI: BA made it worse")
    _check(abs(sc["focal_scale"] - 1.0) < 0.05, f"selfcal CLI: focal scale {sc['focal_scale']}")
    _check(sc["cameras"] == SELFCAL_VIEWS - 1, f"selfcal CLI: {sc['cameras']} cameras")
    return kf["launches"]


def _superpoint_compare(card, cpu):
    """Keypoint Jaccard (masked (x, y) sets) and descriptor cosines on the
    shared keypoints of one image's card and CPU SuperPoint Features."""
    import numpy as np

    def kp(f):
        m = f.keypoints.mask.cpu().numpy()
        xy = np.stack([f.keypoints.x.cpu().numpy(), f.keypoints.y.cpu().numpy()], 1)
        return {tuple(p): r for r, p in enumerate(xy.tolist()) if m[r]}

    a, b = kp(card), kp(cpu)
    shared = sorted(set(a) & set(b))
    da = card.descriptors.cpu().numpy()[[a[p] for p in shared]]
    db = cpu.descriptors.cpu().numpy()[[b[p] for p in shared]]
    cos = (da * db).sum(-1) / np.maximum(
        np.linalg.norm(da, axis=-1) * np.linalg.norm(db, axis=-1), 1e-12)
    return len(shared) / max(len(set(a) | set(b)), 1), cos, len(a)


def _dlt_problem(rng, n: int = 2000, outliers: float = 0.3):
    """A seeded 2D-3D problem at the bench's intrinsics: world points 4-8
    units in front of a camera turned 3 deg and moved 0.3, pixels with
    0.5 px noise, a share of outliers anywhere in the 360x480 frame, and the
    last 50 points masked out. Returns numpy (X, x, K, mask, R, t) and the
    mask of the valid points that are not outliers."""
    import numpy as np

    K = np.array([[520.0, 0, 240.0], [0, 520.0, 180.0], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)], 1)
    a = np.radians(3.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.3, -0.05, 0.1])
    c = X @ R.T + t
    x = c[:, :2] / c[:, 2:] * 520.0 + [240.0, 180.0] + rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, int(outliers * n), replace=False)
    x[out] = rng.uniform([0, 0], [480, 360], (len(out), 2))
    mask = np.ones(n, bool)
    mask[-50:] = False
    clean = mask.copy()
    clean[out] = False
    return (X.astype(np.float32), x.astype(np.float32), K, mask, R, t), clean


def _rot_gap_deg(Ra, Rb) -> float:
    """Angle between two rotations from their Frobenius distance: exact at
    float32 noise, where arccos of the trace is not."""
    import numpy as np

    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0))))


def extractors_phase(dev, peaks):
    """The engines' other front ends and fixed-count RANSAC at the bench
    widths, each run's launches counted:

    1. dog: ``SfmEngine(feature_extractor=make_dog_extractor(...))`` on the
       bench sequence;
    2. hybrid: ``make_hybrid_extractor(k=HYBRID_K)`` (TinyPoint) there;
    3. fixed: ``SfmEngine`` with ``RansacConfig(**FIXED_RANSAC)`` there
       (fixed-count filter and bootstrap of 5,967 hypotheses, P3P at 5,967);
    4. global_fixed: ``GlobalSfmEngine`` with the same RANSAC settings on
       the global phase's orbit cut to ``GLOBAL_FIXED_VIEWS`` views;
    5. superpoint: the full-width ``SuperPointNet`` (random initialisation
       from seed 0) on the bench images on the card and on the CPU, and the
       matcher kernel at D=256 on its consecutive-pair descriptors;
    6. dlt: ``pnp_ransac(solver="dlt")`` on ``_dlt_problem`` and ``pnp()``
       on its outlier-free points, card against CPU on the same uniforms.

    Returns (launches per run, the D=256 matcher row)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.config import RansacConfig
    from sfmfromscratch_tpu_torch.geometry.pnp import pnp, pnp_ransac
    from sfmfromscratch_tpu_torch.io.images import load_image
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
    from sfmfromscratch_tpu_torch.ops.superpoint import SuperPointExtractor, make_hybrid_extractor
    from sfmfromscratch_tpu_torch.pipeline.frontend import make_dog_extractor, preprocess_image
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    cfg = engine_config()
    fixed = dataclasses.replace(cfg, ransac=RansacConfig(**FIXED_RANSAC))
    n = EXTRACTOR_VIEWS

    def timed(fn):
        _zero_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _launch_counts()

    runs, extra = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extractors_") as tmp:
        seq = os.path.join(tmp, "bench")
        os.makedirs(seq)
        K, gt = bench_sequence(seq, n)
        engines = {
            "dog": lambda: SfmEngine(seq, n, config=cfg, single_K=K, device=dev,
                                     feature_extractor=make_dog_extractor(cfg.extractor)),
            "hybrid": lambda: SfmEngine(seq, n, config=cfg, single_K=K, device=dev,
                                        feature_extractor=make_hybrid_extractor(k=HYBRID_K)),
            "fixed": lambda: SfmEngine(seq, n, config=fixed, single_K=K, device=dev),
        }
        for label, make in engines.items():
            eng, wall, launches = timed(make)
            runs[label] = _global_row(eng, gt, wall, launches, first_image=2)
            runs[label]["filter_hyps_used"] = np.asarray(eng.filter_hyps_used).tolist()
            runs[label]["pnp_hypotheses"] = int(eng._pnp_hyp)

        orbit = os.path.join(tmp, "orbit")
        os.makedirs(orbit)
        Ko, gto = orbit_sequence(orbit, GLOBAL_FIXED_VIEWS, 4.0)
        eng, wall, launches = timed(lambda: GlobalSfmEngine(orbit, GLOBAL_FIXED_VIEWS, config=fixed,
                                                            single_K=Ko, device=dev))
        runs["global_fixed"] = _global_row(eng, gto, wall, launches)
        runs["global_fixed"].update(
            edges=len(eng._edges), filter_hyps_used=np.asarray(eng.filter_hyps_used).tolist(),
            camera0_identity=bool(np.allclose(np.hstack(eng.global_poses[0]), 0.0, atol=1e-5)))

        # Full-width SuperPoint, card against CPU on the same images.
        imgs = [preprocess_image(load_image(os.path.join(seq, f"{i}.jpg")), 1.0, dev)
                for i in range(1, n + 1)]
        sp_card, sp_cpu = SuperPointExtractor(None, seed=0), SuperPointExtractor(None, seed=0)
        sp_card(imgs[0], k=SUPERPOINT_K)   # moves the net, first cuDNN plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_card = [sp_card(im, k=SUPERPOINT_K) for im in imgs]
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3 / n
        t0 = time.perf_counter()
        f_cpu = [sp_cpu(im.cpu(), k=SUPERPOINT_K) for im in imgs]
        cpu_ms = (time.perf_counter() - t0) * 1e3 / n
        cmp = [_superpoint_compare(a, b) for a, b in zip(f_card, f_cpu)]
        cos = np.concatenate([c[1] for c in cmp])
        d1 = torch.stack([f.descriptors for f in f_card[:-1]])
        d2 = torch.stack([f.descriptors for f in f_card[1:]])
        mask2 = torch.stack([f.keypoints.mask for f in f_card[1:]])
        d256 = _match_row(f"match f32 superpoint {tuple(d1.shape)}", MK, d1, d2, mask2, False, peaks)
        extra["superpoint"] = dict(
            k=SUPERPOINT_K, descriptor_dim=int(d1.shape[-1]), card_ms_per_image=card_ms,
            cpu_ms_per_image=cpu_ms, keypoints=[c[2] for c in cmp],
            keypoint_jaccard=[c[0] for c in cmp], desc_cosine_min=float(cos.min()),
            desc_cosine_mean=float(cos.mean()), shared_keypoints=int(len(cos)))

        # DLT PnP, card against CPU on the same uniforms.
        (X, x, Kd, m, R_gt, t_gt), clean = _dlt_problem(np.random.default_rng(11))
        u = torch.rand((RansacConfig().num_iterations(), 6),
                       generator=torch.Generator().manual_seed(3))
        dlt = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            args = [torch.as_tensor(a, device=d) for a in (X, x, Kd)]
            ransac = lambda: pnp_ransac(None, *args, torch.as_tensor(m, device=d),
                                        num_hypotheses=u.shape[0], solver="dlt", uniforms=u)
            plain = lambda: pnp(*args, torch.as_tensor(clean, device=d))
            (r, wall_r, _), (q, wall_q, _) = timed(ransac), timed(plain)
            dlt[name] = dict(ransac_s=wall_r, pnp_s=wall_q, ransac=r, pnp=q)
        rows = {}
        for which in ("ransac", "pnp"):
            a, b = dlt["card"][which], dlt["cpu"][which]
            Ra, Rb = (v.R.cpu().numpy().astype(np.float64) for v in (a, b))
            ta, tb = (v.t.cpu().numpy().astype(np.float64) for v in (a, b))
            rows[which] = dict(
                ok=[bool(a.ok), bool(b.ok)], inliers=[int(a.num_inliers), int(b.num_inliers)],
                card_vs_cpu_rot_deg=_rot_gap_deg(Ra, Rb),
                card_vs_cpu_t=float(np.linalg.norm(ta - tb)),
                rot_err_deg=_rot_gap_deg(Ra, R_gt),
                t_err=float(np.linalg.norm(ta - t_gt)),
                card_s=dlt["card"][f"{which}_s"], cpu_s=dlt["cpu"][f"{which}_s"])
        extra["dlt"] = dict(rows, hypotheses=int(u.shape[0]), points=int(len(X)),
                            outlier_free=int(clean.sum()))
    extra["phase_s"] = time.perf_counter() - t_phase

    want = {k: dict(v, **{"match_top2_fused(bf16=True)": 0}) for k, v in EXTRACTOR_LAUNCHES.items()}
    _print({"phase": "extractors", "runs": runs, **extra, "match_d256": d256,
            "pins": PIN_EXTRACTORS, "launches": want})
    for label, w in want.items():
        _check(runs[label]["launches"] == w,
               f"extractors {label} launches {runs[label]['launches']} != {w}")
    for label in ("dog", "hybrid", "fixed"):
        _check(runs[label]["cameras"] == n - 1, f"extractors {label}: {runs[label]['cameras']} cameras")
    fx = runs["fixed"]
    _check(fx["pnp_hypotheses"] == 5967, f"fixed: PnP at {fx['pnp_hypotheses']} hypotheses")
    _check(fx["filter_hyps_used"] == [5967] * (n - 2), f"fixed: filter {fx['filter_hyps_used']}")
    gf = runs["global_fixed"]
    _check(gf["cameras"] == GLOBAL_FIXED_VIEWS, f"global_fixed: {gf['cameras']} cameras")
    _check(gf["camera0_identity"], "global_fixed: camera 0 is not the identity")
    _check(set(gf["filter_hyps_used"]) == {5967}, f"global_fixed: filter {gf['filter_hyps_used']}")
    for label in want:
        _check_pins(f"extractors {label}", runs[label], PIN_EXTRACTORS[label])
    sp = extra["superpoint"]
    _check(sp["descriptor_dim"] == 256, f"superpoint: D={sp['descriptor_dim']}")
    _check(min(sp["keypoint_jaccard"]) >= SP_KP_JACCARD,
           f"superpoint: keypoint Jaccard {sp['keypoint_jaccard']} < {SP_KP_JACCARD}")
    _check(sp["desc_cosine_min"] >= SP_DESC_COSINE,
           f"superpoint: descriptor cosine {sp['desc_cosine_min']} < {SP_DESC_COSINE}")
    for which, r in extra["dlt"].items():
        if not isinstance(r, dict):
            continue
        _check(all(r["ok"]), f"dlt {which}: ok {r['ok']}")
        _check(abs(r["inliers"][0] - r["inliers"][1]) <= DLT_INLIER_GAP,
               f"dlt {which}: inliers card {r['inliers'][0]} vs CPU {r['inliers'][1]}")
        _check(r["card_vs_cpu_rot_deg"] <= DLT_CARD_CPU_ROT_DEG,
               f"dlt {which}: card vs CPU rotation {r['card_vs_cpu_rot_deg']} deg")
        _check(r["rot_err_deg"] <= DLT_ROT_ERR_DEG, f"dlt {which}: rotation error {r['rot_err_deg']} deg")
    launches = {name: {label: r["launches"][name] for label, r in runs.items()}
                for name in runs["dog"]["launches"]}
    return launches, d256


def _kp_desc_agreement(card, cpu):
    """Keypoint Jaccard of two (x, y) keypoint lists and the share of the
    shared keypoints' descriptor rows within DESC_ATOL, for the compat
    extractors' outputs (numpy, valid keypoints only)."""
    import numpy as np

    (xg, yg, dg), (xc, yc, dc) = card, cpu
    a = {(int(x), int(y)): r for r, (x, y) in enumerate(zip(xg, yg))}
    b = {(int(x), int(y)): r for r, (x, y) in enumerate(zip(xc, yc))}
    shared = sorted(set(a) & set(b))
    diff = np.abs(dg[[a[p] for p in shared]] - dc[[b[p] for p in shared]]).max(-1)
    return len(shared) / max(len(set(a) | set(b)), 1), float((diff <= DESC_ATOL).mean())


def compat_phase(dev, engine_ba):
    """The reference's class API (``compat.py``) and the engine's odd inputs
    on the card at the bench widths, each run's launches counted:

    1. ``NaiveSIFT`` and ``ScaleRotInvSIFT`` on bench view 1 (360x480), card
       against CPU, and ``ScaleRotInvSIFT`` on view 2;
    2. ``NNRatioFeatureMatcher`` on the two views' descriptors, card against
       the CPU's whole chain; the compat ``FeatureRunner`` on the two views;
    3. ``find_inliers`` on those matches, ``CameraPose.ransac_camera_motion``
       on its inliers with the canonical base and with view 1's true pose as
       the base, ``triangulate_points`` and
       ``non_linear_triangulation``, ``PnPRansac`` and ``PnP`` on the
       triangulated inliers, card against CPU on the same uniforms;
    4. ``BundleAdjustment.sparse_bundle_adjustment`` on the engine phase's
       BA problem (unpadded), card against CPU;
    5. ``SFMRunner`` on the bench sequence rendered at 720x960 (f=1040);
    6. ``SfmEngine`` on the bench sequence with view 2 padded by 16 px;
    7. ``SfmEngine(max_img=2)`` on the slice phase's pair;
    8. an ``AsyncCheckpointer`` round trip of the mixed-size run's state.

    Returns the launches per run."""
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch import compat
    from sfmfromscratch_tpu_torch.ops.lie import so3_exp
    from sfmfromscratch_tpu_torch.pipeline.checkpoint import AsyncCheckpointer
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    t_phase = time.perf_counter()
    launches, row = {}, {"phase": "compat"}

    def counted(name, fn):
        _zero_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = _launch_counts()
        return out

    def check_launches(name):
        want = dict(COMPAT_LAUNCHES[name], **{"match_top2_fused(bf16=True)": 0})
        _check(launches[name] == want, f"compat {name} launches {launches[name]} != {want}")

    # 1-2. Extractors and the matcher on the bench pair (gray views).
    mod = _render_module()
    images, K, poses, _ = mod.render_sequence(
        np.random.default_rng(7), num_views=10, num_points=600, img_hw=(360, 480), f=520.0,
        step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004))
    v1, v2 = (np.asarray(im, np.float32) for im in images[1:3])
    _, _, _, R_gt, t_gt = bench_pair()
    params = dict(BENCH_EXTRACTOR)

    def extract(cls, img, device):
        ext = getattr(compat, cls)(img, params, device=device)
        x, y = ext.detect_keypoints()
        return x, y, ext.extract_descriptors()

    naive = counted("naive_sift", lambda: extract("NaiveSIFT", v1, dev))
    sriv1 = counted("scale_rot_inv_sift", lambda: extract("ScaleRotInvSIFT", v1, dev))
    sriv2 = extract("ScaleRotInvSIFT", v2, dev)
    agree = {"naive_sift": _kp_desc_agreement(naive, extract("NaiveSIFT", v1, "cpu"))}
    sriv1_cpu = extract("ScaleRotInvSIFT", v1, "cpu")
    sriv2_cpu = extract("ScaleRotInvSIFT", v2, "cpu")
    agree["scale_rot_inv_sift"] = _kp_desc_agreement(sriv1, sriv1_cpu)
    matcher = compat.NNRatioFeatureMatcher(BENCH_MATCHER["ratio_threshold"], device=dev)
    m, conf = counted("nn_ratio_matcher",
                      lambda: matcher.match_features_ratio_test(sriv1[2], sriv2[2]))
    m_cpu, _ = compat.NNRatioFeatureMatcher(BENCH_MATCHER["ratio_threshold"], device="cpu"
                                            ).match_features_ratio_test(sriv1_cpu[2], sriv2_cpu[2])
    sm, sc = {tuple(r) for r in m.tolist()}, {tuple(r) for r in m_cpu.tolist()}
    match_jaccard = len(sm & sc) / max(len(sm | sc), 1)
    fr = counted("feature_runner", lambda: compat.FeatureRunner(
        np.stack([v1] * 3, -1), np.stack([v2] * 3, -1), scale_factor=1.0,
        extractor_params=params, match_threshold=BENCH_MATCHER["ratio_threshold"], device=dev))
    row.update(keypoints={"naive_sift": len(naive[0]), "view1": len(sriv1[0]),
                          "view2": len(sriv2[0])},
               card_vs_cpu={k: {"keypoint_jaccard": a, "descriptor_rows_within_atol": d}
                            for k, (a, d) in agree.items()},
               matcher_shape=[1, len(sriv1[2]), len(sriv2[2]), 128], matches=len(m),
               matches_cpu=len(m_cpu), match_jaccard=match_jaccard,
               feature_runner_matches=int(fr.matches.mask.sum()))
    for name, (jac, share) in agree.items():
        _check(jac >= KP_JACCARD, f"compat {name} keypoint agreement {jac} < {KP_JACCARD}")
        _check(share >= DESC_SHARE, f"compat {name} descriptor agreement {share} < {DESC_SHARE}")
    _check(match_jaccard >= MATCH_JACCARD, f"compat match agreement {match_jaccard}")
    _check(bool(np.all(np.diff(conf) >= -1e-6)), "compat matches not sorted best-first")
    for name in ("naive_sift", "scale_rot_inv_sift", "nn_ratio_matcher", "feature_runner"):
        check_launches(name)

    # 3. Two-view geometry on the matches (integer keypoint pixels).
    p1 = np.stack([sriv1[0][m[:, 0]], sriv1[1][m[:, 0]]], 1).astype(np.float64)
    p2 = np.stack([sriv2[0][m[:, 1]], sriv2[1][m[:, 1]]], 1).astype(np.float64)
    hyp = 5967
    u8 = torch.rand((hyp, 8), generator=torch.Generator().manual_seed(BENCH_SEED))
    u3 = torch.rand((100, 3), generator=torch.Generator().manual_seed(BENCH_SEED))
    R1_gt, t1_gt = poses[1]
    geo = {}
    for dv in (dev, "cpu"):
        out = {"inliers": compat.CameraPose.find_inliers(p1, p2, max_iterations=hyp, device=dv,
                                                         uniforms=u8)}
        cp = compat.CameraPose(*out["inliers"], K, K, device=dv)
        out["canonical"] = cp.ransac_camera_motion(np.eye(3), np.zeros(3), max_iterations=hyp,
                                                   uniforms=u8)
        out["base"] = cp.ransac_camera_motion(R1_gt, t1_gt, max_iterations=hyp, uniforms=u8)
        R, t, in1, in2 = out["canonical"]
        P1 = compat.CameraPose.calculate_projection_matrix(np.eye(3), np.zeros(3), K)
        P2 = compat.CameraPose.calculate_projection_matrix(R, t, K)
        X = compat.CameraPose.triangulate_points(in1, in2, P1, P2, device=dv)
        out["X"] = compat.CameraPose.non_linear_triangulation(X, in1, in2, P1, P2, device=dv)
        out["reproj"] = compat.print_reprojection_error(out["X"], in1, in2, P1, P2, device=dv)
        out["pnp_ransac"] = compat.PnPRansac(out["X"], in2, K=K, device=dv, uniforms=u3)
        out["pnp"] = compat.PnP(out["X"], in2, K=K, device=dv)
        geo["card" if dv == dev else "cpu"] = out
    g, c = geo["card"], geo["cpu"]
    R, t, in1, _ = g["canonical"]
    rot, tdir = pose_errors(R, t, R_gt, t_gt)
    rot_b, tdir_b = pose_errors(g["base"][0], g["base"][1], R_gt, t_gt)
    tri_err = float(np.abs(g["X"] - c["X"]).max() / np.abs(c["X"]).max())
    pr, pp = g["pnp_ransac"], g["pnp"]
    row.update(ransac={"rot_err_deg": rot, "t_err_deg": tdir, "inliers": len(in1),
                       "base_rot_err_deg": rot_b, "base_t_err_deg": tdir_b,
                       "base_inliers": len(g["base"][2]),
                       "canonical_vs_base_rot_deg": _rot_gap_deg(R, g["base"][0]),
                       "card_vs_cpu_rot_deg": _rot_gap_deg(R, c["canonical"][0]),
                       "card_vs_cpu_base_rot_deg": _rot_gap_deg(g["base"][0], c["base"][0]),
                       "f_inliers": len(g["inliers"][0]), "f_inliers_cpu": len(c["inliers"][0])},
               triangulation={"points": len(g["X"]), "reproj_px": g["reproj"],
                              "card_vs_cpu_rel": tri_err},
               pnp={"ransac_ok": pr.R is not None, "pnp_ok": pp.R is not None})
    _check(rot <= PIN_ROT_DEG and tdir <= PIN_TDIR_DEG, f"compat canonical pose {rot}, {tdir} deg")
    _check(rot_b <= PIN_ROT_DEG and tdir_b <= PIN_TDIR_DEG,
           f"compat pose on a non-canonical base {rot_b}, {tdir_b} deg")
    _check(_rot_gap_deg(R, g["base"][0]) <= 2 * PIN_ROT_DEG, "compat canonical vs base gap")
    for key in ("canonical", "base"):
        _check(_rot_gap_deg(g[key][0], c[key][0]) <= RANSAC_ROT_GAP_DEG,
               f"compat {key} RANSAC card vs CPU rotation gap")
        _check(abs(len(g[key][2]) - len(c[key][2])) <= RANSAC_INLIER_GAP,
               f"compat {key} RANSAC card vs CPU inlier gap")
    _check(abs(len(g["inliers"][0]) - len(c["inliers"][0])) <= RANSAC_INLIER_GAP,
           "compat find_inliers card vs CPU gap")
    _check(len(g["inliers"][0]) >= COMPAT_MIN_F_INLIERS,
           f"compat find_inliers {len(g['inliers'][0])} < {COMPAT_MIN_F_INLIERS}")
    _check(bool(np.isfinite(g["X"]).all()) and tri_err <= COMPAT_TRI_RTOL,
           f"compat triangulation card vs CPU {tri_err}")
    _check(g["reproj"] <= PIN_REPROJ_PX, f"compat reprojection {g['reproj']} px")
    _check(pr.R is not None and pp.R is not None, "compat PnP found no pose")
    for name, est in (("PnPRansac", pr), ("PnP", pp)):
        gap = _rot_gap_deg(est.R, R)
        tgap = pose_errors(est.R, est.t.ravel(), R, t)[1]
        row["pnp"][name] = {"rot_gap_deg": gap, "tdir_gap_deg": tgap}
        _check(gap <= COMPAT_PNP_ROT_GAP_DEG and tgap <= COMPAT_PNP_TDIR_GAP_DEG,
               f"compat {name} vs the RANSAC pose: {gap}, {tgap} deg")

    # 4. BundleAdjustment on the engine phase's problem, unpadded.
    pb, O = engine_ba["problem"], engine_ba["observations"]
    C, P = engine_ba["cameras"], engine_ba["tracks"]
    args = dict(num_cameras=C, num_points=P, camera_indices=pb.obs_cam[:O].numpy(),
                point_indices=pb.obs_pt[:O].numpy(), points_2d=pb.obs_xy[:O].numpy(),
                camera_params=pb.cam_params[:C].numpy(), points_3d=pb.points[:P].numpy(),
                K_list=pb.K[:C].numpy())
    errs = {}
    for dv in (dev, "cpu"):
        ba = compat.BundleAdjustment(**args, device=dv)
        t0 = time.perf_counter()
        cams, pts = ba.sparse_bundle_adjustment()
        r = ba.compute_residuals(np.hstack([cams.ravel(), pts.ravel()]), C, P,
                                 args["camera_indices"], args["point_indices"],
                                 args["points_2d"], args["K_list"]).reshape(-1, 2)
        errs["card" if dv == dev else "cpu"] = (float(np.linalg.norm(r, axis=1).mean()),
                                                time.perf_counter() - t0)
    (e_card, s_card), (e_cpu, s_cpu) = errs["card"], errs["cpu"]
    row["bundle_adjustment"] = {"cameras": C, "points": P, "observations": O,
                                "reproj_card_px": e_card, "reproj_cpu_px": e_cpu,
                                "card_s": s_card, "cpu_s": s_cpu}
    _check(bool(np.isfinite([e_card, e_cpu]).all()), "compat BA non-finite error")
    _check(abs(e_card - e_cpu) <= BA_FINAL_RTOL * e_cpu, f"compat BA card {e_card} vs CPU {e_cpu}")

    # 5-8. SFMRunner, mixed sizes, two images, the checkpointer.
    cfg = engine_config()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compat_") as tmp:
        runs = {}
        for name, make in (("sfmrunner", compat_sequence), ("mixed", mixed_size_sequence)):
            seq = os.path.join(tmp, name)
            os.makedirs(seq)
            Kq, gt = make(seq)
            t0 = time.perf_counter()
            if name == "sfmrunner":
                eng = counted(name, lambda: compat.SFMRunner(
                    seq, COMPAT_VIEWS, params, match_threshold=BENCH_MATCHER["ratio_threshold"],
                    single_K=Kq, device=dev).engine)
            else:
                eng = counted(name, lambda: SfmEngine(seq, 10, config=cfg, single_K=Kq,
                                                      device=dev))
            ate, extent = trajectory_error(eng.global_poses, gt)
            e0, e1 = eng.errors_before_after_ba
            runs[name] = eng
            row[name] = {"wall_s": time.perf_counter() - t0, "cameras": len(eng.global_poses),
                         "ate_over_extent": ate / extent, "reproj_before_px": e0,
                         "reproj_after_px": e1, "tracks": eng.map.num_tracks,
                         "launches": launches[name], "pins": PIN_COMPAT[name]}
            pins = PIN_COMPAT[name]
            _check(len(eng.global_poses) == PIN_ENGINE_CAMERAS, f"compat {name} cameras")
            _check(bool(np.isfinite([ate, e0, e1]).all()), f"compat {name} non-finite")
            _check(ate / extent <= pins["ate_over_extent"], f"compat {name} ATE {ate / extent}")
            _check(e1 <= pins["reproj_px"], f"compat {name} reprojection {e1} px")
            _check(eng.map.num_tracks >= pins["min_tracks"], f"compat {name} tracks")
            check_launches(name)
        seq = os.path.join(tmp, "two")
        os.makedirs(seq)
        K2, R2_gt, t2_gt = two_image_sequence(seq)
        two = counted("two_image", lambda: SfmEngine(seq, 2, config=cfg, single_K=K2, device=dev))
        rv, tv = two.global_poses[0]
        R2 = so3_exp(torch.as_tensor(rv, dtype=torch.float32)).numpy()
        rot2, tdir2 = pose_errors(R2, tv, R2_gt, t2_gt)
        row["two_image"] = {"cameras": len(two.global_poses), "rot_err_deg": rot2,
                            "t_err_deg": tdir2, "tracks": two.map.num_tracks,
                            "reproj_after_px": two.errors_before_after_ba[1],
                            "launches": launches["two_image"]}
        _check(len(two.global_poses) == 1, "compat two-image run: want one pose")
        _check(rot2 <= PIN_ROT_DEG and tdir2 <= PIN_TDIR_DEG,
               f"compat two-image pose {rot2}, {tdir2} deg")
        check_launches("two_image")

        src = runs["mixed"]
        ck = AsyncCheckpointer(os.path.join(tmp, "ckpt"))
        ck.save(src, next_frame=11, step=1)
        ck.wait()
        back = SfmEngine(os.path.join(tmp, "mixed"), 10, config=cfg, device=dev, auto_run=False)
        nxt = ck.restore(back, step=1)
        same = (nxt == 11 and np.array_equal(back.map.points(), src.map.points())
                and all(np.array_equal(a, b) for a, b in zip(back.map.observations(),
                                                               src.map.observations()))
                and np.array_equal(np.hstack(back.global_poses), np.hstack(src.global_poses))
                and torch.equal(back._generator.get_state(), src._generator.get_state()))
        row["async_checkpointer"] = {"round_trip": bool(same), "tracks": back.map.num_tracks}
        _check(same, "compat AsyncCheckpointer round trip changed the state")
    row.update(launches=launches, wall_s=time.perf_counter() - t_phase)
    _print(row)
    return launches


def _run_rank_groups(groups, work, device, limit_s):
    """Start every group of ranks at once, each ``(target, world, args)``
    running ``target(rank, device, *args)`` in ``world`` spawned processes
    (``_mesh_rank_main``), and return each group's results in rank order. A
    rank that exits non-zero, or a wait past ``limit_s``, kills every rank
    of every group and fails the phase."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    procs = []
    for target, world, args in groups:
        store = os.path.join(work, f"store_{target}")
        procs += [ctx.Process(target=_mesh_rank_main,
                              args=(target, r, world, store, work, str(device), args))
                  for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            _check(not any(c not in (None, 0) for c in codes),
                   f"mesh: a rank failed (exit codes {codes})")
            _check(time.monotonic() < deadline, f"mesh: ranks still running after {limit_s} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    out = []
    for target, world, _ in groups:
        group = []
        for r in range(world):
            with open(os.path.join(work, f"{target}_rank{r}.pkl"), "rb") as f:
                group.append(pickle.load(f))
        out.append(group)
    return out


def _mesh_rank_main(target, rank, world, store, work, device, args):
    """One rank of the mesh phase on ``device``: a 1-rank group (over NCCL
    on the card), or ``world`` ranks over the backend ``init_distributed``
    chooses (gloo for ranks that share one card); runs ``target`` and
    leaves its result in ``work``."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel.mesh import init_distributed

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    timeout = timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S)
    if world == 1:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=1, rank=0,
                                timeout=timeout)
    else:
        backend = init_distributed(f"file://{store}", world, rank, device=dev, timeout=timeout)
    try:
        out = globals()[target](rank, dev, *args)
        out["backend"] = backend
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"{target}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _counting_all_reduce():
    """Count ``torch.distributed.all_reduce`` calls (the port's collective
    helpers call it through the module); returns the count's holder."""
    import torch.distributed as dist

    calls = [0]
    inner = dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    dist.all_reduce = counted
    return calls


def _ba_row(res, s=None):
    return dict(cams=res.cam_params.cpu().numpy(), points=res.points.cpu().numpy(),
                e0=float(res.initial_mean_error), e1=float(res.final_mean_error),
                iterations=int(res.iterations_used), s=None if s is None else float(s))


def _mesh_nccl_rank(rank, dev, work):
    """1-rank NCCL mesh: ``bundle_adjust_sharded`` on the engine phase's BA
    problem against the unsharded solve in this process."""
    import torch

    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem
    from sfmfromscratch_tpu_torch.parallel import bundle_adjust_sharded, make_mesh

    saved = torch.load(os.path.join(work, "engine_ba.pt"), weights_only=False)
    problem = BAProblem(*(None if v is None else v.to(dev) for v in saved["problem"]))
    calls = _counting_all_reduce()
    t0 = time.perf_counter()
    got = bundle_adjust_sharded(problem, make_mesh(1), **saved["kw"])
    _sync(dev)
    wall = time.perf_counter() - t0
    ref = bundle_adjust(problem, **saved["kw"])
    same = all(torch.equal(getattr(got, f), getattr(ref, f))
               for f in ("cam_params", "points", "final_cost", "final_mean_error"))
    return dict(same_bits=same and got.iterations_used == ref.iterations_used,
                same_as_engine=bool((got.points.cpu().numpy() == saved["points"]).all()),
                all_reduces=calls[0], wall_s=wall, **_ba_row(got))


def _mesh_gloo_rank(rank, dev, work, seq, orbit, K, Ko):
    """The 2-rank checks on the card (ranks share it over gloo): sharded BA
    and selfcal, ``tp_match_ratio_test``, ``SfmEngine(mesh)`` on the bench
    sequence, the sharded relative-pose RANSAC on its pairs and
    ``GlobalSfmEngine(mesh, stream)`` on the orbit cut."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.ba.problem import BAProblem, make_problem
    from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal
    from sfmfromscratch_tpu_torch.config import RansacConfig
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
    from sfmfromscratch_tpu_torch.parallel import bundle_adjust_sharded, make_mesh
    from sfmfromscratch_tpu_torch.parallel import tp_match_ratio_test
    from sfmfromscratch_tpu_torch.parallel.mesh import mesh_axis
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    out = {}
    mesh = make_mesh()                        # (data 2, model 1)
    mesh_m = make_mesh(model_parallel=2)      # (data 1, model 2)
    calls = _counting_all_reduce()

    def timed(fn):
        _zero_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        return res, time.perf_counter() - t0, _launch_counts()

    saved = torch.load(os.path.join(work, "engine_ba.pt"), weights_only=False)
    problem = BAProblem(*(None if v is None else v.to(dev) for v in saved["problem"]))
    calls[0] = 0
    res, wall, _ = timed(lambda: bundle_adjust_sharded(problem, mesh, **saved["kw"]))
    out["ba"] = dict(_ba_row(res), wall_s=wall, all_reduces=calls[0])

    pos, kw = focal_observable_arrays(np.random.default_rng(5))
    ba_kw = dict(max_iters=30, cg_iters=60, ftol=1e-12)
    fp = make_problem(*pos, **kw, device=dev)
    calls[0] = 0
    (res, s), wall, _ = timed(lambda: bundle_adjust_sharded(fp, mesh, selfcal=True, **ba_kw))
    out["selfcal"] = dict(_ba_row(res, s), wall_s=wall, all_reduces=calls[0])
    out["selfcal_ref"] = _ba_row(*bundle_adjust_selfcal(fp, **ba_kw))

    pair = torch.load(os.path.join(work, "bench_pair.pt"), weights_only=False)
    d1, m1, d2, m2 = (pair[k].to(dev) for k in ("d1", "m1", "d2", "m2"))
    tp, wall, launches = timed(lambda: tp_match_ratio_test(mesh_m, d1, d2, m1, m2,
                                                           ratio_threshold=0.85))
    out["tp_match"] = dict(indices=tp.indices.cpu().numpy(), confidence=tp.confidence.cpu().numpy(),
                           mask=tp.mask.cpu().numpy(), wall_s=wall, launches=launches)
    # The shard's kernel alone, rank 0 timing while rank 1 waits.
    ax = mesh_axis(mesh_m, "model")
    shard = d2.shape[0] // ax.size
    lo = ax.rank * shard
    dist.barrier()
    if rank == 0 and dev.type == "cuda":
        ms, seen = _profiled_ms(lambda: MK.match_top2_fused(d1, d2[lo:lo + shard], m2[lo:lo + shard]),
                                ("match_f32_kernel", "merge_segments_kernel"))
        out["tp_match"].update(shard_device_ms=ms, shard_kernel_activities=seen,
                               shard_shape=[1, d1.shape[0], shard, d1.shape[1]])
    dist.barrier()

    cfg = engine_config()
    calls[0] = 0
    eng, wall, launches = timed(lambda: SfmEngine(seq, 10, config=cfg, single_K=K, device=dev,
                                                  mesh=mesh))
    out["engine"] = dict(poses=[np.hstack(p) for p in eng.global_poses],
                         errors=[float(e) for e in eng.errors_before_after_ba],
                         tracks=eng.map.num_tracks, wall_s=wall, launches=launches,
                         stage_times_s=dict(eng.stage_times), all_reduces=calls[0],
                         ba_iterations=eng.ba_result.iterations_used,
                         finite=bool(np.isfinite(eng.map.points()).all()))

    pgs = [eng.pair_geometry[(i, i + 1)] for i in range(1, 10)]
    pairs = [torch.as_tensor(np.stack([getattr(pg, f) for pg in pgs]), device=dev)
             for f in ("p1", "p2", "K1", "K2", "mask")]
    pairs = [a.float() for a in pairs[:4]] + [pairs[4].bool()]
    out["ransac"] = {}
    for mode, ransac in (("adaptive", RansacConfig()), ("fixed", RansacConfig(adaptive=False))):
        gcfg = dataclasses.replace(cfg, ransac=ransac)
        sharded = GlobalSfmEngine(seq, 10, config=gcfg, device=dev, mesh=mesh, auto_run=False)
        single = GlobalSfmEngine(seq, 10, config=gcfg, device=dev, auto_run=False)
        got, wall, _ = timed(lambda: sharded._sharded_relative_poses(mesh_axis(mesh, "data"),
                                                                     *pairs))
        ref = single._relative_pose_batch(*pairs)
        out["ransac"][mode] = dict(
            same_bits=all(torch.equal(a, b) for a, b in zip(got, ref)), wall_s=wall,
            fields_equal={f: bool(torch.equal(a, b)) for f, a, b in zip(got._fields, got, ref)},
            fields_max_gap={f: float((a.double() - b.double()).abs().max())
                            for f, a, b in zip(got._fields, got, ref)},
            state=sharded._generator.get_state().numpy(),
            state_single=single._generator.get_state().numpy(),
            R=got.R.cpu().numpy(), num_inliers=got.num_inliers.cpu().numpy())

    calls[0] = 0
    g, wall, launches = timed(lambda: GlobalSfmEngine(orbit, MESH_GLOBAL_VIEWS, config=cfg,
                                                      single_K=Ko, device=dev, mesh=mesh,
                                                      **MESH_STREAM))
    st = g.stream_stats
    out["global"] = dict(poses=[np.hstack(p) for p in g.global_poses],
                         errors=[float(e) for e in g.errors_before_after_ba],
                         tracks=g.map.num_tracks, wall_s=wall, launches=launches,
                         stage_times_s=dict(g.stage_times), all_reduces=calls[0],
                         windows=st.windows_run,
                         resident=st.peak_resident_obs / max(st.total_obs, 1),
                         finite=bool(np.isfinite(g.map.points()).all()))
    return out


def _similarity_align(src, dst):
    """``src`` (N, 3) moved by the similarity that best maps it onto
    ``dst`` in least squares (Umeyama)."""
    import numpy as np

    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / (a * a).sum(1).mean()
    return scale * a @ R.T + md


def mesh_phase(dev, engine_ba):
    """Phase 10: the device mesh on the one card. A 1-rank NCCL group runs
    ``bundle_adjust_sharded`` on the engine phase's BA problem (the same bits
    as the unsharded solve); then ``MESH_RANKS`` ranks that share the card
    over gloo run ``_mesh_gloo_rank``'s checks, each held to the CPU tests'
    tolerances and the engine and mesh pins, every rank's result the same
    bits. Two ranks on one card measure correctness, not scaling. Returns
    the launches per rank of each mesh run."""
    import tempfile

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.ops.matcher import match_ratio_test
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as work:
        seq, orbit = os.path.join(work, "bench"), os.path.join(work, "orbit")
        os.makedirs(seq)
        os.makedirs(orbit)
        K, gt = bench_sequence(seq, 10)
        Ko, gto = orbit_sequence(orbit, MESH_GLOBAL_VIEWS, 4.0)
        torch.save(engine_ba, os.path.join(work, "engine_ba.pt"))

        # The bench pair's descriptors; the database gains masked rows up to
        # a multiple of the ranks (its 2,499 rows: one, for shards of 1,250).
        feats = SfmEngine(seq, 10, config=engine_config(), single_K=K, device=dev,
                          auto_run=False)._extract_all_features()
        d1, d2 = feats.descriptors[0], feats.descriptors[1]
        m1, m2 = feats.keypoints.mask[0], feats.keypoints.mask[1]
        pad = (-d2.shape[0]) % MESH_RANKS
        d2 = torch.cat([d2, d2.new_zeros((pad, d2.shape[1]))])
        m2 = torch.cat([m2, m2.new_zeros(pad)])
        ref = match_ratio_test(d1, d2, m1, m2, ratio_threshold=0.85, max_matches=d1.shape[0])
        torch.save({k: v.cpu() for k, v in dict(d1=d1, m1=m1, d2=d2, m2=m2).items()},
                   os.path.join(work, "bench_pair.pt"))

        t0 = time.perf_counter()
        (nccl,), ranks = _run_rank_groups(
            [("_mesh_nccl_rank", 1, (work,)),
             ("_mesh_gloo_rank", MESH_RANKS, (work, seq, orbit, K, Ko))], work, dev, MESH_LIMIT_S)
        groups_s = time.perf_counter() - t0

    r0 = ranks[0]
    eng_rows, glob_rows = [], []
    for r in ranks:
        e, g = r["engine"], r["global"]
        ate, extent = trajectory_error([(p[:3], p[3:]) for p in e["poses"]], gt)
        eng_rows.append(dict(cameras=len(e["poses"]), ate_over_extent=ate / extent,
                             reproj_before_px=e["errors"][0], reproj_after_px=e["errors"][1],
                             tracks=e["tracks"], finite=e["finite"]))
        ate, extent = trajectory_error([(p[:3], p[3:]) for p in g["poses"]], gto, first_image=1)
        glob_rows.append(dict(cameras=len(g["poses"]), ate_over_extent=ate / extent,
                              reproj_before_px=g["errors"][0], reproj_after_px=g["errors"][1],
                              tracks=g["tracks"], finite=g["finite"]))
    ref_idx = ref.indices.cpu().numpy()
    ref_mask = ref.mask.cpu().numpy()
    ref_set = {tuple(x) for x in ref_idx[ref_mask]}
    tp = r0["tp_match"]
    tp_set = {tuple(x) for x in tp["indices"][tp["mask"]]}
    ref_conf = np.sort(ref.confidence.cpu().numpy()[ref_mask])
    tp_conf = np.sort(tp["confidence"][tp["mask"]])
    # The engine's problem has a free similarity gauge (image 1 is not in
    # it) and 2-view tracks nearly free along their rays (ROADMAP.md
    # section 3), so the points are compared on tracks of 3 or more views,
    # after aligning the gauge on them.
    ba_ref = engine_ba
    prob = engine_ba["problem"]
    views = np.bincount(prob.obs_pt[prob.obs_w > 0].numpy(), minlength=prob.num_points)
    multi = views >= 3
    ba_pts = _similarity_align(r0["ba"]["points"][multi], ba_ref["points"][multi])
    rows = dict(
        ranks=MESH_RANKS, backend_ranks=r0["backend"], backend_one_rank=nccl["backend"],
        staged_collectives=[], groups_wall_s=groups_s,
        nccl_ba=dict(same_bits=nccl["same_bits"], same_as_engine=nccl["same_as_engine"],
                     reproj_after_px=nccl["e1"], iterations=nccl["iterations"],
                     all_reduces=nccl["all_reduces"], wall_s=nccl["wall_s"]),
        per_rank=[dict(
            ba=dict(reproj_after_px=r["ba"]["e1"], iterations=r["ba"]["iterations"],
                    all_reduces=r["ba"]["all_reduces"], wall_s=r["ba"]["wall_s"]),
            selfcal=dict(s=r["selfcal"]["s"], s_unsharded=r["selfcal_ref"]["s"],
                         reproj_after_px=r["selfcal"]["e1"],
                         reproj_after_px_unsharded=r["selfcal_ref"]["e1"],
                         iterations=r["selfcal"]["iterations"],
                         all_reduces=r["selfcal"]["all_reduces"], wall_s=r["selfcal"]["wall_s"]),
            tp_match={k: v for k, v in r["tp_match"].items()
                      if k not in ("indices", "confidence", "mask")},
            engine=dict(eng_rows[i], wall_s=r["engine"]["wall_s"], launches=r["engine"]["launches"],
                        stage_times_s=r["engine"]["stage_times_s"],
                        all_reduces=r["engine"]["all_reduces"],
                        ba_iterations=r["engine"]["ba_iterations"]),
            ransac={m: dict(same_bits=v["same_bits"], wall_s=v["wall_s"],
                            fields_equal=v["fields_equal"], fields_max_gap=v["fields_max_gap"],
                            state_equal=bool(np.array_equal(v["state"], v["state_single"])))
                    for m, v in r["ransac"].items()},
            global_=dict(glob_rows[i], wall_s=r["global"]["wall_s"],
                         launches=r["global"]["launches"], windows=r["global"]["windows"],
                         resident=r["global"]["resident"],
                         stage_times_s=r["global"]["stage_times_s"],
                         all_reduces=r["global"]["all_reduces"]),
        ) for i, r in enumerate(ranks)],
        unsharded=dict(ba_reproj_after_px=ba_ref["e1"], matches=len(ref_set)),
        ba_points_max_gap=float(np.abs(r0["ba"]["points"] - ba_ref["points"]).max()),
        ba_points_3plus=int(multi.sum()),
        ba_points_3plus_max_gap_aligned=float(np.abs(ba_pts - ba_ref["points"][multi]).max()),
        ba_points_3plus_within_tol=float(np.isclose(ba_pts, ba_ref["points"][multi], rtol=0.05,
                                                    atol=0.02).all(1).mean()),
        tp_matches=len(tp_set), phase_s=time.perf_counter() - t_phase,
        note="ranks share one card: these walls check correctness, not scaling",
        pins={"engine": {"cameras": PIN_ENGINE_CAMERAS, "ate_over_extent": PIN_ENGINE_ATE,
                         "reproj_px": PIN_ENGINE_REPROJ_PX, "min_tracks": PIN_ENGINE_MIN_TRACKS},
              "global": PIN_MESH_GLOBAL, "launches": MESH_LAUNCHES})
    _print(dict(phase="mesh", **rows))

    _check(r0["backend"] == "gloo" and nccl["backend"] == "nccl",
           f"backends {r0['backend']}, {nccl['backend']}")
    _check(nccl["same_bits"], "1-rank NCCL mesh: sharded BA differs from the unsharded solve")
    for r in ranks[1:]:
        for key in ("ba", "selfcal"):
            for f in ("cams", "points"):
                _check(np.array_equal(r[key][f], r0[key][f]), f"mesh {key}: ranks differ in {f}")
        for key in ("engine", "global"):
            _check(np.array_equal(np.stack(r[key]["poses"]), np.stack(r0[key]["poses"])),
                   f"mesh {key}: ranks' poses differ")
        for f in ("indices", "confidence", "mask"):
            _check(np.array_equal(r["tp_match"][f], tp[f]), f"mesh tp_match: ranks differ in {f}")
    b = r0["ba"]
    _check(abs(b["e1"] - ba_ref["e1"]) < 0.05, f"mesh BA: {b['e1']} px vs unsharded {ba_ref['e1']}")
    _check(bool(np.allclose(ba_pts, ba_ref["points"][multi], rtol=0.05, atol=0.02)),
           "mesh BA: points of 3+ views off the unsharded solve's")
    sc, scr = r0["selfcal"], r0["selfcal_ref"]
    _check(abs(sc["s"] - 1 / 1.06) < 0.01, f"mesh selfcal: s = {sc['s']}")
    _check(abs(sc["s"] - scr["s"]) < 5e-3, f"mesh selfcal: s {sc['s']} vs unsharded {scr['s']}")
    _check(abs(sc["e1"] - scr["e1"]) < 0.05, f"mesh selfcal: {sc['e1']} px vs {scr['e1']}")
    _check(tp_set == ref_set, f"mesh tp_match: {len(tp_set)} matches, unsharded {len(ref_set)}")
    _check(bool(np.allclose(tp_conf, ref_conf, atol=1e-5)), "mesh tp_match: confidences")
    for i, r in enumerate(ranks):
        _check(r["tp_match"]["launches"] == MESH_LAUNCHES["tp_match"],
               f"mesh tp_match launches on rank {i}: {r['tp_match']['launches']}")
        for mode, v in r["ransac"].items():
            for f in ("inliers", "num_inliers", "cheirality_ok"):
                _check(v["fields_equal"][f], f"mesh RANSAC {mode} on rank {i}: {f} differs")
            for f in ("R", "t", "F"):
                _check(v["fields_max_gap"][f] <= MESH_RANSAC_FLOAT_GAP,
                       f"mesh RANSAC {mode} on rank {i}: {f} off by {v['fields_max_gap'][f]}")
            _check(bool(np.array_equal(v["R"], r0["ransac"][mode]["R"])),
                   f"mesh RANSAC {mode}: rank {i}'s poses differ from rank 0's")
            _check(bool(np.array_equal(v["state"], v["state_single"])),
                   f"mesh RANSAC {mode} on rank {i}: generator state differs")
            _check(bool(np.array_equal(v["state"], r0["ransac"][mode]["state"])),
                   f"mesh RANSAC {mode}: rank {i}'s generator state differs from rank 0's")
        _check(r["engine"]["launches"] == MESH_LAUNCHES["engine"],
               f"mesh engine launches on rank {i}: {r['engine']['launches']}")
        _check(r["global"]["launches"] == MESH_LAUNCHES["global"],
               f"mesh global launches on rank {i}: {r['global']['launches']}")
    e = eng_rows[0]
    _check(e["cameras"] == PIN_ENGINE_CAMERAS, f"mesh engine: {e['cameras']} cameras")
    _check(e["finite"], "mesh engine: non-finite points")
    _check(e["ate_over_extent"] <= PIN_ENGINE_ATE, f"mesh engine: ATE over extent {e['ate_over_extent']}")
    _check(e["reproj_after_px"] <= PIN_ENGINE_REPROJ_PX, f"mesh engine: {e['reproj_after_px']} px")
    _check(e["tracks"] >= PIN_ENGINE_MIN_TRACKS, f"mesh engine: {e['tracks']} tracks")
    g = glob_rows[0]
    _check(g["cameras"] == MESH_GLOBAL_VIEWS, f"mesh global: {g['cameras']} cameras")
    _check(r0["global"]["windows"] >= 2, f"mesh global: {r0['global']['windows']} stream windows")
    _check(bool(np.allclose(r0["global"]["poses"][0], 0.0, atol=1e-5)),
           "mesh global: camera 0 is not the identity")
    _check(g["reproj_after_px"] <= g["reproj_before_px"], "mesh global: BA made it worse")
    _check_pins("mesh global", g, PIN_MESH_GLOBAL)
    return {run: r0[run]["launches"] for run in ("tp_match", "engine", "global")}


def main(argv) -> int:
    only_kernels = "--only-kernels" in argv
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
        from sfmfromscratch_tpu_torch.ops.cuda.build import SOURCES, build_all, build_log
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
        peaks = _peaks(name)
        print(smi, flush=True)
        _print({"phase": "device", "name": name, "nvidia_smi": smi, "build_s": build_s,
                "torch": torch.__version__, "cuda": torch.version.cuda, "peaks": peaks,
                "ptxas": {n: build_log(n) for n in SOURCES}})

        kernels = [harris_phase(dev, peaks), *match_phase(dev, peaks)]
        if only_kernels:
            _print({"kernels": kernels})
            print("chip_smoke: --only-kernels given: slice and engine phases skipped, "
                  "no result line", file=sys.stderr)
            return 0
        two_view = slice_phase(dev)
        launches, engine_ba = engine_phase(dev)
        global_ = global_phase(dev)
        orbit = orbit_phase(dev)
        host = host_phase(dev)
        scale = scale_phase(dev)
        extractors, d256 = extractors_phase(dev, peaks)
        mesh = mesh_phase(dev, engine_ba)
        compat_runs = compat_phase(dev, engine_ba)
        kernels[1]["superpoint_d256"] = d256
        for k in kernels:
            k["launches"] = launches.get(k["name"], 0)
            k["launches_two_view"] = two_view.get(k["name"], 0)
            k["launches_global"] = global_.get(k["name"], 0)
            k["launches_orbit"] = orbit.get(k["name"], 0)
            k["launches_host"] = host.get(k["name"], 0)
            k["launches_scale"] = scale.get(k["name"], 0)
            k["launches_extractors"] = extractors.get(k["name"], {})
            k["launches_mesh_per_rank"] = {run: n.get(k["name"], 0) for run, n in mesh.items()}
            k["launches_compat"] = {run: n.get(k["name"], 0) for run, n in compat_runs.items()}
        print(smi, flush=True)
        _print({"kernels": kernels})
        _print({"ok": True, "device": {"platform": "gpu", "kind": name,
                                       "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 - top level: report and fail
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
