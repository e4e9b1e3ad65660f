#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--only-kernels | --ladder-global]

Phases, each printing JSON lines:

1. device  — card name, ``nvidia-smi`` name and power limit, kernel build time
             (every ``csrc/*.cu`` built from the checkout, one nvcc each, in
             parallel) and nvcc's register, shared-memory and spill report.
2. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the engine's shapes (Harris B=10 per pyramid level, matcher
             B=9 pairs, f32 and bf16 modes), the two-view shapes, the extra
             regimes below, the ladder's ``L3h`` shapes (Harris B=20 at
             960x1280 and 800x1066, the matcher at B=19 x 4000 x 4000, with
             the card's peak memory of the pyramid, SIFT and the plain
             matcher there) and an exact-tie case, beside its bound, the plain
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
12. train  — TinyPoint's trainer (``ops/sp_train.py``): card against CPU
             over 5 steps from JAX's initial weights (losses and the first
             step's gradients), two card runs of 20
             steps bit for bit, the 1,500-step recipe timed (host
             ``make_batch``, device time and idle share) with its losses and
             corner hit rate, the hybrid engine on the trained checkpoint,
             and 20 steps of the full-width net. Held to pins beside the JAX
             trainer's CPU spread (``tools/train_pins.py``).
13. scenarios — the JAX package's scenario tests at their own scenes,
             configurations and seeds (a featureless frame, a duplicate
             frame, two images, degraded imaging for both engines, the
             20-degree pair and the 10-degree global run, per-image K from
             EXIF at full and half scale), then the bench sequence through
             ``SfmEngine`` with per-image K from EXIF (``camera_sensor``);
             launches counted per scenario; held to the JAX tests' own assertions
             and the bench run to the engine phase's pins
             (``tools/scenario_pins.py``).

14. ladder  — the JAX package's scale ladder (``benchmarks/ladder.py``) at its
             own configurations and scenes, none cut: ``SfmEngine`` on the
             47- and 100-view chains (``L3``, ``L4``), the 100-view chain
             with ``chain_refresh="averaging"`` (``L4r``) and the 960x1280
             rungs at 2,500 and 4,000 keypoints (``L2h``, ``L3h``); with
             ``--ladder-global`` also ``GlobalSfmEngine`` on the 47-view
             orbit (``L3g``) and the 1,000-view keyframed planes orbit
             (``L5``). Every scene is rendered before the runs (in parallel
             processes); each rung runs
             once, its launches counted; held to pins beside the JAX
             package's CPU spread (``tools/ladder_pins.py``), each row with
             its wall, stage times and the final BA's backend (dense or PCG).

The line before last is ``{"kernels": [...]}``, with each kernel's launch
counts on every path (engine, two-view, global, orbit, host, scale, per
run of the extractors, mesh, compat, train, scenarios and ladder phases, and
each kernel's ``ladder_path`` at ``L3h``'s shapes), the f32 matcher's row with
its D=256 case (``superpoint_d256``); the last is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result line. Without a CUDA card, or without the rest of the repository
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
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


# The train phase: TinyPoint's recipe (tools/train_superpoint.py's defaults,
# sp_train.py:278-279), the corner test of tests/test_extensions.py:51-70 at
# 20 shapes seeds, and the hybrid engine on the trained checkpoint.
TRAIN_STEPS = 1500
TRAIN_BATCH = 16
TRAIN_HW = (120, 160)
TRAIN_SEED = 0
TRAIN_LAST = 100            # the loss pins read the mean of the last 100 steps
HIT_SEEDS = tuple(range(20))
HIT_K = 128
HIT_PX = 4.0
TRAIN_CPU_STEPS = 5         # card against CPU from the same carried weights
# Card against CPU (chip run, NVIDIA H100 80GB HBM3, 700 W): the first
# step's losses the same bits, then 9.0e-6, 2.6e-5, 3.0e-4 and 6.8e-4
# relative at steps 1-4, also on dithered batches (2.4e-6, 2.4e-5, 3.7e-4,
# 2.2e-4): Adam's first step moves every weight by about lr whatever its
# gradient's size, so weights whose gradients sit at rounding level part by
# up to 2 lr, and the loss gap grows from step 3 on. Steps 0-2 are held to
# 1e-4, all five to 2e-3. The first step's gradients on the dithered first
# batch (no max-pool ties) are held to the same net in float64 on the CPU:
# on the card each tensor within 2e-4 of its largest |g| (measured 9.4e-5;
# with the backward outside the scope, in TF32, 8.7e-4; the CPU's own
# float32 6.0e-4 at this size, so the CPU's float32 is no reference here).
TRAIN_CPU_RTOL = 1e-4
TRAIN_CPU_RTOL_STEPS = 3
TRAIN_CPU_RTOL_LATE = 2e-3
TRAIN_GRAD_TOL = 2e-4
TRAIN_REPEAT_STEPS = 20     # two card runs, bit for bit
TRAIN_FULL_STEPS = 20       # the full-width net
TRAIN_PROFILE_STEPS = 20
# JAX's SuperPointNet.tiny() initialised at jax.random.key(0), in the npz
# format of save_flax_weights (python tools/train_pins.py --write-init).
TRAIN_INIT_NPZ = os.path.join("tests", "data", "tinypoint_init_key0.npz")
# Pins from the JAX trainer on the CPU at the recipe (tools/train_pins.py,
# training seeds 0-2, the hybrid engine at config.seed 0-9 on each
# checkpoint, 30 runs, every one registering 9 cameras):
#   last-100-step mean ld 2.877-2.941, ldesc 0.1732-0.1747;
#   corner hit rate 0.877-0.907 (the committed checkpoint 0.887);
#   hybrid ATE over extent 0.0131-0.1660, post-BA error 0.099-0.206 px,
#     tracks 785-923.
# The house rule: losses 1.25x the highest, the hit rate 0.9x the lowest,
# the hybrid run the engine pins' margins (1.6x, 1.6x, two thirds).
PIN_TRAIN_LD = 3.68
PIN_TRAIN_LDESC = 0.218
PIN_TRAIN_HIT_RATE = 0.789
PIN_TRAIN_HYBRID = dict(ate_over_extent=0.266, reproj_px=0.329, min_tracks=523)
TRAIN_LAUNCHES = {"recipe": {"harris_response_fused": 0, "match_top2_fused": 0},
                  "hybrid": {"harris_response_fused": 0, "match_top2_fused": 1},
                  "full_width": {"harris_response_fused": 0, "match_top2_fused": 0}}

# The scenarios phase: the JAX package's scenario tests, each at its own
# scene, configuration and seeds and held to its own assertions (cited beside
# each gate), and the bench sequence with per-image K from EXIF. The EXIF
# sensor of the bench run is ONE_INCH (12.8 x 9.6 mm), whose 4:3 aspect is
# the bench's 480x360, so a focal of 520 / 37.5 = 208/15 mm gives the render
# K (f = 520 px) on both axes.
EXIF_BENCH_SENSOR = "ONE_INCH"
EXIF_BENCH_FOCAL_MM = 520.0 / 37.5
# EXIF keeps FocalLength as a RATIONAL of two uint32s; 208/15 and 26/1 are
# exact, so a file's K differs from the render K by float64 rounding only
# (0 seen). Held to the JAX test's rtol (tests/test_exif.py:126, 135, 161).
EXIF_K_RTOL = 1e-6
# Each scenario's gates: (row key, operator, limit), the JAX test's own.
SCENARIO_GATES = {
    # tests/test_robustness.py:40-42, 46-48
    "featureless": [("incremental_cameras", "==", 5), ("incremental_recovery_warning", "==", True),
                    ("incremental_reproj_px", "<", 3.0), ("global_cameras", "==", 6),
                    ("global_components_warning", "==", True), ("global_reproj_px", "<", 3.0)],
    # tests/test_robustness.py:63, 67
    "duplicate": [("incremental_reproj_px", "<", 3.0), ("global_reproj_px", "<", 3.0)],
    # tests/test_robustness.py:82, 85
    "two_images": [("incremental_reproj_px", "<", 3.0), ("global_reproj_px", "<", 3.0)],
    # tests/test_adversarial.py:71-73
    "degraded_incremental": [("degraded_reproj_px", "<", 2.5), ("degraded_ate_pct", "<", 8.0),
                             ("degraded_tracks_over_clean", ">", 0.4)],
    # tests/test_adversarial.py:92, 97
    "degraded_global": [("reproj_px", "<", 2.0), ("ate_pct", "<", 8.0)],
    # tests/test_wide_baseline.py:37, 45
    "pair_20deg": [("matches", ">", 80), ("median_epipolar_px", "<", 1.5)],
    # tests/test_wide_baseline.py:68-69, 83
    "global_10deg": [("tracks", ">", 500), ("reproj_px", "<", 1.0), ("ate_pct", "<", 2.0)],
    # tests/test_exif.py:125-126, 131-135
    "exif": [("file_K_rel_gap", "<=", EXIF_K_RTOL), ("K_per_camera", "==", True),
             ("cameras", ">=", 3), ("engine_K_rel_gap", "<=", EXIF_K_RTOL),
             ("reproj_px", "<", 2.0)],
    # tests/test_exif.py:159-161
    "exif_half": [("engine_K_rel_gap", "<=", EXIF_K_RTOL)],
    # The bench run: the engine phase's pins and the EXIF K (this phase's own).
    "exif_bench": [("file_K_rel_gap", "<=", EXIF_K_RTOL), ("K_per_camera", "==", True),
                   ("engine_K_rel_gap", "<=", EXIF_K_RTOL),
                   ("cameras", "==", PIN_ENGINE_CAMERAS),
                   ("ate_over_extent", "<=", PIN_ENGINE_ATE),
                   ("reproj_px", "<=", PIN_ENGINE_REPROJ_PX),
                   ("tracks", ">=", PIN_ENGINE_MIN_TRACKS)],
}
SCENARIOS = tuple(SCENARIO_GATES)
SCENARIO_BUDGET_S = 120     # the phase's limit on the card, in seconds

# The ladder phase: the JAX package's scale ladder (benchmarks/ladder.py:
# 167-186), each rung at the ladder's own configuration (ladder.py:53-69,
# ``_cfg(kp)``), engine call and scene, none cut. Every scene is drawn from
# default_rng(7): the sprite orbit of ``_scene`` (300 points, 360x480,
# f=520; ladder.py:22-32), the planes of ``_scene_planes`` (240x320, f=400;
# ladder.py:35-50) and of ``run_incremental_planes`` (f = 1.2 * W / 2;
# ladder.py:128-164). (engine, views, keypoints, engine keywords, renderer,
# renderer keywords.)
LADDER_RUNGS = {
    # config 3: the 47-view chain (ladder.py:181)
    "L3": ("SfmEngine", 47, 600, {}, "render_sequence",
           dict(num_views=47, num_points=300, img_hw=(360, 480), f=520.0, orbit_step_deg=0.8)),
    # config 4: the 100-view chain (ladder.py:183)
    "L4": ("SfmEngine", 100, 600, {}, "render_sequence",
           dict(num_views=100, num_points=300, img_hw=(360, 480), f=520.0, orbit_step_deg=0.5)),
    # config 4 in the accuracy configuration (docs/PERFORMANCE.md:159)
    "L4r": ("SfmEngine", 100, 600, {"chain_refresh": "averaging"}, "render_sequence",
            dict(num_views=100, num_points=300, img_hw=(360, 480), f=520.0, orbit_step_deg=0.5)),
    # config 2h and 3h, the hi-res rungs (ladder.py:174-179)
    "L2h": ("SfmEngine", 10, 2500, {"chain_refresh": "averaging"}, "render_planes",
            dict(num_views=10, img_hw=(960, 1280), f=768.0, orbit_step_deg=2.0)),
    "L3h": ("SfmEngine", 20, 4000, {"chain_refresh": "averaging"}, "render_planes",
            dict(num_views=20, img_hw=(960, 1280), f=768.0, orbit_step_deg=1.5)),
    # config 3g, the 47-view global orbit (ladder.py:182)
    "L3g": ("GlobalSfmEngine", 47, 600, {"pair_window": 3}, "render_sequence",
            dict(num_views=47, num_points=300, img_hw=(360, 480), f=520.0, orbit_step_deg=4.0)),
    # config 5, the 1000-view keyframed planes orbit (ladder.py:184-186)
    "L5": ("GlobalSfmEngine", 1000, 400, {"pair_window": 3, "keyframe_step": "auto"},
           "render_planes", dict(num_views=1000, img_hw=(240, 320), f=400.0, orbit_step_deg=0.36)),
}
LADDER_DEFAULT = ("L3", "L4", "L4r", "L2h", "L3h")
LADDER_BA_AGAIN = ("L4",)          # the largest PCG problem, solved again (ladder_ba_again)
LADDER_GLOBAL = ("L3g", "L5")      # only under --ladder-global
# Launches per rung: Harris once per pyramid level (2) for the whole image
# batch; the matcher once for the chain's consecutive pairs (B = views - 1),
# once for the global run's window pairs, and three times on the keyframed
# run (the flow selection, the keyframe windows, the registration pairs).
LADDER_LAUNCHES = {name: {"harris_response_fused": 2, "match_top2_fused": 1}
                   for name in LADDER_RUNGS}
LADDER_LAUNCHES["L5"] = {"harris_response_fused": 2, "match_top2_fused": 3}
# Pins beside the JAX package's CPU spread over config.seed 0-4
# (tools/ladder_pins.py; every run registered every camera): incremental
# rungs 1.6x the worst ATE over extent and post-BA error and two thirds of
# the fewest tracks, global rungs 5x, 1.25x and 85% (rounded up to three
# digits, tracks down). JAX's ATE over extent, error (px) and tracks:
#   L3   0.2044-0.2596, 0.386-0.570, 3982-4640 (the plain chain bends on
#        orbits; final BA on PCG, 48 padded cameras)
#   L4   0.2420-0.2823, 0.474-0.834, 9643-10203 (PCG)
#   L4r  0.0059-0.0137, 0.181-0.192, 9643-10203 (PCG)
#   L2h  0.0176-0.1088, 0.133-0.531, 4070-4822 (dense)
#   L3h  0.0127-0.0366, 0.153-0.691, 12333-15100 (dense)
#   L3g  0.0011-0.0017, 0.242-0.251, 2515-2563 (PCG)
#   L5   0.0029-0.0035, 0.347-0.349, 3025-3074 (PCG; 44 keyframes)
PIN_LADDER = {
    "L3": dict(ate_over_extent=0.416, reproj_px=0.912, min_tracks=2654),
    "L4": dict(ate_over_extent=0.452, reproj_px=1.34, min_tracks=6428),
    "L4r": dict(ate_over_extent=0.0219, reproj_px=0.307, min_tracks=6428),
    "L2h": dict(ate_over_extent=0.175, reproj_px=0.851, min_tracks=2713),
    "L3h": dict(ate_over_extent=0.0587, reproj_px=1.11, min_tracks=8222),
    "L3g": dict(ate_over_extent=0.0087, reproj_px=0.314, min_tracks=2137),
    "L5": dict(ate_over_extent=0.0177, reproj_px=0.437, min_tracks=2571),
}
# The default rungs' engine walls together, in seconds: 67.6-80.0 s in two
# runs on an NVIDIA H100 80GB HBM3 at 700 W (L3 10.9-15.6, L4 27.4-28.4, L4r
# 21.0-26.7, L2h 2.7-3.6, L3h 5.6-5.7), with room for the host's spread (the
# host-bound engines have run 1.7x apart between calls). The renders (~80 s,
# in parallel) come on top.
LADDER_BUDGET_S = 160


def corner_hit_rate(detect, draw_shapes, seeds=HIT_SEEDS, hw=TRAIN_HW, px=HIT_PX):
    """The share of ``draw_shapes``' exact corners with a detection within
    ``px`` pixels, over the shapes of ``default_rng(seed)`` for each seed
    (``tests/test_extensions.py:51-70``). ``detect(image)`` takes a (H, W)
    float32 numpy image and returns the valid keypoints as (n, 2) numpy
    (x, y). Returns (hits, corners)."""
    import numpy as np

    hits = total = 0
    for seed in seeds:
        img, corners = draw_shapes(np.random.default_rng(seed), *hw)
        if len(corners) == 0:
            continue
        kp = np.asarray(detect(img), np.float64).reshape(-1, 2)
        if len(kp):
            d = np.linalg.norm(corners[:, None, :] - kp[None, :, :], axis=-1)
            hits += int((d.min(axis=1) <= px).sum())
        total += len(corners)
    return hits, total


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


def _harris_check(HK, img, G, sigma, alpha):
    """The Harris kernel against its plain version on ``img`` (B, H, W):
    finite, max |kernel - plain| <= HARRIS_TOL * max |plain R|."""
    import torch

    B, H, W = img.shape
    got = HK.harris_response_fused(img, G, sigma, alpha)
    ref = HK.harris_response(img, G, sigma, alpha)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    _check(bool(torch.isfinite(got).all()), f"harris {B}x{H}x{W}: non-finite")
    _check(err <= HARRIS_TOL * scale, f"harris {B}x{H}x{W}: max err {err} > {HARRIS_TOL} * {scale}")
    return dict(shape=[B, H, W], max_abs_err=err, max_abs_R=scale)


def _harris_case(HK, gen, dev, B, H, W, G, sigma, alpha, peaks):
    """The Harris kernel against its plain version on a random (B, H, W)
    stack, with its device, graph and call times, the plain version's and
    its bound (8 bytes a pixel, or the stencil's flops)."""
    import torch

    img = torch.rand((B, H, W), generator=gen, device=dev)
    row = _harris_check(HK, img, G, sigma, alpha)
    px = B * H * W
    row.update(_kernel_times(lambda: HK.harris_response_fused(img, G, sigma, alpha),
                             lambda: HK._launch(img, G, sigma, alpha), ("harris_kernel",)))
    row.update(plain_ms=_cuda_ms(lambda: HK.harris_response(img, G, sigma, alpha), reps=5),
               bound_ms=max(8.0 * px / peaks["bytes_per_s"],
                            px * (16 + 12 * G) / peaks["fp32_flops"]) * 1e3)
    return row


def harris_phase(dev, peaks):
    """Harris kernel vs plain at the engine's pyramid levels (B=10), the
    two-view's (B=1), the global engine's and the orbit's (B=20), the
    960x1280 regime and a width off the 16-byte path; returns the numbers of
    the engine's three launches, with each other path's."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK

    G, sigma, alpha = 7, 6.0, 0.05
    gen = torch.Generator(device=dev).manual_seed(0)
    # The last case's width is not a multiple of 4: the kernel's scalar path.
    cases = [(10, H, W) for H, W in ENGINE_LEVELS] + [(1, H, W) for H, W in ENGINE_LEVELS] \
        + [(20, H, W) for H, W in ENGINE_LEVELS] + [(20, *ORBIT_LEVELS[1])] \
        + [(1, 960, 1280), (2, 45, 61)] + [(SCALE_VIEWS, H, W) for H, W in ENGINE_LEVELS] \
        + [(10 // MESH_RANKS, H, W) for H, W in ENGINE_LEVELS]
    rows = [_harris_case(HK, gen, dev, B, H, W, G, sigma, alpha, peaks) for B, H, W in cases]
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
        scenarios_path=_path(engine, "scenarios EXIF bench run: the engine's 3 launches, B=10 at "
                                     "360x480, 327x436, 297x396 (the JAX tests' scenes: 2 or 4 "
                                     "levels at 240x320 or 312x472, per the scenario lines)"),
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
            scenarios_path=_path([main], "scenarios EXIF bench run: one launch, B=9 pairs, "
                                 "2499 x 2499 x 128, the engine's shape", path_keys),
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
                     cpu_points=res_cpu.points.numpy(),
                     kw=dict(kw, max_iters=b.max_lm_iters), cameras=cams, tracks=tracks,
                     observations=eng.map.num_observations)
    return dict(launches, **{"match_top2_fused(bf16=True)": launches_bf16}), engine_ba


def _engine_ba_kw(ba_cfg):
    """The LM keywords of the engines' final BA at ``ba_cfg``, but its
    iteration cap."""
    return dict(cg_iters=60, init_damping=ba_cfg.init_damping, damping_up=ba_cfg.damping_up,
                damping_down=ba_cfg.damping_down, ftol=ba_cfg.ftol, huber_delta=ba_cfg.huber_delta)


def _resolve_ba_on_cpu(eng, ba_cfg):
    """The card's last BA problem of ``eng`` solved again on the CPU: the
    costs after each of the first 6 iterations on both sides, and the CPU's
    full run."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem

    prob_cpu = BAProblem(*(None if v is None else v.cpu() for v in eng.ba_problem))
    kw = _engine_ba_kw(ba_cfg)
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


def _superpoint_train_flops(channels, desc_dim, hw, images):
    """Operations of one train step of a SuperPoint net: 2 per multiply-add
    of the forward convolutions, times 3 for the forward and the backward
    (data and weight gradients), over ``images`` images of ``hw``."""
    c1, c2, c3, c4, c5 = channels
    H, W = hw
    px = [H * W, H * W // 4, H * W // 16, H * W // 64]
    macs = (px[0] * 9 * (c1 + c1 * c1) + px[1] * 9 * (c1 * c2 + c2 * c2)
            + px[2] * 9 * (c2 * c3 + c3 * c3)
            + px[3] * (9 * (c3 * c4 + c4 * c4 + 2 * c4 * c5) + c5 * (65 + desc_dim)))
    return 3 * 2 * macs * images


def _train_losses(net, batches):
    """Each step's (loss, ld, ldesc) of ``make_train_step(net)`` over
    ``batches``, read on the host after the last step: (steps, 3) float64."""
    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.ops.sp_train import make_train_step

    _, step = make_train_step(net)
    out = torch.stack([torch.stack(step(b)) for b in batches])
    return out.cpu().numpy().astype(np.float64)


def _first_step_grads(net, batch):
    """The gradients of one ``make_train_step`` step of ``net`` on
    ``batch`` (left in ``.grad`` by the step), in flax layout as numpy."""
    from sfmfromscratch_tpu_torch.ops.sp_train import make_train_step
    from sfmfromscratch_tpu_torch.ops.superpoint import flax_params_from_state_dict

    _, step = make_train_step(net)
    step(batch)
    return flax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()})


def _loss_grads(net, batch, backward_in_scope=True):
    """The gradients of the train step's loss on ``batch`` with ``net`` in
    its own dtype (float64 for a reference), in flax layout as numpy. With
    ``backward_in_scope=False`` only the forward runs in ``f32_precision``
    and the backward runs with the process's defaults (cuDNN convolutions in
    TF32 unless ``torch.backends.cudnn.allow_tf32`` is off): the mistake
    ``sp_train.train_scope`` prevents."""
    import contextlib

    import torch

    from sfmfromscratch_tpu_torch.ops import sp_train as SPT
    from sfmfromscratch_tpu_torch.ops.superpoint import flax_params_from_state_dict
    from sfmfromscratch_tpu_torch.utils.precision import f32_precision

    p = next(net.parameters())
    imgs, labs, imgs_w, labs_w, Hs = (torch.as_tensor(a).to(p.device) for a in batch)
    with SPT.train_scope() if backward_in_scope else contextlib.nullcontext():
        with f32_precision():
            semi_a, desc_a = net(imgs[:, None].to(p.dtype))
            semi_b, desc_b = net(imgs_w[:, None].to(p.dtype))
            ld = SPT._detector_ce(semi_a, labs.long()) + SPT._detector_ce(semi_b, labs_w.long())
            loss = ld + torch.mean(SPT._descriptor_hinge(desc_a, desc_b, Hs))
        loss.backward()
    return flax_params_from_state_dict({n: q.grad for n, q in net.named_parameters()})


def _dither(batch, seed):
    """``batch`` with uniform noise of at most 1e-3 on both views: no pixel
    clipped to exactly 0 or 1 ties in the max pools any more."""
    import numpy as np

    r = np.random.default_rng(seed)
    imgs, labs, imgs_w, labs_w, Hs = batch
    return ((imgs + r.uniform(0, 1e-3, imgs.shape)).astype(np.float32), labs,
            (imgs_w + r.uniform(0, 1e-3, imgs_w.shape)).astype(np.float32), labs_w, Hs)


def train_phase(dev, peaks):
    """TinyPoint's trainer (``ops/sp_train.py``) on the card:

    1. card against CPU: ``TRAIN_CPU_STEPS`` steps of the same
       ``make_batch`` batches from JAX's ``key(0)`` initial weights
       (``TRAIN_INIT_NPZ``), the first ``TRAIN_CPU_RTOL_STEPS`` steps' losses
       within ``TRAIN_CPU_RTOL`` and all within ``TRAIN_CPU_RTOL_LATE``, and
       the card's first-step gradients (on the dithered first batch) within
       ``TRAIN_GRAD_TOL`` of the float64 net's on the CPU;
    2. repeatability: ``TRAIN_REPEAT_STEPS`` steps twice from one seed, the
       same bits; one step again under
       ``torch.use_deterministic_algorithms(True, warn_only=True)``;
    3. the recipe: ``train()`` at ``TRAIN_STEPS`` x ``TRAIN_BATCH`` at
       ``TRAIN_HW``, timed (host ``make_batch``, the step, the profiler over
       ``TRAIN_PROFILE_STEPS`` steps for device time and idle share); its
       checkpoint saved and loaded back; the losses and the corner hit rate
       held to ``tools/train_pins.py``'s pins;
    4. the hybrid engine on the new checkpoint on the bench sequence, held
       to the same tool's pins, launches counted;
    5. the full-width net for ``TRAIN_FULL_STEPS`` steps.

    Returns the launch counts per run."""
    import copy
    import tempfile
    import warnings

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sfmfromscratch_tpu_torch.ops import sp_train as SPT
    from sfmfromscratch_tpu_torch.ops.superpoint import (
        SuperPointExtractor, SuperPointNet, load_flax_weights, make_hybrid_extractor,
        save_flax_weights,
    )
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    H, W = TRAIN_HW
    t_phase = time.perf_counter()
    row, launches = {"phase": "train", "card": _nvidia_smi()}, {}

    # 1. Card against CPU from the carried initial weights.
    init = os.path.join(ROOT, TRAIN_INIT_NPZ)
    rng = np.random.default_rng(TRAIN_SEED)
    batches = [SPT.make_batch(rng, TRAIN_BATCH, H, W) for _ in range(TRAIN_CPU_STEPS)]
    card = _train_losses(load_flax_weights(init).to(dev), batches)
    t0 = time.perf_counter()
    cpu = _train_losses(load_flax_weights(init), batches)
    cpu_s = (time.perf_counter() - t0) / TRAIN_CPU_STEPS
    rel = np.abs(card - cpu) / np.abs(cpu)
    def err(got):
        """The largest error of any tensor against float64, over its max |g|."""
        return max(float(np.abs(got[k][leaf] - v).max() / np.abs(v).max())
                   for k, leaves in ref.items() for leaf, v in leaves.items())

    dithered = _dither(batches[0], 0)
    ref = _loss_grads(load_flax_weights(init).double(), dithered)
    grad_err = dict(
        card=err(_first_step_grads(load_flax_weights(init).to(dev), dithered)),
        cpu_float32=err(_first_step_grads(load_flax_weights(init), dithered)),
        card_backward_outside_scope=err(
            _loss_grads(load_flax_weights(init).to(dev), dithered, backward_in_scope=False)),
        cudnn_allow_tf32_default=bool(torch.backends.cudnn.allow_tf32))
    row["card_vs_cpu"] = dict(steps=TRAIN_CPU_STEPS, card=card.tolist(), cpu=cpu.tolist(),
                              max_rel_per_step=rel.max(1).tolist(), cpu_s_per_step=cpu_s,
                              rtol=TRAIN_CPU_RTOL, rtol_steps=TRAIN_CPU_RTOL_STEPS,
                              rtol_late=TRAIN_CPU_RTOL_LATE, first_step_grad_err=grad_err,
                              grad_tol=TRAIN_GRAD_TOL)

    # 2. Repeatability on the card.
    rng = np.random.default_rng(TRAIN_SEED)
    batches = [SPT.make_batch(rng, TRAIN_BATCH, H, W) for _ in range(TRAIN_REPEAT_STEPS)]

    def fresh():
        net = SuperPointNet.tiny()
        net.reset_parameters_flax(torch.Generator().manual_seed(TRAIN_SEED))
        return net.to(dev)

    first, second = _train_losses(fresh(), batches), _train_losses(fresh(), batches)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            probe = _train_losses(fresh(), batches[:1])
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).splitlines()[0][:160] for w in caught
                      if "determinis" in str(w.message)})
    row["repeat"] = dict(steps=TRAIN_REPEAT_STEPS, bit_equal=first.tobytes() == second.tobytes(),
                         last=first[-1].tolist(), deterministic_mode_flagged=flagged,
                         deterministic_mode_same_bits=probe[0].tobytes() == first[0].tobytes())

    # 3. The recipe, timed: host make_batch, the whole loop, and a profiled
    # window of steps for the device time and idle share.
    batch_s, losses = [], []
    make_batch, make_train_step = SPT.make_batch, SPT.make_train_step

    def timed_batch(*a):
        t = time.perf_counter()
        out = make_batch(*a)
        batch_s.append(time.perf_counter() - t)
        return out

    def recording(net, *a, **k):
        opt, step = make_train_step(net, *a, **k)

        def rec(b):
            out = step(b)
            losses.append(torch.stack(out))
            return out
        return opt, rec

    SPT.make_batch, SPT.make_train_step = timed_batch, recording
    try:
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net = SPT.train(steps=TRAIN_STEPS, batch=TRAIN_BATCH, hw=TRAIN_HW, seed=TRAIN_SEED,
                        device=dev)
        torch.cuda.synchronize()
        recipe_s = time.perf_counter() - t0
        launches["recipe"] = _launch_counts()
    finally:
        SPT.make_batch, SPT.make_train_step = make_batch, make_train_step
    L = torch.stack(losses).cpu().numpy().astype(np.float64)
    last = L[-TRAIN_LAST:]

    side = copy.deepcopy(net)          # the window trains a copy on
    _, step = make_train_step(side)
    prof_rng = np.random.default_rng(TRAIN_SEED + 1)
    step(make_batch(prof_rng, TRAIN_BATCH, H, W))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            step(make_batch(prof_rng, TRAIN_BATCH, H, W))
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    fixed = make_batch(prof_rng, TRAIN_BATCH, H, W)
    step_ms = _cuda_ms(lambda: step(fixed), reps=TRAIN_PROFILE_STEPS)
    flops = _superpoint_train_flops(net.channels, net.desc_dim, TRAIN_HW, 2 * TRAIN_BATCH)
    row["recipe"] = dict(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, hw=list(TRAIN_HW), wall_s=recipe_s,
        ms_per_step=recipe_s * 1e3 / TRAIN_STEPS,
        make_batch_ms=float(np.mean(batch_s)) * 1e3,
        device_ms_per_step=busy_us * 1e-3 / TRAIN_PROFILE_STEPS,
        profiled_window_ms_per_step=window_s * 1e3 / TRAIN_PROFILE_STEPS,
        idle_share=1.0 - busy_us * 1e-6 / window_s,
        step_ms_batch_ready=step_ms, step_gflop=flops / 1e9,
        step_bound_ms=flops / peaks["fp32_flops"] * 1e3,
        first_loss=L[0].tolist(), last_loss=L[-1].tolist(),
        last_mean_ld=float(last[:, 1].mean()), last_mean_ldesc=float(last[:, 2].mean()),
        finite=bool(np.isfinite(L).all()), launches=launches["recipe"])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        ckpt = os.path.join(tmp, "tinypoint.npz")
        save_flax_weights(ckpt, net)
        back = load_flax_weights(ckpt)
        same = (back.channels, back.desc_dim) == (net.channels, net.desc_dim) and all(
            torch.equal(a.cpu(), b) for a, b in zip(net.state_dict().values(),
                                                    back.state_dict().values()))
        rates = {}
        for label, path in (("trained", ckpt), ("committed", "auto")):
            ext = SuperPointExtractor(path)

            def detect(img):
                kp = ext(torch.as_tensor(img, device=dev), k=HIT_K).keypoints
                m = kp.mask.cpu().numpy()
                return np.stack([kp.xf.cpu().numpy()[m], kp.yf.cpu().numpy()[m]], 1)

            hits, corners = corner_hit_rate(detect, SPT._draw_shapes)
            rates[label] = dict(hits=hits, corners=corners, rate=hits / max(corners, 1))
        row["checkpoint"] = dict(round_trip=bool(same), hit_rate=rates)

        # 4. The checkpoint in use: the hybrid engine on the bench sequence.
        seq = os.path.join(tmp, "bench")
        os.makedirs(seq)
        n = EXTRACTOR_VIEWS
        K, gt = bench_sequence(seq, n)
        _zero_launch_counts()
        t0 = time.perf_counter()
        eng = SfmEngine(seq, n, config=engine_config(), single_K=K, device=dev,
                        feature_extractor=make_hybrid_extractor(k=HYBRID_K, weights_path=ckpt))
        torch.cuda.synchronize()
        launches["hybrid"] = _launch_counts()
        row["hybrid"] = _global_row(eng, gt, time.perf_counter() - t0, launches["hybrid"],
                                    first_image=2)

    # 5. The full-width net.
    losses.clear()
    SPT.make_train_step = recording
    try:
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = SPT.train(steps=TRAIN_FULL_STEPS, batch=TRAIN_BATCH, hw=TRAIN_HW, seed=TRAIN_SEED,
                         log_every=0, net=SuperPointNet(), device=dev)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        launches["full_width"] = _launch_counts()
    finally:
        SPT.make_train_step = make_train_step
    F = torch.stack(losses).cpu().numpy().astype(np.float64)
    flops_full = _superpoint_train_flops(full.channels, full.desc_dim, TRAIN_HW, 2 * TRAIN_BATCH)
    row["full_width"] = dict(steps=TRAIN_FULL_STEPS, desc_dim=full.desc_dim,
                             ms_per_step=full_s * 1e3 / TRAIN_FULL_STEPS,
                             step_gflop=flops_full / 1e9,
                             step_bound_ms=flops_full / peaks["fp32_flops"] * 1e3,
                             losses=F[:, 0].tolist(), finite=bool(np.isfinite(F).all()),
                             first5=float(F[:5, 0].mean()), last5=float(F[-5:, 0].mean()))
    want = {k: dict(v, **{"match_top2_fused(bf16=True)": 0}) for k, v in TRAIN_LAUNCHES.items()}
    row.update(launches=launches, want_launches=want, wall_s=time.perf_counter() - t_phase,
               pins=dict(ld=PIN_TRAIN_LD, ldesc=PIN_TRAIN_LDESC, hit_rate=PIN_TRAIN_HIT_RATE,
                         hybrid=PIN_TRAIN_HYBRID))
    _print(row)

    cc = row["card_vs_cpu"]
    _check(bool(np.isfinite(card).all() and np.isfinite(cpu).all()), "train: non-finite losses")
    _check(max(cc["max_rel_per_step"][:TRAIN_CPU_RTOL_STEPS]) <= TRAIN_CPU_RTOL
           and max(cc["max_rel_per_step"]) <= TRAIN_CPU_RTOL_LATE,
           f"train: card vs CPU losses {cc['max_rel_per_step']}")
    _check(grad_err["card"] <= TRAIN_GRAD_TOL,
           f"train: the card's first-step gradients against float64 {grad_err} > {TRAIN_GRAD_TOL}")
    _check(row["repeat"]["bit_equal"], "train: two card runs gave other losses")
    rc = row["recipe"]
    _check(rc["finite"], "train: non-finite recipe losses")
    _check(rc["last_mean_ld"] <= PIN_TRAIN_LD, f"train: ld {rc['last_mean_ld']} > {PIN_TRAIN_LD}")
    _check(rc["last_mean_ldesc"] <= PIN_TRAIN_LDESC,
           f"train: ldesc {rc['last_mean_ldesc']} > {PIN_TRAIN_LDESC}")
    _check(row["checkpoint"]["round_trip"], "train: the saved checkpoint loads other weights")
    hit = rates["trained"]["rate"]
    _check(hit >= PIN_TRAIN_HIT_RATE, f"train: hit rate {hit} < {PIN_TRAIN_HIT_RATE}")
    hy = row["hybrid"]
    _check(hy["cameras"] == EXTRACTOR_VIEWS - 1, f"train hybrid: {hy['cameras']} cameras")
    _check_pins("train hybrid", hy, PIN_TRAIN_HYBRID)
    fw = row["full_width"]
    _check(fw["finite"] and fw["last5"] <= fw["first5"],
           f"train full width: losses {fw['first5']} -> {fw['last5']}")
    for label, w in want.items():
        _check(launches[label] == w, f"train {label} launches {launches[label]} != {w}")
    return launches


# ------------------------------------------------------------------ scenarios


def port_scenario_api(dev):
    """The port's names that the scenarios call, on ``dev``
    (``tools/scenario_pins.py`` builds the JAX package's with the same keys)."""
    import functools
    import types

    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch import config
    from sfmfromscratch_tpu_torch.geometry.camera import SensorType, intrinsics_from_exif
    from sfmfromscratch_tpu_torch.geometry.epipolar import (
        eight_point_fundamental,
        epipolar_distances,
    )
    from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner, matches_to_coords
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    return types.SimpleNamespace(
        config=config, SensorType=SensorType, intrinsics_from_exif=intrinsics_from_exif,
        SfmEngine=functools.partial(SfmEngine, device=dev),
        GlobalSfmEngine=functools.partial(GlobalSfmEngine, device=dev),
        feature_runner=functools.partial(FeatureRunner.run, device=dev),
        matches_to_coords=matches_to_coords, eight_point_fundamental=eight_point_fundamental,
        epipolar_distances=epipolar_distances,
        asarray=lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev),
        host=lambda x: x.detach().cpu().numpy())


def small_config(api, seed=None):
    """``tests/test_pipeline.py:27-38`` ``_small_config`` in ``api``'s config
    classes; ``seed`` replaces its ``config.seed`` (None keeps it)."""
    c = api.config
    cfg = c.PipelineConfig(
        extractor=c.ExtractorConfig(
            num_interest_points=400, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
            feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2),
        matcher=c.MatcherConfig(ratio_threshold=0.85, max_matches=400),
        ransac=c.RansacConfig(max_iterations=384),
        ba=c.BundleAdjustConfig(max_lm_iters=15, ftol=1e-6),
        scale_factor=1.0, dist_threshold=5.0)
    return _reseed(cfg, seed)


def _reseed(cfg, seed):
    import dataclasses

    return cfg if seed is None else dataclasses.replace(cfg, seed=seed)


def _wide_extractor(api):
    """The extractor of ``tests/test_wide_baseline.py:29-33, 60-64``."""
    return api.config.ExtractorConfig(
        num_interest_points=600, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
        feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2)


def _ate_pct(eng, poses):
    """``tests/test_adversarial.py:19-30``: ATE in percent of the
    trajectory's extent, the cameras from image 1 when every image has one,
    else from image 2."""
    first = 1 if len(eng.global_poses) == len(poses) else 2
    ate, extent = trajectory_error(eng.global_poses, poses, first_image=first)
    return 100.0 * ate / extent


def _k_gap(Ks, K_ref):
    """The largest gap of any K in ``Ks`` from ``K_ref``, relative to each
    entry of ``K_ref`` (``np.testing.assert_allclose(K, K_ref, rtol)`` holds
    when it is <= rtol; a zero entry must be matched exactly); 0 for none."""
    import numpy as np

    K_ref = np.asarray(K_ref, np.float64)
    gaps = [0.0]
    for K in Ks:
        d = np.abs(np.asarray(K, np.float64) - K_ref)
        gaps.append(float(np.max(np.where(K_ref != 0, d / np.where(K_ref != 0, np.abs(K_ref), 1),
                                          np.where(d > 0, np.inf, 0.0)))))
    return max(gaps)


def _robustness_orbit(work):
    """``tests/test_robustness.py:19-27``: the 6-view orbit, written; (dir, K)."""
    import numpy as np

    mod = _render_module()
    images, K, _, _ = mod.render_sequence(np.random.default_rng(5), num_views=6, num_points=150,
                                          orbit_step_deg=4.0, img_hw=(240, 320))
    d = os.path.join(work, "orbit")
    os.makedirs(d)
    mod.write_sequence(d, images)
    return d, K


def scenario_run(name, api, work, seed=None):
    """Run scenario ``name`` as its JAX test does (scene, calls, files),
    through ``api``'s package, in the empty directory ``work``; ``seed``
    replaces ``config.seed`` (None keeps the test's). Returns the row of
    numbers that ``SCENARIO_GATES[name]`` reads."""
    import shutil

    import numpy as np
    from PIL import Image

    mod = _render_module()
    row = {}
    t0 = time.perf_counter()
    if name in ("featureless", "duplicate"):
        # tests/test_robustness.py:30-67
        orbit, K = _robustness_orbit(work)
        d = os.path.join(work, "seq")
        shutil.copytree(orbit, d)
        if name == "featureless":
            Image.fromarray(np.full((240, 320), 128, np.uint8)).save(os.path.join(d, "4.jpg"))
            n, window = 6, 3
        else:
            shutil.copy(os.path.join(d, "2.jpg"), os.path.join(d, "3.jpg"))
            n, window = 5, 2
        eng = api.SfmEngine(d, n, config=small_config(api, seed), single_K=K,
                            on_pose_failure="recover")
        geng = api.GlobalSfmEngine(d, n, config=small_config(api, seed), single_K=K,
                                   pair_window=window)
        row.update(incremental_cameras=len(eng.global_poses),
                   incremental_reproj_px=float(eng.errors_before_after_ba[1]),
                   incremental_recovery_warning=any("pose recovery engaged" in w
                                                    for w in eng.warnings),
                   global_cameras=len(geng.global_poses),
                   global_reproj_px=float(geng.errors_before_after_ba[1]),
                   global_components_warning=any("components" in w for w in geng.warnings),
                   incremental_warnings=list(eng.warnings), global_warnings=list(geng.warnings))
    elif name == "two_images":
        # tests/test_robustness.py:70-85
        images, K, _, _ = mod.render_sequence(np.random.default_rng(5), num_views=2,
                                              num_points=150, orbit_step_deg=4.0,
                                              img_hw=(240, 320))
        d = os.path.join(work, "two")
        os.makedirs(d)
        mod.write_sequence(d, images)
        eng = api.SfmEngine(d, 2, config=small_config(api, seed), single_K=K)
        geng = api.GlobalSfmEngine(d, 2, config=small_config(api, seed), single_K=K,
                                   pair_window=2)
        row.update(incremental_cameras=len(eng.global_poses),
                   incremental_reproj_px=float(eng.errors_before_after_ba[1]),
                   global_cameras=len(geng.global_poses),
                   global_reproj_px=float(geng.errors_before_after_ba[1]))
    elif name == "degraded_incremental":
        # tests/test_adversarial.py:47-73, the rng fixture (tests/conftest.py:89-92)
        rng = np.random.default_rng(5)
        images, K, poses, _ = mod.render_planes(rng, num_views=6, orbit_step_deg=3.0)
        runs = {}
        for label, ims in (("clean", images), ("degraded", mod.degrade_sequence(rng, images))):
            d = os.path.join(work, label)
            os.makedirs(d)
            mod.write_sequence(d, ims)
            runs[label] = api.SfmEngine(d, 6, config=small_config(api, seed), single_K=K)
        for label, eng in runs.items():
            row.update({f"{label}_reproj_px": float(eng.errors_before_after_ba[1]),
                        f"{label}_ate_pct": _ate_pct(eng, poses),
                        f"{label}_tracks": int(eng.map.num_tracks),
                        f"{label}_cameras": len(eng.global_poses)})
        row["degraded_tracks_over_clean"] = row["degraded_tracks"] / max(row["clean_tracks"], 1)
    elif name == "degraded_global":
        # tests/test_adversarial.py:76-97
        rng = np.random.default_rng(5)
        images, K, poses, _ = mod.render_planes(rng, num_views=8, orbit_step_deg=8.0)
        d = os.path.join(work, "seq")
        os.makedirs(d)
        mod.write_sequence(d, mod.degrade_sequence(rng, images))
        eng = api.GlobalSfmEngine(d, 8, config=small_config(api, seed), single_K=K,
                                  pair_window=3)
        row.update(reproj_px=float(eng.errors_before_after_ba[1]), ate_pct=_ate_pct(eng, poses),
                   cameras=len(eng.global_poses), tracks=int(eng.map.num_tracks))
    elif name in ("pair_20deg", "global_10deg"):
        # tests/test_wide_baseline.py:12-16 (the scene)
        images, K, poses, _ = mod.render_planes(np.random.default_rng(0), num_views=12,
                                                orbit_step_deg=10.0)
        if name == "pair_20deg":
            # tests/test_wide_baseline.py:19-45 (no RANSAC: seed has no effect)
            fr = api.feature_runner(images[0], images[2], _wide_extractor(api), scale_factor=1.0)
            p1, p2, m = api.matches_to_coords(fr.matches, fr.features1, fr.features2, 600)
            F = api.eight_point_fundamental(api.asarray(api.host(p1)), api.asarray(api.host(p2)),
                                            mask=m)
            dist = api.host(api.epipolar_distances(F, p1, p2))
            row.update(matches=int(api.host(fr.matches.mask).sum()),
                       median_epipolar_px=float(np.median(dist[api.host(m).astype(bool)])))
        else:
            # tests/test_wide_baseline.py:48-83
            d = os.path.join(work, "seq")
            os.makedirs(d)
            mod.write_sequence(d, images)
            cfg = _reseed(api.config.PipelineConfig(extractor=_wide_extractor(api),
                                                    scale_factor=1.0), seed)
            eng = api.GlobalSfmEngine(d, 12, config=cfg, single_K=K, pair_window=3,
                                      pair_mode="both", retrieval_k=4,
                                      output_dir=os.path.join(work, "out"))
            row.update(tracks=int(eng.map.num_tracks),
                       reproj_px=float(eng.errors_before_after_ba[1]),
                       ate_pct=_ate_pct(eng, poses), cameras=len(eng.global_poses))
    elif name in ("exif", "exif_half", "exif_bench"):
        sensor = api.SensorType.CROP_FRAME
        if name == "exif_bench":
            # The bench sequence (bench_sequence's render) with the EXIF focal
            # that gives its K on a ONE_INCH sensor, at the bench configuration.
            sensor = api.SensorType[EXIF_BENCH_SENSOR]
            n, focal, scale = 10, EXIF_BENCH_FOCAL_MM, 1.0
            images, K_render, poses, _ = mod.render_sequence(
                np.random.default_rng(7), num_views=n, num_points=600, img_hw=(360, 480),
                f=520.0, step_t=(-0.12, 0.01, 0.02), step_r=(0.006, -0.015, 0.004))
            c = api.config
            cfg = _reseed(c.PipelineConfig(
                extractor=c.ExtractorConfig(**BENCH_EXTRACTOR),
                matcher=c.MatcherConfig(**BENCH_MATCHER), ransac=c.RansacConfig(),
                ba=c.BundleAdjustConfig(**BENCH_BA), scale_factor=1.0), seed)
            kw = {}
        else:
            # tests/test_exif.py:105-161
            half = name == "exif_half"
            n, focal, scale = (3, 26.0, 0.5) if half else (4, 26.0, 1.0)
            images, K_render, poses, _ = mod.render_sequence(
                np.random.default_rng(4 if half else 3), num_views=n,
                num_points=140 if half else 160, img_hw=(312, 472), f=520.0,
                step_t=(-0.25, 0.02, 0.03), step_r=(0.01, -0.03, 0.006))
            cfg = _reseed(api.config.PipelineConfig(scale_factor=scale), seed)
            kw = dict(on_pose_failure="recover") if half else {}
        d = os.path.join(work, "seq")
        os.makedirs(d)
        mod.write_sequence(d, images, exif_focal_mm=focal)
        file_Ks = [api.intrinsics_from_exif(os.path.join(d, f"{i}.jpg"), sensor)
                   for i in range(1, n + 1)]
        eng = api.SfmEngine(d, n, config=cfg, camera_sensor=sensor, **kw)
        K_scaled = np.diag([scale, scale, 1.0]) @ K_render
        row.update(file_K_rel_gap=_k_gap(file_Ks, K_render), cameras=len(eng.global_poses),
                   K_per_camera=len(eng.global_K) == len(eng.global_poses),
                   engine_K_rel_gap=_k_gap(eng.global_K, K_scaled),
                   reproj_px=float(eng.errors_before_after_ba[1]),
                   tracks=int(eng.map.num_tracks))
        if name == "exif_bench":
            ate, extent = trajectory_error(eng.global_poses, poses)
            row.update(ate_over_extent=ate / extent,
                       finite=bool(np.isfinite(eng.map.points()).all()),
                       stage_times_s=dict(eng.stage_times))
    else:
        raise ValueError(f"no scenario {name!r}")
    row["wall_s"] = time.perf_counter() - t0
    return row


_OPS = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b, "==": lambda a, b: a == b,
        ">=": lambda a, b: a >= b, ">": lambda a, b: a > b}


def scenario_failures(name, row):
    """The gates of ``SCENARIO_GATES[name]`` that ``row`` fails, as text."""
    return [f"{name}: {key} = {row[key]!r}, want {op} {limit!r}"
            for key, op, limit in SCENARIO_GATES[name] if not _OPS[op](row[key], limit)]


def scenarios_phase(dev):
    """Every scenario once, through the port on the card, launches counted
    per scenario; each held to its JAX test's gates (the bench EXIF run to
    the engine phase's pins and ``ENGINE_LAUNCHES``). Returns the launches.

    The degraded scenarios' 8% ATE gates sit in the tail of every seed
    spread, at seeds other than the tests' own (on the CPU over
    ``config.seed`` 0-59 the incremental one goes over at 3 seeds in JAX
    and 8 in the port, its clean run at 22 and 15; ``tools/scenario_pins.py``)."""
    import tempfile

    import torch

    api = port_scenario_api(dev)
    t_phase = time.perf_counter()
    launches, failed = {}, []
    for name in SCENARIOS:
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as work:
            _zero_launch_counts()
            row = scenario_run(name, api, work)
            torch.cuda.synchronize()
            launches[name] = _launch_counts()
        fails = scenario_failures(name, row)
        _print({"phase": "scenarios", "scenario": name, **row, "launches": launches[name],
                "gates": SCENARIO_GATES[name], "failed": fails})
        failed += fails
        n = launches[name]
        if name == "exif_bench":
            if {k: n[k] for k in ENGINE_LAUNCHES} != ENGINE_LAUNCHES:
                failed.append(f"{name}: launches {n} != {ENGINE_LAUNCHES}")
        elif n["harris_response_fused"] < 1 or n["match_top2_fused"] < 1:
            failed.append(f"{name}: a kernel of the path was not launched: {n}")
        if n["match_top2_fused(bf16=True)"]:
            failed.append(f"{name}: the bf16 matcher was launched")
    wall_s = time.perf_counter() - t_phase
    _print({"phase": "scenarios", "wall_s": wall_s, "budget_s": SCENARIO_BUDGET_S,
            "failed": failed})
    _check(not failed, "; ".join(failed))
    _check(wall_s <= SCENARIO_BUDGET_S, f"scenarios: {wall_s} s > {SCENARIO_BUDGET_S} s")
    return launches


# ------------------------------------------------------------------ ladder


def port_ladder_api(dev):
    """The port's names that the ladder's rungs call, on ``dev``
    (``tools/ladder_pins.py`` builds the JAX package's with the same keys).
    ``final_ba(eng)`` reads the backend, LM iterations and padded counts of
    the engine's last bundle adjustment; ``peak_reset``/``peak_bytes`` the
    card's allocator peak (None on the CPU)."""
    import functools
    import types

    import torch

    from sfmfromscratch_tpu_torch import config
    from sfmfromscratch_tpu_torch.ba.lm import resolve_dense
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    def final_ba(eng):
        p = eng.ba_problem
        dense = resolve_dense(None, p.num_cameras, p.num_points)
        return dict(backend="dense" if dense else "pcg",
                    iterations=int(eng.ba_result.iterations_used),
                    padded=[p.num_cameras, p.num_points, p.num_obs])

    cuda = dev.type == "cuda"
    return types.SimpleNamespace(
        config=config, final_ba=final_ba,
        SfmEngine=functools.partial(SfmEngine, device=dev),
        GlobalSfmEngine=functools.partial(GlobalSfmEngine, device=dev),
        sync=torch.cuda.synchronize if cuda else (lambda: None),
        peak_reset=torch.cuda.reset_peak_memory_stats if cuda else (lambda: None),
        peak_bytes=torch.cuda.max_memory_allocated if cuda else (lambda: None))


def ladder_config(api, kp, seed=None):
    """``benchmarks/ladder.py:53-69`` ``_cfg(kp)`` in ``api``'s config
    classes; ``seed`` replaces its ``config.seed`` (None keeps it)."""
    c = api.config
    cfg = c.PipelineConfig(
        extractor=c.ExtractorConfig(
            num_interest_points=kp, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
            feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2),
        matcher=c.MatcherConfig(ratio_threshold=0.85, max_matches=kp),
        ransac=c.RansacConfig(), ba=c.BundleAdjustConfig(), scale_factor=1.0)
    return _reseed(cfg, seed)


def ladder_scene(name, work):
    """Render rung ``name``'s scene from default_rng(7) and write it as
    ``1.jpg..N.jpg`` into ``work``; returns dict(dir, K, poses, render_s),
    the render and the writes timed apart from the engine's run."""
    import numpy as np

    mod = _render_module()
    renderer, kw = LADDER_RUNGS[name][4:]
    t0 = time.perf_counter()
    images, K, poses, _ = getattr(mod, renderer)(np.random.default_rng(7), **kw)
    mod.write_sequence(work, images)
    return dict(dir=work, K=K, poses=poses, render_s=time.perf_counter() - t0)


def ladder_scenes(names, work):
    """``ladder_scene`` of every rung of ``names``, each distinct scene once
    (``L4`` and ``L4r`` share one), all rendered at once in spawned
    processes under ``work``: the renderer is host numpy, about a minute for
    twenty 960x1280 views. Returns (scene per rung, wall seconds)."""
    import concurrent.futures
    import multiprocessing as mp

    t0 = time.perf_counter()
    keys = {name: repr(LADDER_RUNGS[name][4:]) for name in names}   # renderer and keywords
    jobs = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(set(keys.values())), mp_context=mp.get_context("spawn")) as pool:
        for name in names:
            if keys[name] not in jobs:
                d = os.path.join(work, name)
                os.makedirs(d)
                jobs[keys[name]] = pool.submit(ladder_scene, name, d)
        scenes = {name: jobs[keys[name]].result() for name in names}
    return scenes, time.perf_counter() - t0


def ladder_ba_again(eng):
    """The card's final BA problem of ``eng`` solved again on the card at
    the engine's settings, where the sorted segment sums must give the run's
    error bit for bit."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust

    b = eng.config.ba
    t0 = time.perf_counter()
    again = bundle_adjust(eng.ba_problem, max_iters=b.max_lm_iters, **_engine_ba_kw(b))
    return dict(run_px=float(eng.errors_before_after_ba[1]),
                card_again_px=float(again.final_mean_error), card_s=time.perf_counter() - t0,
                card_iterations=again.iterations_used)


def ladder_run(name, api, scene, seed=None, keep=None):
    """Run rung ``name`` through ``api``'s engine on ``scene``
    (``ladder_scene``) as ``benchmarks/ladder.py`` calls it; ``seed``
    replaces ``config.seed``; ``keep``, a dict, receives the engine.
    Returns the rung's row: cameras, ATE over extent (``trajectory_error``;
    the chain's cameras start at image 2), errors before and after BA,
    tracks and observations, the engine's wall and stage times, the final
    BA's backend and LM iterations."""
    import numpy as np

    engine, n, kp, kw = LADDER_RUNGS[name][:4]
    cfg = ladder_config(api, kp, seed)
    api.peak_reset()
    t0 = time.perf_counter()
    eng = getattr(api, engine)(scene["dir"], n, config=cfg, single_K=scene["K"], **kw)
    api.sync()
    wall = time.perf_counter() - t0
    if keep is not None:
        keep["engine"] = eng
    first = 1 if len(eng.global_poses) == n else 2
    ate, extent = trajectory_error(eng.global_poses, scene["poses"], first_image=first)
    e0, e1 = eng.errors_before_after_ba
    _, tracks, _ = eng.map.observations()
    kfs = getattr(eng, "keyframes", None)
    peak = api.peak_bytes()
    return dict(
        rung=name, engine=engine, views=n, keypoints=kp, seed=cfg.seed,
        cameras=len(eng.global_poses), want_cameras=n if engine == "GlobalSfmEngine" else n - 1,
        ate_over_extent=ate / extent, reproj_before_px=float(e0), reproj_after_px=float(e1),
        tracks=int(eng.map.num_tracks),
        tracks_3plus=int((np.bincount(tracks, minlength=eng.map.num_tracks) >= 3).sum()),
        observations=int(eng.map.num_observations), keyframes=None if kfs is None else len(kfs),
        kp_capacity=len(eng._kp_tracks[1]), max_points=cfg.max_points,
        wall_s=wall, render_s=scene["render_s"], final_ba=api.final_ba(eng),
        stage_times_s={k: float(v) for k, v in eng.stage_times.items()},
        peak_mib=None if peak is None else peak / 2 ** 20,
        warnings=list(eng.warnings)[:8], num_warnings=len(eng.warnings),
        finite=bool(np.isfinite(eng.map.points()).all()
                    and all(np.isfinite(np.hstack(p)).all() for p in eng.global_poses)))


def ladder_failures(name, row):
    """The pins of ``PIN_LADDER[name]`` (and every camera, finite values, a
    track table not full) that ``row`` fails, as text."""
    pins = PIN_LADDER[name]
    fails = []
    if row["cameras"] != row["want_cameras"]:
        fails.append(f"{name}: {row['cameras']} cameras, want {row['want_cameras']}")
    if not row["finite"]:
        fails.append(f"{name}: non-finite poses or points")
    if row["tracks"] >= row["max_points"]:
        fails.append(f"{name}: the track table is full ({row['max_points']}): new tracks "
                     "were dropped")
    if not row["ate_over_extent"] <= pins["ate_over_extent"]:
        fails.append(f"{name}: ATE over extent {row['ate_over_extent']} > "
                     f"{pins['ate_over_extent']}")
    if not row["reproj_after_px"] <= pins["reproj_px"]:
        fails.append(f"{name}: post-BA error {row['reproj_after_px']} px > {pins['reproj_px']}")
    if not row["tracks"] >= pins["min_tracks"]:
        fails.append(f"{name}: {row['tracks']} tracks < {pins['min_tracks']}")
    return fails


def _peak_mib(fn):
    """The card allocator's peak above what was allocated before, in MiB,
    over one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


@contextlib.contextmanager
def ladder_launch_shapes():
    """Yields a set that, while the context is open, records the arguments
    of every call of the port's Harris and matcher wrappers that the
    engines reach (``ops/harris.py`` imports ``harris_response_fused`` at
    each call, ``ops/matcher.py`` holds ``match_top2_fused``): ("harris",
    (B, H, W), gaussian size, sigma, alpha) and ("match", (B, n1, n2, D),
    masked, bf16). Each call goes on to the wrapper unchanged, which counts
    its launch as before; leaving the context puts the wrappers back."""
    from sfmfromscratch_tpu_torch.ops import matcher
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK

    shapes = set()
    harris, match = HK.harris_response_fused, matcher.match_top2_fused

    def recorded_harris(image, gaussian_size, sigma, alpha):
        shape = tuple(image.shape) if image.dim() == 3 else (1, *image.shape)
        shapes.add(("harris", shape, gaussian_size, float(sigma), float(alpha)))
        return harris(image, gaussian_size, sigma, alpha)

    def recorded_match(d1, d2, mask2=None, bf16=False):
        B = d1.shape[0] if d1.dim() == 3 else 1
        shapes.add(("match", (B, d1.shape[-2], d2.shape[-2], d1.shape[-1]),
                     mask2 is not None, bool(bf16)))
        return match(d1, d2, mask2, bf16)

    HK.harris_response_fused = recorded_harris
    matcher.match_top2_fused = recorded_match
    try:
        yield shapes
    finally:
        HK.harris_response_fused = harris
        matcher.match_top2_fused = match


def ladder_shape_checks(dev, shapes):
    """Both kernels against their plain versions on the card, on random
    inputs at each of ``shapes`` (``ladder_launch_shapes``): Harris to
    HARRIS_TOL, the matcher as ``_match_check`` holds it (a masked
    database drops 5% of its rows). Untimed; returns one row a shape."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for case in sorted(shapes):
        if case[0] == "harris":
            _, shape, G, sigma, alpha = case
            img = torch.rand(shape, generator=gen, device=dev)
            row = _harris_check(HK, img, G, sigma, alpha)
            row.update(kernel="harris_response_fused", G=G, sigma=sigma, alpha=alpha)
        else:
            _, (B, n1, n2, D), masked, bf16 = case
            d1 = _descriptors(gen, dev, B, n1, D)
            d2 = _descriptors(gen, dev, B, n2, D)
            mask2 = torch.rand((B, n2), generator=gen, device=dev) > 0.05 if masked else None
            kw = {"bf16": True} if bf16 else {}
            row, _, _ = _match_check(f"match ladder {B}x{n1}x{n2}x{D}", MK, d1, d2, mask2, kw)
            row.update(kernel="match_top2_fused(bf16=True)" if bf16 else "match_top2_fused",
                       shape=[B, n1, n2, D], masked=masked)
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def ladder_kernels(dev, peaks):
    """Both kernels against their plain versions at ``L3h``'s shapes: Harris
    at B=20 on its two pyramid levels (960x1280 and 800x1066, the tiled K2
    regime of the TPU kernel), the matcher at B=19 pairs of the engine's
    keypoint capacity; each timed as the kernel phase times it. Also the
    card's peak memory of the pyramid, the SIFT descriptors of one level and
    the matcher's plain version at those shapes."""
    import torch

    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
    from sfmfromscratch_tpu_torch.ops.image import build_pyramid, pyramid_shapes
    from sfmfromscratch_tpu_torch.ops.sift import sift_descriptors

    _, n, kp, _, _, scene = LADDER_RUNGS["L3h"]
    ex = ladder_config(port_ladder_api(dev), kp).extractor
    levels = pyramid_shapes(scene["img_hw"], ex.pyramid_level, ex.pyramid_scale_factor)
    per_level = kp // ex.pyramid_level
    cap = per_level * ex.pyramid_level
    gen = torch.Generator(device=dev).manual_seed(13)
    harris = [_harris_case(HK, gen, dev, n, H, W, ex.gaussian_size, ex.sigma, ex.alpha, peaks)
              for H, W in levels]
    d1 = _descriptors(gen, dev, n - 1, cap)
    d2 = _descriptors(gen, dev, n - 1, cap)
    mask2 = torch.rand((n - 1, cap), generator=gen, device=dev) > 0.05
    match = _match_row(f"match f32 ladder {n - 1}x{cap}x{cap}", MK, d1, d2, mask2, False, peaks)
    img = torch.rand((n, *levels[0]), generator=gen, device=dev)
    xs = torch.randint(16, levels[0][1] - 16, (n, per_level), generator=gen, device=dev,
                       dtype=torch.int32)
    ys = torch.randint(16, levels[0][0] - 16, (n, per_level), generator=gen, device=dev,
                       dtype=torch.int32)
    kmask = torch.ones((n, per_level), dtype=torch.bool, device=dev)
    _, n2sq = MK._norms(d1, d2, mask2)
    memory = dict(
        pyramid=_peak_mib(lambda: build_pyramid(img, ex.pyramid_level, ex.pyramid_scale_factor)),
        sift_level0=_peak_mib(lambda: sift_descriptors(img, xs, ys, kmask, ex.feature_width)),
        match_plain=_peak_mib(lambda: MK.match_top2_plain(d1, d2, n2sq)))
    shapes = {("harris", (n, H, W), ex.gaussian_size, float(ex.sigma), float(ex.alpha))
              for H, W in levels} | {("match", (n - 1, cap, cap, 128), True, False)}
    return dict(harris=harris, match=match, capacity=cap, levels=levels, peak_mib=memory,
                shapes=shapes)


def ladder_phase(dev, timed_shapes, rungs=LADDER_DEFAULT):
    """Every scene of ``rungs`` rendered at once (``ladder_scenes``), then
    each rung once through the port on the card, its launch counts zeroed
    just before the run and read just after, and the shapes it launched
    recorded (``ladder_launch_shapes``); each row held to its pins, its
    launches and every camera; after each rung both kernels held against
    their plain versions at every shape it launched that no earlier rung
    did (``ladder_shape_checks``), and ``L3h``'s shapes held to
    ``timed_shapes`` (those that ``ladder_kernels`` timed); ``L4``'s final
    BA solved again (``ladder_ba_again``); the default rungs' engine walls
    held to ``LADDER_BUDGET_S``. Returns the launches per rung."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    api = port_ladder_api(dev)
    launches, failed, walls, held = {}, [], {}, set()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ladder_") as work:
        scenes, render_s = ladder_scenes(rungs, work)
        _print({"phase": "ladder", "render_wall_s": render_s})
        for name in rungs:
            _zero_launch_counts()
            keep = {}
            with ladder_launch_shapes() as shapes:
                row = ladder_run(name, api, scenes[name], keep=keep)
                torch.cuda.synchronize()
            launches[name] = _launch_counts()
            walls[name] = row["wall_s"]
            row["kernel_shapes"] = sorted(shapes)
            row["kernel_checks"] = ladder_shape_checks(dev, shapes - held)
            held |= shapes
            if name in LADDER_BA_AGAIN:
                row["ba_again"] = ladder_ba_again(keep.pop("engine"))
            keep.clear()
            want = dict(LADDER_LAUNCHES[name], **{"match_top2_fused(bf16=True)": 0})
            fails = ladder_failures(name, row)
            if launches[name] != want:
                fails.append(f"{name}: launches {launches[name]} != {want}")
            again = row.get("ba_again")
            if again and again["card_again_px"] != again["run_px"]:
                fails.append(f"{name}: the final BA solved again on the card ends at "
                             f"{again['card_again_px']} px, the run at {again['run_px']}")
            if name == "L3h" and shapes != timed_shapes:
                fails.append(f"{name}: launched {sorted(shapes)}, the kernel phase timed "
                             f"{sorted(timed_shapes)}")
            _print({"phase": "ladder", **row, "launches": launches[name],
                    "pins": PIN_LADDER[name], "want_launches": want, "failed": fails})
            failed += fails
    default_s = sum(walls[n] for n in LADDER_DEFAULT if n in walls)
    _print({"phase": "ladder", "rungs": list(rungs), "wall_s": time.perf_counter() - t_phase,
            "default_rungs_wall_s": default_s, "budget_s": LADDER_BUDGET_S, "failed": failed})
    _check(not failed, "; ".join(failed))
    if set(LADDER_DEFAULT) <= set(walls):
        _check(default_s <= LADDER_BUDGET_S,
               f"ladder: the default rungs took {default_s} s > {LADDER_BUDGET_S} s")
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
    out["ba_prefix"] = []
    for k in range(1, BA_PREFIX + 1):
        res = bundle_adjust_sharded(problem, mesh, **dict(saved["kw"], max_iters=k))
        out["ba_prefix"].append(dict(cost=float(res.final_cost), points=res.points.cpu().numpy()))
    out["ba64"] = _ba_row(bundle_adjust_sharded(_float64_problem(problem), mesh, **saved["kw"]))

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


def _float64_problem(problem):
    """``problem`` with its float tensors in float64."""
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem

    return BAProblem(*(v.double() if v is not None and v.is_floating_point() else v
                       for v in problem))


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

    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.problem import BAProblem
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
    # after aligning the gauge on them. In float32 the sharded and unsharded
    # solves differ only in the order of their sums, and their LM paths part
    # once steps along the weak directions dominate, as the engine phase's
    # card and CPU solves of this problem do (an H100 run: the 2-rank solve
    # stopped at 21 iterations and 0.1191 px, the unsharded one at 27 and
    # 0.1175 px, 94% of these points within 5%). So the float32 solves are
    # held together after each of the first BA_PREFIX iterations and on
    # their final errors (BA_FINAL_RTOL, as card and CPU), and the final
    # state is held on the same problem in float64, where rounding no
    # longer parts the paths: the same iterations, the same error and these
    # points within 5%.
    ba_ref = engine_ba
    prob = engine_ba["problem"]
    views = np.bincount(prob.obs_pt[prob.obs_w > 0].numpy(), minlength=prob.num_points)
    multi = views >= 3
    ba_pts = _similarity_align(r0["ba"]["points"][multi], ba_ref["points"][multi])
    prob_dev = BAProblem(*(None if v is None else v.to(dev) for v in prob))
    ba_prefix = []
    for k, sharded in enumerate(r0["ba_prefix"], 1):
        ref_k = bundle_adjust(prob_dev, **dict(ba_ref["kw"], max_iters=k))
        ref_pts = ref_k.points.cpu().numpy()[multi]
        aligned = _similarity_align(sharded["points"][multi], ref_pts)
        ba_prefix.append(dict(
            k=k, cost_rel=abs(sharded["cost"] - float(ref_k.final_cost)) / float(ref_k.final_cost),
            points_3plus_close=bool(np.allclose(aligned, ref_pts, rtol=0.05, atol=0.02)),
            points_3plus_max_gap_aligned=float(np.abs(aligned - ref_pts).max())))
    ref64 = bundle_adjust(_float64_problem(prob_dev), **ba_ref["kw"])
    ref64_pts = ref64.points.cpu().numpy()[multi]
    b64 = r0["ba64"]
    ba64_pts = _similarity_align(b64["points"][multi], ref64_pts)
    ba64 = dict(iterations=b64["iterations"], unsharded_iterations=int(ref64.iterations_used),
                reproj_after_px=b64["e1"], unsharded_reproj_after_px=float(ref64.final_mean_error),
                points_3plus_max_gap_aligned=float(np.abs(ba64_pts - ref64_pts).max()),
                points_3plus_within_tol=float(np.isclose(ba64_pts, ref64_pts, rtol=0.05,
                                                         atol=0.02).all(1).mean()))
    cpu_pts = _similarity_align(ba_ref["cpu_points"][multi], ba_ref["points"][multi])
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
        ba_prefix=ba_prefix,
        ba_points_3plus_within_tol=float(np.isclose(ba_pts, ba_ref["points"][multi], rtol=0.05,
                                                    atol=0.02).all(1).mean()),
        ba_points_3plus_within_tol_cpu_unsharded=float(np.isclose(
            cpu_pts, ba_ref["points"][multi], rtol=0.05, atol=0.02).all(1).mean()),
        ba_float64=ba64,
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
    _check(abs(b["e1"] - ba_ref["e1"]) <= BA_FINAL_RTOL * ba_ref["e1"],
           f"mesh BA: final error {b['e1']} px vs unsharded {ba_ref['e1']}")
    _check(ba64["iterations"] == ba64["unsharded_iterations"],
           f"mesh BA float64: {ba64['iterations']} iterations, unsharded "
           f"{ba64['unsharded_iterations']}")
    _check(abs(ba64["reproj_after_px"] - ba64["unsharded_reproj_after_px"])
           <= 1e-5 * ba64["unsharded_reproj_after_px"],
           f"mesh BA float64: {ba64['reproj_after_px']} px vs unsharded "
           f"{ba64['unsharded_reproj_after_px']}")
    _check(bool(np.allclose(ba64_pts, ref64_pts, rtol=0.05, atol=0.02)),
           "mesh BA float64: points of 3+ views off the unsharded solve's")
    for p in ba_prefix:
        _check(p["cost_rel"] <= BA_PREFIX_RTOL,
               f"mesh BA: cost after {p['k']} iterations {p['cost_rel']} from the unsharded solve's")
        _check(p["points_3plus_close"],
               f"mesh BA: points of 3+ views after {p['k']} iterations off the unsharded solve's")
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
    ladder_global = "--ladder-global" in argv
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
        # The ladder's kernel shapes here, with the other kernel cases: late
        # in a long process torch.profiler has dropped kernel activities.
        ladder_k = ladder_kernels(dev, peaks)
        ladder_shapes = ladder_k.pop("shapes")
        _print({"phase": "ladder_kernels", **ladder_k, "shapes": sorted(ladder_shapes)})
        kernels[0]["ladder_path"] = dict(
            per=f"L3h run: 2 launches, B=20 at {ladder_k['levels'][0]} and {ladder_k['levels'][1]}",
            cases=ladder_k["harris"], **{k: _sum(ladder_k["harris"], k) for k in
                                         ("device_ms", "call_ms", "bound_ms", "plain_ms")})
        kernels[1]["ladder_path"] = dict(
            per=f"L3h run: one launch, B=19 pairs, {ladder_k['capacity']} x "
                f"{ladder_k['capacity']} x 128 (the engine's keypoint capacity)",
            **{k: ladder_k["match"][k] for k in ("device_ms", "call_ms", "bound_ms", "plain_ms",
                                                 "library_ms", "max_abs_err")})
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
        train = train_phase(dev, peaks)
        scenarios = scenarios_phase(dev)
        ladder = ladder_phase(dev, ladder_shapes,
                              LADDER_DEFAULT + (LADDER_GLOBAL if ladder_global else ()))
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
            k["launches_train"] = {run: n.get(k["name"], 0) for run, n in train.items()}
            k["launches_scenarios"] = {run: n.get(k["name"], 0) for run, n in scenarios.items()}
            k["launches_ladder"] = {run: n.get(k["name"], 0) for run, n in ladder.items()}
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
