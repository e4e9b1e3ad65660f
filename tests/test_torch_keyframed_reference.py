"""The keyframed video path of the port's ``GlobalSfmEngine`` against the
benchmark's plain reference (``portbench/reference/keyframed.py``) on the
CPU, through ``tools/keyframed_parity.py``'s ``recording``: the flow-selected
keyframes, the registration's links to the keyframes' tracks and its P3P
poses; the span counters the keyframe and registration stages record; the
benchmark's new configuration, cell and readers.

Scene: a 24-frame sprite orbit at 1 deg/view (``render_sequence`` seed 19,
400 points, 240x320, 11-pixel patches, f = 400), at ``tests/test_global_sfm.py``'s
small configuration (400 keypoints, 2 levels, 384 hypotheses), window 3 and
a flow target of 4 px: 7 keyframes 4 deg apart, 17 frames to register with
24-63 links each. (At the benchmark's 7.5 px the keyframes fall 8 deg apart,
past what 400 keypoints of this cloud link: a frame gets 2-16 links.)
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from portbench import jobs as J
from portbench.readings import Readings
from portbench.reference import keyframed as ref
from portbench.spec import Bench
from sfmfromscratch_tpu_torch.config import (
    BundleAdjustConfig,
    ExtractorConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)
from sfmfromscratch_tpu_torch.geometry.ransac import uniforms_to_indices
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
from tests.render import render_sequence, write_sequence
from tools import keyframed_parity

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 24
FLOW_PX = 4.0


def _config():
    return PipelineConfig(
        extractor=ExtractorConfig(num_interest_points=400, ksize=3, gaussian_size=7, sigma=3.0,
                                  alpha=0.05, feature_width=16, pyramid_level=2,
                                  pyramid_scale_factor=1.2),
        matcher=MatcherConfig(ratio_threshold=0.85, max_matches=400),
        ransac=RansacConfig(max_iterations=384),
        ba=BundleAdjustConfig(max_lm_iters=15, ftol=1e-6), scale_factor=1.0, seed=3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One keyframed run with its stages recorded: (engine, recorded job)."""
    images, K, _, _ = render_sequence(np.random.default_rng(19), num_views=N, num_points=400,
                                      img_hw=(240, 320), patch=11, orbit_step_deg=1.0)
    d = tmp_path_factory.mktemp("video24")
    write_sequence(str(d), images)
    with keyframed_parity.recording() as jobs:
        eng = GlobalSfmEngine(str(d), N, config=_config(), single_K=K, device="cpu",
                              pair_window=3, keyframe_step="auto", keyframe_flow_px=FLOW_PX)
    assert len(jobs) == 1
    return eng, jobs[0]


@pytest.fixture(scope="module")
def parity(run):
    return keyframed_parity.compare(run[1], FLOW_PX)


def test_select_keyframes_matches_the_reference(run, parity):
    """``_select_keyframes`` picks the reference's keyframes from the same
    consecutive-pair matches: the same list, the first and last image among
    them, some frames left to register."""
    eng, job = run
    assert parity["keyframes_equal"], job["keyframes"]
    assert eng.keyframes == job["keyframes"]
    assert eng.keyframes[0] == 1 and eng.keyframes[-1] == N
    assert 3 <= len(eng.keyframes) < N - 6


def test_links_match_the_reference(run, parity):
    """``_link_registration`` gives every frame the reference's
    correspondences: the same track ids, pixels and first occurrences in
    the same slots, so the same counts."""
    _, job = run
    assert parity["links_equal"]
    links = ref.link_frames(ref.keyframe_tracks(*job["obs"]), job["results"], job["frames"])
    m_all = job["links"][3]
    assert [int(m.sum()) for m in m_all] == [int(links[f].keep.sum()) for f in job["frames"]]
    assert parity["links"] == int(m_all.sum()) > 20 * len(job["frames"])


def test_registered_poses_match_the_reference(run, parity):
    """Every frame registers in both, and each pose fits the reference's
    inliers within ``tools/keyframed_parity.py``'s ``FIT_TOL_PX`` of the
    reference's P3P RANSAC from the same uniforms (the reason is written
    there). This scene's frames are well conditioned, so the poses also
    agree: within 0.05 deg and 0.2% of the inliers' median depth, two
    orders above the float32 polish's gap from float64 (~5e-4 deg)."""
    _, job = run
    assert parity["failed"] == 0 and parity["failed_equal"]
    assert parity["poses_within"] and parity["fit_gap_px"] <= keyframed_parity.FIT_TOL_PX
    assert parity["rot_deg"] <= 0.05 and parity["centre_rel"] <= 2e-3


def test_span_counters_of_keyframes_and_register(run):
    """``keyframes`` counts the consecutive pairs matched and the keyframes
    chosen; ``register`` the frames, the registration pairs (two a frame
    between keyframes), the links after dedup, the P3P samples and the
    failed frames; its children ``register.match``, ``register.link`` and
    ``register.pnp`` are closed inside it and stay out of ``stage_times``."""
    eng, job = run
    spans = eng.spans
    kf = [s for s in spans if s.name == "keyframes"]
    assert len(kf) == 1 and kf[0].counters == dict(frames=N - 1, keyframes=len(eng.keyframes))
    reg = [s for s in spans if s.name == "register"]
    assert len(reg) == 1
    F = N - len(eng.keyframes)
    assert reg[0].counters == dict(frames=F, pairs=2 * F, links=int(job["links"][3].sum()),
                                   pnp_hyps=F * min(512, eng._pnp_hyp), failed=0)
    assert job["counts"] == {k: reg[0].counters[k] for k in ("links", "pnp_hyps", "failed")}
    i = spans.index(reg[0])
    children = [s.name for s in spans if s.parent == i]
    assert children == ["register.match", "register.link", "register.pnp"]
    for s in spans:
        if s.parent == i:
            assert reg[0].start_ns <= s.start_ns <= s.end_ns <= reg[0].end_ns
    assert not {"register.match", "register.link", "register.pnp"} & set(eng.stage_times)
    assert {"keyframes", "register"} <= set(eng.stage_times)


def test_the_reference_draws_the_programs_samples():
    """``sample_indices`` reads the program's strided-bucket rule from its
    description: the same slots as ``uniforms_to_indices`` for masks with
    holes, an empty bucket and the padding past the last bucket."""
    rng = np.random.default_rng(4)
    for n, p in ((100, 0.6), (41, 0.3), (9, 0.9)):
        valid = rng.random(n) < p
        if n == 41:
            valid[1::3] = False     # one bucket empty
        u = rng.random((64, 3)).astype(np.float32)
        want = uniforms_to_indices(torch.as_tensor(u), n, torch.as_tensor(valid), 3).numpy()
        assert np.array_equal(ref.sample_indices(u, valid), want), n


def test_the_reference_p3p_and_polish_recover_a_pose():
    """Grunert's quartic through the companion matrix: a known pose is
    among the solutions of exact samples to 1e-6; RANSAC with 10% outliers
    and half-pixel noise polishes back to within 0.05 deg."""
    rng = np.random.default_rng(8)
    K = np.array([[535.4, 0.0, 320.0], [0.0, 535.4, 240.0], [0.0, 0.0, 1.0]])
    for _ in range(50):
        R, t = ref.rodrigues(rng.normal(size=3) * 0.4), rng.normal(size=3)
        Xc = np.c_[rng.uniform(-2, 2, (3, 2)), rng.uniform(4, 9, 3)]
        X = (Xc - t) @ R
        h = Xc @ K.T
        Rs, ts, ok = ref.p3p(X[None], h[None, :, :2] / h[None, :, 2:], K)
        gap = min(np.abs(Rs[0, j] - R).max() + np.abs(ts[0, j] - t).max()
                  for j in range(4) if ok[0, j])
        assert gap < 1e-6
    R, t = ref.rodrigues(np.array([0.1, -0.3, 0.05])), np.array([0.2, -0.1, 0.5])
    Xc = np.c_[rng.uniform(-3, 3, (300, 2)), rng.uniform(5, 9, 300)]
    X = (Xc - t) @ R
    h = Xc @ K.T
    x = h[:, :2] / h[:, 2:] + rng.normal(0, 0.5, (300, 2))
    x[:30] += rng.uniform(40, 80, (30, 2))
    pose = ref.pnp_ransac(X, x, np.ones(300, bool), K, rng.random((128, 3)), threshold=8.0)
    assert pose.registered and pose.inliers[30:].all() and not pose.inliers[:30].any()
    assert ref.pose_gap(pose.R, pose.t, R, t)[0] < 0.05


def test_the_reference_imports_nothing_of_either_package():
    """``portbench/reference/keyframed.py`` imports no JAX and nothing of
    the JAX package or of the port: only NumPy and the standard library."""
    path = os.path.join(ROOT, "portbench", "reference", "keyframed.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "numpy"}, names
    assert not names & {"jax", "jaxlib", "sfmfromscratch_tpu", "sfmfromscratch_tpu_torch", "torch"}


def _record(views, stage_times, failed=False):
    return J.JobRecord(index=0, scene=0, seed=1, views=views, start=0.0, end=1.0,
                       error="raised" if failed else None, cameras=views, want_cameras=views,
                       stage_times=stage_times)


def test_the_new_readers_on_made_up_records():
    """``keyframes_ms_per_view`` and ``register_ms_per_view``: their span's
    seconds over the completed jobs' views, in ms; a failed job counts
    neither; None where no job has the span (a tree without the stage)."""
    bench = Bench(ROOT)
    cfg = bench.config("video_keyframed")
    jobs = [_record(150, {"keyframes": 0.03, "register": 0.6}),
            _record(100, {"keyframes": 0.02, "register": 0.4}),
            _record(150, {"keyframes": 9.0, "register": 9.0}, failed=True)]
    r = Readings(jobs=jobs, config=cfg, card="NVIDIA H100 80GB HBM3")
    assert bench.reader("keyframes_ms_per_view")(r) == pytest.approx(1e3 * 0.05 / 250)
    assert bench.reader("register_ms_per_view")(r) == pytest.approx(1e3 * 1.0 / 250)
    none = Readings(jobs=[_record(20, {"features": 0.1})], config=cfg, card="x")
    assert bench.reader("keyframes_ms_per_view")(none) is None
    assert bench.reader("register_ms_per_view")(none) is None


def test_the_benchmark_finds_the_configuration_cell_and_readers():
    """``portbench.spec.Bench`` finds ``video_keyframed``, ``kf150_video`` and
    the two readers by name; the configuration's engine keywords are the
    keyframed path's, the cell takes one chip, reports ``frames_per_s``,
    ``peak_device_gib`` and ``setup_s`` and the two new per-layer metrics,
    which list it alone."""
    bench = Bench(ROOT)
    cfg = bench.config(bench.workload("kf150_video")["config"])
    assert cfg["name"] == "video_keyframed" and cfg["engine"] == "GlobalSfmEngine"
    assert cfg["engine_kwargs"] == {"pair_window": 3, "keyframe_step": "auto",
                                    "keyframe_flow_px": 7.5}
    assert cfg["image_hw"] == [480, 640] and cfg["f"] == 535.4
    assert cfg["extractor"] == bench.config("global_window")["extractor"]
    cell = bench.cell("kf150_video")
    assert cell["views"] == cfg["num_views"] == cell["render"]["num_views"] == 150
    assert cell["render"]["orbit_step_deg"] == 0.34 and cell["check_jobs"] == 4
    assert bench.workload("kf150_video")["chips"] == 1
    assert {m["name"] for m in bench.metrics_for("end_to_end", "kf150_video")} == {
        "frames_per_s", "peak_device_gib", "setup_s"}
    layer = {m["name"]: m for m in bench.metrics_for("per_layer", "kf150_video")}
    assert set(layer) == {"keyframes_ms_per_view", "register_ms_per_view"}
    for m in layer.values():
        assert m["workloads"] == ["kf150_video"] and m["source"] == "program_span"
        assert callable(bench.reader(m["name"]))
    assert J.want_cameras(cfg, 150) == 150
    pc = J.pipeline_config(cfg, 7)
    assert dataclasses.asdict(pc.extractor)["num_interest_points"] == 2500
