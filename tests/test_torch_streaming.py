"""The port's out-of-core streaming BA against the JAX package, on the CPU.

Maps come from ``tests/test_streaming.py::_synthetic_map`` (a forward-moving
camera line observing short-lived tracks, 0.3 px noise). The block store is
the JAX package's layout, so each package reads the other's. Each tolerance
is stated where it is used.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.pipeline import streaming as jstream

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
from sfmfromscratch_tpu_torch.ba.problem import make_problem, pad_problem
from sfmfromscratch_tpu_torch.pipeline import streaming as tstream
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from tests.render import render_sequence, write_sequence
from tests.test_pipeline import _small_config
from tests.test_streaming import _synthetic_map

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _build(module, tmp_path, m, block_cams, name="store"):
    return module.MapBlockStore.build_from_arrays(
        str(tmp_path / name), m["cam_params"], m["K"], m["points"],
        m["obs_cam"], m["obs_pt"], m["obs_xy"], block_cams=block_cams,
    )


def test_store_roundtrip(rng, tmp_path):
    """``tests/test_streaming.py::test_store_roundtrip`` on the port's store:
    6 blocks, cameras, intrinsics and points read back exactly, every
    observation counted; and the files are the JAX store's, byte for byte
    in content (same index, same arrays)."""
    m, _ = _synthetic_map(rng, C=48, track_len=10)
    store = _build(tstream, tmp_path, m, block_cams=8)
    assert store.num_blocks == 6
    cams, Ks = store.read_cameras()
    np.testing.assert_allclose(cams, m["cam_params"])
    np.testing.assert_allclose(Ks, m["K"])
    ids, xyz = store.read_points()
    np.testing.assert_array_equal(ids, np.arange(m["points"].shape[0]))
    np.testing.assert_allclose(xyz, m["points"])
    assert store.total_obs == m["obs_cam"].shape[0]
    assert store.max_span_blocks >= 1
    ref = _build(jstream, tmp_path, m, block_cams=8, name="jax_store")
    with open(os.path.join(ref.root, "meta.json")) as f, \
            open(os.path.join(store.root, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    for name in sorted(os.listdir(ref.root)):
        if name.endswith(".npz"):
            with np.load(os.path.join(ref.root, name)) as a, \
                    np.load(os.path.join(store.root, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_stream_matches_monolithic_ba(rng, tmp_path):
    """``test_stream_matches_monolithic_ba`` on the port: the streamed solve
    (window 3 of 16-camera blocks, 2 sweeps) lowers the error and reaches
    the monolithic BA's quality (within 1.3x or 0.05 px), clamping no
    track."""
    m, _ = _synthetic_map(rng, C=96, track_len=20, perturb=0.008)
    store = _build(tstream, tmp_path, m, block_cams=16)
    cam_fixed = np.zeros(96, bool)
    cam_fixed[0] = True
    full = pad_problem(make_problem(m["cam_params"], m["points"], m["obs_cam"], m["obs_pt"],
                                    m["obs_xy"], m["K"], cam_fixed=cam_fixed, device="cpu"))
    full_err = float(bundle_adjust(full, max_iters=20, cg_iters=50, ftol=1e-6).final_mean_error)
    stats = tstream.stream_bundle_adjust(store, window_blocks=3, sweeps=2, max_iters=20,
                                         cg_iters=50, ftol=1e-6, device="cpu")
    assert stats.final_error < stats.initial_error
    assert stats.final_error < max(1.3 * full_err, full_err + 0.05)
    assert stats.clamped_tracks == 0
    assert stats.peak_resident_obs < stats.total_obs


def test_stream_block_count_invariance(rng, tmp_path):
    """``test_stream_block_count_invariance`` on the port (120 cameras in
    blocks of 15, 30 and 60 at windows 3, 2 and 2, 4 sweeps): every blocking
    reaches the same noise floor, within 1.2x of each other and under
    0.45 px."""
    m, _ = _synthetic_map(rng, C=120, track_len=20, perturb=0.008)
    errs = []
    for name, bc, w in (("a", 15, 3), ("b", 30, 2), ("c", 60, 2)):
        store = _build(tstream, tmp_path, m, block_cams=bc, name=name)
        st = tstream.stream_bundle_adjust(store, window_blocks=w, sweeps=4, max_iters=20,
                                          cg_iters=50, ftol=1e-6, device="cpu")
        errs.append(st.final_error)
    assert max(errs) < 1.2 * min(errs) + 1e-3
    assert max(errs) < 0.45


def test_jax_store_solved_by_the_port(rng, tmp_path):
    """A store written by the JAX package, solved by the port: the window
    errors land within 1e-3 relative of JAX's solve of a copy of the same
    store (windows of 24 cameras, below the dense-Schur gate, so both solve
    each window exactly), and the refined cameras and points it writes back
    read in the JAX package."""
    m, _ = _synthetic_map(rng, C=48, track_len=10, perturb=0.008)
    ref_store = _build(jstream, tmp_path, m, block_cams=12, name="jax_store")
    shutil.copytree(ref_store.root, tmp_path / "copy")
    kw = dict(window_blocks=2, sweeps=2, max_iters=20, cg_iters=50, ftol=1e-6, regate_px=3.0)
    ref = jstream.stream_bundle_adjust(ref_store, **kw)
    got = tstream.stream_bundle_adjust(tstream.MapBlockStore(str(tmp_path / "copy")),
                                       device="cpu", **kw)
    assert got.windows_run == ref.windows_run and got.sweeps == ref.sweeps
    np.testing.assert_allclose(got.window_errors, ref.window_errors, rtol=1e-3)
    assert got.final_error == pytest.approx(ref.final_error, rel=1e-3)
    back = jstream.MapBlockStore(str(tmp_path / "copy"))
    cams, _ = back.read_cameras()
    ids, xyz = back.read_points()
    assert cams.shape == m["cam_params"].shape and np.isfinite(xyz).all()


def test_stream_regate_drops_gross_observations(rng, tmp_path):
    """``stream_regate`` drops every observation above the gate and those
    left on tracks of one observation, as the JAX package's does on the same
    store (identical counts and tables)."""
    m, _ = _synthetic_map(rng, C=32, track_len=10)
    m = dict(m, obs_xy=m["obs_xy"].copy())
    m["obs_xy"][::23] += 40.0
    a = _build(tstream, tmp_path, m, block_cams=8, name="a")
    b = _build(jstream, tmp_path, m, block_cams=8, name="b")
    assert tstream.stream_regate(a, 3.0) == jstream.stream_regate(b, 3.0) > 0
    assert a.total_obs == b.total_obs
    for blk in range(a.num_blocks):
        np.testing.assert_array_equal(a._load(blk)["obs_pt"], b._load(blk)["obs_pt"])


def test_stream_mesh_is_not_ported(rng, tmp_path):
    """The sharded window solve (``mesh``) is ported: anything but a
    ``DeviceMesh`` raises ``TypeError``, and on a 1-rank gloo mesh every
    window solve goes through ``bundle_adjust_sharded`` and gives the
    unsharded sweep's bits (the sharded solves across ranks are
    ``tests/test_torch_parallel.py``'s)."""
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel import make_mesh

    m, _ = _synthetic_map(rng, C=16, track_len=6)
    kw = dict(window_blocks=1, max_iters=4, cg_iters=20, device="cpu")
    store = _build(tstream, tmp_path, m, block_cams=8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstream.stream_bundle_adjust(store, mesh=object(), device="cpu")
    ref_store = _build(tstream, tmp_path, m, 8, "ref")
    ref = tstream.stream_bundle_adjust(ref_store, **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    try:
        got = tstream.stream_bundle_adjust(store, mesh=make_mesh(1), **kw)
    finally:
        dist.destroy_process_group()
    assert got.windows_run == ref.windows_run == 2
    assert got.final_error == ref.final_error < got.initial_error
    np.testing.assert_array_equal(store.read_cameras()[0], ref_store.read_cameras()[0])


def test_stream_bundle_adjust_needs_cuda_unless_cpu(rng, tmp_path, monkeypatch):
    """``stream_bundle_adjust`` solves on the card unless ``device="cpu"``
    and raises without one, before it touches the store."""
    m, _ = _synthetic_map(rng, C=16, track_len=6)
    store = _build(tstream, tmp_path, m, block_cams=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.stream_bundle_adjust(store)
    assert not store._resident and store.peak_resident_obs == 0


def test_engine_stream_ba_matches_default(rng, tmp_path):
    """``test_engine_stream_ba_matches_default`` on the port:
    ``GlobalSfmEngine(stream_ba_window=2, stream_ba_block_cams=3)`` lands
    under 2 px and within max(35%, 0.1 px) of the default BA's error, in 2
    windows or more, with the streaming stats kept and its time in
    ``ba(stream)``."""
    images, K, _, _ = render_sequence(rng, num_views=8, num_points=150)
    d = tmp_path / "seq"
    d.mkdir()
    write_sequence(str(d), images)
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    eng0 = TGlobal(str(d), 8, config=cfg, single_K=K, pair_window=3, device="cpu")
    eng1 = TGlobal(str(d), 8, config=cfg, single_K=K, pair_window=3, stream_ba_window=2,
                   stream_ba_block_cams=3, device="cpu")
    e0 = eng0.errors_before_after_ba[1]
    e1 = eng1.errors_before_after_ba[1]
    assert e1 < 2.0
    assert abs(e1 - e0) < max(0.35 * e0, 0.1)
    assert eng1.stream_stats.windows_run >= 2
    assert "ba(stream)" in eng1.stage_times and "ba" not in eng1.stage_times
