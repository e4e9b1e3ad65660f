"""Rules the PyTorch port keeps, checked on the CPU.

* The port imports neither ``jax`` nor the JAX package, and neither does
  ``chip_smoke.py``.
* Entry points run on the CUDA card unless the caller asks for the CPU, and
  raise when there is no card.
* A kernel wrapper runs the plain version only for CPU tensors; the kernel
  build raises when ``nvcc`` fails and rebuilds only when a source changes.
* ``chip_smoke.py`` fails without a card and without the repository beside it.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu_torch.ops.cuda import build
from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.utils.precision import f32_precision, mm_f32

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "sfmfromscratch_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "sfmfromscratch_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def test_port_imports_no_jax_in_a_fresh_process():
    """Import every module of the port, and ``chip_smoke.py``, in a fresh
    interpreter: neither ``jax`` nor ``sfmfromscratch_tpu`` gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sfmfromscratch_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "print('LOADED', len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
        "print('PARALLEL', sorted(n for n in sys.modules if n.startswith(p.__name__ + '.parallel')))\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    assert int(r.stdout.split("LOADED")[1].split()[0]) >= 30
    for m in ("mesh", "sharded_ba", "sharded_match"):
        assert f"sfmfromscratch_tpu_torch.parallel.{m}" in r.stdout, r.stdout


# The modules of the engine slice, at the JAX package's paths.
_SLICE_2 = ("ops/smallsvd.py", "types.py", "pipeline/tracks.py", "utils/metrics.py",
            "pipeline/frontend.py", "ops/matcher.py", "geometry/ransac.py", "geometry/p3p.py",
            "geometry/pnp.py", "ba/problem.py", "ba/schur.py", "ba/lm_core.py", "ba/lm.py",
            "pipeline/incremental.py", "interop.py")
# The modules of the motion-averaging slice (global engine, chain refresh).
_SLICE_4 = ("geometry/averaging.py", "geometry/two_view.py", "geometry/triangulation.py",
            "geometry/homography.py", "native/bindings.py", "pipeline/chain_refresh.py",
            "pipeline/global_sfm.py")
# The modules of the host-chain slice (checkpoints, export, image I/O,
# profiling, the CLI).
_SLICE_5 = ("pipeline/checkpoint.py", "io/export.py", "io/images.py", "utils/profiling.py",
            "cli.py")
# The modules of the scale-out slice (focal self-calibration, retrieval,
# streaming BA).
_SLICE_6 = ("ba/selfcal.py", "ops/retrieval.py", "pipeline/streaming.py")
# The modules of the front-end and fixed-count RANSAC slice (DoG, SuperPoint,
# the DLT PnP, the batched fixed-count relative poses, eigh null vectors).
_SLICE_7 = ("ops/dog.py", "ops/superpoint.py", "pipeline/frontend.py", "geometry/pnp.py",
            "geometry/ransac.py", "ops/smallsvd.py")
# The modules of the mesh slice (torch.distributed).
_SLICE_8 = ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_ba.py",
            "parallel/sharded_match.py")


# The modules of the class-API slice (compat, the viewer, the C++ host
# components, the packed fetch, the asynchronous checkpointer).
_SLICE_9 = ("compat.py", "viz/__init__.py", "viz/overlays.py", "viz/scatter3d.py",
            "native/__init__.py", "native/build.py", "native/bindings.py", "utils/fetch.py",
            "__init__.py")


@pytest.mark.parametrize("rel", _SLICE_2 + _SLICE_4 + _SLICE_5 + _SLICE_6 + _SLICE_7 + _SLICE_8
                         + _SLICE_9)
def test_engine_slice_modules_import_no_jax(rel):
    """Each module of the engine slices exists beside its JAX twin
    (``interop`` is the port's own), and importing it alone in a fresh
    interpreter loads neither ``jax`` nor the JAX package."""
    assert rel == "interop.py" or (ROOT / "sfmfromscratch_tpu" / rel).exists()
    assert (PORT / rel).exists()
    mod = "sfmfromscratch_tpu_torch." + rel[:-3].replace("/", ".").replace(".__init__", "")
    code = (f"import sys, {mod}\n"
            f"print('FORBIDDEN', sorted(n for n in sys.modules if n.split('.')[0] in {_FORBIDDEN!r}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout


def _docstrings(tree):
    """The docstring nodes of a module's AST."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def test_port_opens_no_path_of_the_jax_package():
    """No string of the port's code (docstrings aside, which cite the JAX
    files) names the JAX package's directory, so no source joins a path into
    it; the TinyPoint checkpoint is the port's own, byte-equal copy; and no
    option of the port raises ``NotImplementedError`` any more."""
    import re

    from sfmfromscratch_tpu_torch.ops.superpoint import default_weights_path

    pattern = re.compile(r"(^|[^\w])sfmfromscratch_tpu($|[^\w])")
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        tree = ast.parse(text, str(path))
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert not pattern.search(node.value), (path, node.value)
        assert "NotImplementedError" not in text, path
    weights = pathlib.Path(default_weights_path())
    assert weights.resolve().is_relative_to(PORT.resolve())
    assert weights.read_bytes() == (ROOT / "sfmfromscratch_tpu" / "weights"
                                    / "tinypoint_synth.npz").read_bytes()


def test_port_exports_the_jax_top_level_names():
    """``import sfmfromscratch_tpu_torch`` gives the JAX package's top-level
    names (``__init__.py:57-65``), without its XLA compile-cache set-up."""
    import sfmfromscratch_tpu as jpkg
    import sfmfromscratch_tpu_torch as tpkg

    names = ("SensorType", "intrinsics_from_exif", "projection_matrix", "project_points",
             "ExtractorConfig", "MatcherConfig", "RansacConfig", "PipelineConfig", "__version__")
    for name in names:
        assert hasattr(jpkg, name) and hasattr(tpkg, name), name
    assert tpkg.__version__ == jpkg.__version__
    assert [m.name for m in tpkg.SensorType] == [m.name for m in jpkg.SensorType]
    R, t, K = torch.eye(3), torch.tensor([0.0, 0.0, 1.0]), torch.eye(3) * 2
    P = tpkg.projection_matrix(R, t, K)
    np.testing.assert_array_equal(P.numpy(), np.asarray(jpkg.projection_matrix(
        np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 1.0], np.float32),
        np.eye(3, dtype=np.float32) * 2)))


def test_fetch_matches_jax():
    """``utils/fetch.py``: ``device_get_packed`` returns the JAX function's
    arrays (shapes, dtypes and values exactly) for float32, int32, bool and
    scalar leaves; ``sync_device`` returns on a CPU tensor."""
    from sfmfromscratch_tpu.utils.fetch import device_get_packed as jget
    from sfmfromscratch_tpu_torch.utils.fetch import device_get_packed, sync_device

    r = np.random.default_rng(2)
    arrays = [r.standard_normal((3, 4)).astype(np.float32), r.integers(-9, 9, 7).astype(np.int32),
              r.uniform(size=(2, 2)) > 0.5, np.float32(2.5)]
    got = device_get_packed(*(torch.as_tensor(a) for a in arrays))
    ref = jget(*arrays)
    for g, j in zip(got, ref, strict=True):
        assert g.dtype == j.dtype and g.shape == j.shape
        np.testing.assert_array_equal(g, j)
    sync_device(torch.zeros(3))


def test_port_sources_name_no_jax():
    """No import statement of the port or of ``chip_smoke.py`` names ``jax``
    or the JAX package, not even inside a function."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    assert {PORT / "parallel" / f for f in ("mesh.py", "sharded_ba.py", "sharded_match.py")} \
        <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from sfmfromscratch_tpu_torch.config import ExtractorConfig
    from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner
    from sfmfromscratch_tpu_torch.pipeline.two_view import reconstruct_two_view

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((48, 64, 3), np.float32)
    K = np.eye(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct_two_view(img, img, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct_two_view(img, img, K, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureRunner.run(img, img, ExtractorConfig())
    assert resolve_device("cpu") == torch.device("cpu")
    fr = FeatureRunner.run(img, img, ExtractorConfig(num_interest_points=20, pyramid_level=1),
                           scale_factor=1.0, device="cpu")
    assert fr.image1_bw.device.type == "cpu"


def test_engine_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    """``SfmEngine(device=None)`` asks for the card and raises without one,
    before it reads any image."""
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SfmEngine(str(tmp_path), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        SfmEngine(str(tmp_path), 3, device="cuda", auto_run=False)
    eng = SfmEngine(str(tmp_path), 3, device="cpu", auto_run=False)
    assert eng.device == torch.device("cpu")


@pytest.mark.parametrize("pipeline", ["incremental", "global"])
def test_cli_needs_cuda_unless_cpu(monkeypatch, tmp_path, pipeline):
    """``cli.py reconstruct`` runs on the card unless ``--device cpu`` is
    given, and raises without one before it reads any image."""
    from sfmfromscratch_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["reconstruct", str(tmp_path), "--max-img", "3", "--pipeline", pipeline])


def test_global_engine_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    """``GlobalSfmEngine(device=None)`` asks for the card and raises without
    one, before it reads any image; it runs the window path with Huber BA."""
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GlobalSfmEngine(str(tmp_path), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        GlobalSfmEngine(str(tmp_path), 3, device="cuda", auto_run=False)
    eng = GlobalSfmEngine(str(tmp_path), 5, device="cpu", auto_run=False)
    assert eng.device == torch.device("cpu")
    assert eng.config.ba.huber_delta == 3.0 and eng.pair_window == 3
    assert eng._candidate_pairs(None) == [(1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (2, 5),
                                          (3, 4), (3, 5), (4, 5)]


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A 1-rank gloo process group in this process and its (1, 1) mesh."""
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def _check_mesh_option(engine_cls, tmp_path, mesh, n):
    """``mesh=object()`` is refused with ``TypeError``; a ``DeviceMesh`` is
    taken and kept, and its ``data`` axis is the one the engine shards on."""
    from sfmfromscratch_tpu_torch.parallel.mesh import mesh_axis

    with pytest.raises(TypeError, match="DeviceMesh"):
        engine_cls(str(tmp_path), n, device="cpu", auto_run=False, mesh=object())
    eng = engine_cls(str(tmp_path), n, device="cpu", auto_run=False, mesh=mesh)
    assert eng.mesh is mesh
    assert mesh_axis(eng.mesh, "data").size == 1


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(feature_extractor=lambda im: None), dict(refine_focal=True),
])
def test_engine_options_off_the_default_path_raise(option, tmp_path, request):
    """Every option of the JAX engine is taken; none is ignored.
    ``refine_focal`` is ported: the engine takes it and starts from a focal
    scale of 1. So is ``feature_extractor``: the engine keeps the callable
    for its features stage. So is ``mesh``: anything but a ``DeviceMesh``
    is refused with ``TypeError``, and a 1-rank gloo mesh is kept."""
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    if "mesh" in option:
        _check_mesh_option(SfmEngine, tmp_path, request.getfixturevalue("one_rank_mesh"), 3)
        return
    if "refine_focal" in option:
        eng = SfmEngine(str(tmp_path), 3, device="cpu", auto_run=False, **option)
        assert eng.refine_focal is True and eng.focal_scale == 1.0
        return
    eng = SfmEngine(str(tmp_path), 3, device="cpu", auto_run=False, **option)
    assert eng.feature_extractor is option["feature_extractor"]


@pytest.mark.parametrize("option, scan, fused", [
    (dict(assoc_mode="distance"), False, False), (dict(chain_mode="host"), False, False),
    (dict(pair_window=2), False, False), (dict(local_ba_every=3), False, False),
    (dict(checkpoint_every=2), False, False), (dict(checkpoint_path="c.npz"), True, True),
    (dict(pair_cache_dir="cache"), True, False), (dict(on_pose_failure="recover"), False, False),
])
def test_engine_host_options_take_the_jax_path(option, scan, fused, tmp_path):
    """The options of the host chain are accepted and pick the JAX engine's
    path (``incremental.py:859-867, 1471-1485``): the host chain unless the
    option leaves the scan chain's conditions alone, and the fused front
    only with neither a pair cache nor window pairs."""
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    eng = SfmEngine(str(tmp_path), 4, device="cpu", auto_run=False, **option)
    for name, value in option.items():
        assert getattr(eng, name) == value
    assert eng._use_scan_chain() is scan
    assert eng._fused_front_eligible(None) is fused


def test_engine_chain_refresh_values(tmp_path):
    """``chain_refresh="averaging"`` is ported; any other value is refused
    as the JAX engine refuses it."""
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    eng = SfmEngine(str(tmp_path), 3, device="cpu", auto_run=False, chain_refresh="averaging")
    assert eng.chain_refresh == "averaging"
    with pytest.raises(ValueError):
        SfmEngine(str(tmp_path), 3, device="cpu", auto_run=False, chain_refresh="bundle")


@pytest.mark.parametrize("option", [
    dict(pair_mode="retrieval"), dict(pair_mode="both"), dict(keyframe_step=2),
    dict(keyframe_step="auto"), dict(stream_ba_window=4), dict(mesh=object()),
    dict(refine_focal=True),
    dict(feature_extractor=lambda im: None), dict(adaptive=False),
])
def test_global_engine_options_off_the_window_path_raise(option, tmp_path, request):
    """Every option of the JAX global engine is taken; none is ignored. The
    pair modes, keyframing, streaming BA, focal self-calibration, the
    extractor slot, fixed-count RANSAC and the mesh are ported: the engine
    takes each and picks the JAX engine's path for it (a mesh must be a
    ``DeviceMesh``; ``object()`` raises ``TypeError``)."""
    import dataclasses

    from sfmfromscratch_tpu_torch.config import PipelineConfig, RansacConfig
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

    taken = {"pair_mode", "keyframe_step", "stream_ba_window", "refine_focal"}
    if taken & set(option):
        eng = GlobalSfmEngine(str(tmp_path), 5, device="cpu", auto_run=False, **option)
        for name, value in option.items():
            assert getattr(eng, name) == value
        step = option.get("keyframe_step", 1)
        assert eng.keyframed is (step != 1)
        if step == 2:
            assert eng.keyframes == [1, 3, 5] and eng._candidate_pairs(None) == [
                (1, 3), (1, 5), (3, 5)]
        if step == "auto":   # every image until the flow selection runs
            assert eng.keyframes == [1, 2, 3, 4, 5] and eng._auto_kfs is None
        if "stream_ba_window" in option:
            assert eng.stream_ba_block_cams == 32 and eng.stream_stats is None
        return
    if "feature_extractor" in option:
        eng = GlobalSfmEngine(str(tmp_path), 5, device="cpu", auto_run=False, **option)
        assert eng.feature_extractor is option["feature_extractor"]
        return
    if "adaptive" in option:
        cfg = dataclasses.replace(PipelineConfig(), ransac=RansacConfig(adaptive=False))
        eng = GlobalSfmEngine(str(tmp_path), 5, config=cfg, device="cpu", auto_run=False)
        assert eng.config.ransac.adaptive is False and eng._num_hyp == 5967
        return
    _check_mesh_option(GlobalSfmEngine, tmp_path, request.getfixturevalue("one_rank_mesh"), 5)


def test_global_engine_takes_the_pair_cache(tmp_path):
    """``GlobalSfmEngine`` accepts ``pair_cache_dir`` and shares the
    incremental engine's ``_match_pairs`` with every window pair filtered,
    pair (1, 2) included, as the JAX class sets ``_filter_all_pairs``."""
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    eng = GlobalSfmEngine(str(tmp_path), 5, device="cpu", auto_run=False, pair_cache_dir="cache")
    assert eng.pair_cache_dir == "cache" and eng._filter_all_pairs
    assert GlobalSfmEngine._match_pairs is SfmEngine._match_pairs
    assert not getattr(SfmEngine, "_filter_all_pairs", False)


@pytest.mark.parametrize("ransac", [dict(pnp_solver="dlt"), dict(adaptive=False)])
def test_engine_config_off_the_default_path_raises(ransac, tmp_path):
    """``pnp_solver="dlt"`` and fixed-count RANSAC are taken with the JAX
    engine's meaning: "dlt" raises the chain's P3P hypotheses to
    ``num_iterations()`` (5,967), and ``adaptive=False`` runs every RANSAC
    stage at that fixed count. Two images are taken too, on the JAX
    engine's staged path (no fused front, ``incremental.py:863``)."""
    import dataclasses

    from sfmfromscratch_tpu_torch.config import PipelineConfig, RansacConfig
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    cfg = dataclasses.replace(PipelineConfig(), ransac=RansacConfig(**ransac))
    eng = SfmEngine(str(tmp_path), 3, config=cfg, device="cpu", auto_run=False)
    assert eng._num_hyp == 5967
    assert eng._pnp_hyp == (5967 if ransac.get("pnp_solver") == "dlt" else 512)
    assert eng.config.ransac.adaptive is ransac.get("adaptive", True)
    two = SfmEngine(str(tmp_path), 2, config=cfg, device="cpu", auto_run=False)
    assert two.max_img == 2 and two._candidate_pairs(None) == [(1, 2)]
    assert two._use_scan_chain() and not two._fused_front_eligible(None)


def test_engine_images_of_two_sizes_raise(tmp_path):
    """Images of two sizes are taken, as the JAX engine takes them
    (``incremental.py:614-621``): each is extracted on its own and the
    fixed-capacity Features are stacked, each equal to its image's
    ``extract_features``."""
    from PIL import Image

    from sfmfromscratch_tpu_torch.config import ExtractorConfig, PipelineConfig
    from sfmfromscratch_tpu_torch.pipeline.frontend import extract_features, preprocess_image
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    r = np.random.default_rng(4)
    for i, hw in enumerate([(40, 52), (40, 52), (44, 52)], start=1):
        Image.fromarray(r.integers(0, 256, hw + (3,), dtype=np.uint8)).save(tmp_path / f"{i}.png")
        os.rename(tmp_path / f"{i}.png", tmp_path / f"{i}.jpg")   # lossless pixels
    cfg = PipelineConfig(extractor=ExtractorConfig(num_interest_points=30, ksize=3,
                                                   pyramid_level=2, feature_width=8),
                         scale_factor=1.0)
    eng = SfmEngine(str(tmp_path), 3, config=cfg, device="cpu", auto_run=False)
    feats = eng._extract_all_features()
    assert feats.descriptors.shape == (3, 30, 128)
    with Image.open(tmp_path / "3.jpg") as im:
        one = extract_features(preprocess_image(np.asarray(im, np.float32) / 255.0, 1.0), cfg.extractor)
    assert torch.equal(feats.keypoints.x[2], one.keypoints.x)
    assert torch.equal(feats.descriptors[2], one.descriptors)
    assert set(eng._kp_tracks) == {1, 2, 3}


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain version; a tensor that is on neither the
    CPU nor a CUDA card is refused, as is input the kernel does not take."""
    img = torch.rand(2, 20, 24)
    assert torch.equal(HK.harris_response_fused(img, 7, 6.0, 0.05),
                       HK.harris_response(img, 7, 6.0, 0.05))
    before = (HK.launches, MK.launches)
    d1, d2 = torch.rand(30, 128), torch.rand(40, 128)
    s1, s2, idx = MK.match_top2_fused(d1, d2)
    ref = ((d1[:, None] - d2[None]) ** 2).sum(-1)
    assert torch.equal(idx, ref.argmin(1).int())
    torch.testing.assert_close(s1, ref.min(1).values, atol=0, rtol=1e-5)
    assert (HK.launches, MK.launches) == before   # the plain versions count no launch
    with pytest.raises(ValueError):
        HK.harris_response_fused(torch.empty(20, 24, device="meta"), 7, 6.0, 0.05)
    with pytest.raises(ValueError):
        MK.match_top2_fused(torch.empty(3, 8, device="meta"), torch.empty(4, 8, device="meta"))
    with pytest.raises(ValueError):
        HK._launch(torch.zeros(1, 8, 8, dtype=torch.float64), 7, 6.0, 0.05)
    with pytest.raises(ValueError):
        HK._launch(torch.zeros(1, 8, 8), 8, 6.0, 0.05)      # even Gaussian size
    with pytest.raises(ValueError):
        MK._launch(torch.zeros(1, 3, 8), torch.zeros(1, 4, 7), torch.zeros(1, 4))


def _fake_nvcc(tmp_path, ok: bool) -> str:
    """A stand-in compiler: writes its ``-o`` output (or fails) and logs
    each call."""
    script = tmp_path / ("nvcc_ok" if ok else "nvcc_bad")
    log = tmp_path / "calls.log"
    body = (f'echo "$@" >> {log}\n'
            'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
            + ('echo built > "$out"\n' if ok else 'echo "error: refused" >&2; exit 2\n'))
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_build_raises_when_nvcc_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path, ok=False))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_all()
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    """One nvcc per source with the sm_90a flags; a second build with
    unchanged sources starts nothing; a changed source gets a new library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path, ok=True))
    build.build_all()
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert len(calls) == len(build.SOURCES) == 2
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" in c for c in calls)
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert all(os.path.exists(p) for p in paths.values())
    build.build_all()
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 2
    (csrc / "harris.cu").write_text((csrc / "harris.cu").read_text() + "\n// changed\n")
    assert build.library_path("harris") != paths["harris"]
    assert build.library_path("match_top2") == paths["match_top2"]
    build.build_all()
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 3


def test_build_keeps_nvcc_report(tmp_path, monkeypatch):
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory and
    spills) is kept beside each library and read back by ``build_log``."""
    script = tmp_path / "nvcc_report"
    script.write_text("#!/bin/sh\n"
                      'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
                      'echo built > "$out"\n'
                      'echo "ptxas info    : Used 40 registers, 0 bytes spill stores"\n')
    script.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(script))
    assert "-Xptxas" in build.NVCC_FLAGS and "-v" in build.NVCC_FLAGS
    assert build.build_log("harris") is None
    build.build_all(["harris"])
    assert "Used 40 registers" in build.build_log("harris")
    assert build.build_log("match_top2") is None


def test_precision_scope_turns_off_tf32_and_restores():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with f32_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32

        @mm_f32
        def flags():
            return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

        assert flags() == (False, False)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    """Here there is no CUDA card: the script exits non-zero and prints no
    result line. Copied alone into an empty directory it fails too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout, (r.returncode, r.stdout)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout, (r.returncode, r.stdout)
