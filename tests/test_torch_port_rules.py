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
import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu_torch.ops.cuda import build
from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
from sfmfromscratch_tpu_torch.ops.cuda import nullvec_kernel as NK
from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq
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
# The trainer slice (TinyPoint's self-supervised trainer).
_SLICE_10 = ("ops/sp_train.py",)


@pytest.mark.parametrize("rel", _SLICE_2 + _SLICE_4 + _SLICE_5 + _SLICE_6 + _SLICE_7 + _SLICE_8
                         + _SLICE_9 + _SLICE_10)
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


def test_train_tool_imports_no_jax():
    """``tools/train_superpoint_torch.py`` names neither ``jax`` nor the JAX
    package in any import, and run as a script in a fresh interpreter (with
    ``train`` and the save stubbed) it loads neither, passes its ``steps``
    argument on and saves to the port's own weights."""
    tool = ROOT / "tools" / "train_superpoint_torch.py"
    for node in ast.walk(ast.parse(tool.read_text(), str(tool))):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not any(_forbidden(n) for n in names), names
    code = (
        "import os, runpy, sys\n"
        "import sfmfromscratch_tpu_torch.ops.sp_train as st\n"
        "import sfmfromscratch_tpu_torch.ops.superpoint as sp\n"
        "st.train = lambda steps: (print('STEPS', steps), sp.SuperPointNet.tiny())[1]\n"
        "saved = []\n"
        "sp.save_flax_weights = lambda path, net: saved.append(path)\n"
        "os.path.getsize = lambda path: 0\n"
        "sys.argv = ['train_superpoint_torch.py', '3']\n"
        f"runpy.run_path({str(tool)!r}, run_name='__main__')\n"
        "print('SAVED', saved)\n"
        f"print('FORBIDDEN', sorted(n for n in sys.modules if n.split('.')[0] in {_FORBIDDEN!r}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout and "STEPS 3" in r.stdout, r.stdout
    weights = str(PORT / "weights" / "tinypoint_synth.npz")
    assert f"SAVED [{weights!r}]" in r.stdout, r.stdout


def test_scenarios_import_no_jax():
    """What ``tests/test_torch_scenarios.py`` runs of the port (``chip_smoke``'s
    scenario names on the CPU and ``tests/render.py``) and ``python
    tools/scenario_pins.py --package port`` (here one seed of the two-image
    scenario) load neither ``jax`` nor the JAX package in a fresh
    interpreter."""
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import chip_smoke\n"
        "from tests import render\n"
        "api = chip_smoke.port_scenario_api(torch.device('cpu'))\n"
        "assert api.SfmEngine.keywords == {'device': torch.device('cpu')}\n"
        "sys.argv = ['scenario_pins.py', '--package', 'port', '--seeds', '0',\n"
        "            '--scenarios', 'two_images']\n"
        f"runpy.run_path({str(ROOT / 'tools' / 'scenario_pins.py')!r}, run_name='__main__')\n"
        f"print('FORBIDDEN', sorted(n for n in sys.modules if n.split('.')[0] in {_FORBIDDEN!r}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout
    assert '"failed_seeds": []' in r.stdout and '"package": "port"' in r.stdout, r.stdout


def test_train_pins_port_takes_device_and_init(tmp_path, monkeypatch):
    """``tools/train_pins.py``'s port trainer (``--device``, ``--init``): from
    the weights in ``--init`` its first step's losses are those of
    ``make_train_step`` on that net and the seed's first batch; without it
    the port's seeded draw gives other losses; the run stays on the device
    it is given (the CPU here) and saves a checkpoint that loads."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import chip_smoke
    import train_pins

    from sfmfromscratch_tpu_torch.ops import sp_train
    from sfmfromscratch_tpu_torch.ops.superpoint import load_flax_weights

    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    init = str(ROOT / "tests" / "data" / "tinypoint_init_key0.npz")
    ckpt = str(tmp_path / "ckpt.npz")
    got = train_pins._train_port(0, 2, ckpt, "cpu", init)
    H, W = chip_smoke.TRAIN_HW
    _, step = sp_train.make_train_step(load_flax_weights(init))
    ref = [float(v) for v in step(sp_train.make_batch(np.random.default_rng(0), 2, H, W))]
    assert len(got) == 2 and list(got[0]) == ref
    assert next(load_flax_weights(ckpt).parameters()).device.type == "cpu"
    assert train_pins._train_port(0, 1, ckpt, "cpu")[0] != got[0]


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


# JAX modules with no module at the same path in the port, and what stands in
# for each.
_MODULE_STAND_INS = {
    "ops/pallas/__init__.py": "ops/cuda/__init__.py",
    "ops/pallas/harris_kernel.py": "ops/cuda/harris_kernel.py",   # K1, K2 -> csrc/harris.cu
    "ops/pallas/match_kernel.py": "ops/cuda/match_kernel.py",     # K3 -> csrc/match_top2.cu
    "ops/pallas/support.py": "ops/cuda/build.py",                 # nvcc at first use
    "utils/cache.py": "ops/cuda/build.py",                        # source-keyed build cache
}
# Public names of the JAX package with no counterpart of the same name in the
# port's module, each with its reason. Names imported from ``typing`` are
# exempt everywhere: they are annotations, not the module's interface.
_NAME_EXCEPTIONS = {
    "mm_f32": "XLA's float32 matmul-precision scope; the port's is "
              "utils/precision.py::f32_precision (TF32 off)",
    "jnp_asarray_u32": "a JAX array constructor; the port's checkpoints hold torch tensors",
    "pallas_tpu_available": "asks for a TPU; the port's wrappers dispatch on the tensor's device",
    "Mesh": "jax.sharding.Mesh; the port's mesh is torch's DeviceMesh (parallel/mesh.py)",
    "P": "jax.sharding.PartitionSpec; torch.distributed shards without specs",
    "shard_map": "JAX's SPMD map; the port's ranks run the code themselves",
    "TARGETS": "native/build.py's target table; the port's is build.py::SOURCES",
    "build": "native/build.py's one-target build; the port's is build.py::build_all and load",
    "put_global": "places a host array on a JAX mesh; the port's ranks hold "
                  "their tensors (parallel/mesh.py::all_gather_cat)",
}


def _public_names(path: pathlib.Path) -> set:
    """The public names a module binds at its top level, by AST: functions,
    classes, assignments and ``from`` imports, also inside top-level ``if``,
    ``try`` and ``with`` blocks. A name bound to a whole module (``import x
    as y``, also where a fallback assigns it) and ``__future__`` statements
    are not names the module defines; names from ``typing`` and imports
    under ``if TYPE_CHECKING:`` are annotations and exempt."""
    names, modules = set(), set()

    def visit(body):
        for node in body:
            if isinstance(node, ast.Import):
                modules.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, ast.If) and isinstance(node.test, ast.Name) \
                    and node.test.id == "TYPE_CHECKING":
                visit(node.orelse)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                    names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
            elif isinstance(node, ast.ImportFrom) and node.module not in ("__future__", "typing"):
                names.update(a.asname or a.name for a in node.names if a.name != "*")
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for block in ("body", "orelse", "finalbody"):
                    visit(getattr(node, block, []))
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)

    visit(ast.parse(path.read_text(), str(path)).body)
    return {n for n in names - modules if not n.startswith("_")}


def _lazy_names(path: pathlib.Path) -> set:
    """The names a module serves through a top-level ``__getattr__``
    (``if name == "X"``)."""
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for cmp in ast.walk(node):
                if isinstance(cmp, ast.Compare) and isinstance(cmp.comparators[0], ast.Constant):
                    out.add(cmp.comparators[0].value)
    return out


def test_public_names_match_jax():
    """Every public top-level name of every module of the JAX package has a
    counterpart of the same name in the port's module at the same path
    (the lazy ``__getattr__`` names too), apart from the listed exceptions;
    a JAX module without such a port module is listed with its stand-in,
    which exists. Read by AST: neither package is imported."""
    jroot = ROOT / "sfmfromscratch_tpu"
    gaps, used = {}, set()
    modules = sorted(jroot.rglob("*.py"))
    assert len(modules) >= 50
    for path in modules:
        rel = path.relative_to(jroot).as_posix()
        port = PORT / rel
        if not port.exists():
            assert rel in _MODULE_STAND_INS, f"{rel}: no port module and no stand-in listed"
            assert (PORT / _MODULE_STAND_INS[rel]).exists(), _MODULE_STAND_INS[rel]
            continue
        missing = (_public_names(path) - _public_names(port)) \
            | (_lazy_names(path) - _lazy_names(port))
        used |= missing & set(_NAME_EXCEPTIONS)
        missing -= set(_NAME_EXCEPTIONS)
        if missing:
            gaps[rel] = sorted(missing)
    assert not gaps, gaps
    assert used == set(_NAME_EXCEPTIONS), set(_NAME_EXCEPTIONS) - used   # no stale exception
    assert all((jroot / rel).exists() for rel in _MODULE_STAND_INS)


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
    """No import statement of the port, of ``chip_smoke.py`` or of the
    port's tools (``tools/*_torch.py``) names ``jax`` or the JAX package,
    not even inside a function."""
    tools = sorted((ROOT / "tools").glob("*_torch.py"))
    assert ROOT / "tools" / "eval_superpoint_torch.py" in tools
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + tools
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

    # make_problem, the chain's edge scales and the trainer, as
    # the JAX functions run on the default device.
    from sfmfromscratch_tpu_torch.ba.problem import make_problem
    from sfmfromscratch_tpu_torch.ops import sp_train
    from sfmfromscratch_tpu_torch.pipeline.chain_refresh import solve_edge_scales

    cams, pts = np.zeros((2, 6), np.float32), np.ones((3, 3), np.float32)
    obs = (np.array([0, 1, 1]), np.array([0, 1, 2]), np.zeros((3, 2), np.float32),
           np.stack([np.eye(3)] * 2))
    E, cap = 3, 4
    edges = (np.array([0, 0, 1]), np.array([1, 2, 2]), np.tile(np.arange(cap), (E, 1)),
             np.ones((E, cap), bool), np.full((E, cap), 2.0), np.full((E, cap), 3.0), np.ones(E))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_problem(cams, pts, *obs, device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            solve_edge_scales(*edges, device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            sp_train.train(steps=1, batch=1, hw=(16, 16), device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_problem(cams, pts, *obs)
    assert make_problem(cams, pts, *obs, device="cpu").obs_cam.device.type == "cpu"
    lam = solve_edge_scales(*edges, device="cpu")
    assert lam.shape == (E,) and np.isfinite(lam).all()
    net = sp_train.train(steps=1, batch=1, hw=(16, 16), log_every=0, device="cpu")
    assert next(net.parameters()).device.type == "cpu"

    # project_one_dist creates no tensor: it runs on its inputs' device and
    # asks for no card.
    from sfmfromscratch_tpu_torch.ba.problem import project_one_dist

    uv = project_one_dist(torch.zeros(6), torch.tensor([0.0, 0.0, 2.0]), torch.eye(3), 1.0, 0.0)
    assert uv.device.type == "cpu" and uv.tolist() == [0.0, 0.0]


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


def test_wrappers_dispatch_by_device(monkeypatch):
    """CPU tensors take the plain version; a tensor that is on neither the
    CPU nor a CUDA card is refused, as is input the kernel does not take.
    The null-vector kernel solves every system of a call in one launch."""
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

    # 8x9 systems on the CPU: torch.linalg.qr, no launch.
    A = torch.randn(3, 5, 8, 9, generator=torch.Generator().manual_seed(0))
    before = (NK.launches, NK.systems)
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    assert torch.equal(nullvec_lstsq(A), Q[..., :, -1] / torch.linalg.norm(Q[..., :, -1], dim=-1,
                                                                           keepdim=True))
    assert torch.equal(NK.nullvec_8x9(A), nullvec_lstsq(A))
    assert (NK.launches, NK.systems) == before
    with pytest.raises(ValueError):
        NK.nullvec_8x9(torch.empty(4, 8, 9, device="meta"))
    with pytest.raises(ValueError):
        nullvec_lstsq(torch.empty(4, 8, 9, device="meta"))
    for bad in (torch.zeros(4, 8, 9, dtype=torch.float64), torch.zeros(4, 7, 9),
                torch.zeros(4, 9, 8), torch.zeros(9)):
        with pytest.raises(ValueError):
            NK._launch(bad)

    # The launch, faked: one (A, S, 8, 9) call is one launch of A * S systems.
    calls = []

    def fake_nullvec(device, a_ptr, out_ptr, count):
        calls.append(count)

    def failing(*args):
        raise RuntimeError("sfm_nullvec_qr failed with CUDA error 1")

    monkeypatch.setattr(NK, "_nullvec", fake_nullvec)
    out = NK._launch(A.transpose(0, 1))          # non-contiguous: copied, then launched
    assert calls == [15] and tuple(out.shape) == (5, 3, 9)
    assert (NK.launches, NK.systems) == (before[0] + 1, before[1] + 15)
    assert NK._launch(torch.zeros(0, 4, 8, 9)).shape == (0, 4, 9) and calls == [15]
    monkeypatch.setattr(NK, "_nullvec", failing)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        NK._launch(A)
    assert NK.launches == before[0] + 1

    # Under torch.func.vmap (the fixed-count relative poses) the operator
    # makes one launch over the vmapped dimension and the rest.
    seen = []

    def recording(X):
        seen.append(tuple(X.shape))
        return NK.nullvec_qr_plain(X)

    monkeypatch.setattr(NK, "_launch", recording)
    got = torch.func.vmap(NK._nullvec_op, in_dims=1)(A)
    assert seen == [(5, 3, 8, 9)]
    assert torch.equal(got, NK.nullvec_qr_plain(A.transpose(0, 1)))
    assert torch.equal(NK._nullvec_op(A), NK.nullvec_qr_plain(A)) and seen[-1] == (3, 5, 8, 9)


@pytest.mark.parametrize("m, n, to_wrapper", [(8, 9, True), (7, 9, False), (9, 9, False),
                                               (12, 9, False)])
def test_nullvec_lstsq_takes_the_wrapper_at_8x9_only(m, n, to_wrapper, monkeypatch):
    """``nullvec_lstsq`` hands (..., 8, 9) systems, and only those, to the
    null-vector wrapper, whatever the leading dimensions; other shapes keep
    their QR or SVD path."""
    from sfmfromscratch_tpu_torch.ops import smallsvd

    seen = []

    def recording(A):
        seen.append(tuple(A.shape))
        return NK.nullvec_qr_plain(A)

    monkeypatch.setattr(smallsvd, "nullvec_8x9", recording)
    A = torch.randn(2, 3, m, n, generator=torch.Generator().manual_seed(m * n))
    v = nullvec_lstsq(A)
    assert tuple(v.shape) == (2, 3, n)
    assert seen == ([(2, 3, 8, 9)] if to_wrapper else [])
    # ||A v|| is the least singular value (0 for the minimal systems).
    smin = torch.linalg.svdvals(A)[..., -1] if m >= n else torch.zeros(2, 3)
    norm = torch.linalg.norm(A, dim=(-2, -1))
    assert torch.all(torch.linalg.norm(A @ v[..., None], dim=(-2, -1))
                     <= smin * (1 + 1e-4) + 1e-5 * norm)


def test_bind_loads_once_and_raises_on_a_cuda_error(monkeypatch):
    """A bound kernel loads its library at its first launch only, declares
    the C function's argument types with the stream last and an int
    result, launches on the device's current stream with that device
    current, and raises on a nonzero return. Every wrapper binds through
    it."""
    loads, calls, entered, ret = [], [], [], [0]

    def sfm_fake(*args):
        calls.append(args)
        return ret[0]

    class Entered:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or
                        types.SimpleNamespace(sfm_fake=sfm_fake))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "device", Entered)
    launch = build.bind("fake", "sfm_fake", [ctypes.c_void_p, ctypes.c_int])
    assert loads == []
    launch(torch.device("cuda", 0), 5, 6)
    launch(torch.device("cuda"), 7, 8)
    launch(torch.device("cuda", 1), 9, 10)
    assert loads == ["fake"] and calls == [(5, 6, 77), (7, 8, 77), (9, 10, 77)]
    assert entered == [torch.device("cuda", 1)]
    assert sfm_fake.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert sfm_fake.restype is ctypes.c_int
    ret[0] = 700
    with pytest.raises(RuntimeError, match="sfm_fake failed with CUDA error 700"):
        launch(torch.device("cuda", 0), 1, 2)
    for wrapper in ("harris_kernel", "match_kernel", "nullvec_kernel", "segsum_kernel",
                    "transavg_kernel"):
        text = (PORT / "ops" / "cuda" / f"{wrapper}.py").read_text()
        assert text.count(" = bind(") == 1 and "cuda_stream" not in text, wrapper


def test_port_sums_take_no_accumulating_index_put():
    """Sums on the card add in a fixed order, never with atomics: no
    ``accumulate=True`` anywhere in the port; every segment sum takes a
    plan (``ba/schur.py::segment_sum``)."""
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    assert PORT / "ba" / "schur.py" in files and PORT / "csrc" / "segment_sum.cu" in files
    assert [p for p in files if "accumulate=True" in p.read_text()] == []


def test_kernels_take_no_atomics_and_wrappers_no_fallback():
    """Sums on the card add in a fixed order: no kernel source calls an
    atomic (``atomicAdd`` and its kin); a wrapper launches its kernel for a
    CUDA tensor or raises, with no ``try`` that falls back to the plain
    version."""
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert PORT / "csrc" / "translation_averaging.cu" in sources
    assert [p.name for p in sources if re.search(r"\batomic\w*\s*[(<]", p.read_text())] == []
    wrappers = sorted((PORT / "ops" / "cuda").glob("*_kernel.py"))
    assert PORT / "ops" / "cuda" / "transavg_kernel.py" in wrappers
    for path in wrappers:
        tree = ast.parse(path.read_text(), str(path))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path.name


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
    nvcc = _fake_nvcc(tmp_path, ok=False)   # written once: the builds run it at once
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
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
    nvcc = _fake_nvcc(tmp_path, ok=True)   # written once: the builds run it at once
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    build.build_all()
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert len(calls) == len(build.SOURCES) == 5
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" in c for c in calls)
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert all(os.path.exists(p) for p in paths.values())
    build.build_all()
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 5
    (csrc / "harris.cu").write_text((csrc / "harris.cu").read_text() + "\n// changed\n")
    assert build.library_path("harris") != paths["harris"]
    assert build.library_path("match_top2") == paths["match_top2"]
    assert build.library_path("nullvec_qr") == paths["nullvec_qr"]
    assert build.library_path("segment_sum") == paths["segment_sum"]
    assert build.library_path("translation_averaging") == paths["translation_averaging"]
    build.build_all()
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 6


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
