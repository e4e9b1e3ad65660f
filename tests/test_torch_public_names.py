"""The public names the port took over from the JAX package last, against
their JAX counterparts on the CPU, on the same numpy inputs.

``MetricsLogger``, ``to_uint8``/``to_float``, ``project_one_dist`` and
``load_magicleap_weights`` are new functions of the port; every other name is
a re-export or a module-level import, held to be the very object of the port
module that JAX's statement names. Each tolerance is stated where it is used.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_rules import _NAME_EXCEPTIONS

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = pathlib.Path(__file__).resolve().parents[1]
JROOT = ROOT / "sfmfromscratch_tpu"


def test_metrics_logger_matches_jax(tmp_path, monkeypatch):
    """The same events give the same bytes in both packages' JSON-lines files
    (the clock fixed on both sides), appended across two loggers, and the
    lines read back as ``tests/test_aux.py::test_metrics_logger`` reads them."""
    import time

    from sfmfromscratch_tpu.utils.metrics import MetricsLogger as JLogger
    from sfmfromscratch_tpu_torch.utils.metrics import MetricsLogger

    monkeypatch.setattr(time, "time", lambda: 1760000000.125)
    events = [("ba", dict(reproj_rmse=0.5, iters=12)), ("frame", dict(fps=3.2)),
              ("stage", dict(name="chain", ms=[1.5, 2.25], ok=True, note=None))]
    paths = []
    for cls, name in ((JLogger, "jax.jsonl"), (MetricsLogger, "port.jsonl")):
        path = tmp_path / name
        for chunk in (events[:2], events[2:]):
            m = cls(str(path))
            for event, fields in chunk:
                m.log(event, **fields)
            m.close()
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    lines = [json.loads(line) for line in paths[1].read_text().splitlines()]
    assert [r["event"] for r in lines] == ["ba", "frame", "stage"]
    assert lines[1]["fps"] == 3.2 and lines[0]["ts"] == 1760000000.125


def test_metrics_logger_defaults_to_stderr(capsys):
    """Without a path both loggers write the same line to stderr and leave it
    open."""
    import time

    from sfmfromscratch_tpu.utils.metrics import MetricsLogger as JLogger
    from sfmfromscratch_tpu_torch.utils.metrics import MetricsLogger

    out = []
    for cls in (JLogger, MetricsLogger):
        m = cls()
        m.log("x", v=1)
        m.close()
        out.append(json.loads(capsys.readouterr().err))
    assert abs(out[0].pop("ts") - time.time()) < 60 and abs(out[1].pop("ts") - time.time()) < 60
    assert out[0] == out[1] == {"event": "x", "v": 1}
    assert not sys.stderr.closed


def test_image_conversions_match_jax():
    """``to_uint8`` and ``to_float`` give JAX's arrays bit for bit: every
    uint8 value, and floats in [0, 1] with the edges and values next to each
    step of 1/255."""
    from sfmfromscratch_tpu.io import images as jimages
    from sfmfromscratch_tpu_torch.io import images

    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    r = np.random.default_rng(3)
    steps = np.arange(256, dtype=np.float32) / 255.0
    floats = np.concatenate([r.uniform(0, 1, 500).astype(np.float32), [0.0, 1.0], steps,
                             np.nextafter(steps, np.float32(2)),
                             np.nextafter(steps, np.float32(-1))]).astype(np.float32)
    for got, ref in ((images.to_float(u8), jimages.to_float(u8)),
                     (images.to_uint8(floats), jimages.to_uint8(floats)),
                     (images.to_uint8(floats.astype(np.float64)),
                      jimages.to_uint8(floats.astype(np.float64)))):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def _camera_batch(n, seed=4):
    r = np.random.default_rng(seed)
    cams = np.concatenate([r.normal(0, 0.3, (n, 3)), r.normal(0, 0.5, (n, 3))], 1)
    X = np.stack([r.uniform(-2, 2, n), r.uniform(-1.5, 1.5, n), r.uniform(4, 9, n)], 1)
    K = np.tile(np.array([[520.0, 0, 240], [0, 515.0, 180], [0, 0, 1]]), (n, 1, 1))
    K[:, 0, 0] += r.uniform(-20, 20, n)
    return tuple(a.astype(np.float32) for a in (cams, X, K))


@pytest.mark.parametrize("s, k1", [(1.0, 0.0), (1.06, -0.08), (0.93, 0.15)])
def test_project_one_dist_matches_jax(s, k1):
    """``project_one_dist`` on 200 seeded cameras, points and intrinsics, one
    at a time in JAX (``jax.vmap``) and batched in the port, within 1e-5
    relative of JAX. A coordinate is ``s f x_d + c``, so it is relative to
    the sum's terms, ``|s f x_d| + |c|``: a coordinate near 0 is a
    cancellation of two terms of ~240 px, whose float32 rounding (1.5e-5 px)
    is larger than 1e-5 of the result (seen: 2.0e-5 px at 1.44 px, 1 of 400).
    One unbatched call gives the same; the scale and k1 as Python floats and
    as 0-dim tensors give the same; with s=1, k1=0 it is ``_project`` within
    the same bound."""
    from sfmfromscratch_tpu.ba.problem import project_one_dist as jproj
    from sfmfromscratch_tpu_torch.ba.problem import _project, project_one_dist

    cams, X, K = _camera_batch(200)
    ref = np.asarray(jax.vmap(lambda c, x, k: jproj(c, x, k, s, k1))(
        jnp.asarray(cams), jnp.asarray(X), jnp.asarray(K)))
    tc, tX, tK = (torch.as_tensor(a) for a in (cams, X, K))
    c = K[:, :2, 2]
    terms = np.abs(ref - c) + np.abs(c)     # |s f x_d| + |c|

    def close(a, b, rows=slice(None)):
        assert (np.abs(a - b) <= 1e-5 * terms[rows]).all(), np.abs(a - b).max()

    got = project_one_dist(tc, tX, tK, s, k1)
    assert got.shape == (200, 2) and got.dtype == torch.float32 and got.device.type == "cpu"
    close(got.numpy(), ref)
    one = project_one_dist(tc[7], tX[7], tK[7], s, k1)
    assert one.shape == (2,)
    close(one.numpy(), ref[7], 7)
    as_tensors = project_one_dist(tc, tX, tK, torch.tensor(s), torch.tensor(k1))
    close(as_tensors.numpy(), got.numpy())
    if s == 1.0 and k1 == 0.0:
        close(_project(tc, tX, tK).numpy(), ref)


def _magicleap_state(seed=0):
    """A random state dict in the layout of ``superpoint_v1.pth``."""
    shapes = {
        "conv1a": (64, 1, 3), "conv1b": (64, 64, 3), "conv2a": (64, 64, 3),
        "conv2b": (64, 64, 3), "conv3a": (128, 64, 3), "conv3b": (128, 128, 3),
        "conv4a": (128, 128, 3), "conv4b": (128, 128, 3), "convPa": (256, 128, 3),
        "convPb": (65, 256, 1), "convDa": (256, 128, 3), "convDb": (256, 256, 1),
    }
    g = torch.Generator().manual_seed(seed)
    return {k: v for name, (o, i, kk) in shapes.items()
            for k, v in ((f"{name}.weight", torch.randn(o, i, kk, kk, generator=g) * 0.05),
                         (f"{name}.bias", torch.randn(o, generator=g) * 0.01))}


def test_load_magicleap_weights_matches_jax(tmp_path):
    """``load_magicleap_weights`` of a ``.pth`` written here: the port's net
    holds JAX's flax params bit for bit (in flax layout), and the two nets
    give the same detector logits and descriptors on a 48x64 image within
    1e-4 (absolute; float32 convolutions in another order)."""
    from sfmfromscratch_tpu.ops import superpoint as jsp
    from sfmfromscratch_tpu_torch.ops.superpoint import (
        SuperPointNet, flax_params_from_state_dict, load_magicleap_weights,
    )

    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(_magicleap_state(), path)
    ref = jsp.load_magicleap_weights(path)
    net = load_magicleap_weights(path)
    assert isinstance(net, SuperPointNet) and net.desc_dim == 256
    got = flax_params_from_state_dict(net.state_dict())
    assert sorted(got) == sorted(ref["params"])
    for layer, leaves in ref["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(v))
    img = np.random.default_rng(1).uniform(0, 1, (1, 48, 64)).astype(np.float32)
    jsemi, jdesc = jsp.SuperPointNet().apply(ref, jnp.asarray(img[..., None]))
    with torch.no_grad():
        semi, desc = net(torch.as_tensor(img[:, None]))
    np.testing.assert_allclose(semi.permute(0, 2, 3, 1).numpy(), np.asarray(jsemi), atol=1e-4)
    np.testing.assert_allclose(desc.permute(0, 2, 3, 1).numpy(), np.asarray(jdesc), atol=1e-4)


def _package_imports(rel):
    """(port module, name, port module it comes from) for each name that
    JAX's module ``rel`` imports from its own package at the top level."""
    out = []
    tree = ast.parse((JROOT / rel).read_text())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("sfmfromscratch_tpu."):
            src = node.module.replace("sfmfromscratch_tpu", "sfmfromscratch_tpu_torch", 1)
            out += [(a.asname or a.name, a.name, src) for a in node.names
                    if not (a.asname or a.name).startswith("_")]
    return out


_IMPORTERS = ("io/__init__.py", "utils/__init__.py", "ba/__init__.py", "ops/__init__.py",
              "pipeline/__init__.py", "geometry/__init__.py", "compat.py", "geometry/pnp.py",
              "pipeline/incremental.py", "pipeline/global_sfm.py",
              "parallel/sharded_match.py")


@pytest.mark.parametrize("rel", _IMPORTERS)
def test_package_imports_are_the_port_counterparts(rel):
    """Each name that a JAX module (the subpackages' ``__init__`` files and
    the modules whose imports were missing) imports from its own package is,
    in the port's module of the same path, the very object of the port's
    module at the same source path; the values of those objects are held
    against JAX by their own modules' tests."""
    import importlib

    mod = importlib.import_module(
        "sfmfromscratch_tpu_torch." + rel[:-3].replace("/", ".").replace(".__init__", ""))
    pairs = _package_imports(rel)
    assert pairs
    for bound, name, src in pairs:
        if bound in _NAME_EXCEPTIONS:
            continue
        assert getattr(mod, bound) is getattr(importlib.import_module(src), name), (rel, bound)


def test_pipeline_serves_the_engines_lazily():
    """``from sfmfromscratch_tpu_torch.pipeline import SfmEngine,
    GlobalSfmEngine`` works; as in the JAX package, importing the
    subpackage loads neither engine until one is asked for, and an unknown
    name raises ``AttributeError``."""
    code = (
        "import sys\n"
        "import sfmfromscratch_tpu_torch.pipeline as p\n"
        "print('EAGER', 'sfmfromscratch_tpu_torch.pipeline.incremental' in sys.modules)\n"
        "from sfmfromscratch_tpu_torch.pipeline import SfmEngine, GlobalSfmEngine\n"
        "from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as G\n"
        "print('SAME', GlobalSfmEngine is G, SfmEngine.__module__, issubclass(G, SfmEngine))\n"
        "try:\n"
        "    p.NoSuchEngine\n"
        "except AttributeError as e:\n"
        "    print('MISSING', e)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "EAGER False" in r.stdout, r.stdout
    assert "SAME True sfmfromscratch_tpu_torch.pipeline.incremental True" in r.stdout, r.stdout
    assert "MISSING NoSuchEngine" in r.stdout, r.stdout
