"""The port's native host components (``native/``: the C++ union-find and
resize through ctypes, built with g++ at first use) against their numpy
versions and the JAX package's bindings, on the CPU.

The port's C++ sources are byte-equal copies of the JAX package's, so on
the same edges the track ids are equal, not only the partition, and the
resized pixels are bit-equal; the numpy versions give the same ids and
pixels to float32 rounding.
"""

import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.native import bindings as J
from sfmfromscratch_tpu_torch.native import bindings as T
from sfmfromscratch_tpu_torch.native import build

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_native_builds_from_the_ports_sources():
    """Both libraries build from the port's copies of the C++ sources, which
    are byte-equal to the JAX package's, into the package's ``_build/``,
    named by a hash of source and flags."""
    assert T.native_available() and J.native_available()
    for name, src in build.SOURCES.items():
        port = ROOT / "sfmfromscratch_tpu_torch" / "native" / src
        assert port.read_bytes() == (ROOT / "sfmfromscratch_tpu" / "native" / src).read_bytes()
        path = pathlib.Path(build.library_path(name))
        assert path.exists() and path.parent == ROOT / "sfmfromscratch_tpu_torch" / "_build"
        assert path.name.startswith(f"lib{name}-")
    assert build.CXX_FLAGS == ["-O3", "-shared", "-fPIC", "-std=c++17"]


@pytest.mark.parametrize("n, m, images", [(500, 800, 0), (300, 180, 6), (1000, 3000, 10)])
def test_build_tracks_matches_jax(n, m, images):
    """C++, plain and JAX ``build_tracks`` on random edges (with conflicting
    duplicates when ``node_image`` is given): the same track count, the same
    id for every node, and the same tracks flagged invalid."""
    r = np.random.default_rng(n + m)
    ea, eb = r.integers(0, n, m), r.integers(0, n, m)
    node_image = np.repeat(np.arange(images), n // images) if images else None
    got = T.build_tracks(ea, eb, n, node_image=node_image)
    plain = T.build_tracks_plain(ea, eb, n, node_image=node_image)
    ref = J.build_tracks(ea, eb, n, node_image=node_image)
    assert got[1] == plain[1] == ref[1]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(plain[0], ref[0])
    if images:
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(plain[2], ref[2])
        assert not got[2].all()
    else:
        assert got[2] is plain[2] is ref[2] is None


def test_build_tracks_components_and_duplicates():
    """``tests/test_native.py``'s hand-made graphs: components {0,1,2},
    {3,4}, {5}; a track seen twice in image 0 is invalid."""
    tracks, n, _ = T.build_tracks(np.array([0, 1, 3]), np.array([1, 2, 4]), 6)
    assert n == 3 and tracks[0] == tracks[1] == tracks[2] and tracks[3] == tracks[4]
    assert tracks[5] not in (tracks[0], tracks[3])
    node_image = np.array([0, 0, 1, 1, 2, 2])
    tracks, _, valid = T.build_tracks(np.array([0, 2]), np.array([1, 4]), 6, node_image=node_image)
    assert not valid[tracks[0]] and valid[tracks[2]]


@pytest.mark.parametrize("shape, out_hw", [((120, 160, 3), (60, 80)), ((100, 140), (50, 70)),
                                           ((64, 64, 3), (96, 80))])
def test_resize_gray_matches_jax(shape, out_hw):
    """uint8 RGB and gray images, down and up: C++ bit-equal to the JAX
    package's C++, the plain version bit-equal to JAX's numpy fallback and
    within 2e-3 of the C++ (float32 rounding in a different order)."""
    img = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    got = T.resize_gray(img, out_hw)
    assert got.shape == out_hw and got.dtype == np.float32
    np.testing.assert_array_equal(got, J.resize_gray(img, out_hw))
    plain = T.resize_gray_plain(img, out_hw)
    np.testing.assert_array_equal(plain, J._resize_gray_numpy(img, out_hw))
    np.testing.assert_allclose(got, plain, atol=2e-3)


def test_resize_gray_float_input_takes_numpy():
    """Float input is not the C++ path's: both packages resize it in numpy,
    to the same bits."""
    img = np.random.default_rng(8).uniform(0, 1, (40, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.resize_gray(img, (20, 25)), J.resize_gray(img, (20, 25)))


def _fake_cxx(tmp_path, ok: bool) -> str:
    """A stand-in compiler: writes its ``-o`` output (or fails) and logs
    each call."""
    script = tmp_path / ("cxx_ok" if ok else "cxx_bad")
    log = tmp_path / "calls.log"
    body = (f'echo "$@" >> {log}\n'
            'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
            + ('echo built > "$out"\n' if ok else 'echo "error: refused" >&2; exit 1\n'))
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_failing_gxx_raises(tmp_path, monkeypatch):
    """A failing compiler makes every call raise with its output; nothing
    falls back to numpy, and ``native_available`` says False."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("CXX", _fake_cxx(tmp_path, ok=False))
    with pytest.raises(RuntimeError, match="g.. failed for trackgraph.cpp:\n.*refused"):
        T.build_tracks(np.array([0]), np.array([1]), 2)
    with pytest.raises(RuntimeError, match="refused"):
        T.resize_gray(np.zeros((8, 8), np.uint8), (4, 4))
    assert not T.native_available()
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    """One compiler per source with the flags; a second build with unchanged
    sources starts nothing; a changed source gets a new library."""
    src = tmp_path / "native"
    shutil.copytree(os.path.dirname(build.__file__), src)
    monkeypatch.setattr(build, "_HERE", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("CXX", _fake_cxx(tmp_path, ok=True))
    build.build_all()
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert len(calls) == len(build.SOURCES) == 2
    assert all("-O3 -shared -fPIC -std=c++17" in c for c in calls)
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert all(os.path.exists(p) for p in paths.values())
    build.build_all()
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 2
    (src / "trackgraph.cpp").write_text((src / "trackgraph.cpp").read_text() + "\n// changed\n")
    assert build.library_path("sfmtrack") != paths["sfmtrack"]
    assert build.library_path("sfmpre") == paths["sfmpre"]
    build.build_all()
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 3


def test_global_engine_builds_tracks_in_cpp():
    """``GlobalSfmEngine._build_tracks`` calls the C++ union-find, as the JAX
    engine does (``global_sfm.py:1207``)."""
    from sfmfromscratch_tpu_torch.pipeline import global_sfm

    assert global_sfm.build_tracks is T.build_tracks
