"""Build the native host components (``trackgraph.cpp``, ``preprocess.cpp``:
C++ with a plain C interface) into shared libraries, and load them with
ctypes (counterpart of ``sfmfromscratch_tpu/native/build.py``).

Each source compiles on its own with ``g++ -O3 -shared -fPIC -std=c++17``
into ``_build/lib<name>-<hash>.so`` inside the package; the hash covers the
source text and the flags, so a changed source rebuilds and an unchanged one
is reused. :func:`build_all` starts one compiler per source, all at once. A
failed build raises with the compiler's output. Nothing is built when the
module is imported: the bindings build at first use.

    python -m sfmfromscratch_tpu_torch.native.build     # build everything
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

SOURCES = {
    "sfmpre": "preprocess.cpp",
    "sfmtrack": "trackgraph.cpp",
}

CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def cxx_path() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native components cannot be built")
    return cxx


def library_path(name: str) -> str:
    """Path of the built library ``name`` at the current source."""
    with open(os.path.join(_HERE, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names: Optional[List[str]] = None) -> None:
    """Build every library (or ``names``) not yet built, one compiler
    process per source, all running at once. Raises if any build fails."""
    names = list(SOURCES) if names is None else names
    jobs = []
    for n in names:
        out = library_path(n)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx_path(), *CXX_FLAGS, os.path.join(_HERE, SOURCES[n]), "-o", tmp]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((n, proc, out, tmp))
    errors = []
    for n, proc, out, tmp in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"g++ failed for {SOURCES[n]}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib


if __name__ == "__main__":
    build_all()
    for n in SOURCES:
        print(library_path(n))
    sys.exit(0)
