"""Build the CUDA kernels (``csrc/*.cu``) into shared libraries with a plain C
interface, and load them with ctypes.

Each source compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC -Xptxas -v`` into ``_build/lib<name>-<hash>.so`` inside the
package, with nvcc's report beside it in ``lib<name>-<hash>.log``;
the hash covers the source text and the flags, so a changed source rebuilds
and an unchanged one is reused. :func:`build_all` starts one ``nvcc`` per
source, all at once. Nothing is built when the module is imported.

    python -m sfmfromscratch_tpu_torch.ops.cuda.build     # build everything
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

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

SOURCES = {
    "harris": "harris.cu",
    "match_top2": "match_top2.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills of each kernel, kept in the .log
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Path of the built library for kernel ``name`` at the current source."""
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built; returns
    ``(process, library, temporary output)`` or None."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def build_all(names: Optional[List[str]] = None) -> None:
    """Build every kernel (or ``names``), one nvcc process per source, all
    running at once. Raises if any build fails."""
    names = list(SOURCES) if names is None else names
    started = [(n, _start(n)) for n in names]
    errors = []
    for n, job in started:
        if job is None:
            continue
        proc, out, tmp = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{log}")
        else:
            with open(out[:-3] + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> Optional[str]:
    """nvcc's output for kernel ``name`` at the current source (``-Xptxas -v``:
    registers, shared memory and spills per kernel), or None if that source
    has not been built."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
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
