"""Probe the card's machine, then run the engine, global and compat phases
of ``chip_smoke.py`` (a short first call after a change to those phases).

Prints whether ``cv2``, ``matplotlib`` and ``PIL`` import (each in a fresh
interpreter) and the C++ compiler's version, then the phases' JSON lines;
exits non-zero if a phase fails.

    python3 tools/compat_probe.py
"""

import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    for m in ("cv2", "matplotlib", "PIL"):
        r = subprocess.run([sys.executable, "-c", f"import {m}; print({m}.__version__)"],
                           capture_output=True, text=True)
        print("PROBE", m, r.returncode, r.stdout.strip(), r.stderr.strip()[-300:], flush=True)
    r = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    print("PROBE g++", r.returncode, r.stdout.splitlines()[:1], flush=True)

    import torch

    import chip_smoke as cs
    from sfmfromscratch_tpu_torch.ops.cuda.build import build_all

    dev = torch.device("cuda")
    print(cs._nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    build_all()
    print("build_s", time.perf_counter() - t0, flush=True)
    try:
        _, engine_ba = cs.engine_phase(dev)
        t0 = time.perf_counter()
        cs.global_phase(dev)
        print("global_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        cs.compat_phase(dev, engine_ba)
        print("compat_s", time.perf_counter() - t0)
    except Exception:  # noqa: BLE001 - report and fail
        traceback.print_exc()
        return 1
    print("PROBE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
