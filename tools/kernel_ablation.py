"""What bounds the top-2 matcher kernel on a CUDA card: ablations and the
segment split.

Builds ``csrc/match_top2.cu`` as committed and three variants of it, made by
exact text substitution (the script fails if the source no longer holds the
text it replaces), each a different function that only serves to time one
part of the kernel:

- ``registers``: the f32 mode's A and B operands come from registers, not
  shared memory (no shared-memory reads in the inner loop);
- ``no_top2``: the running top-2 keeps only the minimum (``fminf``);
- ``no_mma``: the bf16 mode skips the ``mma.sync`` instructions.

It times each, in both modes, at the engine's shape (9 pairs of 2499 x 2499
x 128) and at the two-view's (one pair), by CUDA-graph replay
(``chip_smoke._graph_ms``), with the split chosen by the kernel; then times
the committed kernel at every forced segment count 1..16. The card's SM
clock and power are sampled with ``nvidia-smi`` while the committed f32
kernel runs for about a second. Prints one JSON line per measurement and,
with ``--out``, writes them all to that file.

    python3 tools/kernel_ablation.py [--out kernel_ablation.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing helpers)

F32_A = "const float4 a = *reinterpret_cast<const float4*>(Ak + i * 16 * SA + k);"
F32_B = "bv[j] = *reinterpret_cast<const float4*>(Bk + j * 16 * SB + k);"
PUSH = """  b2 = fminf(b2, fmaxf(b1, v));
  i1 = v < b1 ? j : i1;
  b1 = fminf(b1, v);"""
MMA = """          mma_bf16(acc[mi][2 * np], af[mi], b0, b1);
          mma_bf16(acc[mi][2 * np + 1], af[mi], b2, b3);"""

VARIANTS = {
    "committed": [],
    "registers": [
        (F32_A, "const float4 a = make_float4(__int_as_float(k + i), __int_as_float(k + i + 1), "
                "__int_as_float(k + i + 2), __int_as_float(k + i + 3));"),
        (F32_B, "bv[j] = make_float4(__int_as_float(k + j), __int_as_float(k + j + 7), "
                "__int_as_float(k + j + 2), __int_as_float(k + j + 5));"),
    ],
    "no_top2": [(PUSH, "  b1 = fminf(b1, v);")],
    "no_mma": [(MMA, """          acc[mi][2 * np][0] += __uint_as_float(af[mi][0] ^ b0 ^ b1);
          acc[mi][2 * np + 1][0] += __uint_as_float(af[mi][1] ^ b2 ^ b3);""")],
}


def build(out_dir: str):
    """One library per variant, nvcc processes started together."""
    from sfmfromscratch_tpu_torch.ops.cuda import build as B

    with open(os.path.join(B.CSRC, "match_top2.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: text to replace not found: {old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"match_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libmatch_{name}.so")
        cmd = [B.nvcc_path(), *B.NVCC_FLAGS, "-o", lib, cu]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for name, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(lib).sfm_match_top2
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
        logs[name] = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    return libs, logs


def clock_sample(fn, seconds: float = 1.0):
    """(SM MHz, max SM MHz, W) every 100 ms while ``fn`` runs back to back."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = []
    for line in out.strip().splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the lines to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device available", file=sys.stderr)
        return 2
    from sfmfromscratch_tpu_torch.ops.cuda import build as B
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    dev = torch.device("cuda")
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._nvidia_smi()})
    libs, logs = build(os.path.join(B.BUILD_DIR, "ablation"))
    emit({"ptxas": logs})
    gen = torch.Generator(device=dev).manual_seed(1)
    max_seg = 16
    for B_, n1, n2 in [(9, 2499, 2499), (1, 2499, 2499)]:
        d1 = chip_smoke._descriptors(gen, dev, B_, n1)
        d2 = chip_smoke._descriptors(gen, dev, B_, n2)
        mask2 = torch.rand((B_, n2), generator=gen, device=dev) > 0.1
        _, n2sq = MK._norms(d1, d2, mask2)
        r1 = torch.empty((B_, n1), device=dev)
        r2 = torch.empty_like(r1)
        ri = torch.empty((B_, n1), dtype=torch.int32, device=dev)
        scratch = torch.empty((3 * B_ * max_seg * n1,), device=dev)

        def runner(fn, bf16, segs):
            def run():
                err = fn(d1.data_ptr(), d2.data_ptr(), n2sq.data_ptr(), r1.data_ptr(),
                         r2.data_ptr(), ri.data_ptr(), scratch.data_ptr(), B_, n1, n2, 128,
                         bf16, segs, max_seg, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            return run

        for bf16 in (0, 1):
            for name, fn in libs.items():
                if (name == "registers" and bf16) or (name == "no_mma" and not bf16):
                    continue
                ms, err = chip_smoke._graph_ms(runner(fn, bf16, 0))
                emit({"shape": [B_, n1, n2, 128], "bf16": bool(bf16), "variant": name,
                      "segments": "auto", "graph_ms": ms, "error": err})
            for segs in range(1, max_seg + 1):
                ms, err = chip_smoke._graph_ms(runner(libs["committed"], bf16, segs))
                emit({"shape": [B_, n1, n2, 128], "bf16": bool(bf16), "variant": "committed",
                      "segments": segs, "graph_ms": ms, "error": err})
        if B_ == 9:
            samples = clock_sample(runner(libs["committed"], 0, 0))
            emit({"shape": [B_, n1, n2, 128], "clock_samples_mhz_max_w": samples})
    emit({"nvidia_smi": chip_smoke._nvidia_smi()})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
