"""Benchmark of the PyTorch and CUDA port (``sfmfromscratch_tpu_torch``) on
one NVIDIA H100: back-to-back reconstruction jobs through its engines, each
cell described by data files that the harness finds by name.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
