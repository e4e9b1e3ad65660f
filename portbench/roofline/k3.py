"""Ratio-test matcher's distance and top-2 core (``csrc/match_top2.cu``) on
B pairs of n1 x D and n2 x D float32 descriptors: 2 B n1 n2 D FLOPs; bytes
are both descriptor sets and the second set's norms read once, 12 bytes a
query written (best and second distance, nearest index)."""


def work(B: int, n1: int, n2: int, D: int):
    """(bytes, FLOPs) of one call on B pairs."""
    flops = 2.0 * B * n1 * n2 * D
    nbytes = 4.0 * (B * n1 * D + B * n2 * D + B * n2) + 12.0 * B * n1
    return nbytes, flops


def bound_s(nbytes: float, flops: float, peaks: dict) -> float:
    """Least time at the card's peaks: bytes or FP32 FLOPs, whichever binds."""
    return max(nbytes / peaks["bytes_per_s"], flops / peaks["fp32_flops"])
