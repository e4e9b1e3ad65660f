"""Published peaks of the NVIDIA H100 (data sheets, dense, without
sparsity), by the variant the card's name reports: memory bytes/s and FP32
(non-tensor-core) FLOP/s. They assume the card's full power limit (700 W
for the SXM part); a run records the card's own limit beside its numbers.
"""

PEAKS = {
    "PCIe": (2.0e12, 51.2e12),
    "NVL": (3.9e12, 60.0e12),
    "SXM": (3.35e12, 67.0e12),
}


def peaks(card_name: str) -> dict:
    """Bytes/s and FP32 FLOP/s of the card named ``card_name`` (an H100
    whose name gives no variant is taken as SXM)."""
    variant = next((k for k in PEAKS if k in card_name), "SXM")
    bw, fp32 = PEAKS[variant]
    return {"variant": variant, "bytes_per_s": bw, "fp32_flops": fp32}
