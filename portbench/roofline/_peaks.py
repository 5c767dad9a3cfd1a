"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet): 3.35
TB/s of HBM3 bandwidth at the full 700 W power limit.  A roofline share
is stated against this peak with the card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str) -> float:
    """The card's published HBM rate; raises for a card not listed."""
    if kind not in HBM_BYTES_PER_S:
        raise KeyError(f"no published HBM peak for {kind!r}")
    return HBM_BYTES_PER_S[kind]
