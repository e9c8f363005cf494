"""The yardstick's peaks and work counts, copied here so that a change to
the program cannot move them.

``PEAKS`` is NVIDIA's data sheet for the H100 SXM at its 700 W limit
(dense rates, no sparsity), as ``repro_torch.obs.profile.PEAKS`` holds it;
a card not listed has no peaks, and a share of them is then not reported.

The flat request's work is counted as the operation, not as the kernel that
does it: every corpus row, its two float32 range endpoints, every query
with its two endpoints read once, the (Q, k) int32 ids and float32
distances written once, and 2 Q N d multiply-adds' operations against the
TF32 tensor peak, which no float32-exact product can beat.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flop_per_s": 67e12,
        "tf32_flop_per_s": 495e12,
        "bf16_flop_per_s": 989e12,
        "int8_op_per_s": 1979e12,
    },
}


def flat_work(Q: int, N: int, d: int, k: int) -> Dict[str, int]:
    """Bytes and operations of one exact filtered top-k over the corpus."""
    read = N * d * 4 + N * 2 * 4 + Q * d * 4 + Q * 2 * 4
    written = Q * k * (4 + 4)
    return {"bytes": read + written, "flops": 2 * Q * N * d}


def flat_bound_s(card: str, Q: int, N: int, d: int, k: int
                 ) -> Optional[float]:
    """Least time of the flat request's work on ``card``, or None for a card
    without published peaks."""
    peaks = PEAKS.get(card)
    if peaks is None:
        return None
    w = flat_work(Q, N, d, k)
    return max(w["bytes"] / peaks["hbm_bytes_per_s"],
               w["flops"] / peaks["tf32_flop_per_s"])
