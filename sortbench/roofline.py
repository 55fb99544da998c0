"""The table of peaks and the least bytes a call must move.

A call's least bytes count each input byte read once and each output byte
written once, whatever the kernels read again: per key, what the
configuration's ``bytes_per_key`` states (``read`` + ``written``).
"""

from __future__ import annotations

from typing import Optional

# Published peak HBM bandwidth by the name torch.cuda.get_device_name()
# gives (NVIDIA's H100 data sheet: the SXM part at its 700 W limit).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def least_bytes(config: dict, n: int) -> int:
    """Bytes a call on ``n`` keys must move under ``config``."""
    per_key = config["bytes_per_key"]
    return n * (int(per_key["read"]) + int(per_key["written"]))


def peak_bytes_per_s(kind: str) -> Optional[float]:
    """The card's published peak bandwidth, or None for a card not in the
    table."""
    return PEAK_BYTES_PER_S.get(kind)
