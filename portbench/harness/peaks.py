"""Published peaks of the card and the roofline bound.

NVIDIA's H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3 bandwidth,
67 TFLOP/s float32 outside the tensor cores, both at the full power
limit of 700 W. A share of a roofline is stated against these, with the
card's power limit beside it (``power_limit_w``).
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple, Optional

H100_BYTES_S = 3.35e12
H100_F32_FLOPS = 67e12


class Bound(NamedTuple):
    seconds: float
    by: str  # "bytes" or "ops": which of the two binds


def bound(n_bytes: float, n_ops: float, bytes_s: float = H100_BYTES_S,
          flops: float = H100_F32_FLOPS) -> Bound:
    """The least time the card could take: the larger of bytes over peak
    bandwidth and float32 operations over peak rate."""
    tb, to = n_bytes / bytes_s, n_ops / flops
    return Bound(tb, "bytes") if tb >= to else Bound(to, "ops")


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, from ``nvidia-smi``, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
