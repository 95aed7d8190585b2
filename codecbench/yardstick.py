"""The yardstick: peaks of the cards the benchmark knows, and the
percentile its tail is taken with."""
from __future__ import annotations

import math

# Published HBM bandwidth, bytes/s (NVIDIA's H100 SXM data sheet, at the
# full 700 W power limit).  A card not listed gets no roofline share.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def p95(values) -> float:
    """Nearest-rank 95th percentile: the smallest value that at least 95%
    of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
