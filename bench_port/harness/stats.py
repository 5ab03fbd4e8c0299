"""Statistics the metrics share, and the card's published peaks."""
from __future__ import annotations

import statistics
from typing import Sequence

# NVIDIA H100 SXM5 80 GB data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile, interpolated between order statistics
    (``statistics.quantiles``' inclusive method; numpy's default)."""
    vals = list(values)
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method="inclusive")[q - 1])
