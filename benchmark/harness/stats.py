"""Whole-window statistics."""

from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of all
    values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def rate(count: float, seconds: float) -> float:
    """Work completed over the whole window, per second."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds
