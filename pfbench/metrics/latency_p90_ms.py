"""latency_p90_ms: the nearest-rank 90th percentile over every request of
the window, each from its call to the numpy depth it returned (host
clock). Meaningful where the window holds 100 requests or more, so that 10
lie beyond it."""

import math


def nearest_rank(values, q: float) -> float:
    """The smallest value with at least a share q of the values at or
    below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def read(run):
    if not run.latencies_s:
        return None
    return nearest_rank(run.latencies_s, 0.9) * 1e3
