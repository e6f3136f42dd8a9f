"""The statistics of the window's samples."""

import statistics


def p95(values) -> float:
    """The 95th percentile of every sample, interpolated between the two
    samples around it (``statistics.quantiles``, inclusive)."""
    values = list(values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]

