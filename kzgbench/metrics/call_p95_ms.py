"""call_p95_ms: the 95th percentile of every window call's host-clock latency."""

import statistics


def read(run):
    lat = run.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
