"""The 95th percentile of every completed query's latency, start to answer on the host."""

import statistics


def read(run):
    if len(run.latencies_s) < 2:
        return None
    return statistics.quantiles(run.latencies_s, n=100, method="inclusive")[94] * 1e3
