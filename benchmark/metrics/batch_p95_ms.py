"""The 95th percentile, by nearest rank, of the latency of every batch of
the window (host inputs handed to the client to the served answer on the
host), in milliseconds."""

import math


def p95(values):
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def read(run):
    if not run.latencies:
        return None
    return p95(run.latencies) * 1e3
