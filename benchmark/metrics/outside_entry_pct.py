"""The share of the traced window's batch time that lies outside the
device span of the entry call, in percent: one less the sum of the CUDA
event spans around every entry call (``batch_device_ms``) over the sum of
every batch's latency.  What remains is the client's send (its copies and,
for the digit client, the fold), the host's launch of the entry and the
read-back.  Read from the window, which runs without the profiler."""


def read(run):
    if not run.device_ms or len(run.device_ms) != len(run.latencies):
        return None
    return 100.0 * (1.0 - 1e-3 * sum(run.device_ms) / sum(run.latencies))
