"""Host seconds of the first batch: the eager warm-up walk, the CUDA
graph's capture and the first replay, read-back included."""


def read(run):
    return run.spans.get("capture_s")
