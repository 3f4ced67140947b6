"""Mean device milliseconds of the entry call over every batch of the
traced window: CUDA events on the current stream before and after the
call (the copy into the graph's inputs, the replay, the clone)."""


def read(run):
    if not run.device_ms:
        return None
    return sum(run.device_ms) / len(run.device_ms)
