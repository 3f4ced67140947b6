"""Inferences completed in the window over the window's seconds: every
batch the window completed, times its batch size, over the time from the
window's start to the last batch's answer."""


def read(run):
    if not run.latencies or run.window_s <= 0:
        return None
    return len(run.latencies) * run.batch / run.window_s
