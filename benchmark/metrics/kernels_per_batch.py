"""Kernels a batch in the profiled slice (copies and sets left out); read
only where every kept batch shows the same count."""


def read(run):
    sl = run.slice
    if sl is None or not sl.complete:
        return None
    return len(sl.kernels(0))
