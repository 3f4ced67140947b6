"""Process start to the first timed batch: imports, the kernel libraries'
load or build, the pool of inputs, translation, the warm-up walk and
capture, and the warm-up batches."""


def read(run):
    return run.setup_s
