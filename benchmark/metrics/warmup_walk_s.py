"""Host seconds of the eager warm-up walk inside the first call (part of
``capture_s``): the program's ``entry.warmup`` span of ``probs_batch``,
the walk on a side stream through its synchronize."""

from benchmark.harness import program_trace

arm = program_trace.arm


def read(run):
    return program_trace.span_seconds(run, "warmup_walk_s", "entry.warmup")
