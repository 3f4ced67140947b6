"""Host seconds of the CUDA graph's capture inside the first call (part of
``capture_s``): the program's ``entry.capture`` span of ``probs_batch``,
the walk under ``torch.cuda.graph`` through the graph's instantiation."""

from benchmark.harness import program_trace

arm = program_trace.arm


def read(run):
    return program_trace.span_seconds(run, "graph_capture_s",
                                      "entry.capture")
