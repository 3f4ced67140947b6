"""Kernel nodes of the CUDA graph that ``probs_batch`` replays a batch,
read from the captured graph itself (the program's ``graph.nodes``
count, kind ``kernel``); kernels the client runs outside the entry are
not in it."""

from benchmark.harness import program_trace

arm = program_trace.arm


def read(run):
    return program_trace.graph_count(run, "graph_kernels", "kernel")
