"""The program's own tracer (``genfer_tpu_torch.trace``) around the first
call, for the metrics read from inside the program.

``arm(run)`` opens one recording around the first call (the eager warm-up
walk and the capture), whichever of these metrics armed first, and keeps
it in ``run.counters``; the window and the profiled slice run with no
recording open.  A program without the tracer leaves nothing there, and
each metric reads nothing.  A metric reads the served entry's
(``probs_batch``) one capture: it reads nothing, and says why on
standard error, where there is not exactly one (on the CPU nothing is
captured).
"""

from __future__ import annotations

import contextlib
import importlib
import sys

KEY = "program_trace"
#: the served entry point
ENTRY = "probs_batch"


@contextlib.contextmanager
def arm(run):
    if KEY in run.counters:
        yield
        return
    try:
        trace = importlib.import_module("genfer_tpu_torch.trace")
    except ImportError:
        run.counters[KEY] = None
        yield
        return
    with trace.recording() as rec:
        run.counters[KEY] = rec
        yield


def _fail(metric: str, why: str):
    print(f"{metric}: {why}", file=sys.stderr)
    return None


def one_span(run, metric: str, name: str):
    """The served entry's one ``name`` span, or None (and why)."""
    rec = run.counters.get(KEY)
    if rec is None:
        return _fail(metric, "the program has no tracer")
    spans = rec.find(name, entry=ENTRY)
    if len(spans) != 1:
        return _fail(metric, f"{len(spans)} {name} spans of {ENTRY}, not 1")
    return spans[0]


def span_seconds(run, metric: str, name: str):
    span = one_span(run, metric, name)
    return None if span is None else span.ns / 1e9


def graph_count(run, metric: str, kind: str):
    """The served entry's one captured graph's nodes of ``kind``."""
    span = one_span(run, metric, "entry.capture")
    if span is None:
        return None
    return run.counters[KEY].count("graph.nodes", entry=ENTRY,
                                   key=span.attrs["key"], kind=kind)
