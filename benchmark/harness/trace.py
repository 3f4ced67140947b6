"""The traced slice: a fixed number of batches under ``torch.profiler``,
and its reduction to per-batch device operations, busy time and idle
gaps.

The profiler is an unsteady source: it has lost kernel events, often the
first of a session.  So a slice profiles one batch more than it keeps,
drops the first, and is complete only where every kept batch shows the
same number of kernels; ``profile`` tries a few times before it gives up
and says so.  Device operations are kernels, copies and sets; each is
given to the batch whose host span began last before it started (a batch
ends in a read-back that waits for the card, so the next batch's work
starts after the next batch's span).
"""

from __future__ import annotations

import bisect
import sys
import time
from dataclasses import dataclass, field

#: the benchmark's host spans inside a batch, by what the host does
HOST_SPANS = ("client", "entry", "readback")
BATCH_SPAN = "batch"
PREFIX = "bench."
ATTEMPTS = 3
#: a device operation's name in the breakdown is cut to this length
NAME_CHARS = 160


@dataclass
class Slice:
    """A profiled slice, times in seconds on the profiler's clock."""

    #: (start, end) of each kept batch's host span
    batches: list
    #: per kept batch, its device operations (name, start, end)
    ops: list
    #: the host spans inside the batches: (name, start, end)
    spans: list
    complete: bool = True
    problems: list = field(default_factory=list)

    @property
    def window(self) -> tuple[float, float]:
        return self.batches[0][0], self.batches[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def kernels(self, j: int) -> list:
        return [op for op in self.ops[j] if is_kernel(op[0])]

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_length([(s, e) for ops in self.ops for _, s, e in ops],
                            lo, hi)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle gaps (start, end) in [lo, hi] between ``intervals``."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def build(batches, device_ops, spans) -> Slice:
    """A ``Slice`` from the batch spans in order (the first is dropped),
    the device operations (name, start, end) and the host spans."""
    batches = sorted(batches)
    starts = [s for s, _ in batches]
    per = [[] for _ in batches]
    for name, s, e in device_ops:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0:
            per[j].append((name, s, e))
    kept, ops = batches[1:], per[1:]
    sl = Slice(kept, ops, sorted(spans, key=lambda x: x[1]))
    counts = [len(sl.kernels(j)) for j in range(len(kept))]
    if not kept or len(set(counts)) != 1 or counts[0] == 0:
        sl.complete = False
        sl.problems.append(f"kernels a kept batch {counts}: not all equal "
                           "and above 0")
    return sl


def from_profiler(prof) -> Slice:
    """Read a ``torch.profiler.profile`` over the slice's batches from its
    raw events (the profiler's own event tree takes tens of seconds to
    build for the ~190,000 events of a digit slice)."""
    from torch.autograd import DeviceType

    batches, spans, ops = [], [], []
    events = prof.profiler.kineto_results.events()
    # offsets from one event, in integer nanoseconds before they become
    # float seconds: the clock's epoch would cost a float its last digits
    base = events[0].start_ns() if events else 0
    for e in events:
        name = e.name()
        t = ((e.start_ns() - base) / 1e9, (e.end_ns() - base) / 1e9)
        if e.device_type() == DeviceType.CUDA:
            # the profiler mirrors each host span that launched device
            # work as a device-side annotation: not an operation
            if not name.startswith(PREFIX):
                ops.append((name, *t))
        elif name == PREFIX + BATCH_SPAN:
            batches.append(t)
        elif name.startswith(PREFIX) and name[len(PREFIX):] in HOST_SPANS:
            spans.append((name[len(PREFIX):], *t))
    return build(batches, ops, spans)


def profile(step, n_keep: int, torch) -> Slice:
    """Profile ``n_keep + 1`` calls of ``step(label)`` (``label(name)``: a
    context manager that marks a host span) and read the slice; repeat
    up to ``ATTEMPTS`` times while it is incomplete."""
    from torch.profiler import ProfilerActivity, record_function

    def label(name):
        return record_function(PREFIX + name)

    problems = []
    for _ in range(ATTEMPTS):
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(n_keep + 1):
                with label(BATCH_SPAN):
                    step(label)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        t3 = time.perf_counter()
        sl = from_profiler(prof)
        print(f"trace: profiler start {t1 - t0:.3f} s, batches {t2 - t1:.3f}"
              f" s, stop {t3 - t2:.3f} s, reading "
              f"{time.perf_counter() - t3:.3f} s", file=sys.stderr)
        if sl.complete:
            sl.problems = problems
            return sl
        problems += sl.problems
    sl.problems = problems
    return sl


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps by the
    host span they fell in, each in seconds a kept batch."""
    n = len(sl.batches)
    by_op: dict = {}
    for ops in sl.ops:
        for name, s, e in ops:
            key = name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (e - s)
    lo, hi = sl.window
    idle: dict = {}
    every = [(s, e) for ops in sl.ops for _, s, e in ops]
    for s, e in gaps(every, lo, hi):
        mid = (s + e) / 2
        where = next((name for name, a, b in sl.spans if a <= mid <= b),
                     "between")
        idle[where] = idle.get(where, 0.0) + (e - s)

    def ranked(d):
        return [[k, v / n] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}
