"""The port's tracer: spans and counts at the boundaries of the serving
path, kept in memory while a recording is open.

    from genfer_tpu_torch import trace

    with trace.recording() as rec:
        program.probs_batch(params)
    for s in rec.find("entry.capture", entry="probs_batch"):
        print(s.name, s.ns / 1e9, rec.self_ns(s) / 1e9)
    rec.count("graph.nodes", entry="probs_batch", kind="kernel")

A span has a name, a start and an end on ``time.perf_counter_ns()``, its
own id, its parent's id (the span open around it in the same context: a
context-local stack, which ``carry`` takes onto another thread) and a
call id that every span of one entry call shares.  A count is an integer
keyed by a name and attributes.  Recordings may be nested: every
recording open when a span closes, or when a count is made, receives it.
A recording keeps at most ``MAX_SPANS`` spans and counts the rest in its
``dropped`` and in the module's ``dropped``, so a serving process may
keep one open; that adds about 25 us of host time to a served call (the
scam example at batch 4096 on an H100 machine, ``PERF.md`` section 6).

With no recording open ``span`` and ``count`` test ``on`` and return;
code on a hot path tests ``trace.on`` itself before it builds a count's
attributes.  While a recording is open and ``torch.profiler`` is active,
each span is also a ``record_function("genfer." + name)``: the profiler's
trace then holds the span on its own clock, beside the kernels the span
launched.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import sys
import threading
import time

#: True while a recording is open; every span and count tests it first
on = False
#: spans that full recordings dropped, in this process
dropped = 0
#: spans a recording keeps at most (read when it opens)
MAX_SPANS = 1_000_000

_open: list = []
_lock = threading.Lock()
_ids = itertools.count(1)
#: the innermost open span of this context: (id, call id, name, outer)
_stack = contextvars.ContextVar("genfer_trace_stack", default=None)


class Span:
    """One span (times in ``perf_counter_ns``); ``span`` returns it open,
    as a context manager."""

    __slots__ = ("name", "start", "end", "id", "parent", "call", "attrs",
                 "_token", "_mirror")

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, {self.ns} ns, id={self.id}, "
                f"parent={self.parent}, call={self.call}, {self.attrs})")

    def _open(self, name, attrs, new_call):
        self.start = time.perf_counter_ns()
        self.name, self.attrs, self.id = name, attrs, next(_ids)
        outer = _stack.get()
        self.parent = None if outer is None else outer[0]
        self.call = self.id if new_call or outer is None else outer[1]
        self._token = _stack.set((self.id, self.call, name, outer))
        self._mirror = None
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            self._mirror = prof.record_function("genfer." + name)
            self._mirror.__enter__()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
            self._mirror = None
        _stack.reset(self._token)
        self._token = None
        self.end = time.perf_counter_ns()
        with _lock:
            for rec in _open:
                rec._keep(self)
        return False


class Recording:
    """The spans and counts closed while it was open."""

    def __init__(self):
        self.max_spans = MAX_SPANS
        self.spans: list[Span] = []
        #: (name, sorted attribute items) -> count
        self.counters: dict = {}
        self.dropped = 0

    def find(self, name: str, **attrs) -> list[Span]:
        """The spans named ``name`` whose attributes include ``attrs``."""
        return [s for s in self.spans if s.name == name
                and all(s.attrs.get(k) == v for k, v in attrs.items())]

    def count(self, name: str, **attrs) -> int:
        """The sum of the counts named ``name`` whose attributes include
        ``attrs``."""
        return sum(n for (cname, items), n in self.counters.items()
                   if cname == name and attrs.items() <= dict(items).items())

    def children(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: Span) -> int:
        """``span``'s duration less the part of it its children cover."""
        covered, reach = 0, span.start
        for c in sorted(self.children(span), key=lambda s: s.start):
            lo, hi = max(c.start, reach), min(c.end, span.end)
            if hi > lo:
                covered += hi - lo
                reach = hi
        return span.ns - covered

    def _keep(self, span: Span) -> None:
        global dropped
        if len(self.spans) < self.max_spans:
            self.spans.append(span)
        else:
            self.dropped += 1
            dropped += 1


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, *, new_call: bool = False, **attrs):
    """A context manager that records the span ``name`` with ``attrs`` in
    every open recording when it closes.  ``new_call``: the span starts
    an entry call (its id is the call id of the spans inside it)."""
    if not on:
        return _NULL
    return Span()._open(name, attrs, new_call)


def count(name: str, n: int = 1, **attrs) -> None:
    """Add ``n`` to the count ``name`` with ``attrs`` in every open
    recording."""
    if not on:
        return
    key = (name, tuple(sorted(attrs.items())))
    with _lock:
        for rec in _open:
            rec.counters[key] = rec.counters.get(key, 0) + n


def carry(work):
    """``work``, to run on another thread inside the span open here (its
    spans then nest in that span); ``work`` itself where none is open."""
    frame = _stack.get()
    if frame is None:
        return work

    def carried():
        _stack.set(frame)
        return work()

    return carried


def enclosing(names) -> str | None:
    """The innermost open span of this context whose name is in
    ``names``, or None."""
    frame = _stack.get()
    while frame is not None:
        if frame[2] in names:
            return frame[2]
        frame = frame[3]
    return None


@contextlib.contextmanager
def recording():
    """Open a ``Recording``, kept until the block ends."""
    global on
    rec = Recording()
    with _lock:
        _open.append(rec)
        on = True
    try:
        yield rec
    finally:
        with _lock:
            _open.remove(rec)
            on = bool(_open)
