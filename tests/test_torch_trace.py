"""The port's tracer (``genfer_tpu_torch.trace``) and the spans and counts
of the serving path.

On the CPU: parent and call ids of nested spans and ``self_ns``; counts by
attributes; nested recordings; the span cap with ``dropped``; no trace at
all with no recording open, over 1000 served calls; the translation's
spans; the constants' copies and K1's products by the walk's phase; and
the spans mirrored into ``torch.profiler`` inside their own intervals.  On
the card (marked ``cuda``): the captured graph's kernel nodes against the
profiler's kernels of one replay, no constant copied in a capture, one
warm-up and one capture a key, K1's products by phase, a replay a call,
the shared clock of the replay span and its kernels, and ``--profile
DIR`` holding ``genfer.kernels.load``.  The file imports no JAX, so the
card machine collects it."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from genfer_tpu_torch import compile as C
from genfer_tpu_torch import trace
from genfer_tpu_torch.ops import conv2d_f64 as K1

ROOT = Path(__file__).resolve().parent.parent

SCAM = """
calls ~ Poisson(10);
scams ~ Binomial(calls, $p);
observe(scams = 1);
return calls;
"""
#: the cheapest program to serve on the CPU
COIN = """
x ~ Bernoulli($p);
return x;
"""


def _spans(rec):
    return {s.name: s for s in rec.spans}


def _events(prof):
    """The profiler's raw events: (name, device type, start, end), times in
    ``perf_counter_ns`` (the profiler's clock is the wall clock)."""
    shift = time.time_ns() - time.perf_counter_ns()
    return [(e.name(), e.device_type(), e.start_ns() - shift,
             e.end_ns() - shift)
            for e in prof.profiler.kineto_results.events()]


# ----------------------------------------------------------------------
# the tracer
# ----------------------------------------------------------------------

def test_nested_spans_carry_parent_and_call_ids():
    """Parents follow nesting (onto the big-stack thread too), a new call
    starts a call id, and ``self_ns`` leaves out what children cover."""
    with trace.recording() as rec:
        with trace.span("outer", tag=1):
            time.sleep(0.002)
            with trace.span("call", new_call=True):
                with trace.span("inner"):
                    time.sleep(0.002)
                C._translate_big_stack(
                    lambda: trace.span("thread").__enter__().__exit__())
            with trace.span("sibling"):
                time.sleep(0.002)
    s = _spans(rec)
    assert s["outer"].parent is None and s["outer"].call == s["outer"].id
    assert s["outer"].attrs == {"tag": 1}
    assert s["call"].parent == s["outer"].id
    assert s["call"].call == s["call"].id
    assert s["inner"].parent == s["call"].id
    assert s["inner"].call == s["call"].id
    assert s["thread"].parent == s["call"].id
    assert s["sibling"].parent == s["outer"].id
    assert s["sibling"].call == s["outer"].id
    assert rec.children(s["outer"]) == [s["call"], s["sibling"]]
    assert rec.self_ns(s["outer"]) == (s["outer"].ns - s["call"].ns
                                       - s["sibling"].ns)
    assert rec.self_ns(s["outer"]) >= 2_000_000
    assert rec.self_ns(s["inner"]) == s["inner"].ns
    assert [x.name for x in rec.spans] == ["inner", "thread", "call",
                                           "sibling", "outer"]


@pytest.mark.parametrize("query,want", [
    ({}, 7), ({"kind": "kernel"}, 5), ({"kind": "kernel", "key": 1}, 3),
    ({"key": 2}, 4), ({"kind": "memset"}, 0)])
def test_counts_by_attributes(query, want):
    with trace.recording() as rec:
        trace.count("nodes", 3, kind="kernel", key=1)
        trace.count("nodes", 2, kind="kernel", key=2)
        trace.count("nodes", kind="memcpy", key=2)
        trace.count("nodes", kind="memcpy", key=2)
        trace.count("other", 100, kind="kernel", key=1)
    assert rec.count("nodes", **query) == want
    assert rec.counters[("nodes", (("key", 2), ("kind", "memcpy")))] == 2


def test_nested_recordings_each_receive_what_closes_inside():
    with trace.recording() as outer:
        with trace.span("before"):
            pass
        with trace.recording() as inner:
            with trace.span("both"):
                trace.count("n")
            with trace.span("straddles"):
                pass
        assert trace.on
        with trace.span("after"):
            trace.count("n")
    assert not trace.on
    assert [s.name for s in outer.spans] == ["before", "both", "straddles",
                                             "after"]
    assert [s.name for s in inner.spans] == ["both", "straddles"]
    assert outer.count("n") == 2 and inner.count("n") == 1
    assert inner.spans[0] is outer.spans[1]


def test_a_full_recording_counts_what_it_drops(monkeypatch):
    assert trace.MAX_SPANS == 1_000_000
    before = trace.dropped
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.recording() as small:
        monkeypatch.setattr(trace, "MAX_SPANS", 10)
        with trace.recording() as big:
            for j in range(5):
                with trace.span("s", j=j):
                    pass
    assert [s.attrs["j"] for s in small.spans] == [0, 1, 2]
    assert small.dropped == 2 and trace.dropped - before == 2
    assert len(big.spans) == 5 and big.dropped == 0


@pytest.mark.parametrize("around,phase", [
    (None, "eager"), ("entry.warmup", "warmup"), ("entry.capture", "capture"),
])
def test_constant_copies_count_by_phase(around, phase):
    ns = C._ConstantNamespace(torch.device("cpu"), {})
    with trace.recording() as rec:
        with trace.span(around) if around else trace.span("entry.call"):
            with trace.span("deeper"):
                ns.asarray([1.0, 2.0])
                ns.asarray([1.0, 2.0])  # served from the cache
                ns.asarray(3.0)
    assert rec.count("walk.constants_copied") == 2
    assert rec.count("walk.constants_copied", phase=phase) == 2


@pytest.mark.parametrize("around,phase", [
    (None, "eager"), ("entry.warmup", "warmup"), ("entry.capture", "capture"),
])
def test_k1_products_count_by_phase(around, phase, monkeypatch):
    """``k1.products`` {body, a, b, out, phase}: each launch counts under
    the phase of the walk that made it (K1's launch replaced by its plain
    version, so that the count is made on the CPU)."""
    monkeypatch.setattr(K1, "_on_card", lambda a: True)
    monkeypatch.setattr(K1, "_launch", lambda body, a, b, c0, c1, flag,
                        rows: K1.conv2d_trunc_f64_batched_reference(
                            a, b, (c0, c1)))
    a = torch.ones((3, 5, 4), dtype=torch.float64)
    b = torch.ones((3, 2, 2), dtype=torch.float64)
    with trace.recording() as rec:
        with trace.span(around) if around else trace.span("entry.call"):
            with trace.span("deeper"):
                K1.conv2d_trunc_f64_batched(a, b, (6, 5))
                K1.conv2d_trunc_f64_batched(a, b, (6, 5))
    tag = {"body": "small", "a": (5, 4), "b": (2, 2), "out": (6, 5)}
    assert rec.count("k1.products", **tag) == 2
    assert rec.count("k1.products", phase=phase, **tag) == 2
    assert trace.phase() == "eager"


# ----------------------------------------------------------------------
# the serving path on the CPU
# ----------------------------------------------------------------------

def test_no_recording_records_nothing(monkeypatch):
    """With no recording open, 1000 served calls open no span, take no
    lock of the tracer and put nothing in the profiler's trace."""
    program = C.CompiledProgram(COIN, ["p"], 2, device="cpu")
    params = torch.tensor([[0.2], [0.7]], dtype=torch.float64)
    want = program.probs_batch(params)

    def boom(*args, **kwargs):
        raise AssertionError("the tracer ran with no recording open")

    monkeypatch.setattr(trace.Span, "_open", boom)
    monkeypatch.setattr(trace, "_lock", None)
    first_id = next(trace._ids)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(1000):
            got = program.probs_batch(params)
    assert not trace.on and next(trace._ids) == first_id + 1
    assert torch.equal(got, want)
    assert not [e for e in _events(prof) if e[0].startswith("genfer.")]


def test_translation_spans():
    with trace.recording() as rec:
        C.CompiledProgram(SCAM, ["p"], 26, device="cpu")
    (tr,) = rec.find("compile.translate")
    parse, gf = rec.children(tr)
    assert (parse.name, gf.name) == ("compile.parse", "compile.gf")
    assert tr.start <= parse.start <= parse.end <= gf.start <= gf.end \
        <= tr.end
    assert 0 <= rec.self_ns(tr) < tr.ns
    assert {parse.call, gf.call} == {tr.id}


def test_a_served_call_on_the_cpu():
    """A call is ``entry.call`` {entry, key} around ``entry.eager``; the
    first walk copies the constants, the second none; nothing is
    captured or replayed."""
    program = C.CompiledProgram(COIN, ["p"], 2, device="cpu")
    params = torch.tensor([[0.2], [0.7]], dtype=torch.float64)
    with trace.recording() as rec:
        program.probs_batch(params)
        program.probs_batch(params)
        program._probs.eager(params[0])
    calls = rec.find("entry.call", entry="probs_batch")
    assert len(calls) == 2
    assert calls[0].attrs["key"] == (((2, 1), torch.float64),)
    for c in calls:
        (eager,) = rec.children(c)
        assert eager.name == "entry.eager" and eager.call == c.id
    (alone,) = rec.find("entry.eager", entry="probs")
    assert alone.parent is None and alone.call == alone.id
    assert rec.count("walk.constants_copied", phase="eager") > 0
    assert rec.count("walk.constants_copied") == rec.count(
        "walk.constants_copied", phase="eager")
    for name in ("entry.replays", "entry.captures", "graph.nodes"):
        assert rec.count(name) == 0


def test_spans_mirror_into_the_profiler_inside_their_intervals():
    """Under ``torch.profiler`` each span is also a ``genfer.*`` event,
    which lies inside the span's own interval."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            program = C.CompiledProgram(COIN, ["p"], 2, device="cpu")
            for p in (0.2, 0.6):
                program.probs_batch(torch.tensor([[p]], dtype=torch.float64))
    events = sorted((e for e in _events(prof) if e[0].startswith("genfer.")),
                    key=lambda e: e[2])
    spans = sorted(rec.spans, key=lambda s: s.start)
    assert [e[0] for e in events] == ["genfer." + s.name for s in spans]
    assert [s.name for s in spans] == [
        "compile.translate", "compile.parse", "compile.gf",
        "entry.call", "entry.eager", "entry.call", "entry.eager"]
    slack = 200_000  # ns: the profiler's clock against perf_counter_ns
    for (_, _, start, end), s in zip(events, spans):
        assert s.start - slack <= start <= end <= s.end + slack
    # the events nest as the spans do, on the profiler's own clock
    assert events[0][2] <= events[1][2] and events[2][3] <= events[0][3]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _grid(n):
    return torch.linspace(0.01, 0.99, n, dtype=torch.float64,
                          device="cuda").reshape(n, 1)


def _kernels(events):
    return sorted((e for e in events if e[1] == DeviceType.CUDA
                   and not e[0].startswith(("Memcpy", "Memset", "genfer."))),
                  key=lambda e: e[2])


@pytest.mark.cuda
def test_captures_replays_and_graph_nodes_on_the_card(card):
    """One warm-up and one capture a key, no constant copied in a capture,
    a replay a call, and the graph's kernel nodes equal to the kernels
    the profiler sees in one replay."""
    program = C.CompiledProgram(SCAM, ["p"], 26, device="cuda")
    with trace.recording() as rec:
        for n in (64, 128, 64, 64, 128):
            program.probs_batch(_grid(n))
    torch.cuda.synchronize()
    keys = {s.attrs["key"] for s in rec.find("entry.call")}
    assert len(keys) == 2
    for key in keys:
        tag = {"entry": "probs_batch", "key": key}
        assert len(rec.find("entry.warmup", **tag)) == 1
        (cap,) = rec.find("entry.capture", **tag)
        (inst,) = rec.children(cap)
        assert inst.name == "entry.instantiate"
        assert rec.count("entry.captures", **tag) == 1
    assert rec.count("entry.replays", entry="probs_batch") == 5
    assert len(rec.find("entry.replay")) == 5
    assert rec.count("walk.constants_copied", phase="capture") == 0
    assert rec.count("walk.constants_copied", phase="warmup") > 0
    assert rec.count("k1.products", body="small") == 4 * 26
    for phase in ("warmup", "capture"):
        assert rec.count("k1.products", body="small", phase=phase) == 2 * 26
    nodes = rec.count("graph.nodes", kind="kernel") // 2
    assert nodes > 0

    key = (((64, 1), torch.float64),)
    (static, graph, out), = [v for k, v in program._probs_batch.graphs.items()
                             if k == key]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kernels = _kernels(_events(prof))
    # CUDA runs a graph's device-to-device copy nodes as kernels of
    # its own (``memcpy32_post`` and the like)
    copies = [k for k in kernels if k[0].startswith("memcpy")]
    assert len(kernels) - len(copies) == rec.count(
        "graph.nodes", kind="kernel", key=key)
    assert len(copies) <= rec.count("graph.nodes", kind="memcpy", key=key)
    assert nodes == rec.count("graph.nodes", kind="kernel",
                              key=(((128, 1), torch.float64),))


def _replays(prof):
    """Each profiled ``probs_batch`` call's replay: checks that its
    ``genfer.entry.call`` holds its ``genfer.entry.replay``, which holds
    the call's one graph launch and starts, on the profiler's clock,
    before every kernel of that launch (kernels joined to their launch
    by CUPTI's correlation id); returns the kernels seen a replay."""
    raw = list(prof.profiler.kineto_results.events())
    host = [e for e in raw if e.device_type() != DeviceType.CUDA]
    kernels = [e for e in raw if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset", "genfer."))]

    def named(name):
        return sorted((e for e in host if e.name() == name),
                      key=lambda e: e.start_ns())

    replays, calls = named("genfer.entry.replay"), named("genfer.entry.call")
    assert len(replays) == len(calls) == 3
    launches = [e for e in host if e.name().startswith("cudaGraphLaunch")]
    counts = []
    for j, (call, rep) in enumerate(zip(calls, replays)):
        assert call.start_ns() <= rep.start_ns() <= rep.end_ns() \
            <= call.end_ns()
        (launch,) = [e for e in launches
                     if rep.start_ns() <= e.start_ns() <= rep.end_ns()]
        corr = launch.correlation_id()
        mine = [k for k in kernels if corr in (k.correlation_id(),
                                               k.linked_correlation_id())]
        ids = [(k.correlation_id(), k.linked_correlation_id())
               for k in kernels[:4]]
        assert mine, f"no kernel of replay {j} (launch {corr}): {ids}"
        assert rep.start_ns() < min(k.start_ns() for k in mine)
        counts.append(len(mine))
    return counts


@pytest.mark.cuda
def test_the_replay_span_shares_the_profilers_clock(card):
    """Three profiled calls with a recording open: each call's
    ``genfer.entry.replay`` precedes the kernels of its replay and lies
    inside its ``genfer.entry.call`` (``_replays``).  The profiler can
    lose kernel events: a try whose replays show unequal kernel counts
    is made again, up to three tries, as the benchmark's profiled slice
    does."""
    program = C.CompiledProgram(SCAM, ["p"], 26, device="cuda")
    grid = _grid(256)
    program.probs_batch(grid)
    torch.cuda.synchronize()
    tries = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with trace.recording():
                for _ in range(3):
                    program.probs_batch(grid)
                    torch.cuda.synchronize()
        tries.append(_replays(prof))
        if len(set(tries[-1])) == 1:
            return
    pytest.fail(f"kernels a replay unequal in three tries: {tries}")


@pytest.mark.cuda
def test_profile_dir_holds_the_kernel_load_span(card, tmp_path):
    """``--profile DIR`` on a program that reaches K1 writes
    ``genfer.kernels.load`` into DIR/trace.json (a fresh process: the
    library loads once a process)."""
    prog = tmp_path / "scam.sgcl"
    prog.write_text(SCAM.replace("$p", "0.2"))
    out = tmp_path / "profile"
    subprocess.run([sys.executable, "-m", "genfer_tpu_torch", str(prog),
                    "--backend", "jax", "--profile", str(out)], cwd=ROOT,
                   check=True, capture_output=True, timeout=600)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "genfer.kernels.load" in names
