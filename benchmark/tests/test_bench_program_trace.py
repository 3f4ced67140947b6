"""The metrics read from the program's own tracer (``warmup_walk_s``,
``graph_capture_s``, ``graph_kernels``) on runs with synthetic
recordings: the value, nothing on a recording with no capture, and
nothing, with the reason, on two captures."""

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import program_trace, spec
from genfer_tpu_torch import trace

KEY = (((4096, 1), "float64"),)
OTHER = (((64, 1), "float64"),)
METRICS = ["warmup_walk_s", "graph_capture_s", "graph_kernels"]


def _span(rec, name, start_ns, end_ns, **attrs):
    s = trace.Span()
    s.name, s.start, s.end, s.attrs = name, start_ns, end_ns, attrs
    s.id = s.call = len(rec.spans) + 1
    s.parent = None
    rec.spans.append(s)


def _captured(rec, key, kernels, entry="probs_batch", t=0):
    tag = {"entry": entry, "key": key}
    _span(rec, "entry.warmup", t, t + 8_500_000_000, **tag)
    _span(rec, "entry.capture", t + 8_500_000_000, t + 9_250_000_000, **tag)
    for kind, n in (("kernel", kernels), ("memcpy", 2)):
        k = ("graph.nodes", tuple(sorted(dict(tag, kind=kind).items())))
        rec.counters[k] = n


def _run(rec):
    run = cells.Run({}, 4096)
    run.counters[program_trace.KEY] = rec
    return run


def _read(name, run):
    return spec.module("metrics", name).read(run)


def test_each_reader_reads_the_served_entrys_capture():
    rec = trace.Recording()
    _captured(rec, KEY, 149)
    _captured(rec, OTHER, 7, entry="probs")  # another entry: not read
    run = _run(rec)
    assert _read("warmup_walk_s", run) == pytest.approx(8.5)
    assert _read("graph_capture_s", run) == pytest.approx(0.75)
    assert _read("graph_kernels", run) == 149


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_without_a_capture(name, capsys):
    rec = trace.Recording()
    _span(rec, "entry.call", 0, 10, entry="probs_batch", key=KEY)
    _span(rec, "entry.eager", 1, 9)
    assert _read(name, _run(rec)) is None
    assert "0 entry." in capsys.readouterr().err


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_on_two_captures(name, capsys):
    rec = trace.Recording()
    _captured(rec, KEY, 149)
    _captured(rec, OTHER, 149, t=10_000_000_000)
    assert _read(name, _run(rec)) is None
    err = capsys.readouterr().err
    assert err.startswith(f"{name}: 2 entry.") and "not 1" in err


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_from_a_program_without_the_tracer(name, capsys):
    run = cells.Run({}, 4096)
    run.counters[program_trace.KEY] = None
    assert _read(name, run) is None
    assert "no tracer" in capsys.readouterr().err


def test_the_metrics_share_one_recording_of_the_first_call():
    run = cells.Run({}, 4096)
    arms = [spec.module("metrics", name).arm(run) for name in METRICS]
    with arms[0], arms[1], arms[2]:
        assert trace.on and len(trace._open) == 1
        rec = run.counters[program_trace.KEY]
        with trace.span("entry.warmup", entry="probs_batch", key=KEY):
            pass
    assert not trace.on
    assert rec.find("entry.warmup")[0].attrs["key"] == KEY
