"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line.

The traffic is a closed loop: one caller, one batch in flight.  A batch
is timed from the moment its host inputs are handed to the client to the
moment the served answer is on the host.  Set-up builds the pool of
input batches from the seed, translates the program, makes the first
call (the eager warm-up walk and the capture) and serves the traffic's
warm-up batches; the window then cycles through the pool for ``seconds``
and takes every batch it completes.

With ``trace`` the window also keeps, a batch, the host time of the
entry call and CUDA events around it; after the window a fixed slice of
batches runs under ``torch.profiler`` (``trace.profile``).  The metrics
are read by the readers in ``metrics/`` from the ``Run`` below.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

from . import check, spec, trace
from . import traffic as gen


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    config: dict
    batch: int
    setup_s: float = 0.0
    #: host-clock spans of set-up, by name (``translate_s``,
    #: ``capture_s``)
    spans: dict = field(default_factory=dict)
    #: counts the readers' ``arm`` hooks made during the first call
    counters: dict = field(default_factory=dict)
    #: seconds of each batch of the window, client to served answer
    latencies: list = field(default_factory=list)
    window_s: float = 0.0
    #: with ``trace``: host seconds of each entry call, and the device
    #: milliseconds between CUDA events around it
    entry_host_s: list = field(default_factory=list)
    device_ms: list = field(default_factory=list)
    slice: trace.Slice | None = None


class Cell:
    """A cell with its configuration and traffic (from their files unless
    given)."""

    def __init__(self, name: str, bench: dict | None = None,
                 config: dict | None = None, traffic: dict | None = None):
        self.bench = bench or spec.benchmark()
        self.cell = spec.cell(self.bench, name)
        self.config = config or spec.config(self.bench, self.cell["config"])
        self.traffic = traffic or spec.traffic(self.cell["traffic"])
        if (self.traffic["loop"], self.traffic["in_flight"]) != ("closed", 1):
            raise ValueError("the harness runs a closed loop with one batch "
                             "in flight only")
        e2e, layer = spec.cell_metrics(self.bench, name)
        self.e2e = [(m, spec.module("metrics", m["name"])) for m in e2e]
        self.layer = [(m, spec.module("metrics", m["name"])) for m in layer]
        self.reference = spec.module("reference", self.config["name"])
        self.driver_mod = spec.module("drivers", self.config["entry"])
        self.client_mod = spec.module("clients", self.config["client"])


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell: Cell, seed: int):
    """The seed's data, its pool of batches and its sampling stream."""
    rngs = gen.streams(seed)
    data = gen.model_data(cell.config, rngs["data"])
    pool = gen.pool(cell.traffic, cell.config, data, rngs["pool"])
    return data, pool, rngs["sample"]


def serve_batch(driver, client, inputs, label=None, timing=None,
                events=None):
    """One batch: the client's inputs to the device, the entry call, the
    read-back, the served answer.  ``label(name)`` marks host spans;
    ``timing`` collects (host seconds, (start, end) CUDA events or None)
    of the entry call, ``events()`` making the pair.  Returns the
    read-back."""
    mark = label or (lambda name: contextlib.nullcontext())
    with mark("client"):
        params = client.send(inputs)
    with mark("entry"):
        if timing is not None:
            ev = events() if events else None
            if ev:
                ev[0].record()
            t = time.perf_counter()
        out = driver(params)
        if timing is not None:
            host = time.perf_counter() - t
            if ev:
                ev[1].record()
            timing.append((host, ev))
    with mark("readback"):
        raw = out.cpu().numpy()
        client.receive(raw)
    return raw


def window(driver, client, pool, seconds, reservoir, timing=None,
           events=None) -> tuple[list, float]:
    """The measured window: batches cycle through ``pool`` until one
    completes ``seconds`` after the start; each is offered to
    ``reservoir`` as (pool index, read-back).  Returns every batch's
    latency and the seconds from the start to the last answer."""
    latencies = []
    start = last = time.perf_counter()
    while last - start < seconds:
        idx = len(latencies) % len(pool)
        t0 = time.perf_counter()
        raw = serve_batch(driver, client, pool[idx], timing=timing,
                          events=events)
        last = time.perf_counter()
        latencies.append(last - t0)
        reservoir.offer((idx, raw))
    return latencies, last - start


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
        torch, process_start: float, log=print) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    run_ = Run(cell.config, cell.traffic["batch"])
    data, pool, sample_rng = prepare(cell, seed)

    t = time.perf_counter()
    driver = cell.driver_mod.Driver(cell.config, device)
    run_.spans["translate_s"] = time.perf_counter() - t
    client = cell.client_mod.Client(cell.config, data, device)

    arms = [m.arm(run_) for _, m in cell.layer
            if trace_on and hasattr(m, "arm")]
    with contextlib.ExitStack() as stack:
        for a in arms:
            stack.enter_context(a)
        t = time.perf_counter()
        serve_batch(driver, client, pool[0])
        _sync(torch, device)
        run_.spans["capture_s"] = time.perf_counter() - t
    for j in range(cell.traffic["warmup"]):
        serve_batch(driver, client, pool[(j + 1) % len(pool)])
    gc.collect()
    gc.freeze()

    reservoir = check.Reservoir(cell.traffic["check_batches"], sample_rng)
    timing = [] if trace_on else None
    events = None
    if trace_on and device.type == "cuda":
        def events():
            return (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
    start = time.perf_counter()
    run_.setup_s = start - process_start
    run_.latencies, run_.window_s = window(
        driver, client, pool, seconds, reservoir, timing, events)
    n = len(run_.latencies)
    gc.unfreeze()
    log(window_line(run_.latencies, run_.window_s))

    if trace_on:
        _sync(torch, device)
        run_.entry_host_s = [h for h, _ in timing]
        run_.device_ms = [ev[0].elapsed_time(ev[1]) for _, ev in timing
                          if ev is not None]
        if device.type == "cuda":
            t = time.perf_counter()
            run_.slice = profile_slice(driver, client, pool,
                                       cell.traffic["trace_batches"], torch)
            for p in run_.slice.problems:
                log(f"trace: {p}")
            log(f"trace: the slice took {time.perf_counter() - t:.3f} s, "
                "profiler and reading")

    device_info = describe(torch, device)
    del driver, client
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    correct, table = check.judge(cell.reference, cell.config, data,
                                 reservoir.items, pool)
    log(f"check: {time.perf_counter() - t:.3f} s")
    metrics = {}
    for m, mod in (cell.layer if trace_on else cell.e2e):
        v = mod.read(run_)
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace_on and run_.slice is not None:
        device_info["busy_s"] = run_.slice.busy_s()
        device_info["window_s"] = run_.slice.window_s
    out = {"correct": correct, "attempted": n, "failed": 0,
           "metrics": metrics, "device": device_info}
    if trace_on and run_.slice is not None:
        out["breakdown"] = trace.breakdown(run_.slice)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in table.items()}
    return out


def profile_slice(driver, client, pool, n_keep: int, torch) -> trace.Slice:
    """``n_keep`` batches (and the one dropped before them) under the
    profiler, each with its host spans marked."""
    k = [0]

    def step(label):
        serve_batch(driver, client, pool[k[0] % len(pool)], label)
        k[0] += 1

    return trace.profile(step, n_keep, torch)


def window_line(latencies, window_s: float) -> str:
    """What the window held, for standard error: a run whose tail reads
    far off shows there whether a few batches or a stretch were slow."""
    ordered = sorted(latencies)
    med = ordered[len(ordered) // 2]
    slow = sum(t > 1.5 * med for t in ordered)
    return (f"window: {len(ordered)} batches in {window_s:.3f} s; batch ms "
            f"median {1e3 * med:.4f}, max {1e3 * ordered[-1]:.4f}; "
            f"{slow} over 1.5 x the median")


def describe(torch, device) -> dict:
    """The device the run used: platform, name, count, peak memory."""
    from .guard import power_limit

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            "power_limit": power_limit()}


def fmt_checks(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} against the limit {c['limit']!r}"
            + ("" if c["value"] <= c["limit"] else "  FAILS")
            for name, c in checks.items()]
