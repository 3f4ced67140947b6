"""The configuration ``two_populations_2000`` at a size a CPU test run
holds (the same generator at size 30, its own limit): the reference
computes in the dtype it is given; a run is correct, and comes out not
correct with the timed path broken underneath (a stale answer, half the
batch, one mass altered by 1e-6); the control fails the limit.  And the
reader of ``k1_walk_roofline_pct`` on a synthetic recording and slice:
it reads where the captured walk's products are the listed ones, and
nothing where they are not or where no count has the phase ``capture``."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import check, peaks, program_trace, spec, trace
from genfer_tpu_torch import trace as port_trace
from genfer_tpu_torch.compile import CompiledProgram
from genfer_tpu_torch.tools.generators import two_populations_serving

WORKLOAD = "twopop.sweep128"
SIZE, LIMIT = 30, 30
SEED = 2**31 + 11


def _config():
    cfg = spec.config(spec.benchmark(), "two_populations_2000")
    source, model = two_populations_serving(SIZE)
    return dict(cfg, program=source, model=model, limit=LIMIT)


def _cell(batch=8):
    bench = spec.benchmark()
    c = spec.cell(bench, WORKLOAD)
    traffic = dict(spec.traffic(c["traffic"]), batch=batch, pool=3,
                   warmup=1, check_batches=3)
    return cells.Cell(WORKLOAD, bench, _config(), traffic)


def _run(trace_on=False):
    return cells.run(_cell(), SEED, 0.3, trace_on, torch.device("cpu"),
                     torch, time.perf_counter(), log=lambda msg: None)


def test_the_reference_computes_in_the_dtype_it_is_given():
    cfg = _config()
    ref = spec.module("reference", "two_populations_2000")
    params = np.random.default_rng(5).uniform(0.1, 0.4, (6, 3))
    for np_dt, dt in ((np.float64, torch.float64),
                      (np.float32, torch.float32)):
        got = ref.reference({"params": params}, {}, cfg, np_dt)
        want = ref.masses(torch.from_numpy(params), cfg["model"], LIMIT,
                          dtype=dt)
        assert got.dtype == np_dt and got.shape == (6, LIMIT)
        assert np.array_equal(got, want.numpy())


def test_the_program_passes_and_the_control_fails():
    c = _cell(batch=16)
    data, pool, _ = cells.prepare(c, SEED)
    drv = c.driver_mod.Driver(c.config, torch.device("cpu"))
    client = c.client_mod.Client(c.config, data, torch.device("cpu"))
    samples = [(i, drv(client.send(b)).numpy()) for i, b in enumerate(pool)]
    ok, table = check.judge(c.reference, c.config, data, samples, pool)
    ctl = check.control(c.reference, c.config, data, samples, pool)
    assert ok
    value, limit = table["rel_err"]
    assert value < 1e-13 < limit < ctl["rel_err"] / 100


@pytest.mark.parametrize("trace_on,metrics", [
    (False, {"inferences_per_s", "batch_p95_ms", "setup_s"}),
    # on the CPU K1's roofline has nothing to read
    (True, set())])
def test_unbroken_run_is_correct(trace_on, metrics):
    out = _run(trace_on)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == metrics


def _stale(real):
    last = {}

    def probs_batch(self, params, normalized=False):
        out = real(self, params, normalized)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return probs_batch


def _half(real):
    def probs_batch(self, params, normalized=False):
        n = params.shape[0]
        half = real(self, params[: n // 2], normalized)
        return torch.cat([half, half[: n - n // 2]])

    return probs_batch


def _altered(real):
    """The first row's largest mass times 1 + 1e-6 (the masses far down
    the tail lie below any gap the check could see)."""
    def probs_batch(self, params, normalized=False):
        out = real(self, params, normalized).clone()
        out[0, out[0].argmax()] *= 1 + 1e-6
        return out

    return probs_batch


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_broken_entry_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(CompiledProgram, "probs_batch",
                        fault(CompiledProgram.probs_batch))
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["rel_err"]["value"] > out["checks"]["rel_err"][
        "limit"]


# ----------------------------------------------------------------------
# the reader of k1_walk_roofline_pct
# ----------------------------------------------------------------------

K1_NAME = "void conv2d_small_f64_kernel(double const*)"


def _listed(config_name):
    return spec.config(spec.benchmark(), config_name)["k1"]["products"]


def _recording(products, phases=("warmup", "capture"), drop=0):
    """What the tracer counts while the first call walks ``products`` once
    a phase; ``drop`` products left out of the captured walk."""
    rec = port_trace.Recording()
    for phase in phases:
        walk = products[: len(products) - drop] if phase == "capture" \
            else products
        for p in walk:
            attrs = {"body": "small", "a": tuple(p["a"]),
                     "b": tuple(p["b"]), "out": tuple(p["out"])}
            if phase is not None:
                attrs["phase"] = phase
            key = ("k1.products", tuple(sorted(attrs.items())))
            rec.counters[key] = rec.counters.get(key, 0) + 1
    return rec


def _slice(n_k1, n_batches=3, dur=2e-6):
    batches, ops = [], []
    for j in range(n_batches + 1):
        t = j * 0.1
        batches.append((t, t + 0.09))
        for i in range(n_k1[j] if isinstance(n_k1, list) else n_k1):
            s = t + 1e-5 * (i + 1)
            ops.append((K1_NAME, s, s + dur))
        ops.append(("elementwise", t + 0.08, t + 0.08 + 1e-6))
    return trace.build(batches, ops, [])


def _reader_run(config_name, batch, rec, sl):
    cfg = spec.config(spec.benchmark(), config_name)
    r = cells.Run(cfg, batch)
    r.counters[program_trace.KEY] = rec
    r.slice = sl
    return r


@pytest.mark.parametrize("config_name,batch", [
    ("two_populations_2000", 128), ("scam_example", 16384)])
def test_reader_reads_where_the_captured_products_are_listed(config_name,
                                                             batch):
    mod = spec.module("metrics", "k1_walk_roofline_pct")
    assert mod.arm is program_trace.arm
    products = mod.expanded(_listed(config_name))
    n = len(products)
    if config_name == "two_populations_2000":
        assert n == 1115 and len(_listed(config_name)) < n
    got = mod.read(_reader_run(config_name, batch, _recording(products),
                               _slice(n)))
    want = 100 * peaks.least_seconds(products, batch) / (n * 2e-6)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", ["one_missing", "no_phase", "no_capture",
                                  "lost_kernel", "no_tracer"])
def test_reader_reads_nothing_otherwise(case):
    mod = spec.module("metrics", "k1_walk_roofline_pct")
    products = mod.expanded(_listed("two_populations_2000"))
    n = len(products)
    rec, sl = _recording(products), _slice(n)
    if case == "one_missing":
        rec = _recording(products, drop=1)
    elif case == "no_phase":  # a program whose counts have no phase
        rec = _recording(products, phases=(None,))
    elif case == "no_capture":  # the warm-up walk alone
        rec = _recording(products, phases=("warmup",))
    elif case == "lost_kernel":
        sl = _slice([n, n, n - 1, n])
        sl.complete = True
    else:
        rec = None
    assert mod.read(_reader_run("two_populations_2000", 128, rec, sl)) \
        is None
