"""K1's yardstick: the bytes and multiply-adds of the 26 listed products
of the scam walk, the least time, and the reader's checks."""

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import peaks, spec, trace

B = 4096


@pytest.fixture(scope="module")
def products():
    return spec.config(spec.benchmark(), "scam_example")["k1"]["products"]


def test_counts_of_one_product():
    p = {"a": [2, 2], "b": [2, 2], "out": [3, 3], "batched": ["a", "b"]}
    assert peaks.pair_macs([2, 2], [2, 2], [3, 3]) == 16
    assert peaks.product_work(p, 10) == (160, 8 * 10 * (4 + 4 + 9))
    shared = dict(p, batched=["a"])  # b read once for the batch
    assert peaks.product_work(shared, 10) == (160, 8 * (10 * 4 + 4 + 10 * 9))
    big = {"a": [27, 27], "b": [2, 2], "out": [27, 28], "batched": ["a", "b"]}
    assert peaks.pair_macs([27, 27], [2, 2], [27, 28]) == 53 * 54
    assert peaks.product_work(big, B) == (B * 2862, 8 * B * (729 + 4 + 756))


def test_walk_least_time(products):
    words = sum((n * n + 4 + (n + 1) ** 2) for n in range(2, 27))
    words += 729 + 4 + 756
    macs = sum(peaks.product_work(p, B)[0] for p in products)
    # every product is bound by its bytes
    assert macs / peaks.F64_MMA_PER_S < 8 * B * words / peaks.BYTES_PER_S
    assert peaks.least_seconds(products, B) == pytest.approx(
        8 * B * words / peaks.BYTES_PER_S)
    assert peaks.least_seconds(products, B) == pytest.approx(144.0e-6,
                                                             rel=0.02)


def _slice(k1_per_batch, other=3, n=3, dur=2e-6):
    batches, ops = [], []
    for j in range(n + 1):
        t = j * 1e-3
        batches.append((t, t + 0.9e-3))
        for i in range(k1_per_batch[j] if j < len(k1_per_batch) else 26):
            ops.append(("conv2d_small_f64_kernel(double const*)",
                        t + 1e-5 * (i + 1), t + 1e-5 * (i + 1) + dur))
        for i in range(other):
            ops.append(("elementwise", t + 5e-4 + 1e-5 * i,
                        t + 5e-4 + 1e-5 * i + 1e-6))
    return trace.build(batches, ops, [])


def _run(products, sl, seen):
    cfg = spec.config(spec.benchmark(), "scam_example")
    r = cells.Run(cfg, B)
    r.slice = sl
    r.counters["k1_products"] = seen
    return r


def _keys(products):
    return [(tuple(p["a"]), tuple(p["b"]), tuple(p["out"]))
            for p in products]


def test_reader(products):
    read = spec.module("metrics", "k1_roofline_pct").read
    seen = _keys(products) * 2  # the warm-up walk and the capture
    ok = _run(products, _slice([26] * 4), seen)
    want = 100 * peaks.least_seconds(products, B) / (26 * 2e-6)
    assert read(ok) == pytest.approx(want)
    # a batch that lost a K1 event: nothing is read
    assert read(_run(products, _slice([26, 26, 25, 26], other=4), seen)) \
        is None
    # other products than the listed ones: nothing is read
    assert read(_run(products, _slice([26] * 4), seen[:-1])) is None
    assert read(_run(products, _slice([26] * 4), [])) is None


def test_slice_reduction():
    sl = _slice([26] * 4)
    assert sl.complete and len(sl.batches) == 3  # the first is dropped
    assert len(sl.kernels(0)) == 29
    # 26 K1 kernels of 2 us at 10 us steps and 3 of 1 us: 55 us busy a
    # batch
    assert sl.busy_s() == pytest.approx(3 * (26 * 2e-6 + 3e-6))
    assert sl.window_s == pytest.approx(2.9e-3)
    bd = trace.breakdown(sl)
    assert bd["device_ops"][0][0].startswith("conv2d_small_f64_kernel")
    assert bd["device_ops"][0][1] == pytest.approx(26 * 2e-6)
    assert bd["idle_gaps"][0][0] == "between"
    assert not _slice([26, 26, 25, 26], other=4).complete


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert trace.union_length(iv, 0, 10) == 4
    assert trace.union_length(iv, 2.5, 5.5) == 1.0
    assert trace.gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert trace.gaps([], 1, 2) == [(1, 2)]


def test_slice_from_the_profilers_raw_events():
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with record_function("bench.batch"):
                with record_function("bench.client"):
                    torch.ones(8).sum()
                with record_function("bench.entry"):
                    time.sleep(0.002)
    sl = trace.from_profiler(prof)
    assert len(sl.batches) == 3  # the first dropped
    assert 0.006 <= sl.window_s < 1.0
    assert [name for name, _, _ in sl.spans].count("entry") == 4
    # no kernels on the CPU: the slice is not complete, and says why
    assert not sl.complete and sl.problems
