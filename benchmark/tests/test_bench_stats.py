"""The window takes every batch it completes, and the rate and the tail
are worked out over all of them."""

import numpy as np
import pytest

from benchmark.harness import cell as cells
from benchmark.harness import check, spec
from benchmark.harness import traffic as gen


def _run(latencies, window_s, batch):
    r = cells.Run({}, batch)
    r.latencies, r.window_s = latencies, window_s
    return r


def test_rate_takes_every_batch():
    read = spec.module("metrics", "inferences_per_s").read
    lat = [0.001] * 999 + [0.5]  # one slow batch still counts
    assert read(_run(lat, 1.499, 4096)) == pytest.approx(1000 * 4096 / 1.499)


def test_p95_is_the_tail_of_all_batches():
    read = spec.module("metrics", "batch_p95_ms").read
    lat = [0.001 * (i + 1) for i in range(200)]  # 1..200 ms, shuffled
    rng = np.random.default_rng(0)
    rng.shuffle(lat)
    assert read(_run(lat, 1.0, 1)) == pytest.approx(190.0)
    # nearest rank: 20 batches -> the 19th
    assert read(_run([0.001 * (i + 1) for i in range(20)], 1.0, 1)) == \
        pytest.approx(19.0)


def test_outside_entry_share_takes_every_batch():
    read = spec.module("metrics", "outside_entry_pct").read
    r = _run([0.004, 0.002, 0.002], 0.01, 1)
    r.device_ms = [3.0, 1.5, 1.5]  # 6 of the window's 8 ms in the entry
    assert read(r) == pytest.approx(25.0)
    r.device_ms = [3.0, 1.5]  # a batch without its events: nothing read
    assert read(r) is None
    assert read(_run([0.004], 0.01, 1)) is None


class _Driver:
    def __init__(self):
        self.calls = 0

    def __call__(self, params):
        import torch

        self.calls += 1
        return torch.as_tensor(params)


class _Client:
    def send(self, inputs):
        return inputs["params"]

    def receive(self, raw):
        return raw


def test_window_counts_every_completed_batch():
    drv = _Driver()
    pool = [{"params": np.full((2, 1), float(i))} for i in range(3)]
    res = check.Reservoir(4, np.random.default_rng(1))
    lat, window_s = cells.window(drv, _Client(), pool, 0.05, res)
    assert len(lat) == drv.calls == res.seen
    assert window_s >= 0.05 and sum(lat) <= window_s
    # the pool is cycled in order, and the sample keeps (index, answer)
    for idx, raw in res.items:
        assert np.all(raw == idx)


def test_reservoir_is_uniform_and_seeded():
    def draw(seed):
        r = check.Reservoir(5, np.random.default_rng(seed))
        for i in range(100):
            r.offer(i)
        return sorted(r.items)

    assert draw(3) == draw(3) and draw(3) != draw(4)
    hits = np.zeros(100)
    for seed in range(400):
        for i in draw(seed):
            hits[i] += 1
    assert hits.min() > 0 and hits[:50].sum() == pytest.approx(
        hits[50:].sum(), rel=0.15)


def test_seed_gives_same_pool_and_sizes():
    bench = spec.benchmark()
    cfg = spec.config(bench, "scam_example")
    tr = dict(spec.traffic("grid4096"), pool=2)

    def pool(seed):
        s = gen.streams(seed)
        return gen.pool(tr, cfg, gen.model_data(cfg, s["data"]), s["pool"])

    big = 2**31 + 12345
    a, b, c = pool(big), pool(big), pool(big + 1)
    assert all(np.array_equal(x["params"], y["params"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["params"], c[0]["params"])
    assert a[0]["params"].shape == c[0]["params"].shape == (4096, 1)
    assert 0.01 <= a[0]["params"].min() and a[0]["params"].max() <= 0.99
    pool(-5)  # any whole number is a seed


def test_images_follow_theta_and_priors():
    bench = spec.benchmark()
    cfg = spec.config(bench, "digit_recognition")
    s = gen.streams(9)
    data = gen.model_data(cfg, s["data"])
    assert data["theta"].shape == (10, 784)
    b = gen.batch(dict(spec.traffic("images1024"), batch=4000), cfg, data,
                  s["pool"])
    assert b["images"].shape == (4000, 784)
    assert set(np.unique(b["images"])) <= {0.0, 1.0}
    share = np.bincount(b["classes"], minlength=10) / 4000
    assert np.allclose(share, cfg["model"]["priors"], atol=0.02)
    ink = b["images"].mean(0) > 0.03
    assert 0.15 < ink.mean() < 0.35
