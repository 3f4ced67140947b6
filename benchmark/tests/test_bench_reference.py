"""Each plain reference agrees with the port's CPU walk at a small size,
and its control (the reference in float32 in the program's place) fails
the configuration's limit, while the program's readings lie far under
it."""

import numpy as np
import pytest
import torch

import bench_small
from benchmark.harness import check, spec
from benchmark.harness import traffic as gen

CASES = [("scam.grid4096", 64), ("digit.b1024", 16)]


def _readings(workload, batch, seed):
    c = bench_small.cell(workload, batch)
    data, pool, _ = bench_small.cells.prepare(c, seed)
    drv = c.driver_mod.Driver(c.config, torch.device("cpu"))
    client = c.client_mod.Client(c.config, data, torch.device("cpu"))
    samples = [(i, drv(client.send(b)).numpy()) for i, b in enumerate(pool)]
    ok, table = check.judge(c.reference, c.config, data, samples, pool)
    ctl = check.control(c.reference, c.config, data, samples, pool)
    return ok, table, ctl


@pytest.mark.parametrize("workload,batch", CASES)
def test_reference_agrees_with_the_port(workload, batch):
    ok, table, ctl = _readings(workload, batch, 2**31 + 99)
    assert ok
    for name, (value, limit) in table.items():
        # the program's f64 walk is within a few hundred ulps
        assert value < 1e-12 < limit
        # the float32 control fails the limit by orders of magnitude
        assert ctl[name] > 100 * limit


def test_scam_reference_closed_form():
    cfg = bench_small.config("scam_example")
    ref = spec.module("reference", "scam_example")
    p = np.array([[0.2], [0.5]])
    got = ref.reference({"params": p}, {}, cfg, np.float64)
    k = 7
    pois = np.exp(-10) * 10**k / 5040
    assert got[0, k] == pytest.approx(pois * k * 0.2 * 0.8**6, rel=1e-14)
    assert got[1, 0] == 0.0 and got.shape == (2, 26)


def test_digit_reference_is_the_log_of_the_product():
    cfg = bench_small.config("digit_recognition")
    ref = spec.module("reference", "digit_recognition")
    s = gen.streams(4)
    data = gen.model_data(cfg, s["data"])
    b = gen.batch(dict(spec.traffic("images1024"), batch=3), cfg, data,
                  s["pool"])
    x, th = b["images"][:, None, :], data["theta"][None]
    direct = np.asarray(cfg["model"]["priors"]) * np.prod(
        x * th + (1 - x) * (1 - th), axis=2)
    got = ref.reference(b, data, cfg, np.float64)
    assert np.allclose(got, np.log(direct), rtol=0, atol=1e-12)
    # a zero or a NaN mass fails
    bad = np.exp(got)
    bad[0, 0] = 0.0
    assert ref.numbers(ref.served(bad), got)["log_rel_err"] == np.inf
    bad[0, 0] = np.nan
    assert ref.numbers(ref.served(bad), got)["log_rel_err"] == np.inf


def test_a_wrong_shape_fails():
    cfg = bench_small.config("scam_example")
    ref = spec.module("reference", "scam_example")
    pool = [{"params": np.full((4, 1), 0.3)}]
    want = ref.reference(pool[0], {}, cfg, np.float64)
    ok, table = check.judge(ref, cfg, {}, [(0, want[:, :25])], pool)
    assert not ok and table["rel_err"][0] == np.inf
    ok, _ = check.judge(ref, cfg, {}, [(0, want)], pool)
    assert ok
    ok, _ = check.judge(ref, cfg, {}, [], pool)  # nothing compared
    assert not ok
