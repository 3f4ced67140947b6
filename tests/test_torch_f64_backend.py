"""The port's f64 device path on the CPU against genfer_tpu's: the torch
array namespace (``taylor/xp.py``) against numpy, ``TorchF64Backend``
against ``JaxF64Backend`` and ``TorchIntervalBackend`` against
``JaxIntervalBackend`` (``device="cpu"``, JAX on the CPU), ``--backend
jax`` through both CLIs, random programs under the port's ``--backend
jax`` against their exact enumeration oracle, and the ``entry()`` twin
against ``__graft_entry__.entry()``.

Tolerances: rtol 1e-12 on the backends' kernels (the same einsums and
triangular solves in other summation orders), with an absolute floor of
1e-12 of the largest |value| for the Newton-lifted n-axis ops, whose
cancellations leave entries near zero; the reference's is_close (rel 1e-9
/ abs 1e-8) on printed results.  Interval endpoints are compared bit for
bit where no subnormal number arises (XLA on the CPU flushes subnormals
to zero, torch and numpy keep them: ``test_interval_subnormals``), and to
one ulp after ``exp`` and ``log``, whose libraries differ.
"""

import contextlib
import io
import math
import random
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
import genfer_tpu.cli as jcli
import genfer_tpu.tools.generators as jgen
from chip_smoke import read_intervals, read_results
from genfer_tpu.lang.parser import parse_program as jparse
from genfer_tpu.taylor import backend as J
from genfer_tpu_torch import cli, entry
from genfer_tpu_torch.lang.parser import parse_program as tparse
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.taylor.host import IvArr
from genfer_tpu_torch.taylor.xp import TorchNamespace
from test_differential import brute_force, random_program
from test_torch_backend import CONV_SHAPES

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.sgcl"))


def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


@pytest.fixture(scope="module")
def tb():
    return T.TorchF64Backend(device="cpu")


@pytest.fixture(scope="module")
def jb():
    return J.JaxF64Backend()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------- namespace

def test_namespace_against_numpy():
    xp = TorchNamespace("cpu")
    x = _rand((3, 4, 5), 0)
    t = xp.asarray(x)
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    pads = [(1, 2), (0, 0), (3, 1)]
    np.testing.assert_array_equal(xp.pad(t, pads).numpy(), np.pad(x, pads))
    np.testing.assert_array_equal(xp.take(t, 2, axis=1).numpy(),
                                  np.take(x, 2, axis=1))
    np.testing.assert_array_equal(xp.take(t, np.int64(0), 2).numpy(),
                                  np.take(x, 0, axis=2))
    for axis in (0, 2):
        np.testing.assert_allclose(
            xp.sum(t, axis=axis, keepdims=True).numpy(),
            np.sum(x, axis=axis, keepdims=True), rtol=1e-15)
    assert xp.sum(t).shape == ()
    np.testing.assert_allclose(float(xp.sum(t)), x.sum(), rtol=1e-15)
    np.testing.assert_array_equal(
        xp.broadcast_to(xp.asarray(x[:1]), (3, 4, 5)).numpy(),
        np.broadcast_to(x[:1], (3, 4, 5)))
    np.testing.assert_array_equal(
        xp.asarray([[1.0, 2.0], [3.0, math.inf]]).numpy(),
        np.asarray([[1.0, 2.0], [3.0, math.inf]]))
    assert float(xp.asarray(2.5)) == 2.5 and xp.asarray(2.5).shape == ()
    np.testing.assert_array_equal(xp.nextafter(t, xp.inf).numpy(),
                                  np.nextafter(x, np.inf))
    np.testing.assert_array_equal(
        xp.concatenate([t, t], axis=1).numpy(), np.concatenate([x, x], 1))
    np.testing.assert_array_equal(xp.stack([t, t], axis=2).numpy(),
                                  np.stack([x, x], 2))
    ones = xp.ones((2, 1))
    assert ones.dtype == torch.float64 and float(ones.sum()) == 2.0


def test_read_only_factor_vectors_go_to_the_device():
    """``tensorpoly``'s cached factor vectors are read-only numpy arrays;
    ``scale_axis`` hands them to ``asarray``, which copies them."""
    f = np.arange(1.0, 6.0)
    f.setflags(write=False)
    b = T.TorchF64Backend(device="cpu")
    x = torch.ones((2, 5), dtype=torch.float64)
    np.testing.assert_array_equal(b.scale_axis(x, 1, f).numpy(),
                                  np.ones((2, 5)) * f)


# ------------------------------------------------------------ kernels

@pytest.mark.parametrize("sa,sb,out", CONV_SHAPES)
def test_conv_trunc(tb, jb, sa, sb, out):
    a, b = _rand(sa, 1), _rand(sb, 2)
    got = tb.conv_trunc(torch.from_numpy(a), torch.from_numpy(b), out)
    want = _np(jb.conv_trunc(a, b, out))
    assert isinstance(got, torch.Tensor) and got.shape == out
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# (op, x shape, y shape, out shape): 0 and 1 effective axes (the
# triangular solves), then the Newton-lifted cases of tests/test_newton_nd.py
KERNEL_CASES = [
    ("poly_div", (1, 1), (1, 1), (3, 4)),
    ("poly_div", (12, 3), (9, 1), (14, 3)),
    ("poly_div", (1, 20), (1, 6), (1, 16)),
    ("poly_exp", (1, 1), None, (2, 3)),
    ("poly_exp", (10,), None, (13,)),
    ("poly_exp", (1, 8, 1), None, (1, 11, 1)),
    ("poly_log", (1,), None, (4,)),
    ("poly_log", (10,), None, (13,)),
    ("poly_log", (1, 9), None, (1, 6)),
    ("poly_div", (6, 5), (6, 5), (6, 5)),
    ("poly_div", (5, 4, 6), (5, 4, 6), (5, 4, 6)),
    ("poly_div", (6, 8), (4, 3), (8, 8)),
    ("poly_div", (9, 1, 7), (9, 1, 7), (9, 1, 7)),
    ("poly_exp", (5, 6), None, (5, 6)),
    ("poly_exp", (4, 5, 3), None, (4, 5, 3)),
    ("poly_exp", (3, 2), None, (7, 6)),
    ("poly_log", (6, 7), None, (6, 7)),
    ("poly_log", (4, 4, 5), None, (4, 4, 5)),
    ("poly_log", (3, 3), None, (6, 5)),
]


@pytest.mark.parametrize("op,sx,sy,out", KERNEL_CASES)
def test_power_series_kernels(tb, jb, op, sx, sy, out):
    x = _rand(sx, 5, 0.3)
    x.reshape(-1)[0] = 1.25  # a positive leading coefficient (log)
    args = [x]
    if sy is not None:
        y = _rand(sy, 6, 0.3)
        y.reshape(-1)[0] = 1.5
        args.append(y)
    got = getattr(tb, op)(*(torch.from_numpy(v) for v in args), out)
    want = _np(getattr(jb, op)(*args, out))
    assert tuple(got.shape) == want.shape == out
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_tensors_stay_on_the_backends_device(tb):
    x = torch.from_numpy(_rand((6, 5), 7, 0.3))
    x[0, 0] = 1.0
    for out in (tb.poly_exp(x, (6, 5)), tb.poly_log(x, (6, 5)),
                tb.poly_div(x, x, (6, 5)), tb.conv_trunc(x, x, (6, 5))):
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


# ----------------------------------------------------------- interval

def _intervals(shape, seed):
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal(shape)
    hi = lo + rng.random(shape)
    flat_lo, flat_hi = lo.reshape(-1), hi.reshape(-1)
    # the masks' exact cases: [0, 0], [1, 1], [-1, -1]
    for i, v in zip(range(0, flat_lo.size, 7), [0.0, 1.0, -1.0] * 99):
        flat_lo[i] = flat_hi[i] = v
    return np.stack([lo, hi])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "neg",
                                "exp_el", "log_el", "conv_trunc"])
def test_interval_endpoints_equal_jax(op):
    jb = J.JaxIntervalBackend()
    tb = T.TorchIntervalBackend(device="cpu")
    x, y = _intervals((4, 5), 8), _intervals((4, 5), 9)
    if op == "log_el":
        x = np.abs(x)
        x = np.stack([x.min(axis=0), x.max(axis=0)])
    args = [x] if op in ("neg", "exp_el", "log_el") else [x, y]
    if op == "conv_trunc":
        args.append((6, 7))
    jargs = [J.IvArr(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [IvArr(torch.from_numpy(a)) if isinstance(a, np.ndarray) else a
             for a in args]
    want = np.asarray(getattr(jb, op)(*jargs).data)
    got = getattr(tb, op)(*targs).data.numpy()
    if op in ("exp_el", "log_el"):
        # torch's and XLA's exp and log differ by up to an ulp before the
        # one-ulp widening; the rest is IEEE arithmetic, equal to the bit
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


def test_interval_subnormals():
    """A recorded divergence of the reference, not of the port: on the
    CPU, XLA flushes subnormal numbers to zero, so genfer_tpu's
    ``JaxIntervalBackend`` returns a narrower interval than its numpy
    backend for a product of [-5e-324, 5e-324] ([-5e-324, 5e-324] op by
    op; [0, 0] in a jitted program, whose zero mask then fires), where
    torch, like numpy, widens the subnormal products to [-1e-323,
    1e-323]."""
    x = np.array([[0.4999999999999986], [0.5000000000000029]])
    y = np.array([[-5e-324], [5e-324]])
    tb = T.TorchIntervalBackend(device="cpu")
    got = tb.mul(IvArr(torch.from_numpy(x)), IvArr(torch.from_numpy(y)))
    host = J.NumpyIntervalBackend().mul(J.IvArr(x), J.IvArr(y))
    np.testing.assert_array_equal(got.data.numpy(), host.data)
    assert got.data.numpy().ravel().tolist() == [-1e-323, 1e-323]
    jax_iv = J.JaxIntervalBackend().mul(J.IvArr(x), J.IvArr(y))
    lo, hi = np.asarray(jax_iv.data).ravel().tolist()
    assert -1e-323 < lo <= 0.0 <= hi < 1e-323


# ---------------------------------------------------------------- CLI

def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kwargs)
    return buf.getvalue(), ret


def _close(got, want):
    """The reference's is_close; equal non-finite values agree."""
    if not (math.isfinite(got) and math.isfinite(want)):
        return got == want or (math.isnan(got) and math.isnan(want))
    return abs(got - want) <= 1e-8 + 1e-9 * abs(want)


GENERATED = {
    "two_populations": lambda g: g.generate_two_populations(None, 10,
                                                            seed=3),
    "population": lambda g: g.generate_population(None, 10, 2,
                                                  modified=True, seed=3),
}


@pytest.mark.parametrize("source", [p.name for p in EXAMPLES]
                         + list(GENERATED))
def test_cli_backend_jax_matches_genfer_tpu(source):
    text = (GENERATED[source](jgen) if source in GENERATED
            else (REPO / "examples" / source).read_text())
    args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--backend", "jax"])
    port, backend = _printed(cli.run, tparse(text), args, device="cpu")
    assert isinstance(backend, T.TorchF64Backend)
    ref, _ = _printed(jcli.run, jparse(text), args)
    # point results, and the intervals of a program with loops
    got, want = read_results(port), read_results(ref)
    got_iv, want_iv = read_intervals(port), read_intervals(ref)
    assert set(got) == set(want) and set(got_iv) == set(want_iv)
    assert "Z" in got or "Z" in got_iv
    for key, w in want.items():
        assert _close(got[key], w), (key, got[key], w)
    for key, (lo, hi) in want_iv.items():
        assert _close(got_iv[key][0], lo) and _close(got_iv[key][1], hi), key


def test_cli_bounds_backend_jax_matches_genfer_tpu():
    text = (REPO / "examples" / "beta_bernoulli.sgcl").read_text()
    args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--bounds", "--backend", "jax"])
    port, backend = _printed(cli.run, tparse(text), args, device="cpu")
    assert isinstance(backend, T.TorchIntervalBackend)
    ref, _ = _printed(jcli.run, jparse(text), args)
    got, want = read_intervals(port), read_intervals(ref)
    assert set(got) == set(want) and "Z" in got
    for key, (lo, hi) in want.items():
        assert _close(got[key][0], lo) and _close(got[key][1], hi), key
    # and the host f64 point values lie inside the port's intervals
    point, _ = _printed(cli.run, tparse(text), cli.build_arg_parser()
                        .parse_args(["m", "--no-timing", "--backend",
                                     "numpy"]))
    for key, v in read_results(point).items():
        if key in got:
            assert got[key][0] <= v <= got[key][1], key


@pytest.mark.parametrize("seed", range(4))
def test_random_program_vs_oracle(seed):
    src = random_program(random.Random(seed))
    oracle = brute_force(jparse(src))
    total = sum(oracle.values(), Fraction(0))
    limit = max(oracle) + 2 if oracle else 2
    args = cli.build_arg_parser().parse_args(
        ["m", "--no-timing", "--backend", "jax", "--limit", str(limit)])
    out, _ = _printed(cli.run, tparse(src), args, device="cpu")
    got = read_results(out)
    assert abs(got["Z"] - float(total)) < 1e-9, src
    if total == 0:
        return
    for k in range(limit):
        p = oracle.get(k, Fraction(0))
        if f"p({k})" in got:
            assert abs(got[f"p({k})"] - float(p)) < 1e-9, (k, src)
        else:
            assert abs(got[f"p({k}) / Z"] - float(p / total)) < 1e-9, (k,
                                                                      src)


def test_select_mode_builds_the_device_backends(monkeypatch):
    parse = cli.build_arg_parser().parse_args
    _, b, _ = cli.select_mode(parse(["m", "--backend", "jax"]),
                              device="cpu")
    assert isinstance(b, T.TorchF64Backend) and b.device.type == "cpu"
    _, b, _ = cli.select_mode(parse(["m", "--bounds", "--backend", "jax"]),
                              device="cpu")
    assert isinstance(b, T.TorchIntervalBackend)
    monkeypatch.setenv("GENFER_BACKEND", "jax")
    _, b, _ = cli.select_mode(parse(["m"]), device="cpu")
    assert isinstance(b, T.TorchF64Backend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.select_mode(parse(["m", "--backend", "jax"]))


# -------------------------------------------------------------- entry

def test_entry_twin_matches_graft_entry():
    fn, (a, b, y) = __graft_entry__.entry()
    want_q, want_t = (np.asarray(v) for v in fn(a, b, y))
    got_q, got_t = entry.forward(
        *(torch.from_numpy(np.array(v)) for v in (a, b, y)))
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=1e-12,
                               atol=1e-12 * np.abs(want_q).max())
    assert float(got_t) == pytest.approx(float(want_t), rel=1e-12)


def test_entry_twin_draws_its_own_operands():
    fn, (a, b, y) = entry.entry(device="cpu")
    assert a.shape == b.shape == (64, 64) and a.dtype == torch.float64
    assert not torch.equal(a, b) and 0 <= float(a.min()) < float(a.max()) < 1
    assert y[0] == 2.0 and bool((y[1:] == 1.0).all())
    again = entry.entry(device="cpu")[1]
    assert all(torch.equal(u, v) for u, v in zip((a, b, y), again))
    quot, total = fn(a, b, y)
    assert quot.shape == (64, 64) and torch.isfinite(quot).all()
    assert float(total) == pytest.approx(float(quot.sum()))
