"""The port's ``--profile`` and ``--debug-nans`` on the CPU against
genfer_tpu's.

``--profile DIR`` writes one Chrome trace (``cli.TRACE_FILE``) of the
inference from ``torch.profiler``.  ``--debug-nans`` checks the result of
each op of the device backends (``enable_nan_check``) where genfer_tpu
turns on ``jax_debug_nans``: a NaN an op produces raises
``FloatingPointError`` in both packages, and with the check off both give
NaN at the same positions.  Through both CLIs, ``--debug-nans --backend
jax`` either raises in both or prints the same values at the reference's
is_close, on the examples and on ``test_differential``'s random programs;
``--debug-nans --backend numpy`` prints genfer_tpu's bytes.  genfer_tpu's
flag sets a global of JAX, which each test restores.
"""

import contextlib
import io
import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import genfer_tpu.cli as jcli
from genfer_tpu.lang.parser import parse_program as jparse
from genfer_tpu.taylor import backend as J
from genfer_tpu_torch import cli
from genfer_tpu_torch.lang.parser import parse_program as tparse
from genfer_tpu_torch.printed import (
    disagreements,
    read_endpoints,
    read_masses,
    read_results,
)
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.taylor.host import IvArr
from test_differential import random_program

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.sgcl"))
INF = float("inf")


@pytest.fixture
def debug_nans():
    """``jax_debug_nans`` on for the test, off again after it."""
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


def _args(*flags):
    return cli.build_arg_parser().parse_args(["model.sgcl", "--no-timing",
                                              *flags])


def _printed(fn, *args, **kwargs) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


# ----------------------------------------------------------- --profile

@pytest.mark.parametrize("example", EXAMPLES, ids=lambda p: p.name)
def test_profile_writes_one_chrome_trace(example, tmp_path):
    """``--profile DIR`` (DIR absent, nested) on the CPU: DIR holds one
    file, ``cli.TRACE_FILE``, a Chrome trace that ``json.load`` reads,
    with the inference's torch ops among its events; the run prints what
    it prints without the flag."""
    out_dir = tmp_path / "traces" / "run"
    text = example.read_text()
    got = _printed(cli.run, tparse(text),
                   _args("--backend", "jax", "--profile", str(out_dir)),
                   device="cpu")
    assert [p.name for p in out_dir.iterdir()] == [cli.TRACE_FILE]
    with open(out_dir / cli.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert got == _printed(cli.run, tparse(text), _args("--backend", "jax"),
                           device="cpu")


def test_profile_writes_the_trace_of_a_run_that_raises(tmp_path):
    """The trace is written also where the inference raises (as
    ``jax.profiler.trace`` writes on leaving its block)."""
    with pytest.raises(ZeroDivisionError):
        cli._profiled(tmp_path, "cpu", lambda: torch.ones(3).sum() // 0
                      + 1 // 0)
    assert (tmp_path / cli.TRACE_FILE).exists()


# ------------------------------------------------- one NaN-producing op

def _f64_cases():
    """(op, arguments as nested lists): each op's result holds a NaN."""
    return [
        ("div", [[0.0, 1.0], [2.0, 0.0]], [[0.0, 1.0], [1.0, 0.0]]),
        ("mul", [[INF, 1.0]], [[0.0, 2.0]]),
        ("log_el", [[-1.0, 1.0]]),
        ("conv_trunc", [[INF, 0.0], [0.0, 0.0]], [[0.0, 1.0], [1.0, 1.0]],
         (2, 2)),
        ("poly_div", [[1.0, 2.0, 3.0]], [[0.0, 0.0, 1.0]], (1, 3)),
    ]


@pytest.mark.parametrize("case", _f64_cases(), ids=lambda c: c[0])
def test_a_nan_op_raises_in_both_packages(case, debug_nans):
    op, *operands = case
    arrays = [x for x in operands if isinstance(x, list)]
    rest = [x for x in operands if not isinstance(x, list)]
    jb = J.JaxF64Backend()
    tb = T.TorchF64Backend(device="cpu")
    tb.enable_nan_check()
    with pytest.raises(FloatingPointError):
        getattr(jb, op)(*[jb.from_nested(x) for x in arrays], *rest)
    with pytest.raises(FloatingPointError, match=f"encountered in {op}"):
        getattr(tb, op)(*[tb.from_nested(x) for x in arrays], *rest)


@pytest.mark.parametrize("case", _f64_cases(), ids=lambda c: c[0])
def test_without_the_check_both_give_nan_at_the_same_positions(case):
    op, *operands = case
    arrays = [x for x in operands if isinstance(x, list)]
    rest = [x for x in operands if not isinstance(x, list)]
    jb = J.JaxF64Backend()
    tb = T.TorchF64Backend(device="cpu")
    want = np.asarray(getattr(jb, op)(*[jb.from_nested(x) for x in arrays],
                                      *rest))
    got = getattr(tb, op)(*[tb.from_nested(x) for x in arrays], *rest)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


def test_interval_op_raises_in_both_packages(debug_nans):
    """An interval sum inf + -inf: ``JaxIntervalBackend`` under
    ``jax_debug_nans`` and ``TorchIntervalBackend`` with the check."""
    data = [[INF, INF]], [[-INF, -INF]]
    jb = J.JaxIntervalBackend()
    with pytest.raises(FloatingPointError):
        jb.add(*[J.IvArr(jax.numpy.asarray(x).reshape(2, 1)) for x in data])
    tb = T.TorchIntervalBackend(device="cpu")
    tb.enable_nan_check()
    with pytest.raises(FloatingPointError, match="encountered in add"):
        tb.add(*[IvArr(torch.tensor(x, dtype=torch.float64).reshape(2, 1))
                 for x in data])


def test_hybrid_checks_its_device_ops_only(debug_nans, monkeypatch):
    """``HybridBackend`` checks the products it sends to the device and not
    its host ops, in both packages: the same NaN-producing product raises
    offloaded and passes on the host."""
    a = np.array([[INF, 0.0], [0.0, 0.0]])
    b = np.array([[0.0, 1.0], [1.0, 1.0]])
    jb = J.HybridBackend()
    tb = T.HybridBackend(device="cpu")
    tb.enable_nan_check()
    for backend in (jb, tb):
        assert np.isnan(backend.conv_trunc(a, b, (2, 2))).any()
    for cls in (J.HybridBackend, T.HybridBackend):
        monkeypatch.setattr(cls, "CONV_OFFLOAD_FLOPS", 0)
    with pytest.raises(FloatingPointError):
        jb.conv_trunc(a, b, (2, 2))
    with pytest.raises(FloatingPointError, match="encountered in conv_trunc"):
        tb.conv_trunc(a, b, (2, 2))
    assert tb.device_ops == 1


def test_the_check_is_off_by_default():
    """Off, a device backend is its class's methods and nothing else: no
    wrapper, so no reduction, launch or synchronize of the check."""
    for backend in (T.TorchF64Backend(device="cpu"),
                    T.TorchIntervalBackend(device="cpu")):
        assert not set(vars(backend)) & set(T.NAN_CHECKED_OPS)
        backend.enable_nan_check()
        assert set(T.NAN_CHECKED_OPS) <= set(vars(backend))
    assert not T.HybridBackend(device="cpu").check_nans


# ------------------------------------------------------ through the CLIs

def _outcome(fn, program, args, **kwargs):
    """What a run printed, or the type of what it raised."""
    try:
        return _printed(fn, program, args, **kwargs), None
    except Exception as e:  # compared between the packages
        return None, type(e)


SOURCES = {p.name: p.read_text() for p in EXAMPLES}
SOURCES.update({f"random_program({seed})":
                random_program(random.Random(seed))
                for seed in (*range(8), 31)})


@pytest.mark.parametrize("source", list(SOURCES))
def test_debug_nans_backend_jax_through_both_clis(source):
    """Both raise the same error, or both print the same values at
    is_close (random_program(31) raises "is not a probability" in both)."""
    text = SOURCES[source]
    args = _args("--backend", "jax", "--debug-nans")
    port, port_err = _outcome(cli.run, tparse(text), args, device="cpu")
    try:
        ref, ref_err = _outcome(jcli.run, jparse(text), args)
    finally:
        jax.config.update("jax_debug_nans", False)
    assert port_err is ref_err, (port_err, ref_err)
    if ref_err is None:
        want = {**read_results(ref), **read_endpoints(ref)}
        got = {**read_results(port), **read_endpoints(port)}
        assert not disagreements(got, want)
        assert not disagreements(read_masses(port), read_masses(ref),
                                 want.get("Z"))


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda p: p.name)
def test_debug_nans_backend_numpy_prints_genfer_tpus_bytes(example):
    text = example.read_text()
    args = _args("--backend", "numpy", "--debug-nans")
    port = _printed(cli.run, tparse(text), args, device="cpu")
    try:
        ref = _printed(jcli.run, jparse(text), args)
    finally:
        jax.config.update("jax_debug_nans", False)
    assert port == ref
