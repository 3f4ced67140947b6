"""genfer_tpu_torch.taylor.backend against genfer_tpu.taylor.backend on the
CPU: the port's HybridBackend / PallasBackend (device="cpu") and the JAX
package's, with offload thresholds forced low by instance attribute so
that every op takes the device route.  JAX runs its Pallas kernel in
interpret mode.

Tolerances: rtol 1e-12 on the f64 routes (the same einsum / triangular
solves in another summation order); rtol 5e-5 / atol 1e-6 on the f32
route (the Pallas tests' bar against f64).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genfer_tpu.taylor import backend as J
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.taylor.host import ArrayF64Backend, NumpyF64Backend

CONV_SHAPES = [
    # 0, 1 and 3 effective axes
    ((1, 1), (1, 1), (1, 1)),
    ((7,), (5,), (9,)),
    ((1, 12), (1, 9), (1, 15)),
    ((4, 5, 3), (3, 4, 2), (5, 6, 4)),
    ((3, 1, 4, 2), (2, 1, 3, 2), (4, 1, 5, 3)),
    # 2 axes: tests/test_conv_block.py shapes
    ((60, 47), (52, 61), (55, 50)),
    ((33, 64), (64, 20), (96, 83)),
    ((64, 64), (64, 64), (64, 64)),
    ((64, 64), (64, 64), (127, 127)),
    ((40, 30), (20, 25), (59, 54)),
    ((16, 5), (3, 40), (10, 12)),
    ((1, 33), (9, 33), (9, 40)),
]

F32_SHAPES = [
    ((40, 30), (35, 25), (60, 50)),
    ((60, 47), (52, 61), (55, 50)),
    ((40, 1), (40, 38), (40, 38)),
    ((1, 38), (40, 38), (40, 38)),
    ((1, 40, 30), (1, 35, 25), (1, 60, 50)),
]


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape)


def _f64_pair():
    jb, tb = J.HybridBackend(), T.HybridBackend(device="cpu")
    for b in (jb, tb):
        b.CONV_OFFLOAD_FLOPS = 1
        b.SOLVE_OFFLOAD_LEN = 1
    return jb, tb


def _f32_pair():
    jb, tb = J.PallasBackend(), T.PallasBackend(device="cpu")
    for b in (jb, tb):
        b.PALLAS_OFFLOAD_FLOPS = 1
    return jb, tb


@pytest.mark.parametrize("sa,sb,out", CONV_SHAPES)
def test_conv_trunc_f64_route(sa, sb, out):
    """genfer_tpu's HybridBackend offloads JaxF64Backend's product on
    operands padded to multiples of 64 (a bound on XLA recompiles); the
    port compares with that product unpadded, since a padded 3-axis pair
    grid is too large for a unit test."""
    _, tb = _f64_pair()
    jb = J.JaxF64Backend()
    a, b = _rand(sa, 1), _rand(sb, 2)
    want = np.asarray(jb.conv_trunc(a, b, out))
    got = tb.conv_trunc(a, b, out)
    assert tb.device_ops == 1
    assert got.shape == want.shape == out and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("sa,sb,out", F32_SHAPES)
def test_conv_trunc_f32_route(sa, sb, out):
    jb, tb = _f32_pair()
    a, b = _rand(sa, 3), _rand(sb, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jb.conv_trunc(a, b, out))
    got = tb.conv_trunc(a, b, out)
    assert tb.device_ops == 1
    assert got.shape == out and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)
    host = J.NumpyF64Backend().conv_trunc(a, b, out)
    np.testing.assert_allclose(got, host, rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("op,shapes", [
    ("poly_div", ((12, 3), (9, 1), (14, 3))),
    ("poly_div", ((1, 20), (1, 6), (1, 16))),
    ("poly_exp", ((10,), None, (13,))),
    ("poly_exp", ((1, 8, 1), None, (1, 11, 1))),
    ("poly_log", ((10,), None, (13,))),
    ("poly_log", ((1, 9), None, (1, 6))),
])
def test_1d_solves_f64_route(op, shapes):
    jb, tb = _f64_pair()
    sx, sy, out = shapes
    x = _rand(sx, 5) * 0.3
    x.reshape(-1)[0] = 1.25  # positive leading coefficient (log)
    args = (x,) if sy is None else (x, _rand(sy, 6) + 0.5)
    want = np.asarray(getattr(jb, op)(*args, out))
    got = getattr(tb, op)(*args, out)
    assert tb.device_ops == 1
    assert got.shape == want.shape == out
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_newton_div_2d_f32_route():
    """A 2-axis division is Newton-lifted onto conv_trunc, so its
    products take the f32 route."""
    jb, tb = _f32_pair()
    x = _rand((30, 24), 7)
    y = _rand((20, 16), 8) * 0.1
    y[0, 0] = 1.0
    out = (30, 24)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jb.poly_div(x, y, out))
    got = tb.poly_div(x, y, out)
    assert tb.device_ops > 0
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)
    host = J.NumpyF64Backend().poly_div(x, y, out)
    np.testing.assert_allclose(got, host, rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("cls", [T.HybridBackend, T.PallasBackend])
def test_below_threshold_is_the_host_backend(cls):
    """Below the thresholds an op is the port's own host backend's, to
    the bit (genfer_tpu's is held at is_close in test_torch_cli.py: its
    committed C++ kernels were built on another CPU)."""
    b = cls(device="cpu")
    nb = NumpyF64Backend()
    x, y = _rand((40, 30), 9), _rand((35, 25), 10)
    y[0, 0] = 1.5
    np.testing.assert_array_equal(b.conv_trunc(x, y, (60, 50)),
                                  nb.conv_trunc(x, y, (60, 50)))
    np.testing.assert_array_equal(b.poly_div(x, y, (40, 30)),
                                  nb.poly_div(x, y, (40, 30)))
    v = _rand((1, 50), 11)
    v[0, 0] = 1.0
    np.testing.assert_array_equal(b.poly_exp(v, (1, 50)),
                                  nb.poly_exp(v, (1, 50)))
    np.testing.assert_array_equal(b.poly_log(v, (1, 50)),
                                  nb.poly_log(v, (1, 50)))
    assert b.device_ops == 0


def test_routing_constants_match_the_jax_package():
    assert T.HybridBackend.CONV_OFFLOAD_FLOPS == J.HybridBackend.CONV_OFFLOAD_FLOPS
    assert T.HybridBackend.SOLVE_OFFLOAD_LEN == J.HybridBackend.SOLVE_OFFLOAD_LEN
    assert (T.PallasBackend.PALLAS_OFFLOAD_FLOPS
            == J.PallasBackend.PALLAS_OFFLOAD_FLOPS)
    assert T.PallasBackend.MAX_PALLAS_AXIS == J.PallasBackend.MAX_PALLAS_AXIS
    # the port's tensorpoly fast paths test isinstance(b, ArrayF64Backend)
    assert isinstance(T.PallasBackend(device="cpu"), ArrayF64Backend)
    assert not isinstance(T.PallasBackend(device="cpu"), J.JaxF64Backend)


@pytest.mark.parametrize("cls", [T.HybridBackend, T.PallasBackend])
def test_no_card_no_default_device(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls()
