"""Compiled serving in the port (``genfer_tpu_torch.compile``) against
genfer_tpu's ``compile``: the same seeded numpy parameters through both,
the JAX package on the CPU as its own tests run it, the port with
``device="cpu"``, at rtol 1e-12 (both walk the same DAG in IEEE f64; the
scam and digit models agree bit for bit, two_populations to ~1e-15).  Also the pieces the walk needs
under ``torch.func.vmap``: K1's custom op and its vmap rule, the
out-of-place ``_exp1d`` and ``_set_first``; the host ``api.infer`` twin;
and, on the card, one K1 launch a vmapped product and a CUDA-graph replay
equal to the eager walk."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# genfer_tpu's modules import jax where they run it: the card machine,
# which has no jax, collects this file for its ``cuda`` tests
from genfer_tpu import api as japi
from genfer_tpu.compile import TracedF64Backend as JTraced
from genfer_tpu.compile import _translate_big_stack
from genfer_tpu.compile import compile_program as jcompile
from genfer_tpu.compile import make_param_scalar as jmake
from genfer_tpu_torch import api as tapi
from genfer_tpu_torch import compile as C
from genfer_tpu_torch.ops import conv2d_f64 as K
from genfer_tpu_torch.taylor import tensorpoly
from genfer_tpu_torch.taylor.backend import (
    TorchF64Backend,
    TorchIntervalBackend,
    _conv_impl,
    _exp1d,
)
from genfer_tpu_torch.taylor.host import IvArr
from genfer_tpu_torch.tools.generators import (
    digit_serving_source,
    two_populations_serving,
)

RTOL = 1e-12

SRC = """
calls ~ Poisson(10);
scams ~ Binomial(calls, $p);
observe(scams = 1);
return calls;
"""
MULTI = """
x ~ Bernoulli($q);
y ~ Binomial(6, $p);
observe x = 1;
return y;
"""
WHILE = """
X := 0;
while 1 ~ Bernoulli($p) {
    X += 1;
}
return X
"""


def _j(x):
    """``x`` as a jax array (f64: tests/conftest.py enables x64)."""
    import jax.numpy as jnp

    return jnp.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def scam():
    return (jcompile(SRC, params=["p"], limit=26),
            C.compile_program(SRC, params=["p"], limit=26, device="cpu"))


def test_scam_single_and_moments(scam):
    j, t = scam
    p = np.array([0.2])
    _close(t.probs(p), j.probs(_j(p)))
    _close(t.probs(p, normalized=True),
           j.probs(_j(p), normalized=True))
    for got, want in zip(t.moments(p), j.moments(_j(p))):
        _close(got, want)
    total, raw = t.moments(p)
    assert float(total) == pytest.approx(2 * np.exp(-2), rel=1e-12)
    assert float(raw[0]) == pytest.approx(9.0, rel=1e-9)


def test_scam_batch(scam):
    """A seeded grid of $p: probs (plain and normalized) and moments."""
    j, t = scam
    grid = np.random.default_rng(0).uniform(0.01, 0.99, (16, 1))
    got = t.probs_batch(grid)
    assert got.shape == (16, 26) and got.dtype == torch.float64
    _close(got, j.probs_batch(_j(grid)))
    _close(t.probs_batch(grid, normalized=True),
           j.probs_batch(_j(grid), normalized=True))
    for got, want in zip(t.moments_batch(grid),
                         j.moments_batch(_j(grid))):
        _close(got, want)


def test_scam_matches_the_host_interpreter(scam):
    """The port's compiled program against its host ``api.infer``, and
    that against genfer_tpu's (``test_compiled_matches_interpreter``)."""
    _, t = scam
    r = tapi.infer(SRC.replace("$p", "0.2"))
    ref = [x.to_float() for x in r.probs(26, normalized=False)]
    np.testing.assert_allclose(t.probs(np.array([0.2])), ref, rtol=1e-9)
    jr = japi.infer(SRC.replace("$p", "0.2"))
    assert r.total.to_float() == jr.total.to_float()
    assert [m.to_float() for m in r.raw_moments] == [
        m.to_float() for m in jr.raw_moments]


def test_multi_parameter():
    j = jcompile(MULTI, params=["q", "p"], limit=7)
    t = C.compile_program(MULTI, params=["q", "p"], limit=7, device="cpu")
    rng = np.random.default_rng(1)
    for params in rng.uniform(0.05, 0.95, (3, 2)):
        _close(t.probs(params), j.probs(_j(params)))
    batch = rng.uniform(0.05, 0.95, (4, 2))
    _close(t.probs_batch(batch), j.probs_batch(_j(batch)))


def test_while_with_rest_bound():
    j = jcompile(WHILE, params=["p"], limit=8, unroll=8)
    t = C.compile_program(WHILE, params=["p"], limit=8, unroll=8,
                          device="cpu")
    assert t.has_rest and j.has_rest
    p = np.array([0.5])
    _close(t.probs(p), j.probs(_j(p)))
    _close(t.rest_bound(p), j.rest_bound(_j(p)))
    assert 0.0 < float(t.rest_bound(p)) <= 2.0 ** -8 + 1e-12
    grid = np.array([[0.25], [0.5]])
    rb = t.rest_bound_batch(grid)
    assert rb.shape == (2,) and rb[0] < rb[1]
    _close(rb, j.rest_bound_batch(_j(grid)))


def test_rest_bound_without_a_loop(scam):
    """A loop-free program: no rest GF at all (zeros), or one that
    evaluates to 0 (the scam model's ``max(0, 0)``), as in genfer_tpu."""
    t = C.compile_program("x ~ Binomial(6, $p);\nreturn x", ["p"], 7,
                          device="cpu")
    assert not t.has_rest
    assert float(t.rest_bound(np.array([0.3]))) == 0.0
    assert t.rest_bound_batch(np.array([[0.3], [0.4]])).tolist() == [0, 0]
    j, t = scam
    grid = np.array([[0.3], [0.4]])
    assert t.has_rest == j.has_rest
    _close(t.rest_bound_batch(grid), j.rest_bound_batch(_j(grid)))
    assert t.rest_bound_batch(grid).tolist() == [0, 0]


def test_digit_model_20_pixels_batch_8():
    """The naive-Bayes digit model (examples/digit_serving.py) at 20
    pixels, batch 8, with a seeded evidence vector."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "examples"))
    from digit_serving import model_source

    src, params = digit_serving_source(20)
    assert (src, params) == model_source(20)
    j = jcompile(src, params=params, limit=10)
    t = C.compile_program(src, params=params, limit=10, device="cpu")
    ev = np.random.default_rng(2).uniform(0.05, 0.95, (8, len(params)))
    got = t.probs_batch(ev)
    assert got.shape == (8, 10)
    # genfer_tpu's trace of 200 observations recurses past the limit a
    # pytest process leaves: trace it on its big-stack thread
    _close(got, _translate_big_stack(
        lambda: np.asarray(j.probs_batch(_j(ev)))))


def test_two_populations_size_20_batch_6():
    """genfer's two_populations program with survival and detection as
    parameters (the benchmark's ``two_populations_2000`` at size 20): a
    parameterized thinning of a variable by itself and observations under
    a symbolic ``$det``."""
    src, _ = two_populations_serving(20)
    params = ["s1", "s2", "det"]
    j = jcompile(src, params=params, limit=20)
    t = C.compile_program(src, params=params, limit=20, device="cpu")
    grid = np.random.default_rng(3).uniform(0.1, 0.4, (6, 3))
    got = t.probs_batch(grid)
    assert got.shape == (6, 20) and (got[:, 0] > 0).all()
    _close(got, _translate_big_stack(
        lambda: np.asarray(j.probs_batch(_j(grid)))))


def test_a_host_read_raises_in_both():
    """A multi-axis division reads its operand on the host; under
    genfer_tpu's ``jit`` that raises, and so does the port's walk."""
    import jax

    ys = np.random.default_rng(3).uniform(0.5, 1.0, (3, 3))
    xs = np.ones((3, 3))

    def jax_walk(params):
        b = JTraced(params, jmake(["p"]))
        return b.poly_div(_j(xs), _j(ys), (3, 3))

    with pytest.raises(TypeError):
        jax.jit(jax_walk)(_j([0.5]))
    b = C.TracedF64Backend(torch.tensor([0.5], dtype=torch.float64),
                           C.make_param_scalar(["p"]), "cpu", {})
    with pytest.raises(TypeError, match="host"):
        b.poly_div(torch.from_numpy(xs), torch.from_numpy(ys), (3, 3))
    for op in (b.poly_exp, b.poly_log):
        with pytest.raises(TypeError, match="host"):
            op(torch.from_numpy(ys), (3, 3))
    with pytest.raises(AssertionError):
        b.to_host(torch.tensor(1.0, dtype=torch.float64))


def test_constants_are_served_from_the_cache():
    """Every literal of a walk comes from the program's cache: a second
    walk adds none and hands back the same tensors."""
    t = C.CompiledProgram(SRC, ["p"], limit=6, device="cpu")
    first = t.probs_batch(np.array([[0.3], [0.6]]))
    n = len(t.constants)
    ids = {id(v) for v in t.constants.values()}
    assert n > 0
    assert torch.equal(t.probs_batch(np.array([[0.3], [0.6]])), first)
    assert len(t.constants) == n
    assert {id(v) for v in t.constants.values()} == ids


def test_compile_program_is_cached_per_device():
    a = C.compile_program(SRC, params=["p"], limit=5, device="cpu")
    assert C.compile_program(SRC, ["p"], 5, device="cpu") is a


def test_compile_program_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.CompiledProgram(SRC, ["p"], limit=5)


def test_compile_serving_compiles_a_scan_program():
    """``api.compile_serving`` returns the scan compiler's object (the
    scam model with $p bound), which serves a $param sweep as genfer_tpu's
    does (``tests/test_torch_scanc.py`` holds the rest)."""
    src = "calls ~ Poisson(10);\nscams ~ Binomial(calls, $p);\n" \
          "observe(scams = 1);\nreturn calls;"
    obj = tapi.compile_serving(src, order=32, params={"p": 0.2},
                               device="cpu")
    jobj = japi.compile_serving(src, order=32, params={"p": 0.2})
    assert obj.order == jobj.order
    sweep = [{"p": 0.1}, {"p": 0.2}]
    np.testing.assert_allclose(obj.run_param_sweep(sweep)[0],
                               jobj.run_param_sweep(sweep)[0], rtol=RTOL)


def test_infer_twin_on_examples():
    """``api.infer`` / ``infer_file`` print genfer_tpu's numbers on the
    host backend."""
    path = Path(__file__).resolve().parent.parent / "examples" / (
        "scam_calls.sgcl")
    r, jr = tapi.infer_file(path), japi.infer_file(path)
    assert r.total.to_float() == jr.total.to_float()
    assert r.mean.to_float() == jr.mean.to_float()
    assert r.variance.to_float() == jr.variance.to_float()
    assert [x.to_float() for x in r.probs(8)] == [
        x.to_float() for x in jr.probs(8)]
    assert [x.to_float() for x in r.standardized()] == [
        x.to_float() for x in jr.standardized()]


# ----------------------------------------------------------------------
# K1's custom op under torch.func.vmap
# ----------------------------------------------------------------------

@pytest.fixture
def k1_calls(monkeypatch):
    """Every call of K1's wrapper: (a shape, b shape, out shape)."""
    calls = []
    wrapper = K.conv2d_trunc_f64_batched

    def counting(a, b, out_shape):
        calls.append((tuple(a.shape), tuple(b.shape), tuple(out_shape)))
        return wrapper(a, b, out_shape)

    monkeypatch.setattr(K, "conv2d_trunc_f64_batched", counting)
    return calls, wrapper


@pytest.mark.parametrize("batched", ["a", "b", "both"])
def test_k1_op_under_vmap_is_one_call(k1_calls, batched):
    """One operand vmapped and the other not (or both): one wrapper call
    over the vmapped dimension times K1's batch, equal bit for bit to the
    loop over single pairs."""
    calls, wrapper = k1_calls
    rng = np.random.default_rng(4)
    v, nb, out = 5, 3, (8, 7)
    a = torch.from_numpy(rng.standard_normal(
        (v, nb, 6, 7) if batched != "b" else (nb, 6, 7)))
    b = torch.from_numpy(rng.standard_normal(
        (v, nb, 2, 3) if batched != "a" else (nb, 2, 3)))
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)
    got = torch.func.vmap(lambda x, y: K.k1_op(x, y, out),
                          in_dims=dims)(a, b)
    assert calls == [((v * nb, 6, 7), (v * nb, 2, 3), out)]
    want = torch.stack([torch.stack([
        wrapper((a[i] if dims[0] == 0 else a)[z][None].contiguous(),
                (b[i] if dims[1] == 0 else b)[z][None].contiguous(),
                out)[0] for z in range(nb)]) for i in range(v)])
    assert torch.equal(got, want)


def test_k1_op_under_vmap_with_a_pair_batch(k1_calls):
    """A 3-axis product (every pair of leading rows one entry of K1's
    batch) vmapped over a non-leading dimension: one wrapper call over
    all pairs of all entries, equal bit for bit to the unbatched
    products; without vmap the op equals the plain wrapper's route."""
    calls, _ = k1_calls
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((4, 3, 5, 6)))  # vmapped dim 1
    b = torch.from_numpy(rng.standard_normal((2, 3, 4)))
    out = (4, 5, 6)
    got = torch.func.vmap(
        lambda x: _conv_impl(x, b, out, conv2d=K.k1_op), in_dims=1)(a)
    assert len(calls) == 1 and calls[0][0][0] == 3 * 4 * 2
    calls.clear()
    want = torch.stack([_conv_impl(a[:, i].contiguous(), b, out)
                        for i in range(3)])
    assert torch.equal(got, want)
    assert len(calls) == 3
    assert torch.equal(_conv_impl(a[:, 0].contiguous(), b, out,
                                  conv2d=K.k1_op), want[0])


def test_k1_op_fake_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty((3, 5, 6), dtype=torch.float64)
        b = torch.empty((3, 2, 2), dtype=torch.float64)
        out = K.k1_op(a, b, (6, 7))
    assert tuple(out.shape) == (3, 6, 7) and out.dtype == torch.float64


# ----------------------------------------------------------------------
# the out-of-place repairs
# ----------------------------------------------------------------------

def _exp1d_in_place(xs, out_shape, axis):
    """``_exp1d`` as it was written before, with the in-place write."""
    n = out_shape[axis]
    x = xs.movedim(axis, 0).reshape(xs.shape[axis])
    pad = n - x.shape[0]
    x = torch.nn.functional.pad(x, (0, pad)) if pad > 0 else x[:n]
    k = torch.arange(n)[:, None]
    m = torch.arange(n)[None, :]
    d = k - m
    valid = (d >= 1) & (m < k)
    zero = torch.zeros((), dtype=x.dtype)
    coeff = torch.where(valid, d, 0).to(x.dtype) * torch.where(
        valid, x[d.clamp(0, n - 1)], zero)
    ksafe = torch.where(k == 0, 1, k).to(x.dtype)
    M = torch.eye(n, dtype=x.dtype) - coeff / ksafe
    rhs = torch.zeros((n, 1), dtype=x.dtype)
    rhs[0, 0] = torch.exp(x[0])
    f = torch.linalg.solve_triangular(M, rhs, upper=False)
    return f.reshape([n] + [1] * (len(out_shape) - 1)).movedim(0, axis)


@pytest.mark.parametrize("n_in,out_shape,axis", [
    (5, (9,), 0), (9, (5,), 0), (6, (1, 8), 1), (1, (4,), 0)])
def test_exp1d_out_of_place(n_in, out_shape, axis):
    rng = np.random.default_rng(6)
    shape = [1] * len(out_shape)
    shape[axis] = n_in
    xs = torch.from_numpy(rng.uniform(-1, 1, shape))
    assert torch.equal(_exp1d(xs, out_shape, axis),
                       _exp1d_in_place(xs, out_shape, axis))
    batch = torch.from_numpy(rng.uniform(-1, 1, [3] + shape))
    got = torch.func.vmap(lambda x: _exp1d(x, out_shape, axis))(batch)
    for z in range(3):
        assert torch.equal(got[z], _exp1d(batch[z], out_shape, axis))


@pytest.mark.parametrize("shape", [(1,), (4,), (3, 5), (2, 1, 3)])
def test_set_first_out_of_place(shape):
    rng = np.random.default_rng(7)
    b = TorchF64Backend(device="cpu")
    arr = torch.from_numpy(rng.standard_normal(shape))
    val = torch.tensor(2.5, dtype=torch.float64)
    want = arr.clone()
    want[(0,) * len(shape)] = val
    got = tensorpoly._set_first(b, arr, val)
    assert torch.equal(got, want)
    assert not torch.equal(arr, want) or arr.numel() == 0
    vals = torch.from_numpy(rng.standard_normal(4))
    out = torch.func.vmap(lambda v: tensorpoly._set_first(b, arr, v))(vals)
    for z in range(4):
        w = arr.clone()
        w[(0,) * len(shape)] = vals[z]
        assert torch.equal(out[z], w)
    # the interval backend's twin: both endpoints
    ib = TorchIntervalBackend(device="cpu")
    data = torch.from_numpy(rng.standard_normal((2,) + shape))
    iv = tensorpoly._set_first(ib, IvArr(data),
                               IvArr(torch.tensor([1.0, 2.0],
                                                  dtype=torch.float64)))
    want = data.clone()
    want[(slice(None),) + (0,) * len(shape)] = torch.tensor([1.0, 2.0],
                                                           dtype=torch.float64)
    assert torch.equal(iv.data, want)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_one_k1_launch_a_vmapped_product(card):
    """The scam model's batched walk: one K1 launch (small body) a
    product, whatever the batch."""
    t = C.CompiledProgram(SRC, ["p"], limit=26, device="cuda")
    grid = torch.linspace(0.01, 0.99, 64, dtype=torch.float64).reshape(
        64, 1)
    for fn in (t._probs_batch, t._probs):
        K.reset_launches()
        fn.eager(grid if fn is t._probs_batch else grid[0])
        assert K.conv2d_trunc_f64.launches == 26
        assert K.conv2d_trunc_f64.launches_by_body["small"] == 26


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_walk(card):
    t = C.CompiledProgram(SRC, ["p"], limit=26, device="cuda")
    grid = torch.linspace(0.01, 0.99, 256, dtype=torch.float64).reshape(
        256, 1)
    eager = t._probs_batch.eager(grid)
    K.reset_launches()
    first = t.probs_batch(grid)
    assert K.conv2d_trunc_f64.launches == 26  # the captured walk
    assert torch.equal(first, eager)
    other = grid.flip(0)
    assert torch.equal(t.probs_batch(other), t._probs_batch.eager(other))
    assert K.conv2d_trunc_f64.launches == 26 + 26  # eager: 26, replays: 0
    np.testing.assert_allclose(
        t.probs_batch(grid).cpu().numpy(),
        C.compile_program(SRC, ["p"], 26, device="cpu").probs_batch(
            grid.cpu()).numpy(), rtol=RTOL)
