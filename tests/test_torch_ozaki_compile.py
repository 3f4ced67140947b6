"""The compiled mode under ``GENFER_OZAKI=force`` (with
``GENFER_OZAKI_MIN_FLOPS=0``): ``compile.py``'s walk sends its 2-axis f64
products to K5's custom op ``ops.ozaki_conv.ozaki_op``, whose vmap rule
batches them and whose guard stays on the device (a per-product select of
K1's result), so that the walk serves under ``torch.func.vmap`` and, on
the card, inside a CUDA graph.

On the CPU the port's compiled program is held to genfer_tpu's compiled
mode under the same environment (JAX on the CPU: its ``lax.cond`` under
``vmap``) at the reference's is_close, and to the port's own eager forced
``--backend jax`` run (``api.infer``) at rtol 1e-12; ``ozaki_op`` under
``vmap`` is one call of the batched product, each entry equal bit for bit
to its single-pair call, and an entry whose operand holds a NaN equals K1's
plain result.  The tests marked ``cuda`` replay the captured walk on the
card against the eager one.  genfer_tpu's modules are imported inside the
tests that use them: the card machine, which has no jax, collects this
file for its ``cuda`` tests."""

import contextlib
import os

import numpy as np
import pytest
import torch

from genfer_tpu_torch import api as tapi
from genfer_tpu_torch import compile as C
from genfer_tpu_torch.ops import conv2d_f64 as K
from genfer_tpu_torch.ops import ozaki_conv as Z

FORCE = {"GENFER_OZAKI": "force", "GENFER_OZAKI_MIN_FLOPS": "0"}
RTOL = 1e-12
#: the reference's is_close (printed.IS_CLOSE)
IS_CLOSE = (1e-9, 1e-8)
LIMIT = 26
# the scam model (tests/test_torch_compile.py): 26 2-axis f64 products a
# walk, the smaller operand a 2x2 stencil or less (K5's small body)
SRC = """
calls ~ Poisson(10);
scams ~ Binomial(calls, $p);
observe(scams = 1);
return calls;
"""


@contextlib.contextmanager
def _forced(**extra):
    old = {k: os.environ.get(k) for k in (*FORCE, *extra)}
    os.environ.update({**FORCE, **extra})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture
def routed(monkeypatch):
    """Every call of K5's batched product and of K1's batched wrapper."""
    calls = {"k5": [], "k1": []}
    k5, k1 = Z.ozaki_conv2d_batched, K.conv2d_trunc_f64_batched

    def count_k5(a, b, out_shape, *args, **kwargs):
        calls["k5"].append((tuple(a.shape), tuple(b.shape)))
        return k5(a, b, out_shape, *args, **kwargs)

    def count_k1(a, b, out_shape, *args, **kwargs):
        calls["k1"].append((tuple(a.shape), tuple(b.shape)))
        return k1(a, b, out_shape, *args, **kwargs)

    monkeypatch.setattr(Z, "ozaki_conv2d_batched", count_k5)
    monkeypatch.setattr(K, "conv2d_trunc_f64_batched", count_k1)
    return calls


def _grid(n, seed=0):
    return np.random.default_rng(seed).uniform(0.01, 0.99, (n, 1))


def test_compiled_mode_under_force_routes_every_product(routed):
    """Under force the batched walk sends each of its 26 products to K5
    once (one call over the whole batch) and none to K1; without force
    none to K5."""
    t = C.compile_program(SRC, ["p"], LIMIT, device="cpu")
    grid = _grid(5)
    with _forced():
        forced = t.probs_batch(grid)
    assert len(routed["k5"]) == 26 and not routed["k1"]
    assert all(a[0] == 5 for a, _ in routed["k5"])
    routed["k5"].clear()
    default = t.probs_batch(grid)
    assert not routed["k5"] and len(routed["k1"]) == 26
    # at is_close: the route's error is normwise per column, so masses far
    # below their column's max may differ from K1's (the componentwise
    # cliff of ops/ozaki_conv.py)
    np.testing.assert_allclose(forced, default, rtol=IS_CLOSE[0],
                               atol=IS_CLOSE[1])


def test_compiled_mode_under_force_matches_genfer_tpu():
    """probs (plain and normalized) and moments of a seeded $p grid, and
    the single-dataset entry points, against genfer_tpu's compiled mode
    under the same environment, at the reference's is_close."""
    import jax.numpy as jnp

    from genfer_tpu.compile import compile_program as jcompile

    rel, abs_ = IS_CLOSE
    grid = _grid(6, seed=1)
    with _forced():
        t = C.compile_program(SRC, ["p"], LIMIT, device="cpu")
        j = jcompile(SRC, params=["p"], limit=LIMIT)
        pairs = [(t.probs_batch(grid), j.probs_batch(jnp.asarray(grid))),
                 (t.probs_batch(grid, normalized=True),
                  j.probs_batch(jnp.asarray(grid), normalized=True)),
                 (t.probs(grid[2]), j.probs(jnp.asarray(grid[2])))]
        pairs += list(zip(t.moments_batch(grid),
                          j.moments_batch(jnp.asarray(grid))))
    for got, want in pairs:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rel, atol=abs_)


def test_compiled_mode_under_force_matches_the_eager_forced_run():
    """Each dataset of the batch against the port's eager ``--backend
    jax`` run of the program with $p bound (``api.infer``, the same forced
    route through ``ozaki_conv2d_guarded``), at rtol 1e-12; the single
    entry point equals the batch's row bit for bit."""
    grid = _grid(3, seed=2)
    with _forced():
        t = C.compile_program(SRC, ["p"], LIMIT, device="cpu")
        batch = t.probs_batch(grid).numpy()
        for row, (p,) in zip(batch, grid):
            r = tapi.infer(SRC.replace("$p", repr(float(p))),
                           backend="jax", device="cpu")
            eager = np.array([x.to_float()
                              for x in r.probs(LIMIT, normalized=False)])
            np.testing.assert_allclose(row, eager, rtol=RTOL, atol=0)
        assert np.array_equal(t.probs(grid[0]).numpy(), batch[0])


@pytest.mark.parametrize("batched", ["a", "b", "both"])
def test_ozaki_op_under_vmap_is_one_call(routed, batched):
    """One operand vmapped and the other not (or both): one call of the
    batched product over the vmapped dimension times the op's batch, each
    entry equal bit for bit to its single-pair call."""
    rng = np.random.default_rng(4)
    v, nb, out = 5, 2, (8, 7)
    a = torch.from_numpy(rng.random((v, nb, 6, 7) if batched != "b"
                                    else (nb, 6, 7)))
    b = torch.from_numpy(rng.random((v, nb, 5, 3) if batched != "a"
                                    else (nb, 5, 3)))
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)
    got = torch.func.vmap(lambda x, y: Z.ozaki_op(x, y, out),
                          in_dims=dims)(a, b)
    assert routed["k5"] == [((v * nb, 6, 7), (v * nb, 5, 3))]
    for i in range(v):
        for z in range(nb):
            x = (a[i] if dims[0] == 0 else a)[z]
            y = (b[i] if dims[1] == 0 else b)[z]
            assert torch.equal(got[i, z], Z.ozaki_conv2d(x, y, out))


def test_ozaki_op_under_vmap_guards_each_entry():
    """A vmapped batch with one entry whose operand holds a NaN: that
    entry equals K1's plain result (NaN where IEEE puts one, the rest K1's
    bits), every other entry K5's plain version, and the guard counts
    one product."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((4, 20, 21)))
    b = torch.from_numpy(rng.random((4, 9, 8)))
    a[2, 3, 5] = float("nan")
    out = (24, 25)
    Z.reset_launches()
    got = torch.func.vmap(lambda x, y: Z.ozaki_op(x[None], y[None],
                                                  out)[0])(a, b)
    assert Z.guarded_count() == 1
    for z in range(4):
        if z == 2:
            want = K.conv2d_trunc_f64_reference(a[z], b[z], out)
            nan = torch.isnan(want)
            assert nan.any() and torch.equal(torch.isnan(got[z]), nan)
            assert torch.equal(got[z][~nan], want[~nan])
        else:
            want = Z.ozaki_conv2d_reference(a[z], b[z], out)
            assert torch.equal(got[z], want)


def test_ozaki_op_fake_and_environment():
    """The op's fake result has the batch and output shape; pair_bits and
    impl come from the environment at each call."""
    a = torch.rand(3, 10, 4, dtype=torch.float64)
    b = torch.rand(3, 6, 5, dtype=torch.float64)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = Z.ozaki_op(mode.from_tensor(a), mode.from_tensor(b), (12, 7))
    assert tuple(fake.shape) == (3, 12, 7)
    with _forced(GENFER_OZAKI_PAIR_BITS="5", GENFER_OZAKI_IMPL="bf16"):
        got = Z.ozaki_op(a, b, (12, 7))
    assert torch.equal(got, Z.ozaki_conv2d_batched(a, b, (12, 7), 5, "bf16"))


def test_compile_serving_under_force():
    """``api.compile_serving``'s scan walk contracts with Toeplitz matrix
    products, never a 2-axis Cauchy product, so the route does not reach
    it: under force it serves a $param sweep as it does without."""
    sweep = [{"p": 0.1}, {"p": 0.3}]
    src = SRC.strip()
    default = tapi.compile_serving(src, order=32, params={"p": 0.2},
                                   device="cpu").run_param_sweep(sweep)[0]
    with _forced():
        forced = tapi.compile_serving(src, order=32, params={"p": 0.2},
                                      device="cpu").run_param_sweep(sweep)[0]
    np.testing.assert_array_equal(np.asarray(forced), np.asarray(default))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graph_replay_under_force_equals_the_eager_walk(card):
    """The scam model's batched walk under force on the card: one split
    and one K5 launch (small body) a product in the eager walk, a captured
    graph whose replays equal the eager walk bit for bit, the guard's
    device count 0, and the CPU's compiled program within 1e-12."""
    grid = torch.linspace(0.01, 0.99, 256, dtype=torch.float64).reshape(
        256, 1)
    with _forced():
        t = C.CompiledProgram(SRC, ["p"], limit=LIMIT, device="cuda")
        Z.reset_launches()
        eager = t._probs_batch.eager(grid)
        assert Z.ozaki_conv2d.launches == 26 == Z.ozaki_split.launches
        assert Z.ozaki_conv2d.launches_by_body["small"] == 26
        first = t.probs_batch(grid)
        assert torch.equal(first, eager)
        other = grid.flip(0)
        assert torch.equal(t.probs_batch(other), t._probs_batch.eager(other))
        assert Z.guarded_count() == 0
        cpu = C.compile_program(SRC, ["p"], LIMIT, device="cpu")
        np.testing.assert_allclose(first.cpu().numpy(),
                                   cpu.probs_batch(grid).numpy(), rtol=RTOL)
