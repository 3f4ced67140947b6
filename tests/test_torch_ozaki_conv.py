"""K5, the ozaki route (``genfer_tpu_torch/ops/ozaki_conv.py``), on the CPU
against genfer_tpu's ``ops/ozaki_conv.py``: the split, the plain version,
the accuracy ladder, the guard, the routing gates, the backend and the
CLI under ``GENFER_OZAKI=force``; the batched split and product against
their per-entry calls.  The tests marked ``cuda`` hold the kernels
(``csrc/ozaki_split.cu``, ``csrc/ozaki_conv2d.cu``) to the plain version
on a card (they skip here); ``tests/test_torch_ozaki_mma.py`` emulates
the kernels' layouts and fragments in numpy, and
``tests/test_torch_ozaki_compile.py`` holds the compiled mode under
``force``.

genfer_tpu's modules import jax where the tests run them (the card
machine has no jax; it runs only the ``cuda`` tests of this file).

XLA on the CPU computes ``exp2`` of an integer inexactly (up to ~4e-15
relative, e.g. exp2(-3) in a jitted vector), so on the CPU genfer_tpu's own
power-of-two scaling and undo are not exact and its result moves by that
much (ROADMAP Queue 3).  The plain version is therefore held to
genfer_tpu's traced body run with an exact ``exp2`` (``_EXACT``), at 2e-15
of each output column's max, and to the unmodified entry point at the
JAX tests' own bars against host f64.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from genfer_tpu_torch import cli
from genfer_tpu_torch.lang.parser import parse_program as tparse
from genfer_tpu_torch.ops import ozaki_conv as Z
from genfer_tpu_torch.printed import disagreements, read_results
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.taylor.host import NumpyF64Backend

HOST = NumpyF64Backend()

# tests/test_ozaki_conv.py::SHAPES
SHAPES = [
    ((64, 64), (64, 64), (127, 127)),   # full product
    ((64, 64), (64, 64), (64, 64)),     # truncated square
    ((33, 17), (21, 45), (40, 40)),     # ragged
    ((128, 1), (1, 128), (128, 128)),   # outer product
    ((5, 128), (128, 5), (132, 132)),   # thin operands
]
VARIANTS = [(impl, pb) for impl in Z.IMPLS for pb in (5, 6, 7)]
FORCE = {"GENFER_OZAKI": "force", "GENFER_OZAKI_MIN_FLOPS": "0"}


def _jax():
    import jax.numpy as jnp

    from genfer_tpu.ops import ozaki_conv as J

    return jnp, J


class _ExactExp2:
    """jax.numpy with an exact exp2 of integer-valued arrays (ldexp)."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        import jax.numpy as jnp

        return jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))


_EXACT = _ExactExp2()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel_err(got, want):
    want = np.asarray(want)
    scale = np.maximum(np.abs(want), 1e-300)
    return float(np.max(np.abs(np.asarray(got) - want) / scale))


def _col_err(got, want):
    """Max error of each output column over that column's max."""
    want = np.asarray(want)
    col = np.maximum(np.abs(want).max(axis=0, keepdims=True), 1e-300)
    return float((np.abs(np.asarray(got) - want) / col).max())


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------------------------------------ the split

@pytest.mark.parametrize("split", ["_chunk_int", "_chunk"])
@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_equals_genfer_tpu(shapes, split):
    """Column exponents and every chunk (int8 and bf16) bit for bit, on
    uniform operands, signed ones with 2^+-300 column scales, and the
    extreme scales 2^950 and 2^-980."""
    jnp, J = _jax()
    sa, _, _ = shapes
    rng = np.random.RandomState(sum(sa))
    xs = [rng.rand(*sa),
          rng.randn(*sa) * np.exp2(rng.randint(-300, 300, size=sa[1])),
          np.full(sa, 2.0 ** 950), np.full(sa, 2.0 ** -980)]
    for x in xs:
        e = Z._pow2_colexp(_t(x)).numpy()
        assert np.array_equal(e, np.asarray(J._pow2_colexp(jnp,
                                                           jnp.asarray(x))))
        scaled = x * np.ldexp(1.0, -e.astype(int))[None, :]
        for jdt, tdt, bits in ((jnp.int8, torch.int8, np.int8),
                               (jnp.bfloat16, torch.bfloat16, np.int16)):
            want = getattr(J, split)(jnp, jnp.asarray(scaled), jdt)
            got = getattr(Z, split)(_t(scaled), tdt)
            for w, g in zip(want, got):  # the bits (a bf16 -0.0 included)
                assert np.array_equal(np.asarray(w).view(bits),
                                      g.view(getattr(torch, bits.__name__))
                                      .numpy())


def test_split_reference_layout():
    """``ozaki_split_reference``: [n_t, rows, cols] chunks of the impl's
    type, int32 exponents, the finiteness flag; the chunks rebuild the
    scaled operand to half the last chunk's unit, 2^-(7 n_t + 1), plus
    the 2^-57 of the conversion to integer ticks."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 13)) * 10.0 ** rng.integers(-5, 5, 13)
    for pb, impl in ((7, "int8"), (5, "bf16")):
        chunks, e, finite = Z.ozaki_split_reference(_t(x), pb, impl)
        n_t = min(8, pb + 1)
        assert chunks.shape == (n_t, 9, 13) and finite
        assert chunks.dtype == (torch.int8 if impl == "int8"
                                else torch.bfloat16)
        assert e.dtype == torch.int32
        w = 2.0 ** (-7 * (np.arange(n_t) + 1))
        back = np.einsum("t,trc->rc", w, chunks.double().numpy())
        scaled = x * np.ldexp(1.0, -e.numpy())[None, :]
        bound = 2.0 ** (-7 * n_t - 1) + 2.0 ** -57
        assert np.abs(back - scaled).max() <= bound
    x[2, 3] = np.nan
    assert not Z.ozaki_split_reference(_t(x))[2]


@pytest.mark.parametrize("impl", Z.IMPLS)
def test_batched_split_against_per_entry(impl):
    """The split kernel's plain version over a batch: every entry's chunks,
    seen through ``chunk_view``, are ``ozaki_split_reference``'s bit for
    bit (a's columns reversed, b's ascending, each padded with zeros to a
    multiple of 16 rows), its exponents the same, and the flag set only
    for the entry with a non-finite operand; ``ozaki_split`` on the CPU is
    that plain version."""
    rng = np.random.default_rng(7)
    a = _t(rng.standard_normal((3, 21, 5)) * 10.0 ** rng.integers(-9, 9, 5))
    b = _t(rng.standard_normal((3, 33, 4)))
    b[1, 7, 2] = np.inf
    ca, cb, ea, eb, flags = Z.ozaki_split(a, b, 6, impl)
    assert ca.shape == (3, 7, 5, 32) and cb.shape == (3, 7, 4, 48)
    assert flags.tolist() == [0, 1, 0] and flags.dtype == torch.int32
    view = torch.int8 if impl == "int8" else torch.int16
    for z in range(3):
        for x, c, e, rev in ((a[z], ca[z], ea[z], True),
                             (b[z], cb[z], eb[z], False)):
            want, want_e, _ = Z.ozaki_split_reference(x, 6, impl)
            got = Z.chunk_view(c, x.shape[0], rev)
            if z != 1:
                assert torch.equal(got.contiguous().view(view),
                                   want.view(view))
                assert torch.equal(e, want_e)
            pad = c[..., :c.shape[-1] - x.shape[0]] if rev else \
                c[..., x.shape[0]:]
            assert not pad.double().any()


@pytest.mark.parametrize("impl", Z.IMPLS)
def test_batched_product_against_per_entry(impl):
    """``ozaki_conv2d_batched`` on the CPU: each entry equals its
    single-pair ``ozaki_conv2d`` and the plain version bit for bit, and an
    entry with a NaN operand K1's plain result (the guard, counted once);
    without the guard the batched plain version."""
    rng = np.random.default_rng(8)
    a, b = _t(rng.random((3, 30, 12))), _t(rng.random((3, 9, 14)))
    out = (35, 20)
    clean = Z.ozaki_conv2d_batched(a, b, out, 7, impl)
    assert torch.equal(clean, Z.ozaki_conv2d_batched_reference(a, b, out, 7,
                                                               impl))
    for z in range(3):
        assert torch.equal(clean[z], Z.ozaki_conv2d(a[z], b[z], out, 7, impl))
    a[0, 4, 4] = float("nan")
    Z.reset_launches()
    got = Z.ozaki_conv2d_batched(a, b, out, 7, impl)
    assert Z.guarded_count() == 1
    want = T._conv_dense(a[0], b[0], out)
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want))
    assert torch.equal(got[1:], clean[1:])
    unguarded = Z.ozaki_conv2d_batched(a, b, out, 7, impl, guard=False)
    assert torch.equal(unguarded[1:], clean[1:]) and Z.guarded_count() == 1


# ---------------------------------------------- the plain version vs JAX

@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_equals_genfer_tpu(shapes):
    """Every shape of genfer_tpu's SHAPES at pair_bits 5, 6, 7, int8 and
    bf16: within 2e-15 of each output column's max of genfer_tpu's traced
    body (exact exp2; module docstring).  At P = 5 both sit ~1e-10 from
    host, so agreeing this closely shows the same chunk pairs kept."""
    import jax

    jnp, J = _jax()
    sa, sb, out = shapes
    rng = np.random.RandomState(7)
    a, b = rng.rand(*sa), rng.rand(*sb)
    run = jax.jit(lambda x, y: [
        J.ozaki_conv2d_traced(_EXACT, x, y, out, pb, impl)
        for impl, pb in VARIANTS])
    wants = run(jnp.asarray(a), jnp.asarray(b))
    host = HOST.conv_trunc(a, b, out)
    for (impl, pb), want in zip(VARIANTS, wants):
        got = Z.ozaki_conv2d_reference(_t(a), _t(b), out, pb, impl).numpy()
        assert _col_err(got, want) < 2e-15, (impl, pb)
        if pb == 5:
            assert _col_err(got, host) > 1e-13  # the truncation shows


@pytest.mark.parametrize("impl", Z.IMPLS)
def test_accuracy_uniform_operands(impl):
    """The ladder of genfer_tpu's test (pair_bits 7, 6, 5 at 1e-13, 5e-12,
    5e-10 against host), and the unmodified genfer_tpu entry point within
    1e-14 of each column's max (its XLA exp2 included)."""
    jnp, J = _jax()
    rng = np.random.RandomState(7)
    for sa, sb, out in SHAPES:
        a, b = rng.rand(*sa), rng.rand(*sb)
        want = HOST.conv_trunc(a, b, out)
        got = {}
        for pair_bits, tol in [(7, 1e-13), (6, 5e-12), (5, 5e-10)]:
            got[pair_bits] = Z.ozaki_conv2d(_t(a), _t(b), out, pair_bits,
                                            impl).numpy()
            assert _rel_err(got[pair_bits], want) < tol, (sa, out, pair_bits)
        ref = J.ozaki_conv2d(jnp.asarray(a), jnp.asarray(b), out, 7, impl)
        assert _col_err(got[7], np.asarray(ref)) < 1e-14


def test_accuracy_mixed_sign_and_column_scales():
    """Signed operands with 2^+-300 column scales: normwise within 1e-12
    (genfer_tpu's bar), and as close to genfer_tpu's result."""
    jnp, J = _jax()
    rng = np.random.RandomState(3)
    a = rng.randn(96, 48)
    b = rng.randn(96, 48)
    a *= np.exp2(rng.randint(-300, 300, size=48))[None, :]
    b *= np.exp2(rng.randint(-300, 300, size=48))[None, :]
    out = (96, 95)
    want = HOST.conv_trunc(a, b, out)
    got = Z.ozaki_conv2d(_t(a), _t(b), out).numpy()
    norm = np.max(np.abs(want), axis=0, keepdims=True)
    norm = np.maximum(norm, np.max(np.abs(want)) * 1e-12)
    assert float(np.max(np.abs(got - want) / norm)) < 1e-12
    ref = np.asarray(J.ozaki_conv2d(jnp.asarray(a), jnp.asarray(b), out))
    assert float(np.max(np.abs(got - ref) / norm)) < 1e-12


def _poisson_pmf(lam: float, n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    logfact = np.concatenate([[0.0], np.cumsum(np.log(k[1:]))])
    return np.exp(-lam + k * np.log(lam) - logfact)


def test_componentwise_cliff_poisson_tail():
    """genfer_tpu's cliff test: the normwise guarantee holds, entries with
    real mass keep their digits, and the deep tail loses relative
    accuracy (a property of the method, not of the port)."""
    n = 128
    a = np.stack([_poisson_pmf(lam, n) for lam in (6.0, 8.0, 11.0)], axis=1)
    b = np.stack([_poisson_pmf(lam, n) for lam in (7.0, 9.0, 13.0)], axis=1)
    out = (2 * n - 1, 5)
    want = np.asarray(HOST.conv_trunc(a, b, out))
    got = Z.ozaki_conv2d(_t(a), _t(b), out).numpy()
    scale = np.max(a) * np.max(b) * n
    assert float(np.max(np.abs(got - want))) < 1e-13 * scale
    mask = want >= 1e-8 * want.max()
    assert float((np.abs(got[mask] - want[mask]) / want[mask]).max()) < 1e-6
    mask9 = want >= 1e-3 * want.max()
    assert float((np.abs(got[mask9] - want[mask9])
                  / want[mask9]).max()) < 1e-11
    tail = (want > 0) & (want < 1e-25 * want.max())
    assert tail.any()
    assert float((np.abs(got[tail] - want[tail]) / want[tail]).max()) > 1e-4


def test_guard_propagates_nonfinite():
    """Non-finite coefficients take K1's IEEE branch (its plain version
    here): NaN where host f64 has NaN, the rest within 1e-13."""
    rng = np.random.RandomState(0)
    b = rng.rand(16, 16)
    Z.reset_launches()
    for poison in (np.inf, -np.inf, np.nan):
        a = rng.rand(16, 16)
        a[3, 5] = poison
        got = Z.ozaki_conv2d(_t(a), _t(b), (31, 31)).numpy()
        want = np.asarray(HOST.conv_trunc(a, b, (31, 31)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        np.testing.assert_allclose(got[m], want[m], rtol=1e-13)
        dense = T._conv_dense(_t(a), _t(b), (31, 31)).numpy()
        np.testing.assert_array_equal(got, dense)
    assert Z.guarded_count() == 3
    Z.ozaki_conv2d(_t(b), _t(b), (31, 31))
    assert Z.guarded_count() == 3


def test_zero_operands_and_zero_columns():
    rng = np.random.RandomState(1)
    a = np.zeros((32, 32))
    b = rng.rand(32, 32)
    assert np.all(Z.ozaki_conv2d(_t(a), _t(b), (40, 40)).numpy() == 0.0)
    a = rng.rand(32, 32)
    a[:, 10:20] = 0.0  # zero columns exercise the all-zero scale branch
    want = HOST.conv_trunc(a, b, (40, 40))
    got = Z.ozaki_conv2d(_t(a), _t(b), (40, 40)).numpy()
    assert _rel_err(got, want) < 5e-14


def test_extreme_column_scales_handled_natively():
    """Column scales at the ends of the f64 range, and the mixed case
    whose exponent sum only is in range (genfer_tpu's test)."""
    b = np.ones((16, 2))
    for mag in (2.0 ** 950, 2.0 ** -980, 1.0):
        a = np.full((16, 2), mag)
        got = Z.ozaki_conv2d(_t(a), _t(b), (16, 3)).numpy()
        want = np.asarray(HOST.conv_trunc(a, b, (16, 3)))
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=str(mag))
    a = np.full((16, 2), 2.0 ** -980)
    b2 = np.full((16, 2), 2.0 ** 300)
    got = Z.ozaki_conv2d(_t(a), _t(b2), (16, 3)).numpy()
    np.testing.assert_allclose(got, HOST.conv_trunc(a, b2, (16, 3)),
                               rtol=1e-12)


def test_subnormal_column_max_is_scaled_exactly():
    """A column whose max is subnormal (the first product the forced
    two_populations(2000) run routes has one: 1.3742156653705e-310 against
    b's 3.38e17): 2^-e overflows, so genfer_tpu's ``a * exp2(-ea)`` would
    make the chunks of inf on an IEEE device (on the CPU XLA flushes the
    column to zero instead); the port scales it in two exact steps and
    gives host f64's product (ROADMAP Queue 3)."""
    jnp, J = _jax()
    a = np.array([[1.3742156653705e-310, 0.5, 2.0 ** -1060]])
    # one binade of b: no entry below its column's scale (the cliff)
    b = np.array([[3.381856751457401e17], [2.0 ** 58], [1.5 * 2.0 ** 57],
                  [2.0 ** 58 + 2.0 ** 20]])
    out = (4, 3)
    e = Z._pow2_colexp(_t(a)).numpy()
    assert e[0] == -1028 and e[2] == -1059
    chunks, _, _ = Z.ozaki_split_reference(_t(a))
    assert np.isfinite(chunks.double().numpy()).all()
    want = HOST.conv_trunc(a, b, out)
    got = Z.ozaki_conv2d(_t(a), _t(b), out).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-16)
    assert want[0, 0] == pytest.approx(4.6474005258916773e-293, rel=1e-15)
    ref = np.asarray(J.ozaki_conv2d(jnp.asarray(a), jnp.asarray(b), out))
    assert ref[0, 0] == 0.0  # XLA on the CPU: the subnormal reads as 0


def test_bf16_group_fold_contraction_cap():
    """MAX_K_BF16 stays 512, the wrapper refuses a longer contraction for
    bf16 and ozaki_applicable respects the impl's cap."""
    assert Z.MAX_K_BF16 == 512 and Z.OZAKI_MAX_K == Z.MAX_K_INT8 == 1 << 16
    a, b = torch.rand(4, 2, dtype=torch.float64), torch.rand(
        513, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="513 > 512"):
        Z.ozaki_conv2d(a, b, (4, 3), impl="bf16")
    with _env(**FORCE, GENFER_OZAKI_MAX_BYTES="1e18",
              GENFER_OZAKI_IMPL="bf16"):
        assert not Z.ozaki_applicable("float64", (4096, 2), (4096, 2),
                                      (4096, 3), 1e12)
        os.environ["GENFER_OZAKI_IMPL"] = "int8"
        assert Z.ozaki_applicable("float64", (4096, 2), (4096, 2),
                                  (4096, 3), 1e12)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.rand(8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="impl"):
        Z.ozaki_conv2d(a, a, (8, 8), impl="fp8")
    with pytest.raises(ValueError, match="pair_bits"):
        Z.ozaki_conv2d(a, a, (8, 8), pair_bits=15)
    with pytest.raises(TypeError):
        Z.ozaki_conv2d(a.float(), a.float(), (8, 8))
    with pytest.raises(ValueError):
        Z.ozaki_conv2d(a[None], a[None], (8, 8))
    assert Z.pair_passes(7) == 36 and Z.pair_passes(6) == 28
    assert Z.pair_passes(5) == 21


# ---------------------------------------------------------------- routing

class TestRouting:
    def test_platform_gate_default_off_on_cpu(self, monkeypatch):
        """Unset, ``1`` or a number ask for a TPU: never in the port."""
        for mode in (None, "1", "1e3"):
            if mode is None:
                monkeypatch.delenv("GENFER_OZAKI", raising=False)
            else:
                monkeypatch.setenv("GENFER_OZAKI", mode)
            assert not Z.ozaki_applicable(
                "float64", (512, 512), (512, 512), (1023, 1023), 1e12)

    def test_force_enables_on_cpu(self, monkeypatch):
        monkeypatch.setenv("GENFER_OZAKI", "force")
        monkeypatch.setenv("GENFER_OZAKI_MIN_FLOPS", "0")
        assert Z.ozaki_applicable("float64", (64, 64), (64, 64), (127, 127),
                                  1e6)

    def test_disabled(self, monkeypatch):
        monkeypatch.setenv("GENFER_OZAKI", "0")
        assert not Z.ozaki_applicable("float64", (512, 512), (512, 512),
                                      (1023, 1023), 1e12)

    def test_dtype_and_rank_gates(self, monkeypatch):
        monkeypatch.setenv("GENFER_OZAKI", "force")
        monkeypatch.setenv("GENFER_OZAKI_MIN_FLOPS", "0")
        assert not Z.ozaki_applicable("float32", (64, 64), (64, 64),
                                      (127, 127), 1e6)
        assert not Z.ozaki_applicable("float64", (64, 64, 2), (64, 64, 2),
                                      (127, 127, 3), 1e6)

    def test_flops_crossover(self, monkeypatch):
        monkeypatch.setenv("GENFER_OZAKI", "force")
        monkeypatch.setenv("GENFER_OZAKI_MIN_FLOPS", "1e9")
        assert not Z.ozaki_applicable("float64", (64, 64), (64, 64),
                                      (127, 127), 1e8)
        assert Z.ozaki_applicable("float64", (64, 64), (64, 64), (127, 127),
                                  2e9)
        monkeypatch.delenv("GENFER_OZAKI_MIN_FLOPS")
        assert Z._min_flops() == Z.OZAKI_MIN_FLOPS_DEFAULT == 6e8

    def test_memory_estimate_and_cap(self, monkeypatch):
        """The estimate is K5's own buffers: chunks, exponents, output and
        workspace slots; the cap routes on it."""
        monkeypatch.setenv("GENFER_OZAKI", "force")
        monkeypatch.setenv("GENFER_OZAKI_MIN_FLOPS", "0")
        sa = sb = (640, 640)
        for out in ((640, 640), (1279, 1279)):
            for pb, impl, elem in ((7, "int8", 1), (5, "bf16", 2)):
                slots = Z.plan(sa, sb, out).slots
                want = (min(8, pb + 1) * 2 * 640 * 640 * elem
                        + 4 * 1280 + 8 * out[0] * out[1]
                        + 8 * slots * 64 * 64)
                assert Z.estimate_bytes(sa, sb, out, pb, impl) == want
        est = Z.estimate_bytes(sa, sb, (1279, 1279))
        assert est < Z.OZAKI_MAX_BYTES_DEFAULT
        assert Z.ozaki_applicable("float64", sa, sb, (1279, 1279), 1e12)
        monkeypatch.setenv("GENFER_OZAKI_MAX_BYTES", str(est - 1))
        assert not Z.ozaki_applicable("float64", sa, sb, (1279, 1279), 1e12)

    def test_contraction_cap(self, monkeypatch):
        monkeypatch.setenv("GENFER_OZAKI", "force")
        monkeypatch.setenv("GENFER_OZAKI_MIN_FLOPS", "0")
        monkeypatch.setenv("GENFER_OZAKI_MAX_BYTES", "1e18")
        k = Z.OZAKI_MAX_K + 1
        assert not Z.ozaki_applicable("float64", (k, 2), (k, 2), (k, 3),
                                      1e12)
        assert not Z.ozaki_applicable("float64", (k, 2), (4, 2), (k, 3),
                                      1e12)

    def test_route_reads_the_environment_on_every_call(self, monkeypatch):
        """Nothing is cached across calls (genfer_tpu keys its compile
        cache on these variables; the port compiles nothing): the gate and
        the guarded entry's pair_bits and impl follow each change."""
        rng = np.random.default_rng(9)
        a, b = _t(rng.random((24, 24))), _t(rng.random((24, 24)))
        monkeypatch.setenv("GENFER_OZAKI", "force")
        monkeypatch.setenv("GENFER_OZAKI_MIN_FLOPS", "0")
        assert Z.ozaki_applicable("float64", (24, 24), (24, 24), (24, 24), 1)
        got = {}
        for pb, impl in ((5, "int8"), (7, "int8"), (7, "bf16")):
            monkeypatch.setenv("GENFER_OZAKI_PAIR_BITS", str(pb))
            monkeypatch.setenv("GENFER_OZAKI_IMPL", impl)
            got[pb, impl] = Z.ozaki_conv2d_guarded(a, b, (24, 24))
            assert torch.equal(got[pb, impl],
                               Z.ozaki_conv2d(a, b, (24, 24), pb, impl))
        assert not torch.equal(got[5, "int8"], got[7, "int8"])
        monkeypatch.setenv("GENFER_OZAKI", "0")
        assert not Z.ozaki_applicable("float64", (24, 24), (24, 24),
                                      (24, 24), 1)


# ------------------------------------------------- the backend and the CLI

@pytest.mark.parametrize("sa,sb,out", [
    ((80, 80), (80, 80), (120, 120)),
    ((1, 48, 1, 48), (1, 48, 1, 48), (1, 70, 1, 70)),
])
def test_routed_backend_matches_genfer_tpu(monkeypatch, sa, sb, out):
    """``TorchF64Backend(device="cpu").conv_trunc`` under force takes the
    route (2 effective axes, squeezed and reshaped back) and equals
    ``JaxF64Backend``'s under force within 1e-14 of each column's max
    (XLA's exp2; module docstring), both within 5e-14 of host."""
    from genfer_tpu.taylor.backend import JaxF64Backend

    jnp, _ = _jax()
    for k, v in FORCE.items():
        monkeypatch.setenv(k, v)
    calls = []
    real = Z.ozaki_conv2d_guarded
    monkeypatch.setattr(Z, "ozaki_conv2d_guarded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(5)
    a, b = rng.rand(*sa), rng.rand(*sb)
    got = T.TorchF64Backend(device="cpu").conv_trunc(_t(a), _t(b),
                                                     out).numpy()
    assert calls and got.shape == out
    want = np.asarray(JaxF64Backend().conv_trunc(jnp.asarray(a),
                                                 jnp.asarray(b), out))
    host = HOST.conv_trunc(a, b, out)
    assert _rel_err(got, host) < 5e-14 and _rel_err(want, host) < 5e-14
    squeeze = [s for s in out if s > 1]
    assert _col_err(got.reshape(squeeze), want.reshape(squeeze)) < 1e-14


def test_default_env_keeps_k1(monkeypatch):
    """Without force the backend's products never reach the route."""
    monkeypatch.delenv("GENFER_OZAKI", raising=False)
    monkeypatch.setattr(Z, "ozaki_conv2d_guarded",
                        lambda *a, **k: pytest.fail("the route ran"))
    x = torch.rand(40, 40, dtype=torch.float64)
    T.TorchF64Backend(device="cpu").conv_trunc(x, x, (40, 40))


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def test_cli_backend_jax_under_force_matches_genfer_tpu(monkeypatch):
    """``--backend jax`` on two_populations(10) (seed 3) with the route
    forced: every 2-axis f64 product takes it, and the printed results
    agree with genfer_tpu's forced run at is_close (Z at rel 1e-9 of
    itself, ``printed.disagreements``) and with the port's host f64 run."""
    import genfer_tpu.cli as jcli
    import genfer_tpu.tools.generators as jgen
    from genfer_tpu.lang.parser import parse_program as jparse

    for k, v in FORCE.items():
        monkeypatch.setenv(k, v)
    calls = []
    real = Z.ozaki_conv2d_guarded
    monkeypatch.setattr(Z, "ozaki_conv2d_guarded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    text = jgen.generate_two_populations(None, 10, seed=3)
    args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--backend", "jax"])
    port = read_results(_printed(cli.run, tparse(text), args, device="cpu"))
    assert calls
    ref = read_results(_printed(jcli.run, jparse(text), args))
    assert set(port) == set(ref) and "Z" in port
    assert not disagreements(port, ref)
    host_args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--backend", "numpy"])
    host = read_results(_printed(cli.run, tparse(text), host_args))
    assert not disagreements(port, host)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", Z.IMPLS)
def test_kernel_against_plain_on_card(card, impl):
    """K5 against its plain version on the card at SHAPES (the dense body)
    and at small-body shapes, pair_bits 5 to 7, within 1e-13 of each
    output column's max, the same bits twice; a batch equal to its
    entries' single calls; the split equal to the CPU split bit for bit."""
    rng = np.random.default_rng(11)
    shapes = SHAPES + [((70, 66), (2, 2), (70, 66)),
                       ((3, 5), (40, 37), (41, 40))]
    view = torch.int8 if impl == "int8" else torch.int16
    for sa, sb, out in shapes:
        a, b = _t(rng.random(sa)).to(card), _t(rng.random(sb)).to(card)
        got_split = Z.ozaki_split(a[None], b[None], 7, impl)
        want_split = Z.ozaki_split_batched_reference(a[None].cpu(),
                                                     b[None].cpu(), 7, impl)
        for g, w in zip(got_split, want_split):
            if g.dtype in (torch.int8, torch.bfloat16):
                g, w = g.view(view), w.view(view)
            assert torch.equal(g.cpu(), w)
        for pb in (5, 6, 7):
            got = Z.ozaki_conv2d(a, b, out, pb, impl)
            assert torch.equal(got, Z.ozaki_conv2d(a, b, out, pb, impl))
            want = Z.ozaki_conv2d_reference(a, b, out, pb, impl)
            assert _col_err(got.cpu().numpy(), want.cpu().numpy()) < 1e-13
        batch = Z.ozaki_conv2d_batched(torch.stack([a, a.flip(0)]),
                                       torch.stack([b, b]), out, 7, impl)
        assert torch.equal(batch[0], Z.ozaki_conv2d(a, b, out, 7, impl))
        assert torch.equal(batch[1], Z.ozaki_conv2d(a.flip(0).contiguous(),
                                                    b, out, 7, impl))


@pytest.mark.cuda
def test_guard_on_card(card):
    """A non-finite operand: K5 launches once with the split, its blocks of
    the flagged product write nothing, the guard counts it on the device,
    and the result is K1's bit for bit; no host synchronize."""
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64

    rng = np.random.default_rng(12)
    a, b = _t(rng.random((40, 40))).to(card), _t(rng.random((40, 40))).to(card)
    a[3, 5] = float("nan")
    Z.reset_launches()
    got = Z.ozaki_conv2d(a, b, (60, 60))
    assert Z.ozaki_conv2d.launches == 1 and Z.ozaki_split.launches == 1
    assert Z.guarded_count() == 1
    want = conv2d_trunc_f64(a, b, (60, 60))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])


@pytest.mark.cuda
def test_float_split_raises_on_card(card, monkeypatch):
    """The split kernel runs the integer split only: the float split is
    refused on the card, never taken from the plain version."""
    x = _t(np.random.default_rng(13).random((16, 16))).to(card)
    monkeypatch.setenv("GENFER_OZAKI_CHUNK", "float")
    Z.reset_launches()
    with pytest.raises(NotImplementedError, match="integer split"):
        Z.ozaki_conv2d(x, x, (16, 16))
    assert Z.ozaki_split.launches == 0 and Z.ozaki_conv2d.launches == 0
