"""The one-pass mode (``highest=False``) of the port's four f32 2-D
wrappers: K2 ``conv2d_trunc_f32``, K4a ``conv2d_trunc_f32_tile``, K4b
``conv2d_trunc_f32_grouped`` and K3 ``conv2d_trunc_f32_batched``, the
twins of genfer_tpu's Pallas kernels at ``highest=False``.

On the CPU each wrapper runs its plain version: the f32 product of
``tf32_round(a)`` and ``tf32_round(b)``.  Its bar against f64 is the
one-pass bound, elementwise

    |got - exact| <= (2^-10 + RTOL) * (|a| * |b|)[k] + ATOL

(``*`` the truncated product): 2^-10 covers the two TF32 roundings (2u +
u^2, u = 2^-11), RTOL = 5e-5 / ATOL = 1e-6 the three-pass bar of the
Pallas tests, which covers the f32 sums.  genfer_tpu's ``highest=False``
run on the CPU is not one pass: XLA's CPU dot ignores
``Precision.DEFAULT`` and its result is the f32 product, so the port is
held to it at the same bound with 2 RTOL.  The kernels themselves run in
the ``cuda``-marked tests at the end: against their plain version at the
three-pass bar (the two differ by the order of f32 sums only), against
f64 at the one-pass bound, the same bits twice, and never equal to the
three-pass result.  (The kernels' arithmetic is emulated in
tests/test_torch_mma.py.)
"""

import numpy as np
import pytest
import torch

from genfer_tpu_torch import ops
from genfer_tpu_torch.ops import conv2d as C

RTOL, ATOL = 5e-5, 1e-6
ONE_PASS = 2.0 ** -10

# tests/test_parallel_ops.py's shapes up to (70, 80), with their seeds:
# the row strip's (RandomState(13)), the batch's (RandomState(11)) and
# the swapped batch's (RandomState(12)), drawn in order
ROWSTRIP_SHAPES = [
    ((5, 7), (4, 6), (8, 12)),
    ((70, 80), (60, 50), (70, 80)),
]
BATCHED = [
    (3, (5, 7), (4, 6), (8, 12)),
    (4, (70, 80), (60, 50), (70, 80)),
]
SWAPPED = [
    (3, (5, 7), (4, 6), (8, 12)),
    (4, (70, 80), (60, 50), (70, 80)),
]
SINGLE = (ops.conv2d_trunc_f32, ops.conv2d_trunc_f32_tile,
          ops.conv2d_trunc_f32_grouped)


def _rowstrip_operands(i):
    rng = np.random.RandomState(13)
    for sa, sb, _ in ROWSTRIP_SHAPES[: i + 1]:
        a, b = rng.rand(*sa), rng.rand(*sb)
    return a, b


def _batched_operands(i):
    rng = np.random.RandomState(11)
    for nbatch, sa, sb, _ in BATCHED[: i + 1]:
        a, b = rng.rand(nbatch, *sa), rng.rand(*sb)
    return a, b


def _swapped_operands(i):
    rng = np.random.RandomState(12)
    for nbatch, sa, sb, _ in SWAPPED[: i + 1]:
        a, b = rng.rand(*sa), rng.rand(nbatch, *sb)
    return a, b


def _f32(x):
    return torch.from_numpy(np.ascontiguousarray(x)).float()


def _exact(a, b, out):
    """The f64 product of the f32 operands, and that of their absolute
    values."""
    from genfer_tpu.taylor.backend import NumpyF64Backend

    a32 = np.asarray(a, dtype=np.float32).astype(np.float64)
    b32 = np.asarray(b, dtype=np.float32).astype(np.float64)
    nb = NumpyF64Backend()
    return (nb.conv_trunc(a32, b32, out),
            nb.conv_trunc(np.abs(a32), np.abs(b32), out))


def _within(got, want, absprod, rtol=RTOL, atol=ATOL):
    """The one-pass bound, elementwise; its worst share on failure."""
    bar = (ONE_PASS + rtol) * absprod + atol
    diff = np.abs(np.asarray(got, dtype=np.float64) - want)
    assert (diff <= bar).all(), float((diff / bar).max())


# --------------------------------------------------------- tf32_round


def cvt_rna(x):
    """``cvt.rna.tf32.f32`` on finite f32 values, from its definition:
    round |x| to a multiple of its TF32 quantum (2^(e - 10) for x in
    [2^e, 2^(e+1)), and 2^-136 below f32's normal range, where the f32
    subnormal grid of 2^-149 keeps its top 10 bits), to nearest, ties
    away from zero, in f64 (exact at these sizes)."""
    x64 = np.asarray(x, dtype=np.float32).astype(np.float64)
    mag = np.abs(x64)
    _, e = np.frexp(mag)  # mag = m 2^e, m in [0.5, 1)
    quantum = np.ldexp(1.0, np.maximum(e - 11, -136))
    q = np.floor(mag / quantum + 0.5) * quantum
    with np.errstate(over="ignore"):
        return np.copysign(q, x64).astype(np.float32)


def _words(n, rng):
    """``n`` random finite f32 words of either sign, every exponent."""
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    x = w.view(np.float32)
    return x[np.isfinite(x)]


def _ties(rng):
    """Values exactly half a TF32 unit above a TF32 value, normal and
    subnormal, of either sign: the low 13 bits 0x1000."""
    w = (rng.integers(0, 1 << 19, 512, dtype=np.uint64).astype(np.uint32)
         << 13) | np.uint32(0x1000)
    x = w.view(np.float32)
    x = x[np.isfinite(x)]
    return np.concatenate([x, -x])


@pytest.mark.parametrize("kind", ["words", "ties", "zeros", "subnormals"])
def test_tf32_round_is_cvt_rna(kind):
    rng = np.random.default_rng({"words": 1, "ties": 2, "zeros": 3,
                                 "subnormals": 4}[kind])
    if kind == "words":
        x = _words(1 << 16, rng)
    elif kind == "ties":
        x = _ties(rng)
    elif kind == "zeros":
        x = np.array([0.0, -0.0], dtype=np.float32)
    else:
        w = rng.integers(1, 1 << 23, 4096, dtype=np.uint64).astype(np.uint32)
        x = np.concatenate([w.view(np.float32), -w.view(np.float32)])
    got = C.tf32_round(torch.from_numpy(x)).numpy()
    want = cvt_rna(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # 10 stored mantissa bits: the 13 low bits of every finite word clear
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    if kind == "ties":
        assert (np.abs(got) > np.abs(x)).all()  # away from zero


@pytest.mark.parametrize("sa,sb", [((5, 7), (4, 6)), ((3, 70, 67), (64, 8)),
                                   ((64, 8), (2, 70, 80)), ((9, 12), (1, 9))])
def test_round_operands_on_cpu_is_the_plain_rounding(monkeypatch, sa, sb):
    """``tf32_round_operands`` on the CPU: ``tf32_round`` of each operand,
    its rows padded with zeros to a multiple of 4 words; no launch."""
    monkeypatch.setattr(C.tf32_round_operands, "launches", 0)
    rng = np.random.default_rng(len(sa) + sa[-1])
    a, b = _f32(rng.standard_normal(sa)), _f32(rng.standard_normal(sb))
    for x, rx in zip((a, b), C.tf32_round_operands(a, b)):
        n = x.shape[-1]
        assert rx.shape == (*x.shape[:-1], -(-n // 4) * 4)
        assert torch.equal(rx[..., :n], C.tf32_round(x))
        assert not rx[..., n:].any()
    assert C.tf32_round_operands.launches == 0


def test_tf32_round_passes_infinities_and_nans():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    got = C.tf32_round(x)
    assert got[0] == float("inf") and got[1] == -float("inf")
    assert torch.isnan(got[2])
    with pytest.raises(TypeError):
        C.tf32_round(x.double())


# ---------------------------------------------- against genfer_tpu


@pytest.mark.parametrize("kernel", SINGLE, ids=lambda k: k.__name__)
def test_single_pair_matches_pallas_default(kernel):
    """Each single-pair wrapper at ``highest=False`` against its Pallas
    twin at ``highest=False`` in interpret mode (f32 on the CPU) at the
    one-pass bound with 2 RTOL, and against f64 at the one-pass bound."""
    import jax.numpy as jnp

    from genfer_tpu.ops.pallas_conv2d import (
        conv2d_pallas_grouped,
        conv2d_pallas_rowstrip,
        conv2d_pallas_tile,
    )

    pallas = {ops.conv2d_trunc_f32: conv2d_pallas_rowstrip,
              ops.conv2d_trunc_f32_tile: conv2d_pallas_tile,
              ops.conv2d_trunc_f32_grouped: conv2d_pallas_grouped}[kernel]
    sa, sb, out = ROWSTRIP_SHAPES[0]
    a, b = _rowstrip_operands(0)
    ref = np.asarray(pallas(jnp.asarray(a), jnp.asarray(b), out,
                            interpret=True, highest=False))
    got = kernel(_f32(a), _f32(b), out, highest=False).numpy()
    assert got.shape == out and got.dtype == np.float32
    want, absprod = _exact(a, b, out)
    _within(got, want, absprod)
    _within(got, ref, absprod, rtol=2 * RTOL)


def test_batched_matches_pallas_default():
    import jax.numpy as jnp

    from genfer_tpu.ops.pallas_conv2d import conv2d_pallas_batched

    nbatch, sa, sb, out = BATCHED[0]
    a, b = _batched_operands(0)
    ref = np.asarray(conv2d_pallas_batched(jnp.asarray(a), jnp.asarray(b),
                                           out, interpret=True,
                                           highest=False))
    got = ops.conv2d_trunc_f32_batched(_f32(a), _f32(b), out,
                                       highest=False).numpy()
    assert got.shape == (nbatch, *out) and got.dtype == np.float32
    for g in range(nbatch):
        want, absprod = _exact(a[g], b, out)
        _within(got[g], want, absprod)
        _within(got[g], ref[g], absprod, rtol=2 * RTOL)


# --------------------------------------------------- against host f64


@pytest.mark.parametrize("i", range(len(ROWSTRIP_SHAPES)))
@pytest.mark.parametrize("kernel", SINGLE, ids=lambda k: k.__name__)
def test_single_pair_holds_the_one_pass_bound(kernel, i):
    """Against host f64 at the one-pass bound; and not the three-pass
    product: it differs from that by more than 1e-5 relative somewhere,
    which f32's sums alone never reach on these shapes."""
    sa, sb, out = ROWSTRIP_SHAPES[i]
    a, b = _rowstrip_operands(i)
    got = kernel(_f32(a), _f32(b), out, highest=False).numpy()
    want, absprod = _exact(a, b, out)
    _within(got, want, absprod)
    three = kernel(_f32(a), _f32(b), out).numpy()
    assert (np.abs(got - three) > 1e-5 * np.abs(three)).any()


@pytest.mark.parametrize("i", range(len(BATCHED)))
@pytest.mark.parametrize("swapped", [False, True])
def test_batched_holds_the_one_pass_bound(i, swapped):
    """Either operand batched, against host f64 at the one-pass bound;
    every entry the single-pair plain version's (operands in the batched
    call's order), bit for bit."""
    if swapped:
        nbatch, sa, sb, out = SWAPPED[i]
        a, bs = _swapped_operands(i)
        got = ops.conv2d_trunc_f32_batched(_f32(bs), _f32(a), out,
                                           highest=False).numpy()
        pairs = [(bs[g], a) for g in range(nbatch)]
    else:
        nbatch, sa, sb, out = BATCHED[i]
        as_, b = _batched_operands(i)
        got = ops.conv2d_trunc_f32_batched(_f32(as_), _f32(b), out,
                                           highest=False).numpy()
        pairs = [(as_[g], b) for g in range(nbatch)]
    for g, (x, y) in enumerate(pairs):
        want, absprod = _exact(x, y, out)
        _within(got[g], want, absprod)
        single = ops.conv2d_trunc_f32(_f32(x), _f32(y), out,
                                      highest=False).numpy()
        assert np.array_equal(got[g], single)


def test_reference_rounds_both_operands():
    """The plain one-pass version is the f32 product of the rounded
    operands, whichever operand is the larger."""
    rng = np.random.default_rng(3)
    a, b = _f32(rng.random((9, 11))), _f32(rng.random((13, 4)))
    out = (15, 12)
    got = C.conv2d_trunc_f32_reference(a, b, out, highest=False)
    want = C.conv2d_trunc_f32_reference(C.tf32_round(a), C.tf32_round(b),
                                        out)
    assert torch.equal(got, want)
    assert torch.equal(C.conv2d_trunc_f32_reference(b, a, out, highest=False),
                       C.conv2d_trunc_f32_reference(C.tf32_round(b),
                                                    C.tf32_round(a), out))


@pytest.mark.parametrize("wrapper,args", [
    (ops.conv2d_trunc_f32, ((6, 5), (4, 3), (6, 5))),
    (ops.conv2d_trunc_f32_tile, ((6, 5), (4, 3), (6, 5))),
    (ops.conv2d_trunc_f32_grouped, ((6, 5), (4, 3), (6, 5))),
    (ops.conv2d_trunc_f32_batched, ((2, 6, 5), (4, 3), (6, 5))),
])
def test_one_pass_on_cpu_launches_nothing(monkeypatch, wrapper, args):
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "launches_1pass", 0)
    sa, sb, out = args
    wrapper(torch.rand(*sa), torch.rand(*sb), out, highest=False)
    assert wrapper.launches == 0 and wrapper.launches_1pass == 0


# ---------------------------------------------------- issued flops


def _brute_ffma(plan, cj):
    """The FFMA body's loops (``csrc/conv2d_unit.cuh``), counted: every
    (unit, chunk, stream step s, row class i < TM = 4) whose j0 = s + i
    lies in the unit's range (every one for CJ = 1, which has no branch)
    issues CJ multiply-adds for each of the TILE^2 / TM outputs in the
    rows m = i mod TM of the tile."""
    total = 0
    for K0, K1, lo0, hi0, lo1, hi1, *_ in plan.units.tolist():
        for _jb in range(lo1 & ~3, hi1, cj):
            for s in range(lo0 - 3, hi0):
                for i in range(4):
                    if cj == 1 or lo0 <= s + i < hi0:
                        total += cj * (C.TILE * C.TILE // 4)
    return total


def _brute_mma(plan, a_shape, b_shape):
    """The one-pass wgmma body's loops (``csrc/conv2d_wgmma.cuh``),
    counted: its stages stage 64 of a's columns at a time from the first
    one whose band meets the unit's j1 range (some output column n < TILE
    and j1 in range with K1 + n - i1 = j1) rounded down to 4, up to the
    last such column; every j0 of the unit at which some of the tile's 64
    window rows lies in a issues, in each stage, a tile of multiply-adds
    for each of the 8 columns of every k-step that holds such a column."""
    (a0, a1) = b_shape if plan.swap else a_shape
    total = 0
    for K0, K1, lo0, hi0, lo1, hi1, *_ in plan.units.tolist():
        band = [i1 for i1 in range(a1)
                if any(lo1 <= K1 + n - i1 < hi1 for n in range(C.TILE))]
        live_j0 = sum(1 for j0 in range(lo0, hi0)
                      if any(0 <= K0 + m - j0 < a0 for m in range(C.TILE)))
        first = band[0] // 4 * 4
        steps = 0
        for i1_0 in range(first, band[-1] + 1, 64):
            steps += sum(1 for ks in range(8)
                         if any(i1_0 + 8 * ks <= i1 < i1_0 + 8 * ks + 8
                                for i1 in band))
        total += live_j0 * steps * 8 * C.TILE * C.TILE
    return total


@pytest.mark.parametrize("sa,sb,out", [
    ((5, 7), (4, 6), (8, 12)),
    ((70, 80), (60, 50), (70, 80)),
    ((1, 130), (130, 1), (130, 130)),
    ((95, 1), (95, 87), (95, 87)),
    ((16, 5), (3, 40), (10, 12)),
    ((200, 150), (150, 100), (280, 200)),
    ((130, 133), (120, 9), (130, 130)),
    ((70, 67), (64, 8), (70, 70)),
])
@pytest.mark.parametrize("highest", [True, False])
def test_rowstrip_issued_flops_counts_the_kernels(sa, sb, out, highest):
    plan = C.unit_plan(sa, sb, out, highest)
    kb1 = (sa if plan.swap else sb)[1]
    if highest:
        macs = _brute_ffma(plan, 1 if kb1 == 1 else C.CHUNK)
    elif kb1 < C.MMA_MIN_COLS:
        macs = _brute_ffma(plan, 1 if kb1 == 1 else 8)
    else:
        macs = _brute_mma(plan, sa, sb)
    assert C.rowstrip_issued_flops(sa, sb, out, highest) == 2.0 * macs
    # never fewer than the useful multiply-adds
    from genfer_tpu.taylor.backend import NumpyF64Backend

    useful = NumpyF64Backend().conv_trunc(np.ones(sa), np.ones(sb), out).sum()
    assert 2.0 * macs >= 2.0 * useful


class _Entries:
    """A stand-in for the kernel library that records each entry's
    arguments and accepts every launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _fake_card(monkeypatch):
    """Run the wrappers' card path on CPU tensors against ``_Entries``."""
    lib = _Entries()
    monkeypatch.setattr(C, "_on_card", lambda t: True)
    monkeypatch.setattr(C._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("wrapper,sa,sb,scratch", [
    # (a0, a1), (b0, b1): the kernel's b is the smaller operand
    (ops.conv2d_trunc_f32_tile, (70, 67), (64, 9), 70 * 68 + 64 * 12),
    (ops.conv2d_trunc_f32, (60, 50), (70, 81), 60 * 52 + 70 * 84),
    (ops.conv2d_trunc_f32_tile, (95, 87), (95, 1), 0),
    (ops.conv2d_trunc_f32, (16, 5), (3, 40), 0),
    (ops.conv2d_trunc_f32_grouped, (70, 67), (64, 9), 70 * 68 + 64 * 12),
    (ops.conv2d_trunc_f32_grouped, (60, 50), (70, 81), 60 * 52 + 70 * 84),
    (ops.conv2d_trunc_f32_grouped, (95, 87), (95, 1), 0),
    (ops.conv2d_trunc_f32_grouped, (16, 5), (3, 40), 0),
])
def test_one_pass_tile_entry_gets_its_scratch(monkeypatch, wrapper, sa, sb,
                                              scratch):
    """The one-pass tile and grouped entries' arguments: b's row count
    and a pointer into the call's one workspace allocation, past its slot
    tiles, with room for both operands' rows padded to 4 words where the
    kernel's b has 8 or more columns (the entry rounds them there: one
    rounding launch counted); a null pointer for a thinner b, and no
    count."""
    lib = _fake_card(monkeypatch)
    monkeypatch.setattr(C.tf32_round_operands, "launches", 0)
    sizes = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s, **k: sizes.append(s)
                        or real_empty(*s, **k))
    out = (max(sa[0], sb[0]), max(sa[1], sb[1]))
    wrapper(torch.rand(*sa), torch.rand(*sb), out, highest=False)
    (name, args), = lib.calls
    assert name == ("conv2d_trunc_f32_grouped_1pass"
                    if wrapper is ops.conv2d_trunc_f32_grouped
                    else "conv2d_trunc_f32_tile_1pass")
    plan = C.unit_plan(sa, sb, out, False)
    kb = sa if plan.swap else sb
    assert args[9:11] == ((sb if plan.swap else sa)[1], kb[1])
    b0, ptr = args[-2:]
    assert b0 == kb[0]
    slot_words = plan.slots * C.TILE * C.TILE
    if scratch:
        assert ptr == args[3] + 4 * slot_words
        assert (slot_words + scratch,) in sizes
    else:
        assert ptr == 0
    assert C.tf32_round_operands.launches == (1 if scratch else 0)


@pytest.mark.parametrize("swap", [False, True])
def test_one_pass_batched_entry_gets_its_scratch(monkeypatch, swap):
    """K3's one-pass entry: the operands' own strides (the entry derives
    the rounded ones), b's row count, and a scratch pointer past the
    batch's slot tiles with room for the batched operand's rows and the
    shared one's, padded to 4 words; one rounding launch counted."""
    lib = _fake_card(monkeypatch)
    monkeypatch.setattr(C.tf32_round_operands, "launches", 0)
    sizes = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s, **k: sizes.append(s)
                        or real_empty(*s, **k))
    batch, sa, sb, out = 3, (70, 67), (64, 9), (70, 70)
    if swap:  # the batch as the kernel's b
        sa, sb = sb, sa
    a, b = torch.rand(batch, *sa), torch.rand(*sb)
    ops.conv2d_trunc_f32_batched(a, b, out, highest=False)
    (name, args), = lib.calls
    assert name == "conv2d_trunc_f32_batched_1pass"
    plan = C.unit_plan(sa, sb, out, False)
    assert plan.swap == swap
    ka, kb = (b, a) if swap else (a, b)
    strides = args[9:11]
    assert strides == ((0, 64 * 9) if swap else (70 * 67, 0))
    assert args[12:15] == (70, 67, 9)
    b0, ptr = args[-2:]
    assert b0 == 64
    slot_words = batch * plan.slots * C.TILE * C.TILE
    assert ptr == args[3] + 4 * slot_words
    assert ka.shape[-2:] == (70, 67) and kb.shape[-2:] == (64, 9)
    assert (slot_words + (1 if swap else batch) * 70 * 68
            + (batch if swap else 1) * 64 * 12,) in sizes
    assert C.tf32_round_operands.launches == 1


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _f64_card(a, b, out):
    """The exact product and that of the absolute values, on the card
    (K1's plain version in f64)."""
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64_reference

    a64, b64 = a.double(), b.double()
    return (conv2d_trunc_f64_reference(a64, b64, out),
            conv2d_trunc_f64_reference(a64.abs(), b64.abs(), out))


def _card_within(got, want, absprod):
    bar = (ONE_PASS + RTOL) * absprod + ATOL
    diff = (got.double() - want).abs()
    assert bool((diff <= bar).all()), float((diff / bar).max())


CARD_SHAPES = ROWSTRIP_SHAPES + [
    ((200, 300), (150, 100), (280, 380)),
    ((1, 130), (130, 1), (130, 130)),
    ((95, 1), (95, 87), (95, 87)),
    ((16, 5), (3, 40), (10, 12)),
    # a's rows not 16-byte aligned
    ((130, 141), (120, 100), (130, 140)),
    ((512, 512), (512, 512), (512, 512)),
    # the wgmma body's ragged shapes: a1 % 4 != 0, b of 8, 9, 64 columns
    ((70, 67), (64, 8), (70, 70)),
    ((130, 133), (120, 9), (130, 130)),
    ((130, 130), (130, 64), (130, 130)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", CARD_SHAPES)
@pytest.mark.parametrize("kernel", SINGLE, ids=lambda k: k.__name__)
def test_one_pass_on_card(kernel, sa, sb, out):
    """The one-pass kernel against its plain version at the three-pass
    bar, against f64 at the one-pass bound, the same bits twice, counted
    apart from the three-pass launches, and not the three-pass result.
    K2's one-pass mode is the one-pass tile kernel, bit for bit."""
    _card()
    rng = np.random.default_rng(19)
    a = torch.from_numpy(rng.random(sa)).float().cuda()
    b = torch.from_numpy(rng.random(sb)).float().cuda()
    before = (kernel.launches, kernel.launches_1pass)
    got = kernel(a, b, out, highest=False)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_1pass) == (before[0],
                                                        before[1] + 1)
    plain = C.conv2d_trunc_f32_reference(a, b, out, highest=False)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    _card_within(got, *_f64_card(a, b, out))
    assert torch.equal(kernel(a, b, out, highest=False), got)
    three = kernel(a, b, out)
    assert bool(((got - three).abs() > 1e-5 * three.abs()).any())
    if kernel is ops.conv2d_trunc_f32:
        assert torch.equal(ops.conv2d_trunc_f32_tile(a, b, out,
                                                     highest=False), got)


@pytest.mark.cuda
def test_round_kernel_is_tf32_round_on_card():
    """The rounding kernel against ``tf32_round`` bit for bit: random
    words of every exponent, ties, subnormals, zeros, infinities and NaNs
    with payloads, in both operands; the pad columns zero; one launch."""
    _card()
    rng = np.random.default_rng(29)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC00001,
                        0xFFFFFFFF, 0x7F7FFFFF, 0x7F7FF000, 0x00000000,
                        0x80000000, 0x00001000, 0x80001000],
                       dtype=np.uint32).view(np.float32)
    sub = rng.integers(1, 1 << 23, 2048, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([_words(1 << 15, rng), _ties(rng), special,
                        sub.view(np.float32), -sub.view(np.float32)])
    n = x.size // 37 * 37
    a = torch.from_numpy(x[:n].reshape(-1, 37)).cuda()
    b = torch.from_numpy(np.ascontiguousarray(x[-999:]).reshape(-1, 27)
                         ).cuda()
    before = C.tf32_round_operands.launches
    ra, rb = C.tf32_round_operands(a, b)
    torch.cuda.synchronize()
    assert C.tf32_round_operands.launches == before + 1
    assert ra.shape == (a.shape[0], 40) and rb.shape == (b.shape[0], 28)
    words = lambda t: t.cpu().contiguous().view(torch.int32)
    assert torch.equal(words(ra[:, :37]), words(C.tf32_round(a.cpu())))
    assert torch.equal(words(rb[:, :27]), words(C.tf32_round(b.cpu())))
    assert not ra[:, 37:].any() and not rb[:, 27:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out,rounds", [
    ((130, 133), (120, 9), (130, 130), 1),
    ((512, 512), (512, 512), (512, 512), 1),
    ((95, 1), (95, 87), (95, 87), 0),
    ((16, 5), (3, 40), (10, 12), 0),
])
def test_one_pass_rounds_once_a_call(sa, sb, out, rounds):
    """The one-pass tile kernel, K2's, K4b's and K3's one pass launch the
    rounding kernel once a call where they run the wgmma body, and not on
    a thin b (the FFMA body rounds in registers)."""
    _card()
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.random(sa)).float().cuda()
    b = torch.from_numpy(rng.random(sb)).float().cuda()
    for wrapper, args, n in (
            (ops.conv2d_trunc_f32_tile, (a, b), rounds),
            (ops.conv2d_trunc_f32, (a, b), rounds),
            (ops.conv2d_trunc_f32_grouped, (a, b), rounds),
            (ops.conv2d_trunc_f32_batched, (a[None].repeat(3, 1, 1), b),
             rounds)):
        before = C.tf32_round_operands.launches
        wrapper(*args, out, highest=False)
        torch.cuda.synchronize()
        assert C.tf32_round_operands.launches == before + n, wrapper.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", (*SINGLE, ops.conv2d_trunc_f32_batched),
                         ids=lambda k: k.__name__)
def test_one_pass_on_card_extreme_scales(kernel):
    """Column scales from 1e-30 to 1e30 (a) and 1e-6 to 1e6 (b): TF32 has
    f32's exponent range, so every column holds the bound at its own
    scale (atol 1e-37)."""
    _card()
    rng = np.random.default_rng(13)
    out = (130, 140)
    a = rng.random((130, 140)) * 10.0 ** np.linspace(-30, 30, 140)
    b = rng.random((120, 100)) * 10.0 ** np.linspace(-6, 6, 100)
    ta = torch.from_numpy(a).float().cuda()
    tb = torch.from_numpy(b).float().cuda()
    if kernel is ops.conv2d_trunc_f32_batched:
        got = kernel(ta[None].repeat(2, 1, 1), tb, out, highest=False)[1]
    else:
        got = kernel(ta, tb, out, highest=False)
    want, absprod = _f64_card(ta, tb, out)
    bar = (ONE_PASS + RTOL) * absprod + 1e-37
    assert bool(torch.isfinite(got).all())
    assert bool(((got.double() - want).abs() <= bar).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch,sa,sb,out", [
    *BATCHED, *SWAPPED,
    (2, (1, 130), (130, 1), (130, 130)),
    (5, (256, 256), (256, 256), (256, 256)),
    (3, (130, 141), (120, 100), (130, 140)),
    (3, (95, 1), (95, 87), (95, 87)),
    (4, (5, 7), (70, 80), (70, 80)),
    (3, (70, 67), (64, 8), (70, 70)),
    (4, (130, 133), (120, 9), (130, 130)),
    (4, (120, 9), (130, 133), (130, 130)),
])
def test_batched_one_pass_on_card(nbatch, sa, sb, out):
    """Every entry equals ``conv2d_trunc_f32(..., highest=False)`` bit for
    bit, and holds the one-pass bound."""
    _card()
    rng = np.random.default_rng(23)
    a = torch.from_numpy(rng.random((nbatch, *sa))).float().cuda()
    b = torch.from_numpy(rng.random(sb)).float().cuda()
    wrapper = ops.conv2d_trunc_f32_batched
    before = (wrapper.launches, wrapper.launches_1pass)
    got = wrapper(a, b, out, highest=False)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_1pass) == (before[0],
                                                          before[1] + 1)
    for g in range(nbatch):
        assert torch.equal(got[g], ops.conv2d_trunc_f32(a[g], b, out,
                                                        highest=False))
        _card_within(got[g], *_f64_card(a[g], b, out))


# phase 3's shapes of chip_smoke.py (SHAPES), and b of 1, 3 and 8 columns
PHASE3_SHAPES = [
    ((5, 7), (4, 6), (8, 12)),
    ((130, 140), (120, 100), (130, 140)),
    ((100, 120), (130, 140), (130, 140)),
    ((1, 130), (130, 1), (130, 130)),
    ((70, 80), (60, 50), (70, 80)),
    ((200, 300), (150, 100), (280, 380)),
    ((16, 5), (3, 40), (10, 12)),
    ((33, 64), (64, 20), (96, 83)),
    ((95, 1), (95, 87), (95, 87)),
    ((1, 87), (95, 87), (95, 87)),
    ((308, 274), (308, 1), (308, 274)),
    ((1, 274), (308, 274), (308, 274)),
    ((256, 256), (256, 256), (256, 256)),
    ((384, 384), (384, 384), (384, 384)),
    ((512, 512), (512, 512), (512, 512)),
    ((768, 768), (768, 768), (768, 768)),
]
THIN_B = [((150, 140), (120, 1), (150, 140)), ((150, 140), (120, 3),
                                                 (150, 140)),
          ((150, 140), (120, 8), (150, 140))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*PHASE3_SHAPES, *THIN_B, "extreme"],
                         ids=str)
def test_grouped_one_pass_on_card(case):
    """K4b's one pass (the ``wgmma`` body in residue-major order for b of
    8 or more columns, its rounding launched once a call): within phase
    3's bar of its plain version, the same bits twice, and equal to the
    one-pass tile kernel to f32 rounding (2e-6 relative, the atol at the
    extreme scales), which it is not bit for bit on the dense orders."""
    _card()
    rng = np.random.default_rng(37)
    if case == "extreme":
        (sa, sb, out), atol = ((130, 140), (120, 100), (130, 140)), 1e-37
        a = rng.random(sa) * 10.0 ** np.linspace(-30, 30, sa[1])
        b = rng.random(sb) * 10.0 ** np.linspace(-6, 6, sb[1])
    else:
        (sa, sb, out), atol = case, ATOL
        a, b = rng.random(sa), rng.random(sb)
    a = torch.from_numpy(a).float().cuda()
    b = torch.from_numpy(b).float().cuda()
    wgmma = C.tile_body(sa, sb) == "mma"
    before = C.tf32_round_operands.launches
    got = ops.conv2d_trunc_f32_grouped(a, b, out, highest=False)
    torch.cuda.synchronize()
    assert C.tf32_round_operands.launches == before + wgmma
    plain = C.conv2d_trunc_f32_reference(a, b, out, highest=False)
    assert bool(((got - plain).abs() <= RTOL * plain.abs() + atol).all())
    assert torch.equal(ops.conv2d_trunc_f32_grouped(a, b, out,
                                                    highest=False), got)
    tile = ops.conv2d_trunc_f32_tile(a, b, out, highest=False)
    assert bool(((got - tile).abs() <= 2e-6 * tile.abs() + atol).all())
    if wgmma and sa == sb == out and sa[0] >= 256:
        assert not torch.equal(got, tile)


def _rounded_on_card(a, b):
    """The rounding kernel on CUDA tensors ``a``, ``b`` (one launch),
    held bit for bit to ``tf32_round`` with zero pads."""
    before = C.tf32_round_operands.launches
    ra, rb = C.tf32_round_operands(a, b)
    torch.cuda.synchronize()
    assert C.tf32_round_operands.launches == before + 1
    words = lambda t: t.cpu().contiguous().view(torch.int32)  # noqa: E731
    for x, rx in ((a, ra), (b, rb)):
        n = x.shape[-1]
        assert rx.shape == (*x.shape[:-1], -(-n // 4) * 4)
        assert torch.equal(words(rx[..., :n]), words(C.tf32_round(x.cpu())))
        assert not rx[..., n:].any()


def _at_offset(x, words):
    """``x`` (CUDA) copied into a contiguous tensor whose storage starts
    ``words`` 4-byte words past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    assert flat.data_ptr() % 16 == 0
    y = flat[words:words + x.numel()].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,offsets", [
    ((37, 5), (3, 9), (0, 0)),        # odd widths, b of 3 rows
    ((64, 64), (5, 8), (1, 3)),       # 16-byte widths, unaligned starts
    ((130, 141), (31, 100), (2, 0)),  # unaligned a, b under a warp of rows
    ((1, 1), (1, 2), (0, 1)),
    ((2, 768, 768), (768, 768), (0, 0)),
])
def test_round_kernel_on_card_shapes(sa, sb, offsets):
    """The rounding kernel at odd widths (its 4-byte path), at widths of
    whole 16-byte words whose rows start unaligned (the 4-byte path too)
    or aligned (16-byte loads), on b of fewer rows than a warp and on a
    batch, with infinities and NaNs among the words: ``tf32_round``'s
    bits, pads zero."""
    _card()
    rng = np.random.default_rng(sum(sa) + sum(sb))
    special = torch.tensor(np.array([0x7F800000, 0xFF800000, 0x7FC00001,
                                     0xFFFFFFFF, 0x00001000],
                                    dtype=np.uint32).view(np.float32))
    xs = []
    for shape, off in zip((sa, sb), offsets):
        x = torch.from_numpy(rng.standard_normal(shape)).float()
        flat = x.view(-1)
        k = min(flat.numel(), special.numel())
        flat[-k:] = special[:k]
        xs.append(_at_offset(x.cuda(), off))
    _rounded_on_card(*xs)
