"""K1, the truncated 2-D f64 product (``genfer_tpu_torch/ops/conv2d_f64.py``,
``csrc/conv2d_trunc_f64.cu``), on the CPU: its plain version against
genfer_tpu's ``_conv_impl`` and host kernel, its row strips against the
unblocked einsum, the wrapper's checks, and the kernel's index algebra
emulated in numpy.

A CUDA kernel cannot run without a card, so the emulation holds the
design the kernel follows: each stage staged as ``issue`` stages it
(unstaged words are NaN, so that reading one poisons the result), the
``mma.sync.m8n8k4 .f64`` fragments read at the kernel's offsets and
assembled lane by lane by the PTX layout, over the unit table of
``unit_plan(..., cut_j1=False)`` and the slot sum.  On integer operands
every sum is exact, so the emulation must equal the product bit for bit.

The tests marked ``cuda`` hold the kernel itself to its plain version on a
card (they skip here).
"""

import numpy as np
import pytest
import torch

from genfer_tpu.taylor import backend as J
from genfer_tpu_torch import bench
from genfer_tpu_torch.ops import conv2d as C
from genfer_tpu_torch.ops import conv2d_f64 as K

# tests/test_conv_block.py::SHAPES: ragged, c1 > a1 + b1 - 1, square
# truncated, full, c0 < b0, degenerate first axis
SHAPES = [
    ((60, 47), (52, 61), (55, 50)),
    ((33, 64), (64, 20), (96, 83)),
    ((64, 64), (64, 64), (64, 64)),
    ((64, 64), (64, 64), (127, 127)),
    ((40, 30), (20, 25), (59, 54)),
    ((16, 5), (3, 40), (10, 12)),
    ((1, 33), (9, 33), (9, 40)),
]
TILE = C.TILE
# the kernel's geometry (F64Geo in conv2d_trunc_f64.cu)
G, KB = 16, 32
S = KB // 4
MT = NTL = 4
A_ROWS = TILE + G - 1
A_PITCH, B_PITCH, B_USED = KB + 4, KB + TILE, KB + TILE - 1


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("sa,sb,out", SHAPES)
def test_reference_matches_jax_and_host(sa, sb, out):
    """The plain version is the einsum genfer_tpu's ``_conv_impl`` runs on
    the CPU: rtol 1e-12 against it, and against the host C++ kernel."""
    a, b = _normal(sa, 1), _normal(sb, 2)
    got = K.conv2d_trunc_f64_reference(_t(a), _t(b), out).numpy()
    want = np.asarray(J._conv_impl(J._jax()[1], a, b, out))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    host = J.NumpyF64Backend().conv_trunc(a, b, out)
    np.testing.assert_allclose(got, host, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("sa,sb,out", [SHAPES[0], SHAPES[3], SHAPES[5]])
def test_row_strips_equal_the_unblocked_einsum(sa, sb, out, rows):
    a, b = _normal((3, *sa), 3), _normal((3, *sb), 4)
    dense = K.conv2d_trunc_f64_batched_reference(_t(a), _t(b), out)
    strips = K.conv2d_trunc_f64_batched_reference(_t(a), _t(b), out, rows)
    scale = float(dense.abs().max())
    np.testing.assert_allclose(strips.numpy(), dense.numpy(), rtol=1e-13,
                               atol=1e-13 * scale)


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    monkeypatch.setattr(K.conv2d_trunc_f64, "launches", 0)
    a, b = _t(_normal((40, 30), 5)), _t(_normal((20, 25), 6))
    got = K.conv2d_trunc_f64(a, b, (59, 54))
    assert torch.equal(got, K.conv2d_trunc_f64_reference(a, b, (59, 54)))
    ab, bb = torch.stack([a, 2 * a]), torch.stack([b, b])
    got_b = K.conv2d_trunc_f64_batched(ab, bb, (59, 54))
    assert torch.equal(got_b[0], got)
    assert K.conv2d_trunc_f64.launches == 0


@pytest.mark.parametrize("bad,err", [
    (lambda a, b: (a.float(), b), TypeError),
    (lambda a, b: (a[None], b), ValueError),
    (lambda a, b: (a.t(), b), ValueError),
    (lambda a, b: (a[:0], b), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    a = torch.rand(6, 5, dtype=torch.float64)
    b = torch.rand(4, 3, dtype=torch.float64)
    with pytest.raises(err):
        K.conv2d_trunc_f64(*bad(a, b), (6, 5))


def test_batched_wrapper_rejects_unequal_batches():
    a = torch.rand(2, 6, 5, dtype=torch.float64)
    b = torch.rand(3, 4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="batches"):
        K.conv2d_trunc_f64_batched(a, b, (6, 5))


# ------------------------------------------------------- index algebra

LANE = np.arange(32)
GRP, TIG = LANE // 4, LANE % 4  # the layouts' group and thread in group


def _stage(ka, kb, K0, K1, g0, i1_0, j0_hi, j1_lo, j1_hi):
    """The flat stage buffers as ``issue`` writes them; NaN elsewhere."""
    a0, a1 = ka.shape
    sA = np.full(A_ROWS * A_PITCH, np.nan)
    sB = np.full(G * B_PITCH, np.nan)
    n_dj = min(G, j0_hi - g0)
    for r in range(G - n_dj, A_ROWS):  # a warp a row, a lane a word
        ar = K0 - (g0 + G - 1) + r
        for lane in range(32):
            ok = i1_0 + lane < a1 and 0 <= ar < a0
            sA[r * A_PITCH + lane] = ka[ar, i1_0 + lane] if ok else 0.0
    col0 = K1 - i1_0 - KB + 1
    for e in range(n_dj * B_USED):
        dj, x = divmod(e, B_USED)
        j1 = col0 + x
        ok = j1_lo <= j1 < j1_hi
        sB[dj * B_PITCH + x] = kb[g0 + dj, j1] if ok else 0.0
    return sA, sB


def _mma_m8n8k4(a_frag, b_frag):
    """D = A B from per-lane fragments (leading axes batched), by the PTX
    layout of mma.m8n8k4 .f64: lane = 4 g + t holds A[g, t] and B[t, g],
    and receives D[g, 2 t], D[g, 2 t + 1]."""
    A = np.zeros(a_frag.shape[:-1] + (8, 4))
    B = np.zeros(b_frag.shape[:-1] + (4, 8))
    A[..., GRP, TIG] = a_frag
    B[..., TIG, GRP] = b_frag
    return A, B


def emulate(a, b, out):
    """The kernel's result for operands ``a``, ``b``: every unit of the
    plan with the kernel's staging, fragment offsets and write-back, then
    the slot sum."""
    plan = C.unit_plan(a.shape, b.shape, out, cut_j1=False)
    ka, kb = (b, a) if plan.swap else (a, b)
    a1 = ka.shape[1]
    c = np.full(out, np.nan)
    work = np.zeros((max(plan.slots, 1), TILE, TILE))
    for K0, K1, j0_lo, j0_hi, j1_lo, j1_hi, slot, _ in plan.units.tolist():
        i1_lo, i1_hi = max(0, K1 - j1_hi + 1), min(a1, K1 + TILE - j1_lo)
        n_blocks = -(-(i1_hi - i1_lo) // KB)
        acc = np.zeros((4, MT, NTL, 32, 2))  # [warp, M, N, lane, i]
        for g0 in range(j0_lo, j0_hi, G):
            for ib in range(n_blocks):
                sA, sB = _stage(ka, kb, K0, K1, g0, i1_lo + ib * KB, j0_hi,
                                j1_lo, j1_hi)
                for dj in range(min(G, j0_hi - g0)):
                    for warp in range(4):
                        mb, nb = (warp // 2) * 32, (warp % 2) * 32
                        wa = (mb + GRP - dj + G - 1) * A_PITCH + TIG
                        wb = dj * B_PITCH + nb + GRP - TIG + KB - 1
                        ks = np.arange(S)[:, None, None]
                        af = sA[wa + 8 * np.arange(MT)[:, None] * A_PITCH
                                + 4 * ks]  # [ks, M, lane]
                        bf = sB[wb + 8 * np.arange(NTL)[:, None] - 4 * ks]
                        A, B = _mma_m8n8k4(af, bf)
                        D = np.einsum("smgk,snkh->mngh", A, B)
                        acc[warp, ..., 0] += D[..., GRP, 2 * TIG]
                        acc[warp, ..., 1] += D[..., GRP, 2 * TIG + 1]
        tile = np.zeros((TILE, TILE))
        for warp in range(4):
            mb, nb = (warp // 2) * 32, (warp % 2) * 32
            for M in range(MT):
                for N in range(NTL):
                    for i in range(2):
                        tile[mb + 8 * M + GRP, nb + 8 * N + 2 * TIG + i] = (
                            acc[warp, M, N, :, i])
        if slot >= 0:
            work[slot] = tile
        else:
            r, q = min(TILE, out[0] - K0), min(TILE, out[1] - K1)
            c[K0:K0 + r, K1:K1 + q] = tile[:r, :q]
    for K0, K1, first, n in plan.sums.tolist():
        total = work[first:first + n].sum(axis=0)
        r, q = min(TILE, out[0] - K0), min(TILE, out[1] - K1)
        c[K0:K0 + r, K1:K1 + q] = total[:r, :q]
    if not plan.covers:
        c[np.isnan(c)] = 0.0
    return c


@pytest.mark.parametrize("sa,sb,out", SHAPES + [
    ((5, 7), (4, 6), (200, 150)),  # output tiles without a unit
    ((95, 1), (95, 87), (95, 87)),  # one-column operand, swapped
    ((130, 140), (120, 100), (130, 140)),  # several tiles and units
])
def test_fragment_offsets_name_the_product(sa, sb, out):
    rng = np.random.default_rng(7)
    a = rng.integers(-4, 5, sa).astype(np.float64)
    b = rng.integers(-4, 5, sb).astype(np.float64)
    got = emulate(a, b, out)
    want = J.NumpyF64Backend().conv_trunc(a, b, out)
    assert np.array_equal(got, want)


def test_unstaged_words_would_poison_the_emulation():
    """The NaN guard is live: a fragment offset one word off reads an
    unstaged word of the window's pitch padding and poisons the tile."""
    sA, _ = _stage(np.ones((64, 64)), np.ones((16, 64)), 0, 0, 0, 0, 16, 0,
                   64)
    row = sA[:A_PITCH]
    assert np.isfinite(row[:KB]).all() and np.isnan(row[KB:]).all()


# -------------------------------------------------------------- bound


@pytest.mark.parametrize("order,ms", [(512, 0.515), (1024, 8.22)])
def test_bound_of_the_square_product_is_the_f64_tensor_rate(order, ms):
    shape = (order, order)
    bound, by = bench.product_bound(shape, shape, shape, rate=bench.F64_MMA)
    assert by == "tensor operations"
    assert bound == pytest.approx(ms, rel=2e-3)
    macs = bench._conv_pair_flops(shape, shape, shape)
    assert bound == pytest.approx(macs / bench.F64_MMA_PER_S * 1e3,
                                  rel=1e-12)


# ------------------------------------------------------------ the card

CARD_SHAPES = SHAPES + [((256, 256),) * 3, ((512, 512),) * 3,
                        ((95, 1), (95, 87), (95, 87))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gate(got, want):
    """max abs error over max |want| <= 1e-12 (standard-normal operands)."""
    err = float((got - want).abs().max() / want.abs().max())
    assert torch.isfinite(got).all() and err <= 1e-12, err


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", CARD_SHAPES)
def test_kernel_on_card(card, sa, sb, out):
    a = _t(_normal(sa, 11)).to(card)
    b = _t(_normal(sb, 12)).to(card)
    before = K.conv2d_trunc_f64.launches
    got = K.conv2d_trunc_f64(a, b, out)
    assert K.conv2d_trunc_f64.launches == before + 1
    _gate(got, K.conv2d_trunc_f64_reference(a, b, out))
    assert torch.equal(got, K.conv2d_trunc_f64(a, b, out))


@pytest.mark.cuda
def test_batched_entries_equal_the_single_pair_on_card(card):
    sa, sb, out = (130, 140), (120, 100), (130, 140)
    a = _t(_normal((5, *sa), 13)).to(card)
    b = _t(_normal((5, *sb), 14)).to(card)
    got = K.conv2d_trunc_f64_batched(a, b, out)
    _gate(got, K.conv2d_trunc_f64_batched_reference(a, b, out))
    for z in range(5):
        assert torch.equal(got[z], K.conv2d_trunc_f64(a[z], b[z], out))


@pytest.mark.cuda
def test_kernel_on_card_extreme_column_scales(card):
    sa, sb, out = (130, 140), (120, 100), (130, 140)
    rng = np.random.default_rng(15)
    a = rng.random(sa) * 10.0 ** np.linspace(-150, 150, sa[1])
    b = rng.random(sb) * 10.0 ** np.linspace(-20, 20, sb[1])
    a, b = _t(a).to(card), _t(b).to(card)
    got = K.conv2d_trunc_f64(a, b, out)
    want = K.conv2d_trunc_f64_reference(a, b, out)
    col = want.abs().amax(dim=0)
    assert ((got - want).abs() <= 1e-12 * col).all()


@pytest.mark.cuda
def test_every_f64_path_reaches_the_kernel_on_card(card):
    """``HybridBackend``'s f64 offload, ``TorchF64Backend`` (a 3-axis
    product in one launch) and the ``entry()`` twin launch K1."""
    from genfer_tpu_torch.entry import entry
    from genfer_tpu_torch.taylor import backend as T

    hybrid = T.HybridBackend()
    hybrid.CONV_OFFLOAD_FLOPS = 1
    a, b = _normal((40, 30), 16), _normal((20, 25), 17)
    a3, b3 = _normal((6, 40, 30), 18), _normal((5, 20, 25), 19)
    calls = [
        lambda: hybrid.conv_trunc(a, b, (59, 54)),
        lambda: T.TorchF64Backend().conv_trunc(_t(a).to(card), _t(b).to(card),
                                               (59, 54)),
        lambda: T.TorchF64Backend().conv_trunc(
            _t(a3).to(card), _t(b3).to(card), (10, 59, 54)),
        lambda: (lambda f, args: f(*args))(*entry()),
    ]
    for call in calls:
        before = K.conv2d_trunc_f64.launches
        call()
        assert K.conv2d_trunc_f64.launches == before + 1
