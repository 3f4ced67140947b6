"""K1, the truncated 2-D f64 product (``genfer_tpu_torch/ops/conv2d_f64.py``,
``csrc/conv2d_trunc_f64.cu``, ``csrc/conv2d_small_f64.cu``), on the CPU:
its plain version against genfer_tpu's ``_conv_impl`` and host kernel, its
row strips against the unblocked einsum, the wrapper's checks, the routing
of ``k1_route``, and the index algebra of K1's bodies emulated in numpy.

A CUDA kernel cannot run without a card, so the emulations hold the
design the kernels follow.  The dense body: each stage staged as ``issue``
stages it (unstaged words are NaN, so that reading one poisons the
result), the ``mma.sync.m16n8k8 .f64`` fragments read at the kernel's
offsets and assembled lane by lane by the PTX layout, over the unit table
of ``unit_plan(..., cut_j1=False)`` and the slot sum, in the orientation
``k1_route`` picks.  On integer operands every sum is exact, so the
emulation must equal the product bit for bit.  The small body: each
tile's window staged as the kernel's loads stage it, and each output's
sum replayed in the kernel's order (j0 ascending, then j1).

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
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.taylor.host import _conv_pair_flops

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
# the dense body's geometry (F64Geo in conv2d_trunc_f64.cu)
G, KB = 16, 32
S = KB // 8
MT, NTL = 2, 4
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


def _mma_m16n8k8(a_frag, b_frag):
    """A (16x8) and B (8x8) of mma.m16n8k8 .f64 from per-lane fragments
    (leading axes batched; a_frag [..., 4, lane], b_frag [..., 2, lane]),
    by the PTX layout: lane = 4 g + t holds a0 = A[g, t], a1 = A[g + 8, t],
    a2 = A[g, t + 4], a3 = A[g + 8, t + 4], b0 = B[t, g], b1 = B[t + 4,
    g]."""
    A = np.zeros(a_frag.shape[:-2] + (16, 8))
    B = np.zeros(b_frag.shape[:-2] + (8, 8))
    A[..., GRP, TIG] = a_frag[..., 0, :]
    A[..., GRP + 8, TIG] = a_frag[..., 1, :]
    A[..., GRP, TIG + 4] = a_frag[..., 2, :]
    A[..., GRP + 8, TIG + 4] = a_frag[..., 3, :]
    B[..., TIG, GRP] = b_frag[..., 0, :]
    B[..., TIG + 4, GRP] = b_frag[..., 1, :]
    return A, B


# the fragment words' offsets from a lane's A and B base words (``wa``,
# ``wb`` in the kernel): a0..a3 and b0, b1
A_OFF = np.array([0, 8 * A_PITCH, 4, 8 * A_PITCH + 4])
B_OFF = np.array([0, -4])


def _write(c, w, e, K0, K1, tile):
    """The write-back of one output tile at (K0, K1) into the window [w0,
    e0) x [w1, e1) that ``c`` holds, as the kernel and the slot sum index
    it: c[k0 - w0, k1 - w1] for w <= k < e."""
    for m in range(TILE):
        k0 = K0 + m
        if not w[0] <= k0 < e[0]:
            continue
        for n in range(TILE):
            k1 = K1 + n
            if w[1] <= k1 < e[1]:
                c.reshape(-1)[(k0 - w[0]) * (e[1] - w[1]) + k1 - w[1]] = (
                    tile[m, n])


def emulate_dense(a, b, out, window=None):
    """The dense body's result for operands ``a``, ``b`` in this
    orientation: every unit of the plan with the kernel's staging,
    fragment offsets and write-back, then the slot sum.  ``window`` =
    (axis, lo, hi): ``C.window_plan``'s units and the window's write-back
    (output rows, axis 0, or columns, axis 1, [lo, hi))."""
    if window is None:
        plan = C.unit_plan(a.shape, b.shape, out, cut_j1=False)
        w, e = (0, 0), tuple(out)
    else:
        axis, lo, hi = window
        plan = C.window_plan(a.shape, b.shape, tuple(out), *window)
        w = (lo, 0) if axis == 0 else (0, lo)
        e = (hi, out[1]) if axis == 0 else (out[0], hi)
    ka, kb = (b, a) if plan.swap else (a, b)
    a1 = ka.shape[1]
    c = np.full((e[0] - w[0], e[1] - w[1]), np.nan)
    work = np.zeros((max(plan.slots, 1), TILE, TILE))
    ks = np.arange(S)[:, None, None, None]
    for K0, K1, j0_lo, j0_hi, j1_lo, j1_hi, slot, _ in plan.units.tolist():
        i1_lo, i1_hi = max(0, K1 - j1_hi + 1), min(a1, K1 + TILE - j1_lo)
        n_blocks = -(-(i1_hi - i1_lo) // KB)
        acc = np.zeros((4, MT, NTL, 32, 4))  # [warp, M, N, lane, register]
        for g0 in range(j0_lo, j0_hi, G):
            for ib in range(n_blocks):
                sA, sB = _stage(ka, kb, K0, K1, g0, i1_lo + ib * KB, j0_hi,
                                j1_lo, j1_hi)
                for dj in range(min(G, j0_hi - g0)):
                    for warp in range(4):
                        mb, nb = (warp // 2) * 32, (warp % 2) * 32
                        wa = (mb + GRP - dj + G - 1) * A_PITCH + TIG
                        wb = dj * B_PITCH + nb + GRP - TIG + KB - 1
                        # [ks, M, register, lane] and [ks, N, register, lane]
                        af = sA[wa + 16 * np.arange(MT)[:, None, None]
                                * A_PITCH + 8 * ks + A_OFF[:, None]]
                        bf = sB[wb + 8 * np.arange(NTL)[:, None, None]
                                - 8 * ks + B_OFF[:, None]]
                        A, B = _mma_m16n8k8(af, bf)
                        D = np.einsum("smgk,snkh->mngh", A, B)
                        for h in range(2):
                            for i in range(2):
                                acc[warp, ..., 2 * h + i] += (
                                    D[..., 8 * h + GRP, 2 * TIG + i])
        tile = np.zeros((TILE, TILE))
        for warp in range(4):
            mb, nb = (warp // 2) * 32, (warp % 2) * 32
            for M in range(MT):
                for N in range(NTL):
                    for h in range(2):
                        for i in range(2):
                            tile[mb + 16 * M + 8 * h + GRP,
                                 nb + 8 * N + 2 * TIG + i] = (
                                acc[warp, M, N, :, 2 * h + i])
        if slot >= 0:
            work[slot] = tile
        else:
            _write(c, w, e, K0, K1, tile)
    for K0, K1, first, n in plan.sums.tolist():
        _write(c, w, e, K0, K1, work[first:first + n].sum(axis=0))
    if not plan.covers:
        c[np.isnan(c)] = 0.0
    return c


def emulate(a, b, out, rows=None):
    """The dense body in the orientation ``k1_route`` gives it:
    ``dense_t`` runs on the transposed operands and transposes back (a
    window of ``rows`` on the transposed output's columns)."""
    if K.dense_transposed(a.shape, b.shape, tuple(out)):
        window = None if rows is None else (1, *rows)
        return emulate_dense(a.T, b.T, out[::-1], window).T
    return emulate_dense(a, b, out, None if rows is None else (0, *rows))


@pytest.mark.parametrize("sa,sb,out", SHAPES + [
    ((5, 7), (4, 6), (200, 150)),  # output tiles without a unit
    ((95, 1), (95, 87), (95, 87)),  # one-column operand: dense_t
    ((130, 140), (120, 100), (130, 140)),  # several tiles and units
])
def test_fragment_offsets_name_the_product(sa, sb, out):
    rng = np.random.default_rng(7)
    a = rng.integers(-4, 5, sa).astype(np.float64)
    b = rng.integers(-4, 5, sb).astype(np.float64)
    got = emulate(a, b, out)
    want = J.NumpyF64Backend().conv_trunc(a, b, out)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rows", [(0, 64), (64, 130), (13, 77), (129, 130),
                                  (0, 130)])
@pytest.mark.parametrize("sa,sb,out", [
    ((130, 140), (120, 100), (130, 140)),  # several tiles and units
    ((130, 1), (130, 87), (130, 87)),  # dense_t: the window on columns
    ((5, 7), (4, 6), (130, 150)),  # output tiles without a unit
])
def test_window_write_back_names_the_rows(sa, sb, out, rows):
    """The dense body's window (``window_plan``'s units, the kernel's
    write-back at (k0 - w0, k1 - w1)) gives the whole product's rows
    bit for bit, in both orientations, on integer operands (exact)."""
    rng = np.random.default_rng(8)
    a = rng.integers(-4, 5, sa).astype(np.float64)
    b = rng.integers(-4, 5, sb).astype(np.float64)
    got = emulate(a, b, out, rows)
    whole = J.NumpyF64Backend().conv_trunc(a, b, out)
    assert np.array_equal(got, whole[rows[0]:rows[1]])


def test_unstaged_words_would_poison_the_emulation():
    """The NaN guard is live: a fragment offset one word off reads an
    unstaged word of the window's pitch padding and poisons the tile."""
    sA, _ = _stage(np.ones((64, 64)), np.ones((16, 64)), 0, 0, 0, 0, 16, 0,
                   64)
    row = sA[:A_PITCH]
    assert np.isfinite(row[:KB]).all() and np.isnan(row[KB:]).all()


# ------------------------------------------------------------ routing

# the classes the --backend jax main path gives K1 (two_populations(2000)
# and population(1000, 2), seed 0): a 2x2 stencil (nearly every call),
# other stencils of <= 16 coefficients, thin (1, n) and (n, 1) operands;
# and the dense squares of the bench.  (41, 1) holds fewer than
# SMALL_MAX_COEFFS coefficients: the small body (probe 11 timed it faster
# there than the dense body transposed)
ROUTES = [
    (((255, 268), (2, 2), (255, 268)), ("small", False)),
    (((2, 2), (308, 314), (308, 314)), ("small", False)),
    (((261, 203), (4, 4), (261, 203)), ("small", False)),
    (((100, 90), (1, 16), (100, 90)), ("small", False)),
    (((268, 274), (41, 1), (268, 274)), ("small", False)),
    (((100, 90), (8, 8), (100, 90)), ("small", False)),
    (((100, 90), (65, 1), (100, 90)), ("dense", True)),
    (((1, 274), (308, 274), (308, 274)), ("dense", False)),
    (((308, 1), (308, 274), (308, 274)), ("dense", True)),
    (((95, 1), (95, 87), (95, 87)), ("dense", True)),
    (((512, 512), (512, 512), (512, 512)), ("dense", False)),
]


@pytest.mark.parametrize("shapes,route", ROUTES)
def test_k1_route_of_each_main_path_class(shapes, route):
    assert K.k1_route(*shapes) == route
    # the operands' order does not matter
    sa, sb, out = shapes
    assert K.k1_route(sb, sa, out) == route


# every thin class of the main path, the test shapes, both operand orders
# of the (1, n) and (n, 1) classes and some ragged thin and square ones
ORIENTATION_SHAPES = SHAPES + [
    ((308, 1), (308, 274), (308, 274)),
    ((308, 274), (308, 1), (308, 274)),
    ((268, 274), (41, 1), (268, 274)),
    ((95, 1), (95, 87), (95, 87)),
    ((1, 274), (308, 274), (308, 274)),
    ((1, 87), (95, 87), (95, 87)),
    ((200, 150), (60, 20), (200, 150)),
    ((150, 200), (20, 60), (150, 200)),
    ((130, 140), (120, 100), (130, 140)),
    ((256, 256), (256, 256), (256, 256)),
    ((300, 40), (17, 3), (300, 40)),
]


@pytest.mark.parametrize("sa,sb,out", ORIENTATION_SHAPES)
def test_dense_orientation_never_issues_more(sa, sb, out):
    """``dense_transposed`` never picks the orientation whose plan
    issues more multiply-adds on the tensor cores."""
    t = K.dense_transposed(sa, sb, out)
    picked = K.dense_issued_macs(sa, sb, out, t)
    other = K.dense_issued_macs(sa, sb, out, not t)
    assert picked <= other, (t, picked, other)


@pytest.mark.parametrize("sa,sb,out,before,after", [
    ((308, 1), (308, 274), (308, 274), 85.8, 2.6),
    ((268, 274), (41, 1), (268, 274), 86.8, 3.8),
])
def test_thin_classes_contract_along_the_long_axis(sa, sb, out, before,
                                                   after):
    """The two thin classes of two_populations(2000): issued over useful
    multiply-adds fall from ~86 x in the untransposed plan to <= 2.6 x
    and <= 3.8 x in the orientation the dense body takes."""
    useful = _conv_pair_flops(sa, sb, out)
    assert K.dense_transposed(sa, sb, out)
    assert K.dense_issued_macs(sa, sb, out) / useful == pytest.approx(
        before, abs=0.05)
    assert K.dense_issued_macs(sa, sb, out, True) / useful <= after


# ---------------------------------------------------------- small body

# the small body's geometry (conv2d_small_f64.cu): output tile edge, and
# the most coefficients its smaller operand may hold
SMALL_TILE, SMALL_LIMIT = 32, 64


def test_small_body_takes_every_operand_the_route_sends_it():
    assert K.SMALL_MAX_COEFFS <= SMALL_LIMIT


def _small_window(ka, K0, K1, s0, s1, vec):
    """The window a block of the small body stages, as its loads write it
    (NaN where none does): word (r, q) is ka[K0 - h0 + r, K1 - e1 + q],
    zero outside ka; ``vec``: pairs of words from even columns."""
    a0, a1 = ka.shape
    h0, e1 = s0 - 1, s1 & ~1
    rows, width = SMALL_TILE + h0, SMALL_TILE + e1
    sw = np.full((rows, width), np.nan)
    step = 2 if vec else 1
    for r in range(rows):
        ar = K0 - h0 + r
        for q in range(0, width, step):
            aq = K1 - e1 + q
            for w in range(step):
                ok = 0 <= ar < a0 and 0 <= aq < a1
                if vec:
                    assert aq % 2 == 0 and a1 % 2 == 0
                sw[r, q + w] = ka[ar, aq + w] if ok else 0.0
    return sw


def emulate_small(a, b, out, vec=None, rows=None):
    """The small body's result for one pair: per 32x32 output tile its
    window, then every output as the kernel sums it, j0 ascending then
    j1 (fma's single rounding aside), read at the kernel's offsets;
    ``rows`` = (r0, r1): the tiles start at row r0, and output row k is
    written at k - r0."""
    ka, ks = (b, a) if C._swap(a.shape, b.shape) else (a, b)
    s0, s1 = ks.shape
    assert s0 * s1 <= SMALL_LIMIT
    vec = ka.shape[1] % 2 == 0 if vec is None else vec
    h0, e1 = s0 - 1, s1 & ~1
    r0, r1 = (0, out[0]) if rows is None else rows
    c = np.full((r1 - r0, out[1]), np.nan)
    for K0 in range(r0, r1, SMALL_TILE):
        for K1 in range(0, out[1], SMALL_TILE):
            sw = _small_window(ka, K0, K1, s0, s1, vec)
            acc = np.zeros((SMALL_TILE, SMALL_TILE))  # [y, x]
            for j0 in range(s0):
                for j1 in range(s1):
                    acc = acc + ks[j0, j1] * sw[h0 - j0:h0 - j0 + SMALL_TILE,
                                                e1 - j1:e1 - j1 + SMALL_TILE]
            r, q = min(SMALL_TILE, r1 - K0), min(SMALL_TILE, out[1] - K1)
            c[K0 - r0:K0 - r0 + r, K1:K1 + q] = acc[:r, :q]
    assert not np.isnan(c).any()  # every output word written
    return c


def emulate_small_batched(a, b, out):
    return np.stack([emulate_small(x, y, out) for x, y in zip(a, b)])


# main-path stencil shapes cut to <= 64: square and ragged, either operand
# smaller, one row or one column, truncated, wider than the full product,
# odd widths (8-byte loads)
SMALL_SHAPES = [
    ((55, 64), (2, 2), (55, 64)),
    ((2, 2), (61, 47), (61, 47)),
    ((64, 61), (4, 4), (64, 61)),
    ((40, 50), (1, 16), (40, 50)),
    ((40, 50), (16, 1), (40, 50)),
    ((1, 1), (33, 20), (33, 20)),
    ((40, 50), (2, 3), (30, 35)),
    ((10, 12), (2, 3), (20, 40)),
    ((1, 45), (3, 5), (3, 49)),
    ((64, 60), (41, 1), (64, 60)),
    ((50, 64), (8, 8), (50, 64)),
    ((30, 40), (1, 64), (30, 40)),
]


@pytest.mark.parametrize("sa,sb,out", SMALL_SHAPES)
def test_small_body_replay_matches_jax_and_host(sa, sb, out):
    assert K.k1_route(sa, sb, out)[0] == "small"
    a, b = _normal(sa, 21), _normal(sb, 22)
    got = emulate_small(a, b, out)
    want = np.asarray(J._conv_impl(J._jax()[1], a, b, out))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    host = J.NumpyF64Backend().conv_trunc(a, b, out)
    np.testing.assert_allclose(got, host, rtol=1e-12, atol=1e-12 * scale)
    # integer operands: every sum exact, the same bits as the host
    rng = np.random.default_rng(23)
    ai = rng.integers(-4, 5, sa).astype(np.float64)
    bi = rng.integers(-4, 5, sb).astype(np.float64)
    assert np.array_equal(emulate_small(ai, bi, out),
                          J.NumpyF64Backend().conv_trunc(ai, bi, out))


@pytest.mark.parametrize("sa,sb,out", [SMALL_SHAPES[0], SMALL_SHAPES[3]])
def test_small_body_loads_stage_the_same_window(sa, sb, out):
    """16-byte and 8-byte loads stage the same words."""
    a, b = _normal(sa, 24), _normal(sb, 25)
    assert np.array_equal(emulate_small(a, b, out, vec=True),
                          emulate_small(a, b, out, vec=False))


@pytest.mark.parametrize("rows", [(0, 32), (7, 41), (30, 31)])
@pytest.mark.parametrize("sa,sb,out", [SMALL_SHAPES[0], SMALL_SHAPES[2],
                                       SMALL_SHAPES[9]])
def test_small_body_window_equals_the_whole_rows(sa, sb, out, rows):
    """The small body's row offset: a window's outputs are the whole
    product's, bit for bit (each output's fma chain is the same)."""
    a, b = _normal(sa, 30), _normal(sb, 31)
    whole = emulate_small(a, b, out)
    assert np.array_equal(emulate_small(a, b, out, rows=rows),
                          whole[rows[0]:rows[1]])


def test_small_body_batch_replay_matches_the_plain_version():
    sa, sb, out = (3, 50, 64), (3, 2, 2), (50, 64)
    a, b = _normal(sa, 26), _normal(sb, 27)
    got = emulate_small_batched(a, b, out)
    want = K.conv2d_trunc_f64_batched_reference(_t(a), _t(b), out).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


def test_small_body_replay_through_a_3_axis_product(monkeypatch):
    """A 3-axis product through ``TorchF64Backend(device="cpu")`` whose
    pair batch K1 would run on the small body, with the wrapper's plain
    version replaced by the small body's replay: it matches
    ``_conv_impl`` and the host product at rtol 1e-12."""
    calls = []

    def replay(a, b, out_shape, rows=None):
        assert K.k1_route(tuple(a.shape[1:]), tuple(b.shape[1:]),
                          out_shape)[0] == "small"
        calls.append(a.shape[0])
        return torch.from_numpy(emulate_small_batched(
            a.numpy(), b.numpy(), tuple(out_shape)))

    monkeypatch.setattr(K, "conv2d_trunc_f64_batched_reference", replay)
    sa, sb, out = (6, 40, 30), (3, 2, 2), (8, 40, 30)
    a, b = _normal(sa, 28), _normal(sb, 29)
    got = T.TorchF64Backend(device="cpu").conv_trunc(_t(a), _t(b), out)
    assert calls == [6 * 3]
    got = got.numpy()
    want = np.asarray(J._conv_impl(J._jax()[1], a, b, out))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    host = J.NumpyF64Backend().conv_trunc(a, b, out)
    np.testing.assert_allclose(got, host, rtol=1e-12, atol=1e-12 * scale)


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
# one product of each body's classes on the main path
BODY_SHAPES = [
    ((255, 268), (2, 2), (255, 268)),
    ((2, 2), (308, 314), (308, 314)),
    ((261, 203), (4, 4), (261, 203)),
    ((61, 47), (1, 16), (61, 47)),
    ((308, 1), (308, 274), (308, 274)),
    ((268, 274), (41, 1), (268, 274)),
    ((1, 274), (308, 274), (308, 274)),
]


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
@pytest.mark.parametrize("sa,sb,out", CARD_SHAPES + BODY_SHAPES)
def test_kernel_on_card(card, sa, sb, out):
    a = _t(_normal(sa, 11)).to(card)
    b = _t(_normal(sb, 12)).to(card)
    K.reset_launches()
    got = K.conv2d_trunc_f64(a, b, out)
    assert K.conv2d_trunc_f64.launches == 1
    assert K.conv2d_trunc_f64.launches_by_body[K.k1_body(sa, sb, out)] == 1
    _gate(got, K.conv2d_trunc_f64_reference(a, b, out))
    assert torch.equal(got, K.conv2d_trunc_f64(a, b, out))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 64), (64, 128), (13, 77)])
@pytest.mark.parametrize("sa,sb,out", BODY_SHAPES[:1] + BODY_SHAPES[4:5]
                         + [((200, 190), (150, 170), (200, 190))])
def test_window_equals_the_whole_rows_on_card(card, sa, sb, out, rows):
    """K1's row window on the card (small, dense_t, dense): the same rows
    of the whole product bit for bit, one windowed launch each."""
    a = _t(_normal(sa, 13)).to(card)
    b = _t(_normal(sb, 14)).to(card)
    whole = K.conv2d_trunc_f64(a, b, out)
    K.reset_launches()
    got = K.conv2d_trunc_f64(a, b, out, rows=rows)
    body = K.k1_body(sa, sb, out)
    assert K.conv2d_trunc_f64.windowed_by_body[body] == 1
    assert torch.equal(got, whole[rows[0]:rows[1]])


@pytest.mark.cuda
def test_every_body_reached_on_card(card):
    K.reset_launches()
    for sa, sb, out in BODY_SHAPES + [((512, 512),) * 3]:
        K.conv2d_trunc_f64(_t(_normal(sa, 1)).to(card),
                           _t(_normal(sb, 2)).to(card), out)
    assert all(K.conv2d_trunc_f64.launches_by_body[body] >= 1
               for body in K.BODIES), K.conv2d_trunc_f64.launches_by_body


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", BODY_SHAPES[:2] + BODY_SHAPES[4:6])
def test_batched_bodies_equal_the_single_pair_on_card(card, sa, sb, out):
    a = _t(_normal((3, *sa), 30)).to(card)
    b = _t(_normal((3, *sb), 31)).to(card)
    got = K.conv2d_trunc_f64_batched(a, b, out)
    _gate(got, K.conv2d_trunc_f64_batched_reference(a, b, out))
    for z in range(3):
        assert torch.equal(got[z], K.conv2d_trunc_f64(a[z], b[z], out))


@pytest.mark.cuda
def test_small_body_unaligned_operand_on_card(card):
    """An operand that starts 8 bytes past a 16-byte boundary takes the
    8-byte loads, and gives the aligned operand's bits."""
    sa, sb, out = (255, 268), (2, 2), (255, 268)
    a = _t(_normal(sa, 32)).to(card)
    b = _t(_normal(sb, 33)).to(card)
    store = torch.empty(a.numel() + 1, dtype=torch.float64, device=card)
    shifted = store[1:].view(sa)
    shifted.copy_(a)
    assert shifted.data_ptr() % 16 == 8
    assert torch.equal(K.conv2d_trunc_f64(shifted, b, out),
                       K.conv2d_trunc_f64(a, b, out))


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
