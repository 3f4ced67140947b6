"""K6, the truncated 1-D f32 product (``genfer_tpu_torch/ops/conv1d.py``,
``csrc/conv1d_trunc_f32.cu``), on the CPU.

The kernel folds the 1-D product into a 2-D one (rows of W = 64 words,
one (rows x 64) @ (64 x 64) product per block diagonal d) and runs it as
split-TF32 ``mma.sync`` on the work units of ``fold_plan``.  A CUDA kernel
cannot run without a card, so these tests hold its design, in numpy:

* the plan: every (output row, diagonal) pair the clipping keeps in
  exactly one unit, slots in d order, balance at the long lengths, and
  the kernel's two passes replayed in f64 on integer operands equal to
  ``np.convolve`` exactly;
* the fold identity and the fragment offsets: an ``mma.sync.m16n8k8``
  assembled lane by lane from the kernel's offsets into the staged a
  window and b stretch names the folded product;
* the split arithmetic (hi + 2^-11 lo, three passes, chains of eight
  steps, f32 sums outside the tensor core) under the pessimistic tensor
  core of ``tests/test_torch_mma.py``, held to f64 at the 1-D bar (rtol
  2e-5 / atol 1e-6, ``tests/test_parallel_ops.py``), and on a geometric
  pair whose outputs span 36 decades at atol 1e-37;
* the bound of a 1-D split product, and the plain version at lengths the
  old (lc x lb) Toeplitz could not reach.
"""

import numpy as np
import pytest
import torch

from genfer_tpu_torch import bench
from genfer_tpu_torch.ops import conv1d as C
from test_torch_mma import _mma_m16n8k8, chain_step, split

W, G = C.W, C.G
RTOL, ATOL = 2e-5, 1e-6
ATOL_GEOMETRIC = 1e-37

# (la, lb, lc), each taking the tensor-core body: dense, truncated below
# the full product, b the longer (swapped), a short b, the output beyond
# the full product (tiles without a unit), and several tiles
PLAN_LENGTHS = [
    (4096, 4096, 4096),
    (5000, 3000, 7000),
    (3000, 9000, 12000),
    (20000, 600, 20100),
    (2600, 2600, 20000),
    (12288, 12288, 12288),
]


def _f64_product(a, b, lc):
    ref = np.convolve(a.astype(np.float64), b.astype(np.float64))
    return np.pad(ref, (0, max(0, lc - len(ref))))[:lc]


def _kernel_operands(a, b, plan):
    return (b, a) if plan.swap else (a, b)


def _stretch(b, d):
    """T_d[s, r] = b[W d + r - s], zero outside b."""
    j = W * d + np.arange(W)[None, :] - np.arange(W)[:, None]
    ok = (j >= 0) & (j < len(b))
    return np.where(ok, b[np.clip(j, 0, len(b) - 1)], 0.0)


def _window(fa, P0, d):
    """A[m, s] = a[W (P0 + m - d) + s], zero outside a (fa: a's rows)."""
    q = P0 + np.arange(W) - d
    ok = (q >= 0) & (q < len(fa))
    return np.where(ok[:, None], fa[np.clip(q, 0, len(fa) - 1)], 0.0)


def _fold(a):
    fa = np.zeros(-(-len(a) // W) * W, dtype=a.dtype)
    fa[:len(a)] = a
    return fa.reshape(-1, W)


def replay(a, b, lc, unit_fn):
    """The kernel's two passes over ``fold_plan``: ``unit_fn(fa, kb, P0,
    d_lo, d_hi)`` gives a unit's W x W tile; a tile of several units is
    the sum of its slots in slot order."""
    plan = C.fold_plan(len(a), len(b), lc)
    ka, kb = _kernel_operands(a, b, plan)
    fa = _fold(ka)
    rc = -(-lc // W)
    c = np.zeros((rc, W), dtype=unit_fn.dtype)
    work = np.zeros((max(plan.slots, 1), W, W), dtype=unit_fn.dtype)
    for P0, d_lo, d_hi, slot in plan.units.tolist():
        tile = unit_fn(fa, kb, P0, d_lo, d_hi)
        if slot < 0:
            rows = min(W, rc - P0)
            c[P0:P0 + rows] = tile[:rows]
        else:
            work[slot] = tile
    for P0, _, first, n in plan.sums.tolist():
        total = np.zeros((W, W), dtype=unit_fn.dtype)
        for z in range(first, first + n):
            total += work[z]
        rows = min(W, rc - P0)
        c[P0:P0 + rows] = total[:rows]
    return c.reshape(-1)[:lc]


def _exact_unit(fa, kb, P0, d_lo, d_hi):
    return sum(_window(fa, P0, d) @ _stretch(kb, d) for d in range(d_lo, d_hi))


_exact_unit.dtype = np.float64


# ---------------------------------------------------------------- plan


@pytest.mark.parametrize("la,lb,lc", PLAN_LENGTHS)
def test_fold_plan_covers_every_pair_once(la, lb, lc):
    """Units cover every (folded output row p, diagonal d) with a's row
    p - d inside a exactly once (and no pair outside b's diagonals), none
    is empty, they come heaviest first, and a tile's slots are contiguous
    and in d order."""
    plan = C.fold_plan(la, lb, lc)
    assert C.fold_body(la, lb, lc) == "mma"
    assert plan.swap is (lb > la)
    ka, kb = (lb, la) if plan.swap else (la, lb)
    ra, nd, rc = C.fold_rows(ka, kb, lc)
    u = plan.units
    assert u.dtype == np.int32 and u.shape[1] == 4
    w = plan.weights()
    assert (w > 0).all() and (np.diff(w) <= 0).all()
    seen = np.zeros((rc, nd), dtype=np.int64)
    tiles = {}
    for P0, d_lo, d_hi, slot in u.tolist():
        assert P0 % W == 0 and 0 <= d_lo < d_hi <= nd
        seen[P0:P0 + W, d_lo:d_hi] += 1
        tiles.setdefault(P0, []).append((slot, d_lo, d_hi))
    p, d = np.meshgrid(np.arange(rc), np.arange(nd), indexing="ij")
    live = (p - d >= 0) & (p - d < ra)
    assert (seen[live] == 1).all()
    assert (seen <= 1).all()
    assert plan.covers is (len(tiles) == -(-rc // W))
    sums = {P0: (first, n) for P0, _, first, n in plan.sums.tolist()}
    used = []
    for P0, cuts in tiles.items():
        if len(cuts) == 1:
            assert cuts[0][0] == -1 and P0 not in sums
            continue
        cuts.sort()
        first, n = sums[P0]
        assert [c[0] for c in cuts] == list(range(first, first + n))
        assert [c[1] for c in cuts] == sorted(c[1] for c in cuts)
        used.extend(c[0] for c in cuts)
    assert sorted(used) == list(range(plan.slots))


@pytest.mark.parametrize("la,lb,lc", PLAN_LENGTHS[:5])
def test_two_passes_replayed_in_f64_equal_np_convolve(la, lb, lc):
    """Integer operands: every sum is exact in f64, so the replay of the
    units and the slot sum equals the product exactly, which is coverage
    of every (output, j) pair exactly once through the fold."""
    rng = np.random.default_rng(la + lb)
    a = rng.integers(-8, 9, la).astype(np.float64)
    b = rng.integers(-8, 9, lb).astype(np.float64)
    got = replay(a, b, lc, _exact_unit)
    assert np.array_equal(got, _f64_product(a, b, lc))


@pytest.mark.parametrize("n,units", [
    (65536, 919), (262144, 1391), (1 << 20, 1509),
])
def test_fold_plan_is_balanced_at_long_lengths(n, units):
    """The coarse units are near their mean, there are more units than
    the card has block slots (two an SM), and the kernel issues within a
    few percent of the useful multiply-adds: 1 + W^2 / n, full tiles on
    the diagonal, before the warps' skips."""
    plan = C.fold_plan(n, n, n)
    w = plan.weights()
    assert len(w) == units
    assert len(w) > 2 * 132
    coarse = w[w > w.max() / 2]
    assert coarse.max() <= 1.5 * coarse.mean()
    useful = n * (n + 1) // 2
    assert 1 <= C.issued_macs(plan) / useful <= 1 + W * W / n + 1e-12


@pytest.mark.parametrize("la,lb,lc,body", [
    (100, 37, 120, "ffma"), (1, 1, 1, "ffma"), (300, 7, 129, "ffma"),
    (7, 300, 300, "ffma"), (1000, 1000, 1000, "ffma"),
    (1024, 1024, 1024, "mma"),
    (100000, 511, 100000, "ffma"), (100000, 512, 100000, "mma"),
    (4096, 4096, 4096, "mma"), (262144, 262144, 262144, "mma"),
])
def test_fold_body(la, lb, lc, body):
    assert C.fold_body(la, lb, lc) == body
    plan = C.fold_plan(la, lb, lc)
    assert (len(plan.units) == 0) is (body == "ffma")


# -------------------------------------------------- fragment offsets


@pytest.mark.parametrize("dj,warp", [(0, 0), (7, 1), (15, 2), (9, 3)])
def test_fragment_offsets_name_the_folded_product(dj, warp):
    """A group staged as the kernel stages it (window word e = a[i0 + e],
    stretch word x = b[W g0 - (W - 1) + x]), fragments read at the
    kernel's offsets, the 2 x 4 mma tiles of one warp over the eight
    k-slices: the warp's 32 x 32 block of the folded product at d."""
    rng = np.random.default_rng(dj + 10 * warp)
    la, lb = 12000, 3000
    a = rng.integers(-4, 5, la).astype(np.float64)
    b = rng.integers(-4, 5, lb).astype(np.float64)
    P0, g0 = 128, 20
    a_rows, a_pitch = W + G - 1, W + 4
    i0 = W * (P0 - (g0 + G - 1))
    sA = np.zeros(a_rows * a_pitch)
    for e in range(a_rows * W):
        i = i0 + e
        sA[e // W * a_pitch + e % W] = a[i] if 0 <= i < la else 0.0
    sB = np.zeros((G + 1) * W)
    for x in range(G * W + W - 1):
        j = W * g0 - (W - 1) + x
        sB[x] = b[j] if 0 <= j < lb else 0.0
    mb, nb = (warp // 2) * 32, (warp % 2) * 32
    got = np.zeros((32, 32))
    for kk in range(0, W, 8):
        for M in range(2):
            for N in range(4):
                a_frag, b_frag = [], []
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    wm = ((mb + g - dj + G - 1) * a_pitch + kk + t
                          + 16 * M * a_pitch)
                    a_frag.append((sA[wm], sA[wm + 8 * a_pitch], sA[wm + 4],
                                   sA[wm + 8 * a_pitch + 4]))
                    x = dj * W + nb + g - kk - t + W - 1
                    b_frag.append((sB[x + 8 * N], sB[x + 8 * N - 4]))
                dd = _mma_m16n8k8(a_frag, b_frag)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for i in range(4):
                        got[16 * M + g + 8 * (i // 2),
                            8 * N + 2 * t + (i & 1)] += dd[lane][i]
    d = g0 + dj
    want = np.zeros((32, 32))
    for m in range(32):
        for n in range(32):
            want[m, n] = sum(a[W * (P0 + mb + m - d) + s]
                             * b[W * d + nb + n - s]
                             for s in range(W)
                             if 0 <= W * d + nb + n - s < lb
                             and 0 <= W * (P0 + mb + m - d) + s < la)
    assert np.array_equal(got, want)


def test_fold_identity():
    """c[W p + r] = sum_d A_d[p] T_d[:, r]: every (i, j) with i + j = k
    is one (d, s), so the folded sum is the product."""
    rng = np.random.default_rng(3)
    a, b = rng.random(700), rng.random(300)
    fa = _fold(a)
    lc = 1000
    c = np.zeros((-(-lc // W), W))
    for p in range(len(c)):
        for d in range(p + 1):
            if p - d < len(fa):
                c[p] += fa[p - d] @ _stretch(b, d)
    np.testing.assert_allclose(c.reshape(-1)[:lc], _f64_product(a, b, lc),
                               rtol=1e-13, atol=1e-13)


# ------------------------------------------------------- arithmetic


def _split_unit(fa, kb, P0, d_lo, d_hi):
    """The tensor-core body's f32 result for one unit: per diagonal a
    chain of the eight k-slices (hh, and the two cross products in cr)
    from zero accumulators, in the pessimistic tensor core of
    ``chain_step``; grp += hh + 2^-11 cr at the chain's end, grp into acc
    once a staged group."""
    unscale = np.float32(1.0 / 2048.0)
    acc = np.zeros((W, W), dtype=np.float32)
    for g0 in range(d_lo, d_hi, G):
        grp = np.zeros((W, W), dtype=np.float32)
        for d in range(g0, min(g0 + G, d_hi)):
            ah, al = split(_window(fa, P0, d), 2048.0)
            bh, bl = split(_stretch(kb, d), 2048.0)
            hh = np.zeros((W, W), dtype=np.float32)
            cr = np.zeros((W, W), dtype=np.float32)
            for k in range(0, W, 8):
                def part(x, y):
                    return (x[:, k:k + 8].astype(np.float64)
                            @ y[k:k + 8].astype(np.float64))

                hh = chain_step(hh, part(ah, bh))
                cr = chain_step(chain_step(cr, part(ah, bl)), part(al, bh))
            grp += (cr.astype(np.float64) * unscale + hh).astype(np.float32)
        acc += grp
    return acc


_split_unit.dtype = np.float32


@pytest.mark.parametrize("la,lb,lc", [
    (4096, 4096, 4096), (5000, 3000, 7000), (3000, 9000, 12000),
])
def test_split_arithmetic_holds_the_gate(la, lb, lc):
    rng = np.random.default_rng(lc)
    a = rng.random(la).astype(np.float32)
    b = rng.random(lb).astype(np.float32)
    want = _f64_product(a, b, lc)
    got = replay(a, b, lc, _split_unit)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # well inside it: the kernel is held to 2e-6 on the card
    assert (np.abs(got - want) <= 2e-6 * np.abs(want) + ATOL).all()


def test_split_arithmetic_holds_a_geometric_pair():
    """a[i] = u_i rho^i, b[j] = v_j rho^j with rho^n = 1e-36 (chip_smoke.py's
    geometric pair at a quarter of its length): every
    output k is a sum of terms of one scale rho^k, and each is held to
    the rtol at its own scale."""
    n = 4096
    rng = np.random.default_rng(36)
    rho = 10.0 ** (-36.0 / n)
    scale = rho ** np.arange(n)
    # u, v in [0.5, 1): every term is normal in f32
    a = ((0.5 + 0.5 * rng.random(n)) * scale).astype(np.float32)
    b = ((0.5 + 0.5 * rng.random(n)) * scale).astype(np.float32)
    want = _f64_product(a, b, n)
    got = replay(a, b, n, _split_unit).astype(np.float64)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= RTOL * np.abs(want) + ATOL_GEOMETRIC).all()
    assert want[-1] < 1e-32  # the last outputs: about 1e-36 x n / 4


# ------------------------------------------------- plain version, bound


@pytest.mark.parametrize("la,lb,lc", [
    (70000, 300, 70100), (129, 70000, 70000),
])
def test_plain_version_reaches_long_lengths(la, lb, lc):
    """The folded plain version needs O(la + lb + lc) memory: lengths
    whose (lc x lb) Toeplitz would take 84 MB and 20 GB."""
    rng = np.random.default_rng(la)
    a = rng.random(la).astype(np.float32)
    b = rng.random(lb).astype(np.float32)
    got = C.conv1d_trunc_f32_reference(torch.from_numpy(a),
                                       torch.from_numpy(b), lc).numpy()
    assert got.shape == (lc,) and got.dtype == np.float32
    want = np.fft.irfft(np.fft.rfft(a.astype(np.float64), la + lb)
                        * np.fft.rfft(b.astype(np.float64), la + lb),
                        la + lb)
    want = np.pad(want, (0, max(0, lc - len(want))))[:lc]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,ms", [(4096, 1.017e-4), (262144, 0.4165)])
def test_bound_of_a_1d_split_product(n, ms):
    """Three TF32 passes of the n (n + 1) / 2 useful multiply-adds at
    the data-sheet TF32 rate; the bytes bound is far below."""
    got, by = bench.product_bound((n,), (n,), (n,),
                                  passes=bench.SPLIT_PASSES)
    assert by == "tensor operations"
    macs = n * (n + 1) / 2
    assert got == pytest.approx(3 * macs / bench.TF32_MMA_PER_S * 1e3,
                                rel=1e-12)
    assert got == pytest.approx(ms, rel=2e-3)
    ffma, by = bench.product_bound((n,), (n,), (n,))
    assert by == "operations" and ffma > got
