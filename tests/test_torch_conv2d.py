"""genfer_tpu_torch.ops.conv2d against genfer_tpu's Pallas row-strip kernel
(interpret mode) and the f64 host product.

The plain PyTorch version is what CPU tensors get; the CUDA kernel itself
is compared on the card by the ``cuda``-marked test at the end.  The f32
bar is the Pallas tests' own: rtol 5e-5 / atol 1e-6 against f64.
"""

import numpy as np
import pytest
import torch

from genfer_tpu.ops.pallas_conv2d import conv2d_pallas_rowstrip
from genfer_tpu.taylor.backend import NumpyF64Backend
from genfer_tpu_torch.ops import conv2d as C

SHAPES = [
    # tests/test_parallel_ops.py: ragged shapes of the Pallas 2-D tests
    ((5, 7), (4, 6), (8, 12)),
    ((130, 140), (120, 100), (130, 140)),
    ((100, 120), (130, 140), (130, 140)),
    ((1, 130), (130, 1), (130, 130)),
    ((70, 80), (60, 50), (70, 80)),
    ((200, 300), (150, 100), (280, 380)),
    # thin operands, as the population models route them
    ((40, 1), (40, 38), (40, 38)),
    ((1, 38), (40, 38), (40, 38)),
    # a longer than the output; output wider than the full product
    ((16, 5), (3, 40), (10, 12)),
    ((33, 64), (64, 20), (96, 83)),
]


def _operands(sa, sb, seed):
    rng = np.random.default_rng(seed)
    return rng.random(sa), rng.random(sb)


@pytest.mark.parametrize("sa,sb,out", SHAPES)
def test_reference_matches_pallas_and_host(sa, sb, out):
    import jax.numpy as jnp

    a, b = _operands(sa, sb, 13)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    pallas = np.asarray(conv2d_pallas_rowstrip(
        jnp.asarray(a), jnp.asarray(b), out, interpret=True
    ))
    got = C.conv2d_trunc_f32_reference(
        torch.from_numpy(a).float(), torch.from_numpy(b).float(), out
    ).numpy()
    assert got.shape == out and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=5e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    monkeypatch.setattr(C.conv2d_trunc_f32, "launches", 0)
    a, b = _operands((40, 1), (40, 38), 1)
    ta, tb = torch.from_numpy(a).float(), torch.from_numpy(b).float()
    got = C.conv2d_trunc_f32(ta, tb, (40, 38))
    want = C.conv2d_trunc_f32_reference(ta, tb, (40, 38))
    assert torch.equal(got, want)
    assert C.conv2d_trunc_f32.launches == 0


@pytest.mark.parametrize("bad,err", [
    (lambda a, b: (a.double(), b), TypeError),
    (lambda a, b: (a[None], b), ValueError),
    (lambda a, b: (a.t(), b), ValueError),
    (lambda a, b: (a[:0], b), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    a = torch.rand(6, 5)
    b = torch.rand(4, 3)
    with pytest.raises(err):
        C.conv2d_trunc_f32(*bad(a, b), (6, 5))


# the shapes the launch plans of the first kernel were pinned on (dense
# order 512, the thin operands of the end-to-end run, order 768 twice: its
# plan once depended on the card), then dense 256 and 384
PLAN_SHAPES = [
    ((512, 512), (512, 512), (512, 512), False),
    ((95, 1), (95, 87), (95, 87), True),
    ((308, 274), (308, 1), (308, 274), False),
    ((1, 274), (308, 274), (308, 274), True),
    ((768, 768), (768, 768), (768, 768), False),
    ((768, 700), (700, 768), (768, 768), False),
    ((256, 256), (256, 256), (256, 256), False),
    ((384, 384), (384, 384), (384, 384), False),
    # ragged, a longer than the output, output wider than the product
    ((200, 300), (150, 100), (280, 380), False),
    ((16, 5), (3, 40), (10, 12), True),
    ((33, 64), (64, 20), (96, 83), False),
    # output far beyond the product: tiles without a unit
    ((5, 7), (4, 6), (200, 150), False),
]


def _kernel_shapes(sa, sb, swap):
    return (sb, sa) if swap else (sa, sb)


def _check_plan(plan, sa, sb, out, swap):
    """Units cover every (tile, j0, j1) the clipping keeps exactly once,
    none is empty, they come heaviest first, and a tile's slots are
    contiguous and in (j0, j1) order.  Returns the units by tile."""
    assert plan.swap is swap
    ka, kb = _kernel_shapes(sa, sb, swap)
    units = plan.units
    assert units.dtype == np.int32 and units.shape[1] == 8
    w = plan.weights()
    assert (w > 0).all()
    assert (np.diff(w) <= 0).all()
    by_tile = {}
    for K0, K1, lo0, hi0, lo1, hi1, slot, _ in units.tolist():
        by_tile.setdefault((K0, K1), []).append((slot, lo0, hi0, lo1, hi1))
    kept = 0
    for K0 in range(0, out[0], C.TILE):
        for K1 in range(0, out[1], C.TILE):
            lo0, hi0, lo1, hi1 = C.tile_ranges(ka, kb, out, K0, K1)
            if hi0 <= lo0 or hi1 <= lo1:
                assert (K0, K1) not in by_tile
                continue
            kept += 1
            seen = np.zeros((hi0 - lo0, hi1 - lo1), dtype=np.int64)
            for _, u_lo0, u_hi0, u_lo1, u_hi1 in by_tile[(K0, K1)]:
                assert lo0 <= u_lo0 < u_hi0 <= hi0
                assert lo1 <= u_lo1 < u_hi1 <= hi1
                seen[u_lo0 - lo0:u_hi0 - lo0, u_lo1 - lo1:u_hi1 - lo1] += 1
            assert (seen == 1).all()
    assert kept == len(by_tile)
    tiles = (-(-out[0] // C.TILE)) * (-(-out[1] // C.TILE))
    assert plan.covers is (kept == tiles)
    # slots: none for a tile of one unit; else a run in (j0, j1) order
    sums = {(K0, K1): (first, n) for K0, K1, first, n in plan.sums.tolist()}
    used = []
    for tile, cuts in by_tile.items():
        if len(cuts) == 1:
            assert cuts[0][0] == -1 and tile not in sums
            continue
        cuts.sort()
        first, n = sums[tile]
        assert [c[0] for c in cuts] == list(range(first, first + n))
        assert [c[1:] for c in cuts] == sorted(c[1:] for c in cuts)
        used.extend(c[0] for c in cuts)
    assert sorted(used) == list(range(plan.slots))
    return by_tile


@pytest.mark.parametrize("sa,sb,out,swap", PLAN_SHAPES)
def test_unit_plan(sa, sb, out, swap):
    _check_plan(C.unit_plan(sa, sb, out), sa, sb, out, swap)


@pytest.mark.parametrize("sa,sb,out,swap", PLAN_SHAPES)
def test_unit_plan_j0_only(sa, sb, out, swap):
    """The plan of the tensor-core kernels (``cut_j1=False``) is a unit
    plan like the other, and cuts j0 alone: a tile has one j1 range,
    unless its j0 range is too short to cut (then j1 is cut at multiples
    of a tile's width)."""
    plan = C.unit_plan(sa, sb, out, cut_j1=False)
    by_tile = _check_plan(plan, sa, sb, out, swap)
    for cuts in by_tile.values():
        j0_cuts = {c[1:3] for c in cuts}
        j1_cuts = sorted({c[3:5] for c in cuts})
        n0 = max(hi for _, hi in j0_cuts) - min(lo for lo, _ in j0_cuts)
        if n0 >= 2 * C.MMA_MIN_ROWS:
            assert len(j1_cuts) == 1
        else:
            assert len(j0_cuts) == 1
            for lo, _ in j1_cuts[1:]:
                assert (lo - j1_cuts[0][0]) % C.MMA_J1_STEP == 0
        if len(j0_cuts) > 1:
            assert min(hi - lo for lo, hi in j0_cuts) >= C.MMA_MIN_ROWS


@pytest.mark.parametrize("order,units,issued", [
    (256, 160, 1.551), (384, 500, 1.355), (512, 963, 1.261),
    (768, 1274, 1.171),
])
def test_unit_plan_j0_only_is_balanced(order, units, issued):
    """At the dense orders: the coarse units are near their mean, orders
    from 384 have more units than a card has block slots (396: the
    kernels no longer run one block a tile), and the kernel issues
    1.17-1.55 times the useful multiply-adds (full tiles, and the band's
    edges)."""
    shape = (order, order)
    plan = C.unit_plan(shape, shape, shape, cut_j1=False)
    w = plan.weights()
    assert len(w) == units
    coarse = w[w > w.max() / 2]
    assert coarse.max() <= 1.5 * coarse.mean()
    if order >= 384:
        assert len(w) > 396
    useful = sum((k0 + 1) * (k1 + 1) for k0 in range(order)
                 for k1 in range(order))
    assert C.issued_macs(plan, shape, shape) / useful == pytest.approx(
        issued, abs=1e-3)


@pytest.mark.parametrize("sa,sb,body", [
    ((512, 512), (512, 512), "mma"),
    ((130, 140), (120, 100), "mma"),
    ((95, 87), (95, 8), "mma"),
    ((95, 1), (95, 87), "ffma"),  # the one-column operand becomes b
    ((308, 274), (308, 1), "ffma"),
    ((16, 5), (3, 40), "ffma"),  # swapped: b is (16, 5)
    ((1, 274), (308, 274), "mma"),  # b is the one-row operand
])
def test_tile_body_by_shape(sa, sb, body):
    assert C.tile_body(sa, sb) == body
    assert C.tile_body(sb, sa) == body


@pytest.mark.parametrize("sa,sb,out", [
    ((512, 512), (512, 512), (512, 512)),
    ((256, 256), (256, 256), (256, 256)),
    ((384, 384), (384, 384), (384, 384)),
    ((768, 768), (768, 768), (768, 768)),
])
def test_unit_plan_is_balanced(sa, sb, out):
    """Where tiles can be cut, no coarse unit is above 1.5 times the coarse
    units' mean, the fine units of the lightest tiles (the tail) are
    lighter than any of them, and there are enough units to keep a card's
    SMs busy to the end."""
    w = C.unit_plan(sa, sb, out).weights()
    coarse = w[w > w.max() / 2]
    assert coarse.max() <= 1.5 * coarse.mean()
    assert len(coarse) >= 0.5 * len(w) or len(w) > C.UNIT_TARGET
    assert len(w) >= 396  # three 128-thread blocks on each of 132 SMs


def test_unit_plan_depends_on_the_shapes_alone():
    """No SM count, device or batch size enters the plan: the same shapes
    give the same table, so the result's bits are the same on any card."""
    import inspect

    assert list(inspect.signature(C.unit_plan.__wrapped__).parameters) == [
        "a_shape", "b_shape", "out_shape", "cut_j1"]
    args = ((512, 512), (512, 512), (512, 512))
    for cut_j1 in (True, False):
        first = C.unit_plan(*args, cut_j1)
        C.unit_plan.cache_clear()
        again = C.unit_plan(*args, cut_j1)
        assert first is not again
        assert np.array_equal(first.units, again.units)
        assert np.array_equal(first.sums, again.sums)


@pytest.mark.parametrize("sa,sb,out", [
    ((70, 80), (60, 50), (70, 80)),
    ((33, 64), (64, 20), (96, 83)),
    ((95, 1), (95, 87), (95, 87)),
])
def test_unit_plan_reproduces_the_product(monkeypatch, sa, sb, out):
    """The two passes as the kernels run them, in f64 on the host: every
    unit's partial tile from its block of b alone, slots added in slot
    order, single-unit tiles written directly."""
    monkeypatch.setattr(C, "MIN_ROWS", 8)
    monkeypatch.setattr(C, "UNIT_TARGET", 4096)
    C.unit_plan.cache_clear()
    try:
        plan = C.unit_plan(sa, sb, out)
    finally:
        C.unit_plan.cache_clear()
    assert plan.slots > 1
    a, b = _operands(sa, sb, 3)
    nb = NumpyF64Backend()
    want = nb.conv_trunc(a, b, out)
    ka, kb = (b, a) if plan.swap else (a, b)
    c = np.zeros(out)
    work = np.zeros((plan.slots, C.TILE, C.TILE))
    for K0, K1, lo0, hi0, lo1, hi1, slot, _ in plan.units.tolist():
        block = np.zeros_like(kb)
        block[lo0:hi0, lo1:hi1] = kb[lo0:hi0, lo1:hi1]
        part = nb.conv_trunc(ka, block, (K0 + C.TILE, K1 + C.TILE))
        part = part[K0:, K1:]
        if slot < 0:
            r, q = min(C.TILE, out[0] - K0), min(C.TILE, out[1] - K1)
            c[K0:K0 + r, K1:K1 + q] = part[:r, :q]
        else:
            work[slot] = part
    for K0, K1, first, n in plan.sums.tolist():
        r, q = min(C.TILE, out[0] - K0), min(C.TILE, out[1] - K1)
        c[K0:K0 + r, K1:K1 + q] = work[first:first + n].sum(axis=0)[:r, :q]
    np.testing.assert_allclose(c, want, rtol=1e-12, atol=1e-300)


CARD_SHAPES = SHAPES + [
    ((95, 1), (95, 87), (95, 87)),
    # a's rows not 16-byte aligned: the 4-byte staging path
    ((130, 141), (120, 100), (130, 140)),
    ((256, 256), (256, 256), (256, 256)),
    ((512, 512), (512, 512), (512, 512)),
    ((768, 768), (768, 768), (768, 768)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")


def f64_product(a, b, out):
    """The f64 product to hold the kernel against: genfer_tpu's host
    backend, or above order 256 (where that takes a minute a product)
    the port's own f64 product on the card, itself held against
    genfer_tpu's at rtol 1e-12 in tests/test_torch_backend.py."""
    if max(out) <= 256:
        return NumpyF64Backend().conv_trunc(a, b, out)
    from genfer_tpu_torch.taylor.backend import _conv_impl

    return _conv_impl(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                      out).cpu().numpy()


def extreme_operands(seed):
    """(130, 140) x (120, 100) with column scales spread over 1e-30..1e30
    (a) and 1e-6..1e6 (b): every product stays inside f32's range."""
    a, b = _operands((130, 140), (120, 100), seed)
    return (a * 10.0 ** np.linspace(-30, 30, 140),
            b * 10.0 ** np.linspace(-6, 6, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", CARD_SHAPES)
def test_kernel_on_card(sa, sb, out):
    _card()
    a, b = _operands(sa, sb, 13)
    want = f64_product(a, b, out)
    ta = torch.from_numpy(a).float().cuda()
    tb = torch.from_numpy(b).float().cuda()
    before = C.conv2d_trunc_f32.launches
    got = C.conv2d_trunc_f32(ta, tb, out)
    torch.cuda.synchronize()
    assert C.conv2d_trunc_f32.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=5e-5, atol=1e-6)
    # the slot sum has a fixed order: a second call gives the same bits
    assert torch.equal(C.conv2d_trunc_f32(ta, tb, out), got)


@pytest.mark.cuda
def test_kernel_on_card_extreme_scales():
    """Relative accuracy holds per column scale, from 1e-36 to 1e36."""
    _card()
    a, b = extreme_operands(13)
    out = (130, 140)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    got = C.conv2d_trunc_f32(torch.from_numpy(a).float().cuda(),
                             torch.from_numpy(b).float().cuda(), out)
    got = got.cpu().numpy().astype(np.float64)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 5e-5 * np.abs(want) + 1e-37).all()


@pytest.mark.cuda
def test_kernel_on_card_zero_fills_beyond_the_product():
    """Output tiles that no unit reaches (c beyond a + b - 1) are zero."""
    _card()
    a, b = _operands((5, 7), (4, 6), 2)
    out = (200, 150)
    assert not C.unit_plan((5, 7), (4, 6), out).covers
    got = C.conv2d_trunc_f32(torch.from_numpy(a).float().cuda(),
                             torch.from_numpy(b).float().cuda(), out)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=5e-5, atol=1e-6)
