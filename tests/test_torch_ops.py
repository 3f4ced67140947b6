"""The port's K3 (batched), K4a (tile), K4b (grouped) and K6 (1-D) wrappers
against genfer_tpu's Pallas kernels in interpret mode and the f64 host
product, and K3's grid over K2's work-unit plan.  (The arithmetic of the
tensor-core kernels K4a and K4b is emulated in tests/test_torch_mma.py.)

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are compared on the card by the ``cuda``-marked tests at the
end.  Shapes, seeds and tolerances are those of the Pallas tests in
tests/test_parallel_ops.py: rtol 5e-5 / atol 1e-6 against f64 for the 2-D
products, rtol 2e-5 / atol 1e-6 for the 1-D one.  The grouped kernel has
no Pallas test there; it takes the row-strip test's shapes (the largest,
14 s in interpret mode, left out).
"""

import numpy as np
import pytest
import torch

from genfer_tpu.ops.pallas_conv import conv1d_pallas
from genfer_tpu.ops.pallas_conv2d import (
    conv2d_pallas_batched,
    conv2d_pallas_grouped,
    conv2d_pallas_tile,
)
from genfer_tpu.taylor.backend import NumpyF64Backend
from genfer_tpu_torch import ops
from genfer_tpu_torch.ops import conv1d as C1
from genfer_tpu_torch.ops import conv2d as C

RTOL, ATOL = 5e-5, 1e-6
RTOL_1D = 2e-5

# test_pallas_conv2d_rowstrip_interpret: RandomState(13), drawn in order
ROWSTRIP_SHAPES = [
    ((5, 7), (4, 6), (8, 12)),
    ((70, 80), (60, 50), (70, 80)),
    ((200, 300), (150, 100), (280, 380)),
]
# test_pallas_conv2d_batched_interpret: RandomState(11)
BATCHED = [
    (3, (5, 7), (4, 6), (8, 12)),
    (4, (70, 80), (60, 50), (70, 80)),
    (2, (1, 130), (130, 1), (130, 130)),
]
# test_pallas_conv2d_batched_swapped_operands: RandomState(12)
SWAPPED = [
    (3, (5, 7), (4, 6), (8, 12)),
    (4, (70, 80), (60, 50), (70, 80)),
    (2, (130, 1), (1, 130), (130, 130)),
]


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


def _conv1d_operands():
    a = np.random.RandomState(0).rand(100).astype(np.float32)
    b = np.random.RandomState(1).rand(37).astype(np.float32)
    return a, b


def _conv1d_f64(a, b, n):
    ref = np.convolve(a.astype(np.float64), b.astype(np.float64))
    return np.pad(ref, (0, max(0, n - len(ref))))[:n]


@pytest.mark.parametrize("kernel,pallas,i", [
    *((ops.conv2d_trunc_f32_tile, conv2d_pallas_tile, i) for i in range(3)),
    *((ops.conv2d_trunc_f32_grouped, conv2d_pallas_grouped, i)
      for i in range(2)),
])
def test_tile_and_grouped_match_pallas(kernel, pallas, i):
    import jax.numpy as jnp

    sa, sb, out = ROWSTRIP_SHAPES[i]
    a, b = _rowstrip_operands(i)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    ref = np.asarray(pallas(jnp.asarray(a), jnp.asarray(b), out,
                            interpret=True))
    got = kernel(_f32(a), _f32(b), out).numpy()
    assert got.shape == out and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", range(len(BATCHED)))
def test_batched_matches_pallas(i):
    import jax.numpy as jnp

    nbatch, sa, sb, out = BATCHED[i]
    a, b = _batched_operands(i)
    ref = np.asarray(conv2d_pallas_batched(jnp.asarray(a), jnp.asarray(b),
                                           out, interpret=True))
    got = ops.conv2d_trunc_f32_batched(_f32(a), _f32(b), out).numpy()
    assert got.shape == (nbatch, *out) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    nb = NumpyF64Backend()
    for g in range(nbatch):
        np.testing.assert_allclose(got[g], nb.conv_trunc(a[g], b, out),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", range(len(SWAPPED)))
def test_batched_swapped_operands_match_pallas(i):
    """One shared LHS and a batch of RHS: the batched call with the
    operands swapped, as in genfer_tpu."""
    import jax.numpy as jnp

    nbatch, sa, sb, out = SWAPPED[i]
    a, b = _swapped_operands(i)
    ref = np.asarray(conv2d_pallas_batched(jnp.asarray(b), jnp.asarray(a),
                                           out, interpret=True))
    got = ops.conv2d_trunc_f32_batched(_f32(b), _f32(a), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    nb = NumpyF64Backend()
    for g in range(nbatch):
        np.testing.assert_allclose(got[g], nb.conv_trunc(a, b[g], out),
                                   rtol=RTOL, atol=ATOL)


def test_conv1d_matches_pallas():
    import jax.numpy as jnp

    a, b = _conv1d_operands()
    ref = np.asarray(conv1d_pallas(jnp.asarray(a), jnp.asarray(b), 120,
                                   interpret=True))
    got = ops.conv1d_trunc_f32(_f32(a), _f32(b), 120).numpy()
    assert got.shape == (120,) and got.dtype == np.float32
    np.testing.assert_allclose(got, _conv1d_f64(a, b, 120), rtol=RTOL_1D,
                               atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL_1D, atol=ATOL)


@pytest.mark.parametrize("la,lb,lc", [
    (300, 200, 450), (1, 129, 129), (129, 1, 200),
])
def test_conv1d_matches_pallas_across_the_fold(la, lb, lc):
    """Lengths that cross the plain version's 64-word rows: a of one
    row, b of one word, a product of several rows and diagonals."""
    import jax.numpy as jnp

    rng = np.random.default_rng(la * 1000 + lb)
    a = rng.random(la).astype(np.float32)
    b = rng.random(lb).astype(np.float32)
    ref = np.asarray(conv1d_pallas(jnp.asarray(a), jnp.asarray(b), lc,
                                   interpret=True))
    got = ops.conv1d_trunc_f32(_f32(a), _f32(b), lc).numpy()
    assert got.shape == (lc,) and got.dtype == np.float32
    np.testing.assert_allclose(got, _conv1d_f64(a, b, lc), rtol=RTOL_1D,
                               atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL_1D, atol=ATOL)


@pytest.mark.parametrize("la,lb,lc", [
    (1, 1, 1), (5, 3, 2), (3, 5, 20), (300, 7, 129), (7, 300, 300),
])
def test_conv1d_reference_edge_lengths(la, lb, lc):
    """Truncated below the full product, padded beyond it, and either
    operand the longer."""
    rng = np.random.default_rng(la * 1000 + lb)
    a, b = rng.random(la).astype(np.float32), rng.random(lb).astype(np.float32)
    got = C1.conv1d_trunc_f32_reference(_f32(a), _f32(b), lc).numpy()
    np.testing.assert_allclose(got, _conv1d_f64(a, b, lc), rtol=RTOL_1D,
                               atol=ATOL)


@pytest.mark.parametrize("wrapper,args", [
    (ops.conv2d_trunc_f32_tile, ((6, 5), (4, 3), (6, 5))),
    (ops.conv2d_trunc_f32_grouped, ((6, 5), (4, 3), (6, 5))),
    (ops.conv2d_trunc_f32_batched, ((2, 6, 5), (4, 3), (6, 5))),
    (ops.conv1d_trunc_f32, ((9,), (4,), 11)),
])
def test_wrappers_on_cpu_launch_nothing(monkeypatch, wrapper, args):
    monkeypatch.setattr(wrapper, "launches", 0)
    sa, sb, out = args
    wrapper(torch.rand(*sa), torch.rand(*sb), out)
    assert wrapper.launches == 0


@pytest.mark.parametrize("call,err", [
    (lambda: ops.conv2d_trunc_f32_batched(torch.rand(6, 5), torch.rand(4, 3),
                                          (6, 5)), ValueError),
    (lambda: ops.conv2d_trunc_f32_batched(
        torch.rand(2, 6, 5).double(), torch.rand(4, 3), (6, 5)), TypeError),
    (lambda: ops.conv2d_trunc_f32_batched(
        torch.rand(2, 5, 6).transpose(1, 2), torch.rand(4, 3), (6, 5)),
     ValueError),
    (lambda: ops.conv2d_trunc_f32_grouped(torch.rand(6, 5), torch.rand(4, 3),
                                          (0, 5)), ValueError),
    (lambda: ops.conv1d_trunc_f32(torch.rand(6, 1), torch.rand(4), 6),
     ValueError),
    (lambda: ops.conv1d_trunc_f32(torch.rand(6), torch.rand(4), 0),
     ValueError),
    (lambda: ops.conv1d_trunc_f32(torch.rand(6), torch.rand(0), 6),
     ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("batch,sa,sb,out,swap", [
    # every entry takes the single-pair plan, swap included
    (8, (512, 512), (512, 512), (512, 512), False),
    (32, (256, 256), (256, 256), (256, 256), False),
    (3, (95, 1), (95, 87), (95, 87), True),
])
def test_batched_launch_plan(batch, sa, sb, out, swap):
    """The batched plan is the per-pair plan repeated: the table both
    wrappers look up is keyed by one pair's shapes, and the batched grid
    holds every (unit, entry) once, all entries of a unit side by side."""
    import inspect

    assert list(inspect.signature(C._plan_on_card.__wrapped__).parameters) == [
        "a_shape", "b_shape", "out_shape", "device", "cut_j1", "window"]
    plan = C.unit_plan(sa, sb, out)
    assert plan.swap is swap
    blocks = C.batched_blocks(batch, plan)
    assert blocks == batch * len(plan.units)
    # the kernel's index math: unit = block // batch, entry = block % batch
    pairs = {divmod(block, batch) for block in range(blocks)}
    assert pairs == {(u, g) for u in range(len(plan.units))
                     for g in range(batch)}


def test_batched_launch_plan_keeps_to_the_grid():
    # the batch rides the grid's x axis: 16384 entries of order 512, once
    # over the z axis's limit, now fit; 2^31 blocks do not
    plan = C.unit_plan((512, 512), (512, 512), (512, 512))
    assert C.batched_blocks(16384, plan) == 16384 * len(plan.units)
    with pytest.raises(ValueError, match="2147483647"):
        C.batched_blocks((1 << 31) // len(plan.units) + 1, plan)


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _f64_product(a, b, out):
    """genfer_tpu's host f64 product, or above order 256 (where that
    takes a minute a product) the port's plain f64 product on the card
    (K1's plain version), itself held against genfer_tpu's in
    tests/test_torch_backend.py and tests/test_torch_conv2d_f64.py."""
    if max(out) <= 256:
        return NumpyF64Backend().conv_trunc(a, b, out)
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64_reference

    return conv2d_trunc_f64_reference(
        torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
        out).cpu().numpy()


CARD_SHAPES = ROWSTRIP_SHAPES + [
    ((1, 130), (130, 1), (130, 130)),
    ((95, 1), (95, 87), (95, 87)),
    ((16, 5), (3, 40), (10, 12)),
    # a's rows not 16-byte aligned
    ((130, 141), (120, 100), (130, 140)),
    ((512, 512), (512, 512), (512, 512)),
    ((768, 768), (768, 768), (768, 768)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", CARD_SHAPES)
def test_tile_and_grouped_on_card(sa, sb, out):
    _card()
    rng = np.random.default_rng(5)
    a, b = rng.random(sa), rng.random(sb)
    want = _f64_product(a, b, out)
    ta, tb = _f32(a).cuda(), _f32(b).cuda()
    strip = ops.conv2d_trunc_f32(ta, tb, out)
    got = {}
    for kernel in (ops.conv2d_trunc_f32_tile, ops.conv2d_trunc_f32_grouped):
        before = kernel.launches
        got[kernel] = kernel(ta, tb, out)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        np.testing.assert_allclose(got[kernel].cpu().numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        # the slot sum has a fixed order: a second call gives the same bits
        assert torch.equal(kernel(ta, tb, out), got[kernel])
    tile = got[ops.conv2d_trunc_f32_tile].cpu().numpy()
    # K4a and K4b run the same split-TF32 arithmetic in another j0 order
    np.testing.assert_allclose(
        got[ops.conv2d_trunc_f32_grouped].cpu().numpy(), tile, rtol=1e-5,
        atol=0.0)
    # K4a runs three TF32 passes on operands split into hi + 2^-11 lo and
    # drops lo*lo (2^-22 relative); K2 runs f32 FMAs.  Each reads within
    # ~5e-7 relative of f64 on these positive operands (the truncation
    # inside an mma chain included), and they are held to 4e-6 of each
    # other: 2e-6, the mark either is held to against f64, twice
    np.testing.assert_allclose(tile, strip.cpu().numpy(), rtol=4e-6,
                               atol=0.0)


@pytest.mark.cuda
def test_tile_and_grouped_on_card_extreme_scales():
    """Column scales from 1e-30 to 1e30 (a) and 1e-6 to 1e6 (b): the
    scaled low part keeps every column at the rtol of its own scale."""
    _card()
    rng = np.random.default_rng(13)
    out = (130, 140)
    a = rng.random((130, 140)) * 10.0 ** np.linspace(-30, 30, 140)
    b = rng.random((120, 100)) * 10.0 ** np.linspace(-6, 6, 100)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    ta, tb = _f32(a).cuda(), _f32(b).cuda()
    for kernel in (ops.conv2d_trunc_f32_tile, ops.conv2d_trunc_f32_grouped):
        got = kernel(ta, tb, out)
        assert torch.equal(kernel(ta, tb, out), got)
        have = got.cpu().numpy().astype(np.float64)
        assert np.isfinite(have).all()
        assert (np.abs(have - want) <= RTOL * np.abs(want) + 1e-37).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch,sa,sb,out", [
    *BATCHED, *SWAPPED,
    (5, (256, 256), (256, 256), (256, 256)),
    (32, (130, 140), (120, 100), (130, 140)),
    (32, (120, 100), (130, 140), (130, 140)),
    (3, (512, 512), (512, 512), (512, 512)),
    (2, (768, 768), (768, 768), (768, 768)),
    # entries whose rows are not 16-byte aligned: the 4-byte staging path
    (3, (130, 141), (120, 100), (130, 140)),
    # entries smaller than the shared operand: the batch becomes the
    # kernel's b (stride) and the shared one its a (stride 0)
    (3, (95, 1), (95, 87), (95, 87)),
    (4, (5, 7), (70, 80), (70, 80)),
])
def test_batched_on_card(nbatch, sa, sb, out):
    """Every entry equals the single-pair kernel bit for bit."""
    _card()
    rng = np.random.default_rng(7)
    a, b = rng.random((nbatch, *sa)), rng.random(sb)
    ta, tb = _f32(a).cuda(), _f32(b).cuda()
    before = ops.conv2d_trunc_f32_batched.launches
    got = ops.conv2d_trunc_f32_batched(ta, tb, out)
    torch.cuda.synchronize()
    assert ops.conv2d_trunc_f32_batched.launches == before + 1
    assert got.shape == (nbatch, *out)
    for g in range(nbatch):
        assert torch.equal(got[g], ops.conv2d_trunc_f32(ta[g], tb, out))
        np.testing.assert_allclose(got[g].cpu().numpy(),
                                   _f64_product(a[g], b, out),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch", [3, 32])
def test_batched_on_card_extreme_scales(nbatch):
    """Column scales from 1e-30 to 1e30 (a) and 1e-6 to 1e6 (b): relative
    accuracy holds at every column's own scale, and entries keep the
    single-pair kernel's bits."""
    _card()
    rng = np.random.default_rng(17)
    out = (130, 140)
    a = rng.random((nbatch, 130, 140)) * 10.0 ** np.linspace(-30, 30, 140)
    b = rng.random((120, 100)) * 10.0 ** np.linspace(-6, 6, 100)
    ta, tb = _f32(a).cuda(), _f32(b).cuda()
    got = ops.conv2d_trunc_f32_batched(ta, tb, out)
    nb = NumpyF64Backend()
    for g in range(nbatch):
        assert torch.equal(got[g], ops.conv2d_trunc_f32(ta[g], tb, out))
        want = nb.conv_trunc(a[g], b, out)
        have = got[g].cpu().numpy().astype(np.float64)
        assert np.isfinite(have).all()
        assert (np.abs(have - want) <= RTOL * np.abs(want) + 1e-37).all()


@pytest.mark.cuda
@pytest.mark.parametrize("la,lb,lc", [
    (100, 37, 120), (1, 1, 1), (300, 7, 129), (7, 300, 300),
    (4096, 4096, 4096), (16384, 16384, 16384), (65536, 65536, 65536),
    (262144, 262144, 262144),
    # b the longer, truncated, output beyond the full product
    (3000, 9000, 12000), (2600, 2600, 20000),
    # either side of the shorter operand's threshold for the FFMA body
    (100000, 511, 100000), (100000, 512, 100000),
    # the cap: int32 index math and the grid at 2^20
    (1 << 20, 1 << 20, 1 << 20),
])
def test_conv1d_on_card(la, lb, lc):
    """Held to the folded product in f64 on the card (np.convolve at
    these lengths would take minutes), the same bits twice."""
    _card()
    rng = np.random.default_rng(la + lb)
    a, b = rng.random(la).astype(np.float32), rng.random(lb).astype(np.float32)
    ta, tb = _f32(a).cuda(), _f32(b).cuda()
    before = ops.conv1d_trunc_f32.launches
    got = ops.conv1d_trunc_f32(ta, tb, lc)
    torch.cuda.synchronize()
    assert ops.conv1d_trunc_f32.launches == before + 1
    assert got.shape == (lc,)
    want = C1.folded_product(ta.double(), tb.double(), lc).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL_1D,
                               atol=ATOL)
    assert torch.equal(ops.conv1d_trunc_f32(ta, tb, lc), got)
