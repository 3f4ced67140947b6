"""The port's K3 (batched), K4a (tile), K4b (grouped) and K6 (1-D) wrappers
against genfer_tpu's Pallas kernels in interpret mode and the f64 host
product.

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


@pytest.mark.parametrize("batch,sa,sb,out,sms,plan", [
    # every entry takes the single-pair plan, swap included
    (8, (512, 512), (512, 512), (512, 512), 132, (False, 4, 128)),
    (32, (256, 256), (256, 256), (256, 256), 132, (False, 8, 32)),
    (3, (95, 1), (95, 87), (95, 87), 132, (True, 3, 32)),
])
def test_batched_launch_plan(batch, sa, sb, out, sms, plan):
    assert C.batched_launch_plan(batch, sa, sb, out, sms) == plan
    assert plan == C.launch_plan(sa, sb, out, sms)


def test_batched_launch_plan_keeps_to_the_grid():
    # 16384 entries x 4 j0 ranges is over CUDA's 65535 z blocks
    with pytest.raises(ValueError, match="65535"):
        C.batched_launch_plan(16384, (512, 512), (512, 512), (512, 512), 132)
    assert C.batched_launch_plan(16383, (512, 512), (512, 512), (512, 512),
                                 132)[1] == 4


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


CARD_SHAPES = ROWSTRIP_SHAPES + [
    ((1, 130), (130, 1), (130, 130)),
    ((95, 1), (95, 87), (95, 87)),
    ((16, 5), (3, 40), (10, 12)),
    ((512, 512), (512, 512), (512, 512)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", CARD_SHAPES)
def test_tile_and_grouped_on_card(sa, sb, out):
    _card()
    rng = np.random.default_rng(5)
    a, b = rng.random(sa), rng.random(sb)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    ta, tb = _f32(a).cuda(), _f32(b).cuda()
    strip = ops.conv2d_trunc_f32(ta, tb, out)
    for kernel in (ops.conv2d_trunc_f32_tile, ops.conv2d_trunc_f32_grouped):
        before = kernel.launches
        got = kernel(ta, tb, out)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    _, splits, _ = C.launch_plan(sa, sb, out, C._sm_count(ta.device))
    if splits == 1:  # the same tile code over the same j0 range
        assert torch.equal(ops.conv2d_trunc_f32_tile(ta, tb, out), strip)


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch,sa,sb,out", [
    *BATCHED, *SWAPPED,
    (5, (256, 256), (256, 256), (256, 256)),
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
    nb = NumpyF64Backend()
    for g in range(nbatch):
        assert torch.equal(got[g], ops.conv2d_trunc_f32(ta[g], tb, out))
        np.testing.assert_allclose(got[g].cpu().numpy(),
                                   nb.conv_trunc(a[g], b, out),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("la,lb,lc", [
    (100, 37, 120), (1, 1, 1), (300, 7, 129), (7, 300, 300),
    (4096, 4096, 4096),
])
def test_conv1d_on_card(la, lb, lc):
    _card()
    rng = np.random.default_rng(la + lb)
    a, b = rng.random(la).astype(np.float32), rng.random(lb).astype(np.float32)
    before = ops.conv1d_trunc_f32.launches
    got = ops.conv1d_trunc_f32(_f32(a).cuda(), _f32(b).cuda(), lc)
    torch.cuda.synchronize()
    assert ops.conv1d_trunc_f32.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), _conv1d_f64(a, b, lc),
                               rtol=RTOL_1D, atol=ATOL)
