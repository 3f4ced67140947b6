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


@pytest.mark.parametrize("sa,sb,out,sms,plan", [
    # dense order 512 on 132 SMs: 64 tiles, 16 j0 groups cut in 4
    ((512, 512), (512, 512), (512, 512), 132, (False, 4, 128)),
    # thin operands: the smaller one becomes the kernel's b
    ((95, 1), (95, 87), (95, 87), 132, (True, 3, 32)),
    ((308, 274), (308, 1), (308, 274), 132, (False, 10, 32)),
    ((1, 274), (308, 274), (308, 274), 132, (True, 1, 32)),
    # enough tiles to fill the card: no split
    ((768, 768), (768, 768), (768, 768), 132, (False, 2, 384)),
    ((768, 768), (768, 768), (768, 768), 64, (False, 1, 768)),
])
def test_launch_plan(sa, sb, out, sms, plan):
    swap, splits, rows = C.launch_plan(sa, sb, out, sms)
    assert (swap, splits, rows) == plan
    span = min((sa if swap else sb)[0], out[0])
    assert rows % C.GROUP == 0
    assert (splits - 1) * rows < span <= splits * rows


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb,out", SHAPES)
def test_kernel_on_card(sa, sb, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    a, b = _operands(sa, sb, 13)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    ta = torch.from_numpy(a).float().cuda()
    tb = torch.from_numpy(b).float().cuda()
    before = C.conv2d_trunc_f32.launches
    got = C.conv2d_trunc_f32(ta, tb, out)
    torch.cuda.synchronize()
    assert C.conv2d_trunc_f32.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=5e-5, atol=1e-6)
