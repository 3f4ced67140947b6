"""``genfer_tpu_torch/ops/blocked_conv.py`` against genfer_tpu's
``ops/blocked_conv.py`` on the CPU: the block-pair plan, the blocked
product with K1's plain version and K5's inside, and the spot check."""

import numpy as np
import pytest
import torch

from genfer_tpu_torch.ops import blocked_conv as B
from genfer_tpu_torch.ops import ozaki_conv as Z
from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64_batched
from genfer_tpu_torch.taylor.host import NumpyF64Backend

# (a shape, b shape, out shape, P): square truncated, ragged, full, and an
# output narrower than one block
CASES = [
    ((40, 40), (40, 40), (40, 40), 16),
    ((37, 29), (23, 41), (50, 45), 16),
    ((24, 24), (24, 24), (47, 47), 8),
    ((30, 30), (30, 30), (10, 30), 16),
]


@pytest.mark.parametrize("sa,sb,out,P", CASES)
def test_block_pairs_equal_genfer_tpu(sa, sb, out, P):
    from genfer_tpu.ops import blocked_conv as J

    assert B.block_pairs(sa, sb, out, P) == J.block_pairs(sa, sb, out, P)


@pytest.mark.parametrize("group", [0, 3])
@pytest.mark.parametrize("sa,sb,out,P", CASES)
def test_conv2d_blocked_matches_genfer_tpu(sa, sb, out, P, group):
    """The blocked product with K1's batched plain version inside equals
    genfer_tpu's with its f64 product inside at rtol 1e-12 (and host f64),
    for one dispatch and for groups of 3 pairs (the last one short)."""
    import jax.numpy as jnp

    from genfer_tpu.ops import blocked_conv as J
    from genfer_tpu.taylor.backend import _conv_dense

    rng = np.random.default_rng(sum(sa) + P)
    a, b = rng.random(sa), rng.random(sb)
    full = (2 * P - 1, 2 * P - 1)
    got = B.conv2d_blocked(
        torch.from_numpy(a), torch.from_numpy(b), out, P,
        lambda x, y: conv2d_trunc_f64_batched(x.contiguous(),
                                              y.contiguous(), full),
        group=group).numpy()
    want = np.asarray(J.conv2d_blocked(
        jnp.asarray(a), jnp.asarray(b), out, P,
        lambda x, y: _conv_dense(jnp, x, y, full), group=group,
        out_dtype=jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, NumpyF64Backend().conv_trunc(a, b, out),
                               rtol=1e-12)
    assert B.spot_check(a, b, got, 16) == J.spot_check(a, b, got, 16)
    assert B.spot_check(a, b, got, 16) < 1e-13


def test_conv2d_blocked_with_the_ozaki_route_inside():
    """K5's plain version as ``inner`` (one pair a call), pair_bits 7:
    f64-class against host."""
    rng = np.random.default_rng(4)
    a, b = rng.random((40, 40)), rng.random((40, 40))
    P = 16
    full = (2 * P - 1, 2 * P - 1)

    def inner(x, y):
        return torch.stack([Z.ozaki_conv2d(x[z].contiguous(),
                                           y[z].contiguous(), full)
                            for z in range(x.shape[0])])

    got = B.conv2d_blocked(torch.from_numpy(a), torch.from_numpy(b),
                           (40, 40), P, inner, group=4).numpy()
    want = NumpyF64Backend().conv_trunc(a, b, (40, 40))
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 1e-14
    assert B.spot_check(a, b, got, 32) < 1e-13


def test_pad_blocks_layout():
    x = torch.arange(35.0).reshape(5, 7)
    blocks = B._pad_blocks(x, 4)
    assert blocks.shape == (2, 2, 4, 4)
    assert torch.equal(blocks[1, 1, 0, :3], x[4, 4:7])
    assert float(blocks[1, 1, 1:].abs().sum()) == 0.0
