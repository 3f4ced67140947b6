"""Truncated 2-D Cauchy products by P x P blocks: the twin of genfer_tpu's
``ops/blocked_conv.py``.

Write ``a(x) = sum_I a_I(x) x^(P*I)`` with P x P coefficient blocks (per
axis); then

    a * b = sum_{I,J} (a_I * b_J) x^(P*(I+J))

where each small product ``a_I * b_J`` is a FULL (untruncated) (2P-1,
2P-1) product of P x P operands, computed by one of the port's kernels
(``inner``), whose memory is bounded by P, not by the total order.  Pairs
whose offset lands wholly above the truncation bound are skipped; the
boundary pairs compute their out-of-range half and drop it.

``bench --highorder`` runs it at orders 1024 and 2048 with K2 (f32, P =
512), K1 (f64, P = 256) and K5 (f64, the ozaki route, P = 512) inside.
No backend routes a product here.

What genfer_tpu's version does for the TPU is left out: the pairs of a
group run as one batched call of ``inner`` (eager torch needs no uniform
shape, so the last group is not padded), not a ``fori_loop`` traced once;
the group size keeps its meaning (pairs a dispatch), but no watchdog
bounds a dispatch here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def block_pairs(a_shape, b_shape, out_shape, P: int):
    """Static block-pair plan: list of (i0, i1, j0, j1) block indices
    whose product contributes below the truncation bound."""
    ma0 = -(-a_shape[0] // P)
    ma1 = -(-a_shape[1] // P)
    mb0 = -(-b_shape[0] // P)
    mb1 = -(-b_shape[1] // P)
    pairs = []
    for i0 in range(ma0):
        for j0 in range(mb0):
            if P * (i0 + j0) >= out_shape[0]:
                continue
            for i1 in range(ma1):
                for j1 in range(mb1):
                    if P * (i1 + j1) >= out_shape[1]:
                        continue
                    pairs.append((i0, i1, j0, j1))
    return pairs


def _pad_blocks(x, P: int):
    """Pad to a multiple of P per axis and cut into (m0, m1, P, P)."""
    s0, s1 = x.shape
    m0, m1 = -(-s0 // P), -(-s1 // P)
    xp = torch.zeros((m0 * P, m1 * P), dtype=x.dtype, device=x.device)
    xp[:s0, :s1] = x
    return xp.reshape(m0, P, m1, P).permute(0, 2, 1, 3)


def conv2d_blocked(a, b, out_shape, P: int, inner: Callable,
                   group: int = 0, out_dtype=None):
    """Truncated 2-D Cauchy product via P-block decomposition.

    ``inner(a_blocks, b_blocks) -> (n, 2P-1, 2P-1)`` computes the full
    small products of ``n`` pairs of P x P blocks (``a_blocks`` and
    ``b_blocks`` of shape (n, P, P)) in one call.  ``group > 0`` sends the
    pair list to ``inner`` in groups of that many pairs; ``group == 0``
    sends all of them at once.  The small products are added into the
    result at their offsets in pair order, so the sum order is fixed."""
    c0, c1 = int(out_shape[0]), int(out_shape[1])
    pairs = block_pairs(a.shape, b.shape, (c0, c1), P)
    dtype = out_dtype or a.dtype
    ab = _pad_blocks(a, P)
    bb = _pad_blocks(b, P)
    # the accumulator is padded so that every (2P-1) small product fits
    # at its offset; cropped at the end
    acc = torch.zeros((c0 + 2 * P, c1 + 2 * P), dtype=dtype,
                      device=a.device)
    if group <= 0 or group > len(pairs):
        group = len(pairs)
    n = 2 * P - 1
    for k in range(0, len(pairs), group):
        sel = pairs[k:k + group]
        a_sel = torch.stack([ab[i0, i1] for (i0, i1, _, _) in sel])
        b_sel = torch.stack([bb[j0, j1] for (_, _, j0, j1) in sel])
        small = inner(a_sel, b_sel).to(dtype)
        for z, (i0, i1, j0, j1) in enumerate(sel):
            o0, o1 = P * (i0 + j0), P * (i1 + j1)
            acc[o0:o0 + n, o1:o1 + n] += small[z]
    return acc[:c0, :c1]


def spot_check(a, b, out, n_samples: int = 64, seed: int = 0):
    """Host-exact f64 check of random output coefficients:
    c[k0,k1] = sum_{i<=k} a[i0,i1] b[k0-i0,k1-i1].  Returns max rel
    error over the sampled coefficients (ground truth for orders where
    the full host conv is infeasible)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = np.asarray(out)
    rng = np.random.default_rng(seed)
    c0, c1 = out.shape
    worst = 0.0
    for _ in range(n_samples):
        k0 = int(rng.integers(0, c0))
        k1 = int(rng.integers(0, c1))
        i0lo = max(0, k0 - (b.shape[0] - 1))
        i0hi = min(a.shape[0] - 1, k0)
        i1lo = max(0, k1 - (b.shape[1] - 1))
        i1hi = min(a.shape[1] - 1, k1)
        if i0lo > i0hi or i1lo > i1hi:
            truth = 0.0
        else:
            aw = a[i0lo : i0hi + 1, i1lo : i1hi + 1]
            bw = b[k0 - i0hi : k0 - i0lo + 1, k1 - i1hi : k1 - i1lo + 1]
            truth = float(np.sum(aw * bw[::-1, ::-1]))
        got = float(out[k0, k1])
        denom = max(abs(truth), 1e-300)
        worst = max(worst, abs(got - truth) / denom)
    return worst
