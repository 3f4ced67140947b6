"""K1, the truncated 2-D Cauchy product in f64: the CUDA kernel and its
plain PyTorch version.

``conv2d_trunc_f64_batched(a, b, out_shape)`` computes, for every batch
entry z of ``a`` (B, a0, a1) and ``b`` (B, b0, b1),

    c[z, k0, k1] = sum a[z, i0, i1] * b[z, k0 - i0, k1 - i1],  k < out_shape

in f64, and ``conv2d_trunc_f64`` the same for one pair.  They replace the
f64 2-axis product of genfer_tpu's ``JaxF64Backend``, which ran in XLA:
``taylor/backend.py::_conv_dense`` (2-axis branch) and its truncation
staircase ``_conv_dense_2d_blocked``.  ``taylor/backend.py::
_conv_dense_batched`` sends every 2-axis f64 product here, so
``TorchF64Backend``, the ``entry()`` twin and ``HybridBackend``'s offload
reach K1 on the card, the >= 3-axis products with one launch over all
their pairs.

On a CUDA tensor a wrapper launches ``csrc/conv2d_trunc_f64.cu`` (built by
``_build``) or raises; on a CPU tensor it runs the plain version
(``conv2d_trunc_f64_batched_reference``: the Toeplitz einsum and
anti-diagonal sum the port's backend ran before K1).  There is no other
fallback.  Both wrappers count the kernel's launches in
``conv2d_trunc_f64.launches`` (CPU calls add nothing).

The kernel runs the work units of ``ops.conv2d.unit_plan(...,
cut_j1=False)`` on the FP64 tensor cores (``mma.sync.m8n8k4 ... f64``), a
tile's units added in slot order: the result depends on the shapes alone,
and every batch entry equals the single-pair call bit for bit.
"""

from __future__ import annotations

import torch

from .. import _build
from ..taylor.backend import _antidiag_sum, _toeplitz
from .conv2d import (
    TILE,
    _check,
    _on_card,
    _on_device,
    _plan_on_card,
    batched_blocks,
)


def conv2d_trunc_f64_batched_reference(a, b, out_shape, rows=None):
    """Plain PyTorch version of the batch: for each strip of ``rows``
    output rows (all of them by default), a Toeplitz tensor of ``a``
    [rows, b0, a1, B] contracted with ``b`` into [B, rows, a1, b1], then
    the anti-diagonal sum along axis 1.  The dense form holds ~8 c0 a1 b1
    doubles at once (~69 GB at order 1024); a strip holds rows / c0 of
    that."""
    c0, c1 = _check(a, b, out_shape, 3, 3, torch.float64)
    rows = rows or c0
    parts = []
    for r0 in range(0, c0, rows):
        n = min(rows, c0 - r0)
        Ta = _toeplitz(a.movedim(0, -1), n, b.shape[1], start=r0)
        H = torch.einsum("kjiz,zjl->zkil", Ta, b)  # [B, n, a1, b1]
        parts.append(_antidiag_sum(H, c1))
        del Ta, H
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def conv2d_trunc_f64_reference(a, b, out_shape, rows=None):
    """``conv2d_trunc_f64_batched_reference`` of one pair."""
    _check(a, b, out_shape, 2, 2, torch.float64)
    return conv2d_trunc_f64_batched_reference(a[None], b[None], out_shape,
                                              rows)[0]


def conv2d_trunc_f64_batched(a, b, out_shape):
    """Truncated 2-D Cauchy products of every pair ``a[z]``, ``b[z]`` of
    the batches ``a`` (B, a0, a1) and ``b`` (B, b0, b1), f64, to (B, c0,
    c1); any sizes >= 1."""
    c0, c1 = _check(a, b, out_shape, 3, 3, torch.float64)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batches of {a.shape[0]} and {b.shape[0]} pairs")
    if not _on_card(a):
        return conv2d_trunc_f64_batched_reference(a, b, (c0, c1))
    lib = _build.load()
    batch = a.shape[0]
    plan, units, sums = _plan_on_card(tuple(a.shape[1:]), tuple(b.shape[1:]),
                                      (c0, c1), a.device, False)
    batched_blocks(batch, plan)
    # the kernel's operand b is the smaller one
    ka, kb = (b, a) if plan.swap else (a, b)
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((batch, c0, c1), dtype=torch.float64, device=a.device)
    work = (torch.empty((batch, plan.slots, TILE, TILE), dtype=torch.float64,
                        device=a.device) if plan.slots else None)
    with _on_device(a.device):
        err = lib.conv2d_trunc_f64_batched(
            ka.data_ptr(), kb.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(),
            units.data_ptr(), len(plan.units), sums.data_ptr(),
            len(plan.sums), plan.slots, ka[0].numel(), kb[0].numel(), batch,
            ka.shape[1], ka.shape[2], kb.shape[2], c0, c1,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, "conv2d_trunc_f64_batched", err)
    conv2d_trunc_f64.launches += 1
    return out


def conv2d_trunc_f64(a, b, out_shape):
    """Truncated 2-D Cauchy product of f64 matrices ``a`` (a0, a1) and
    ``b`` (b0, b1) to ``out_shape`` (c0, c1): the batch of one pair."""
    _check(a, b, out_shape, 2, 2, torch.float64)
    return conv2d_trunc_f64_batched(a[None], b[None], out_shape)[0]


conv2d_trunc_f64.launches = 0
