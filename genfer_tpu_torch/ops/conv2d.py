"""Truncated 2-D Cauchy product in f32: the CUDA kernel and its plain
PyTorch version.

``conv2d_trunc_f32`` is the twin of genfer_tpu's
``ops/pallas_conv2d.py::conv2d_pallas`` (row-strip kernel
``_build2d_rowstrip``): ``c[k0, k1] = sum a[k0-j0, k1-j1] * b[j0, j1]``
for ``k < out_shape``, f32 in, f32 accumulate, f32 out.  On a CUDA tensor
it launches ``csrc/conv2d_trunc_f32.cu`` (built by ``_build``) or raises;
on a CPU tensor it runs ``conv2d_trunc_f32_reference``.  There is no
other fallback.
"""

from __future__ import annotations

import torch

from .. import _build
from ..taylor.backend import _antidiag_sum, _toeplitz

#: kernel launches since the count was last reset (CPU calls add nothing)
launches = 0

_MAX_DIM = 1 << 20  # int32 index math in the kernel stays far from overflow
TILE = 64  # output tile edge of the kernel (BM = BN in the .cu)
GROUP = 32  # j0 rows staged together (G in the .cu)
BLOCKS_PER_SM = 2  # 256-thread blocks of the kernel resident on one SM


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def launch_plan(a_shape, b_shape, out_shape, sm_count: int):
    """How ``conv2d_trunc_f32`` launches its kernel on a card with
    ``sm_count`` SMs: ``(swap, splits, split_rows)``.

    ``swap``: pass the operands as (b, a), so that the smaller one is the
    kernel's b (the product is symmetric; the kernel loops over b).
    ``splits`` x ``split_rows``: the j0 axis is cut into ranges of
    ``split_rows`` rows, one block per (output tile, range), until there
    are about as many blocks as the card holds at once; the partial tiles
    are summed in range order by a second kernel."""
    (a0, a1), (b0, b1) = a_shape, b_shape
    c0, c1 = out_shape
    swap = b0 * b1 > a0 * a1
    if swap:
        b0 = a0
    tiles = _cdiv(c0, TILE) * _cdiv(c1, TILE)
    span = min(b0, c0)  # no tile uses a j0 beyond it
    groups = _cdiv(span, GROUP)
    splits = max(1, min(groups, _cdiv(BLOCKS_PER_SM * sm_count, tiles)))
    rows = _cdiv(groups, splits) * GROUP
    return swap, _cdiv(span, rows), rows


def _check(a, b, out_shape) -> tuple[int, int]:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if min(t.shape) < 1 or max(t.shape) > _MAX_DIM:
            raise ValueError(f"{name} has unsupported shape {tuple(t.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    c0, c1 = (int(s) for s in out_shape)
    if min(c0, c1) < 1 or max(c0, c1) > _MAX_DIM:
        raise ValueError(f"unsupported out_shape {(c0, c1)}")
    return c0, c1


def conv2d_trunc_f32_reference(a, b, out_shape):
    """Plain PyTorch version: Toeplitz einsum plus anti-diagonal sum, all
    in f32.  On a card the einsum is a cuBLAS product, which must not run
    in TF32 (10 mantissa bits): it raises if TF32 matmuls are enabled."""
    c0, c1 = _check(a, b, out_shape)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the f32 reference needs TF32 matmuls disabled")
    Ta = _toeplitz(a[:c0], c0, b.shape[0])  # [c0, b0, a1]
    H = torch.einsum("kji,jl->kil", Ta, b)  # [c0, a1, b1]
    return _antidiag_sum(H, c1)


def conv2d_trunc_f32(a, b, out_shape):
    """Truncated 2-D Cauchy product of f32 matrices ``a`` (a0, a1) and
    ``b`` (b0, b1) to ``out_shape`` (c0, c1); any sizes >= 1."""
    global launches
    c0, c1 = _check(a, b, out_shape)
    if a.device.type == "cpu":
        return conv2d_trunc_f32_reference(a, b, (c0, c1))
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    lib = _build.load()
    swap, splits, rows = launch_plan(
        tuple(a.shape), tuple(b.shape), (c0, c1),
        torch.cuda.get_device_properties(a.device).multi_processor_count,
    )
    if swap:
        a, b = b, a
    out = torch.empty((c0, c1), dtype=torch.float32, device=a.device)
    work = (torch.empty((splits, c0, c1), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.conv2d_trunc_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(),
            a.shape[0], a.shape[1], b.shape[0], b.shape[1], c0, c1,
            splits, rows, stream,
        )
    if err != 0:
        msg = lib.conv2d_trunc_f32_error_string(err).decode()
        raise RuntimeError(f"conv2d_trunc_f32 launch failed: {msg} ({err})")
    launches += 1
    return out
