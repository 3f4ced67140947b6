"""Truncated 2-D Cauchy products in f32: the CUDA kernels and their plain
PyTorch versions.

Each wrapper computes ``c[k0, k1] = sum a[k0-j0, k1-j1] * b[j0, j1]`` for
``k < out_shape``, f32 in, f32 accumulate, f32 out, and is the twin of one
of genfer_tpu's Pallas kernels in ``ops/pallas_conv2d.py``:

* ``conv2d_trunc_f32``: ``conv2d_pallas`` (row-strip kernel
  ``_build2d_rowstrip``), ``csrc/conv2d_trunc_f32.cu``;
* ``conv2d_trunc_f32_tile``: ``conv2d_pallas_tile`` (``_build2d``),
  ``csrc/conv2d_trunc_f32_tile.cu``;
* ``conv2d_trunc_f32_grouped``: ``conv2d_pallas_grouped``
  (``_build2d_grouped``), ``csrc/conv2d_trunc_f32_grouped.cu``;
* ``conv2d_trunc_f32_batched``: ``conv2d_pallas_batched``
  (``_build2d_batched``), ``csrc/conv2d_trunc_f32_batched.cu``.

On a CUDA tensor a wrapper launches its kernel (built by ``_build``) or
raises; on a CPU tensor it runs the plain version
(``conv2d_trunc_f32_reference``, or ``conv2d_trunc_f32_batched_reference``
for the batch).  There is no other fallback.  Each wrapper counts its
kernel launches in its ``launches`` attribute (CPU calls add nothing).
"""

from __future__ import annotations

import torch

from .. import _build
from ..taylor.backend import _antidiag_sum, _toeplitz

_MAX_DIM = 1 << 20  # int32 index math in the kernel stays far from overflow
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z
TILE = 64  # output tile edge of the kernels (BM = BN in conv2d_tile.cuh)
GROUP = 32  # j0 rows staged together (G in conv2d_tile.cuh)
BLOCKS_PER_SM = 2  # 256-thread blocks of the kernel resident on one SM


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _swap(a_shape, b_shape) -> bool:
    """Pass the operands as (b, a), so that the smaller one is the
    kernel's b (the product is symmetric; the kernel loops over b)."""
    return b_shape[0] * b_shape[1] > a_shape[0] * a_shape[1]


def launch_plan(a_shape, b_shape, out_shape, sm_count: int):
    """How ``conv2d_trunc_f32`` launches its kernel on a card with
    ``sm_count`` SMs: ``(swap, splits, split_rows)``.

    ``swap``: see ``_swap``.  ``splits`` x ``split_rows``: the j0 axis is
    cut into ranges of ``split_rows`` rows, one block per (output tile,
    range), until there are about as many blocks as the card holds at
    once; the partial tiles are summed in range order by a second
    kernel."""
    (a0, a1), (b0, b1) = a_shape, b_shape
    c0, c1 = out_shape
    swap = _swap(a_shape, b_shape)
    if swap:
        b0 = a0
    tiles = _cdiv(c0, TILE) * _cdiv(c1, TILE)
    span = min(b0, c0)  # no tile uses a j0 beyond it
    groups = _cdiv(span, GROUP)
    splits = max(1, min(groups, _cdiv(BLOCKS_PER_SM * sm_count, tiles)))
    rows = _cdiv(groups, splits) * GROUP
    return swap, _cdiv(span, rows), rows


def batched_launch_plan(batch: int, a_shape, b_shape, out_shape,
                        sm_count: int):
    """How ``conv2d_trunc_f32_batched`` launches: ``(swap, splits,
    split_rows)`` of ``launch_plan`` for one pair, so that every batch
    entry is the single-pair kernel's result bit for bit.  The grid's z
    axis holds ``batch * splits`` blocks; beyond CUDA's 65535 it raises."""
    plan = launch_plan(a_shape, b_shape, out_shape, sm_count)
    if batch * plan[1] > _MAX_GRID_Z:
        raise ValueError(
            f"batch {batch} x {plan[1]} j0 ranges exceeds the grid's "
            f"{_MAX_GRID_Z} z blocks"
        )
    return plan


def _check_operand(name: str, t, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(
            f"{name} must be {ndim}-D, got shape {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if min(t.shape) < 1 or max(t.shape) > _MAX_DIM:
        raise ValueError(f"{name} has unsupported shape {tuple(t.shape)}")


def _check(a, b, out_shape, a_ndim: int = 2) -> tuple[int, int]:
    _check_operand("a", a, a_ndim)
    _check_operand("b", b, 2)
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    c0, c1 = (int(s) for s in out_shape)
    if min(c0, c1) < 1 or max(c0, c1) > _MAX_DIM:
        raise ValueError(f"unsupported out_shape {(c0, c1)}")
    return c0, c1


def _on_card(a) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    one; raises for any other device."""
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    return True


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    c0, c1 = _check(a, b, out_shape)
    if not _on_card(a):
        return conv2d_trunc_f32_reference(a, b, (c0, c1))
    lib = _build.load()
    swap, splits, rows = launch_plan(
        tuple(a.shape), tuple(b.shape), (c0, c1), _sm_count(a.device)
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
    _build.check(lib, "conv2d_trunc_f32", err)
    conv2d_trunc_f32.launches += 1
    return out


def _single_tile_kernel(wrapper, a, b, out_shape):
    """Launch the one-pass kernel named like ``wrapper`` (tile or
    grouped): one block per output tile, the smaller operand as b."""
    c0, c1 = _check(a, b, out_shape)
    if not _on_card(a):
        return conv2d_trunc_f32_reference(a, b, (c0, c1))
    lib = _build.load()
    if _swap(tuple(a.shape), tuple(b.shape)):
        a, b = b, a
    out = torch.empty((c0, c1), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, wrapper.__name__)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            a.shape[0], a.shape[1], b.shape[0], b.shape[1], c0, c1, stream,
        )
    _build.check(lib, wrapper.__name__, err)
    wrapper.launches += 1
    return out


def conv2d_trunc_f32_tile(a, b, out_shape):
    """``conv2d_trunc_f32`` with one block per output tile over the whole
    j0 range (no split): equal to it bit for bit where its launch plan
    does not split, and to f32 rounding where it does."""
    return _single_tile_kernel(conv2d_trunc_f32_tile, a, b, out_shape)


def conv2d_trunc_f32_grouped(a, b, out_shape):
    """``conv2d_trunc_f32_tile`` with the j0 sum in residue-major order
    (j0 mod 8 outer): equal to it to f32 rounding."""
    return _single_tile_kernel(conv2d_trunc_f32_grouped, a, b, out_shape)


def conv2d_trunc_f32_batched_reference(a_batch, b, out_shape):
    """Plain PyTorch version of the batch: ``conv2d_trunc_f32_reference``
    for every entry (one entry's Toeplitz tensor at a time: at order 512
    it is 0.5 GB)."""
    c0, c1 = _check(a_batch, b, out_shape, a_ndim=3)
    return torch.stack([conv2d_trunc_f32_reference(x, b, (c0, c1))
                        for x in a_batch])


def conv2d_trunc_f32_batched(a_batch, b, out_shape):
    """Truncated 2-D Cauchy products of every ``a_batch[g]`` (B, a0, a1)
    with one shared ``b`` (b0, b1), to (B, c0, c1).  A shared-LHS batch
    (one a, a batch of b) is this call with the operands swapped.  Every
    entry equals ``conv2d_trunc_f32(a_batch[g], b, out_shape)`` bit for
    bit on the card."""
    c0, c1 = _check(a_batch, b, out_shape, a_ndim=3)
    if not _on_card(a_batch):
        return conv2d_trunc_f32_batched_reference(a_batch, b, (c0, c1))
    lib = _build.load()
    batch, a0, a1 = a_batch.shape
    swap, splits, rows = batched_launch_plan(
        batch, (a0, a1), tuple(b.shape), (c0, c1),
        _sm_count(a_batch.device),
    )
    # the kernel's operand b is the smaller one, as in conv2d_trunc_f32;
    # the shared operand has stride 0
    ka, kb = (b, a_batch) if swap else (a_batch, b)
    ka_stride, kb_stride = (0, a0 * a1) if swap else (a0 * a1, 0)
    out = torch.empty((batch, c0, c1), dtype=torch.float32,
                      device=a_batch.device)
    work = (torch.empty((batch, splits, c0, c1), dtype=torch.float32,
                        device=a_batch.device) if splits > 1 else None)
    with torch.cuda.device(a_batch.device):
        stream = torch.cuda.current_stream(a_batch.device).cuda_stream
        err = lib.conv2d_trunc_f32_batched(
            ka.data_ptr(), kb.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(), ka_stride, kb_stride,
            batch, ka.shape[-2], ka.shape[-1], kb.shape[-2], kb.shape[-1],
            c0, c1, splits, rows, stream,
        )
    _build.check(lib, "conv2d_trunc_f32_batched", err)
    conv2d_trunc_f32_batched.launches += 1
    return out


for _wrapper in (conv2d_trunc_f32, conv2d_trunc_f32_tile,
                 conv2d_trunc_f32_grouped, conv2d_trunc_f32_batched):
    _wrapper.launches = 0
