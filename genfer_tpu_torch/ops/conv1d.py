"""Truncated 1-D Cauchy product in f32: the CUDA kernel and its plain
PyTorch version.

``conv1d_trunc_f32`` is the twin of genfer_tpu's
``ops/pallas_conv.py::conv1d_pallas`` (kernel ``_build``):
``c[k] = sum_j b[j] * a[k-j]`` for ``k < out_len``, f32 in, f32
accumulate, f32 out.  On a CUDA tensor it launches
``csrc/conv1d_trunc_f32.cu`` (built by ``_build``) or raises; on a CPU
tensor it runs ``conv1d_trunc_f32_reference``.  There is no other
fallback.  Its kernel launches are counted in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from .. import _build
from ..taylor.backend import _toeplitz
from .conv2d import _MAX_DIM, _check_operand, _on_card


def _check(a, b, out_len) -> int:
    _check_operand("a", a, 1)
    _check_operand("b", b, 1)
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    lc = int(out_len)
    if not 1 <= lc <= _MAX_DIM:
        raise ValueError(f"unsupported out_len {lc}")
    return lc


def conv1d_trunc_f32_reference(a, b, out_len):
    """Plain PyTorch version: the (out_len, lb) Toeplitz matrix of ``a``
    times ``b``, in f32 (it raises on a card with TF32 matmuls on)."""
    lc = _check(a, b, out_len)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the f32 reference needs TF32 matmuls disabled")
    return _toeplitz(a, lc, b.shape[0]) @ b


def conv1d_trunc_f32(a, b, out_len):
    """Truncated 1-D Cauchy product of f32 vectors ``a`` (la,) and ``b``
    (lb,) to length ``out_len``; any lengths >= 1."""
    lc = _check(a, b, out_len)
    if not _on_card(a):
        return conv1d_trunc_f32_reference(a, b, lc)
    lib = _build.load()
    out = torch.empty((lc,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.conv1d_trunc_f32(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), a.shape[0], b.shape[0],
                                   lc, stream)
    _build.check(lib, "conv1d_trunc_f32", err)
    conv1d_trunc_f32.launches += 1
    return out


conv1d_trunc_f32.launches = 0
