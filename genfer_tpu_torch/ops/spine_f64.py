"""A constant spine of the GF DAG in f64, in one launch: the CUDA kernel
and its plain PyTorch version.

A constant spine is a tower of Add / Mul nodes with one constant operand
each (``gf/ir.py::GenFun._eval``): digitRecognition's 784 observations a
class are 1,568 links, ``G * e`` then ``G + 0 * (1 - e)``, applied to one
series.  ``spine_f64(x, c, src, adds)`` applies ``L = len(src)`` such
links to every row of ``x`` (R, N), the N coefficients of one series a
row, flat in row-major order:

    link l, constant v = c[r, src[l]]:
        bit l of ``adds`` set:   x[r, 0] = x[r, 0] + v    (Add)
        else:                    x[r, :] = x[r, :] * v    (Mul)

``c`` (R, M) holds the links' constants a row; ``src`` (int32, L) says
which column each link reads, so links that share a constant-building
template can have their constants made together and concatenated;
``adds`` (int32, ceil(L / 32)) holds one bit a link, bit l % 32 of word
l // 32.  ``x`` or ``c`` may have one row for all R.  These are the
operations ``TaylorPoly``'s ``G * c`` and ``G + c`` perform for a 0-d
constant c (``taylor/tensorpoly.py``: ``b.mul(c, G)``; ``_add_at_zero``
on the first coefficient), so the result equals the link-by-link loop bit
for bit: each output is one chain of IEEE f64 operations in link order,
with no FMA contraction and no reassociation.

On a CUDA tensor the wrapper launches ``csrc/spine_f64.cu`` (built by
``_build``) or raises, and counts the launch in ``spine_f64.launches``;
on a CPU tensor it runs the plain version (``spine_f64_reference``, the
loop).  ``spine_op`` is the wrapper as a torch custom op, for the
compiled walk under ``torch.func.vmap``: its vmap rule folds the vmapped
dimension into the rows, so one launch serves the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .conv2d import _on_device


def pack_adds(is_add) -> np.ndarray:
    """The ``adds`` words (int32) of the per-link flags ``is_add`` (True:
    Add)."""
    flags = np.asarray(is_add, dtype=bool)
    bits = np.zeros(-(-len(flags) // 32) * 32, dtype=bool)
    bits[: len(flags)] = flags
    return np.packbits(bits, bitorder="little").view("<i4")


def _check(x, c, src, adds) -> int:
    """The rows of the result; raise on operands the op does not take."""
    if x.dtype != torch.float64 or c.dtype != torch.float64:
        raise ValueError("x and c must be float64")
    if x.ndim != 2 or c.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and c {tuple(c.shape)} "
                         "must be matrices")
    rows = max(x.shape[0], c.shape[0])
    if {x.shape[0], c.shape[0]} - {1, rows}:
        raise ValueError(f"rows of x ({x.shape[0]}) and c ({c.shape[0]}) "
                         "differ and neither is 1")
    if src.dtype != torch.int32 or adds.dtype != torch.int32:
        raise ValueError("src and adds must be int32")
    if adds.numel() != (src.numel() + 31) // 32:
        raise ValueError(f"{adds.numel()} words for {src.numel()} links")
    return rows


def spine_f64_reference(x, c, src, adds):
    """Plain PyTorch version: the links one by one, in order."""
    rows = _check(x, c, src, adds)
    out = x.expand(rows, -1).clone()
    c = c.expand(rows, -1)
    words = adds.tolist()
    for l, s in enumerate(src.tolist()):
        v = c[:, s]
        if words[l >> 5] >> (l & 31) & 1:
            out[:, 0] += v
        else:
            out *= v[:, None]
    return out


def spine_f64(x, c, src, adds):
    """``x`` (R or 1, N) after the links ``src`` / ``adds`` with the
    constants ``c`` (R or 1, M), to (R, N); see the module docstring."""
    rows = _check(x, c, src, adds)
    if x.device.type != "cuda":
        return spine_f64_reference(x, c, src, adds)
    x, c = x.contiguous(), c.contiguous()
    src, adds = src.contiguous(), adds.contiguous()
    n = x.shape[1]
    out = torch.empty((rows, n), dtype=torch.float64, device=x.device)
    with _on_device(x.device):
        lib = _build.load()
        err = lib.spine_f64(
            x.data_ptr(), n if x.shape[0] > 1 else 0, c.data_ptr(),
            c.shape[1] if c.shape[0] > 1 else 0, src.data_ptr(),
            adds.data_ptr(), out.data_ptr(), rows, n, src.numel(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "spine_f64", err)
    spine_f64.launches += 1
    return out


spine_f64.launches = 0


@torch.library.custom_op("genfer_tpu_torch::spine_f64", mutates_args=())
def spine_op(x: torch.Tensor, c: torch.Tensor, src: torch.Tensor,
             adds: torch.Tensor) -> torch.Tensor:
    """``spine_f64`` as a custom op: the same result, batched by
    ``torch.func.vmap`` into one call."""
    return spine_f64(x, c, src, adds)


@spine_op.register_fake
def _(x, c, src, adds):
    return x.new_empty((max(x.shape[0], c.shape[0]), x.shape[1]))


def _spine_vmap(info, in_dims, x, c, src, adds):
    """One call over the vmapped dimension times the rows: a batched
    operand ``(V, r, ...)`` becomes ``(V * r, ...)``; one that is not
    batched keeps its single row (the kernel reads it for every row) or
    is expanded."""
    if in_dims[2] is not None or in_dims[3] is not None:
        raise ValueError("spine_op: src and adds cannot be batched")
    if in_dims[0] is None and in_dims[1] is None:
        return spine_op(x, c, src, adds), None
    v = info.batch_size

    def example(t, dim):
        return t if dim is None else t.movedim(dim, 0)[0]

    rows = max(example(x, in_dims[0]).shape[0],
               example(c, in_dims[1]).shape[0])

    def front(t, dim):
        if dim is None:
            if rows == 1:
                return t
            t = t.expand(v, *t.shape)
        else:
            t = t.movedim(dim, 0)
        return t.expand(v, rows, t.shape[2]).reshape(v * rows, t.shape[2])

    out = spine_op(front(x, in_dims[0]), front(c, in_dims[1]), src, adds)
    return out.reshape(v, rows, -1), 0


spine_op.register_vmap(_spine_vmap)
