"""A sum of two padded, scaled and shifted f64 coefficient tensors in one
pass: the CUDA kernel and its plain PyTorch version.

``lincomb_f64(a, b, alpha, beta, shape, pa, pb, sub)`` gives, for every
row r and every index i of ``shape`` (the result is (R, *shape)),

    out[r, i] = alpha[r] * a[r, i - pa]  +  beta[r] * b[r, i - pb]

(``-`` where ``sub``), a term whose index falls outside its operand
+0.0, an absent factor (None) 1, an absent ``b`` no second term.  ``a``
(Ra, *sa) and ``b`` (Rb, *sb) hold one series a row, with as many
coefficient axes as ``shape`` (at least one), any strides;
``alpha`` / ``beta`` (R,) one factor a row; each of them may have one row
for all R.  ``pa`` / ``pb`` are offsets >= 0 a coefficient axis.  These
are the coefficients ``TaylorPoly`` makes op by op (``taylor/host.py::
Backend.lincomb``): a padded add or sub, ``mul_var``'s ``G * m`` at
offset 1 along its axis, and ``mul_linear``'s sum of that and ``c * G``.
Each output is the same chain of IEEE f64 operations as that sequence (a
product, then one add or sub; no FMA contraction), so the result equals
it bit for bit; a sub is a subtraction, ``a - b`` being ``a + (-b)`` with
the pad's zeros negated too.

On a CUDA tensor the wrapper launches ``csrc/lincomb_f64.cu`` (built by
``_build``; a launch error raises), a result of 2^31 words or more in
chunks of rows, and counts each launch in ``lincomb_f64.launches``; on a
CPU tensor it runs the plain version (``lincomb_f64_reference``: pad,
multiply, add, as the ops do, with the same bits).  Both refuse a row of
2^31 words or more.  ``lincomb`` is the wrapper for the compiled walk:
one series, or under ``torch.func.vmap`` the whole batch in one launch.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch._C import _functorch

from .. import _build
from .conv2d import _on_device

#: coefficient axes the kernel takes (``LC_AXES`` in the kernel): more
#: than a row below ``WORDS`` has once its axes of extent 1 are dropped
MAX_AXES = 30
#: the words one launch indexes, and one row at most, are below this
WORDS = 2 ** 31


def _rows(t) -> int:
    return 1 if t is None else t.shape[0]


def _check(a, b, alpha, beta, shape, pa, pb, sub) -> int:
    """The rows of the result; raise on operands the op does not take."""
    k = len(shape)
    if k < 1:
        raise ValueError("the result needs at least one coefficient axis")
    for name, t in (("a", a), ("b", b), ("alpha", alpha), ("beta", beta)):
        if t is not None and t.dtype != torch.float64:
            raise ValueError(f"{name} must be float64")
        if t is not None and t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    for name, t, p in (("a", a, pa), ("b", b, pb)):
        if t is None:
            continue
        if t.ndim != k + 1:
            raise ValueError(f"{name} {tuple(t.shape)}: rows and {k} "
                             "coefficient axes expected")
        if len(p) != k or min(p) < 0:
            raise ValueError(f"offsets of {name} {tuple(p)}: {k} expected, "
                             "none negative")
    for name, f in (("alpha", alpha), ("beta", beta)):
        if f is not None and f.ndim != 1:
            raise ValueError(f"{name} must have one factor a row")
    if b is None and (beta is not None or sub):
        raise ValueError("beta or sub without b")
    if min(shape) < 0:
        raise ValueError(f"shape {tuple(shape)} has a negative extent")
    if max([math.prod(shape)] + [n for t, p in ((a, pa), (b, pb))
                                 if t is not None
                                 for n in (*p, *t.shape[1:])]) >= WORDS:
        raise ValueError(f"shape {tuple(shape)}, an offset or an operand "
                         "reaches 2^31 words a row")
    rows = max(_rows(t) for t in (a, b, alpha, beta))
    if {_rows(t) for t in (a, b, alpha, beta)} - {1, rows}:
        raise ValueError("the operands' rows differ and are not 1")
    return rows


def _term(x, f, p, shape, rows, left):
    """``x`` times ``f`` (``f * x`` where ``left``) at the offsets ``p`` of
    zeros (rows, *shape), cut to fit."""
    out = x.new_zeros((rows, *shape))
    cut = tuple(slice(0, max(0, min(s, n - q)))
                for s, n, q in zip(x.shape[1:], shape, p))
    x = x[(slice(None),) + cut]
    if f is not None:
        f = f.reshape(-1, *[1] * len(shape))
        x = f * x if left else x * f
    out[(slice(None),) + tuple(slice(q, q + s) for q, s in
                               zip(p, x.shape[1:]))] = x
    return out


def lincomb_f64_reference(a, b, alpha, beta, shape, pa, pb, sub=False):
    """Plain PyTorch version: each term padded, then added (or its
    negation added), as ``Backend.lincomb`` does op by op."""
    rows = _check(a, b, alpha, beta, shape, pa, pb, sub)
    out = _term(a, alpha, pa, shape, rows, False)
    if b is None:
        return out
    tb = _term(b, beta, pb, shape, rows, True)
    return out + (-tb) if sub else out + tb


class _Args(ctypes.Structure):
    """``LincombArgs`` of ``csrc/lincomb_f64.cu``."""

    _fields_ = [
        *((name, ctypes.c_void_p)
          for name in ("a", "b", "alpha", "beta", "out")),
        *((name, ctypes.c_longlong)
          for name in ("a_row", "b_row", "alpha_row", "beta_row")),
        ("a_stride", ctypes.c_longlong * MAX_AXES),
        ("b_stride", ctypes.c_longlong * MAX_AXES),
        *((name, ctypes.c_int * MAX_AXES)
          for name in ("a_len", "b_len", "a_pre", "b_pre", "len")),
        ("axes", ctypes.c_int), ("rows", ctypes.c_int), ("sub", ctypes.c_int),
    ]


_A_FIELDS = ("a", "a_row", "a_stride", "a_len", "a_pre")
_B_FIELDS = ("b", "b_row", "b_stride", "b_len", "b_pre")


def _kept_axes(shape, operands):
    """The coefficient axes the kernel walks (those of extent > 1, or the
    last where none is), and of each operand whether it lies wholly off
    the result: at a nonzero offset, or empty, along an axis of extent 1
    that is dropped."""
    kept = [d for d, n in enumerate(shape) if n != 1] or [len(shape) - 1]
    off = [t is not None and any(p[d] != 0 or t.shape[d + 1] == 0
                                 for d in range(len(shape)) if d not in kept)
           for t, p in operands]
    return kept, off


def _row_chunks(rows, shape):
    """(first row, rows) of each launch: fewer than ``WORDS`` words
    each."""
    step = max(1, (WORDS - 1) // max(1, math.prod(shape)))
    return [(r, min(step, rows - r)) for r in range(0, rows, step)]


def _launches(a, b, alpha, beta, shape, pa, pb, sub, out):
    """The kernel's arguments for ``out`` (rows, *shape), one launch at a
    time (one ``_Args``, set anew for each chunk of rows)."""
    kept, off = _kept_axes(shape, ((a, pa), (b, pb)))
    args = _Args(axes=len(kept), sub=int(sub))
    args.len[:len(kept)] = [shape[n] for n in kept]
    for t, (_, _, stride, extent, pre), p, empty in (
            (a, _A_FIELDS, pa, off[0]), (b, _B_FIELDS, pb, off[1])):
        if t is not None:
            getattr(args, stride)[:len(kept)] = [t.stride(n + 1)
                                                 for n in kept]
            getattr(args, extent)[:len(kept)] = [
                0 if empty else t.shape[n + 1] for n in kept]
            getattr(args, pre)[:len(kept)] = [p[n] for n in kept]
    for first, n in _row_chunks(out.shape[0], shape):
        args.rows, args.out = n, out[first].data_ptr()
        for t, name in ((a, "a"), (b, "b"), (alpha, "alpha"),
                        (beta, "beta")):
            if t is not None:
                row = t.stride(0) if t.shape[0] > 1 else 0
                setattr(args, name + "_row", row)
                setattr(args, name, t.data_ptr() + 8 * first * row)
        yield args


def lincomb_f64(a, b, alpha, beta, shape, pa, pb, sub=False):
    """(R, *shape); see the module docstring."""
    shape, pa = [int(n) for n in shape], [int(p) for p in pa]
    pb = [0] * len(shape) if b is None else [int(p) for p in pb]
    rows = _check(a, b, alpha, beta, shape, pa, pb, sub)
    if a.device.type != "cuda":
        return lincomb_f64_reference(a, b, alpha, beta, shape, pa, pb, sub)
    out = torch.empty((rows, *shape), dtype=torch.float64, device=a.device)
    if out.numel() == 0:
        return out
    with _on_device(a.device):
        lib = _build.load()
        stream = torch.cuda.current_stream().cuda_stream
        for args in _launches(a, b, alpha, beta, shape, pa, pb, sub, out):
            _build.check(lib, "lincomb_f64",
                         lib.lincomb_f64(ctypes.byref(args), stream))
            lincomb_f64.launches += 1
    return out


lincomb_f64.launches = 0


def lincomb(a, b, alpha, beta, shape, pa, pb, sub=False):
    """``lincomb_f64`` of one series (operands without the rows axis, the
    factors 0-d) for the compiled walk.  Under ``torch.func.vmap`` the
    operands are unwrapped at the innermost level, the vmapped dimension
    becomes the rows (a view; an operand that is not batched one row that
    every row reads), and one call serves the whole batch: a torch custom
    op's Python vmap rule took ~450 us of host time a call on the H100's
    host, against ~70 us, and a two_populations(2000) walk makes ~8,600
    calls twice in set-up (warm-up and capture).  The walk runs under one
    ``vmap``; an operand batched at two levels raises."""
    ops = (a, b, alpha, beta)
    level = max(_functorch.maybe_get_level(t) for t in ops if t is not None)
    if level < 0:
        return lincomb_f64(*(None if t is None else t.unsqueeze(0)
                             for t in ops), shape, pa, pb, sub)[0]
    rows = []
    for t in ops:
        if t is not None:
            t, dim = _functorch._unwrap_batched(t, level)
            if _functorch.is_batchedtensor(t):
                raise ValueError("lincomb under nested vmap")
            t = t.unsqueeze(0) if dim is None else t.movedim(dim, 0)
        rows.append(t)
    return _functorch._add_batch_dim(
        lincomb_f64(*rows, shape, pa, pb, sub), 0, level)
