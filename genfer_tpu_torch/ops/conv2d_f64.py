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

On a CUDA tensor a wrapper launches one of K1's bodies (built by
``_build``) or raises; on a CPU tensor it runs the plain version
(``conv2d_trunc_f64_batched_reference``: the Toeplitz einsum and
anti-diagonal sum the port's backend ran before K1).  There is no other
fallback, and none from one body to another.  ``k1_route`` picks the body
from the shapes alone:

* ``"small"`` (``csrc/conv2d_small_f64.cu``): the smaller operand holds at
  most ``SMALL_MAX_COEFFS`` coefficients; one fma chain an output, j0
  ascending then j1, one launch a product and nothing on the host;
* ``"dense"`` (``csrc/conv2d_trunc_f64.cu``): the work units of
  ``ops.conv2d.unit_plan(..., cut_j1=False)`` on the FP64 tensor cores
  (``mma.sync.m16n8k8 ... f64``), a tile's units added in slot order;
* ``"dense_t"``: the dense body on the transposed operands, ``c^T =
  K1(a^T, b^T)``, where that plan issues fewer multiply-adds: a thin, tall
  smaller operand ((308,1)x(308,274): 85.8 x the useful multiply-adds as
  given, 2.5 x transposed) is then contracted along its long axis.

Every body's result depends on the shapes alone, and every batch entry
equals the single-pair call bit for bit.  Both wrappers count the kernel's
launches in ``conv2d_trunc_f64.launches`` and, by body, in
``conv2d_trunc_f64.launches_by_body`` (CPU calls add nothing); while a
recording of the port's tracer is open, each launch also counts in
``k1.products`` {body, a, b, out, phase} (one pair's operand shapes, the
whole product's out shape, and the walk's phase, ``trace.phase``: a
reader takes a captured walk's products alone).

``rows=(r0, r1)`` asks for output rows [r0, r1) only, a (r1 - r0, c1)
result: the local body of the sharded routes (``parallel.mesh``), each
rank its own rows.  The body is the one ``k1_route`` picks for the whole
product, and each computes the window's rows as the whole product does:
the small body starts its tiles at r0; the dense body runs the units of
the whole product's plan whose tiles meet the window
(``ops.conv2d.window_plan``: a tile keeps its units and their slot order)
and writes the window's rows; ``dense_t`` takes the window on the
transposed output's columns.  So a
window equals the same rows of the whole product bit for bit.  Windowed
launches are counted besides, in ``conv2d_trunc_f64.windowed_by_body``.

``k1_op`` is ``conv2d_trunc_f64_batched`` as a torch custom op, for the
compiled mode (``genfer_tpu_torch.compile``), whose walk runs under
``torch.func.vmap``: a vmapped tensor has no ``data_ptr()``, so the op's
vmap rule moves the vmapped dimension to the front, expands an operand
that is not batched, folds the vmapped dimension into K1's batch and calls
the wrapper once (one launch a vmapped product, on the body ``k1_route``
picks from one pair's shapes).  ``TorchF64Backend`` keeps calling the
wrapper itself, without the dispatcher.
"""

from __future__ import annotations

import functools

import torch

from .. import _build, trace
from ..taylor.backend import _antidiag_sum, _toeplitz
from .conv2d import (
    TILE,
    _check,
    _on_card,
    _on_device,
    _plan_on_card,
    _swap,
    batched_blocks,
    issued_macs,
    unit_plan,
)

# The constants of ``k1_route``, beside those of ``ops.conv2d.unit_plan``;
# they depend on the shapes alone, never on the card.
#: smaller operands of at most this many coefficients take the small body:
#: ``tune_port.py`` probe 11 found it faster on one H100 80GB HBM3 (700 W)
#: than the dense body at (255,268)x(s,s) for every s up to 8 (2.66 against
#: 8.84 us of device time at 2x2) and than the dense body transposed at
#: (268,274)x(n,1) up to n = 64 (9.81 against 11.89 us), so up to its own
#: limit (SMALL_LIMIT in its .cu)
SMALL_MAX_COEFFS = 64
#: the dense body's stage width in a's columns (F64Geo::KB in the .cu)
KB = 32
BODIES = ("small", "dense", "dense_t")


def _smaller(a_shape, b_shape):
    """The operand the kernels loop over: b, unless a has fewer
    coefficients (``ops.conv2d._swap``)."""
    return a_shape if _swap(a_shape, b_shape) else b_shape


def k1_route(a_shape, b_shape, out_shape) -> tuple[str, bool]:
    """``(body, transposed)`` of K1 for one pair's shapes (every batch
    entry has the same): ``("small", False)`` where the smaller operand
    holds at most ``SMALL_MAX_COEFFS`` coefficients, else ``("dense",
    dense_transposed(...))``."""
    s0, s1 = _smaller(a_shape, b_shape)
    if s0 * s1 <= SMALL_MAX_COEFFS:
        return "small", False
    return "dense", dense_transposed(tuple(a_shape), tuple(b_shape),
                                     tuple(out_shape))


def k1_body(a_shape, b_shape, out_shape) -> str:
    """The name of the body ``k1_route`` picks: one of ``BODIES``
    (``dense_t``: the dense body transposed)."""
    body, transposed = k1_route(a_shape, b_shape, out_shape)
    return body + "_t" if transposed else body


@functools.lru_cache(maxsize=1024)
def dense_transposed(a_shape, b_shape, out_shape) -> bool:
    """The orientation rule of the dense body: transposed where its plan
    on the transposed shapes issues fewer multiply-adds
    (``dense_issued_macs``) than on the shapes as given; a tie keeps them
    as given.  A unit contracts over its b columns plus the 63 of the
    band, in ``KB``-wide blocks, so a tall, thin b wastes nearly all of
    them: (n, 1) fills 1 column of 64.  Both plans are ``unit_plan``'s
    cached ones, and the transposed call reuses its own."""
    return (dense_issued_macs(a_shape, b_shape, out_shape, True)
            < dense_issued_macs(a_shape, b_shape, out_shape))


def dense_issued_macs(a_shape, b_shape, out_shape,
                      transposed: bool = False) -> int:
    """Multiply-adds the dense body issues for one pair
    (``ops.conv2d.issued_macs`` of its plan, a's columns in the ``KB``-wide
    blocks of its loop), on the transposed shapes where ``transposed``."""
    shapes = (tuple(a_shape), tuple(b_shape), tuple(out_shape))
    if transposed:
        shapes = tuple(s[::-1] for s in shapes)
    return issued_macs(unit_plan(*shapes, False), *shapes[:2], KB)


def _window(rows, c0: int) -> tuple[int, int]:
    """The output rows [r0, r1) that ``rows`` asks for (``None``: all
    ``c0``); a window is nonempty and inside the output."""
    if rows is None:
        return 0, c0
    r0, r1 = (int(r) for r in rows)
    if not 0 <= r0 < r1 <= c0:
        raise ValueError(f"rows {tuple(rows)} is not a window of {c0} rows")
    return r0, r1


def conv2d_trunc_f64_batched_reference(a, b, out_shape, strip=None,
                                       rows=None):
    """Plain PyTorch version of the batch, output rows ``rows`` = (r0,
    r1) (all by default): for each strip of ``strip`` output rows (the
    whole window by default), a Toeplitz tensor of ``a`` [strip, b0, a1,
    B] contracted with ``b`` into [B, strip, a1, b1], then the
    anti-diagonal sum along axis 1.  The dense form holds ~8 c0 a1 b1
    doubles at once (~69 GB at order 1024); a strip holds strip / c0 of
    that."""
    c0, c1 = _check(a, b, out_shape, 3, 3, torch.float64)
    r0, r1 = _window(rows, c0)
    strip = strip or r1 - r0
    parts = []
    for s0 in range(r0, r1, strip):
        n = min(strip, r1 - s0)
        Ta = _toeplitz(a.movedim(0, -1), n, b.shape[1], start=s0)
        H = torch.einsum("kjiz,zjl->zkil", Ta, b)  # [B, n, a1, b1]
        parts.append(_antidiag_sum(H, c1))
        del Ta, H
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def conv2d_trunc_f64_reference(a, b, out_shape, strip=None, rows=None):
    """``conv2d_trunc_f64_batched_reference`` of one pair."""
    _check(a, b, out_shape, 2, 2, torch.float64)
    return conv2d_trunc_f64_batched_reference(a[None], b[None], out_shape,
                                              strip, rows)[0]


def _small(lib, a, b, c0, c1, flag, r0=0, r1=None):
    """The small body: one launch over (entry, output tile of rows [r0,
    r1))."""
    batch = a.shape[0]
    r1 = c0 if r1 is None else r1
    ka, ks = (b, a) if _swap(tuple(a.shape[1:]), tuple(b.shape[1:])) else (
        a, b)
    # the launch refuses more than SMALL_LIMIT coefficients and a grid of
    # more than 2^31 - 1 blocks (an error that raises below)
    vec = ka.data_ptr() % 16 == 0 and ka.shape[2] % 2 == 0
    out = torch.empty((batch, r1 - r0, c1), dtype=torch.float64,
                      device=a.device)
    err = lib.conv2d_small_f64(
        ka.data_ptr(), ks.data_ptr(), out.data_ptr(), batch, ka.shape[1],
        ka.shape[2], ks.shape[1], ks.shape[2], r1, c1, r0, int(vec),
        0 if flag is None else flag.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "conv2d_small_f64", err)
    return out


def _dense(lib, a, b, c0, c1, flag, window=None):
    """The dense body on ``unit_plan(..., cut_j1=False)`` of the pair's
    shapes (its tables kept on the card per shape); ``window`` = (axis,
    lo, hi): output rows (axis 0) or columns (axis 1) [lo, hi) only, on
    ``window_plan``."""
    batch = a.shape[0]
    shapes = (tuple(a.shape[1:]), tuple(b.shape[1:]), (c0, c1))
    plan, units, sums = _plan_on_card(*shapes, a.device, False, window)
    if window is None:
        w, e = (0, 0), (c0, c1)
    else:
        axis, lo, hi = window
        w = (lo, 0) if axis == 0 else (0, lo)
        e = (hi, c1) if axis == 0 else (c0, hi)
    batched_blocks(batch, plan)
    # the kernel's operand b is the smaller one
    ka, kb = (b, a) if plan.swap else (a, b)
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((batch, e[0] - w[0], e[1] - w[1]), dtype=torch.float64,
                device=a.device)
    work = (torch.empty((batch, plan.slots, TILE, TILE), dtype=torch.float64,
                        device=a.device) if plan.slots else None)
    err = lib.conv2d_trunc_f64_batched(
        ka.data_ptr(), kb.data_ptr(), out.data_ptr(),
        0 if work is None else work.data_ptr(),
        units.data_ptr(), len(plan.units), sums.data_ptr(),
        len(plan.sums), plan.slots, ka[0].numel(), kb[0].numel(), batch,
        ka.shape[1], ka.shape[2], kb.shape[2], *e, *w,
        0 if flag is None else flag.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, "conv2d_trunc_f64_batched", err)
    return out


def _launch(body, a, b, c0, c1, flag=None, rows=None):
    """Run ``body`` of K1 on the card (``dense_t``: the dense body on the
    transposed operands, its result transposed back), output rows
    ``rows`` = (r0, r1) (``None``: all)."""
    lib = _build.load()
    if body == "small":
        return _small(lib, a, b, c0, c1, flag, *(rows or ()))
    if body == "dense":
        return _dense(lib, a, b, c0, c1, flag,
                      None if rows is None else (0, *rows))
    out = _dense(lib, a.mT.contiguous(), b.mT.contiguous(), c1, c0, flag,
                 None if rows is None else (1, *rows))
    return out.mT.contiguous()


def conv2d_trunc_f64_batched(a, b, out_shape, flag=None, rows=None):
    """Truncated 2-D Cauchy products of every pair ``a[z]``, ``b[z]`` of
    the batches ``a`` (B, a0, a1) and ``b`` (B, b0, b1), f64, to (B, c0,
    c1); any sizes >= 1.  ``rows`` = (r0, r1): output rows [r0, r1) only,
    to (B, r1 - r0, c1) (see the module docstring).  ``flag``: an int32
    tensor (B,) on the card (the guard of ``ops.ozaki_conv``): the
    kernel's blocks of an entry whose flag is 0 do nothing, and that
    entry's output is undefined (counted in ``conv2d_trunc_f64.predicated``
    besides the launch counts); the plain version computes every entry."""
    c0, c1 = _check(a, b, out_shape, 3, 3, torch.float64)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batches of {a.shape[0]} and {b.shape[0]} pairs")
    window = None if rows is None else _window(rows, c0)
    if not _on_card(a):
        return conv2d_trunc_f64_batched_reference(a, b, (c0, c1),
                                                  rows=window)
    if flag is not None and (flag.dtype != torch.int32
                             or tuple(flag.shape) != (a.shape[0],)
                             or flag.device != a.device):
        raise ValueError("flag must be int32 (B,) on the operands' device")
    if window is not None and window[0] >= a.shape[1] + b.shape[1] - 1:
        # below the product's last row: zeros, and no unit to launch
        return a.new_zeros((a.shape[0], window[1] - window[0], c1))
    body = k1_body(tuple(a.shape[1:]), tuple(b.shape[1:]), (c0, c1))
    with _on_device(a.device):
        out = _launch(body, a, b, c0, c1, flag, window)
    conv2d_trunc_f64.launches += 1
    conv2d_trunc_f64.launches_by_body[body] += 1
    if trace.on:
        trace.count("k1.products", body=body, a=tuple(a.shape[1:]),
                    b=tuple(b.shape[1:]), out=(c0, c1), phase=trace.phase())
    conv2d_trunc_f64.windowed_by_body[body] += window is not None
    conv2d_trunc_f64.predicated += flag is not None
    return out


def conv2d_trunc_f64(a, b, out_shape, rows=None):
    """Truncated 2-D Cauchy product of f64 matrices ``a`` (a0, a1) and
    ``b`` (b0, b1) to ``out_shape`` (c0, c1): the batch of one pair;
    ``rows`` = (r0, r1): output rows [r0, r1) only."""
    _check(a, b, out_shape, 2, 2, torch.float64)
    return conv2d_trunc_f64_batched(a[None], b[None], out_shape,
                                    rows=rows)[0]


@torch.library.custom_op("genfer_tpu_torch::k1_batched", mutates_args=())
def _k1_batched(a: torch.Tensor, b: torch.Tensor, c0: int,
                c1: int) -> torch.Tensor:
    return conv2d_trunc_f64_batched(a, b, (c0, c1))


@_k1_batched.register_fake
def _(a, b, c0, c1):
    return a.new_empty((a.shape[0], c0, c1))


def _k1_batched_vmap(info, in_dims, a, b, c0, c1):
    """One call over the vmapped dimension times K1's batch: ``(V, B,
    ...)`` operands folded to ``(V * B, ...)``, the result unfolded."""
    v = info.batch_size

    def front(x, dim):
        x = x.expand(v, *x.shape) if dim is None else x.movedim(dim, 0)
        return x.reshape(v * x.shape[1], *x.shape[2:]).contiguous()

    out = _k1_batched(front(a, in_dims[0]), front(b, in_dims[1]), c0, c1)
    return out.reshape(v, -1, c0, c1), 0


_k1_batched.register_vmap(_k1_batched_vmap)


def k1_op(a, b, out_shape):
    """``conv2d_trunc_f64_batched`` through the custom op (see the module
    docstring): the same result, batched by ``torch.func.vmap`` into one
    call."""
    c0, c1 = (int(s) for s in out_shape)
    return _k1_batched(a, b, c0, c1)


def reset_launches() -> None:
    """Set K1's launch counts, total, by body, windowed by body and
    predicated, to 0 (the by-body dicts in place, so that a reference to
    them stays live)."""
    conv2d_trunc_f64.launches = 0
    conv2d_trunc_f64.predicated = 0
    conv2d_trunc_f64.launches_by_body.update(dict.fromkeys(BODIES, 0))
    conv2d_trunc_f64.windowed_by_body.update(dict.fromkeys(BODIES, 0))


conv2d_trunc_f64.launches_by_body = {}
conv2d_trunc_f64.windowed_by_body = {}
reset_launches()
