"""Truncated 1-D Cauchy product in f32: the CUDA kernel and its plain
PyTorch version.

``conv1d_trunc_f32`` is the twin of genfer_tpu's
``ops/pallas_conv.py::conv1d_pallas`` (kernel ``_build``):
``c[k] = sum_j b[j] * a[k-j]`` for ``k < out_len``, f32 in, f32
accumulate, f32 out.  On a CUDA tensor it launches
``csrc/conv1d_trunc_f32.cu`` (built by ``_build``) or raises; on a CPU
tensor it runs ``conv1d_trunc_f32_reference``.  There is no other
fallback.  Its kernel launches are counted in its ``launches`` attribute.

Both compute the product *folded*: with ``W = 64``, ``k = W p + r`` and
``i = W q + s``,

    c[W p + r] = sum_d sum_{s < W} a[W (p - d) + s] * T_d[s, r],
    T_d[s, r]  = b[W d + r - s]      (zero outside [0, lb)),

so the 1-D product is one ``(rows x W) @ (W x W)`` product per block
diagonal ``d``: a's rows slid down by ``d`` times a Toeplitz tile of b.
The plain version (``folded_product``) loops over ``d`` in cuBLAS; the
kernel runs the same products as split-TF32 ``mma.sync`` on the tensor
cores, on the work units of ``fold_plan`` (output tile of ``W`` folded
rows, range of ``d``), or, for products too small or too thin for a
tensor-core tile, an FFMA body (``fold_body`` says which).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..taylor.host import _conv_pair_flops
from .conv2d import (
    _MAX_DIM,
    _cdiv,
    _check_operand,
    _even_cuts,
    _on_card,
    _on_device,
)

W = 64  # fold width: outputs a folded row (the tile edge of conv2d_mma.cuh)
G = 16  # block diagonals a staged group (MmaGeo::G)
# The constants of ``fold_plan`` and ``fold_body``, set from measurements
# on one H100 (``tune_port.py`` probe 7, PERF.md); they shape the table,
# never the result's accuracy.
UNIT_TARGET = 792  # units a large product is cut into, about
TAIL_SHARE = 0.25  # share of the work, in the lightest tiles, cut finer
TAIL_DIV = 4  # how much finer
MIN_DIAG = 8  # shortest d range a tile is cut into ...
MIN_UNITS = 32  # ... unless the product would have fewer units
MMA_MIN_LEN = 512  # shorter operand below which the FFMA body runs
MMA_MIN_MACS = 1 << 19  # useful multiply-adds below which it runs


def _check(a, b, out_len) -> int:
    _check_operand("a", a, 1)
    _check_operand("b", b, 1)
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    lc = int(out_len)
    if not 1 <= lc <= _MAX_DIM:
        raise ValueError(f"unsupported out_len {lc}")
    return lc


def fold_rows(la: int, lb: int, lc: int) -> tuple[int, int, int]:
    """a's folded rows, b's block diagonals (those whose Toeplitz tile
    holds a word of b) and c's folded rows."""
    return _cdiv(la, W), (lb + W - 2) // W + 1, _cdiv(lc, W)


def folded_product(a, b, out_len: int):
    """``c[k] = sum_j b[j] a[k - j]`` for ``k < out_len``, in the dtype and
    on the device of ``a`` and ``b`` (1-D, the same dtype): a loop over
    the block diagonals d of one ``(rows x W) @ (W x W)`` product each,
    summed in place in d order.  Memory: the operands and the result
    padded to whole rows, and one ``W x W`` tile."""
    la, lb, lc = a.shape[0], b.shape[0], int(out_len)
    ra, nd, rc = fold_rows(la, lb, lc)
    fa = torch.zeros(ra * W, dtype=a.dtype, device=a.device)
    fa[:la] = a
    fa = fa.view(ra, W)
    # T_d[s, r] = pb[W d + (W - 1) + r - s]
    pb = torch.zeros((nd + 1) * W, dtype=b.dtype, device=b.device)
    pb[W - 1:W - 1 + lb] = b
    r = torch.arange(W, device=a.device)
    idx = (W - 1) + r[None, :] - r[:, None]
    c = torch.zeros((rc, W), dtype=a.dtype, device=a.device)
    # output row p = d + q reads a's row q
    for d in range(min(nd, rc)):
        rows = min(ra, rc - d)
        c[d:d + rows].addmm_(fa[:rows], pb[W * d + idx])
    return c.view(-1)[:lc]


def conv1d_trunc_f32_reference(a, b, out_len):
    """Plain PyTorch version: ``folded_product`` in f32 (it raises on a
    card with TF32 matmuls on)."""
    lc = _check(a, b, out_len)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the f32 reference needs TF32 matmuls disabled")
    return folded_product(a, b, lc)


def _swap(la: int, lb: int) -> bool:
    """Pass the operands as (b, a), so that the shorter one is the
    kernel's b (the product is symmetric)."""
    return lb > la


def fold_body(la: int, lb: int, lc: int) -> str:
    """Which body ``conv1d_trunc_f32`` runs for these lengths: ``"mma"``
    (split TF32 on the tensor cores, on ``fold_plan``'s units), or
    ``"ffma"`` where the shorter operand has fewer than ``MMA_MIN_LEN``
    words or the product fewer than ``MMA_MIN_MACS`` useful multiply-adds:
    there the FFMA body's chains, as long as the shorter operand, end
    before the tensor-core body's staging and slot sum do."""
    if min(la, lb) < MMA_MIN_LEN:
        return "ffma"
    if _conv_pair_flops((la,), (lb,), (lc,)) < MMA_MIN_MACS:
        return "ffma"
    return "mma"


class FoldPlan(NamedTuple):
    """How the kernel cuts one product into work units."""

    #: the operands go to the kernel as (b, a): see ``_swap``
    swap: bool
    #: int32 (n, 4), heaviest first: P0 (the tile's first folded output
    #: row), d_lo, d_hi, the unit's slot in the workspace (-1: it writes c
    #: directly).  Empty for the FFMA body.
    units: np.ndarray
    #: int32 (m, 4), one row per tile of more than one unit: P0, 0, its
    #: first slot, its number of slots (the rows ``sum_units_kernel`` reads)
    sums: np.ndarray
    #: workspace tiles (of W x W floats) the product needs
    slots: int
    #: False where some output tile has no unit (c is then zero-filled)
    covers: bool

    def weights(self) -> np.ndarray:
        """Block diagonals of every unit (x W^3 multiply-adds)."""
        return self.units[:, 2] - self.units[:, 1]


@functools.lru_cache(maxsize=1024)
def fold_plan(la: int, lb: int, lc: int) -> FoldPlan:
    """The work units of ``conv1d_trunc_f32`` for these lengths.

    A unit is (output tile of ``W`` folded rows at P0, range of block
    diagonals d).  Tile P0's range is clipped to where a's rows and b's
    diagonals are nonzero and to c's rows (no unit is empty), then cut
    until a unit holds about ``1 / UNIT_TARGET`` of the product (the
    lightest tiles, ``TAIL_SHARE`` of the work, ``TAIL_DIV`` times finer),
    but not below ``MIN_DIAG`` diagonals (a unit pays one exposed staging
    and a slot), or below the size that leaves ``MIN_UNITS`` units where
    that is smaller (a short product still fills part of the card); cuts
    fall at multiples of the staged group ``G`` from the range's start
    where the pieces are that long.  Units are sorted heaviest first, so
    the card's block scheduler ends with the light ones.  A tile of
    several units gets consecutive workspace slots in d order, which a
    second kernel adds in slot order: the result depends on the lengths
    alone, not on the card or on which block ran what.  The FFMA body has
    no units."""
    swap = _swap(la, lb)
    if swap:
        la, lb = lb, la
    if fold_body(la, lb, lc) == "ffma":
        return FoldPlan(swap, np.zeros((0, 4), dtype=np.int32),
                        np.zeros((0, 4), dtype=np.int32), 0, True)
    ra, nd, rc = fold_rows(la, lb, lc)
    tiles = []
    for P0 in range(0, rc, W):
        lo, hi = max(0, P0 - ra + 1), min(nd, P0 + W, rc)
        if hi > lo:
            tiles.append((P0, lo, hi))
    covers = len(tiles) == _cdiv(rc, W)
    weight = [hi - lo for _, lo, hi in tiles]
    total = sum(weight)
    floor = max(1, min(MIN_DIAG, total // MIN_UNITS))
    target = max(floor, total / UNIT_TARGET)
    fine, done = set(), 0
    for i in sorted(range(len(tiles)), key=lambda i: weight[i]):
        if done + weight[i] > TAIL_SHARE * total:
            break
        done += weight[i]
        fine.add(i)
    units, sums, slots = [], [], 0
    for i, (P0, lo, hi) in enumerate(tiles):
        n = hi - lo
        goal = max(floor, target / TAIL_DIV) if i in fine else target
        k = max(1, min(n // floor, _cdiv(n, int(goal))))
        if k == 1:
            units.append((P0, lo, hi, -1))
            continue
        cuts = _even_cuts(lo, n, k, G if n // k >= G else 1)
        sums.append((P0, 0, slots, k))
        units.extend((P0, d_lo, d_hi, slots + z)
                     for z, (d_lo, d_hi) in enumerate(cuts))
        slots += k
    units.sort(key=lambda u: -(u[2] - u[1]))
    return FoldPlan(swap, np.asarray(units, dtype=np.int32).reshape(-1, 4),
                    np.asarray(sums, dtype=np.int32).reshape(-1, 4), slots,
                    covers)


def issued_macs(plan: FoldPlan) -> int:
    """Multiply-adds the tensor-core body issues for ``plan`` (one pass):
    a full ``W x W x W`` tile product for every unit's diagonal, before a
    warp skips the rows that lie wholly outside a."""
    return int(plan.weights().astype(np.int64).sum()) * W ** 3


@functools.lru_cache(maxsize=256)
def _plan_on_card(la, lb, lc, device):
    """``fold_plan`` with its two tables on ``device``, kept for the next
    call of the same lengths."""
    plan = fold_plan(la, lb, lc)
    units = torch.from_numpy(plan.units).to(device)
    sums = torch.from_numpy(plan.sums).to(device)
    return plan, units, sums


def conv1d_trunc_f32(a, b, out_len):
    """Truncated 1-D Cauchy product of f32 vectors ``a`` (la,) and ``b``
    (lb,) to length ``out_len``; any lengths from 1 to 2^20.  On the card
    the same bits from call to call and card to card."""
    lc = _check(a, b, out_len)
    if not _on_card(a):
        return conv1d_trunc_f32_reference(a, b, lc)
    lib = _build.load()
    plan, units, sums = _plan_on_card(a.shape[0], b.shape[0], lc, a.device)
    if plan.swap:
        a, b = b, a
    # the tensor-core body (a plan with units) writes whole rows of W
    n = _cdiv(lc, W) * W if len(plan.units) else lc
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((n,), dtype=torch.float32, device=a.device)
    work = (torch.empty((plan.slots, W, W), dtype=torch.float32,
                        device=a.device) if plan.slots else None)
    with _on_device(a.device):
        err = lib.conv1d_trunc_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(), units.data_ptr(),
            len(plan.units), sums.data_ptr(), len(plan.sums), a.shape[0],
            b.shape[0], lc, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "conv1d_trunc_f32", err)
    conv1d_trunc_f32.launches += 1
    return out if n == lc else out[:lc]


conv1d_trunc_f32.launches = 0
