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

Every kernel runs the work units of ``unit_plan``, a table computed here
from the shapes alone and read on the card.  ``conv2d_trunc_f32`` and
``conv2d_trunc_f32_batched`` run them in IEEE f32 FMAs
(``csrc/conv2d_unit.cuh``), on a plan that cuts j0 and j1.  The tile and
grouped kernels run them on the tensor cores, as split-TF32 ``mma.sync``
products of an a window with a Toeplitz tile of one b row that is never
built (``csrc/conv2d_mma.cuh``), on a plan that cuts j0 only: a j1 cut
would cost them 63 more contraction columns.  ``tile_body`` says which
shapes take that body and which the FFMA one.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..taylor.backend import _antidiag_sum, _toeplitz

_MAX_DIM = 1 << 20  # int32 index math in the kernel stays far from overflow
_MAX_GRID_X = (1 << 31) - 1  # CUDA's limit on gridDim.x
TILE = 64  # output tile edge of the kernels (BM = BN in the csrc headers)
CHUNK = 32  # b columns staged together by K2 / K3 (CJ in conv2d_unit.cuh)
# The constants of ``unit_plan``, set from measurements on one H100
# (``tune_port.py``, PERF.md); they shape the table, never the result's
# accuracy, and no card property enters them.
MIN_ROWS = 32  # shortest j0 range a tile is cut into
UNIT_TARGET = 792  # coarse units a large product is cut into, about
TAIL_SHARE = 0.25  # share of the work, in the lightest tiles, cut finer
TAIL_DIV = 4  # how much finer
# the same for the plan of the tensor-core kernels (``cut_j1=False``)
MMA_MIN_ROWS = 16  # one staged group of j0 rows (MmaGeo::G in the .cuh)
MMA_J1_STEP = 64  # where that plan does cut j1: at multiples of a tile
MMA_MIN_COLS = 8  # b columns below which K4a / K4b take the FFMA body


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _swap(a_shape, b_shape) -> bool:
    """Pass the operands as (b, a), so that the smaller one is the
    kernel's b (the product is symmetric; the kernel loops over b)."""
    return b_shape[0] * b_shape[1] > a_shape[0] * a_shape[1]


def tile_ranges(a_shape, b_shape, out_shape, K0: int, K1: int):
    """The (j0_lo, j0_hi, j1_lo, j1_hi) of b that the output tile at
    (K0, K1) can use, ``a`` being zero outside its shape: the clipping of
    ``csrc/conv2d_tile.cuh``, with j1 also held below c1."""
    (a0, a1), (b0, b1), (c0, c1) = a_shape, b_shape, out_shape
    return (max(0, K0 - a0 + 1), min(b0, K0 + TILE, c0),
            max(0, K1 - a1 + 1), min(b1, K1 + TILE, c1))


def _even_cuts(lo: int, n: int, k: int, step: int = 1):
    """``k`` consecutive ranges covering [lo, lo + n), cut at multiples of
    ``step`` from ``lo``, their lengths within one ``step`` of each other."""
    blocks = _cdiv(n, step)
    marks = [lo + min(n, step * (blocks * i // k)) for i in range(k + 1)]
    return list(zip(marks[:-1], marks[1:]))


class UnitPlan(NamedTuple):
    """How the kernels cut one pair's product into work units."""

    #: the operands go to the kernel as (b, a): see ``_swap``
    swap: bool
    #: int32 (n, 8), heaviest first: K0, K1, j0_lo, j0_hi, j1_lo, j1_hi,
    #: the unit's slot in the workspace (-1: it writes c directly), 0
    units: np.ndarray
    #: int32 (m, 4), one row per output tile of more than one unit: K0,
    #: K1, its first slot, its number of slots
    sums: np.ndarray
    #: workspace tiles (of TILE x TILE floats) one pair needs
    slots: int
    #: False where some output tile has no unit (c is then zero-filled)
    covers: bool

    def weights(self) -> np.ndarray:
        """j0 x j1 steps of every unit (x TILE^2 multiply-adds)."""
        u = self.units
        return (u[:, 3] - u[:, 2]) * (u[:, 5] - u[:, 4])


@functools.lru_cache(maxsize=1024)
def unit_plan(a_shape, b_shape, out_shape, cut_j1: bool = True) -> UnitPlan:
    """The work units of ``conv2d_trunc_f32`` for these shapes (and of
    every entry of ``conv2d_trunc_f32_batched``), or with ``cut_j1=False``
    those of ``conv2d_trunc_f32_tile`` and ``conv2d_trunc_f32_grouped``.

    A unit is (output tile, j0 range, j1 range).  Every tile's clipped
    ranges (``tile_ranges``: no unit is empty) are cut until a unit holds
    about ``1 / UNIT_TARGET`` of the product's multiply-adds (the
    lightest tiles, ``TAIL_SHARE`` of the work, ``TAIL_DIV`` times finer),
    but not below ``MIN_ROWS`` rows x one chunk of columns: j0 into ranges
    of at least ``MIN_ROWS`` rows, j1 at multiples of ``CHUNK`` columns (1
    for a one-column b).  Units are sorted heaviest first, so the card's
    block scheduler, which hands the next block to the first free SM, ends
    with the light ones.  A tile of several units gets consecutive slots
    of a workspace, in (j0, j1) order, which a second kernel adds in slot
    order: the result depends on the shapes alone, not on the card or on
    which block ran what.

    ``cut_j1=False``: a unit of n1 columns of b contracts over n1 + 63
    columns of a on the tensor cores (the band of the Toeplitz tile), so
    the plan cuts j0 only, into ranges of at least ``MMA_MIN_ROWS`` rows;
    j1 is cut, at multiples of ``MMA_J1_STEP``, only in a tile whose j0
    range cannot be."""
    return plan_units(a_shape, b_shape, out_shape, cut_j1, MMA_MIN_ROWS)


def plan_units(a_shape, b_shape, out_shape, cut_j1: bool,
               mma_rows: int, j0_align: int = 1) -> UnitPlan:
    """``unit_plan``'s body, with the least j0 range of the plan that cuts
    j0 only (``cut_j1=False``) as ``mma_rows``, and every tile's j0 range
    starting at a multiple of ``j0_align`` (its first rows then meet only
    zeros of a: ``tile_ranges`` clips j0 where a ends).  K5
    (``ops.ozaki_conv``), which stages j0 in 16-row pieces and contracts
    over stages of 64 rows, asks for 64 rows aligned to 16."""
    swap = _swap(a_shape, b_shape)
    if swap:
        a_shape, b_shape = b_shape, a_shape
    c0, c1 = out_shape
    if cut_j1:
        chunk, min_rows = (1 if b_shape[1] == 1 else CHUNK), MIN_ROWS
    else:
        chunk, min_rows = MMA_J1_STEP, mma_rows
    tiles = []
    for K0 in range(0, c0, TILE):
        for K1 in range(0, c1, TILE):
            r = tile_ranges(a_shape, b_shape, out_shape, K0, K1)
            if r[1] > r[0] and r[3] > r[2]:
                tiles.append((K0, K1, r[0] - r[0] % j0_align, *r[1:]))
    covers = len(tiles) == _cdiv(c0, TILE) * _cdiv(c1, TILE)
    weight = [(t[3] - t[2]) * (t[5] - t[4]) for t in tiles]
    total = sum(weight)
    floor = min_rows * (chunk if cut_j1 else 1)
    target = max(floor, total / UNIT_TARGET)
    # the lightest tiles, TAIL_SHARE of the work, are cut TAIL_DIV times
    # finer: sorted last, their units fill the gaps as the card runs dry
    fine, done = set(), 0
    for i in sorted(range(len(tiles)), key=lambda i: weight[i]):
        if done + weight[i] > TAIL_SHARE * total:
            break
        done += weight[i]
        fine.add(i)
    units, sums, slots = [], [], 0
    for i, (K0, K1, j0_lo, j0_hi, j1_lo, j1_hi) in enumerate(tiles):
        n0, n1 = j0_hi - j0_lo, j1_hi - j1_lo
        goal = max(floor, target / TAIL_DIV) if i in fine else target
        max0, blocks1 = max(1, n0 // min_rows), _cdiv(n1, chunk)
        max1 = blocks1 if cut_j1 or max0 == 1 else 1
        # the fewest k0 x k1 cuts whose heaviest piece stays near the goal
        # (of those, the longest j0 ranges: a range's ends cost three
        # partly used steps); failing that, the lightest heaviest piece
        def cost(k):
            heaviest = _cdiv(n0, k[0]) * min(n1, chunk * _cdiv(blocks1, k[1]))
            near = heaviest <= 1.125 * goal
            return (not near, k[0] * k[1] if near else heaviest, k[0])

        k0, k1 = min(((k0, k1) for k0 in range(1, max0 + 1)
                      for k1 in range(1, max1 + 1)), key=cost)
        cuts = [(lo0, hi0, lo1, hi1)
                for lo0, hi0 in _even_cuts(j0_lo, n0, k0,
                                           1 if cut_j1 else min_rows)
                for lo1, hi1 in _even_cuts(j1_lo, n1, k1, chunk)]
        if len(cuts) > 1:
            sums.append((K0, K1, slots, len(cuts)))
        for n, cut in enumerate(cuts):
            units.append((K0, K1, *cut, slots + n if len(cuts) > 1 else -1,
                          0))
        if len(cuts) > 1:
            slots += len(cuts)
    # heaviest first; equal weights keep tile order
    units.sort(key=lambda u: -(u[3] - u[2]) * (u[5] - u[4]))
    return UnitPlan(
        swap, np.asarray(units, dtype=np.int32).reshape(-1, 8),
        np.asarray(sums, dtype=np.int32).reshape(-1, 4), slots, covers)


def tile_body(a_shape, b_shape) -> str:
    """Which body ``conv2d_trunc_f32_tile`` and ``conv2d_trunc_f32_grouped``
    run for these operands: ``"mma"`` (split TF32 on the tensor cores), or
    ``"ffma"`` where the kernel's b (the smaller operand) has fewer than
    ``MMA_MIN_COLS`` columns: a band narrower than one ``mma`` tile."""
    kb = a_shape if _swap(a_shape, b_shape) else b_shape
    return "ffma" if kb[1] < MMA_MIN_COLS else "mma"


def issued_macs(plan: UnitPlan, a_shape, b_shape, block: int = 1) -> int:
    """Multiply-adds the tensor-core kernels issue for ``plan`` (one
    pass): every unit a full TILE x TILE tile for each of its j0 and each
    column of a it contracts over (those whose band meets the unit's j1
    range, rounded up to whole blocks of ``block`` columns where the
    kernel's loop runs over such blocks, as K1's does), before a warp
    skips what lies wholly outside a or b."""
    a1 = (b_shape if plan.swap else a_shape)[1]
    u = plan.units.astype(np.int64)
    cols = (np.minimum(a1, u[:, 1] + TILE - u[:, 4])
            - np.maximum(0, u[:, 1] - u[:, 5] + 1))
    cols = -(-cols // block) * block
    return int(((u[:, 3] - u[:, 2]) * cols).sum()) * TILE * TILE


def batched_blocks(batch: int, plan: UnitPlan) -> int:
    """Blocks of ``conv2d_trunc_f32_batched``'s grid: one per (unit of the
    single-pair plan, batch entry), unit-major, on the grid's x axis."""
    blocks = batch * len(plan.units)
    if blocks > _MAX_GRID_X:
        raise ValueError(
            f"batch {batch} x {len(plan.units)} units exceeds the grid's "
            f"{_MAX_GRID_X} blocks"
        )
    return blocks


@functools.lru_cache(maxsize=256)
def _plan_on_card(a_shape, b_shape, out_shape, device, cut_j1=True):
    """``unit_plan`` with its two tables on ``device``, kept for the next
    call of the same shapes (no host-to-device copy then)."""
    plan = unit_plan(a_shape, b_shape, out_shape, cut_j1)
    units = torch.from_numpy(plan.units).to(device)
    sums = torch.from_numpy(plan.sums).to(device)
    return plan, units, sums


def _check_operand(name: str, t, ndim: int,
                   dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(
            f"{name} must be {ndim}-D, got shape {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    # a batch axis is bounded by the grid (``batched_blocks``)
    if min(t.shape) < 1 or max(t.shape[-2:]) > _MAX_DIM:
        raise ValueError(f"{name} has unsupported shape {tuple(t.shape)}")


def _check(a, b, out_shape, a_ndim: int = 2, b_ndim: int = 2,
           dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    _check_operand("a", a, a_ndim, dtype)
    _check_operand("b", b, b_ndim, dtype)
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


def _on_device(device):
    """A context in which ``device`` is the current CUDA device (no
    context switch where it already is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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


def _unit_kernel(wrapper, cut_j1, a, b, out_shape):
    """Launch the single-pair kernel named like ``wrapper`` on its unit
    plan: the table, the workspace its slots need, the smaller operand as
    the kernel's b."""
    c0, c1 = _check(a, b, out_shape)
    if not _on_card(a):
        return conv2d_trunc_f32_reference(a, b, (c0, c1))
    lib = _build.load()
    plan, units, sums = _plan_on_card(tuple(a.shape), tuple(b.shape),
                                      (c0, c1), a.device, cut_j1)
    if plan.swap:
        a, b = b, a
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((c0, c1), dtype=torch.float32, device=a.device)
    work = (torch.empty((plan.slots, TILE, TILE), dtype=torch.float32,
                        device=a.device) if plan.slots else None)
    with _on_device(a.device):
        err = getattr(lib, wrapper.__name__)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(),
            units.data_ptr(), len(plan.units), sums.data_ptr(),
            len(plan.sums), a.shape[0], a.shape[1], b.shape[1], c0, c1,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, wrapper.__name__, err)
    wrapper.launches += 1
    return out


def conv2d_trunc_f32(a, b, out_shape):
    """Truncated 2-D Cauchy product of f32 matrices ``a`` (a0, a1) and
    ``b`` (b0, b1) to ``out_shape`` (c0, c1); any sizes >= 1."""
    return _unit_kernel(conv2d_trunc_f32, True, a, b, out_shape)


def conv2d_trunc_f32_tile(a, b, out_shape):
    """``conv2d_trunc_f32`` on the tensor cores: every (tile, j0) a product
    of an a window with the Toeplitz tile of one b row, in three TF32
    passes over operands split into a high and a scaled low part, j0
    ascending, on the plan that cuts j0 only.  Equal to
    ``conv2d_trunc_f32`` to f32 rounding, and the same bits from call to
    call and card to card."""
    return _unit_kernel(conv2d_trunc_f32_tile, False, a, b, out_shape)


def conv2d_trunc_f32_grouped(a, b, out_shape):
    """``conv2d_trunc_f32_tile`` with j0 in residue-major order inside a
    staged group (j0 mod 8 outer), which lets the kernel carry its a
    operand in registers from one j0 of a class to the next: equal to it
    to f32 rounding."""
    return _unit_kernel(conv2d_trunc_f32_grouped, False, a, b, out_shape)


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
    plan, units, sums = _plan_on_card((a0, a1), tuple(b.shape), (c0, c1),
                                      a_batch.device)
    batched_blocks(batch, plan)
    # the kernel's operand b is the smaller one, as in conv2d_trunc_f32;
    # the shared operand has stride 0
    ka, kb = (b, a_batch) if plan.swap else (a_batch, b)
    ka_stride, kb_stride = (0, a0 * a1) if plan.swap else (a0 * a1, 0)
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((batch, c0, c1), dtype=torch.float32, device=a_batch.device)
    work = (torch.empty((batch, plan.slots, TILE, TILE), dtype=torch.float32,
                        device=a_batch.device) if plan.slots else None)
    with _on_device(a_batch.device):
        err = lib.conv2d_trunc_f32_batched(
            ka.data_ptr(), kb.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(),
            units.data_ptr(), len(plan.units), sums.data_ptr(),
            len(plan.sums), plan.slots, ka_stride, kb_stride, batch,
            ka.shape[-2], ka.shape[-1], kb.shape[-1], c0, c1,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, "conv2d_trunc_f32_batched", err)
    conv2d_trunc_f32_batched.launches += 1
    return out


for _wrapper in (conv2d_trunc_f32, conv2d_trunc_f32_tile,
                 conv2d_trunc_f32_grouped, conv2d_trunc_f32_batched):
    _wrapper.launches = 0
