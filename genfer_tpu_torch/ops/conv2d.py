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
kernel launches in its ``launches`` attribute, and those of its one-pass
mode in ``launches_1pass`` (CPU calls add nothing).

``highest`` has genfer_tpu's meaning.  True (the default) is the f32
product above.  False is the one-pass mode: on the TPU one DEFAULT-
precision matrix-unit pass (bf16 operands), here one TF32 pass.  The tile
kernel's (K4a's and K2's), the grouped kernel's (K4b's) and K3's run
``wgmma`` on operands that their C entry rounds once a call into scratch
that comes with the workspace (``csrc/conv2d_wgmma.cuh``: K4b's in
residue-major order; K3's in ``csrc/conv2d_trunc_f32_batched_1pass.cu``),
counted in ``tf32_round_operands.launches``; on a b of fewer than
``MMA_MIN_COLS`` columns their FFMA body on operands rounded in
registers.  A TF32 x TF32 product is exact in f32, so that mode
computes the f32 sums of the exact products of ``tf32_round(a)`` and
``tf32_round(b)``, and its plain version is the f32 one on rounded
operands.  Its error against f64 is about 2^-10 of the
product of the absolute values (TF32 keeps 10 stored mantissa bits, bf16
7: the TPU's mode is about 8x looser).

Every kernel runs the work units of ``unit_plan``, a table computed here
from the shapes alone and read on the card.  ``conv2d_trunc_f32`` and
``conv2d_trunc_f32_batched`` run them in IEEE f32 FMAs
(``csrc/conv2d_unit.cuh``), on a plan that cuts j0 and j1.  The tile and
grouped kernels run them on the tensor cores, at three passes as
split-TF32 ``mma.sync`` products of an a window with a Toeplitz tile of
one b row that is never built (``csrc/conv2d_mma.cuh``), on a plan that
cuts j0 only: a j1 cut
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


@functools.lru_cache(maxsize=1024)
def window_plan(a_shape, b_shape, out_shape, axis: int, lo: int,
                hi: int) -> UnitPlan:
    """``unit_plan(a_shape, b_shape, out_shape, False)``, the whole
    product's plan, restricted to the output tiles that meet [lo, hi) on
    ``axis`` (0: rows, 1: columns): those tiles keep their units, in the
    whole plan's order, and each tile of several units its slots in slot
    order, renumbered from 0 in the order of the tables' sum rows.  So
    every output in the window is summed as in the whole product."""
    plan = unit_plan(a_shape, b_shape, out_shape, False)

    def meets(k):
        return (k + TILE > lo) & (k < hi)

    units = plan.units[meets(plan.units[:, axis])].copy()
    sums = plan.sums[meets(plan.sums[:, axis])].copy()
    shift = {}
    first = 0
    for row in sums:
        shift[(int(row[0]), int(row[1]))] = int(row[2]) - first
        row[2] = first
        first += int(row[3])
    for u in units:
        if u[6] >= 0:
            u[6] -= shift[(int(u[0]), int(u[1]))]
    other = out_shape[1 - axis]
    tiles = ((-(-hi // TILE) - lo // TILE) * -(-other // TILE))
    covers = len({(int(u[0]), int(u[1])) for u in units}) == tiles
    return UnitPlan(plan.swap, units, sums, first, covers)


def tile_body(a_shape, b_shape) -> str:
    """Which body ``conv2d_trunc_f32_tile`` and ``conv2d_trunc_f32_grouped``
    run for these operands: ``"mma"`` (split TF32 on the tensor cores), or
    ``"ffma"`` where the kernel's b (the smaller operand) has fewer than
    ``MMA_MIN_COLS`` columns: a band narrower than one ``mma`` tile."""
    kb = a_shape if _swap(a_shape, b_shape) else b_shape
    return "ffma" if kb[1] < MMA_MIN_COLS else "mma"


def issued_macs(plan: UnitPlan, a_shape, b_shape, block: int = 1,
                align: int = 1) -> int:
    """Multiply-adds the tensor-core kernels issue for ``plan`` (one
    pass): every unit a full TILE x TILE tile for each of its j0 and each
    column of a it contracts over (those whose band meets the unit's j1
    range, the first rounded down to a multiple of ``align`` where the
    kernel stages from there, and their count rounded up to whole blocks
    of ``block`` columns where the kernel's loop runs over such blocks, as
    K1's does), before a warp skips what lies wholly outside a or b."""
    a1 = (b_shape if plan.swap else a_shape)[1]
    u = plan.units.astype(np.int64)
    first = np.maximum(0, u[:, 1] - u[:, 5] + 1)
    cols = np.minimum(a1, u[:, 1] + TILE - u[:, 4]) - first // align * align
    cols = -(-cols // block) * block
    return int(((u[:, 3] - u[:, 2]) * cols).sum()) * TILE * TILE


def _ffma_issued_macs(plan: UnitPlan, cj: int) -> int:
    """Multiply-adds the FFMA body (``csrc/conv2d_unit.cuh``) issues for
    ``plan`` in chunks of ``cj`` columns of b: every unit a full TILE x
    TILE tile for each j0 of its range and each column of the chunks that
    cover its j1 range from ``j1_lo`` rounded down to 4 (a one-column b,
    ``cj`` = 1, runs every stream step of its window without a branch:
    TM - 1 = 3 more than its j0 rows), before a warp skips the steps at
    which its window lies outside a."""
    u = plan.units.astype(np.int64)
    steps = u[:, 3] - u[:, 2] + (3 if cj == 1 else 0)
    chunks = -(-(u[:, 5] - (u[:, 4] & ~3)) // cj)
    return int((steps * chunks).sum()) * cj * TILE * TILE


def rowstrip_issued_flops(a_shape, b_shape, out_shape,
                          highest: bool = True) -> float:
    """Twice the multiply-adds ``conv2d_trunc_f32(..., highest=highest)``
    issues on the card for these shapes (genfer_tpu's function of the
    name counts its TPU kernel's (128, 128, 128) dots; this one counts
    this card's kernels): K2's FFMA body on ``unit_plan``, or with
    ``highest=False`` the one-pass tile kernel on the plan that cuts j0
    only: its ``wgmma`` body (``csrc/conv2d_wgmma.cuh``) issues, for each
    j0 of a unit, k-steps of 8 of a's columns from the first one the band
    meets rounded down to 4 through the last one (``issued_macs`` with
    ``block=8, align=4``; the plan clips j0 to where the window meets a,
    so no j0 is skipped); its FFMA body where the kernel's b has fewer
    than ``MMA_MIN_COLS`` columns.  Useful FLOPs over this are the plan's
    issue efficiency."""
    a_shape, b_shape = tuple(a_shape), tuple(b_shape)
    out_shape = tuple(int(x) for x in out_shape)
    plan = unit_plan(a_shape, b_shape, out_shape, highest)
    kb1 = (a_shape if plan.swap else b_shape)[1]
    if highest:
        macs = _ffma_issued_macs(plan, 1 if kb1 == 1 else CHUNK)
    elif kb1 < MMA_MIN_COLS:
        macs = _ffma_issued_macs(plan, 1 if kb1 == 1 else 8)
    else:
        macs = issued_macs(plan, a_shape, b_shape, block=8, align=4)
    return 2.0 * macs


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
def _plan_on_card(a_shape, b_shape, out_shape, device, cut_j1=True,
                  window=None):
    """``unit_plan`` with its two tables on ``device``, kept for the next
    call of the same shapes (no host-to-device copy then); with
    ``window`` = (axis, lo, hi), ``window_plan`` of that window."""
    plan = (unit_plan(a_shape, b_shape, out_shape, cut_j1) if window is None
            else window_plan(a_shape, b_shape, out_shape, *window))
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


def tf32_round(x):
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, 10 stored mantissa bits, by integer
    operations on the f32 words (half a TF32 unit added to the magnitude,
    the 13 low bits cleared).  Subnormals round on the same grid of
    2^-136; a value within half a unit of f32's largest becomes infinite;
    infinities and NaNs pass unchanged."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    words = x.contiguous().view(torch.int32)
    mag = words & 0x7FFFFFFF
    rounded = (mag + 0x1000) & ~0x1FFF
    sign = words & torch.iinfo(torch.int32).min
    finite = mag < 0x7F800000
    return torch.where(finite, rounded | sign, words).view(torch.float32)


def tf32_round_operands(a, b):
    """``tf32_round`` of both operands of a one-pass ``wgmma`` product, in
    one launch of the rounding kernel that the one-pass tile, grouped and
    batched entries launch themselves (``csrc/conv2d_wgmma.cuh``): each (..., n)
    to (..., n rounded up to 4), its pad columns zero.  Both results are
    views of one scratch tensor.  On a CPU tensor the plain version
    (``tf32_round`` and a pad).  ``launches`` counts the kernel's launches,
    these and the one-pass wrappers' alike."""
    pa, pb = (_cdiv(x.shape[-1], 4) * 4 for x in (a, b))
    if not _on_card(a):
        return tuple(torch.nn.functional.pad(tf32_round(x),
                                             (0, p - x.shape[-1]))
                     for x, p in ((a, pa), (b, pb)))
    a_rows, b_rows = a.numel() // a.shape[-1], b.numel() // b.shape[-1]
    scratch = torch.empty(a_rows * pa + b_rows * pb, dtype=torch.float32,
                          device=a.device)
    ra = scratch[:a_rows * pa].view(*a.shape[:-1], pa)
    rb = scratch[a_rows * pa:].view(*b.shape[:-1], pb)
    lib = _build.load()
    with _on_device(a.device):
        err = lib.tf32_round_operands(
            a.data_ptr(), ra.data_ptr(), a_rows, a.shape[-1], pa,
            b.data_ptr(), rb.data_ptr(), b_rows, b.shape[-1], pb,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "tf32_round_operands", err)
    tf32_round_operands.launches += 1
    return ra, rb


tf32_round_operands.launches = 0


def _rounding_words(a_rows: int, a1: int, b_rows: int, b1: int) -> int:
    """Words of the scratch into which a one-pass tile, grouped or batched
    entry rounds its operands (the kernel's: a of ``a_rows`` rows of ``a1``
    words, b, the smaller, of ``b_rows`` x ``b1``): each operand's rows
    padded to a multiple of 4 words where b has ``MMA_MIN_COLS`` or more
    columns (the entries run their ``wgmma`` body then, on rounded
    operands); 0 for a thinner b."""
    if b1 < MMA_MIN_COLS:
        return 0
    return a_rows * ((a1 + 3) & ~3) + b_rows * ((b1 + 3) & ~3)


def conv2d_trunc_f32_reference(a, b, out_shape, highest: bool = True):
    """Plain PyTorch version: Toeplitz einsum plus anti-diagonal sum, all
    in f32; ``highest=False``: the same on ``tf32_round`` of both operands
    (the one-pass mode).  On a card the einsum is a cuBLAS product, which
    must not run in TF32 (10 mantissa bits): it raises if TF32 matmuls are
    enabled."""
    c0, c1 = _check(a, b, out_shape)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the f32 reference needs TF32 matmuls disabled")
    if not highest:
        a, b = tf32_round(a), tf32_round(b)
    Ta = _toeplitz(a[:c0], c0, b.shape[0])  # [c0, b0, a1]
    H = torch.einsum("kji,jl->kil", Ta, b)  # [c0, a1, b1]
    return _antidiag_sum(H, c1)


def _unit_kernel(wrapper, entry, cut_j1, a, b, out_shape, highest,
                 rounds=False):
    """Launch the single-pair kernel ``entry`` for ``wrapper`` on its unit
    plan: the table, the workspace its slots need, the smaller operand as
    the kernel's b; count it in ``launches``, or in ``launches_1pass``
    where not ``highest``.  ``rounds``: a one-pass entry (tile or
    grouped), which also takes b's row count and the scratch it rounds the
    operands into (``_rounding_words``, allocated with the workspace)."""
    c0, c1 = _check(a, b, out_shape)
    if not _on_card(a):
        return conv2d_trunc_f32_reference(a, b, (c0, c1), highest)
    lib = _build.load()
    plan, units, sums = _plan_on_card(tuple(a.shape), tuple(b.shape),
                                      (c0, c1), a.device, cut_j1)
    if plan.swap:
        a, b = b, a
    (a0, a1), (b0, b1) = a.shape, b.shape
    slot_words = plan.slots * TILE * TILE
    scratch_words = _rounding_words(a0, a1, b0, b1) if rounds else 0
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((c0, c1), dtype=torch.float32, device=a.device)
    work = (torch.empty(slot_words + scratch_words, dtype=torch.float32,
                        device=a.device)
            if slot_words + scratch_words else None)
    tail = ()
    if rounds:
        tail = (b0, work.data_ptr() + 4 * slot_words if scratch_words else 0)
    with _on_device(a.device):
        err = getattr(lib, entry)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(),
            units.data_ptr(), len(plan.units), sums.data_ptr(),
            len(plan.sums), a0, a1, b1, c0, c1,
            torch.cuda.current_stream().cuda_stream, *tail,
        )
    _build.check(lib, entry, err)
    if highest:
        wrapper.launches += 1
    else:
        wrapper.launches_1pass += 1
    if scratch_words:
        tf32_round_operands.launches += 1
    return out


def conv2d_trunc_f32(a, b, out_shape, highest: bool = True):
    """Truncated 2-D Cauchy product of f32 matrices ``a`` (a0, a1) and
    ``b`` (b0, b1) to ``out_shape`` (c0, c1); any sizes >= 1.

    ``highest=False`` launches the one-pass tile kernel
    (``conv2d_trunc_f32_tile(..., highest=False)``, bit for bit): this
    kernel runs IEEE f32 FMAs and has no pass to drop, and on the TPU the
    row strip and the tile kernel give the same bits in either mode."""
    if highest:
        return _unit_kernel(conv2d_trunc_f32, "conv2d_trunc_f32", True, a,
                            b, out_shape, True)
    return _unit_kernel(conv2d_trunc_f32, "conv2d_trunc_f32_tile_1pass",
                        False, a, b, out_shape, False, rounds=True)


def conv2d_trunc_f32_tile(a, b, out_shape, highest: bool = True):
    """``conv2d_trunc_f32`` on the tensor cores: every (tile, j0) a product
    of an a window with the Toeplitz tile of one b row, in three TF32
    passes over operands split into a high and a scaled low part, j0
    ascending, on the plan that cuts j0 only.  Equal to
    ``conv2d_trunc_f32`` to f32 rounding, and the same bits from call to
    call and card to card.  ``highest=False``: the high parts' pass
    alone."""
    entry = "conv2d_trunc_f32_tile" + ("" if highest else "_1pass")
    return _unit_kernel(conv2d_trunc_f32_tile, entry, False, a, b,
                        out_shape, highest, rounds=not highest)


def conv2d_trunc_f32_grouped(a, b, out_shape, highest: bool = True):
    """``conv2d_trunc_f32_tile`` with j0 in residue-major order inside a
    staged group (j0 mod 8 outer): equal to it to f32 rounding, in either
    mode.  At three passes the order lets the kernel carry its a operand
    in registers from one j0 of a class to the next; at one pass
    (``highest=False``) it runs the one-pass tile kernel's ``wgmma`` body
    with a chain per class (``csrc/conv2d_wgmma.cuh``), on operands its
    entry rounds once a call."""
    entry = "conv2d_trunc_f32_grouped" + ("" if highest else "_1pass")
    return _unit_kernel(conv2d_trunc_f32_grouped, entry, False, a, b,
                        out_shape, highest, rounds=not highest)


def conv2d_trunc_f32_batched_reference(a_batch, b, out_shape,
                                       highest: bool = True):
    """Plain PyTorch version of the batch: ``conv2d_trunc_f32_reference``
    for every entry (one entry's Toeplitz tensor at a time: at order 512
    it is 0.5 GB)."""
    c0, c1 = _check(a_batch, b, out_shape, a_ndim=3)
    return torch.stack([conv2d_trunc_f32_reference(x, b, (c0, c1), highest)
                        for x in a_batch])


def conv2d_trunc_f32_batched(a_batch, b, out_shape, highest: bool = True):
    """Truncated 2-D Cauchy products of every ``a_batch[g]`` (B, a0, a1)
    with one shared ``b`` (b0, b1), to (B, c0, c1).  A shared-LHS batch
    (one a, a batch of b) is this call with the operands swapped.  Every
    entry equals ``conv2d_trunc_f32(a_batch[g], b, out_shape, highest)``
    bit for bit on the card: ``highest=False`` runs the one-pass tile
    kernel's units (``csrc/conv2d_trunc_f32_batched_1pass.cu``) on its
    plan."""
    c0, c1 = _check(a_batch, b, out_shape, a_ndim=3)
    if not _on_card(a_batch):
        return conv2d_trunc_f32_batched_reference(a_batch, b, (c0, c1),
                                                  highest)
    lib = _build.load()
    batch, a0, a1 = a_batch.shape
    plan, units, sums = _plan_on_card((a0, a1), tuple(b.shape), (c0, c1),
                                      a_batch.device, cut_j1=highest)
    batched_blocks(batch, plan)
    # the kernel's operand b is the smaller one, as in conv2d_trunc_f32;
    # the shared operand has stride 0
    ka, kb = (b, a_batch) if plan.swap else (a_batch, b)
    (ka0, ka1), (kb0, kb1) = ka.shape[-2:], kb.shape[-2:]
    ka_stride, kb_stride = ((0, kb0 * kb1) if plan.swap
                            else (ka0 * ka1, 0))
    slot_words = batch * plan.slots * TILE * TILE
    scratch_words = 0 if highest else _rounding_words(
        ka0 * (batch if ka.ndim == 3 else 1), ka1,
        kb0 * (batch if kb.ndim == 3 else 1), kb1)
    alloc = torch.empty if plan.covers else torch.zeros
    out = alloc((batch, c0, c1), dtype=torch.float32, device=a_batch.device)
    work = (torch.empty(slot_words + scratch_words, dtype=torch.float32,
                        device=a_batch.device)
            if slot_words + scratch_words else None)
    tail = () if highest else (
        kb0, work.data_ptr() + 4 * slot_words if scratch_words else 0)
    entry = "conv2d_trunc_f32_batched" + ("" if highest else "_1pass")
    with _on_device(a_batch.device):
        err = getattr(lib, entry)(
            ka.data_ptr(), kb.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(),
            units.data_ptr(), len(plan.units), sums.data_ptr(),
            len(plan.sums), plan.slots, ka_stride, kb_stride, batch,
            ka0, ka1, kb1, c0, c1,
            torch.cuda.current_stream().cuda_stream, *tail,
        )
    _build.check(lib, entry, err)
    if highest:
        conv2d_trunc_f32_batched.launches += 1
    else:
        conv2d_trunc_f32_batched.launches_1pass += 1
    if scratch_words:
        tf32_round_operands.launches += 1
    return out


for _wrapper in (conv2d_trunc_f32, conv2d_trunc_f32_tile,
                 conv2d_trunc_f32_grouped, conv2d_trunc_f32_batched):
    _wrapper.launches = 0
    _wrapper.launches_1pass = 0
