"""The arithmetic and the index algebra of the tensor-core kernels K4a
(``conv2d_trunc_f32_tile``) and K4b (``conv2d_trunc_f32_grouped``),
``genfer_tpu_torch/csrc/conv2d_mma.cuh``, emulated in numpy.

A CUDA kernel cannot run without a card, so what these tests hold is the
design the kernel follows, against genfer_tpu's host f64 product at the
Pallas tests' bar (rtol 5e-5 / atol 1e-6):

* the split: hi = tf32(x) rounded to nearest, lo = tf32((x - hi) * 2^11),
  three TF32 products (hi*hi, hi*lo, lo*hi) on the unit plan that cuts j0
  only, ``mma`` chains of eight steps from zero accumulators, f32 sums
  at three levels outside the chain.  Inside a chain the f32 accumulation
  is emulated as round-toward-zero with results below f32's smallest
  normal flushed to zero: the pessimistic reading of a tensor core.  The
  same emulation with one long chain, or without the 2^11 scale, fails
  the bar: that is why the design has both;
* the fragment offsets: an ``mma.sync.m16n8k8`` assembled lane by lane
  from the offsets the kernel computes names the a window times the
  Toeplitz tile of one b row;
* the residue carry of K4b: shifting the A halves down and loading the
  top one names the same window rows as loading all of them;
* the one-pass mode (``highest=False``): the ``wgmma`` body of the
  one-pass tile kernel, K4b and K3 (``csrc/conv2d_wgmma.cuh``,
  ``emulate_wgmma``: the tile product transposed, the Toeplitz from
  registers at the kernel's addresses, the a window staged in 4-column
  chunks and read through the kernel's descriptor, which steps 16 bytes a
  j0, chains from zero added to their group in the order of
  ``stage_schedule``: a chain of eight k-steps per j0 in j0 order, or
  K4b's residue-major chain per class over both its j0), and on a b of
  fewer than 8 columns the FFMA body on TF32-rounded operands
  (``emulate_ffma``), each within the one-pass bound of f64: 2^-10 of the
  product of the absolute values plus the three-pass bar.  The two
  orders agree to f32 rounding.  The same ``wgmma`` emulation with the
  descriptor's two strides swapped fails the bar.
"""

import numpy as np
import pytest
import torch

from genfer_tpu.taylor.backend import NumpyF64Backend
from genfer_tpu_torch import bench
from genfer_tpu_torch.ops import conv2d as C

RTOL, ATOL = 5e-5, 1e-6
ATOL_EXTREME = 1e-37
TILE = C.TILE
G = 16  # j0 rows a stage (MmaGeo in conv2d_mma.cuh)
KB = 64  # a columns a stage
SLICES = KB // 8
CHAIN = SLICES // 2  # k-slices of one chain of K4b
TINY = float(np.finfo(np.float32).tiny)

# tests/test_parallel_ops.py::test_pallas_conv2d_rowstrip_interpret
ROWSTRIP_SHAPES = [
    ((5, 7), (4, 6), (8, 12)),
    ((70, 80), (60, 50), (70, 80)),
    ((200, 300), (150, 100), (280, 380)),
]


def tf32_rn(x):
    """cvt.rna.tf32.f32: 10 explicit mantissa bits, round to nearest, ties
    away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, scale):
    """The two planes the kernel stages."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_rn(x)
    return hi, tf32_rn((x - hi) * np.float32(scale))


def chain_step(acc, part):
    """One ``mma`` into an f32 accumulator, pessimistically: the exact sum
    of the accumulator and the slice's products, rounded toward zero, and
    flushed to zero below f32's normal range."""
    exact = acc.astype(np.float64) + part
    got = exact.astype(np.float32)
    over = np.abs(got.astype(np.float64)) > np.abs(exact)
    got = np.where(over, np.nextafter(got, np.float32(0)), got)
    return np.where(np.abs(got) < TINY, np.float32(0), got)


def emulate(a, b, out, order="ascending", scale=2048.0, long_chain=False,
            plan=None, tiles=None):
    """The f32 result of the kernel's arithmetic for f64 operands ``a``,
    ``b`` (cast to f32 first, as the wrapper's caller does).  ``tiles``
    restricts the work to those output tiles; the rest of the result is
    NaN."""
    plan = plan or C.unit_plan(a.shape, b.shape, out, cut_j1=False)
    ka, kb = (b, a) if plan.swap else (a, b)
    ka = np.asarray(ka, dtype=np.float32)
    kb = np.asarray(kb, dtype=np.float32)
    a0, a1 = ka.shape
    unscale = np.float32(1.0 / scale)
    # a and b with zeros around, so that every window is a plain slice
    pad0, pad1 = TILE + G, KB + TILE
    ah, al = split(np.pad(ka, ((pad0, pad0 + out[0]), (0, pad1 + out[1]))),
                   scale)
    c = np.full(out, np.nan, dtype=np.float32)
    work = np.zeros((max(plan.slots, 1), TILE, TILE), dtype=np.float32)
    wanted = {}
    for K0, K1, lo0, hi0, lo1, hi1, slot, _ in plan.units.tolist():
        if tiles is not None and (K0, K1) not in tiles:
            continue
        i1_lo, i1_hi = max(0, K1 - hi1 + 1), min(a1, K1 + TILE - lo1)
        acc = np.zeros((TILE, TILE), dtype=np.float32)
        hh = np.zeros((TILE, TILE), dtype=np.float32)
        cr = np.zeros((TILE, TILE), dtype=np.float32)
        for g0 in range(lo0, hi0, G):
            for i1_0 in range(i1_lo, i1_hi, KB):
                # b rows g0 .. g0 + G - 1, words K1 - i1_0 - KB + 1 + x,
                # masked to the unit
                col0 = K1 - i1_0 - KB + 1
                rows = np.zeros((G, KB + TILE - 1), dtype=np.float32)
                x = np.arange(KB + TILE - 1)
                ok = (col0 + x >= lo1) & (col0 + x < hi1)
                n = min(G, hi0 - g0)
                rows[:n, ok] = kb[g0:g0 + n, (col0 + x)[ok]]
                bh, bl = split(rows, scale)
                # T[dj, k, n] = row[dj, n - k + KB - 1]
                view = np.lib.stride_tricks.sliding_window_view
                th, tl = (view(r, TILE, axis=1)[:, ::-1, :] for r in (bh, bl))
                # A[dj, m, k] = a[K0 + m - (g0 + dj), i1_0 + k]
                r0 = pad0 + K0 - g0
                wh, wl = (np.stack([p[r0 - dj:r0 - dj + TILE,
                                      i1_0:i1_0 + KB] for dj in range(G)])
                          for p in (ah, al))
                # the slices' exact products, [dj, slice, m, n]
                def products(w, t):
                    w = w.reshape(G, TILE, SLICES, 8).transpose(0, 2, 1, 3)
                    t = t.reshape(G, SLICES, 8, TILE)
                    return np.matmul(w.astype(np.float64),
                                     t.astype(np.float64))

                p_hh, p_hl, p_lh = (products(wh, th), products(wh, tl),
                                    products(wl, th))
                # rows beyond the unit are zero, and a chain step that
                # adds zero changes nothing: every stage runs all G rows
                if long_chain:
                    for dj in range(n):
                        for s in range(SLICES):
                            hh = chain_step(hh, p_hh[dj, s])
                            cr = chain_step(cr, p_hl[dj, s])
                            cr = chain_step(cr, p_lh[dj, s])
                    continue
                if order == "ascending":  # [step = slice, chain = dj]
                    steps = [p.transpose(1, 0, 2, 3)
                             for p in (p_hh, p_hl, p_lh)]
                else:
                    # dj = r + 8 q; a chain is (class r, half of the
                    # slices), its steps (slice, q)
                    steps = [p.reshape(G // 8, 8, 2, CHAIN, TILE, TILE)
                             .transpose(3, 0, 1, 2, 4, 5)
                             .reshape(CHAIN * G // 8, 16, TILE, TILE)
                             for p in (p_hh, p_hl, p_lh)]
                hh = np.zeros(steps[0].shape[1:], dtype=np.float32)
                cr = np.zeros_like(hh)
                for s_hh, s_hl, s_lh in zip(*steps):
                    hh = chain_step(hh, s_hh)
                    cr = chain_step(chain_step(cr, s_hl), s_lh)
                ends = (cr.astype(np.float64) * unscale + hh).astype(
                    np.float32)
                grp = np.zeros((TILE, TILE), dtype=np.float32)
                for end in ends:  # chain ends, in the kernel's order
                    grp += end
                acc += grp
        if long_chain:
            acc = (cr.astype(np.float64) * unscale + hh).astype(np.float32)
        if slot < 0:
            wanted[(K0, K1)] = acc
        else:
            work[slot] = acc
    for K0, K1, first, n in plan.sums.tolist():
        if tiles is None or (K0, K1) in tiles:
            total = np.zeros((TILE, TILE), dtype=np.float32)
            for z in range(first, first + n):
                total += work[z]
            wanted[(K0, K1)] = total
    for (K0, K1), tile in wanted.items():
        r, q = min(TILE, out[0] - K0), min(TILE, out[1] - K1)
        c[K0:K0 + r, K1:K1 + q] = tile[:r, :q]
    if tiles is None and not plan.covers:
        c[np.isnan(c)] = 0
    return c


def emulate_ffma(a, b, out, passes=1):
    """The f32 result of the FFMA body (``csrc/conv2d_unit.cuh``) that the
    tensor-core kernels run where their b has fewer than 8 columns, on
    their plan (CJ = 1 for one column, else 8), each operand word rounded
    to TF32 as it leaves shared memory where ``passes`` is 1.  Output row
    m of a tile takes stream step s at j0 = s + m % 4; grp collects FMAs
    (exact products, one rounding) and is added to acc every 8 stream
    steps and at a stage's end; a tile's units are added in slot order.
    Steps at which a warp's window lies outside a add zeros here."""
    plan = C.unit_plan(a.shape, b.shape, out, cut_j1=False)
    ka, kb = (b, a) if plan.swap else (a, b)
    rnd = tf32_rn if passes == 1 else (lambda x: x)
    ka = rnd(np.asarray(ka, dtype=np.float32)).astype(np.float64)
    kb = rnd(np.asarray(kb, dtype=np.float32)).astype(np.float64)
    a0, a1 = ka.shape
    cj = 1 if kb.shape[1] == 1 else 8
    stage = 64 if cj == 1 else 24  # Geo<CJ>::G
    tm = 4
    c = np.zeros(out, dtype=np.float32)
    work = np.zeros((max(plan.slots, 1), TILE, TILE), dtype=np.float32)
    m = np.arange(TILE)
    n = np.arange(TILE)
    for K0, K1, lo0, hi0, lo1, hi1, slot, _ in plan.units.tolist():
        acc = np.zeros((TILE, TILE), dtype=np.float32)
        grp = np.zeros((TILE, TILE), dtype=np.float32)
        s_lo = lo0 - (tm - 1)
        for jb in range(lo1 & ~3, hi1, cj):
            for s0 in range(s_lo, hi0, stage):
                for ds in range(min(stage, hi0 - s0)):
                    for i in range(tm):
                        t = s0 + ds + i
                        if not lo0 <= t < hi0:
                            continue
                        rows = K0 + m[i::tm] - t
                        for j1 in range(jb, min(jb + cj, hi1)):
                            if j1 < lo1:
                                continue
                            cols = K1 + n - j1
                            ok = ((rows[:, None] >= 0) & (rows[:, None] < a0)
                                  & (cols[None] >= 0) & (cols[None] < a1))
                            win = np.where(ok, ka[np.clip(rows, 0, a0 - 1)][
                                :, np.clip(cols, 0, a1 - 1)], 0.0)
                            grp[i::tm] = (grp[i::tm] + win * kb[t, j1]
                                          ).astype(np.float32)
                    if ds % 8 == 7:
                        acc += grp
                        grp[:] = 0
                acc += grp
                grp[:] = 0
        if slot < 0:
            r, q = min(TILE, out[0] - K0), min(TILE, out[1] - K1)
            c[K0:K0 + r, K1:K1 + q] = acc[:r, :q]
        else:
            work[slot] = acc
    for K0, K1, first, count in plan.sums.tolist():
        total = np.zeros((TILE, TILE), dtype=np.float32)
        for z in range(first, first + count):
            total += work[z]
        r, q = min(TILE, out[0] - K0), min(TILE, out[1] - K1)
        c[K0:K0 + r, K1:K1 + q] = total[:r, :q]
    return c


# the wgmma body (WgGeo in conv2d_wgmma.cuh)
WG_CHUNK_ROWS = TILE + G - 1 + 2  # window rows a chunk, 2 of them pad
WG_CHUNK_BYTES = 16 * WG_CHUNK_ROWS
WG_W_BYTES = (KB // 4) * WG_CHUNK_BYTES
WG_B_PITCH = KB + TILE
WG_STAGE_WORDS = WG_W_BYTES // 4 + G * WG_B_PITCH
WG_SBO = 128


def window_desc(addr, lbo=WG_CHUNK_BYTES, sbo=WG_SBO):
    """The kernel's descriptor of the window at shared byte ``addr``."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


def desc_words(desc):
    """The words (4-byte units of shared memory) that a K-major, unswizzled
    wgmma descriptor names for B[k, n] of an m64n64k8 TF32 product (8 x
    64): core matrices of 8 rows of n x 16 bytes of k, rows 16 bytes
    apart; the next 8 rows of n ``SBO`` bytes on, the next 4 of k ``LBO``
    bytes on; the start in 16-byte units."""
    desc = np.asarray(desc, dtype=np.int64)[..., None, None]
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    k = np.arange(8)[:, None]
    n = np.arange(TILE)[None, :]
    return (start + n // 8 * sbo + n % 8 * 16 + k // 4 * lbo + k % 4 * 4) // 4


def _wgmma_a_words():
    """Per k-step ks, the b-row word each element A[n, k] of the wgmma's A
    (64 x 8) comes from, assembled lane by lane from the kernel's
    registers: warp w, lane 4 g + t loads u[i] = word x0 + 8 - 4 i, x0 =
    16 w + g - t + KB, and k-step ks takes (a0, a1, a2, a3) = (u[2 ks +
    2], u[2 ks], u[2 ks + 3], u[2 ks + 1]), in the m16n8k8 A layout of the
    warp's 16 rows: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    words = np.full((SLICES, TILE, 8), -1)
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            x0 = 16 * w + g - t + KB
            u = [x0 + 8 - 4 * i for i in range(2 * SLICES + 2)]
            for ks in range(SLICES):
                regs = (u[2 * ks + 2], u[2 * ks], u[2 * ks + 3], u[2 * ks + 1])
                for (dr, dc), word in zip(((0, 0), (8, 0), (0, 4), (8, 4)),
                                          regs):
                    words[ks, 16 * w + g + dr, t + dc] = word
    assert (words >= 0).all()
    return words


def _wgmma_c_cells():
    """(tile row, tile column) of accumulator register 4 j + 2 h + e of
    lane 4 g + t in warp w, for every (thread, register), and the (n, m)
    of C^T = D it holds: D's layout for m64nNk8 (row 16 w + 8 h + g,
    column 8 j + 2 t + e)."""
    cells, d_index = [], []
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for j in range(8):
                for h in range(2):
                    for e in range(2):
                        n, m = 16 * w + 8 * h + g, 8 * j + 2 * t + e
                        cells.append((m, n))
                        d_index.append((n, m))
    return np.array(cells), np.array(d_index)


WG_A_WORDS = _wgmma_a_words()
WG_C_CELLS, WG_D_INDEX = _wgmma_c_cells()


def wgmma_stage(kb, apad, a0, a1, K0, K1, g0, i1_0, j0_hi, j1_lo, j1_hi):
    """One ring slot as the kernel's ``issue`` fills it: float32 words,
    NaN where nothing is staged (stale words a read would carry).  Window
    row r, chunk ch (16-byte units at ch * CHUNK_BYTES + 16 r):
    A[K0 - (g0 + G - 1) + r][i1_0 + 4 ch ..], zero outside the padded A;
    rows r < G - n_dj unstaged.  b row dj, word x: B[g0 + dj][K1 - i1_0 -
    KB + x] (a 16-byte aligned start), zero outside [j1_lo, j1_hi) (the
    kernel's 16-byte pieces, copied whole inside, zero whole outside and
    word by word across an end, give these words)."""
    smem = np.full(WG_STAGE_WORDS, np.nan, dtype=np.float32)
    n_dj = min(G, j0_hi - g0)
    # A with zeros around: every (row, chunk) the window names is in range
    big = np.pad(apad, ((TILE + G, TILE + G), (0, KB + 4)))
    r = np.arange(G - n_dj, TILE + G - 1)[:, None, None]
    ch = np.arange(KB // 4)[None, :, None]
    k = np.arange(4)[None, None, :]
    ar = K0 - (g0 + G - 1) + r
    smem[(ch * WG_CHUNK_BYTES + 16 * r) // 4 + k] = big[ar + TILE + G,
                                                         i1_0 + 4 * ch + k]
    col0 = K1 - i1_0 - KB
    assert col0 % 4 == 0
    j1 = col0 + np.arange(WG_B_PITCH)
    ok = (j1 >= j1_lo) & (j1 < j1_hi)
    rows = np.zeros((n_dj, WG_B_PITCH), dtype=np.float32)
    rows[:, ok] = kb[g0:g0 + n_dj, j1[ok]]
    base = WG_W_BYTES // 4
    smem[base:base + n_dj * WG_B_PITCH] = rows.ravel()
    return smem


def stage_schedule(order, dj_lo, dj_hi, ks_hi, chain=SLICES):
    """The chains of one stage of the ``wgmma`` body over its live j0, dj
    in [dj_lo, dj_hi), each a list of (dj, k-step) in issue order
    (``stage_chains``).  ``ascending``: a chain per j0 in j0 order over
    the stage's ``ks_hi`` k-steps.  ``residue``: dj mod 8 outer; a class
    with both its j0 live runs chains of ``chain`` k-steps of each, dj = r
    then r + 8 (``chain`` = 8: one chain of 2 ``ks_hi`` k-steps,
    ``class_chain``); a class with one live j0 runs that j0's chain."""
    live = range(dj_lo, dj_hi)
    if order == "ascending":
        return [[(dj, ks) for ks in range(ks_hi)] for dj in live]
    chains = []
    for r in range(8):
        djs = [dj for dj in (r, r + 8) if dj in live]
        if len(djs) == 1:
            chains.append([(djs[0], ks) for ks in range(ks_hi)])
        elif djs:
            for k0 in range(0, ks_hi, chain):
                chains.append([(dj, ks) for dj in djs
                               for ks in range(k0, min(ks_hi, k0 + chain))])
    return chains


def emulate_wgmma(a, b, out, lbo=WG_CHUNK_BYTES, sbo=WG_SBO, plan=None,
                  order="ascending", chain=SLICES):
    """The f32 result of the one-pass ``wgmma`` body
    (``csrc/conv2d_wgmma.cuh``) for f64 operands ``a``, ``b`` (cast to f32
    first): both rounded to TF32 once (A's rows padded with zeros to 4
    words); per unit, per stage (16 rows of j0 x 64 of a's columns from
    the band's first column rounded down to 4), the slot as the kernel
    stages it; the live j0 (their window rows meeting A) and the stage's
    k-steps that meet A's columns: C^T += A_ks B_ks, A_ks from the b row
    at the register words, B_ks at the descriptor's words (k-step 0's
    start row G - 1 - dj, each k-step two chunks on), in the chains of
    ``stage_schedule(order, ..., chain)``, one ``chain_step`` a k-step
    from zero, as ``emulate(..., long_chain=True)`` truncates; grp +=
    chain in chain order, acc += grp a stage; accumulator registers to
    tile cells; units added in slot order.  ``lbo`` / ``sbo``: the
    descriptor's strides; ``order="residue"``: K4b's one pass."""
    plan = plan or C.unit_plan(a.shape, b.shape, out, cut_j1=False)
    ka, kb = (b, a) if plan.swap else (a, b)
    ka = tf32_rn(np.asarray(ka, dtype=np.float32))
    kb = tf32_rn(np.asarray(kb, dtype=np.float32))
    a0, a1 = ka.shape
    pitch = -(-a1 // 4) * 4
    apad = np.zeros((a0, pitch), dtype=np.float32)
    apad[:, :a1] = ka
    c = np.zeros(out, dtype=np.float32)
    work = np.zeros((max(plan.slots, 1), TILE, TILE), dtype=np.float32)
    wanted = {}
    for K0, K1, lo0, hi0, lo1, hi1, slot, _ in plan.units.tolist():
        i1_lo = max(0, K1 - hi1 + 1) // 4 * 4
        i1_hi = min(a1, K1 + TILE - lo1)
        w_lo, w_hi = max(lo0, K0 - a0 + 1), min(hi0, K0 + TILE)
        acc = np.zeros(TILE * TILE, dtype=np.float32)
        for g0 in range(lo0, hi0, G):
            for i1_0 in range(i1_lo, i1_hi, KB):
                dj_lo, dj_hi = max(0, w_lo - g0), min(G, w_hi - g0)
                ks_hi = min(SLICES, -(-(i1_hi - i1_0) // 8))
                if dj_lo >= dj_hi:
                    continue
                smem = wgmma_stage(kb, apad, a0, a1, K0, K1, g0, i1_0, hi0,
                                   lo1, hi1)
                desc0 = window_desc(0, lbo, sbo) + (G - 1)
                dj = np.arange(G)
                brow = WG_W_BYTES // 4 + dj * WG_B_PITCH
                # [dj, ks, n, k] and [dj, ks, k, m]; rows outside the
                # stage's live j0 are never read
                A = smem[brow[:, None, None, None]
                         + WG_A_WORDS[None, :ks_hi]].astype(np.float64)
                B = smem[desc_words(desc0 - dj[:, None] + 2 * WG_CHUNK_ROWS
                                    * np.arange(ks_hi)[None, :])
                         ].astype(np.float64)
                live = np.s_[dj_lo:dj_hi]
                parts = np.full((G, ks_hi, TILE, TILE), np.nan)
                parts[live] = np.matmul(A[live], B[live])
                grp = np.zeros((TILE, TILE), dtype=np.float32)
                for steps in stage_schedule(order, dj_lo, dj_hi, ks_hi,
                                            chain):
                    d = np.zeros((TILE, TILE), np.float32)  # scale-d 0
                    for step in steps:
                        d = chain_step(d, parts[step])
                    grp += d
                # registers to cells: cell (m, n) holds D[n, m]
                acc += grp[WG_D_INDEX[:, 0], WG_D_INDEX[:, 1]][
                    np.argsort(WG_C_CELLS[:, 0] * TILE + WG_C_CELLS[:, 1])]
        acc = acc.reshape(TILE, TILE)
        if slot < 0:
            wanted[(K0, K1)] = acc
        else:
            work[slot] = acc
    for K0, K1, first, n in plan.sums.tolist():
        total = np.zeros((TILE, TILE), dtype=np.float32)
        for z in range(first, first + n):
            total += work[z]
        wanted[(K0, K1)] = total
    for (K0, K1), tile in wanted.items():
        r, q = min(TILE, out[0] - K0), min(TILE, out[1] - K1)
        c[K0:K0 + r, K1:K1 + q] = tile[:r, :q]
    return c


def one_pass_bound(a, b, out):
    """The one-pass mode's bar against f64, elementwise: 2^-10 (two TF32
    roundings, 2u + u^2 with u = 2^-11) of the truncated product of the
    absolute values, plus the three-pass bar for the f32 sums."""
    absprod = NumpyF64Backend().conv_trunc(np.abs(a), np.abs(b), out)
    return (2.0 ** -10 + RTOL) * absprod + ATOL


def _rowstrip_operands(i):
    rng = np.random.RandomState(13)
    for sa, sb, _ in ROWSTRIP_SHAPES[: i + 1]:
        a, b = rng.rand(*sa), rng.rand(*sb)
    return a, b


def _extreme_operands(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.random((130, 140)), rng.random((120, 100))
    return (a * 10.0 ** np.linspace(-30, 30, 140),
            b * 10.0 ** np.linspace(-6, 6, 100))


@pytest.mark.parametrize("order,i", [
    ("ascending", 0), ("ascending", 1), ("ascending", 2),
    ("residue", 0), ("residue", 1),
])
def test_split_arithmetic_holds_the_gate(order, i):
    sa, sb, out = ROWSTRIP_SHAPES[i]
    a, b = _rowstrip_operands(i)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    got = emulate(a, b, out, order)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # well inside it: the kernels are held to 2e-6 on the card
    assert (np.abs(got - want) <= 2e-6 * np.abs(want) + ATOL).all()


@pytest.mark.parametrize("order,i", [
    ("ascending", 0), ("ascending", 1), ("residue", 0), ("residue", 1),
])
def test_one_pass_arithmetic_holds_its_bound(order, i):
    """The one-pass mode's design at the one-pass bound: shape 0 has a b
    of 6 columns (the FFMA body on rounded operands), shape 1 runs the
    wgmma body in the tile kernel's order (ascending) or K4b's (residue).
    Each differs from the three-pass result in its order somewhere, and
    the FFMA body without the rounding would be a three-pass-like f32
    product that differs from the rounded one by more than f32's sums
    can."""
    sa, sb, out = ROWSTRIP_SHAPES[i]
    a, b = _rowstrip_operands(i)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    if C.tile_body(sa, sb) == "ffma":
        got = emulate_ffma(a, b, out)
        unrounded = emulate_ffma(a, b, out, passes=3)
        assert (np.abs(unrounded - want) <= 2e-6 * np.abs(want) + ATOL).all()
        # the rounding moves the result far beyond f32's sums
        assert (np.abs(got - unrounded) > 1e-4 * np.abs(want)).any()
    else:
        # every one pass is the wgmma body, K4b's in residue-major order
        got = emulate_wgmma(a, b, out, order=order)
        three = emulate(a, b, out, order)
        assert (np.abs(got - three) > 1e-5 * np.abs(three)).any()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (np.abs(got - want) <= one_pass_bound(a, b, out)).all()
    # the plain one-pass version (f32 sums of the rounded operands'
    # products) differs from the design by f32's sums only
    plain = C.conv2d_trunc_f32_reference(
        torch.from_numpy(a).float(), torch.from_numpy(b).float(), out,
        highest=False).numpy()
    assert (np.abs(got - plain) <= 2e-6 * np.abs(plain) + ATOL).all()


# ragged shapes of the wgmma body: a1 % 4 != 0 (a's pad columns), b of
# 8, 9 and 64 columns, orders 70 and 130
WGMMA_SHAPES = [
    ((70, 67), (64, 8), (70, 70)),
    ((70, 81), (70, 9), (70, 70)),
    ((130, 133), (120, 9), (130, 130)),
    ((130, 130), (130, 64), (130, 130)),
]


def _plain_one_pass(a, b, out):
    return C.conv2d_trunc_f32_reference(
        torch.from_numpy(a).float(), torch.from_numpy(b).float(), out,
        highest=False).numpy()


def _holds_the_one_pass_bound(sa, sb, out, order):
    rng = np.random.default_rng(sum(sa) + sb[1])
    a, b = rng.random(sa), rng.random(sb)
    assert C.tile_body(sa, sb) == "mma"
    got = emulate_wgmma(a, b, out, order=order)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    want = NumpyF64Backend().conv_trunc(a, b, out)
    assert (np.abs(got - want) <= one_pass_bound(a, b, out)).all()
    plain = _plain_one_pass(a, b, out)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    assert (np.abs(got - plain) <= 2e-6 * np.abs(plain) + ATOL).all()


@pytest.mark.parametrize("sa,sb,out", WGMMA_SHAPES)
def test_wgmma_arithmetic_holds_the_one_pass_bound(sa, sb, out):
    """The wgmma body against f64 at the one-pass bound, and against its
    plain version (f32 sums of the rounded operands' exact products) at
    phase 3's bar and well inside it: the two differ by f32 sums only."""
    _holds_the_one_pass_bound(sa, sb, out, "ascending")


@pytest.mark.parametrize("sa,sb,out", WGMMA_SHAPES)
def test_residue_wgmma_arithmetic_holds_the_one_pass_bound(sa, sb, out):
    """The same for K4b's one pass: residue order, a chain per class over
    both its j0 of a stage, 128 terms in the tensor core's truncating
    accumulator."""
    _holds_the_one_pass_bound(sa, sb, out, "residue")


def _holds_every_column_scale(order):
    a, b = _extreme_operands(13)
    out = (130, 140)
    got = emulate_wgmma(a, b, out, order=order).astype(np.float64)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    absprod = NumpyF64Backend().conv_trunc(np.abs(a), np.abs(b), out)
    assert np.isfinite(got).all()
    assert (np.abs(got - want)
            <= (2.0 ** -10 + RTOL) * absprod + ATOL_EXTREME).all()


def test_wgmma_arithmetic_holds_every_column_scale():
    """Column scales from 1e-30 to 1e30 (a) and 1e-6 to 1e6 (b): every
    output column holds the one-pass bound at its own scale."""
    _holds_every_column_scale("ascending")


def test_residue_wgmma_arithmetic_holds_every_column_scale():
    """The same for K4b's one pass (residue order)."""
    _holds_every_column_scale("residue")


@pytest.mark.parametrize("case", [*range(len(WGMMA_SHAPES)), "extreme"])
def test_residue_chains_equal_the_ascending_ones_to_f32_rounding(case):
    """K4b's one pass (residue order, one chain per class of a stage over
    both its j0: 2 x 8 k-steps) against the tile kernel's (a chain per
    j0): the same exact products summed in other groups, so equal to f32
    rounding (2e-6 relative; at the extreme scales the atol covers the
    partial sums the tensor core flushes below f32's normal range), not
    bit for bit; both hold the one-pass bound of f64 with a margin of a
    quarter."""
    if case == "extreme":
        (a, b), out, atol = _extreme_operands(13), (130, 140), ATOL_EXTREME
    else:
        sa, sb, out = WGMMA_SHAPES[case]
        rng = np.random.default_rng(sum(sa) + sb[1])
        a, b, atol = rng.random(sa), rng.random(sb), ATOL
    res = emulate_wgmma(a, b, out, order="residue").astype(np.float64)
    asc = emulate_wgmma(a, b, out).astype(np.float64)
    assert (np.abs(res - asc) <= 2e-6 * np.abs(asc) + atol).all()
    assert not np.array_equal(res, asc)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    absprod = NumpyF64Backend().conv_trunc(np.abs(a), np.abs(b), out)
    bar = (2.0 ** -10 + RTOL) * absprod + atol
    for got in (res, asc):
        assert (np.abs(got - want) <= 0.75 * bar).all()


@pytest.mark.parametrize("dj_lo,dj_hi,ks_hi", [
    (0, G, SLICES), (0, G, 3), (3, G, SLICES), (0, 11, 5), (5, 9, 1),
])
def test_stage_schedule_visits_each_live_j0_once(dj_lo, dj_hi, ks_hi):
    """``stage_chains``' schedule: both orders issue every (live j0,
    k-step) once; residue-major runs the classes in order, a class's j0
    r before r + 8, one chain per class (8 waits a full stage against
    ascending's 16), or with ``chain`` = 4 the fallback's two chains of
    a class."""
    wanted = sorted((dj, ks) for dj in range(dj_lo, dj_hi)
                    for ks in range(ks_hi))
    asc = stage_schedule("ascending", dj_lo, dj_hi, ks_hi)
    for chain in (SLICES, SLICES // 2):
        res = stage_schedule("residue", dj_lo, dj_hi, ks_hi, chain)
        assert sorted(step for c in res for step in c) == wanted
        classes = [c[0][0] % 8 for c in res]
        assert classes == sorted(classes)
        for c in res:
            assert len({dj % 8 for dj, _ in c}) == 1
            assert [dj for dj, _ in c] == sorted(dj for dj, _ in c)
    assert sorted(step for c in asc for step in c) == wanted
    assert [c[0][0] for c in asc] == list(range(dj_lo, dj_hi))
    full = stage_schedule("residue", 0, G, SLICES)
    assert len(full) == 8 and len(stage_schedule("ascending", 0, G,
                                                 SLICES)) == 16
    assert all(len(c) == 2 * SLICES for c in full)


@pytest.mark.parametrize("sa,sb,out", WGMMA_SHAPES[1:3])
def test_swapped_descriptor_strides_fail_the_gate(sa, sb, out):
    """LBO and SBO swapped (the 8-row stride taken for the k stride and
    back): the descriptor names other words, stale ones among them, and
    the emulation leaves phase 3's bar."""
    rng = np.random.default_rng(sum(sa) + sb[1])
    a, b = rng.random(sa), rng.random(sb)
    plain = _plain_one_pass(a, b, out)
    bad = emulate_wgmma(a, b, out, lbo=WG_SBO, sbo=WG_CHUNK_BYTES)
    off = ~(np.abs(bad - plain) <= RTOL * np.abs(plain) + ATOL)
    assert off.mean() > 0.5


@pytest.mark.parametrize("dj,ks", [(0, 0), (15, 7), (5, 3), (9, 1), (1, 6)])
def test_wgmma_operands_name_the_window_and_the_toeplitz_tile(dj, ks):
    """One stage staged as the kernel stages it (integer operands: exact),
    the A registers read at the kernel's words and B at the descriptor's:
    the k-step's product is C^T[n, m] = sum over its 8 columns i1 of
    a[K0 + m - j0, i1] * b[j0, K1 + n - i1], and the accumulator
    registers put it at tile cell (m, n)."""
    rng = np.random.default_rng(10 * dj + ks)
    K0, K1, g0, i1_0 = 128, 192, 40, 96
    a = rng.integers(-4, 5, (400, 400)).astype(np.float32)
    b = rng.integers(-4, 5, (200, 400)).astype(np.float32)
    smem = wgmma_stage(b, a, 400, 400, K0, K1, g0, i1_0, 200, 0, 400)
    brow = WG_W_BYTES // 4 + dj * WG_B_PITCH
    A = smem[brow + WG_A_WORDS[ks]].astype(np.float64)
    desc = window_desc(0) + (G - 1) - dj + 2 * ks * WG_CHUNK_ROWS
    B = smem[desc_words(desc)].astype(np.float64)
    D = A @ B
    tile = np.full((TILE, TILE), np.nan)
    tile[WG_C_CELLS[:, 0], WG_C_CELLS[:, 1]] = D[WG_D_INDEX[:, 0],
                                                 WG_D_INDEX[:, 1]]
    j0 = g0 + dj
    m = np.arange(TILE)[:, None]
    n = np.arange(TILE)[None, :]
    want = sum(a[K0 + m - j0, i1] * b[j0, K1 + n - i1]
               for i1 in range(i1_0 + 8 * ks, i1_0 + 8 * ks + 8))
    assert np.array_equal(tile, want)


def test_window_core_matrices_step_16_bytes_a_j0():
    """The window's layout: rows r .. r + 7 of a chunk are one 128-byte
    core matrix for any r, so the descriptor of j0 = g0 + dj is k-step
    0's start minus dj 16-byte units, and names window row m + G - 1 - dj
    for B column m: no copy per j0.  Chunks lie 16 bytes off a multiple of
    128, so the copies of one window row's 8 chunks of a quarter warp land
    on 8 distinct 16-byte bank groups."""
    assert WG_CHUNK_BYTES % 128 == 16
    groups = {(ch * WG_CHUNK_BYTES + 16 * 5) // 16 % 8 for ch in range(8)}
    assert groups == set(range(8))
    for dj in range(G):
        words = desc_words(window_desc(0) + (G - 1) - dj)
        m = np.arange(TILE)
        for k in range(8):
            row = m + G - 1 - dj
            assert np.array_equal(words[k], (k // 4 * WG_CHUNK_BYTES
                                             + 16 * row) // 4 + k % 4)


@pytest.mark.parametrize("order", ["ascending", "residue"])
def test_split_arithmetic_holds_every_column_scale(order):
    """Column scales from 1e-30 to 1e30 (a) and 1e-6 to 1e6 (b): every
    output column is held to the rtol at its own scale."""
    a, b = _extreme_operands(13)
    out = (130, 140)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    got = emulate(a, b, out, order).astype(np.float64)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= RTOL * np.abs(want) + ATOL_EXTREME).all()


def test_unscaled_low_part_loses_the_small_columns():
    """lo = tf32(x - hi) without the 2^11 scale: where a's columns are
    1e-30, lo's products with b's 1e-6 columns are subnormal, a chain
    that flushes them drops the whole cross term (2^-11 relative), and
    the smallest columns leave the bar."""
    a, b = _extreme_operands(13)
    out = (130, 140)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    got = emulate(a, b, out, scale=1.0, tiles={(0, 0)}).astype(np.float64)
    rel = np.abs(got - want)[:64, :64] / np.abs(want)[:64, :64]
    assert rel[:, :8].max() > RTOL  # the columns near 1e-36
    assert rel[:, 48:].max() < 2e-6  # larger columns: lo's products normal
    scaled = emulate(a, b, out, tiles={(0, 0)}).astype(np.float64)
    assert (np.abs(scaled - want)[:64, :64]
            <= 2e-6 * np.abs(want)[:64, :64] + ATOL_EXTREME).all()


def test_one_long_chain_drifts_out_of_the_gate(monkeypatch):
    """One chain over a whole tile (every j0, every k-slice) in the tensor
    core's own accumulator: truncation is a bias on positive operands, it
    grows with the chain, and the result leaves the bar that the same
    tile holds with chains of eight."""
    monkeypatch.setattr(C, "UNIT_TARGET", 1)  # one unit a tile
    C.unit_plan.cache_clear()
    sa = sb = out = (256, 256)
    try:
        plan = C.unit_plan(sa, sb, out, cut_j1=False)
    finally:
        C.unit_plan.cache_clear()
    assert plan.slots == 0
    rng = np.random.default_rng(5)
    a, b = rng.random(sa), rng.random(sb)
    want = NumpyF64Backend().conv_trunc(a, b, out)
    tile = (192, 192)  # 256 j0 x 32 k-slices in one chain
    sl = np.s_[tile[0]:tile[0] + TILE, tile[1]:tile[1] + TILE]
    long = emulate(a, b, out, long_chain=True, plan=plan, tiles={tile})
    short = emulate(a, b, out, plan=plan, tiles={tile})
    bar = ATOL + RTOL * np.abs(want[sl])
    assert (np.abs(long[sl] - want[sl]) > bar).any()
    assert (long[sl] < want[sl]).all()  # a bias, not noise
    assert (np.abs(short[sl] - want[sl]) <= 2e-6 * np.abs(want[sl])
            + ATOL).all()


# ------------------------------------------------------- index algebra


def _mma_m16n8k8(a_frag, b_frag):
    """D = A B from per-lane fragments, by the PTX layout of
    mma.sync.m16n8k8 (.tf32): lane = 4 g + t; A regs (g, t), (g + 8, t),
    (g, t + 4), (g + 8, t + 4); B regs (k = t, n = g), (k = t + 4, n = g);
    D regs (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8, 2 t + 1)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[lane]
        B[t, g], B[t + 4, g] = b_frag[lane]
    D = A @ B
    return [[D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
             D[g + 8, 2 * t + 1]] for g, t in (divmod(lane, 4)
                                                for lane in range(32))]


@pytest.mark.parametrize("dj,warp", [
    (0, 0), (5, 1), (15, 2), (9, 3), (8, 0),
])
def test_fragment_offsets_name_the_window_and_the_toeplitz_tile(dj, warp):
    """A stage staged as the kernel stages it, fragments read at the
    kernel's offsets, and the 2 x 4 mma tiles of one warp over the eight
    k-slices: the warp's 32 x 32 block of (a window) x (Toeplitz tile of
    b row j0)."""
    rng = np.random.default_rng(dj)
    a_pitch, b_pitch = KB + 4, KB + TILE
    K0, K1, g0, i1_0 = 128, 192, 40, 96
    a = rng.integers(-4, 5, (400, 400)).astype(np.float64)
    b = rng.integers(-4, 5, (200, 400)).astype(np.float64)
    # window row r, word k: a[K0 - (g0 + G - 1) + r][i1_0 + k]
    sA = np.zeros((TILE + G - 1) * a_pitch)
    for r in range(TILE + G - 1):
        sA[r * a_pitch:r * a_pitch + KB] = a[K0 - (g0 + G - 1) + r,
                                             i1_0:i1_0 + KB]
    # b row dj, word x: b[g0 + dj][K1 - i1_0 - KB + 1 + x]
    sB = np.zeros(G * b_pitch)
    for d in range(G):
        for x in range(KB + TILE - 1):
            sB[d * b_pitch + x] = b[g0 + d, K1 - i1_0 - KB + 1 + x]
    mb, nb = (warp // 2) * 32, (warp % 2) * 32
    got = np.zeros((32, 32))
    for ks in range(SLICES):
        kk = 8 * ks
        for M in range(2):
            for N in range(4):
                a_frag, b_frag = [], []
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    wm = ((mb + g - dj + G - 1) * a_pitch + kk + t
                          + 16 * M * a_pitch)
                    a_frag.append((sA[wm], sA[wm + 8 * a_pitch], sA[wm + 4],
                                   sA[wm + 8 * a_pitch + 4]))
                    x = dj * b_pitch + nb + g - kk - t + KB - 1
                    b_frag.append((sB[x + 8 * N], sB[x + 8 * N - 4]))
                d = _mma_m16n8k8(a_frag, b_frag)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for i in range(4):
                        got[16 * M + g + 8 * (i // 2),
                            8 * N + 2 * t + (i & 1)] += d[lane][i]
    j0 = g0 + dj
    want = np.zeros((32, 32))
    for m in range(32):
        for n in range(32):
            want[m, n] = sum(
                a[K0 + mb + m - j0, i1] * b[j0, K1 + nb + n - i1]
                for i1 in range(i1_0, i1_0 + KB))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mb", [0, 32])
@pytest.mark.parametrize("r", range(8))
def test_residue_carry_names_the_rows_of_direct_loads(mb, r):
    """K4b steps j0 by 8 inside a class: the window moves down 8 rows, so
    A half h (rows mb + 8 h + g of the tile) becomes the old half h - 1
    and only half 0 is loaded.  Followed over a class's steps, the carried
    registers name the window rows that direct loads would."""
    halves = 4  # 2 MT halves of 8 rows
    for g in range(8):
        def row(h, dj):
            return mb + 8 * h + g - dj + G - 1

        regs = [row(h, r) for h in range(halves)]  # q = 0: all loaded
        for q in range(1, G // 8):
            dj = r + 8 * q
            regs = [row(0, dj)] + regs[:-1]  # shift down, load the top
            assert regs == [row(h, dj) for h in range(halves)]
            assert min(regs) >= 0 and max(regs) < TILE + G - 1
            # the m16n8k8 A fragment of mma tile M: rows g and g + 8
            for M in range(halves // 2):
                assert regs[2 * M + 1] - regs[2 * M] == 8


# -------------------------------------------------------------- bound


@pytest.mark.parametrize("order", [256, 384, 512, 768])
def test_bound_of_a_split_product_is_the_tensor_rate(order):
    """Three TF32 passes at the data-sheet TF32 rate; a kernel that ran
    at that rate would read a share of exactly 1 against this bound and
    an impossible one (> 1) against the FFMA bound."""
    shape = (order, order)
    ffma, by = bench.product_bound(shape, shape, shape)
    assert by == "operations"
    ms, by = bench.product_bound(shape, shape, shape,
                                 passes=bench.SPLIT_PASSES)
    assert by == "tensor operations"
    macs = ffma * 1e-3 * bench.F32_FMA_PER_S
    fastest = 3 * macs / bench.TF32_MMA_PER_S * 1e3
    assert ms == pytest.approx(fastest, rel=1e-12)
    assert ms / fastest <= 1 + 1e-12 < ffma / fastest
    if order == 512:
        assert ms == pytest.approx(0.209, rel=5e-3)


def test_bound_of_a_thin_split_product_is_still_its_bytes():
    ms, by = bench.product_bound((1, 87), (95, 87), (95, 87),
                                 passes=bench.SPLIT_PASSES)
    assert by == "bytes"
    assert ms == bench.product_bound((1, 87), (95, 87), (95, 87))[0]
