"""K5's kernels (``genfer_tpu_torch/csrc/ozaki_split.cu`` and
``ozaki_conv2d.cu``) emulated in numpy, lane by lane, on the CPU.

A CUDA kernel cannot run without a card, so this file holds the design the
kernels follow:

* the split's transposing tile: 64 rows of 8 columns a pass, a's rows
  reversed in it, written out in 16-byte pieces at the kernel's positions,
  which must give the chunk layout of ``ozaki_conv.py::_chunk_columns``;
* the dense body's stages as its ``cp.async`` pieces fill them (a's
  reversed window columns, b's window as planes of 16-byte pieces, a piece
  outside a, the unit's b columns or its j0 range zero-filled), double
  buffered in the kernel, in the order (g0, I) of its stage loop;
* the int8 ``wgmma`` m64n64k32: A from registers (the ``__byte_perm`` of
  two aligned words with the kernel's selector, in the ``mma.sync``
  m16n8k32 A layout for each warp's 16 rows) and B read through the
  no-swizzle K-major descriptor (core matrices of 8 columns x 16 bytes,
  SBO 128, LBO one plane, the start one window column on for each a
  column); the bf16 ``mma.sync`` m16n8k16 fragments (A from two words, B
  two words of two planes); each assembled into the matrices it
  multiplies, which must be the Toeplitz tile of ``ca_t`` and the shifted
  window of ``cb_u``;
* the Horner pairs over a 64-row stage (int32 bound held), the
  per-column weights 2^(ea + eb - 7(s+2)), the unit table of
  ``ozaki_conv.py::plan`` and the slot sum;
* the small body's sum order (b columns ascending, exact int32 sums, a
  flush a Horner pair).

On small integer operands every step is exact, so the emulation must equal
the product bit for bit; on uniform operands it is held to the plain
version at 1e-14 of each output column's max.  Change an offset here
first, then in the ``.cu``.  ``tune_port.py`` probe 14 checks the PTX
layouts and the descriptor on the card.
"""

import numpy as np
import pytest
import torch

from genfer_tpu_torch.ops import conv2d as C
from genfer_tpu_torch.ops import ozaki_conv as Z

TILE = C.TILE
PIECE = 16  # bytes a cp.async piece
SBO = 128  # K5_SBO in the .cu
SPLIT_COLS = 8  # columns a block of the split (ozaki_split.cu)
NO_COL = None

LANE = np.arange(32)
GID, TQ = LANE // 4, LANE % 4


class Impl:
    """The kernel's per-impl geometry (OzGeo / OzStage in the .cu)."""

    def __init__(self, name):
        self.name = name
        self.esz = 1 if name == "int8" else 2
        self.G = Z.STAGE_ROWS
        self.IB = 16 if name == "int8" else 4
        self.pr = PIECE // self.esz  # rows a piece
        self.planes = self.G // self.pr
        self.xw = TILE + self.IB - 1
        self.a_len = TILE + self.G
        self.a_bytes = self.a_len * self.esz
        self.plane = self.xw * PIECE  # the descriptor's LBO
        self.b_chunk = self.planes * self.plane
        self.horner = name == "int8"

    def selector(self, gid):
        if self.name == "int8":
            return 0x3210 + 0x1111 * ((3 - gid) & 3)
        return np.where(gid & 1, 0x3210, 0x5432)


def _to_bytes(values, impl):
    """Little-endian bytes of integer chunk values as the kernel stores
    them (int8, or the bits of bf16), one row of bytes for each row of
    values."""
    v = np.asarray(values)
    if impl.name == "int8":
        return v.astype(np.int8).view(np.uint8)
    bits = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return bits.view(torch.int16).numpy().view(np.uint8).reshape(
        v.shape[:-1] + (-1,))


def _from_bytes(raw, impl):
    """Entries of ``raw`` (..., 4) as an mma reads a register."""
    if impl.name == "int8":
        return raw.astype(np.uint8).view(np.int8).astype(np.int64)
    raw = np.ascontiguousarray(raw.astype(np.uint8))
    bits = raw.reshape(raw.shape[:-1] + (2, 2)).view(np.int16)[..., 0]
    vals = torch.from_numpy(np.ascontiguousarray(bits)).view(
        torch.bfloat16).float().numpy()
    return vals.astype(np.int64)


def _window_word(column, y, sel):
    """``__byte_perm(w[y >> 2], w[(y >> 2) + 1], sel)`` over a staged
    column of bytes: byte j of the result is byte (sel >> 4 j) & 7 of the 8
    bytes from word y >> 2."""
    nib = np.stack([(sel >> (4 * j)) & 7 for j in range(4)], axis=-1)
    addr = 4 * (y >> 2)[..., None] + nib
    return column[..., addr]


def pow2(e):
    if e > 1023:
        return np.inf
    return float(np.ldexp(1.0, e)) if e >= -1074 else 0.0


def to_f64_exact(c, impl):
    """The kernel's exact conversion of an int32 sum, or of an f32 sum of
    the bf16 impl through an int32 (``exact_int``: |x| < 2^22)."""
    bound = 2 ** 31 if impl.horner else 2 ** 22
    assert np.abs(c).max(initial=0) < bound
    return c.astype(np.float64)


# ----------------------------------------------------------------- split

def emulate_split(x, pair_bits, impl_name, reverse):
    """The split kernel's layout of one operand [rows, cols] (one product):
    the chunks of the plain split, passed through the kernel's transposing
    tile (64 rows x SPLIT_COLS columns, a's reversed: row rr at tile
    position 63 - rr) and written out in 16-byte pieces at the kernel's positions into
    [n_t, cols, padded rows] bytes, unwritten bytes marked 0xEE."""
    impl = Impl(impl_name)
    rows, cols = x.shape
    chunks, _, _ = Z.ozaki_split_reference(torch.from_numpy(x), pair_bits,
                                           impl_name)
    vals = chunks.double().numpy().astype(np.int64)  # [n_t, rows, cols]
    n_t = vals.shape[0]
    P = Z.padded_rows(rows)
    out = np.full((n_t, cols, P * impl.esz), 0xEE, np.uint8)
    for blk in range(-(-cols // SPLIT_COLS)):
        for r0 in range(0, P, 64):
            tile = np.zeros((n_t, SPLIT_COLS, 64), np.int64)
            for rr in range(64):
                r, at = r0 + rr, (63 - rr if reverse else rr)
                for col in range(SPLIT_COLS):
                    c = blk * SPLIT_COLS + col
                    if c < cols and r < rows:
                        tile[:, col, at] = vals[:, r, c]
            raw = _to_bytes(tile, impl)  # [n_t, SPLIT_COLS, 64 esz]
            n_rows = min(64, P - r0)
            pieces = 64 // impl.pr
            first = (64 - n_rows) // impl.pr if reverse else 0
            last = pieces if reverse else n_rows // impl.pr
            for q in range(first, last):
                pos = (P - r0 - 64 if reverse else r0) + q * impl.pr
                for col in range(SPLIT_COLS):
                    c = blk * SPLIT_COLS + col
                    if c < cols:
                        out[:, c, pos * impl.esz:(pos + impl.pr) * impl.esz] \
                            = raw[:, col, PIECE * q:PIECE * (q + 1)]
    return out


@pytest.mark.parametrize("impl", ["int8", "bf16"])
@pytest.mark.parametrize("shape", [(5, 3), (70, 33), (16, 40), (130, 2)])
def test_split_pieces_give_the_layout(shape, impl):
    """Every byte of the layout is written once by the kernel's pieces and
    equals the plain version's layout (``_chunk_columns``), a's reversed
    and b's ascending, the padding zero."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-30, 30, shape[1])
    for reverse in (True, False):
        got = emulate_split(x, 7, impl, reverse)
        assert not (got == 0xEE).all(axis=-1).any()
        chunks, _, _ = Z.ozaki_split_reference(torch.from_numpy(x), 7, impl)
        want = Z._chunk_columns(chunks, shape[0], reverse)
        view = torch.int8 if impl == "int8" else torch.int16
        want_bytes = want.contiguous().view(view).numpy().view(np.uint8)
        assert np.array_equal(got, want_bytes.reshape(got.shape))


# ---------------------------------------------------------- dense body

def _stage(ca, cb, impl, Pa, Pb, a1, K0, K1, g0, j0_hi, I, n_i, j1_lo,
           j1_hi):
    """The stage's bytes as the kernel's cp.async pieces fill them: sA
    [n_t, IB, a_bytes] (a's window column: entry y is position pos0 + y of
    the reversed column), sB [n_t, planes, xw, 16] (piece kc of window
    column x: b's rows g0 + 16 kc .. of column col0 + x), zero-filled where
    a piece lies outside a, the unit's b columns or its j0 range."""
    n_t = ca.shape[0]
    pos0 = Pa - TILE - K0 + g0
    col0 = K1 - (I + impl.IB - 1)
    sA = np.zeros((n_t, impl.IB, impl.a_bytes), np.uint8)
    for i in range(n_i):
        for q in range(impl.a_bytes // PIECE):
            p = pos0 + q * impl.pr
            assert p % impl.pr == 0
            if 0 <= p < Pa:
                sA[:, i, PIECE * q:PIECE * (q + 1)] = ca[
                    :, I + i, p * impl.esz:(p + impl.pr) * impl.esz]
    sB = np.zeros((n_t, impl.planes, impl.xw, PIECE), np.uint8)
    for x in range(impl.xw):
        ll = col0 + x
        if not j1_lo <= ll < j1_hi:
            continue
        for kc in range(impl.planes):
            r = g0 + kc * impl.pr
            if r < j0_hi:
                assert r + impl.pr <= Pb
                sB[:, kc, x] = cb[:, ll, r * impl.esz:(r + impl.pr)
                                  * impl.esz]
    return sA, sB.reshape(n_t, -1), col0


def _fragments_s8(sA, sB, impl, i):
    """A (n_t, 64, G) and B (n_t, G, 64) of stage column i as the int8
    body's wgmma reads them: A from each warp's registers, B through the
    descriptor, every position written once."""
    n_t = sA.shape[0]
    A = np.full((n_t, TILE, impl.G), -(1 << 40), np.int64)
    sel = impl.selector(GID)
    col = sA[:, i]
    for w in range(4):
        y0 = 63 - (16 * w + GID) + 4 * TQ
        for ks in range(impl.G // 32):
            for r, off in enumerate((0, -8, 16, 8)):
                vals = _from_bytes(_window_word(col, y0 + off + 32 * ks, sel),
                                   impl)  # (n_t, 32, 4)
                for j in range(4):
                    row = 16 * w + GID + 8 * (r % 2)
                    k = 32 * ks + 4 * TQ + j + 16 * (r // 2)
                    assert (A[:, row, k] == -(1 << 40)).all()
                    A[:, row, k] = vals[:, :, j]
    B = np.full((n_t, impl.G, TILE), -(1 << 40), np.int64)
    flat = sB.reshape(-1)  # every chunk's planes, as in shared memory
    start0 = PIECE * (impl.IB - 1 - i)
    k, n = np.arange(32)[:, None], np.arange(TILE)[None, :]
    for u in range(n_t):
        for ks in range(impl.G // 32):
            start = start0 + u * impl.b_chunk + 2 * ks * impl.plane
            addr = (start + (n // 8) * SBO + (n % 8) * PIECE
                    + (k // 16) * impl.plane + k % 16)
            B[u, 32 * ks:32 * ks + 32] = flat[addr].view(np.int8)
    assert (A > -(1 << 40)).all()
    return A, B


def _fragments_bf16(sA, sB, impl, i):
    """The same for the bf16 body's mma.sync m16n8k16 (warp w: rows 16 w ..
    16 w + 15, eight 16x8 tiles across the 64 columns)."""
    n_t = sA.shape[0]
    A = np.full((n_t, TILE, impl.G), -(1 << 40), np.int64)
    B = np.full((n_t, impl.G, TILE), -(1 << 40), np.int64)
    sel = impl.selector(GID)
    col = sA[:, i]
    for w in range(4):
        y0 = 2 * (63 - (16 * w + GID) + 2 * TQ)
        for ks in range(impl.G // 16):
            for r, off in enumerate((0, -16, 16, 0)):
                vals = _from_bytes(_window_word(col, y0 + off + 32 * ks, sel),
                                   impl)  # (n_t, 32, 2)
                for j in range(2):
                    row = 16 * w + GID + 8 * (r % 2)
                    k = 16 * ks + 2 * TQ + j + 8 * (r // 2)
                    A[:, row, k] = vals[:, :, j]
    flat = sB.reshape(n_t, -1)
    for jt in range(8):
        n = 8 * jt + GID
        x = n + impl.IB - 1 - i
        for ks in range(impl.G // 16):
            for r in range(2):
                addr = (PIECE * x + 4 * TQ + (2 * ks + r) * impl.plane)
                raw = flat[:, addr[:, None] + np.arange(4)]
                vals = _from_bytes(raw, impl)
                for j in range(2):
                    B[:, 16 * ks + 2 * TQ + j + 8 * r, n] = vals[:, :, j]
    assert (A > -(1 << 40)).all() and (B > -(1 << 40)).all()
    return A, B


def _unit(ca, cb, ea, eb, impl, shapes, n_t, n_s, unit, check):
    """One work unit of the dense body: its 64 x 64 f64 tile."""
    (a0, a1, Pa), (b0, b1, Pb), a_vals, b_vals = shapes
    K0, K1, j0_lo, j0_hi, j1_lo, j1_hi = (int(v) for v in unit[:6])
    assert j0_lo % Z.PIECE_ROWS == 0
    i1_lo = max(0, K1 - j1_hi + 1)
    i1_hi = min(a1, K1 + TILE - j1_lo)
    acc = np.zeros((TILE, TILE))
    for g0 in range(j0_lo, j0_hi, impl.G):
        for I in range(i1_lo, i1_hi, impl.IB):
            n_i = min(impl.IB, i1_hi - I)
            sA, sB, col0 = _stage(ca, cb, impl, Pa, Pb, a1, K0, K1, g0,
                                  j0_hi, I, n_i, j1_lo, j1_hi)
            for i in range(n_i):
                i1 = I + i
                frag = _fragments_s8 if impl.horner else _fragments_bf16
                A, B = frag(sA, sB, impl, i)
                if check:
                    m, k = np.arange(TILE)[:, None], np.arange(impl.G)[None]
                    r = K0 + m - (g0 + k)
                    ok = (r >= 0) & (r < a0)
                    want_a = np.where(ok, a_vals[:, np.clip(r, 0, a0 - 1),
                                                 i1], 0)
                    assert np.array_equal(A, want_a), (unit, g0, i1)
                    n = np.arange(TILE)[None, :]
                    ll = K1 + n - i1
                    rows = g0 + k.T
                    okb = ((ll >= j1_lo) & (ll < j1_hi) & (rows < j0_hi)
                           & (rows < b0))
                    want_b = np.where(
                        okb, b_vals[:, np.clip(rows, 0, b0 - 1),
                                    np.clip(ll, 0, b1 - 1)], 0)
                    assert np.array_equal(B, want_b), (unit, g0, i1)
                ex = []
                for n in range(TILE):
                    ll = K1 + n - i1
                    ex.append(int(ea[i1]) + int(eb[ll])
                              if j1_lo <= ll < j1_hi else NO_COL)
                pair = np.einsum("tmk,ukn->tumn", A.astype(np.float64),
                                 B.astype(np.float64))
                c = None
                for s in range(n_s):
                    fresh = not impl.horner or s % 2 == 0
                    flush = not impl.horner or s % 2 == 1 or s == n_s - 1
                    c = np.zeros((TILE, TILE)) if fresh else c * 128
                    for t in range(max(0, s - 7), min(s, n_t - 1) + 1):
                        c = c + pair[t, s - t]
                    if flush:
                        # a window column outside the unit's b sums to 0
                        # (its B column is zero-filled), so the kernel's
                        # finite weight of NO_COL_EX adds 0 as this 0 does
                        nocol = np.array([e is NO_COL for e in ex])
                        assert not c[:, nocol].any()
                        w = np.array([0.0 if e is NO_COL
                                      else pow2(e - 7 * (s + 2)) for e in ex])
                        acc = acc + to_f64_exact(c, impl) * w[None, :]
    return acc


def _split(a, b, pair_bits, impl_name):
    """The split kernel's outputs for one pair (its plain version), as
    bytes [n_t, cols, padded rows x esz], and the chunk values."""
    ca, cb, ea, eb, _ = Z.ozaki_split_batched_reference(
        torch.from_numpy(a)[None], torch.from_numpy(b)[None], pair_bits,
        impl_name)
    view = torch.int8 if impl_name == "int8" else torch.int16

    def raw(c):
        return c[0].contiguous().view(view).numpy().view(np.uint8).reshape(
            c.shape[1], c.shape[2], -1)

    a_vals = Z.chunk_view(ca[0], a.shape[0], True).double().numpy().astype(
        np.int64)
    b_vals = Z.chunk_view(cb[0], b.shape[0], False).double().numpy().astype(
        np.int64)
    return raw(ca), raw(cb), ea[0].numpy(), eb[0].numpy(), a_vals, b_vals


def emulate(a, b, out_shape, pair_bits, impl_name, check=True):
    """K5's dense body as the kernel computes it: the split (its plain
    version, which the card's split equals bit for bit), the unit plan,
    every unit, the slot sum in slot order."""
    impl = Impl(impl_name)
    c0, c1 = out_shape
    plan = Z.plan(a.shape, b.shape, out_shape)
    if plan.swap:
        a, b = b, a
    ca, cb, ea, eb, a_vals, b_vals = _split(a, b, pair_bits, impl_name)
    n_t = ca.shape[0]
    n_s = min(15, pair_bits + 1)
    shapes = ((a.shape[0], a.shape[1], Z.padded_rows(a.shape[0])),
              (b.shape[0], b.shape[1], Z.padded_rows(b.shape[0])),
              a_vals, b_vals)
    out = np.zeros((c0, c1))
    work = np.zeros((max(plan.slots, 1), TILE, TILE))
    for unit in plan.units:
        tile = _unit(ca, cb, ea, eb, impl, shapes, n_t, n_s, unit, check)
        K0, K1, slot = int(unit[0]), int(unit[1]), int(unit[6])
        if slot >= 0:
            work[slot] = tile
        else:
            h, w = min(TILE, c0 - K0), min(TILE, c1 - K1)
            out[K0:K0 + h, K1:K1 + w] = tile[:h, :w]
    for K0, K1, first, count in plan.sums:
        total = np.zeros((TILE, TILE))
        for z in range(first, first + count):
            total = total + work[z]
        h, w = min(TILE, c0 - K0), min(TILE, c1 - K1)
        out[K0:K0 + h, K1:K1 + w] = total[:h, :w]
    return out


# ---------------------------------------------------------- small body

def emulate_small(a, b, out_shape, pair_bits, impl_name):
    """K5's small body: for each output, b's columns j1 ascending (a's
    column k1 - j1), the exact int32 sums S_s over j0 and t + u = s, a
    flush a Horner pair (fma: exact here, as each term is rounded once in
    both), the smaller operand as b."""
    impl = Impl(impl_name)
    if C._swap(a.shape, b.shape):
        a, b = b, a
    (a0, a1), (b0, b1) = a.shape, b.shape
    assert b0 * b1 <= Z.SMALL_MAX_COEFFS
    _, _, ea, eb, av, bv = _split(a, b, pair_bits, impl_name)
    n_t, n_s = av.shape[0], min(15, pair_bits + 1)
    c0, c1 = out_shape
    k0 = np.arange(c0)[:, None]
    k1 = np.arange(c1)[None, :]
    acc = np.zeros((c0, c1))
    for j1 in range(b1):
        i1 = k1 - j1
        ok1 = (i1 >= 0) & (i1 < a1)
        S = np.zeros((15, c0, c1), np.int64)
        for j0 in range(b0):
            r = k0 - j0
            ok = ok1 & (r >= 0) & (r < a0)
            va = np.where(ok, av[:, np.clip(r, 0, a0 - 1),
                                 np.clip(i1, 0, a1 - 1)], 0)
            for t in range(n_t):
                for u in range(n_t):
                    if t + u < n_s:
                        S[t + u] += va[t] * bv[u, j0, j1]
        ex = np.where(ok1, ea[np.clip(i1, 0, a1 - 1)] + eb[j1], 0)
        for s in range(0, n_s, 2):
            h, sf = S[s], s
            if s + 1 < n_s:
                h, sf = h * 128 + S[s + 1], s + 1
            assert np.abs(h).max() < 2 ** 31
            w = np.vectorize(pow2)(ex - 7 * (sf + 2))
            acc = acc + np.where(ok1, h.astype(np.float64) * w, 0.0)
    return acc


def _exact(a, b, out_shape):
    """The product in exact integer arithmetic (small integer operands)."""
    c0, c1 = out_shape
    full = np.zeros((a.shape[0] + b.shape[0], a.shape[1] + b.shape[1]),
                    np.int64)
    for i0 in range(a.shape[0]):
        for i1 in range(a.shape[1]):
            full[i0:i0 + b.shape[0], i1:i1 + b.shape[1]] += (
                int(a[i0, i1]) * b.astype(np.int64))
    out = np.zeros(out_shape, np.int64)
    h, w = min(c0, full.shape[0]), min(c1, full.shape[1])
    out[:h, :w] = full[:h, :w]
    return out.astype(np.float64)


# ragged (a band of b columns cut by the truncation), thin, a j0 range not
# starting at row 0 (a short a: the plan aligns it down to 16), and one
# whose tiles are cut into several units (slots added in order)
SHAPES = [
    ((33, 17), (21, 45), (40, 40)),
    ((5, 70), (70, 9), (74, 74)),
    ((20, 300), (150, 30), (160, 40)),
    ((136, 10), (136, 10), (136, 10)),
]


@pytest.mark.parametrize("impl", ["int8", "bf16"])
@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulation_exact_on_integer_operands(shapes, impl):
    """Small integer operands: the split, every mma and every weighted add
    are exact, so the kernel's fragments must multiply exactly the
    Toeplitz and window tiles (checked at every stage column) and the
    result equal the integer product bit for bit, at pair_bits 7 (all
    chunks of such operands sit in the first two)."""
    sa, sb, out = shapes
    rng = np.random.default_rng(sum(sa) + sum(sb))
    a = rng.integers(0, 8, sa).astype(np.float64)
    b = rng.integers(0, 8, sb).astype(np.float64)
    got = emulate(a, b, out, 7, impl)
    want = _exact(a, b, out)
    assert np.array_equal(got, want)
    plain = Z.ozaki_conv2d_reference(torch.from_numpy(a), torch.from_numpy(b),
                                     out, 7, impl).numpy()
    assert np.array_equal(plain, want)


def test_plan_of_the_slot_shape_has_slots():
    """The last shape above runs tiles of several units (the slot sum),
    the third a unit whose j0 range starts past row 0."""
    plan = Z.plan(*SHAPES[-1])
    assert plan.slots > 0 and len(plan.sums) > 0
    lo = Z.plan(*SHAPES[2]).units[:, 2]
    assert lo.max() > 0 and not (lo % Z.PIECE_ROWS).any()


@pytest.mark.parametrize("impl,pair_bits", [("int8", 7), ("int8", 5),
                                            ("bf16", 7)])
def test_emulation_against_plain_on_uniform_operands(impl, pair_bits):
    """Uniform operands: the kernel's sum order (an f64 add a Horner pair
    of a stage column, slots in order) against the plain version's (one
    exact sum a diagonal, one undo, the anti-diagonal sum), at 1e-14 of
    each output column's max; the same chunk pairs are kept at every
    pair_bits, so P = 5 agrees as closely as P = 7."""
    sa, sb, out = (40, 36), (33, 47), (60, 58)
    rng = np.random.default_rng(5)
    a, b = rng.random(sa), rng.random(sb)
    got = emulate(a, b, out, pair_bits, impl, check=False)
    want = Z.ozaki_conv2d_reference(torch.from_numpy(a), torch.from_numpy(b),
                                    out, pair_bits, impl).numpy()
    col = np.abs(want).max(axis=0, keepdims=True)
    assert float((np.abs(got - want) / col).max()) < 1e-14


def test_selectors_pick_the_aligned_bytes():
    """The kernel's __byte_perm selectors start every A register at its
    first entry's byte within the aligned word: (3 - g) & 3 for int8
    (entry 63 - m + 4 t, m = 16 w + g), 2 ((63 - g) mod 2) for bf16."""
    for name in ("int8", "bf16"):
        impl = Impl(name)
        for w in range(4):
            m = 16 * w + GID
            byte = ((63 - m + 4 * TQ) if name == "int8"
                    else 2 * (63 - m + 2 * TQ))
            assert np.array_equal(impl.selector(GID) & 7, byte % 4), name


def test_horner_pair_over_a_stage_stays_in_int32():
    """The worst Horner pair of a 64-row stage: every chunk +-64, all 8
    pairs of both diagonals, every row: 2^7 (8 64^2 64) + 8 64^2 64 <
    2^31, and G could grow to 256 before it would not."""
    for g in (Z.STAGE_ROWS, 256):
        worst = 128 * (8 * 64 * 64 * g) + 8 * 64 * 64 * g
        assert worst < 2 ** 31, g
    assert 128 * (8 * 64 * 64 * 512) + 8 * 64 * 64 * 512 >= 2 ** 31


@pytest.mark.parametrize("impl", ["int8", "bf16"])
@pytest.mark.parametrize("shapes", [((70, 66), (2, 2), (70, 66)),
                                    ((3, 5), (40, 37), (41, 40)),
                                    ((27, 27), (2, 2), (27, 27)),
                                    ((30, 9), (64, 1), (80, 9))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_small_body_exact_and_against_plain(shapes, impl):
    """The small body on integer operands equals the integer product bit
    for bit, and on uniform operands the plain version at 1e-14 of each
    output column's max (the smaller operand as b, swapped where a is
    smaller)."""
    sa, sb, out = shapes
    assert Z.k5_body(sa, sb) == "small"
    rng = np.random.default_rng(sum(sa) + sum(sb))
    a = rng.integers(0, 8, sa).astype(np.float64)
    b = rng.integers(0, 8, sb).astype(np.float64)
    assert np.array_equal(emulate_small(a, b, out, 7, impl),
                          _exact(a, b, out))
    a, b = rng.random(sa), rng.random(sb)
    got = emulate_small(a, b, out, 7, impl)
    want = Z.ozaki_conv2d_reference(torch.from_numpy(a), torch.from_numpy(b),
                                    out, 7, impl).numpy()
    col = np.abs(want).max(axis=0, keepdims=True)
    assert float((np.abs(got - want) / col).max()) < 1e-14
