"""K5's tensor-core kernel (``genfer_tpu_torch/csrc/ozaki_conv2d.cu``)
emulated in numpy, lane by lane, on the CPU.

A CUDA kernel cannot run without a card, so this file holds the design the
kernel follows: each stage staged as the kernel stages it (a's chunk
columns reversed, b's window columns with their j0 rows in the kernel's
word order, in its byte pitches), the ``mma.sync.m16n8k32 .s8`` and
``m16n8k16 .bf16`` fragments read at the kernel's offsets (the
``__byte_perm`` of two aligned words with the kernel's selector for A,
one 64-bit word pair for B) and assembled by the PTX layout into the
matrices each ``mma`` multiplies, which must be the Toeplitz tile of ``ca_t`` and the
shifted window of ``cb_u``; then the diagonals (Horner pairs for int8),
the per-column weights 2^(ea + eb - 7(s+2)), the unit table of
``unit_plan(..., cut_j1=False)`` and the slot sum.  On small integer
operands every step is exact, so the emulation must equal the product bit
for bit; on uniform operands it is held to the plain version at 1e-14 of
each output column's max.  Change an offset here first, then in the
``.cu``.  ``tune_port.py`` probe 14 checks the PTX layouts on the card.
"""

import numpy as np
import pytest
import torch

from genfer_tpu_torch.ops import conv2d as C
from genfer_tpu_torch.ops import ozaki_conv as Z

TILE = C.TILE
# OzGeo in ozaki_conv2d.cu
G, IB = 32, 32
A_LEN, XW = TILE + G, TILE + IB
MT, NTL = 2, 4
NO_COL = None

LANE = np.arange(32)
GID, TQ = LANE // 4, LANE % 4


class Impl:
    """The kernel's per-impl constants and offsets (OzPass in the .cu)."""

    def __init__(self, name):
        self.name = name
        self.esz = 1 if name == "int8" else 2
        self.k_slices = 1 if name == "int8" else 2
        self.kk = 32 if name == "int8" else 16  # k of one mma
        self.horner = name == "int8"
        self.a_pitch = A_LEN * self.esz
        self.b_pitch = G * self.esz
        # A registers a0 .. a3 at window entries y0 + off
        self.a_off = (0, -8, 16, 8) if name == "int8" else (0, -8, 8, 0)

    def entry0(self, m, ks):
        """y0 of a lane's A registers (m: the lane's row)."""
        if self.name == "int8":
            return 63 - m + 4 * TQ
        return 63 - m + 16 * ks + 2 * TQ

    def selector(self):
        if self.name == "int8":
            return 0x3210 + 0x1111 * ((3 - GID) & 3)
        return np.where(GID & 1, 0x3210, 0x5432)

    def a_word(self, y):
        """The aligned word a register's first entry lies in."""
        return y >> 2 if self.name == "int8" else y >> 1

    def b_words(self, ks):
        """b0's and b1's word in a window column: one 64-bit load of the
        word pair 2 tq, 2 tq + 1 (of the slice's 8 words for bf16)."""
        base = 2 * TQ if self.name == "int8" else 8 * ks + 2 * TQ
        return base, base + 1

    def b_byte(self, kk):
        """Where the kernel's staging stores row kk of a window column
        (OzPass::b_byte): the 4-byte word w of rows is stored at position
        2 (w mod 4) + w // 4 of its group of 8."""
        if self.name == "int8":
            w = kk >> 2
            return 4 * (((w & 3) << 1) | (w >> 2)) + (kk & 3)
        w = (kk & 15) >> 1
        return 4 * (8 * (kk >> 4) + (((w & 3) << 1) | (w >> 2))) + 2 * (kk & 1)

    # the PTX ISA's fragment layouts: (row, col) of element j of register r
    def a_pos(self, r, j):
        if self.name == "int8":
            return GID + 8 * (r % 2), 4 * TQ + j + 16 * (r // 2)
        return GID + 8 * (r % 2), 2 * TQ + j + 8 * (r // 2)

    def b_pos(self, r, j):
        if self.name == "int8":
            return 4 * TQ + j + 16 * r, GID
        return 2 * TQ + j + 8 * r, GID


def _to_bytes(values, impl):
    """Little-endian bytes of integer chunk values as the kernel stores
    them (int8, or the bits of bf16)."""
    v = np.asarray(values)
    if impl.name == "int8":
        return v.astype(np.int8).view(np.uint8)
    bits = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return bits.view(torch.int16).numpy().view(np.uint8).reshape(
        v.shape + (2,)).reshape(v.shape[:-1] + (-1,))


def _from_bytes(raw, impl):
    """Entries of ``raw`` (..., 4) as the mma reads a register."""
    if impl.name == "int8":
        return raw.astype(np.uint8).view(np.int8).astype(np.int64)
    raw = np.ascontiguousarray(raw.astype(np.uint8))
    bits = raw.reshape(raw.shape[:-1] + (2, 2)).view(np.int16)[..., 0]
    vals = torch.from_numpy(np.ascontiguousarray(bits)).view(
        torch.bfloat16).float().numpy()
    return vals.astype(np.int64)


def _byte_perm(column, word, sel):
    """``__byte_perm(w[word], w[word + 1], sel)`` over a staged column of
    bytes: byte j of the result is byte (sel >> 4 j) & 7 of the 8 bytes
    from word's first."""
    nib = np.stack([(sel >> (4 * j)) & 7 for j in range(4)], axis=-1)
    addr = 4 * word[..., None] + nib
    return column[..., addr]


def pow2(e):
    if e > 1023:
        return np.inf
    return float(np.ldexp(1.0, e)) if e >= -1074 else 0.0


def _stage(ca, cb, impl, a_shape, b_shape, K0, K1, g0, n_dj, I, n_i,
           j1_lo, j1_hi):
    """The stage as the kernel's loads write it: a's columns reversed
    (entry y is row K0 + 63 - g0 - y), b's window columns (column x is b's
    column K1 - (I + IB - 1) + x) with their G rows contiguous; zero where
    a ends, beyond the stage's columns, rows or the unit's b columns."""
    (a0, a1), (b0, b1) = a_shape, b_shape
    n_t = ca.shape[0]
    R0 = K0 + TILE - 1 - g0
    col0 = K1 - (I + IB - 1)
    sa = np.zeros((n_t, IB, A_LEN), np.int64)
    y = np.arange(A_LEN)
    ok = (R0 - y >= 0) & (R0 - y < a0)
    sa[:, :n_i, ok] = ca[:, R0 - y[ok], I:I + n_i].transpose(0, 2, 1)
    sb = np.zeros((n_t, XW, G), np.int64)
    x = np.arange(XW)
    okb = (col0 + x >= j1_lo) & (col0 + x < j1_hi)
    sb[:, okb, :n_dj] = cb[:, g0:g0 + n_dj, col0 + x[okb]].transpose(
        0, 2, 1)
    bytes_a = np.zeros((n_t, IB, impl.a_pitch), np.uint8)
    bytes_a[:, :, :A_LEN * impl.esz] = _to_bytes(sa, impl)
    bytes_b = np.zeros((n_t, XW, impl.b_pitch), np.uint8)
    for kk in range(G):
        at = impl.b_byte(kk)
        bytes_b[:, :, at:at + impl.esz] = _to_bytes(sb[:, :, kk:kk + 1], impl)
    return bytes_a, bytes_b, col0


def _fragments(bytes_a, bytes_b, impl, i, ks):
    """The A (n_t, 64, kk) and B (n_t, kk, 64) that the kernel's mma of
    k-slice ``ks`` multiply for stage column i, assembled lane by lane
    from its fragment reads by the PTX layout (NaN-free: every position is
    written exactly once, checked)."""
    n_t = bytes_a.shape[0]
    A = np.full((n_t, TILE, impl.kk), -(1 << 40), np.int64)
    B = np.full((n_t, impl.kk, TILE), -(1 << 40), np.int64)
    sel = impl.selector()
    col_a = bytes_a[:, i]  # (n_t, a_pitch)
    per = 4 // impl.esz
    for mb in (0, 32):
        for M in range(MT):
            y0 = impl.entry0(mb + 16 * M + GID, ks)
            for r in range(4):
                y = y0 + impl.a_off[r]
                raw = _byte_perm(col_a, impl.a_word(y), sel)  # (n_t, 32, 4)
                vals = _from_bytes(raw, impl)
                for j in range(per):
                    row, col = impl.a_pos(r, j)
                    A[:, mb + 16 * M + row, col] = vals[:, :, j]
    for nb in (0, 32):
        for N in range(NTL):
            n = nb + 8 * N + GID
            x = n + IB - 1 - i
            for r, word in enumerate(impl.b_words(ks)):
                addr = 4 * (x[:, None] * (impl.b_pitch // 4)
                            + word[:, None]) + np.arange(4)
                raw = bytes_b.reshape(n_t, -1)[:, addr]
                vals = _from_bytes(raw, impl)
                for j in range(per):
                    row, col = impl.b_pos(r, j)
                    B[:, row, nb + 8 * N + col] = vals[:, :, j]
    assert (A > -(1 << 40)).all() and (B > -(1 << 40)).all()
    return A, B


def _unit(ca, cb, ea, eb, impl, a_shape, b_shape, n_t, n_s, unit, check):
    """One work unit of the kernel: its 64 x 64 f64 tile."""
    K0, K1, j0_lo, j0_hi, j1_lo, j1_hi = (int(v) for v in unit[:6])
    a1 = a_shape[1]
    i1_lo = max(0, K1 - j1_hi + 1)
    i1_hi = min(a1, K1 + TILE - j1_lo)
    acc = np.zeros((TILE, TILE))
    for g0 in range(j0_lo, j0_hi, G):
        n_dj = min(G, j0_hi - g0)
        for I in range(i1_lo, i1_hi, IB):
            n_i = min(IB, i1_hi - I)
            bytes_a, bytes_b, col0 = _stage(ca, cb, impl, a_shape, b_shape,
                                            K0, K1, g0, n_dj, I, n_i, j1_lo,
                                            j1_hi)
            for i in range(n_i):
                i1 = I + i
                frags = [_fragments(bytes_a, bytes_b, impl, i, ks)
                         for ks in range(impl.k_slices)]
                A = np.concatenate([f[0] for f in frags], axis=2)
                B = np.concatenate([f[1] for f in frags], axis=1)
                if check:
                    m, k = np.arange(TILE)[:, None], np.arange(G)[None, :]
                    r = K0 + m - (g0 + k)
                    ok = (r >= 0) & (r < a_shape[0])
                    rows = np.clip(r, 0, a_shape[0] - 1)
                    want_a = np.where(ok, ca[:, rows, i1], 0)
                    assert np.array_equal(A, want_a), (unit, g0, i1)
                    n = np.arange(TILE)[None, :]
                    ll = K1 + n - i1
                    okb = (ll >= j1_lo) & (ll < j1_hi) & (k.T < n_dj)
                    want_b = np.where(
                        okb, cb[:, np.minimum(g0 + k.T, b_shape[0] - 1),
                                np.clip(ll, 0, b_shape[1] - 1)], 0)
                    assert np.array_equal(B, want_b), (unit, g0, i1)
                ex = []
                for n in range(TILE):
                    ll = K1 + n - i1
                    ex.append(int(ea[i1]) + int(eb[ll])
                              if j1_lo <= ll < j1_hi else NO_COL)
                # every chunk pair's integer product (f64 matmuls of small
                # integers: exact)
                pair = np.einsum("tmk,ukn->tumn", A.astype(np.float64),
                                 B.astype(np.float64))
                c = None
                for s in range(n_s):
                    fresh = not impl.horner or s % 2 == 0
                    flush = not impl.horner or s % 2 == 1 or s == n_s - 1
                    c = np.zeros((TILE, TILE)) if fresh else c * 128
                    for t in range(max(0, s - 7), min(s, n_t - 1) + 1):
                        c = c + pair[t, s - t]
                    if impl.horner:  # the int32 registers
                        assert np.abs(c).max() < 2 ** 31
                    else:  # exact in the f32 accumulator
                        assert np.abs(c).max() < 2 ** 24
                    if flush:
                        w = np.array([0.0 if e is NO_COL
                                      else pow2(e - 7 * (s + 2)) for e in ex])
                        acc = acc + c * w[None, :]
    return acc


def emulate(a, b, out_shape, pair_bits, impl_name, check=True):
    """K5 as the kernel computes it: the split (the plain version's, which
    the card's split equals bit for bit), the unit plan, every unit, the
    slot sum in slot order."""
    impl = Impl(impl_name)
    c0, c1 = out_shape
    plan = Z.plan(a.shape, b.shape, out_shape)
    if plan.swap:
        a, b = b, a
    ca, ea, _ = Z.ozaki_split_reference(torch.from_numpy(a), pair_bits,
                                        impl_name)
    cb, eb, _ = Z.ozaki_split_reference(torch.from_numpy(b), pair_bits,
                                        impl_name)
    ca = ca.to(torch.int64).numpy()
    cb = cb.to(torch.int64).numpy()
    n_t = ca.shape[0]
    n_s = min(15, pair_bits + 1)
    out = np.zeros((c0, c1))
    work = np.zeros((max(plan.slots, 1), TILE, TILE))
    for unit in plan.units:
        tile = _unit(ca, cb, ea.numpy(), eb.numpy(), impl, a.shape, b.shape,
                     n_t, n_s, unit, check)
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


# ragged (a band of b columns cut by the truncation), thin, the main
# path's stencil class, and one whose tiles are cut into several units
# (slots added in order)
SHAPES = [
    ((33, 17), (21, 45), (40, 40)),
    ((5, 70), (70, 5), (74, 74)),
    ((70, 66), (2, 2), (70, 66)),
    ((72, 72), (72, 72), (72, 72)),
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
    """The last shape above runs tiles of several units (the slot sum)."""
    plan = Z.plan(*SHAPES[-1])
    assert plan.slots > 0 and len(plan.sums) > 0


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
    (entry 63 - m + 4 t, m = g mod 4), 2 ((63 - g) mod 2) for bf16."""
    for name in ("int8", "bf16"):
        impl = Impl(name)
        y0 = impl.entry0(GID, 0)
        byte = y0 * impl.esz
        start = (impl.selector() & 7)
        assert np.array_equal(start, byte % 4), name
