"""K5, the f64-accuracy truncated 2-D product from exact integer
tensor-core passes (Ozaki-style error-free splitting): the CUDA kernels,
their plain PyTorch version and the route.

The twin of genfer_tpu's ``ops/ozaki_conv.py``, with its names and
constants.  ``ozaki_conv2d(a, b, out_shape)`` computes the truncated
Cauchy product ``c[k0, k1] = sum a[i0, i1] * b[k0 - i0, k1 - i1]`` of f64
matrices this way:

* every column of each operand is scaled by a power of two
  (``_pow2_colexp``: exact), so that its entries lie in [-1/2, 1/2];
* each scaled operand is split into ``N_CHUNKS`` = 8 integer chunks of
  ``CHUNK_BITS`` = 7 bits (``_chunk_int``; ``_chunk`` with
  ``GENFER_OZAKI_CHUNK=float``, in the plain version only): ``x = sum_t
  C_t 2^-7(t+1) + R``, |C_t| <= 64, every step exact in f64;
* the chunk pairs (t, u) with t + u <= ``pair_bits`` are multiplied as
  integers, one exact integer sum per diagonal s = t + u (int8 in, int32
  sums; bf16 in, f32 sums, which are exact integers too);
* each diagonal's sum is weighted by ``2^-7(s+2)`` and the column scales
  are undone by ``exp2(ea + eb)`` in f64.

Keeping the pairs with t + u <= P truncates at ~2^-7(P+2) relative to the
product of the column scales: P = 7 (36 passes, the default) at the
chunks' remainder floor, ~1e-16 normwise; P = 6 (28 passes) ~1e-13; P = 5
(21) ~5e-10.  The error is normwise per output column: entries far below
their column-scale product lose relative accuracy (the componentwise
cliff of genfer_tpu's module docstring, a property of the method).

On a CUDA tensor ``ozaki_conv2d_batched`` (and ``ozaki_conv2d``, its
batch of one) launches the split once for both operands of every batch
entry (``csrc/ozaki_split.cu``: column exponents, the chunks as int8 or
bf16 in the layout K5 stages in 16-byte pieces, one finiteness flag a
product) and K5 once (``csrc/ozaki_conv2d.cu``): its small body where the
smaller operand holds at most ``SMALL_MAX_COEFFS`` coefficients (exact
int32 multiply-adds on the CUDA cores, one launch, no plan), else its
dense body on the work units of ``plan`` (``wgmma`` m64n64k32 s8 for
int8, ``mma.sync`` m16n8k16 for bf16, 64-row stages of j0, the slots
added in order), or raises; on a CPU tensor it runs the plain version
``ozaki_conv2d_reference`` a batch entry at a time.  There is no other
fallback but the guard's, which never waits for the host: with ``guard``
(the default, and always in ``ozaki_conv2d_guarded`` and ``ozaki_op``)
K5's blocks of a product whose operands hold a non-finite value write
nothing and add one to the guard's count on the device
(``guarded_count``); K1 (``ops.conv2d_f64``) is launched predicated on
the same flags, its blocks of the other products doing nothing, and
``torch.where`` takes K1's result for the flagged products, as
genfer_tpu's ``lax.cond`` under ``vmap`` selects.  So a flagged product
equals K1's bit for bit, which keeps IEEE propagation.  ``ozaki_op`` is
the batched product as a torch custom op with a vmap rule, for the
compiled mode (``genfer_tpu_torch.compile``): one split and one K5 launch
a vmapped product, captured in its CUDA graph like K1's op.

The route (``ozaki_applicable``, read by ``taylor.backend._conv_impl``)
keeps genfer_tpu's environment knobs:

* ``GENFER_OZAKI``: ``0`` off; ``force`` on for any device; unset, ``1`` or
  a number: on a TPU only, so never in this package (the route stays off
  on the card, as the JAX package's is off a TPU);
* ``GENFER_OZAKI_PAIR_BITS`` (default 7), ``GENFER_OZAKI_IMPL`` (``int8``
  or ``bf16``), ``GENFER_OZAKI_MIN_FLOPS`` (crossover in multiply-adds,
  default ``OZAKI_MIN_FLOPS_DEFAULT``), ``GENFER_OZAKI_MAX_BYTES`` (cap on
  ``estimate_bytes``), ``GENFER_OZAKI_CHUNK`` (``int``, or ``float``: the
  plain version only; the split on the card raises for it).

genfer_tpu's XLA layout knobs (``GENFER_OZAKI_STACK``, ``_COLBLOCK``,
``_ROWBLOCK``) and its compile-cache key ``route_fingerprint`` have no
counterpart: K5's unit plan clips the band and the truncation, and
nothing here is compiled.

The column exponent is computed exactly from the exponent bits
(``frexp``): the same value as genfer_tpu's ``ceil(log2(max|col|)) + 1``
wherever that rounded log2 is not pulled onto an integer (column maxima
within ~|e| 1e-16 relative above a power of two 2^e, |e| >= 4), and the
same on the CPU and the card.  A column whose max is subnormal is scaled
in two exact steps (``_scale_columns``), where genfer_tpu's single
``exp2(-e)`` overflows.
"""

from __future__ import annotations

import functools
import os

import torch

from .. import _build
from ..taylor.backend import _antidiag_sum, _toeplitz
from .conv2d import TILE, _check, _on_card, _on_device, _swap, plan_units
from .conv2d_f64 import SMALL_MAX_COEFFS, conv2d_trunc_f64_batched

# 7-bit signed chunks scaled into [-64, 64]: products fit 2^12; the
# int32 accumulator is exact for contractions up to 2^19 per pass and
# 2^16 with the 8-pass diagonal groups folded in
CHUNK_BITS = 7
N_CHUNKS = 8  # 8 * 7 = 56 bits >= the 53-bit f64 mantissa
MAX_K_INT8 = 1 << 16
#: genfer_tpu's bf16 impl folds up to 8 passes of a diagonal into its f32
#: accumulator over the whole contraction: exact only for k <= 512 (K5
#: converts every 32 rows and would stay exact beyond; the cap is kept so
#: that both packages route and refuse the same products)
MAX_K_BF16 = 512
IMPLS = ("int8", "bf16")
BODIES = ("small", "dense")
MAX_PAIR_BITS = 2 * N_CHUNKS - 2  # t + u of the last chunk pair

#: genfer_tpu's crossover against the XLA f64 emulation on the TPU (kept
#: so that ``force`` routes the same products in both packages; the H100
#: A/B against K1 is ``tune_port.py`` probe 15 and PERF.md)
OZAKI_MIN_FLOPS_DEFAULT = 6e8
#: cap on ``estimate_bytes`` (bytes of K5's own buffers)
OZAKI_MAX_BYTES_DEFAULT = 10e9
OZAKI_MAX_K = MAX_K_INT8
#: the split pads every chunk column to a multiple of this many rows, and
#: every tile of K5's plan starts its j0 range at such a multiple: K5
#: stages both operands in 16-byte pieces of whole rows (OzStage::PR)
PIECE_ROWS = 16
#: rows of j0 a stage of K5's dense body contracts over (OzGeo::G in the
#: .cu, both impls), and the least j0 range of a unit of its plan
#: (``ops.conv2d.plan_units(..., cut_j1=False, mma_rows=STAGE_ROWS,
#: j0_align=PIECE_ROWS)``)
STAGE_ROWS = 64


def _pow2_colexp(x):
    """Per-column power-of-two scale EXPONENT ceil(log2 max|col|) + 1, as
    f64, so that x * exp2(-e) lies in [-1/2, 1/2] (e = 1 for all-zero
    columns): from ``frexp``, exact (module docstring)."""
    m = x.abs().amax(dim=0)
    mant, e = torch.frexp(torch.where(m > 0.0, m, torch.ones_like(m)))
    return (e - (mant == 0.5).to(e.dtype)).to(torch.float64) + 1.0


def _scale_columns(x, e):
    """x * 2^-e per column, exactly: one multiplication by exp2(-e) (an
    exact power of two, as genfer_tpu's ``a * exp2(-ea)``), or, where
    2^-e overflows (a column whose max is subnormal, e < -1023), two
    multiplications by 2^1000 and 2^(-e - 1000), both scaling up, so that
    no bit is lost (genfer_tpu multiplies by inf there: ROADMAP Queue 3)."""
    up = torch.where(-e > 1023, 1000.0, 0.0).to(x.dtype)
    return x * torch.exp2(up)[None, :] * torch.exp2(-e - up)[None, :]


def _chunk(x, dtype=torch.float64):
    """Error-free split of ``x`` (f64, |x| <= 1/2) into N_CHUNKS tensors of
    integers in [-64, 64] (as ``dtype``): x = sum_t chunks[t] 2^-7(t+1) +
    R, |R| <= 2^-57; round half to even, as ``jnp.round``."""
    chunks = []
    r = x
    for t in range(N_CHUNKS):
        s = float(2.0 ** (CHUNK_BITS * (t + 1)))
        c = torch.round(r * s)
        chunks.append(c.to(dtype))
        r = r - c / s
    return chunks


def _chunk_int(x, dtype=torch.float64):
    """Integer-domain error-free split: one f64 -> int64 conversion of
    ``x * 2^56`` (round half to even), then int64 bit-slicing into 8
    round-to-nearest 7-bit signed chunks (arithmetic right shifts; the
    chunk is multiplied back, never a negative left shift).  x = sum_t
    chunks[t] 2^-7(t+1) + R, |R| <= 2^-56."""
    y = x * float(2.0 ** (CHUNK_BITS * N_CHUNKS))
    i = torch.round(y).to(torch.int64)
    chunks = []
    for t in range(N_CHUNKS):
        shift = CHUNK_BITS * (N_CHUNKS - 1 - t)
        c = (i + (1 << (shift - 1))) >> shift if shift else i
        chunks.append(c.to(dtype))
        i = i - c * (1 << shift)
    return chunks


def _chunk_impl() -> str:
    """GENFER_OZAKI_CHUNK: 'int' (default) or 'float'."""
    return os.environ.get("GENFER_OZAKI_CHUNK", "int").strip() or "int"


def default_impl() -> str:
    return os.environ.get("GENFER_OZAKI_IMPL", "int8").strip() or "int8"


def default_pair_bits() -> int:
    v = os.environ.get("GENFER_OZAKI_PAIR_BITS", "").strip()
    return int(v) if v else 7


def _min_flops() -> float:
    v = os.environ.get("GENFER_OZAKI_MIN_FLOPS", "").strip()
    return float(v) if v else OZAKI_MIN_FLOPS_DEFAULT


def _max_bytes() -> float:
    v = os.environ.get("GENFER_OZAKI_MAX_BYTES", "").strip()
    return float(v) if v else OZAKI_MAX_BYTES_DEFAULT


def _max_k(impl: str) -> int:
    return MAX_K_INT8 if impl == "int8" else MAX_K_BF16


def _n_chunks(pair_bits: int) -> int:
    return min(N_CHUNKS, pair_bits + 1)


def pair_passes(pair_bits: int) -> int:
    """Chunk pairs (t, u), t + u <= pair_bits, the product runs: each is
    one integer pass over the useful multiply-adds (21, 28, 36 at 5, 6,
    7)."""
    return sum(1 for t in range(N_CHUNKS) for u in range(N_CHUNKS)
               if t + u <= pair_bits)


def _elem_dtype(impl: str) -> torch.dtype:
    return torch.int8 if impl == "int8" else torch.bfloat16


@functools.lru_cache(maxsize=1024)
def _plan(a_shape, b_shape, out_shape):
    return plan_units(a_shape, b_shape, out_shape, False, STAGE_ROWS,
                      PIECE_ROWS)


def plan(a_shape, b_shape, out_shape):
    """The work units of K5's dense body: K1's dense plan
    (``unit_plan(cut_j1=False)``) with j0 ranges of at least
    ``STAGE_ROWS`` rows, cut at multiples of ``PIECE_ROWS``."""
    return _plan(tuple(a_shape), tuple(b_shape), tuple(out_shape))


@functools.lru_cache(maxsize=256)
def _plan_on_card(a_shape, b_shape, out_shape, device):
    """``plan`` with its two tables on ``device``, kept for the next call
    of the same shapes (no host-to-device copy then)."""
    p = plan(a_shape, b_shape, out_shape)
    return (p, torch.from_numpy(p.units).to(device),
            torch.from_numpy(p.sums).to(device))


def k5_body(a_shape, b_shape) -> str:
    """K5's body for one pair's shapes: ``"small"`` where the smaller
    operand holds at most ``SMALL_MAX_COEFFS`` coefficients (K1's small
    class), else ``"dense"``."""
    s0, s1 = b_shape if not _swap(tuple(a_shape), tuple(b_shape)) \
        else a_shape
    return "small" if s0 * s1 <= SMALL_MAX_COEFFS else "dense"


def padded_rows(rows: int) -> int:
    """Rows of a chunk column as the split lays it out: ``rows`` rounded up
    to a multiple of ``PIECE_ROWS`` (the padding holds zeros)."""
    return -(-rows // PIECE_ROWS) * PIECE_ROWS


def estimate_bytes(a_shape, b_shape, out_shape,
                   pair_bits: int | None = None,
                   impl: str | None = None) -> float:
    """Device bytes one K5 product allocates: the chunks of both operands
    (n_t of them, 1 byte an entry for int8, 2 for bf16, each column padded
    to ``padded_rows``), their column exponents, the f64 output and the
    f64 workspace slots of its unit plan (``plan``)."""
    if pair_bits is None:
        pair_bits = default_pair_bits()
    if impl is None:
        impl = default_impl()
    (a0, a1), (b0, b1) = a_shape, b_shape
    c0, c1 = out_shape
    elem = 1 if impl == "int8" else 2
    chunks = _n_chunks(pair_bits) * (padded_rows(a0) * a1
                                     + padded_rows(b0) * b1) * elem
    slots = plan(a_shape, b_shape, out_shape).slots
    return float(chunks + 4 * (a1 + b1) + 8 * c0 * c1
                 + 8 * slots * TILE * TILE)


def ozaki_applicable(dtype_name: str, a_shape, b_shape, out_shape,
                     flops: float) -> bool:
    """True when an f64 product should take the ozaki route: f64, exactly 2
    effective axes (callers pass squeezed shapes), ``GENFER_OZAKI=force``
    (every other setting asks for a TPU, which this package never runs
    on), both contraction lengths within the impl's cap, K5's buffers
    within ``GENFER_OZAKI_MAX_BYTES`` and the multiply-adds at least
    ``GENFER_OZAKI_MIN_FLOPS``."""
    mode = os.environ.get("GENFER_OZAKI", "1").strip()
    if mode == "0" or dtype_name != "float64" or len(out_shape) != 2:
        return False
    if mode != "force":
        return False
    max_k = _max_k(default_impl())
    if b_shape[0] > max_k or a_shape[0] > max_k:
        return False
    if estimate_bytes(a_shape, b_shape, out_shape) > _max_bytes():
        return False
    return flops >= _min_flops()


def _checked(b, pair_bits, impl) -> int:
    """Validate ``pair_bits`` and ``impl`` and the contraction length
    (``b``'s rows, of each batch entry) against the impl's cap; return
    pair_bits."""
    if impl not in IMPLS:
        raise ValueError(f"ozaki impl {impl!r}: not one of {IMPLS}")
    pair_bits = int(pair_bits)
    if not 0 <= pair_bits <= MAX_PAIR_BITS:
        raise ValueError(f"pair_bits {pair_bits} outside [0, "
                         f"{MAX_PAIR_BITS}]")
    b0, max_k = int(b.shape[-2]), _max_k(impl)
    if b0 > max_k:
        raise ValueError(
            f"ozaki conv contraction length {b0} > {max_k}: the {impl} "
            "accumulator would round - route through the blocked driver"
        )
    return pair_bits


def ozaki_split_reference(x, pair_bits: int = 7, impl: str = "int8"):
    """Plain version of the split: (chunks [n_t, rows, cols] as int8 or
    bf16, column exponents as int32, whether every entry is finite)."""
    e = _pow2_colexp(x)
    chunk = _chunk_int if _chunk_impl() == "int" else _chunk
    chunks = chunk(_scale_columns(x, e), _elem_dtype(impl))
    return (torch.stack(chunks[:_n_chunks(pair_bits)]), e.to(torch.int32),
            bool(torch.isfinite(x).all()))


def ozaki_conv2d_reference(a, b, out_shape, pair_bits: int = 7,
                           impl: str = "int8", rows: int | None = None):
    """Plain version of K5, genfer_tpu's ``ozaki_conv2d_traced`` in its
    unblocked layout: the chunks; for each strip of ``rows`` output rows
    (all of them by default), one exact integer sum per diagonal s = t + u
    over the chunk pairs, as f64 einsums of the chunk values (products <=
    2^12, sums far below 2^53: exact), added s ascending into an f64
    ``h`` with weight 2^-7(s+2); one undo by ``exp2(ea + eb)``; the
    anti-diagonal sum.  No finite-input guard."""
    c0, c1 = _check(a, b, out_shape, 2, 2, torch.float64)
    pair_bits = _checked(b, pair_bits, impl)
    b0 = int(b.shape[0])
    n_t = _n_chunks(pair_bits)
    n_s = min(2 * N_CHUNKS - 1, pair_bits + 1)
    chunk = _chunk_int if _chunk_impl() == "int" else _chunk
    ea, eb = _pow2_colexp(a), _pow2_colexp(b)
    dtype = _elem_dtype(impl)
    ca = [c.to(torch.float64) for c in chunk(_scale_columns(a, ea), dtype)]
    cb = [c.to(torch.float64) for c in chunk(_scale_columns(b, eb), dtype)]
    scale = torch.exp2(ea[:, None] + eb[None, :])  # [a1, b1]
    rows = rows or c0
    parts = []
    for r0 in range(0, c0, rows):
        n = min(rows, c0 - r0)
        tas = [_toeplitz(ca[t], n, b0, start=r0) for t in range(n_t)]
        h = None
        for s in range(n_s):
            g = None
            for t in range(max(0, s - N_CHUNKS + 1), min(s + 1, n_t)):
                d = torch.einsum("kji,jl->kil", tas[t], cb[s - t])
                g = d if g is None else g + d
            term = g * 2.0 ** (-CHUNK_BITS * (s + 2))
            h = term if h is None else h + term
        parts.append(_antidiag_sum(h * scale[None], c1))
        del tas, h
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _chunk_columns(chunks, rows: int, reverse: bool):
    """[n_t, rows, cols] chunks as the split kernel lays them out: [n_t,
    cols, padded_rows(rows)], each column's rows contiguous, ascending
    from the top (b) or, where ``reverse``, descending from the end (a:
    the column's last position holds row 0), the padding zero."""
    n_t, _, cols = chunks.shape
    col = chunks.transpose(1, 2)
    pad = torch.zeros((n_t, cols, padded_rows(rows) - rows),
                      dtype=chunks.dtype, device=chunks.device)
    return (torch.cat([pad, col.flip(-1)], -1) if reverse
            else torch.cat([col, pad], -1))


def chunk_view(chunks, rows: int, reverse: bool):
    """The split kernel's chunks [..., n_t, cols, padded rows] seen as the
    plain version's [..., n_t, rows, cols] (``reverse`` for a's, whose
    rows run backwards from the end of each column)."""
    p = chunks.shape[-1]
    col = chunks[..., p - rows:].flip(-1) if reverse \
        else chunks[..., :rows]
    return col.transpose(-1, -2)


def ozaki_split_batched_reference(a, b, pair_bits: int = 7,
                                  impl: str = "int8"):
    """Plain version of the split kernel: for batches ``a`` (B, a0, a1) and
    ``b`` (B, b0, b1), each entry split by ``ozaki_split_reference``, as
    (ca, cb, ea, eb, flags): the chunks in the kernel's layout
    (``_chunk_columns``: ca [B, n_t, a1, padded_rows(a0)] reversed, cb [B,
    n_t, b1, padded_rows(b0)]), the int32 column exponents [B, a1] and [B,
    b1], and int32 flags [B], 1 where a[z] or b[z] holds a non-finite
    entry."""
    out = {"ca": [], "cb": [], "ea": [], "eb": [], "flags": []}
    for az, bz in zip(a, b):
        ok = True
        for name, x, rev in (("a", az, True), ("b", bz, False)):
            chunks, e, finite = ozaki_split_reference(x, pair_bits, impl)
            out["c" + name].append(_chunk_columns(chunks, x.shape[0], rev))
            out["e" + name].append(e)
            ok = ok and finite
        out["flags"].append(0 if ok else 1)
    return (torch.stack(out["ca"]), torch.stack(out["cb"]),
            torch.stack(out["ea"]), torch.stack(out["eb"]),
            torch.tensor(out["flags"], dtype=torch.int32, device=a.device))


def ozaki_split(a, b, pair_bits: int = 7, impl: str = "int8"):
    """The split of both operands of every batch entry, ``a`` (B, a0, a1)
    in a's layout and ``b`` (B, b0, b1) in b's: (ca, cb, ea, eb, flags) as
    ``ozaki_split_batched_reference`` gives them, on the card in one launch
    of ``csrc/ozaki_split.cu`` (the integer split only: raises under
    ``GENFER_OZAKI_CHUNK=float``), on the CPU by that plain version."""
    _check(a, b, (1, 1), 3, 3, torch.float64)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batches of {a.shape[0]} and {b.shape[0]} pairs")
    if impl not in IMPLS:
        raise ValueError(f"ozaki impl {impl!r}: not one of {IMPLS}")
    if not _on_card(a):
        return ozaki_split_batched_reference(a, b, pair_bits, impl)
    if _chunk_impl() != "int":
        raise NotImplementedError(
            f"GENFER_OZAKI_CHUNK={_chunk_impl()!r} on the card: the split "
            "kernel runs the integer split only")
    batch, a0, a1 = a.shape
    _, b0, b1 = b.shape
    n_t = _n_chunks(int(pair_bits))
    dtype, dev = _elem_dtype(impl), a.device
    ca = torch.empty((batch, n_t, a1, padded_rows(a0)), dtype=dtype,
                     device=dev)
    cb = torch.empty((batch, n_t, b1, padded_rows(b0)), dtype=dtype,
                     device=dev)
    ea = torch.empty((batch, a1), dtype=torch.int32, device=dev)
    eb = torch.empty((batch, b1), dtype=torch.int32, device=dev)
    flags = torch.zeros(batch, dtype=torch.int32, device=dev)
    lib = _build.load()
    with _on_device(dev):
        err = lib.ozaki_split(
            a.data_ptr(), b.data_ptr(), batch, a0, a1, b0, b1, n_t,
            int(impl == "bf16"), ca.data_ptr(), cb.data_ptr(), ea.data_ptr(),
            eb.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "ozaki_split", err)
    ozaki_split.launches += 1
    return ca, cb, ea, eb, flags


#: the guard's counts, one int64 tensor a device (``guarded_count``)
_GUARDED: dict = {}


def _guard_counter(device):
    """The guard's count on ``device``, made on first use.  Its first use
    must not be inside a CUDA graph capture: the allocation would belong
    to the graph (the compiled mode's eager warm-up walk makes it)."""
    t = _GUARDED.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the guard's count is first made inside a "
                               "graph capture: run the walk eagerly first")
        t = _GUARDED[device] = torch.zeros(1, dtype=torch.int64,
                                           device=device)
    return t


def guarded_count() -> int:
    """Products the guard sent to K1 since ``reset_launches``: K5 counts
    them on the device (its first block of a flagged product adds one);
    reading them waits for the card."""
    return sum(int(t.item()) for t in _GUARDED.values())


def _launch(a, b, c0, c1, pair_bits, impl, guard):
    """The split of both operands, K5 (its small or dense body) with the
    guard's flags, then, under ``guard``, K1 predicated on them and the
    per-product select."""
    batch = a.shape[0]
    body = k5_body(tuple(a.shape[1:]), tuple(b.shape[1:]))
    if body == "dense":
        units_plan, units, sums = _plan_on_card(
            tuple(a.shape[1:]), tuple(b.shape[1:]), (c0, c1), a.device)
        swap = units_plan.swap
    else:
        swap = _swap(tuple(a.shape[1:]), tuple(b.shape[1:]))
    # the kernels' operand b is the smaller one, as in K1's bodies
    ka, kb = (b, a) if swap else (a, b)
    counter = _guard_counter(a.device) if guard else None
    ca, cb, ea, eb, flags = ozaki_split(ka, kb, pair_bits, impl)
    (_, a0, a1), (_, b0, b1) = ka.shape, kb.shape
    n_t = ca.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    common = (ca.data_ptr(), cb.data_ptr(), ea.data_ptr(), eb.data_ptr(),
              flags.data_ptr() if guard else 0,
              counter.data_ptr() if guard else 0)
    shape = (a0, a1, ca.shape[-1], b0, b1, cb.shape[-1], c0, c1)
    lib = _build.load()
    if body == "small":
        out = torch.empty((batch, c0, c1), dtype=torch.float64,
                          device=a.device)
        err = lib.ozaki_small(*common, out.data_ptr(), batch, n_t, pair_bits,
                              int(impl == "bf16"), *shape, stream)
    else:
        alloc = torch.empty if units_plan.covers else torch.zeros
        out = alloc((batch, c0, c1), dtype=torch.float64, device=a.device)
        work = (torch.empty((batch, units_plan.slots, TILE, TILE),
                            dtype=torch.float64, device=a.device)
                if units_plan.slots else None)
        err = lib.ozaki_conv2d(
            *common, out.data_ptr(), 0 if work is None else work.data_ptr(),
            units.data_ptr(), len(units_plan.units), sums.data_ptr(),
            len(units_plan.sums), units_plan.slots, batch, n_t, pair_bits,
            int(impl == "bf16"), *shape, stream)
    _build.check(lib, f"ozaki_{'small' if body == 'small' else 'conv2d'}",
                 err)
    ozaki_conv2d.launches += 1
    ozaki_conv2d.launches_by_impl[impl] += 1
    ozaki_conv2d.launches_by_body[body] += 1
    if not guard:
        return out
    dense = conv2d_trunc_f64_batched(a, b, (c0, c1), flag=flags)
    return torch.where(flags[:, None, None] != 0, dense, out)


def ozaki_conv2d_batched_reference(a, b, out_shape, pair_bits: int = 7,
                                   impl: str = "int8"):
    """``ozaki_conv2d_reference`` of every batch entry (no guard)."""
    return torch.stack([ozaki_conv2d_reference(az, bz, out_shape, pair_bits,
                                               impl)
                        for az, bz in zip(a, b)])


def ozaki_conv2d_batched(a, b, out_shape, pair_bits: int = 7,
                         impl: str = "int8", guard: bool = True):
    """Truncated 2-D Cauchy products of every pair ``a[z]``, ``b[z]`` of
    the f64 batches ``a`` (B, a0, a1) and ``b`` (B, b0, b1) to (B, c0, c1)
    through exact integer chunk passes (module docstring).  ``pair_bits``
    keeps the chunk pairs with t + u <= pair_bits: 7 = 36 passes, 6 = 28,
    5 = 21.  ``impl``: ``int8`` (int32 sums) or ``bf16`` (f32 sums), whose
    contraction cap (b0 <= ``MAX_K_BF16``) is genfer_tpu's.  ``guard``: a
    product with a non-finite operand entry is K1's (counted by
    ``guarded_count``).  Raises on a bad shape, impl or pair_bits and on a
    contraction above the cap."""
    c0, c1 = _check(a, b, out_shape, 3, 3, torch.float64)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batches of {a.shape[0]} and {b.shape[0]} pairs")
    pair_bits = _checked(b, pair_bits, impl)
    if _on_card(a):
        with _on_device(a.device):
            return _launch(a, b, c0, c1, pair_bits, impl, guard)
    outs = []
    for az, bz in zip(a, b):
        if guard and not bool(torch.isfinite(az).all()
                              & torch.isfinite(bz).all()):
            _guard_counter(a.device).add_(1)
            outs.append(conv2d_trunc_f64_batched(az[None], bz[None],
                                                 (c0, c1))[0])
        else:
            outs.append(ozaki_conv2d_reference(az, bz, (c0, c1), pair_bits,
                                               impl))
    return torch.stack(outs)


def ozaki_conv2d(a, b, out_shape, pair_bits: int = 7, impl: str = "int8",
                 guard: bool = True):
    """Truncated 2-D Cauchy product of f64 matrices ``a`` (a0, a1) and
    ``b`` (b0, b1) to ``out_shape`` (c0, c1): ``ozaki_conv2d_batched`` of
    one pair."""
    _check(a, b, out_shape, 2, 2, torch.float64)
    return ozaki_conv2d_batched(a[None], b[None], out_shape, pair_bits,
                                impl, guard)[0]


def ozaki_conv2d_guarded(a, b, out_shape, pair_bits: int | None = None,
                         impl: str | None = None):
    """The route's entry: ``ozaki_conv2d`` with the guard, ``pair_bits``
    and ``impl`` from GENFER_OZAKI_PAIR_BITS / GENFER_OZAKI_IMPL by
    default."""
    if pair_bits is None:
        pair_bits = default_pair_bits()
    if impl is None:
        impl = default_impl()
    return ozaki_conv2d(a, b, out_shape, pair_bits, impl, guard=True)


@torch.library.custom_op("genfer_tpu_torch::ozaki_batched", mutates_args=())
def _ozaki_batched(a: torch.Tensor, b: torch.Tensor, c0: int, c1: int,
                   pair_bits: int, impl: str) -> torch.Tensor:
    return ozaki_conv2d_batched(a, b, (c0, c1), pair_bits, impl, guard=True)


@_ozaki_batched.register_fake
def _(a, b, c0, c1, pair_bits, impl):
    return a.new_empty((a.shape[0], c0, c1))


def _ozaki_batched_vmap(info, in_dims, a, b, c0, c1, pair_bits, impl):
    """One call over the vmapped dimension times the batch: ``(V, B,
    ...)`` operands folded to ``(V * B, ...)`` (an operand that is not
    batched expanded), the result unfolded: one split and one K5 launch."""
    v = info.batch_size

    def front(x, dim):
        x = x.expand(v, *x.shape) if dim is None else x.movedim(dim, 0)
        return x.reshape(v * x.shape[1], *x.shape[2:]).contiguous()

    out = _ozaki_batched(front(a, in_dims[0]), front(b, in_dims[1]), c0, c1,
                         pair_bits, impl)
    return out.reshape(v, -1, c0, c1), 0


_ozaki_batched.register_vmap(_ozaki_batched_vmap)


def ozaki_op(a, b, out_shape, pair_bits: int | None = None,
             impl: str | None = None):
    """``ozaki_conv2d_batched`` with the guard through the custom op (see
    the module docstring), ``pair_bits`` and ``impl`` from the environment
    by default: the same result, batched by ``torch.func.vmap`` into one
    call."""
    if pair_bits is None:
        pair_bits = default_pair_bits()
    if impl is None:
        impl = default_impl()
    c0, c1 = (int(s) for s in out_shape)
    return _ozaki_batched(a, b, c0, c1, int(pair_bits), impl)


def reset_launches() -> None:
    """Set the split's and K5's launch counts (total, by impl and by body)
    and the guard's counts on every device to 0 (the dicts and counters
    in place, so that references and captured graphs keep them)."""
    ozaki_split.launches = 0
    ozaki_conv2d.launches = 0
    ozaki_conv2d.launches_by_impl.update(dict.fromkeys(IMPLS, 0))
    ozaki_conv2d.launches_by_body.update(dict.fromkeys(BODIES, 0))
    for t in _GUARDED.values():
        t.zero_()


ozaki_conv2d.launches_by_impl = {}
ozaki_conv2d.launches_by_body = {}
reset_launches()
