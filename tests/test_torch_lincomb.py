"""The compiled walk's padded sums in one pass (``ops.lincomb_f64``,
``compile.TracedF64Backend.lincomb``) on the CPU, where the op runs its
plain version: the plain version against ``Backend.lincomb``'s op-by-op
sequence bit for bit (1 to 9 axes, offsets, strided operands, factors
shared, per row or absent, no second operand, -0.0, inf and nan),
``lincomb`` under ``torch.func.vmap`` against a loop over rows, the
operands' checks, the launches' row chunks, the kernel's arguments read
as the kernel reads them, and ``TaylorPoly``'s
``__add__``, ``__sub__`` and ``mul_linear`` through the fused hook against
the default one in every field.  On the card, the kernel against the plain
version at the same operands and at the main path's largest shape, and a
result past 2^31 words in chunks of rows."""

import ctypes
import math

import numpy as np
import pytest
import torch

from genfer_tpu_torch import compile as C
from genfer_tpu_torch import trace
from genfer_tpu_torch.numbers.scalar import F64
from genfer_tpu_torch.ops.lincomb_f64 import (
    WORDS,
    _launches,
    _row_chunks,
    lincomb,
    lincomb_f64,
    lincomb_f64_reference,
)
from genfer_tpu_torch.taylor import (
    HybridBackend,
    NumpyF64Backend,
    NumpyIntervalBackend,
    ObjectBackend,
    PallasBackend,
    TorchF64Backend,
    TorchIntervalBackend,
)
from genfer_tpu_torch.taylor.host import Backend, Term
from genfer_tpu_torch.taylor.tensorpoly import TaylorPoly

ROWS = 3

#: (id, a's shape, b's shape or None, result shape, pa, pb, alpha, beta,
#: sub, strided); a factor "shared" (one for all rows), "row" (one a row)
#: or None
CASES = [
    ("add_1", (4,), (6,), (6,), (0,), (0,), None, None, False, False),
    ("sub_2", (4, 3), (2, 5), (4, 5), (0, 0), (0, 0), None, None, True,
     False),
    ("sub_3_strided", (2, 3, 4), (2, 1, 4), (2, 3, 5), (0, 0, 0), (0, 0, 0),
     None, None, True, True),
    ("mul_var_1", (5,), None, (6,), (1,), None, "row", None, False, False),
    ("mul_var_2_cut", (4, 3), None, (4, 3), (1, 0), None, "shared", None,
     False, True),
    ("mul_var_empty", (0, 3), None, (1, 3), (1, 0), None, "row", None, False,
     False),
    ("mul_linear_2", (3, 4), (3, 4), (3, 5), (0, 1), (0, 0), "row", "shared",
     False, False),
    ("mul_linear_2_cut", (3, 3), (4, 3), (4, 3), (1, 0), (0, 0), "shared",
     "row", False, True),
    ("mul_linear_3_strided", (2, 3, 4), (2, 3, 4), (2, 4, 4), (0, 1, 0),
     (0, 0, 0), "row", "row", False, True),
    ("linear_one", (3, 4), (3, 4), (3, 5), (0, 1), (0, 0), "row", None,
     False, False),
    # axes of extent 1 dropped; a wholly off at offset 1 along one of them
    ("mul_linear_4_off", (2, 1, 3, 2), (2, 1, 3, 2), (2, 1, 3, 2),
     (0, 1, 0, 0), (0, 0, 0, 0), "row", "row", False, True),
    # more axes than the kernel unrolls: its loop over the axes
    ("sub_5_strided", (2, 3, 1, 2, 2), (1, 3, 2, 2, 2), (2, 3, 2, 2, 3),
     (0,) * 5, (0, 0, 0, 0, 1), None, "shared", True, True),
    ("add_9_axes", (2,) * 9, (2,) * 8 + (1,), (2,) * 9, (0,) * 9, (0,) * 9,
     None, None, False, False),
]


def same_bits(got, want) -> bool:
    """The same words, NaN where NaN (a NaN's sign and payload are the
    hardware's)."""
    if got.shape != want.shape:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got.masked_fill(nan, 0.0).view(torch.int64),
        want.masked_fill(nan, 0.0).view(torch.int64)))


def _values(rng, shape, device="cpu"):
    """Seeded values with -0.0, +-inf and nan among them."""
    x = rng.standard_normal(shape)
    flat = x.reshape(-1)
    specials = [-0.0, 0.0, np.inf, -np.inf, np.nan]
    for i in range(0, flat.size, 5):
        flat[i] = specials[(i // 5) % len(specials)]
    return torch.from_numpy(x).to(device)


def _operand(rng, shape, strided, rows, device):
    """(rows, *shape), a view with strides of a larger tensor where
    ``strided``."""
    if not strided:
        return _values(rng, (rows, *shape), device)
    big = _values(rng, (rows, *(s + 2 for s in shape)), device)
    return big[(slice(None),) + tuple(slice(1, 1 + s) for s in shape)]


def _factor(rng, kind, rows, device):
    """-1, 0 and inf among the factors: products that give -0.0 and
    nan."""
    if kind is None:
        return None
    f = torch.from_numpy(rng.standard_normal(rows))
    f[: 3] = torch.tensor([-1.0, 0.0, np.inf])[: rows]
    return (f[-1:] if kind == "shared" else f).to(device)


def _case(case, device="cpu", rows=ROWS):
    """The op's arguments for ``case``."""
    name, sa, sb, shape, pa, pb, fa, fb, sub, strided = case
    rng = np.random.default_rng(sum(map(ord, name)))
    a = _operand(rng, sa, strided, rows, device)
    b = None if sb is None else _operand(rng, sb, strided, rows, device)
    if name.startswith("main_mul") or name == "mul_linear_2":
        b = a  # one G for both terms, as the walk has
    return (a, b, _factor(rng, fa, rows, device),
            _factor(rng, fb, rows, device), list(shape), list(pa),
            None if pb is None else list(pb), sub)


def _op_by_op(a, b, alpha, beta, shape, pa, pb, sub):
    """``Backend.lincomb``'s default on ``TorchF64Backend``, row by row:
    a factor or an offset makes an operand a Term."""
    backend = TorchF64Backend(device="cpu")

    def operand(x, f, p, left, r):
        x = x[r % x.shape[0]]
        if f is None and not any(p):
            return x
        f = None if f is None else f[r % f.shape[0]]
        return Term(x, tuple(shape), tuple(p),
                    scale=None if left or f is None else F64(f.item()),
                    left=f.reshape(()) if left and f is not None else None)

    rows = max(t.shape[0] for t in (a, b, alpha, beta) if t is not None)
    return torch.stack([backend.lincomb(
        shape, operand(a, alpha, pa, False, r),
        None if b is None else operand(b, beta, pb, True, r), sub)
        for r in range(rows)])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_version_is_the_op_sequence(case):
    args = _case(case)
    want = _op_by_op(*args)
    got = lincomb_f64_reference(*args)
    assert same_bits(got, want)
    assert same_bits(lincomb_f64(*args), want)
    a, b, alpha, beta = (None if t is None else t[-1] for t in args[:4])
    one = lincomb(a, b, alpha, beta, *args[4:6], args[6] or [], args[7])
    assert same_bits(one, want[-1])


@pytest.mark.parametrize("batched", ["a", "a_alpha", "all", "alpha"])
@pytest.mark.parametrize("dim", [0, 1])
def test_lincomb_folds_the_vmapped_batch_into_rows(batched, dim):
    """``lincomb`` under vmap over ``dim`` of the batched operands (the
    rest unbatched) against each row's call: one call for the batch."""
    a, b, alpha, beta, shape, pa, pb, sub = _case(CASES[7])
    v = ROWS
    ops = {"a": a, "b": b, "alpha": alpha.expand(v).contiguous(),
           "beta": beta}
    names = {"a": ["a"], "a_alpha": ["a", "alpha"], "alpha": ["alpha"],
             "all": ["a", "b", "alpha", "beta"]}[batched]
    dims = {n: min(dim, ops[n].ndim - 1) for n in names}
    args = [ops[n].movedim(0, dims[n]) if n in names else ops[n][0]
            for n in ("a", "b", "alpha", "beta")]
    in_dims = tuple(dims.get(n) for n in ("a", "b", "alpha", "beta"))

    def one(x, y, f, g):
        return lincomb(x, y, f, g, shape, pa, pb, sub)

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("genfer_tpu_torch.ops.lincomb_f64.lincomb_f64",
                   lambda *a: calls.append(a) or lincomb_f64(*a))
        got = torch.func.vmap(one, in_dims=in_dims)(*args)
    assert len(calls) == 1
    want = torch.stack([lincomb_f64_reference(
        *((ops[n][r] if n in names else ops[n][0]).unsqueeze(0)
          for n in ("a", "b")),
        *((ops[n][r] if n in names else ops[n][0]).reshape(1)
          for n in ("alpha", "beta")), shape, pa, pb, sub)[0]
        for r in range(v)])
    assert same_bits(got, want)


@pytest.mark.parametrize("bad", ["dtype", "rows", "offset", "axes",
                                 "beta_alone", "row_words"])
def test_operands_the_op_does_not_take(bad):
    a = torch.zeros(2, 3, 3, dtype=torch.float64)
    b = torch.zeros(2, 3, 3, dtype=torch.float64)
    kw = {"a": a, "b": b, "alpha": None, "beta": None, "shape": [3, 3],
          "pa": [0, 0], "pb": [0, 0], "sub": False}
    if bad == "dtype":
        kw["b"] = b.float()
    elif bad == "rows":
        kw["b"] = torch.zeros(3, 3, 3, dtype=torch.float64)
    elif bad == "offset":
        kw["pa"] = [0, -1]
    elif bad == "axes":
        kw["shape"] = [3, 3, 1]
    elif bad == "beta_alone":
        kw.update(b=None, beta=torch.ones(1, dtype=torch.float64))
    else:  # a row of 2^31 words (nothing allocated on the meta device)
        kw.update(a=torch.empty(1, WORDS, dtype=torch.float64,
                                device="meta"), b=None, shape=[WORDS],
                  pa=[0], pb=None)
    with pytest.raises(ValueError):
        lincomb_f64(**kw)


def test_nested_vmap_is_refused():
    a = torch.zeros(2, 2, 3, dtype=torch.float64)

    def one(x):
        return lincomb(x, x, None, None, [3], [0], [0], False)

    with pytest.raises(ValueError):
        torch.func.vmap(torch.func.vmap(one))(a)


def _run_kernel_on_the_host(args):
    """What ``csrc/lincomb_f64.cu`` computes from ``args``, word by word
    through its pointers (CPU tensors; Python's floats are IEEE f64)."""
    def word(ptr, i):
        return ctypes.c_double.from_address(ptr + 8 * i)

    lens = list(args.len[:args.axes])
    for idx in range(args.rows * math.prod(lens)):
        rest, oa, ob, in_a, in_b = idx, 0, 0, True, bool(args.b)
        for d in reversed(range(args.axes)):
            rest, c = divmod(rest, lens[d])
            ja, jb = c - args.a_pre[d], c - args.b_pre[d]
            in_a = in_a and 0 <= ja < args.a_len[d]
            in_b = in_b and 0 <= jb < args.b_len[d]
            oa, ob = oa + ja * args.a_stride[d], ob + jb * args.b_stride[d]
        t = word(args.a, rest * args.a_row + oa).value if in_a else 0.0
        if in_a and args.alpha:
            t = t * word(args.alpha, rest * args.alpha_row).value
        if args.b:
            u = word(args.b, rest * args.b_row + ob).value if in_b else 0.0
            if in_b and args.beta:
                u = word(args.beta, rest * args.beta_row).value * u
            t = t - u if args.sub else t + u
        word(args.out, idx).value = t


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_the_kernels_arguments_give_the_plain_versions_bits(case):
    a, b, alpha, beta, shape, pa, pb, sub = _case(case)
    pb = pb or [0] * len(shape)
    want = lincomb_f64_reference(a, b, alpha, beta, shape, pa, pb, sub)
    out = torch.full_like(want, 7.0)
    for args in _launches(a, b, alpha, beta, shape, pa, pb, sub, out):
        _run_kernel_on_the_host(args)
    assert same_bits(out, want)


@pytest.mark.parametrize("rows, shape, chunks", [
    (4096, [374, 374], [(0, 4096)]),
    (129, [2 ** 24], [(0, 127), (127, 2)]),
    (3, [WORDS - 1], [(0, 1), (1, 1), (2, 1)]),
])
def test_each_launch_indexes_fewer_than_2_31_words(rows, shape, chunks):
    assert _row_chunks(rows, shape) == chunks


# ----------------------------------------------------------------------
# TaylorPoly's sums through TracedF64Backend: the fused hook against the
# default one
# ----------------------------------------------------------------------

PARAMS = ["p", "q"]


def _backend():
    return C.TracedF64Backend(torch.tensor([0.3, -1.7], dtype=torch.float64),
                              C.make_param_scalar(PARAMS), "cpu", {})


def _poly(backend, shape, degrees, seed):
    coeffs = _values(np.random.default_rng(seed), shape)
    return TaylorPoly(backend, coeffs, degrees)


def _linear(backend, c, v, n):
    """c + x_v as a TaylorPoly of n variables (``linear`` set)."""
    return TaylorPoly.var_with_degrees_p1(backend, v, c, (64,) * n)


def _fields(poly):
    return (poly.coeffs.view(torch.int64), poly.degrees_p1,
            repr(poly.host_const), repr(poly.linear), repr(poly.const0))


def _sites(SP):
    p = SP.param("p")
    return {
        "add": lambda be: _poly(be, (3, 4), (8, 8), 1)
        + _poly(be, (5, 2), (8, 6), 2),
        "add_linear": lambda be: _poly(be, (3, 4), (8, 8), 1)
        + _linear(be, p, 1, 2),
        "sub": lambda be: _poly(be, (2, 3, 2), (4, 4, 4), 3)
        - _poly(be, (3, 1, 2), (4, 4, 4), 4),
        "mul_linear_c_zero": lambda be: _poly(be, (3, 4), (8, 8), 5)
        * _linear(be, SP.zero(), 0, 2),
        "mul_linear_c_one": lambda be: _linear(be, SP.one(), 1, 2)
        * _poly(be, (3, 4), (8, 8), 6),
        "mul_linear_c": lambda be: _poly(be, (3, 4), (8, 8), 7)
        * _linear(be, p * SP.from_ratio(3, 7), 1, 2),
        "mul_linear_cut": lambda be: _poly(be, (3, 4), (8, 4), 8)
        * _linear(be, p, 1, 2),
        "mul_linear_of_linear": lambda be: _linear(be, p, 0, 2)
        * _linear(be, SP.param("q"), 1, 2),
    }


SITES = list(_sites(C.make_param_scalar(PARAMS)))


@pytest.mark.parametrize("site", SITES)
def test_taylorpoly_sums_take_the_hook_with_the_default_bits(site,
                                                             monkeypatch):
    be = _backend()
    make = _sites(be.scalar_cls)[site]
    with trace.recording() as rec:
        fused = make(be)
    monkeypatch.setattr(C.TracedF64Backend, "lincomb", Backend.lincomb)
    plain = make(_backend())
    for got, want in zip(_fields(fused), _fields(plain)):
        assert got == want if not torch.is_tensor(got) else torch.equal(
            got, want)
    kind = ("mul_var" if site == "mul_linear_c_zero"
            else site[:3] if site[:3] in ("add", "sub") else "mul_linear")
    assert rec.count("walk.lincombs_fused", site=kind, phase="eager") == 1


@pytest.mark.parametrize("cls", [
    TorchF64Backend, TorchIntervalBackend, HybridBackend, PallasBackend,
    NumpyF64Backend, NumpyIntervalBackend, ObjectBackend])
def test_other_backends_keep_the_default_hook(cls):
    assert cls.lincomb is Backend.lincomb


# ----------------------------------------------------------------------
# the kernel on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("case", CASES + [
    ("main_mul_linear", (374, 373), (374, 373), (374, 374), (0, 1), (0, 0),
     "row", "row", False, False),
    ("main_add", (374, 300), (200, 374), (374, 374), (0, 0), (0, 0), None,
     None, False, False)], ids=lambda c: c[0])
def test_the_kernel_gives_the_plain_versions_bits(case):
    args = _case(case, "cuda", 128 if case[0].startswith("main") else ROWS)
    launches = lincomb_f64.launches
    got = lincomb_f64(*args)
    want = lincomb_f64_reference(*(t.cpu() if torch.is_tensor(t) else t
                                   for t in args))
    assert same_bits(got.cpu(), want)
    assert lincomb_f64.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_a_result_past_2_31_words_takes_chunks_of_rows():
    """129 rows of 2^24 words (17.3 GB), one row of ``a`` for all, a
    factor a row: two launches, and each row ``a * alpha[r]``."""
    a = _values(np.random.default_rng(5), (1, 2 ** 24), "cuda")
    alpha = torch.linspace(-2.0, 2.0, 129, dtype=torch.float64,
                           device="cuda")
    launches = lincomb_f64.launches
    out = lincomb_f64(a, None, alpha, None, [2 ** 24], [0], None)
    assert lincomb_f64.launches == launches + 2
    for r in (0, 126, 127, 128):
        assert same_bits(out[r], a[0] * alpha[r])
    del out
