"""Host array backends of the port's TensorPoly Taylor engine.

The port's copy of the host half of genfer_tpu's ``taylor/backend.py``,
which owns the coefficient-tensor representation and the four power-series
kernels ``conv_trunc``, ``poly_div``, ``poly_exp`` and ``poly_log``:

* ``Backend``              - the abstract backend with the generic,
  reference-faithful recursions;
* ``ObjectBackend``        - numpy object arrays of exact payloads for the
  ``--rational`` / ``--precision`` / ``--big-float`` modes;
* ``ArrayF64Backend``      - the f64 body of genfer_tpu's ``JaxF64Backend``
  over an array namespace ``self.jnp`` (numpy here, and the base a torch
  device backend will share): structural and elementwise ops and the
  Newton-lifted multivariate div / exp / log;
* ``NumpyF64Backend``      - the host f64 backend with the native C++
  ``_seriesops`` kernels;
* ``IvArr``, ``ArrayIntervalBackend`` and ``NumpyIntervalBackend`` - the
  vectorized ``--bounds`` arithmetic of genfer_tpu's ``JaxIntervalBackend``
  over an array namespace, and its numpy instance.

What calls jax in the original (the jit paths, the ozaki route and the
truncation staircase) is left out; the torch device code is in
``taylor/backend.py``.
"""

from __future__ import annotations

import functools
import os
from typing import Any, NamedTuple, Sequence

import numpy as np

from .._host_build import load_extension
from ..numbers.scalar import F64, Interval

Shape = tuple[int, ...]


def _norm_shape(shape: Sequence[int]) -> Shape:
    # fast path: already a tuple of python ints (the overwhelmingly
    # common case — 50k+ calls per large-program simplify)
    if type(shape) is tuple:
        for s in shape:
            if type(s) is not int:
                break
        else:
            return shape
    return tuple(int(s) for s in shape)


class Term(NamedTuple):
    """A coefficient tensor of ``shape`` not made yet, for
    ``Backend.lincomb``: ``arr`` times a factor, at the offsets ``pre``
    (None: 0) of a zero tensor of ``shape``, ``arr`` cut where it would
    pass the end of an axis.  The factor is the host scalar ``scale``
    (``Backend.scale``: ``arr * scale``) or the 0-d array ``left``
    (``Backend.mul``: ``left * arr``); with neither, ``arr`` itself."""

    arr: Any
    shape: Shape
    pre: Shape | None = None
    scale: Any = None
    left: Any = None


def _pad_with_offsets(b: "Backend", arr, shape, pre):
    """Zero tensor of ``shape`` with ``arr`` placed at the offsets
    ``pre``."""
    ashape = b.shape(arr)
    if isinstance(b, ObjectBackend):
        out = b.zeros(shape)
        idx = tuple(
            slice(p, p + s) for p, s in zip(pre, ashape)
        )
        out[idx] = arr
        return out
    if isinstance(b, ArrayIntervalBackend):
        pads = [(0, 0)] + [
            (p, t - p - s) for p, t, s in zip(pre, shape, ashape)
        ]
        return IvArr(b.jnp.pad(arr.data, pads))
    pads = [(p, t - p - s) for p, t, s in zip(pre, shape, ashape)]
    return b.jnp.pad(arr, pads)


class Backend:
    """Abstract backend; generic implementations mirror the reference
    recursions and only rely on the structural/elementwise primitives."""

    # host scalar class used for constants of this backend
    scalar_cls: type = F64

    # ---- conversion -------------------------------------------------
    def scalar(self, x) -> Any:
        """Lift a host scalar to a 0-d array."""
        raise NotImplementedError

    def to_host(self, arr0d) -> Any:
        """Lower a 0-d array to a host scalar."""
        raise NotImplementedError

    def from_nested(self, nested) -> Any:
        """Build an array from nested lists of host scalars."""
        raise NotImplementedError

    # ---- structural -------------------------------------------------
    def shape(self, arr) -> Shape:
        raise NotImplementedError

    def zeros(self, shape: Sequence[int]):
        raise NotImplementedError

    def reshape(self, arr, shape: Sequence[int]):
        raise NotImplementedError

    def index(self, arr, axis: int, i: int):
        """Remove ``axis`` by indexing at ``i``."""
        raise NotImplementedError

    def slice_axis(self, arr, axis: int, start: int, stop: int):
        raise NotImplementedError

    def stack(self, arrs: Sequence, axis: int = 0):
        raise NotImplementedError

    def concat(self, arrs: Sequence, axis: int):
        raise NotImplementedError

    def pad_to(self, arr, shape: Sequence[int]):
        """Zero-pad at the high end of each axis up to ``shape``
        (ndim must already match)."""
        raise NotImplementedError

    # ---- elementwise ------------------------------------------------
    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        return self.add(a, self.neg(b))

    def neg(self, a):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def div(self, a, b):
        raise NotImplementedError

    def scale(self, a, host_scalar):
        """Multiply by a host scalar: ``x * c`` elementwise.

        Operand order matters for interval semantics: the reference maps
        ``*x *= c`` which is ``x * c``."""
        return self.mul(a, self.scalar(host_scalar))

    def scale_left(self, host_scalar, a):
        """``c * x`` elementwise."""
        return self.mul(self.scalar(host_scalar), a)

    def div_scalar(self, a, host_scalar):
        return self.div(a, self.scalar(host_scalar))

    def exp_el(self, a):
        raise NotImplementedError

    def log_el(self, a):
        raise NotImplementedError

    def sum_axis(self, a, axis: int, keepdims: bool = False):
        """Sum along an axis with backend-correct accumulation order."""
        n = self.shape(a)[axis]
        acc = self.index(a, axis, 0)
        for i in range(1, n):
            acc = self.add(acc, self.index(a, axis, i))
        if keepdims:
            shape = list(self.shape(a))
            shape[axis] = 1
            acc = self.reshape(acc, shape)
        return acc

    def sum_all(self, a):
        arr = a
        while len(self.shape(arr)) > 0:
            arr = self.sum_axis(arr, 0)
        return arr

    # ---- a constant spine of the GF DAG (gf/ir.py::GenFun._eval) -----
    def eval_spine(self, base, links, constant):
        """Apply ``links`` to the TaylorPoly ``base``, innermost first:
        each is ``(op, node, left)`` with ``op`` the node kind "Add" or
        "Mul", ``node`` the constant-only subtree it applies (a
        TaylorPoly by ``constant(node)``) and ``left`` whether it stands
        on the left.  Op for op what the recursive evaluation does."""
        result = base
        for op, node, left in links:
            c = constant(node)
            if op == "Add":
                result = c + result if left else result + c
            else:
                result = c * result if left else result * c
        return result

    # ---- a sum of padded, scaled and shifted operands (TaylorPoly) ---
    def lincomb(self, shape, a, b=None, sub: bool = False):
        """The coefficients of ``shape`` that ``a + b`` gives (``a - b``
        where ``sub``; ``a`` alone where ``b`` is None), each operand an
        array zero-padded at the high end of each axis to ``shape``, or a
        ``Term`` made first.  ``TaylorPoly``'s ``__add__``, ``__sub__``,
        ``mul_var`` and ``mul_linear`` make their coefficients here.  This
        default makes them op by op: a Term by ``scale`` or ``mul``, its
        cut and ``_pad_with_offsets``, then ``pad_to`` and ``add`` /
        ``sub``; a backend may make them in one pass, with the same
        bits."""
        shape = _norm_shape(shape)
        a = self.pad_to(self._make_term(a), shape)
        if b is None:
            return a
        b = self.pad_to(self._make_term(b), shape)
        return self.sub(a, b) if sub else self.add(a, b)

    def _make_term(self, t):
        if not isinstance(t, Term):
            return t
        arr = t.arr
        if t.scale is not None:
            arr = self.scale(arr, t.scale)
        if t.left is not None:
            arr = self.mul(t.left, arr)
        if t.pre is None:
            return arr
        for ax, n in enumerate(t.shape):
            if self.shape(arr)[ax] > n - t.pre[ax]:
                arr = self.slice_axis(arr, ax, 0, n - t.pre[ax])
        return _pad_with_offsets(self, arr, list(t.shape), t.pre)

    # ---- per-axis scaling by a list of host factors -----------------
    def scale_axis(self, arr, axis: int, factors: Sequence):
        """Multiply slice ``i`` along ``axis`` by host scalar ``factors[i]``
        (each slice as ``x * factors[i]``)."""
        n = self.shape(arr)[axis]
        assert len(factors) == n
        slices = [
            self.scale(self.index(arr, axis, i), factors[i]) for i in range(n)
        ]
        return self.stack(slices, axis)

    # ---- power-series kernels (generic reference-faithful versions) --
    def conv_trunc(self, a, b, out_shape: Sequence[int]):
        """Truncated Cauchy product; ``a``/``b`` must have
        ``ndim == len(out_shape)`` and per-axis length <= out length."""
        out_shape = _norm_shape(out_shape)
        return self._conv_generic(a, b, out_shape)

    def _conv_generic(self, a, b, out_shape: Shape):
        if len(out_shape) == 0:
            return self.mul(a, b)
        la = self.shape(a)[0]
        lb = self.shape(b)[0]
        rest = out_shape[1:]
        ks = []
        for k in range(out_shape[0]):
            lo = max(0, k + 1 - lb)
            hi = min(k + 1, la)
            acc = None
            for j in range(lo, hi):
                p = self._conv_generic(
                    self.index(a, 0, j), self.index(b, 0, k - j), rest
                )
                acc = p if acc is None else self.add(acc, p)
            if acc is None:
                acc = self.zeros(rest)
            ks.append(acc)
        return self.stack(ks, 0)

    def poly_div(self, xs, ys, out_shape: Sequence[int]):
        out_shape = _norm_shape(out_shape)
        return self._div_generic(xs, ys, out_shape)

    def _div_generic(self, xs, ys, out_shape: Shape):
        if len(out_shape) == 0:
            return self.div(xs, ys)
        lxs = self.shape(xs)[0]
        lys = self.shape(ys)[0]
        rest = out_shape[1:]
        ys0 = self.index(ys, 0, 0)
        res: list = []
        for k in range(out_shape[0]):
            lo = max(0, k + 1 - lys)
            acc = None
            for j in range(lo, k):
                term = self._conv_generic(res[j], self.index(ys, 0, k - j), rest)
                acc = term if acc is None else self.add(acc, term)
            cur = self.neg(acc) if acc is not None else self.zeros(rest)
            if k < lxs:
                xsk = self.pad_to(self.index(xs, 0, k), rest)
                cur = self.add(cur, xsk)
            res.append(self._div_generic(cur, ys0, rest))
        return self.stack(res, 0)

    def poly_exp(self, xs, out_shape: Sequence[int]):
        out_shape = _norm_shape(out_shape)
        return self._exp_generic(xs, out_shape)

    def _exp_generic(self, xs, out_shape: Shape):
        if len(out_shape) == 0:
            return self.exp_el(xs)
        lxs = self.shape(xs)[0]
        rest = out_shape[1:]
        T = self.scalar_cls
        res = [self._exp_generic(self.index(xs, 0, 0), rest)]
        for k in range(1, out_shape[0]):
            hi = min(lxs, k + 1)
            acc = None
            for j in range(1, hi):
                xj = self.scale(self.index(xs, 0, j), T.from_u32(j))
                term = self._conv_generic(xj, res[k - j], rest)
                acc = term if acc is None else self.add(acc, term)
            if acc is None:
                acc = self.zeros(rest)
            res.append(self.div_scalar(acc, T.from_u32(k)))
        return self.stack(res, 0)

    def poly_log(self, xs, out_shape: Sequence[int]):
        out_shape = _norm_shape(out_shape)
        return self._log_generic(xs, out_shape)

    def _log_generic(self, xs, out_shape: Shape):
        if len(out_shape) == 0:
            return self.log_el(xs)
        lxs = self.shape(xs)[0]
        rest = out_shape[1:]
        T = self.scalar_cls
        xs0 = self.index(xs, 0, 0)
        res = [self._log_generic(xs0, rest)]
        for k in range(1, out_shape[0]):
            lo = max(1, k + 1 - lxs)
            acc = None
            for j in range(lo, k):
                rj = self.scale(res[j], T.from_u32(j))
                term = self._conv_generic(self.index(xs, 0, k - j), rj, rest)
                acc = term if acc is None else self.add(acc, term)
            cur = self.neg(acc) if acc is not None else self.zeros(rest)
            if k < lxs:
                xsk = self.scale(self.index(xs, 0, k), T.from_u32(k))
                cur = self.add(cur, self.pad_to(xsk, rest))
            cur = self._div_generic(cur, xs0, rest)
            res.append(self.div_scalar(cur, T.from_u32(k)))
        return self.stack(res, 0)


# ===================================================================
# Object backend: numpy object arrays of exact payloads
# ===================================================================

class ObjectBackend(Backend):
    """Exact-mode backend over numpy object arrays.

    Array elements are raw *payloads*, not scalar-tower wrappers: GMP
    ``mpq`` (or ``Fraction``) for Rational, native ``mpfr`` for MultiPrec.
    This keeps the hot elementwise arithmetic at C speed (the payload
    dunders) and lets the native _exactops kernels consume the arrays
    without per-element unwrap/rewrap.  The rare non-finite Rational
    values (NaR/±∞) are stored as Rational wrapper elements; mixed
    payload/wrapper arithmetic resolves through Rational's reflected
    dunders.  Scalar classes without a payload form (BigFloat, Interval,
    mpmath MultiPrec, F64) store their wrapper objects directly.
    """

    def __init__(self, scalar_cls):
        self.scalar_cls = scalar_cls
        from ..numbers.scalar import _XO, MultiPrec, Rational

        if scalar_cls is Rational:
            self._mode = "rational"
        elif _XO is not None and scalar_cls is MultiPrec:
            self._mode = "mpfr"
        else:
            self._mode = "wrapper"
        self._zero = self._lower(scalar_cls.zero())

    # ---- payload <-> host-scalar conversion --------------------------
    def _lower(self, x):
        """Host scalar (or payload) -> array element."""
        if self._mode == "rational":
            from ..numbers.scalar import Rational

            if isinstance(x, Rational):
                return x.frac if x.frac is not None else x
            return x
        if self._mode == "mpfr":
            from ..numbers.scalar import MultiPrec

            return x.v if isinstance(x, MultiPrec) else x
        return x

    def _lift(self, x):
        """Array element -> host scalar."""
        if self._mode == "rational":
            from ..numbers.scalar import Rational

            return x if isinstance(x, Rational) else Rational(x)
        if self._mode == "mpfr":
            from ..numbers.scalar import MultiPrec

            return x if isinstance(x, MultiPrec) else MultiPrec(x)
        return x

    def scalar(self, x):
        a = np.empty((), dtype=object)
        a[()] = self._lower(x)
        return a

    def to_host(self, arr0d):
        v = arr0d[()] if isinstance(arr0d, np.ndarray) else arr0d
        return self._lift(v)

    def from_nested(self, nested):
        def build(n):
            if isinstance(n, (list, tuple)):
                return [build(x) for x in n]
            return self._lower(n)

        return np.array(build(nested), dtype=object)

    def shape(self, arr) -> Shape:
        return tuple(arr.shape)

    def zeros(self, shape):
        a = np.empty(_norm_shape(shape), dtype=object)
        a.fill(self._zero)
        return a

    def reshape(self, arr, shape):
        return arr.reshape(_norm_shape(shape))

    @staticmethod
    def _wrap(x):
        if isinstance(x, np.ndarray):
            return x
        out = np.empty((), dtype=object)
        out[()] = x
        return out

    def index(self, arr, axis, i):
        return self._wrap(np.take(arr, i, axis=axis))

    def slice_axis(self, arr, axis, start, stop):
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(start, stop)
        return arr[tuple(sl)]

    def stack(self, arrs, axis=0):
        return np.stack(arrs, axis=axis)

    def concat(self, arrs, axis):
        return np.concatenate(arrs, axis=axis)

    def pad_to(self, arr, shape):
        shape = _norm_shape(shape)
        if tuple(arr.shape) == shape:
            return arr
        out = self.zeros(shape)
        out[tuple(slice(0, s) for s in arr.shape)] = arr
        return out

    def _ew(self, op, a, b):
        # numpy unwraps one operand when both are 0-d object arrays, which
        # confuses the scalar dunders; compute on raw scalars in that case
        if a.ndim == 0 and b.ndim == 0:
            return self.scalar(op(a[()], b[()]))
        if a.ndim == 0:
            a = a[()]
        if b.ndim == 0:
            b = b[()]
        return np.frompyfunc(op, 2, 1)(a, b)

    def _ew_native(self, opcode, a, b):
        """Native elementwise binary op on payload arrays (C++ walks the
        buffers); None when unavailable or a special element is present."""
        from ..numbers.scalar import _XO

        if _XO is None or self._mode == "wrapper":
            return None
        if a.ndim == 0 and b.ndim == 0:
            return None
        out_shape = np.broadcast_shapes(a.shape, b.shape)
        av = np.broadcast_to(a, out_shape)
        bv = np.broadcast_to(b, out_shape)
        out = np.empty(out_shape, dtype=object)
        fn = _XO.ew_mpq if self._mode == "rational" else _XO.ew_mpfr
        if fn(opcode, av, bv, out):
            return out
        return None

    def add(self, a, b):
        r = self._ew_native(0, a, b)
        if r is not None:
            return r
        return self._ew(lambda x, y: x + y, a, b)

    def sub(self, a, b):
        r = self._ew_native(1, a, b)
        if r is not None:
            return r
        return self.add(a, self.neg(b))

    def neg(self, a):
        if a.ndim == 0:
            return self.scalar(-a[()])
        from ..numbers.scalar import _XO

        if _XO is not None and self._mode != "wrapper":
            out = np.empty(a.shape, dtype=object)
            fn = (
                _XO.ew_neg_mpq
                if self._mode == "rational"
                else _XO.ew_neg_mpfr
            )
            if fn(a, out):
                return out
        return np.frompyfunc(lambda x: -x, 1, 1)(a)

    def mul(self, a, b):
        r = self._ew_native(2, a, b)
        if r is not None:
            return r
        return self._ew(lambda x, y: x * y, a, b)

    def scale_axis(self, arr, axis, factors):
        # one vectorized multiply instead of the generic per-slice loop
        f = np.empty(len(factors), dtype=object)
        for i, x in enumerate(factors):
            f[i] = self._lower(x)
        shape = [1] * arr.ndim
        shape[axis] = len(factors)
        return self.mul(arr, f.reshape(shape))

    def div(self, a, b):
        # Division needs the wrapper semantics for zero divisors (x/0 is
        # ±∞/NaR for Rational, multi_precision.rs-style inf/nan for
        # MultiPrec), so route each element pair through the scalar tower
        # unless both payloads are safely divisible.
        if self._mode == "rational":
            from ..numbers.scalar import Rational

            def dv(x, y):
                if (
                    not isinstance(y, Rational)
                    and not isinstance(x, Rational)
                    and y != 0
                ):
                    return x / y
                return self._lower(self._lift(x) / self._lift(y))

            return self._ew(dv, a, b)
        if self._mode == "mpfr":
            def dv(x, y):
                if y != 0:
                    return x / y
                return self._lower(self._lift(x) / self._lift(y))

            return self._ew(dv, a, b)
        return self._ew(lambda x, y: x / y, a, b)

    def exp_el(self, a):
        if self._mode == "mpfr":
            return _obj_ufunc(lambda x: x.exp())(a)
        return _obj_ufunc(lambda x: self._lower(self._lift(x).exp()))(a)

    def log_el(self, a):
        if self._mode == "mpfr":
            # mpfr_log already gives log(0) = -inf, log(<0) = NaN, which is
            # exactly MultiPrec.log's branching
            return _obj_ufunc(lambda x: x.log())(a)
        return _obj_ufunc(lambda x: self._lower(self._lift(x).log()))(a)

    # ---- optimized kernels -------------------------------------------
    # The generic recursion over numpy object arrays pays enormous
    # per-index overhead.  With the native _exactops extension (GMP/MPFR)
    # the four power-series kernels run in C++ directly on the mpq/mpfr
    # payloads; the fallbacks below run the Cauchy product over flat
    # Python lists with a common-denominator integer fast path for exact
    # rationals (one gcd per output element instead of one per op).
    @staticmethod
    def _fill(out_shape, values):
        out = np.empty(out_shape, dtype=object)
        flat = out.reshape(-1)
        for i, v in enumerate(values):
            flat[i] = v
        return out

    def _all_payload(self, flat):
        """True when no element is a special-wrapper (rational mode) or a
        non-finite value (mpfr mode)."""
        if self._mode == "rational":
            from ..numbers.scalar import Rational

            return not any(isinstance(x, Rational) for x in flat)
        if self._mode == "mpfr":
            return all(x.is_finite() for x in flat)
        return False

    def conv_trunc(self, a, b, out_shape):
        out_shape = _norm_shape(out_shape)
        if a.size == 1 and b.size == 1:
            return self._conv_generic(a, b, out_shape)
        sa = tuple(int(x) for x in a.shape)
        sb = tuple(int(x) for x in b.shape)
        af = a.reshape(-1).tolist()
        bf = b.reshape(-1).tolist()
        from ..numbers.scalar import _XO

        if (
            self._mode == "rational"
            and self._all_payload(af)
            and self._all_payload(bf)
        ):
            if _XO is not None:
                return self._fill(
                    out_shape, _XO.conv_mpq(af, sa, bf, sb, out_shape)
                )
            # Fraction fallback: common-denominator integer convolution
            import math as _math
            from fractions import Fraction

            da = _math.lcm(*(x.denominator for x in af)) if af else 1
            db = _math.lcm(*(x.denominator for x in bf)) if bf else 1
            ai = [x.numerator * (da // x.denominator) for x in af]
            bi = [x.numerator * (db // x.denominator) for x in bf]
            ci = _flat_conv(ai, sa, bi, sb, out_shape, 0)
            den = da * db
            return self._fill(
                out_shape, [Fraction(v, den) for v in ci]
            )
        if self._mode == "mpfr" and self._all_payload(af) and self._all_payload(bf):
            # finite-only: the C++ scatter skips zero coefficients, which
            # would lose 0*inf = NaN propagation on non-finite inputs
            return self._fill(
                out_shape, _XO.conv_mpfr(af, sa, bf, sb, out_shape)
            )
        if self._mode == "wrapper":
            from ..numbers.scalar import (
                MultiPrec,
                _MultiPrecMpmath,
                get_precision,
            )

            if self.scalar_cls is _MultiPrecMpmath:
                import mpmath
                from mpmath.libmp import from_man_exp

                if all(mpmath.isfinite(x.v) for x in af) and all(
                    mpmath.isfinite(x.v) for x in bf
                ):
                    ok, ai, ea = _mpf_to_scaled_ints([x.v for x in af])
                    if ok:
                        ok, bi, eb = _mpf_to_scaled_ints([x.v for x in bf])
                        if ok:
                            ci = _flat_conv(ai, sa, bi, sb, out_shape, 0)
                            prec = get_precision()
                            return self._fill(out_shape, [
                                self.scalar_cls(
                                    mpmath.mpf(
                                        from_man_exp(v, ea + eb, prec, "n")
                                    )
                                )
                                for v in ci
                            ])
        zero = self._zero
        return self._fill(
            out_shape, _flat_conv(af, sa, bf, sb, out_shape, zero)
        )

    # power-series division / exp / log on the native exact payloads
    # (reference recurrences: multivariate_taylor.rs:1162-1386); fall back
    # to the generic per-element recursions on specials
    def poly_div(self, xs, ys, out_shape):
        out_shape = _norm_shape(out_shape)
        from ..numbers.scalar import _XO

        if _XO is not None and xs.size and ys.size:
            xf = xs.reshape(-1).tolist()
            yf = ys.reshape(-1).tolist()
            sxs = tuple(int(s) for s in xs.shape)
            sys_ = tuple(int(s) for s in ys.shape)
            if (
                self._mode == "rational"
                and self._all_payload(xf)
                and self._all_payload(yf)
            ):
                try:
                    cf = _XO.div_mpq(xf, sxs, yf, sys_, out_shape)
                except ZeroDivisionError:
                    return self._div_generic(xs, ys, out_shape)
                return self._fill(out_shape, cf)
            if (
                self._mode == "mpfr"
                and self._all_payload(xf)
                and self._all_payload(yf)
            ):
                return self._fill(
                    out_shape, _XO.div_mpfr(xf, sxs, yf, sys_, out_shape)
                )
        return self._div_generic(xs, ys, out_shape)

    def poly_exp(self, xs, out_shape):
        out_shape = _norm_shape(out_shape)
        from ..numbers.scalar import _XO

        if self._mode == "mpfr" and xs.size:
            xf = xs.reshape(-1).tolist()
            if self._all_payload(xf):
                return self._fill(out_shape, _XO.exp_mpfr(
                    xf, tuple(int(s) for s in xs.shape), out_shape
                ))
        return self._exp_generic(xs, out_shape)

    def poly_log(self, xs, out_shape):
        out_shape = _norm_shape(out_shape)
        from ..numbers.scalar import _XO

        if self._mode == "mpfr" and xs.size:
            xf = xs.reshape(-1).tolist()
            if self._all_payload(xf) and xf[0] > 0:
                return self._fill(out_shape, _XO.log_mpfr(
                    xf, tuple(int(s) for s in xs.shape), out_shape
                ))
        return self._log_generic(xs, out_shape)


def _mpf_to_scaled_ints(values, max_shift_bits: int = 200_000):
    """Represent mpf values exactly as integers times a common 2^E.

    Returns (ok, ints, E); ok=False when the exponent spread would blow up
    the integer sizes (caller falls back to per-element arithmetic)."""
    mans = []
    exps = []
    for v in values:
        sign, man, exp, _bc = v._mpf_
        if man == 0:
            mans.append(0)
            exps.append(None)
        else:
            mans.append(-man if sign else man)
            exps.append(exp)
    finite_exps = [e for e in exps if e is not None]
    if not finite_exps:
        return True, [0] * len(values), 0
    E = min(finite_exps)
    if max(finite_exps) - E > max_shift_bits:
        return False, None, 0
    ints = [
        0 if e is None else m << (e - E) for m, e in zip(mans, exps)
    ]
    return True, ints, E


def _flat_conv(af, sa, bf, sb, out_shape, zero):
    """Truncated n-D Cauchy product over flat Python lists (row-major)."""
    nd = len(out_shape)
    if nd == 1:
        la, lb, lc = sa[0], sb[0], out_shape[0]
        out = []
        for k in range(lc):
            lo = max(0, k + 1 - lb)
            hi = min(k + 1, la)
            acc = zero
            for j in range(lo, hi):
                acc = acc + af[j] * bf[k - j]
            out.append(acc)
        return out
    if nd == 2:
        (a0, a1), (b0, b1) = sa, sb
        (c0, c1) = out_shape
        # skip zero coefficients of a (integer/exact zeros are common)
        a_rows = [af[i0 * a1 : (i0 + 1) * a1] for i0 in range(a0)]
        out = [zero] * (c0 * c1)
        for i0 in range(a0):
            row = a_rows[i0]
            nz = [(i1, v) for i1, v in enumerate(row) if v != zero]
            if not nz:
                continue
            for j0 in range(min(b0, c0 - i0)):
                boff = j0 * b1
                coff = (i0 + j0) * c1
                for i1, v in nz:
                    hi = min(b1, c1 - i1)
                    for j1 in range(hi):
                        idx = coff + i1 + j1
                        out[idx] = out[idx] + v * bf[boff + j1]
        return out
    # general n-D: iterate nonzero coefficients of a, scatter v * b into
    # the output with per-axis truncation clipping; the innermost axis is a
    # contiguous run (no per-element index arithmetic)
    def strides(shape):
        st = [1] * nd
        for i in range(nd - 2, -1, -1):
            st[i] = st[i + 1] * shape[i + 1]
        return st

    sta, stb, stc = strides(sa), strides(sb), strides(out_shape)
    total = 1
    for s_ in out_shape:
        total *= s_
    out = [zero] * total

    import itertools

    for i_multi in itertools.product(*(range(s_) for s_ in sa)):
        oa = sum(i_multi[d] * sta[d] for d in range(nd))
        v = af[oa]
        if v == zero:
            continue
        # bounds for j along each axis: j_d < min(sb_d, c_d - i_d)
        bounds = [min(sb[d], out_shape[d] - i_multi[d]) for d in range(nd)]
        if any(bd <= 0 for bd in bounds):
            continue
        base_c = sum(i_multi[d] * stc[d] for d in range(nd))

        def scatter(d, boff, coff):
            if d == nd - 1:
                run = bounds[d]
                for j in range(run):
                    idx = coff + j
                    out[idx] = out[idx] + v * bf[boff + j]
                return
            for j in range(bounds[d]):
                scatter(d + 1, boff + j * stb[d], coff + j * stc[d])

        scatter(0, 0, base_c)
    return out


def _obj_ufunc(f):
    uf = np.frompyfunc(f, 1, 1)

    def apply(a):
        out = uf(a)
        if not isinstance(out, np.ndarray):
            wrapped = np.empty((), dtype=object)
            wrapped[()] = out
            return wrapped
        return out

    return apply



# ===================================================================
# shape helpers
# ===================================================================

def _effective_axes(shape: Shape) -> list[int]:
    return [i for i, s in enumerate(shape) if s != 1]


@functools.lru_cache(maxsize=4096)
def _conv_pair_flops(a_shape: Shape, b_shape: Shape, out_shape: Shape) -> int:
    """Truncated-product multiply-add count (the honest work measure:
    boundary overshoot of a dense kernel is overhead, not delivered
    work)."""
    total = 1
    for s_a, s_b, o in zip(a_shape, b_shape, out_shape):
        pairs = 0
        for k in range(o):
            pairs += max(0, min(k + 1, s_a) - max(0, k + 1 - s_b))
        total *= max(pairs, 1)
    return total


class ArrayF64Backend(Backend):
    """IEEE-f64 tensors over the array namespace ``xp`` (``self.jnp``,
    numpy-compatible: asarray, zeros, take, stack, concatenate, pad, exp,
    log, sum, isfinite, ones, broadcast_to).  Subclasses provide the fast
    ``conv_trunc`` / ``poly_div`` / ``poly_exp`` / ``poly_log``; the
    Newton-lifted multivariate paths below reduce to them."""

    scalar_cls = F64

    def __init__(self, xp, dtype=None):
        self.jnp = xp
        self.dtype = dtype or xp.float64

    # ---- conversion -------------------------------------------------
    def scalar(self, x):
        v = x.v if isinstance(x, F64) else float(x)
        return self.jnp.asarray(v, dtype=self.dtype)

    def to_host(self, arr0d):
        return F64(float(arr0d))

    def from_nested(self, nested):
        def build(n):
            if isinstance(n, (list, tuple)):
                return [build(x) for x in n]
            return n.v if isinstance(n, F64) else float(n)

        return self.jnp.asarray(build(nested), dtype=self.dtype)

    # ---- structural -------------------------------------------------
    def shape(self, arr) -> Shape:
        return tuple(arr.shape)

    def zeros(self, shape):
        return self.jnp.zeros(_norm_shape(shape), dtype=self.dtype)

    def reshape(self, arr, shape):
        return arr.reshape(_norm_shape(shape))

    def index(self, arr, axis, i):
        return self.jnp.take(arr, i, axis=axis)

    def slice_axis(self, arr, axis, start, stop):
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(start, stop)
        return arr[tuple(sl)]

    def stack(self, arrs, axis=0):
        return self.jnp.stack(arrs, axis=axis)

    def concat(self, arrs, axis):
        return self.jnp.concatenate(arrs, axis=axis)

    def pad_to(self, arr, shape):
        shape = _norm_shape(shape)
        if tuple(arr.shape) == shape:
            return arr
        pads = [(0, t - s) for s, t in zip(arr.shape, shape)]
        return self.jnp.pad(arr, pads)

    # ---- elementwise ------------------------------------------------
    def add(self, a, b):
        return a + b

    def neg(self, a):
        return -a

    def mul(self, a, b):
        return a * b

    def div(self, a, b):
        return a / b

    def exp_el(self, a):
        return self.jnp.exp(a)

    def log_el(self, a):
        return self.jnp.log(a)

    def sum_axis(self, a, axis, keepdims=False):
        return self.jnp.sum(a, axis=axis, keepdims=keepdims)

    def sum_all(self, a):
        return self.jnp.sum(a)

    def scale_axis(self, arr, axis, factors):
        if isinstance(factors, np.ndarray):
            # cached factor vectors (tensorpoly._falling_factors_f64)
            f = self.jnp.asarray(factors, dtype=self.dtype)
        else:
            f = self.jnp.asarray(
                [x.v if isinstance(x, F64) else float(x) for x in factors],
                dtype=self.dtype,
            )
        shape = [1] * arr.ndim
        shape[axis] = len(factors)
        return arr * f.reshape(shape)

    # ---- multivariate power-series kernels (Newton, conv-based) ------
    #
    # The reference computes multivariate div/exp/log with coefficient
    # recurrences that are sequential in the leading axis and recurse
    # per-coefficient in the remaining axes (multivariate_taylor.rs
    # 1162-1231 div, 1285-1317 exp, 1335-1386 log).  That shape of
    # computation is hostile to the TPU: O(order) tiny dependent steps.
    # Instead we use Newton/Hensel lifting, which expresses all three as
    # O(log order) *full-size truncated convolutions* — the one op this
    # framework is fast at everywhere (XLA Toeplitz-matmul kernels on
    # device, native C++ on host, shard_map over the mesh).  Each
    # iteration doubles the number of correct orders along one axis, so
    # the total work is a small constant multiple of a single conv.
    #
    # These produce the same truncated series as the recurrences up to
    # f64 rounding (goldens compare numerically at reference is_close
    # tolerances); non-finite / zero-leading-coefficient inputs take the
    # IEEE-faithful generic recurrence instead.

    def _trunc_to(self, arr, shape):
        """Slice then zero-pad ``arr`` to exactly ``shape``."""
        sl = tuple(slice(0, min(s, t)) for s, t in zip(arr.shape, shape))
        return self.pad_to(arr[sl], _norm_shape(shape))

    def _all_finite(self, arr) -> bool:
        return bool(self.jnp.isfinite(arr).all())

    def _origin_one(self, ndim):
        """The constant-1 series: a single 1 at the origin."""
        return self.jnp.ones((1,) * ndim, dtype=self.dtype)

    def _inv_nd(self, ys, t_shape, r0=None, exact0=1):
        """Reciprocal of the power series ``ys`` truncated to ``t_shape``
        by Newton doubling along the first effective axis:

            r <- r + r * (1 - ys * r)

        If ``r - 1/ys`` has valuation >= k along the Newton axis, the
        update makes it >= 2k, so ceil(log2(n)) iterations suffice; the
        base case (<= 1 effective axis) is the fast triangular-solve
        division of 1 by ``ys``.  ``r0``/``exact0`` warm-start the
        iteration with an approximation exact to valuation ``exact0``."""
        t_shape = _norm_shape(t_shape)
        nd = len(t_shape)
        eff = [
            i for i in range(nd)
            if min(ys.shape[i], t_shape[i]) > 1 and t_shape[i] > 1
        ]
        if r0 is None and len(eff) <= 1:
            return self.poly_div(self._origin_one(nd), ys, t_shape)
        a = eff[0] if eff else 0
        na = t_shape[a]
        if r0 is None:
            sub_t = tuple(1 if i == a else s for i, s in enumerate(t_shape))
            r = self._inv_nd(self.slice_axis(ys, a, 0, 1), sub_t)
            k = 1
        else:
            r, k = r0, exact0
        while k < na:
            k2 = min(2 * k, na)
            t = tuple(k2 if i == a else s for i, s in enumerate(t_shape))
            yt = self._trunc_to(ys, t)
            rt = self._trunc_to(r, t)
            e = self.sub(
                self.pad_to(self._origin_one(nd), t),
                self.conv_trunc(yt, rt, t),
            )
            r = self.add(rt, self.conv_trunc(rt, e, t))
            k = k2
        return r

    def _poly_div_nd(self, xs, ys, out_shape):
        """Multivariate division: q = xs * inv(ys) plus one residual
        refinement step (q += inv(ys) * (xs - ys*q)) for ~1-ulp accuracy.
        Falls back to the IEEE-faithful generic recurrence when the
        leading coefficient is zero or inputs are non-finite."""
        out_shape = _norm_shape(out_shape)
        # truncate the divisor up front: quotient coefficients below
        # out_shape only depend on divisor coefficients below out_shape,
        # and dispatching on the truncated shape guarantees the 1-axis
        # base case of _inv_nd is reachable (a divisor with >=2 effective
        # axes but an out_shape truncating them to 1 would otherwise
        # recurse poly_div -> _poly_div_nd -> _inv_nd forever)
        ys = self._trunc_to(ys, tuple(
            min(ys.shape[i], out_shape[i]) for i in range(len(out_shape))
        ))
        if len(_effective_axes(tuple(ys.shape))) <= 1:
            return self.poly_div(xs, ys, out_shape)
        lead = ys[(0,) * ys.ndim]
        if (
            not self._all_finite(ys)
            or not self._all_finite(xs)
            or float(lead) == 0.0
        ):
            return self._div_generic(xs, ys, out_shape)
        inv_t = tuple(
            o if ys.shape[i] > 1 else 1 for i, o in enumerate(out_shape)
        )
        r = self._inv_nd(ys, inv_t)
        xt = self._trunc_to(xs, out_shape)
        yt = self._trunc_to(ys, tuple(
            min(ys.shape[i], out_shape[i]) for i in range(len(out_shape))
        ))
        q = self.conv_trunc(xt, r, out_shape)
        e = self.sub(xt, self.conv_trunc(q, yt, out_shape))
        return self.add(q, self.conv_trunc(e, r, out_shape))

    def _poly_log_nd(self, xs, out_shape):
        """Multivariate log via  d/dv log(x) = (d/dv x) * inv(x) along the
        first effective axis, integrated, with the integration constant
        log(x|_{v=0}) computed recursively one dimension down."""
        out_shape = _norm_shape(out_shape)
        lead = xs[(0,) * xs.ndim]
        if not self._all_finite(xs) or not float(lead) > 0.0:
            return self._log_generic(xs, out_shape)
        nd = len(out_shape)
        eff = [
            i for i in range(nd)
            if min(xs.shape[i], out_shape[i]) > 1 and out_shape[i] > 1
        ]
        if not eff:
            # xs is constant within out_shape: defer to the 0/1-axis path
            xt = self._trunc_to(xs, tuple(
                min(xs.shape[i], out_shape[i]) for i in range(nd)
            ))
            return self.poly_log(xt, out_shape)
        # log varies only along xs's axes; compute there, zero-pad after
        work = tuple(
            out_shape[i] if i in eff else 1 for i in range(nd)
        )
        a = eff[0]
        na = work[a]
        la = min(xs.shape[a], na)
        xw = self._trunc_to(xs, tuple(
            min(xs.shape[i], work[i]) for i in range(nd)
        ))
        r = self._inv_nd(xw, work)
        # derivative along a: dx[j] = (j+1) * x[j+1]
        dx = self.scale_axis(
            self.slice_axis(xw, a, 1, la), a,
            [float(j) for j in range(1, la)],
        )
        g_shape = tuple(na - 1 if i == a else s for i, s in enumerate(work))
        g = self.conv_trunc(
            self._trunc_to(dx, g_shape), self._trunc_to(r, g_shape), g_shape
        )
        tail = self.scale_axis(g, a, [1.0 / j for j in range(1, na)])
        sub_t = tuple(1 if i == a else s for i, s in enumerate(work))
        head = self.poly_log(self.slice_axis(xw, a, 0, 1), sub_t)
        res = self.concat([self._trunc_to(head, sub_t), tail], a)
        return self._trunc_to(res, out_shape)

    def _poly_exp_nd(self, xs, out_shape):
        """Multivariate exp by Newton iteration  y <- y * (1 + x - log y)
        along the first effective axis; the axis-0 slice is seeded with
        the recursively computed (n-1)-D exp, which makes the integration
        constant of the inner log exactly the slice of x."""
        out_shape = _norm_shape(out_shape)
        if not self._all_finite(xs):
            return self._exp_generic(xs, out_shape)
        nd = len(out_shape)
        eff = [
            i for i in range(nd)
            if min(xs.shape[i], out_shape[i]) > 1 and out_shape[i] > 1
        ]
        if not eff:
            # xs is constant within out_shape: defer to the 0/1-axis path
            xt = self._trunc_to(xs, tuple(
                min(xs.shape[i], out_shape[i]) for i in range(nd)
            ))
            return self.poly_exp(xt, out_shape)
        work = tuple(
            out_shape[i] if i in eff else 1 for i in range(nd)
        )
        a = eff[0]
        na = work[a]
        xw = self._trunc_to(xs, tuple(
            min(xs.shape[i], work[i]) for i in range(nd)
        ))
        sub_t = tuple(1 if i == a else s for i, s in enumerate(work))
        x0 = self._trunc_to(self.slice_axis(xw, a, 0, 1), sub_t)
        y = self._trunc_to(self.poly_exp(x0, sub_t), sub_t)
        # y is constant along a, so inv(y) is too: r = inv(y) exactly
        r = self._inv_nd(y, sub_t)
        r_ex = na  # valuation along a to which r matches inv(y)
        k = 1
        while k < na:
            k2 = min(2 * k, na)
            t = tuple(k2 if i == a else s for i, s in enumerate(work))
            yt = self._trunc_to(y, t)
            # lift the reciprocal to valuation k2 against the current y
            r = self._inv_nd(yt, t, r0=self._trunc_to(r, t),
                             exact0=min(r_ex, k2))
            # log(y) = x|_{v_a=0} + integral of (dy/dv_a) * inv(y)
            dy = self.scale_axis(
                self.slice_axis(yt, a, 1, k2), a,
                [float(j) for j in range(1, k2)],
            )
            g_shape = tuple(
                k2 - 1 if i == a else s for i, s in enumerate(work)
            )
            g = self.conv_trunc(dy, self._trunc_to(r, g_shape), g_shape)
            tail = self.scale_axis(g, a, [1.0 / j for j in range(1, k2)])
            logy = self.concat([x0, tail], a)
            d = self.sub(self._trunc_to(xw, t), logy)
            y = self.add(yt, self.conv_trunc(yt, d, t))
            # the update changed y at valuations >= k, so r is now only
            # guaranteed against the new y up to valuation k
            r_ex = k
            k = k2
        return self._trunc_to(y, out_shape)


# ===================================================================
# interval backend (vectorized --bounds mode)
# ===================================================================

class IvArr:
    """An interval tensor: ``data`` has shape (2, *shape); data[0] = lo,
    data[1] = hi."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data

    @property
    def lo(self):
        return self.data[0]

    @property
    def hi(self):
        return self.data[1]

    @property
    def shape(self):
        return tuple(self.data.shape[1:])

    @property
    def ndim(self):
        return self.data.ndim - 1


class ArrayIntervalBackend(Backend):
    """Interval tensors with outward one-ULP widening after every scalar
    operation, matching reference src/interval.rs semantics (including the
    exactness fast paths for zero/one operands, applied elementwise via
    masks so that point intervals stay points where the reference's do),
    over the array namespace ``xp`` (``self.jnp``)."""

    def __init__(self, xp, dtype=None):
        self.jnp = xp
        self.dtype = dtype or xp.float64
        self.scalar_cls = Interval.over(F64)

    # -- helpers ------------------------------------------------------
    def _widen_lo(self, lo):
        return self.jnp.nextafter(lo, -self.jnp.inf)

    def _widen_hi(self, hi):
        return self.jnp.nextafter(hi, self.jnp.inf)

    def _zero_mask(self, x: IvArr):
        return (x.lo == 0.0) & (x.hi == 0.0)

    def _one_mask(self, x: IvArr):
        return (x.lo == 1.0) & (x.hi == 1.0)

    def _neg_one_mask(self, x: IvArr):
        return (x.lo == -1.0) & (x.hi == -1.0)

    def _finite_mask(self, x: IvArr):
        return self.jnp.isfinite(x.lo) & self.jnp.isfinite(x.hi)

    # ---- conversion -------------------------------------------------
    def scalar(self, x):
        jnp = self.jnp
        if isinstance(x, Interval):
            lo, hi = x.lo.v, x.hi.v
        elif isinstance(x, F64):
            lo = hi = x.v
        else:
            lo = hi = float(x)
        return IvArr(jnp.asarray([lo, hi], dtype=self.dtype))

    def to_host(self, arr0d: IvArr):
        return self.scalar_cls(F64(float(arr0d.lo)), F64(float(arr0d.hi)))

    def from_nested(self, nested):
        jnp = self.jnp

        def build(n, comp):
            if isinstance(n, (list, tuple)):
                return [build(x, comp) for x in n]
            if isinstance(n, Interval):
                return (n.lo.v, n.hi.v)[comp]
            return n.v if isinstance(n, F64) else float(n)

        lo = jnp.asarray(build(nested, 0), dtype=self.dtype)
        hi = jnp.asarray(build(nested, 1), dtype=self.dtype)
        return IvArr(jnp.stack([lo, hi]))

    # ---- structural -------------------------------------------------
    def shape(self, arr: IvArr) -> Shape:
        return arr.shape

    def zeros(self, shape):
        return IvArr(self.jnp.zeros((2,) + _norm_shape(shape), dtype=self.dtype))

    def reshape(self, arr: IvArr, shape):
        return IvArr(arr.data.reshape((2,) + _norm_shape(shape)))

    def index(self, arr: IvArr, axis, i):
        return IvArr(self.jnp.take(arr.data, i, axis=axis + 1))

    def slice_axis(self, arr: IvArr, axis, start, stop):
        sl = [slice(None)] * arr.data.ndim
        sl[axis + 1] = slice(start, stop)
        return IvArr(arr.data[tuple(sl)])

    def stack(self, arrs, axis=0):
        return IvArr(self.jnp.stack([a.data for a in arrs], axis=axis + 1))

    def concat(self, arrs, axis):
        return IvArr(self.jnp.concatenate([a.data for a in arrs], axis=axis + 1))

    def pad_to(self, arr: IvArr, shape):
        shape = _norm_shape(shape)
        if arr.shape == shape:
            return arr
        pads = [(0, 0)] + [(0, t - s) for s, t in zip(arr.shape, shape)]
        return IvArr(self.jnp.pad(arr.data, pads))

    # ---- elementwise interval ops ------------------------------------
    def add(self, a: IvArr, b: IvArr):
        jnp = self.jnp
        lo = a.lo + b.lo
        hi = a.hi + b.hi
        exact = self._zero_mask(a) | self._zero_mask(b)
        lo = jnp.where(exact, lo, self._widen_lo(lo))
        hi = jnp.where(exact, hi, self._widen_hi(hi))
        return IvArr(jnp.stack([lo, hi]))

    def neg(self, a: IvArr):
        return IvArr(self.jnp.stack([-a.hi, -a.lo]))

    def mul(self, a: IvArr, b: IvArr):
        jnp = self.jnp
        p1 = a.lo * b.lo
        p2 = a.lo * b.hi
        p3 = a.hi * b.lo
        p4 = a.hi * b.hi
        lo = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
        hi = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
        lo = self._widen_lo(lo)
        hi = self._widen_hi(hi)
        # fast-path masks (reference: interval.rs:168-189)
        a_one, b_one = self._one_mask(a), self._one_mask(b)
        a_negone, b_negone = self._neg_one_mask(a), self._neg_one_mask(b)
        zero = (self._zero_mask(a) & self._finite_mask(b)) | (
            self._zero_mask(b) & self._finite_mask(a)
        )
        blo, bhi = jnp.broadcast_to(b.lo, lo.shape), jnp.broadcast_to(b.hi, hi.shape)
        alo, ahi = jnp.broadcast_to(a.lo, lo.shape), jnp.broadcast_to(a.hi, hi.shape)
        lo = jnp.where(b_negone, -ahi, lo)
        hi = jnp.where(b_negone, -alo, hi)
        lo = jnp.where(a_negone, -bhi, lo)
        hi = jnp.where(a_negone, -blo, hi)
        lo = jnp.where(b_one, alo, lo)
        hi = jnp.where(b_one, ahi, hi)
        lo = jnp.where(a_one, blo, lo)
        hi = jnp.where(a_one, bhi, hi)
        lo = jnp.where(zero, 0.0, lo)
        hi = jnp.where(zero, 0.0, hi)
        return IvArr(jnp.stack([lo, hi]))

    def div(self, a: IvArr, b: IvArr):
        jnp = self.jnp
        with np.errstate(divide="ignore", invalid="ignore"):
            q1 = a.lo / b.lo
            q2 = a.lo / b.hi
            q3 = a.hi / b.lo
            q4 = a.hi / b.hi
        lo = jnp.minimum(jnp.minimum(q1, q2), jnp.minimum(q3, q4))
        hi = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
        # divisor straddles zero (reference: interval.rs:213-225)
        contains0 = (b.lo <= 0.0) & (0.0 <= b.hi)
        lo_inf = contains0 & ~((0.0 <= a.lo) & ~(a.hi <= 0.0))
        hi_inf = contains0 & ~((a.hi <= 0.0) & ~(0.0 <= a.lo))
        lo = jnp.where(lo_inf, -jnp.inf, lo)
        hi = jnp.where(hi_inf, jnp.inf, hi)
        lo = self._widen_lo(lo)
        hi = self._widen_hi(hi)
        # fast paths
        a_zero = self._zero_mask(a) & ~self._zero_mask(b)
        b_one = self._one_mask(b)
        nan = (
            jnp.isnan(a.lo) | jnp.isnan(a.hi) | jnp.isnan(b.lo) | jnp.isnan(b.hi)
        )
        alo = jnp.broadcast_to(a.lo, lo.shape)
        ahi = jnp.broadcast_to(a.hi, hi.shape)
        lo = jnp.where(b_one, alo, lo)
        hi = jnp.where(b_one, ahi, hi)
        lo = jnp.where(a_zero, alo, lo)
        hi = jnp.where(a_zero, ahi, hi)
        lo = jnp.where(nan, jnp.nan, lo)
        hi = jnp.where(nan, jnp.nan, hi)
        return IvArr(jnp.stack([lo, hi]))

    def exp_el(self, a: IvArr):
        jnp = self.jnp
        lo = self._widen_lo(jnp.exp(a.lo))
        hi = self._widen_hi(jnp.exp(a.hi))
        z = self._zero_mask(a)
        lo = jnp.where(z, 1.0, lo)
        hi = jnp.where(z, 1.0, hi)
        return IvArr(jnp.stack([lo, hi]))

    def log_el(self, a: IvArr):
        jnp = self.jnp
        with np.errstate(divide="ignore", invalid="ignore"):
            llo = jnp.log(a.lo)
            lhi = jnp.log(a.hi)
        lo = self._widen_lo(llo)
        hi = self._widen_hi(lhi)
        one = self._one_mask(a)
        lo = jnp.where(one, 0.0, lo)
        hi = jnp.where(one, 0.0, hi)
        return IvArr(jnp.stack([lo, hi]))


# ===================================================================
# NumPy backends: identical IEEE-f64 semantics on the host.  The torch
# backends of taylor/backend.py subclass NumpyF64Backend and send large
# ops to the card.
# ===================================================================

#: native C++ series kernels (built by _host_build on first use); optional
_SERIESOPS = load_extension("_seriesops")


class NumpyF64Backend(ArrayF64Backend):
    def __init__(self):
        import numpy as _np

        _np.seterr(all="ignore")
        self.jnp = _np
        self.dtype = _np.float64
        self.concrete = True
        self.native = _SERIESOPS

    def scalar(self, x):
        v = x.v if isinstance(x, F64) else float(x)
        return np.asarray(v, dtype=np.float64)

    def to_host(self, arr0d):
        return F64(float(arr0d))

    def from_nested(self, nested):
        def build(n):
            if isinstance(n, (list, tuple)):
                return [build(x) for x in n]
            return n.v if isinstance(n, F64) else float(n)

        return np.asarray(build(nested), dtype=np.float64)

    def seq_sum_axis(self, arr, axis):
        """Sequential (Horner-order) sum along ``axis``, keepdims: the
        cumulative sum of the axis-reversed array reproduces the exact
        right-to-left floating-point accumulation of the Horner loop in
        ``TaylorPoly.subst_var`` at substitution value 1 (numpy's plain
        ``sum`` is pairwise and would round differently)."""
        f = np.flip(arr, axis)
        c = np.cumsum(f, axis=axis)
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(arr.shape[axis] - 1, arr.shape[axis])
        return np.ascontiguousarray(c[tuple(sl)])

    # ---- fast kernels ----------------------------------------------
    def conv_trunc(self, a, b, out_shape):
        out_shape = _norm_shape(out_shape)
        if a.size == 1 or b.size == 1:
            prod = a * b
            sl = tuple(
                slice(0, min(s, o)) for s, o in zip(prod.shape, out_shape)
            )
            prod = prod[sl]
            if prod.shape != out_shape:
                prod = np.pad(
                    prod, [(0, o - s) for s, o in zip(prod.shape, out_shape)]
                )
            return prod
        if self.native is not None:
            out = np.zeros(out_shape)
            self.native.conv_trunc(
                np.ascontiguousarray(a), tuple(a.shape),
                np.ascontiguousarray(b), tuple(b.shape),
                out, out_shape,
            )
            return out
        from scipy.signal import convolve

        prod = convolve(a, b, method="direct")
        sl = tuple(slice(0, min(s, o)) for s, o in zip(prod.shape, out_shape))
        prod = prod[sl]
        if prod.shape != out_shape:
            prod = np.pad(
                prod, [(0, o - s) for s, o in zip(prod.shape, out_shape)]
            )
        return prod

    def poly_div(self, xs, ys, out_shape):
        out_shape = _norm_shape(out_shape)
        eff_ys = _effective_axes(tuple(ys.shape))
        if len(eff_ys) == 0:
            return self.pad_to(xs, out_shape) / ys
        if len(eff_ys) == 1:
            axis = eff_ys[0]
            n = out_shape[axis]
            yv = np.ascontiguousarray(
                np.moveaxis(ys, axis, 0).reshape(ys.shape[axis])
            )
            xm = np.moveaxis(xs, axis, 0).reshape(xs.shape[axis], -1)
            if xm.shape[0] < n:
                xm = np.pad(xm, ((0, n - xm.shape[0]), (0, 0)))
            else:
                xm = xm[:n]
            if self.native is not None and np.isfinite(xm).all() and np.isfinite(yv).all():
                xm = np.ascontiguousarray(xm)
                sol = np.zeros_like(xm)
                self.native.div_1d(
                    xm, xm.shape[0], yv, yv.shape[0], sol, n, xm.shape[1]
                )
            else:
                with np.errstate(all="ignore"):
                    if yv[0] == 0.0 or not np.isfinite(yv).all():
                        sol = self._div_forward_sub(xm, yv, n)
                    else:
                        from scipy.linalg import solve_triangular

                        T = _np_toeplitz(yv, n, n)
                        sol = solve_triangular(T, xm, lower=True)
            rest = [s for i, s in enumerate(out_shape) if i != axis]
            return np.moveaxis(sol.reshape([n] + rest), 0, axis)
        return self._poly_div_nd(xs, ys, out_shape)

    @staticmethod
    def _div_forward_sub(xm, yv, n):
        # IEEE-faithful forward substitution (handles zero/non-finite
        # leading coefficients like the reference recurrence)
        out = np.zeros_like(xm)
        with np.errstate(all="ignore"):
            for k in range(n):
                lo = max(0, k + 1 - yv.shape[0])
                acc = xm[k].copy()
                for j in range(lo, k):
                    acc -= out[j] * yv[k - j]
                out[k] = acc / yv[0]
        return out

    def poly_exp(self, xs, out_shape):
        out_shape = _norm_shape(out_shape)
        eff = _effective_axes(tuple(xs.shape))
        if len(eff) == 0:
            return np.broadcast_to(np.exp(xs), out_shape).copy()
        if len(eff) == 1:
            axis = eff[0]
            n = out_shape[axis]
            x = np.moveaxis(xs, axis, 0).reshape(xs.shape[axis])
            if x.shape[0] < n:
                x = np.pad(x, (0, n - x.shape[0]))
            else:
                x = x[:n]
            res = np.zeros(n)
            if self.native is not None and np.isfinite(x).all():
                self.native.exp_1d(np.ascontiguousarray(x), x.shape[0], res, n)
            else:
                with np.errstate(all="ignore"):
                    res[0] = np.exp(x[0])
                    j = np.arange(n)
                    jx = j * x
                    for k in range(1, n):
                        res[k] = (
                            np.dot(jx[1 : k + 1], res[k - 1 :: -1][: k]) / k
                        )
            return np.moveaxis(
                res.reshape([n] + [1] * (len(out_shape) - 1)), 0, axis
            )
        return self._poly_exp_nd(xs, out_shape)

    def poly_log(self, xs, out_shape):
        out_shape = _norm_shape(out_shape)
        eff = _effective_axes(tuple(xs.shape))
        if len(eff) == 0:
            with np.errstate(all="ignore"):
                return np.broadcast_to(np.log(xs), out_shape).copy()
        if len(eff) == 1:
            axis = eff[0]
            n = out_shape[axis]
            x = np.moveaxis(xs, axis, 0).reshape(xs.shape[axis])
            if x.shape[0] < n:
                x = np.pad(x, (0, n - x.shape[0]))
            else:
                x = x[:n]
            res = np.zeros(n)
            if (
                self.native is not None
                and np.isfinite(x).all()
                and x[0] > 0.0
            ):
                self.native.log_1d(np.ascontiguousarray(x), x.shape[0], res, n)
            else:
                with np.errstate(all="ignore"):
                    res[0] = np.log(x[0]) if x[0] > 0 else (
                        -np.inf if x[0] == 0 else np.nan
                    )
                    j = np.arange(n)
                    jres = np.zeros(n)
                    for k in range(1, n):
                        s = np.dot(x[k - 1 : 0 : -1][: k - 1], jres[1:k])
                        res[k] = (x[k] * k - s) / x[0] / k
                        jres[k] = res[k] * k
            return np.moveaxis(
                res.reshape([n] + [1] * (len(out_shape) - 1)), 0, axis
            )
        return self._poly_log_nd(xs, out_shape)


def _np_toeplitz(a, out_len, b_len):
    la = a.shape[0]
    k = np.arange(out_len)[:, None]
    j = np.arange(b_len)[None, :]
    idx = k - j
    valid = (idx >= 0) & (idx < la)
    g = a[np.clip(idx, 0, la - 1)]
    valid = valid.reshape(valid.shape + (1,) * (g.ndim - 2))
    return np.where(valid, g, 0.0)


class NumpyIntervalBackend(ArrayIntervalBackend):
    """Vectorized --bounds arithmetic on the host (numpy)."""

    def __init__(self):
        import numpy as _np

        _np.seterr(all="ignore")
        self.jnp = _np
        self.dtype = _np.float64
        self.scalar_cls = Interval.over(F64)
        self.concrete = True
