"""TensorPoly: truncated multivariate Taylor polynomials over a backend.

Faithful re-implementation of the reference Taylor/AD engine
(reference: src/multivariate_taylor.rs).  A polynomial is a dense n-D
coefficient tensor plus *conceptual* truncation degrees ``degrees_p1``
which may exceed the stored shape (``INF_DEGREE`` = untruncated);
invariant: ``coeffs.ndim <= len(degrees_p1)`` and
``0 < shape[i] <= degrees_p1[i]`` (reference: multivariate_taylor.rs:13-31).

Unlike the reference (which inspects coefficient values at runtime for its
zero/one/constant/linear fast paths), value-dependent decisions here are
driven by *host-side metadata* (``host_const`` / ``linear``) propagated
structurally through the operations.  This keeps every computation free of
device->host synchronization and jit-traceable, while exercising the same
fast paths in the cases that matter (they originate from program constants,
not from computed tensors).
"""

from __future__ import annotations

import functools
import math
import struct
from typing import Optional, Sequence

import numpy as np

from ..numbers.scalar import F64
from .host import ArrayF64Backend, Backend, Term

import os

# expensive per-op invariant checks (reference check_invariants,
# multivariate_taylor.rs:23-31); enable with GENFER_CHECK=1
CHECK_INVARIANTS = bool(os.environ.get("GENFER_CHECK"))

INF_DEGREE = math.inf

Degrees = tuple  # of int | INF_DEGREE


def _as_int(d) -> int:
    assert d != INF_DEGREE, "operation requires a finite truncation degree"
    return int(d)


class TaylorPoly:
    __slots__ = ("backend", "coeffs", "degrees_p1", "host_const", "linear",
                 "const0")

    def __init__(
        self,
        backend: Backend,
        coeffs,
        degrees_p1: Sequence,
        host_const=None,
        linear: Optional[tuple] = None,
        const0=None,
    ):
        self.backend = backend
        self.coeffs = coeffs
        self.degrees_p1 = tuple(degrees_p1)
        # metadata: host_const is a host scalar if the poly is that constant
        # (size-1 coeffs); linear is (c, m, var) meaning the poly is exactly
        # c + m * x_var (with all other axes size 1); const0 is the host
        # value of the order-0 coefficient alone (weaker than host_const,
        # needed by traced backends where device values cannot be read back)
        self.host_const = host_const
        self.linear = linear
        if const0 is None:
            if host_const is not None:
                const0 = host_const
            elif linear is not None:
                const0 = linear[0]
        self.const0 = const0
        if CHECK_INVARIANTS:
            shape = backend.shape(coeffs)
            assert len(shape) <= len(self.degrees_p1), (shape, self.degrees_p1)
            assert all(
                0 < s <= d for s, d in zip(shape, self.degrees_p1)
            ), (shape, self.degrees_p1)

    # ------------------------------------------------------------------
    # constructors (reference: multivariate_taylor.rs:33-47, 208-259)
    # ------------------------------------------------------------------
    @classmethod
    def new(cls, backend, coeffs, degrees_p1, **kw):
        return cls(backend, coeffs, degrees_p1, **kw)

    @classmethod
    def from_coeffs(cls, backend, coeffs):
        return cls(backend, coeffs, backend.shape(coeffs))

    @classmethod
    def zero_with(cls, backend, degrees_p1):
        n = len(degrees_p1)
        return cls(
            backend,
            backend.zeros((1,) * n),
            degrees_p1,
            host_const=backend.scalar_cls.zero(),
        )

    @classmethod
    def from_scalar(cls, backend, x, degrees_p1=()):
        return cls(backend, backend.scalar(x), degrees_p1, host_const=x)

    @classmethod
    def from_u32(cls, backend, n: int, degrees_p1=()):
        return cls.from_scalar(backend, backend.scalar_cls.from_u32(n), degrees_p1)

    @classmethod
    def zero(cls, backend):
        return cls.from_scalar(backend, backend.scalar_cls.zero())

    @classmethod
    def one(cls, backend):
        return cls.from_scalar(backend, backend.scalar_cls.one())

    @classmethod
    def var(cls, backend, v: int, x, length):
        """0 + 1*v Taylor polynomial at point x
        (reference: multivariate_taylor.rs:239-248)."""
        T = backend.scalar_cls
        shape = [1] * (v + 1)
        shape[v] = 2 if (length == INF_DEGREE or length >= 2) else _as_int(length)
        if shape[v] > 1:
            col = [x, T.one()]
        else:
            col = [x]
        nested = col
        for _ in range(v):
            nested = [nested]
        # build with axis v as the last of v+1 axes
        arr = backend.from_nested(nested)
        arr = backend.reshape(arr, shape)
        degrees = (length,) * (v + 1)
        if shape[v] > 1:
            return cls(backend, arr, degrees, linear=(x, T.one(), v))
        return cls(backend, arr, degrees, host_const=x)

    @classmethod
    def var_at_zero(cls, backend, v: int, length):
        """reference: multivariate_taylor.rs:228-237 (shape[v] = 2 always)."""
        T = backend.scalar_cls
        shape = [1] * (v + 1)
        shape[v] = 2
        zero, one = T.zero(), T.one()
        col = [zero, one if (length == INF_DEGREE or length > 1) else zero]
        nested = col
        for _ in range(v):
            nested = [nested]
        arr = backend.reshape(backend.from_nested(nested), shape)
        lin = (zero, one, v) if (length == INF_DEGREE or length > 1) else None
        return cls(backend, arr, (length,) * (v + 1), linear=lin)

    @classmethod
    def var_with_degrees_p1(cls, backend, v: int, x, degrees_p1):
        """reference: multivariate_taylor.rs:250-259."""
        T = backend.scalar_cls
        n = len(degrees_p1)
        shape = [1] * n
        shape[v] = 2
        dv = degrees_p1[v]
        arr = backend.from_nested(
            [x, T.one() if (dv == INF_DEGREE or dv > 1) else T.zero()]
        )
        arr = backend.reshape(arr, shape)
        lin = (x, T.one(), v) if (dv == INF_DEGREE or dv > 1) else None
        return cls(backend, arr, tuple(degrees_p1), linear=lin)

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return self.degrees_p1

    def coeffs_shape(self) -> tuple:
        return self.backend.shape(self.coeffs)

    @property
    def ndim(self) -> int:
        return len(self.backend.shape(self.coeffs))

    def num_vars(self) -> int:
        return len(self.degrees_p1)

    def len_of(self, v: int):
        if v < len(self.degrees_p1):
            return self.degrees_p1[v]
        return INF_DEGREE

    def is_constant(self) -> bool:
        return _size(self.coeffs_shape()) == 1

    def _materialize_const(self):
        """For constant-shaped polys, fetch the value as a host scalar.

        The reference's zero/one fast paths inspect values at runtime
        (multivariate_taylor.rs:643-655); some are semantically load-bearing
        (e.g. ``inf * 0 = 0`` via the zero fast path in nested-inference
        normalization factors).  In eager mode we read the 0-d device value
        once and cache it; under tracing (non-concrete backends) this
        returns None and the general path is used."""
        if self.host_const is not None:
            return self.host_const
        if not self.is_constant():
            return None
        if not getattr(self.backend, "concrete", True):
            return None
        self.host_const = self.backend.to_host(
            self.backend.reshape(self.coeffs, ())
        )
        return self.host_const

    def is_zero(self) -> bool:
        if not self.is_constant():
            return False
        c = self._materialize_const()
        return c is not None and c.is_zero()

    def is_one(self) -> bool:
        if not self.is_constant():
            return False
        c = self._materialize_const()
        return c is not None and c.is_one()

    def extract_constant(self):
        """Return the 0-d backend value if this poly is constant (shape-based,
        reference: multivariate_taylor.rs:262-269)."""
        if self.is_constant():
            flat = self.backend.reshape(self.coeffs, ())
            return flat
        return None

    def extract_linear(self):
        """Metadata-driven analogue of reference extract_linear (275-294)."""
        return self.linear

    def constant_term(self):
        """First coefficient as a 0-d backend value."""
        arr = self.coeffs
        b = self.backend
        for _ in range(self.ndim):
            arr = b.index(arr, 0, 0)
        return arr

    def constant_term_host(self):
        return self.backend.to_host(self.constant_term())

    # ------------------------------------------------------------------
    # shape calculus (reference: multivariate_taylor.rs:81-205, 831-852)
    # ------------------------------------------------------------------
    def extend_to_dim(self, ndim: int, degree_p1):
        b = self.backend
        shape = list(self.coeffs_shape())
        assert len(shape) <= ndim
        coeffs = b.reshape(self.coeffs, shape + [1] * (ndim - len(shape)))
        degrees = list(self.degrees_p1)
        while len(degrees) < ndim:
            degrees.append(degree_p1)
        return TaylorPoly(
            b, coeffs, degrees, host_const=self.host_const, linear=self.linear,
            const0=self.const0,
        )

    def remove_last_variable(self):
        b = self.backend
        v = self.num_vars() - 1
        coeffs = self.coeffs
        if v < self.ndim:
            coeffs = b.index(coeffs, v, 0)
        degrees = self.degrees_p1[:-1]
        return TaylorPoly(b, coeffs, degrees, host_const=self.host_const,
                          const0=self.const0)

    def truncate_to_degree_p1(self, degree_p1):
        b = self.backend
        degrees = [min(d, degree_p1) for d in self.degrees_p1]
        coeffs = self.coeffs
        shape = self.coeffs_shape()
        for v in range(len(shape)):
            if degree_p1 != INF_DEGREE and shape[v] > degree_p1:
                coeffs = b.slice_axis(coeffs, v, 0, _as_int(degree_p1))
        return TaylorPoly(
            b, coeffs, degrees, host_const=self.host_const, linear=self.linear,
            const0=self.const0,
        )

    def _truncate_degrees_p1(self, degrees_p1):
        b = self.backend
        degrees = [
            min(d, nd) for d, nd in zip(self.degrees_p1, degrees_p1)
        ]
        coeffs = self.coeffs
        shape = self.coeffs_shape()
        changed = False
        for v in range(len(shape)):
            nd = degrees_p1[v]
            if nd != INF_DEGREE and shape[v] > nd:
                coeffs = b.slice_axis(coeffs, v, 0, _as_int(nd))
                changed = True
        if not changed and degrees == self.degrees_p1:
            return self  # immutable: nothing sliced, degrees unchanged
        lin = self.linear
        if changed:
            lin = None  # slicing could drop the linear coefficient
        return TaylorPoly(
            b, coeffs, degrees, host_const=self.host_const, linear=lin,
            const0=self.const0,
        )

    def min_degrees_p1(self, other: "TaylorPoly") -> list:
        n = max(len(self.degrees_p1), len(other.degrees_p1))
        out = [INF_DEGREE] * n
        for v in range(n):
            if v < len(self.degrees_p1):
                out[v] = min(out[v], self.degrees_p1[v])
            if v < len(other.degrees_p1):
                out[v] = min(out[v], other.degrees_p1[v])
        return out

    def _max_shape(self, other: "TaylorPoly") -> list:
        sa, sb = self.coeffs_shape(), other.coeffs_shape()
        n = max(len(sa), len(sb))
        shape = [1] * n
        for v in range(n):
            if v < len(sa):
                shape[v] = max(shape[v], sa[v])
            if v < len(sb):
                shape[v] = max(shape[v], sb[v])
            if v < len(self.degrees_p1):
                shape[v] = min(shape[v], self.degrees_p1[v])
            if v < len(other.degrees_p1):
                shape[v] = min(shape[v], other.degrees_p1[v])
        return [_as_int(s) for s in shape]

    def _sum_shape(self, other: "TaylorPoly") -> list:
        sa, sb = self.coeffs_shape(), other.coeffs_shape()
        n = max(len(sa), len(sb))
        shape = [0] * n
        for v in range(n):
            if v < len(sa):
                shape[v] += sa[v] - 1
            if v < len(sb):
                shape[v] += sb[v] - 1
            shape[v] += 1
            if v < len(self.degrees_p1):
                shape[v] = min(shape[v], self.degrees_p1[v])
            if v < len(other.degrees_p1):
                shape[v] = min(shape[v], other.degrees_p1[v])
        return [_as_int(s) for s in shape]

    def _broadcast_with(self, other: "TaylorPoly"):
        """reference broadcast (831-852): align degree lengths and ndims."""
        b = self.backend
        da, db = list(self.degrees_p1), list(other.degrees_p1)
        if len(da) < len(db):
            da += db[len(da):]
        elif len(db) < len(da):
            db += da[len(db):]
        ca, cb = self.coeffs, other.coeffs
        na, nb = len(b.shape(ca)), len(b.shape(cb))
        if na < nb:
            ca = b.reshape(ca, list(b.shape(ca)) + [1] * (nb - na))
        elif nb < na:
            cb = b.reshape(cb, list(b.shape(cb)) + [1] * (na - nb))
        a2 = TaylorPoly(b, ca, da, host_const=self.host_const,
                        linear=self.linear, const0=self.const0)
        b2 = TaylorPoly(b, cb, db, host_const=other.host_const,
                        linear=other.linear, const0=other.const0)
        return a2, b2

    # ------------------------------------------------------------------
    # extraction / slicing (reference: 314-404, 453-536)
    # ------------------------------------------------------------------
    def coefficient(self, index: Sequence[int]):
        """Host scalar coefficient at a multi-index (reference: 314-339)."""
        b = self.backend
        view = self.coeffs
        ndim = self.ndim
        shape = b.shape(self.coeffs)
        T = b.scalar_cls
        for v, idx in enumerate(index):
            assert idx < self.len_of(v), (
                f"index out of bounds: {list(index)} vs {self.degrees_p1}"
            )
            if v >= ndim:
                if idx != 0:
                    return T.zero()
            elif idx >= shape[v]:
                return T.zero()
            else:
                view = b.index(view, 0, idx)
        assert len(b.shape(view)) == 0, "index is too short"
        return b.to_host(view)

    def coefficients_of_term(self, v: int, order: int):
        """reference: 341-358."""
        b = self.backend
        if v >= self.ndim:
            if order == 0:
                return self
            return TaylorPoly.zero_with(b, self.degrees_p1)
        if order >= self.coeffs_shape()[v]:
            return TaylorPoly.zero_with(b, self.degrees_p1)
        sliced = b.slice_axis(self.coeffs, v, order, order + 1)
        return TaylorPoly(b, sliced, self.degrees_p1,
                          const0=self.const0 if order == 0 else None)

    def taylor_polynomial(self, v: int, order: int):
        """reference: 360-378."""
        b = self.backend
        if v >= self.ndim:
            if order == 0:
                return self
            return TaylorPoly.zero_with(b, self.degrees_p1)
        if order >= self.coeffs_shape()[v]:
            return self
        upper = min(self.coeffs_shape()[v], order + 1)
        return TaylorPoly(
            b, b.slice_axis(self.coeffs, v, 0, upper), self.degrees_p1,
            const0=self.const0,
        )

    def taylor_polynomial_terms(self, v: int, orders: Sequence[int]):
        """Keep selected orders along v, zero the others (reference: 380-404)."""
        b = self.backend
        max_order_p1 = max(orders) + 1 if orders else 1
        if v >= self.ndim:
            if 0 in orders:
                return self
            return TaylorPoly.zero_with(b, self.degrees_p1)
        upper = min(self.coeffs_shape()[v], max_order_p1)
        keep = [i in set(orders) for i in range(upper)]
        result = b.slice_axis(self.coeffs, v, 0, upper)
        slices = []
        for i in range(upper):
            s = b.slice_axis(result, v, i, i + 1)
            if not keep[i]:
                s = b.zeros(b.shape(s))
            slices.append(s)
        result = b.concat(slices, v) if len(slices) > 1 else slices[0]
        return TaylorPoly(b, result, self.degrees_p1)

    def derivative(self, v: int, n: int):
        """n-th derivative wrt v, keeping the n! factor (reference: 453-481)."""
        b = self.backend
        T = b.scalar_cls
        if v >= self.ndim:
            if n == 0:
                return self
            return TaylorPoly.zero_with(b, self.degrees_p1)
        degrees = list(self.degrees_p1)
        degrees[v] = _sat_sub(degrees[v], n)
        if n >= self.coeffs_shape()[v]:
            return TaylorPoly.zero_with(b, degrees)
        sliced = b.slice_axis(self.coeffs, v, n, self.coeffs_shape()[v])
        m = b.shape(sliced)[v]
        if T is F64 and isinstance(b, ArrayF64Backend):
            factors = _falling_factors_f64(n, m)
        else:
            ff = T.one()
            for i in range(1, n + 1):
                ff = ff * T.from_u32(i)
            factors = []
            for k in range(m):
                factors.append(ff)
                ff = ff * T.from_u32(n + k + 1) / T.from_u32(k + 1)
        result = b.scale_axis(sliced, v, factors)
        return TaylorPoly(b, result, degrees)

    def taylor_expansion_of_coeff(self, v: int, n: int):
        """Coefficient extraction without the n! factor (reference: 484-509)."""
        b = self.backend
        T = b.scalar_cls
        if v >= self.ndim:
            if n == 0:
                return self
            return TaylorPoly.zero_with(b, self.degrees_p1)
        degrees = list(self.degrees_p1)
        degrees[v] = _sat_sub(degrees[v], n)
        if n >= self.coeffs_shape()[v]:
            return TaylorPoly.zero_with(b, degrees)
        sliced = b.slice_axis(self.coeffs, v, n, self.coeffs_shape()[v])
        m = b.shape(sliced)[v]
        if T is F64 and isinstance(b, ArrayF64Backend):
            factors = _binom_factors_f64(n, m)
        else:
            factor = T.one()
            factors = [T.one()]
            for k in range(1, m):
                factor = factor * T.from_u32(n + k) / T.from_u32(k)
                factors.append(factor)
        result = b.scale_axis(sliced, v, factors)
        return TaylorPoly(b, result, degrees)

    def shift_down(self, v: int, n: int):
        """Monus: drop n leading coefficients of v, folding their sum into
        the new order-0 coefficient (reference: 511-536)."""
        b = self.backend
        if v >= self.ndim:
            return self
        degrees = list(self.degrees_p1)
        degrees[v] = _sat_sub(degrees[v], n)
        length = self.coeffs_shape()[v]
        if length <= n + 1:
            result = b.sum_axis(self.coeffs, v, keepdims=True)
        else:
            head = b.slice_axis(self.coeffs, v, 0, n)
            tail = b.slice_axis(self.coeffs, v, n, length)
            head_sum = b.sum_axis(head, v, keepdims=True) if n > 0 else None
            if head_sum is not None:
                first = b.add(b.slice_axis(tail, v, 0, 1), head_sum)
                rest = b.slice_axis(tail, v, 1, length - n)
                result = b.concat([first, rest], v)
            else:
                result = tail
        return TaylorPoly(b, result, degrees)

    def subst_var(self, v: int, subst: "TaylorPoly"):
        """Horner composition along axis v (reference: 538-580)."""
        b = self.backend
        T = b.scalar_cls
        if v >= self.ndim:
            return self
        degrees = self.min_degrees_p1(subst)
        if subst.is_zero():
            return TaylorPoly(
                b, b.slice_axis(self.coeffs, v, 0, 1), degrees,
                const0=self.const0,
            )
        # substituting exactly 1 (the marginalization substitution of
        # probs/moments extraction, reference generating_function.rs:
        # 945-957) degenerates Horner to a right-to-left running sum;
        # a sequential (cumsum-ordered) axis reduction is bit-identical
        # to the Horner accumulation (res*1 + a_i is exact) in one pass
        # instead of shape[v] full-tensor mul/adds.  Backends without a
        # sequential reduction keep the Horner path.
        if (
            subst.host_const is not None
            and subst.is_constant()
            and subst.host_const.is_one()
        ):
            seq = getattr(b, "seq_sum_axis", None)
            if seq is not None:
                coeffs = self.coeffs
                nd0 = len(b.shape(coeffs))
                if nd0 < len(degrees):
                    coeffs = b.reshape(
                        coeffs,
                        list(b.shape(coeffs)) + [1] * (len(degrees) - nd0),
                    )
                for ax in range(len(b.shape(coeffs))):
                    d = degrees[ax]
                    if ax != v and d != INF_DEGREE and b.shape(coeffs)[ax] > d:
                        coeffs = b.slice_axis(coeffs, ax, 0, _as_int(d))
                return TaylorPoly(b, seq(coeffs, v), degrees)
        lin = subst.extract_linear()
        if lin is not None:
            c, m, w = lin
            if v == w and c.is_zero():
                # diagonal scaling by powers of m (reference: 555-567)
                coeffs = self.coeffs
                shape = b.shape(coeffs)
                for ax in range(len(shape)):
                    d = degrees[ax] if ax < len(degrees) else INF_DEGREE
                    if d != INF_DEGREE and shape[ax] > d:
                        coeffs = b.slice_axis(coeffs, ax, 0, _as_int(d))
                shape = b.shape(coeffs)
                if T is F64 and isinstance(b, ArrayF64Backend):
                    factors = _power_factors_f64(m.v, shape[v])
                else:
                    factor = T.one()
                    factors = []
                    for _ in range(shape[v]):
                        factors.append(factor)
                        factor = factor * m
                result = b.scale_axis(coeffs, v, factors)
                return TaylorPoly(b, result, degrees, const0=self.const0)
        fast = self._subst_shift_scale(v, subst, degrees)
        if fast is not None:
            return fast
        fast = self._subst_horner_native(v, subst, degrees)
        if fast is not None:
            return fast
        # general Horner
        res = TaylorPoly.zero_with(b, degrees)
        coeffs = self.coeffs
        nd = len(b.shape(coeffs))
        if nd < len(degrees):
            coeffs = b.reshape(
                coeffs, list(b.shape(coeffs)) + [1] * (len(degrees) - nd)
            )
        shape = b.shape(coeffs)
        for i in reversed(range(shape[v])):
            chunk = b.slice_axis(coeffs, v, i, i + 1)
            cshape = b.shape(chunk)
            for ax in range(len(cshape)):
                d = degrees[ax]
                if d != INF_DEGREE and b.shape(chunk)[ax] > d:
                    chunk = b.slice_axis(chunk, ax, 0, _as_int(d))
            res = res * subst + TaylorPoly(b, chunk, degrees)
        return res

    def _subst_horner_native(self, v: int, subst: "TaylorPoly", degrees):
        """The general Horner substitution loop fused into one native
        pass per step (_seriesops.subst_horner): for the small
        replacement series of real programs (a handful of nonzeros) each
        step is a single output-centric gather instead of numpy's
        mul/pad/add round trips.  Accumulation order matches the Python
        loop bit for bit on finite inputs; non-finite inputs keep the
        IEEE-faithful Python path."""
        b = self.backend
        import numpy as _np

        native = getattr(b, "native", None)
        if native is None or not hasattr(native, "subst_horner"):
            return None
        a = self.coeffs
        g = subst.coeffs
        if (
            not isinstance(a, _np.ndarray)
            or not isinstance(g, _np.ndarray)
            or a.dtype != _np.float64
            or g.dtype != _np.float64
            or g.size > 64
        ):
            return None
        if not (_np.isfinite(a).all() and _np.isfinite(g).all()):
            return None
        nd = len(degrees)
        if a.ndim < nd:
            a = a.reshape(list(a.shape) + [1] * (nd - a.ndim))
        if g.ndim < nd:
            g = g.reshape(list(g.shape) + [1] * (nd - g.ndim))
        if v >= nd:
            return None
        # clip a to the result degrees on the non-v axes (the Python
        # loop clips each chunk the same way)
        sl = []
        for ax in range(nd):
            d = degrees[ax]
            if ax != v and d != INF_DEGREE and a.shape[ax] > d:
                sl.append(slice(0, _as_int(d)))
            else:
                sl.append(slice(None))
        a = _np.ascontiguousarray(a[tuple(sl)])
        g = _np.ascontiguousarray(g)
        # simulate the Horner loop's shape growth to size the output
        def clip(ax, n):
            d = degrees[ax]
            return n if d == INF_DEGREE else min(n, _as_int(d))

        chunk_shape = [
            1 if ax == v else clip(ax, a.shape[ax]) for ax in range(nd)
        ]
        # bit-parity guard: conv_nd scatters from the *smaller* operand,
        # so the accumulation order matches this kernel's fixed g-nonzero
        # order only while every intermediate res is strictly bigger
        # than g; res grows monotonically from the first chunk
        cn = 1
        for s in chunk_shape:
            cn *= s
        if cn <= g.size:
            return None
        # the Python loop's first res*g is the zero polynomial's is_zero
        # fast path (shape stays (1,)*nd), so growth starts one step late
        s_res = list(chunk_shape)
        for _ in range(a.shape[v] - 1):
            s_res = [
                max(clip(ax, s_res[ax] + g.shape[ax] - 1), chunk_shape[ax])
                for ax in range(nd)
            ]
        out = _np.zeros(s_res)
        native.subst_horner(
            a, tuple(a.shape), g, tuple(g.shape), out, tuple(s_res), v
        )
        return TaylorPoly(b, out, degrees)

    def _subst_shift_scale(self, v: int, subst: "TaylorPoly", degrees):
        """One-pass substitution of ``g = alpha + beta * v`` (Taylor
        shift/scale) or ``g = alpha + beta * v * u`` (the compound-
        Binomial thinning factor) for the Horner loop.

        Both reduce to the Pascal-triangular transform

            T[..., j] = sum_i a[..., i] * B[i, j],
            B[i, j] = C(i, j) * alpha^(i-j) * beta^j

        computed as a single matmul over the ``v`` axis (B built by the
        stable Pascal recurrence B[i+1] = alpha*B[i] + beta*shift(B[i]),
        the same nonnegative-sum structure as the Horner loop); for the
        bilinear case the w^j factor then places column j at u-offset j
        (one strided copy per column, O(tensor) total traffic instead of
        the Horner loop's O(n * tensor)).

        Only on concrete host (numpy-family) backends — detection reads
        coefficient values.  Returns None when the pattern does not
        match."""
        b = self.backend
        import numpy as _np

        if (
            not isinstance(self.coeffs, _np.ndarray)
            or self.coeffs.dtype != _np.float64
        ):
            return None
        g = subst.coeffs
        if not isinstance(g, _np.ndarray) or g.dtype != _np.float64:
            return None
        gshape = list(g.shape)
        if v >= len(gshape) or gshape[v] != 2:
            return None
        other = [
            i for i, s in enumerate(gshape) if s != 1 and i != v
        ]
        if len(other) > 1:
            return None
        u = other[0] if other else None
        if u is not None and (g.shape[u] != 2 or u == v):
            return None
        # alpha at the origin; beta at v=1 (and u=1 when present); no
        # other nonzeros
        idx0 = [0] * g.ndim
        idx1 = [0] * g.ndim
        idx1[v] = 1
        if u is not None:
            idx1[u] = 1
        alpha = float(g[tuple(idx0)])
        beta = float(g[tuple(idx1)])
        mask = _np.zeros_like(g)
        mask[tuple(idx0)] = alpha
        mask[tuple(idx1)] = beta
        if not _np.array_equal(mask, g) or not _np.isfinite(g).all():
            return None
        a = self.coeffs
        if a.ndim < len(degrees):
            a = a.reshape(list(a.shape) + [1] * (len(degrees) - a.ndim))
        if not _np.isfinite(a).all():
            return None
        # truncate input to the result degrees on every axis but v
        sl = []
        for ax in range(a.ndim):
            d = degrees[ax]
            if ax != v and d != INF_DEGREE and a.shape[ax] > d:
                sl.append(slice(0, _as_int(d)))
            else:
                sl.append(slice(None))
        a = a[tuple(sl)]
        n_in = a.shape[v]
        dv = degrees[v]
        n_out = n_in if dv == INF_DEGREE else min(n_in, _as_int(dv))
        # Pascal matrix by recurrence (row i+1 from row i)
        B = _np.zeros((n_in, n_out))
        B[0, 0] = 1.0
        row = _np.zeros(n_out)
        row[0] = 1.0
        for i in range(1, n_in):
            new = alpha * row
            new[1:] += beta * row[: n_out - 1]
            B[i] = new
            row = new
        am = _np.moveaxis(a, v, -1)
        T = am @ B  # (..., n_out)
        if u is None:
            out = _np.moveaxis(T, -1, v)
            return TaylorPoly(b, _np.ascontiguousarray(out), degrees)
        # bilinear: column j also shifts the u axis by j
        du = degrees[u]
        u_in = a.shape[u]
        u_out = u_in + n_out - 1
        if du != INF_DEGREE:
            u_out = min(u_out, _as_int(du))
        # T axes: a-with-v-moved-to-last; locate u in that layout
        u_t = u if u < v else u - 1
        out_shape = list(T.shape)
        out_shape[u_t] = u_out
        out = _np.zeros(out_shape)
        for j in range(n_out):
            lo = j
            hi = min(u_out, j + u_in)
            if lo >= hi:
                break
            src = [slice(None)] * T.ndim
            src[-1] = j
            src[u_t] = slice(0, hi - lo)
            dst = [slice(None)] * T.ndim
            dst[-1] = j
            dst[u_t] = slice(lo, hi)
            out[tuple(dst)] = T[tuple(src)]
        out = _np.moveaxis(out, -1, v)
        return TaylorPoly(b, _np.ascontiguousarray(out), degrees)

    def evaluate_all_one(self):
        """Sum of all coefficients, as a host scalar (reference: 582-586)."""
        return self.backend.to_host(self.backend.sum_all(self.coeffs))

    # ------------------------------------------------------------------
    # arithmetic (reference: 854-1236)
    # ------------------------------------------------------------------
    def __add__(self, other: "TaylorPoly"):
        b = self.backend
        result_degrees = self.min_degrees_p1(other)
        a2, b2 = self._broadcast_with(other)
        a2 = a2._truncate_degrees_p1(result_degrees)
        b2 = b2._truncate_degrees_p1(result_degrees)
        hc = None
        if a2.host_const is not None and b2.host_const is not None:
            hc = a2.host_const + b2.host_const
        lin = _lin_add(a2, b2)
        c0 = _c0_of(a2, b2, lambda x, y: x + y)
        if _size(b2.coeffs_shape()) == 1:
            coeffs = _add_at_zero(b, a2.coeffs, b2.extract_constant())
            return TaylorPoly(b, coeffs, result_degrees, host_const=hc,
                              linear=lin, const0=c0)
        if _size(a2.coeffs_shape()) == 1:
            coeffs = _add_at_zero(b, b2.coeffs, a2.extract_constant())
            return TaylorPoly(b, coeffs, result_degrees, host_const=hc,
                              linear=lin, const0=c0)
        shape = a2._max_shape(b2)
        a2 = a2._truncate_degrees_p1(shape)
        b2 = b2._truncate_degrees_p1(shape)
        result = b.lincomb(shape, a2.coeffs, b2.coeffs)
        return TaylorPoly(b, result, result_degrees, host_const=hc,
                          linear=lin, const0=c0)

    def __sub__(self, other: "TaylorPoly"):
        b = self.backend
        result_degrees = self.min_degrees_p1(other)
        a2, b2 = self._broadcast_with(other)
        a2 = a2._truncate_degrees_p1(result_degrees)
        b2 = b2._truncate_degrees_p1(result_degrees)
        hc = None
        if a2.host_const is not None and b2.host_const is not None:
            hc = a2.host_const - b2.host_const
        lin = _lin_sub(a2, b2)
        c0 = _c0_of(a2, b2, lambda x, y: x - y)
        if _size(b2.coeffs_shape()) == 1:
            coeffs = _sub_at_zero(b, a2.coeffs, b2.extract_constant())
            return TaylorPoly(b, coeffs, result_degrees, host_const=hc,
                              linear=lin, const0=c0)
        if _size(a2.coeffs_shape()) == 1:
            coeffs = b.neg(_sub_at_zero(b, b2.coeffs, a2.extract_constant()))
            return TaylorPoly(b, coeffs, result_degrees, host_const=hc,
                              linear=lin, const0=c0)
        shape = a2._max_shape(b2)
        result = b.lincomb(shape, a2.coeffs, b2.coeffs, sub=True)
        return TaylorPoly(b, result, result_degrees, host_const=hc,
                          linear=lin, const0=c0)

    def __neg__(self):
        b = self.backend
        hc = -self.host_const if self.host_const is not None else None
        lin = None
        if self.linear is not None:
            c, m, v = self.linear
            lin = (-c, -m, v)
        return TaylorPoly(
            b, b.neg(self.coeffs), self.degrees_p1, host_const=hc, linear=lin,
            const0=-self.const0 if self.const0 is not None else None,
        )

    def __mul__(self, other: "TaylorPoly"):
        return self._mul(other)

    def _mul(self, other: "TaylorPoly", defer: bool = False):
        """``self * other``; with ``defer`` a product by a constant leaves
        its coefficients a ``Term`` (``mul_linear``'s sum makes them)."""
        b = self.backend
        degrees = self.min_degrees_p1(other)
        if self.is_zero() or other.is_zero():
            return TaylorPoly.zero_with(b, degrees)
        a2, b2 = self._broadcast_with(other)
        shape = a2._sum_shape(b2)
        a2 = a2._truncate_degrees_p1(degrees)
        b2 = b2._truncate_degrees_p1(degrees)
        if a2.is_one():
            return b2._with_degrees(degrees)
        if b2.is_one():
            return a2._with_degrees(degrees)
        hc = None
        if a2.host_const is not None and b2.host_const is not None:
            hc = a2.host_const * b2.host_const
        c0 = _c0_of(a2, b2, lambda x, y: x * y)
        scaled = ((lambda k, arr: Term(arr, b.shape(arr), left=k)) if defer
                  else b.mul)
        # constant fast paths (shape-based, reference: 1040-1047)
        ca = a2.extract_constant()
        if ca is not None:
            lin = None
            if b2.linear is not None and a2.host_const is not None:
                c, m, v = b2.linear
                lin = (a2.host_const * c, a2.host_const * m, v)
            coeffs = scaled(ca, b2.coeffs)
            return TaylorPoly(b, coeffs, degrees, host_const=hc, linear=lin,
                              const0=c0)
        cb = b2.extract_constant()
        if cb is not None:
            lin = None
            if a2.linear is not None and b2.host_const is not None:
                c, m, v = a2.linear
                lin = (b2.host_const * c, b2.host_const * m, v)
            coeffs = scaled(cb, a2.coeffs)
            return TaylorPoly(b, coeffs, degrees, host_const=hc, linear=lin,
                              const0=c0)
        # linear fast paths (reference: 1049-1061)
        la = a2.extract_linear()
        if la is not None:
            c, m, v = la
            s = list(b2.coeffs_shape())
            s[v] = int(min(degrees[v], s[v] + 1))
            return b2.mul_linear(c, m, v, s, degrees)
        lb = b2.extract_linear()
        if lb is not None:
            c, m, v = lb
            s = list(a2.coeffs_shape())
            s[v] = int(min(degrees[v], s[v] + 1))
            return a2.mul_linear(c, m, v, s, degrees)
        # general truncated Cauchy product
        result = b.conv_trunc(a2.coeffs, b2.coeffs, shape)
        return TaylorPoly(b, result, degrees, const0=c0)

    def mul_var(self, m, v: int, shape, degrees, defer: bool = False):
        """Multiply by m * x_v (reference: 589-608): ``self * m`` cut to
        ``shape`` at offset 1 along axis v of zeros(shape); with ``defer``
        the coefficients are left a ``Term``."""
        b = self.backend
        upper = min(shape[v] - 1, self.coeffs_shape()[v])
        pre = [0] * len(shape)
        pre[v] = 1
        term = Term(b.slice_axis(self.coeffs, v, 0, upper), tuple(shape),
                    tuple(pre), scale=m)
        return TaylorPoly(b, term if defer else b.lincomb(shape, term),
                          degrees, const0=b.scalar_cls.zero())

    def mul_linear(self, c, m, v: int, shape, degrees):
        """Multiply by c + m * x_v (reference: 611-623): ``mul_var`` plus
        ``self * c``, both left Terms that the sum's ``lincomb`` makes in
        one step.  ``__mul__`` takes a constant ``self`` first, so neither
        summand has a single coefficient (``__add__``'s paths that would
        read one)."""
        if c.is_zero():
            return self.mul_var(m, v, shape, degrees)
        return self.mul_var(m, v, shape, degrees, defer=True) + self._mul(
            TaylorPoly.from_scalar(self.backend, c), defer=True)

    def __truediv__(self, other: "TaylorPoly"):
        b = self.backend
        a2, b2 = self._broadcast_with(other)
        degrees = a2.min_degrees_p1(b2)
        a2 = a2._truncate_degrees_p1(degrees)
        b2 = b2._truncate_degrees_p1(degrees)
        if b2.is_one():
            return a2._with_degrees(degrees)
        hc = None
        if a2.host_const is not None and b2.host_const is not None:
            hc = a2.host_const / b2.host_const
        c0 = _c0_of(a2, b2, lambda x, y: x / y)
        cb = b2.extract_constant()
        if cb is not None:
            lin = None
            if a2.linear is not None and b2.host_const is not None:
                c, m, v = a2.linear
                lin = (c / b2.host_const, m / b2.host_const, v)
            coeffs = b.div(a2.coeffs, cb)
            return TaylorPoly(b, coeffs, degrees, host_const=hc, linear=lin,
                              const0=c0)
        n = len(degrees)
        a2 = a2.extend_to_dim(n, 1) if a2.ndim < n else a2
        b2 = b2.extend_to_dim(n, 1) if b2.ndim < n else b2
        sa, sb = a2.coeffs_shape(), b2.coeffs_shape()
        result_shape = list(degrees)
        for i in range(n):
            if sb[i] == 1:
                result_shape[i] = sa[i]
        result_shape = [_as_int(s) for s in result_shape]
        result = b.poly_div(a2.coeffs, b2.coeffs, result_shape)
        return TaylorPoly(b, result, degrees, const0=c0)

    def exp(self):
        """reference: 406-417."""
        b = self.backend
        if self.host_const is not None and self.is_constant():
            hc = self.host_const.exp()
            return TaylorPoly(
                b,
                b.reshape(b.exp_el(self.extract_constant()), self.coeffs_shape()),
                self.degrees_p1,
                host_const=hc,
            )
        me = self.extend_to_dim(len(self.degrees_p1), 1)
        shape = list(me.degrees_p1)
        cs = me.coeffs_shape()
        for i in range(len(shape)):
            if cs[i] == 1:
                shape[i] = 1
        shape = [_as_int(s) for s in shape]
        result = b.poly_exp(me.coeffs, shape)
        c0 = self.const0.exp() if self.const0 is not None else None
        return TaylorPoly(b, result, self.degrees_p1, const0=c0)

    def log(self):
        """reference: 419-430."""
        b = self.backend
        if self.host_const is not None and self.is_constant():
            hc = self.host_const.log()
            return TaylorPoly(
                b,
                b.reshape(b.log_el(self.extract_constant()), self.coeffs_shape()),
                self.degrees_p1,
                host_const=hc,
            )
        me = self.extend_to_dim(len(self.degrees_p1), 1)
        shape = list(me.degrees_p1)
        cs = me.coeffs_shape()
        for i in range(len(shape)):
            if cs[i] == 1:
                shape[i] = 1
        shape = [_as_int(s) for s in shape]
        result = b.poly_log(me.coeffs, shape)
        c0 = self.const0.log() if self.const0 is not None else None
        return TaylorPoly(b, result, self.degrees_p1, const0=c0)

    def pow(self, n: int):
        """Binary exponentiation (reference: 433-451)."""
        if n == 0:
            return TaylorPoly.one(self.backend)
        if n == 1:
            return self
        res = TaylorPoly.one(self.backend)
        base = self
        while n > 0:
            if n & 1:
                res = res * base
            base = base * base
            n >>= 1
        return res

    # ------------------------------------------------------------------
    def _with_degrees(self, degrees):
        return TaylorPoly(
            self.backend,
            self.coeffs,
            degrees,
            host_const=self.host_const,
            linear=self.linear,
            const0=self.const0,
        )

    def zero_pad(self, new_degrees_p1):
        """reference: 301-312 (extend degrees, insert trailing axes)."""
        b = self.backend
        assert all(
            a <= bb for a, bb in zip(self.degrees_p1, new_degrees_p1)
        )
        coeffs = self.coeffs
        nd = self.ndim
        if nd < len(new_degrees_p1):
            coeffs = b.reshape(
                coeffs,
                list(b.shape(coeffs)) + [1] * (len(new_degrees_p1) - nd),
            )
        return TaylorPoly(
            b, coeffs, new_degrees_p1, host_const=self.host_const,
            linear=self.linear, const0=self.const0,
        )

    def to_nested_host(self):
        """Materialize coefficients as nested lists of host scalars."""
        b = self.backend
        shape = self.coeffs_shape()

        def rec(arr, depth):
            if depth == len(shape):
                return b.to_host(arr)
            return [rec(b.index(arr, 0, i), depth + 1) for i in range(b.shape(arr)[0])]

        return rec(self.coeffs, 0)

    def __repr__(self):
        return f"TaylorPoly({list(self.degrees_p1)}, shape={list(self.coeffs_shape())})"


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _c0_of(a: "TaylorPoly", b: "TaylorPoly", op):
    if a.const0 is not None and b.const0 is not None:
        return op(a.const0, b.const0)
    return None


def _size(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


@functools.lru_cache(maxsize=8192)
def _falling_factors_f64(n: int, m: int):
    """Derivative scale factors n!..(n+k)!/k! as a cached numpy vector.

    Computed with the exact op sequence of the generic host-scalar loop
    (sequential IEEE mul/div) so the result is bit-identical to it; the
    profile showed the per-call scalar-wrapper loop costing millions of
    Python ops on observation-chain-heavy models (mixture: 10k calls x
    ~200 factors)."""
    ff = 1.0
    for i in range(1, n + 1):
        ff = ff * float(i)
    out = np.empty(m)
    for k in range(m):
        out[k] = ff
        ff = ff * float(n + k + 1) / float(k + 1)
    return out


def _power_factors_f64(m: float, count: int):
    """Diagonal-substitution powers 1, m, m^2, ... as a cached numpy
    vector (sequential IEEE muls, bit-identical to the scalar loop).

    Cache key is the bit pattern of m, not its float value: -0.0 == 0.0
    would share a slot (their power sequences differ in zero sign) and a
    NaN key would never hit its own entry (NaN != NaN), growing the
    cache by one dead entry per call."""
    return _power_factors_f64_bits(
        struct.pack("<d", m), count
    )


@functools.lru_cache(maxsize=8192)
def _power_factors_f64_bits(m_bits: bytes, count: int):
    m = struct.unpack("<d", m_bits)[0]
    out = np.empty(count)
    f = 1.0
    for k in range(count):
        out[k] = f
        f = f * m
    return out


@functools.lru_cache(maxsize=8192)
def _binom_factors_f64(n: int, m: int):
    """Coefficient-extraction (binomial) factors, cached; see
    _falling_factors_f64."""
    factor = 1.0
    out = np.empty(max(m, 1))
    out[0] = 1.0
    for k in range(1, m):
        factor = factor * float(n + k) / float(k)
        out[k] = factor
    return out[:m]


def _sat_sub(d, n):
    if d == INF_DEGREE:
        return INF_DEGREE
    return max(0, int(d) - n)


def _add_at_zero(b: Backend, arr, val0d):
    """arr with val added to the first element only (reference add constant
    fast path, 862-869)."""
    shape = b.shape(arr)
    if _size(shape) == 1:
        flat = b.reshape(arr, ())
        return b.reshape(b.add(flat, val0d), shape)
    first = arr
    for _ in range(len(shape)):
        first = b.index(first, 0, 0)
    new_first = b.add(first, val0d)
    return _set_first(b, arr, new_first)


def _sub_at_zero(b: Backend, arr, val0d):
    shape = b.shape(arr)
    if _size(shape) == 1:
        flat = b.reshape(arr, ())
        return b.reshape(b.sub(flat, val0d), shape)
    first = arr
    for _ in range(len(shape)):
        first = b.index(first, 0, 0)
    new_first = b.sub(first, val0d)
    return _set_first(b, arr, new_first)


def _set_first(b: Backend, arr, val0d):
    import numpy as _np

    from .host import ArrayIntervalBackend, IvArr, ObjectBackend

    shape = b.shape(arr)
    idx = (0,) * len(shape)
    if isinstance(b, ObjectBackend):
        out = arr.copy()
        out[idx] = val0d[()] if hasattr(val0d, "shape") else val0d
        return out
    # numpy arrays copy; torch tensors (TorchF64Backend) are rebuilt out
    # of place, the new first element before the rest of the flat tensor
    # (torch.func.vmap refuses a batched write into an unbatched tensor)
    if isinstance(b, ArrayIntervalBackend):
        if isinstance(arr.data, _np.ndarray):
            data = arr.data.copy()
            data[(slice(None),) + idx] = val0d.data
            return IvArr(data)
        return IvArr(_cat_first(arr.data.reshape(2, -1),
                                val0d.data.reshape(2, 1), 1)
                     .reshape(arr.data.shape))
    if isinstance(arr, _np.ndarray):
        out = arr.copy()
        out[idx] = val0d
        return out
    return _cat_first(arr.reshape(-1), val0d.reshape(1), 0).reshape(shape)


def _cat_first(flat, first, dim):
    """``flat`` with its first entry along ``dim`` replaced by ``first``."""
    import torch

    return torch.cat([first, flat.narrow(dim, 1, flat.shape[dim] - 1)],
                     dim=dim)


def _lin_add(a: TaylorPoly, b: TaylorPoly):
    """linear + const / linear + linear metadata propagation."""
    la, lb = a.linear, b.linear
    if la is not None and b.host_const is not None and b.is_constant():
        c, m, v = la
        return (c + b.host_const, m, v)
    if lb is not None and a.host_const is not None and a.is_constant():
        c, m, v = lb
        return (c + a.host_const, m, v)
    if la is not None and lb is not None and la[2] == lb[2]:
        return (la[0] + lb[0], la[1] + lb[1], la[2])
    return None


def _lin_sub(a: TaylorPoly, b: TaylorPoly):
    la, lb = a.linear, b.linear
    if la is not None and b.host_const is not None and b.is_constant():
        c, m, v = la
        return (c - b.host_const, m, v)
    if lb is not None and a.host_const is not None and a.is_constant():
        c, m, v = lb
        return (a.host_const - c, -m, v)
    if la is not None and lb is not None and la[2] == lb[2]:
        return (la[0] - lb[0], la[1] - lb[1], la[2])
    return None
