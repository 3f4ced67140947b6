"""Host-side scalar number tower.

This mirrors the reference's pluggable scalar arithmetic (reference:
src/number/number.rs:8-79 defines traits Number / FloatNumber /
IntervalNumber; concrete types live in src/number/{f64,big_float,
multi_precision,rational}.rs and src/interval.rs).

In the TPU-native design these scalars serve three purposes:

1. constants inside the generating-function DAG (always host values),
2. the printing / moment post-processing pipeline (tiny, host-only),
3. the object-array TensorPoly backend used for the exact modes
   (``--rational``, ``--precision``) that cannot run on TPU hardware.

The *fast* numeric paths (f64 and interval-of-f64 tensors) do NOT use these
classes element-wise; they use jnp arrays (see genfer_tpu_torch.taylor.host).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

from .format import format_f64

from .._host_build import load_extension

# GMP/MPFR-backed scalars (built by _host_build on first use); optional
_XO = load_extension("_exactops")


def _FRAC(n, d=None):
    """Make an exact rational value: GMP ``mpq`` when the native extension
    is available (reference uses rug::Rational, src/number/rational.rs:1-16),
    else ``fractions.Fraction``."""
    if _XO is not None:
        return _XO.mpq(n) if d is None else _XO.mpq(n, d)
    return Fraction(n) if d is None else Fraction(n, d)


__all__ = [
    "F64",
    "BigFloat",
    "Rational",
    "MultiPrec",
    "Interval",
    "set_precision",
    "get_precision",
]


# --------------------------------------------------------------------------
# shared default from_ratio (reference: src/number/number.rs:26-33)
# --------------------------------------------------------------------------

def _default_from_ratio(cls, numerator: int, denominator: int):
    two_to_32 = cls.from_u32(0xFFFF_FFFF) + cls.one()
    numer = cls.from_u32(numerator & 0xFFFF_FFFF) + cls.from_u32(numerator >> 32) * two_to_32
    denom = cls.from_u32(denominator & 0xFFFF_FFFF) + cls.from_u32(denominator >> 32) * two_to_32
    return numer / denom


class _NumberBase:
    """Mixin providing derived operations shared by every scalar type."""

    __slots__ = ()

    # True only for types whose + and * are exact (associativity holds
    # bit-for-bit); lets the GF smart constructors re-associate constant
    # products without perturbing rounding vs the reference eval order.
    EXACT_RING = False

    # -- derived (reference: number.rs:38-43) --
    def minimum(self, other):
        return -((-self).maximum(-other))

    def abs_(self):
        return self.maximum(self.zero())

    # reference: number.rs:59-77 (is_close / is_close_with)
    def is_close_with(self, other, rel_tol, abs_tol) -> bool:
        diff = (self - other).abs_()
        return bool(diff <= abs_tol) or bool(diff <= rel_tol * other.abs_())

    def is_close(self, other) -> bool:
        cls = type(self)
        return self.is_close_with(
            other,
            cls.from_ratio(1, 1_000_000_000),
            cls.from_ratio(1, 100_000_000),
        )

    @classmethod
    def from_ratio(cls, numerator: int, denominator: int):
        return _default_from_ratio(cls, numerator, denominator)

    def __sub__(self, other):
        return self + (-other)

    def __str__(self):
        return self.display()

    def __repr__(self):
        return f"{type(self).__name__}({self.display()})"


# --------------------------------------------------------------------------
# F64 (reference: src/number/f64.rs)
# --------------------------------------------------------------------------

class F64(_NumberBase):
    __slots__ = ("v",)

    def __init__(self, v: float):
        self.v = float(v)

    # constructors
    @classmethod
    def zero(cls):
        return cls(0.0)

    @classmethod
    def one(cls):
        return cls(1.0)

    @classmethod
    def from_u32(cls, n: int):
        return cls(float(n))

    @classmethod
    def from_ratio(cls, numerator: int, denominator: int):
        # reference: f64.rs:48-51 — plain double division
        if denominator == 0:
            return cls(math.inf if numerator > 0 else math.nan)
        return cls(float(numerator) / float(denominator))

    @classmethod
    def nan(cls):
        return cls(math.nan)

    @classmethod
    def infinity(cls):
        return cls(math.inf)

    # predicates
    def is_zero(self):
        return self.v == 0.0

    def is_one(self):
        return self.v == 1.0

    def is_finite(self):
        return math.isfinite(self.v)

    def is_nan(self):
        return math.isnan(self.v)

    def is_infinite(self):
        return math.isinf(self.v)

    # arithmetic
    def __add__(self, other):
        return F64(self.v + other.v)

    def __mul__(self, other):
        return F64(self.v * other.v)

    def __truediv__(self, other):
        if other.v == 0.0:
            # mimic IEEE division (Python raises)
            if self.v == 0.0 or math.isnan(self.v):
                return F64(math.nan)
            return F64(math.copysign(math.inf, self.v) * math.copysign(1.0, other.v))
        return F64(self.v / other.v)

    def __neg__(self):
        return F64(-self.v)

    def exp(self):
        try:
            return F64(math.exp(self.v))
        except OverflowError:
            return F64(math.inf)

    def log(self):
        v = self.v
        if v > 0.0:
            return F64(math.log(v))
        if v == 0.0:
            return F64(-math.inf)
        return F64(math.nan)

    def pow_u32(self, n: int):
        # f64::powi — overflows to +/-inf like Rust, where Python's
        # float ** raises OverflowError instead
        if self.v == 0.0 and n == 0:
            return F64(1.0)
        try:
            return F64(self.v ** n)
        except OverflowError:
            return F64(-math.inf if (self.v < 0.0 and n % 2) else math.inf)

    def sqrt(self):
        if self.v < 0.0:
            return F64(math.nan)
        return F64(math.sqrt(self.v))

    def maximum(self, other):
        # reference f64.rs max: `if self > other { self } else { other }`
        return self if self.v > other.v else other

    def minimum(self, other):
        return self if self.v < other.v else other

    def abs_(self):
        return F64(abs(self.v))

    # IntervalNumber (reference: f64.rs:124-172)
    def next_up(self):
        return F64(math.nextafter(self.v, math.inf))

    def next_down(self):
        return F64(math.nextafter(self.v, -math.inf))

    # comparisons
    def __eq__(self, other):
        return isinstance(other, F64) and self.v == other.v

    def __lt__(self, other):
        return self.v < other.v

    def __le__(self, other):
        return self.v <= other.v

    def __gt__(self, other):
        return self.v > other.v

    def __ge__(self, other):
        return self.v >= other.v

    def __hash__(self):
        return hash(("F64", self.v))

    def display(self) -> str:
        return format_f64(self.v)

    def to_float(self) -> float:
        return self.v


# --------------------------------------------------------------------------
# BigFloat: f64 mantissa + separate i64 exponent
# (reference: src/number/big_float.rs)
# --------------------------------------------------------------------------

def _extract_exponent(f: float) -> tuple[float, int]:
    """Extract power-of-two exponent; factor normalized into [1, 2).
    (reference: big_float.rs:24-43)"""
    if not math.isfinite(f) or f == 0.0:
        return f, 0
    m, e = math.frexp(f)  # m in [0.5, 1)
    return m * 2.0, e - 1


class BigFloat(_NumberBase):
    __slots__ = ("factor", "exponent")

    def __init__(self, factor: float, exponent: int = 0, _normalized: bool = False):
        if _normalized:
            self.factor = factor
            self.exponent = exponent
        else:
            f, e = _extract_exponent(float(factor))
            if f == 0.0:
                self.factor, self.exponent = 0.0, 0
            else:
                self.factor, self.exponent = f, e + exponent

    @classmethod
    def _norm(cls, factor: float, exponent: int):
        return cls(factor, exponent)

    @classmethod
    def zero(cls):
        return cls(0.0)

    @classmethod
    def one(cls):
        return cls(1.0)

    @classmethod
    def from_u32(cls, n: int):
        return cls(float(n))

    @classmethod
    def from_ratio(cls, numerator: int, denominator: int):
        # reference: big_float.rs:141-144
        return cls(float(numerator) / float(denominator)) if denominator else cls(math.inf)

    @classmethod
    def nan(cls):
        return cls(math.nan)

    @classmethod
    def infinity(cls):
        return cls(math.inf)

    def to_f64(self) -> float:
        try:
            return self.factor * math.pow(2.0, self.exponent)
        except OverflowError:
            return math.copysign(math.inf, self.factor)

    to_float = to_f64

    def is_zero(self):
        return self.factor == 0.0

    def is_one(self):
        return self.factor == 1.0 and self.exponent == 0

    def is_finite(self):
        return math.isfinite(self.factor)

    def is_nan(self):
        return math.isnan(self.factor)

    def is_infinite(self):
        return math.isinf(self.factor)

    def __add__(self, other):
        # reference: big_float.rs:263-277
        if self.exponent >= other.exponent:
            bigger, smaller = self, other
        else:
            bigger, smaller = other, self
        diff = smaller.exponent - bigger.exponent
        factor = bigger.factor + smaller.factor * _pow2(diff)
        return BigFloat(factor, bigger.exponent)

    def __mul__(self, other):
        return BigFloat(self.factor * other.factor, self.exponent + other.exponent)

    def __truediv__(self, other):
        if other.factor == 0.0:
            if self.factor == 0.0 or math.isnan(self.factor):
                return BigFloat(math.nan)
            return BigFloat(math.copysign(math.inf, self.factor))
        return BigFloat(self.factor / other.factor, self.exponent - other.exponent)

    def __neg__(self):
        return BigFloat(-self.factor, self.exponent, _normalized=True)

    def exp(self):
        # reference: big_float.rs:157-164 — base-2 decomposition
        exponent = self.factor * _pow2(self.exponent) * math.log2(math.e)
        if not math.isfinite(exponent):
            return BigFloat(math.exp(exponent) if exponent < 0 else math.inf)
        integer_exponent = int(exponent)
        correction = 2.0 ** (exponent - integer_exponent)
        return BigFloat(correction, integer_exponent)

    def log(self):
        if self.factor <= 0.0:
            return BigFloat(-math.inf if self.factor == 0.0 else math.nan)
        log2v = math.log2(self.factor) + self.exponent
        return BigFloat(log2v * math.log(2.0))

    def pow_u32(self, n: int):
        return BigFloat(self.factor**n, self.exponent * n)

    def sqrt(self):
        # reference: big_float.rs:216-225
        exponent = self.exponent // 2
        if self.exponent % 2 == 0:
            factor = math.sqrt(self.factor) if self.factor >= 0 else math.nan
        else:
            factor = math.sqrt(self.factor * 2.0) if self.factor >= 0 else math.nan
        return BigFloat(factor, exponent)

    def _cmp_key(self):
        return (self.exponent, self.factor)

    def __eq__(self, other):
        return (
            isinstance(other, BigFloat)
            and self.factor == other.factor
            and self.exponent == other.exponent
        )

    def __lt__(self, other):
        # reference: big_float.rs:127-138, extended to order non-finite
        # factors correctly (the exponent-first comparison misorders
        # infinities, which arise in interval division bounds)
        if not (math.isfinite(self.factor) and math.isfinite(other.factor)):
            return self.to_f64() < other.to_f64()
        if self.exponent == other.exponent or self.is_zero() or other.is_zero():
            if self.exponent == other.exponent:
                return self.factor < other.factor
            return self.to_f64() < other.to_f64()
        if (self.factor < 0.0) != (other.factor < 0.0):
            return self.factor < other.factor
        if self.factor < 0.0:
            return self.exponent > other.exponent
        return self.exponent < other.exponent

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        return not (self.is_nan() or other.is_nan()) and other < self

    def __ge__(self, other):
        return self == other or self > other

    def __hash__(self):
        return hash(("BigFloat", self.factor, self.exponent))

    def maximum(self, other):
        return self if self > other else other

    def minimum(self, other):
        return self if self < other else other

    def abs_(self):
        return BigFloat(abs(self.factor), self.exponent, _normalized=True)

    def next_up(self):
        return BigFloat(math.nextafter(self.factor, math.inf), self.exponent)

    def next_down(self):
        return BigFloat(math.nextafter(self.factor, -math.inf), self.exponent)

    def display(self) -> str:
        return format_f64(self.to_f64())


def _pow2(e: int) -> float:
    try:
        return math.pow(2.0, e)
    except OverflowError:
        return math.inf


# --------------------------------------------------------------------------
# Rational: exact rationals with specials (reference: src/number/rational.rs)
# --------------------------------------------------------------------------

_NAR = "NaR"
_POS_INF = "PosInf"
_NEG_INF = "NegInf"


class Rational(_NumberBase):
    __slots__ = ("frac", "special")

    EXACT_RING = True

    def __init__(self, frac, special: Optional[str] = None):
        # `frac` is an mpq when the native extension is loaded, else a
        # Fraction; a single representation per process keeps equality and
        # hashing coherent, so coerce stray Fractions here.
        if _XO is not None and type(frac) is Fraction:
            frac = _XO.mpq(frac)
        self.frac = frac
        self.special = special

    @classmethod
    def from_frac(cls, n, d=1):
        return cls(_FRAC(n, d))

    @classmethod
    def not_a_rational(cls):
        return cls(None, _NAR)

    @classmethod
    def infinity(cls):
        return cls(None, _POS_INF)

    @classmethod
    def neg_infinity(cls):
        return cls(None, _NEG_INF)

    nan = not_a_rational

    @classmethod
    def zero(cls):
        return cls(_FRAC(0))

    @classmethod
    def one(cls):
        return cls(_FRAC(1))

    @classmethod
    def from_u32(cls, n: int):
        return cls(_FRAC(n))

    @classmethod
    def from_ratio(cls, numerator: int, denominator: int):
        if denominator == 0:
            return cls.infinity() if numerator > 0 else cls.not_a_rational()
        return cls(_FRAC(numerator, denominator))

    def is_zero(self):
        return self.frac is not None and self.frac == 0

    def is_one(self):
        return self.frac is not None and self.frac == 1

    def is_finite(self):
        return self.frac is not None

    def is_nan(self):
        return self.special == _NAR

    def is_infinite(self):
        return self.special in (_POS_INF, _NEG_INF)

    # The object-array backend stores raw payloads (mpq/Fraction) and only
    # wraps specials in Rational; mixed payload/wrapper arithmetic lands
    # here via the reflected dunders, so coerce the other operand.
    @staticmethod
    def _coerce(other):
        return other if isinstance(other, Rational) else Rational(other)

    def __radd__(self, other):
        return Rational._coerce(other) + self

    def __rmul__(self, other):
        return Rational._coerce(other) * self

    def __rtruediv__(self, other):
        return Rational._coerce(other) / self

    def __rsub__(self, other):
        return Rational._coerce(other) + (-self)

    def __add__(self, other):
        # reference: rational.rs (Add impl)
        other = Rational._coerce(other)
        if self.frac is not None and other.frac is not None:
            return Rational(self.frac + other.frac)
        a, b = self.special, other.special
        if a == _NAR or b == _NAR:
            return Rational.not_a_rational()
        if (a == _POS_INF and b == _NEG_INF) or (a == _NEG_INF and b == _POS_INF):
            return Rational.not_a_rational()
        return Rational(None, a if a is not None else b)

    def __mul__(self, other):
        other = Rational._coerce(other)
        if self.frac is not None and other.frac is not None:
            return Rational(self.frac * other.frac)
        a, b = self.special, other.special
        if a == _NAR or b == _NAR:
            return Rational.not_a_rational()
        if a is not None and b is not None:
            if a == b:
                return Rational.infinity()
            return Rational.neg_infinity()
        inf, frac = (a, other.frac) if a is not None else (b, self.frac)
        if frac == 0:
            return Rational.not_a_rational()
        pos = (frac > 0) == (inf == _POS_INF)
        return Rational.infinity() if pos else Rational.neg_infinity()

    def __truediv__(self, other):
        # reference: rational.rs Div
        other = Rational._coerce(other)
        if self.frac is not None and other.frac is not None:
            if other.frac == 0:
                if self.frac == 0:
                    return Rational.not_a_rational()
                return Rational.infinity() if self.frac > 0 else Rational.neg_infinity()
            return Rational(self.frac / other.frac)
        a, b = self.special, other.special
        if a == _NAR or b == _NAR:
            return Rational.not_a_rational()
        if a is not None and b is not None:
            return Rational.not_a_rational()
        if a is not None:
            # inf / frac
            frac = other.frac
            if frac == 0:
                return Rational(None, a)
            pos = (frac > 0) == (a == _POS_INF)
            return Rational.infinity() if pos else Rational.neg_infinity()
        # frac / inf
        return Rational.zero()

    def __neg__(self):
        if self.frac is not None:
            return Rational(-self.frac)
        if self.special == _POS_INF:
            return Rational.neg_infinity()
        if self.special == _NEG_INF:
            return Rational.infinity()
        return Rational.not_a_rational()

    def exp(self):
        # reference: rational.rs:329-337
        if self.special == _NAR:
            return Rational.not_a_rational()
        if self.special == _NEG_INF:
            return Rational.zero()
        if self.special == _POS_INF:
            return Rational.infinity()
        if self.is_zero():
            return Rational.one()
        return Rational.not_a_rational()

    def log(self):
        if self.special in (_NAR, _NEG_INF):
            return Rational.not_a_rational()
        if self.special == _POS_INF:
            return Rational.infinity()
        if self.is_zero():
            return Rational.neg_infinity()
        if self.is_one():
            return Rational.zero()
        return Rational.not_a_rational()

    def pow_u32(self, n: int):
        if n == 0:
            return Rational.one()
        if n == 1:
            return self
        if self.special == _NAR:
            return Rational.not_a_rational()
        if self.special == _NEG_INF:
            return Rational.infinity() if n % 2 == 0 else Rational.neg_infinity()
        if self.special == _POS_INF:
            return Rational.infinity()
        return Rational(self.frac**n)

    def sqrt(self):
        # exact-or-NaR (reference: rational.rs:399-422)
        if self.special is not None:
            if self.special == _POS_INF:
                return Rational.infinity()
            return Rational.not_a_rational()
        if self.frac == 0:
            return Rational.zero()
        if self.frac < 0:
            return Rational.not_a_rational()
        if _XO is not None:
            r = self.frac.sqrt_exact()
            return Rational(r) if r is not None else Rational.not_a_rational()
        n, d = self.frac.numerator, self.frac.denominator
        sn, sd = math.isqrt(n), math.isqrt(d)
        if sn * sn == n and sd * sd == d:
            return Rational(Fraction(sn, sd))
        return Rational.not_a_rational()

    def _key(self):
        if self.frac is not None:
            return (0, self.frac)
        if self.special == _NEG_INF:
            return (-1, 0)
        if self.special == _POS_INF:
            return (1, 0)
        return None  # NaR: unordered

    def __eq__(self, other):
        if not isinstance(other, Rational):
            return NotImplemented
        if self.frac is not None and other.frac is not None:
            return self.frac == other.frac
        # NaR != NaR (reference: Special PartialEq)
        if self.special == _NAR or other.special == _NAR:
            return False
        return self.special == other.special

    def __lt__(self, other):
        a, b = self._key(), other._key()
        if a is None or b is None:
            return False
        if self.frac is not None and other.frac is not None:
            return self.frac < other.frac
        if a[0] != b[0]:
            return a[0] < b[0]
        if self.frac is not None:
            return b[0] == 1
        return False

    def __le__(self, other):
        if self.is_nan() or other.is_nan():
            return False
        return self == other or self < other

    def __gt__(self, other):
        if self.is_nan() or other.is_nan():
            return False
        return other < self

    def __ge__(self, other):
        if self.is_nan() or other.is_nan():
            return False
        return self == other or self > other

    def __hash__(self):
        return hash(("Rational", self.frac, self.special))

    def maximum(self, other):
        return self if self > other else other

    def minimum(self, other):
        return self if self < other else other

    def abs_(self):
        if self.frac is not None:
            return Rational(abs(self.frac))
        if self.special == _NAR:
            return Rational.not_a_rational()
        return Rational.infinity()

    # exact type: stepping is the identity (used by Interval.widen in
    # --bounds --rational mode, where no rounding occurs)
    def next_up(self):
        return self

    def next_down(self):
        return self

    def to_float(self) -> float:
        if self.frac is not None:
            return float(self.frac)
        if self.special == _POS_INF:
            return math.inf
        if self.special == _NEG_INF:
            return -math.inf
        return math.nan

    def display(self) -> str:
        if self.frac is not None:
            # str() of both Fraction and mpq is "p" or "p/q"; mpq formats
            # huge numerators via GMP (CPython int->str is quadratic)
            return str(self.frac)
        if self.special == _POS_INF:
            return "∞"
        if self.special == _NEG_INF:
            return "-∞"
        return "(not a rational)"


# --------------------------------------------------------------------------
# MultiPrec: arbitrary-precision binary floats via mpmath
# (reference: src/number/multi_precision.rs, which uses MPFR)
# --------------------------------------------------------------------------

_PRECISION_BITS: list[int] = [53]


def set_precision(bits: int) -> None:
    """Set the global precision (reference: multi_precision.rs:13-16 uses a
    set-once thread-local; we allow resetting for test convenience)."""
    import mpmath

    _PRECISION_BITS[0] = bits
    mpmath.mp.prec = bits
    if _XO is not None:
        _XO.set_precision(bits)


def get_precision() -> int:
    return _PRECISION_BITS[0]


class MultiPrec(_NumberBase):
    __slots__ = ("v",)

    def __init__(self, v):
        import mpmath

        self.v = mpmath.mpf(v) if not isinstance(v, mpmath.mpf) else v

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_u32(cls, n: int):
        return cls(n)

    @classmethod
    def from_ratio(cls, numerator: int, denominator: int):
        import mpmath

        if denominator == 0:
            return cls(mpmath.inf)
        return cls(mpmath.mpf(numerator) / mpmath.mpf(denominator))

    @classmethod
    def nan(cls):
        import mpmath

        return cls(mpmath.nan)

    @classmethod
    def infinity(cls):
        import mpmath

        return cls(mpmath.inf)

    def is_zero(self):
        return self.v == 0

    def is_one(self):
        return self.v == 1

    def is_finite(self):
        import mpmath

        return mpmath.isfinite(self.v)

    def is_nan(self):
        import mpmath

        return mpmath.isnan(self.v)

    def is_infinite(self):
        import mpmath

        return mpmath.isinf(self.v)

    def __add__(self, other):
        return MultiPrec(self.v + other.v)

    def __mul__(self, other):
        return MultiPrec(self.v * other.v)

    def __truediv__(self, other):
        import mpmath

        if other.v == 0:
            if self.v == 0:
                return MultiPrec(mpmath.nan)
            return MultiPrec(mpmath.inf if self.v > 0 else mpmath.ninf)
        return MultiPrec(self.v / other.v)

    def __neg__(self):
        return MultiPrec(-self.v)

    def exp(self):
        import mpmath

        return MultiPrec(mpmath.exp(self.v))

    def log(self):
        import mpmath

        if self.v == 0:
            return MultiPrec(mpmath.ninf)
        if self.v < 0:
            return MultiPrec(mpmath.nan)
        return MultiPrec(mpmath.log(self.v))

    def pow_u32(self, n: int):
        return MultiPrec(self.v**n)

    def sqrt(self):
        import mpmath

        if self.v < 0:
            return MultiPrec(mpmath.nan)
        return MultiPrec(mpmath.sqrt(self.v))

    def maximum(self, other):
        return self if self.v > other.v else other

    def minimum(self, other):
        return self if self.v < other.v else other

    def abs_(self):
        return MultiPrec(abs(self.v))

    def next_up(self):
        return MultiPrec(_mp_nextafter(self.v, +1))

    def next_down(self):
        return MultiPrec(_mp_nextafter(self.v, -1))

    def __eq__(self, other):
        return isinstance(other, MultiPrec) and self.v == other.v

    def __lt__(self, other):
        return self.v < other.v

    def __le__(self, other):
        return self.v <= other.v

    def __gt__(self, other):
        return self.v > other.v

    def __ge__(self, other):
        return self.v >= other.v

    def __hash__(self):
        return hash(("MultiPrec", self.v))

    def to_float(self) -> float:
        return float(self.v)

    def display(self) -> str:
        import mpmath

        if mpmath.isnan(self.v):
            return "NaN"
        if mpmath.isinf(self.v):
            return "inf" if self.v > 0 else "-inf"
        digits = max(1, int(get_precision() * 0.30103) + 1)
        return mpmath.nstr(self.v, digits, strip_zeros=True)


class _MultiPrecMpfr(_NumberBase):
    """MPFR-backed arbitrary-precision float (native _exactops extension);
    drop-in for the mpmath-backed MultiPrec above and ~50x faster, matching
    the reference's rug::Float (src/number/multi_precision.rs)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v if type(v) is _XO.mpfr else _XO.mpfr(v)

    @classmethod
    def zero(cls):
        return cls(_XO.mpfr(0))

    @classmethod
    def one(cls):
        return cls(_XO.mpfr(1))

    @classmethod
    def from_u32(cls, n: int):
        return cls(_XO.mpfr(n))

    @classmethod
    def from_ratio(cls, numerator: int, denominator: int):
        if denominator == 0:
            return cls(_XO.mpfr(math.inf))
        # one correctly-rounded conversion of the exact ratio
        return cls(_XO.mpfr(_XO.mpq(numerator, denominator)))

    @classmethod
    def nan(cls):
        return cls(_XO.mpfr(math.nan))

    @classmethod
    def infinity(cls):
        return cls(_XO.mpfr(math.inf))

    def is_zero(self):
        return self.v == 0

    def is_one(self):
        return self.v == 1

    def is_finite(self):
        return self.v.is_finite()

    def is_nan(self):
        return self.v.is_nan()

    def is_infinite(self):
        return self.v.is_inf()

    def __add__(self, other):
        return _MultiPrecMpfr(self.v + other.v)

    def __mul__(self, other):
        return _MultiPrecMpfr(self.v * other.v)

    def __truediv__(self, other):
        if other.v == 0:
            if self.v == 0:
                return _MultiPrecMpfr(_XO.mpfr(math.nan))
            return _MultiPrecMpfr(
                _XO.mpfr(math.inf if self.v > 0 else -math.inf)
            )
        return _MultiPrecMpfr(self.v / other.v)

    def __neg__(self):
        return _MultiPrecMpfr(-self.v)

    def exp(self):
        return _MultiPrecMpfr(self.v.exp())

    def log(self):
        return _MultiPrecMpfr(self.v.log())

    def pow_u32(self, n: int):
        return _MultiPrecMpfr(self.v**n)

    def sqrt(self):
        return _MultiPrecMpfr(self.v.sqrt())

    def maximum(self, other):
        return self if self.v > other.v else other

    def minimum(self, other):
        return self if self.v < other.v else other

    def abs_(self):
        return _MultiPrecMpfr(abs(self.v))

    def next_up(self):
        return _MultiPrecMpfr(self.v.next_up())

    def next_down(self):
        return _MultiPrecMpfr(self.v.next_down())

    def __eq__(self, other):
        return isinstance(other, _MultiPrecMpfr) and self.v == other.v

    def __lt__(self, other):
        return self.v < other.v

    def __le__(self, other):
        return self.v <= other.v

    def __gt__(self, other):
        return self.v > other.v

    def __ge__(self, other):
        return self.v >= other.v

    def __hash__(self):
        return hash(("MultiPrec", self.v))

    def to_float(self) -> float:
        return float(self.v)

    def display(self) -> str:
        digits = max(1, int(get_precision() * 0.30103) + 1)
        return self.v.digits(digits)


_MultiPrecMpmath = MultiPrec
if _XO is not None:
    MultiPrec = _MultiPrecMpfr


def _mp_nextafter(x, direction: int):
    """One-ULP step at the current global precision."""
    import mpmath

    if mpmath.isnan(x) or mpmath.isinf(x):
        return x
    prec = mpmath.mp.prec
    if x == 0:
        tiny = mpmath.mpf(2) ** (-(1 << 20))
        return tiny if direction > 0 else -tiny
    ulp = mpmath.mpf(2) ** (mpmath.mag(x) - prec)
    return x + ulp if direction > 0 else x - ulp


# --------------------------------------------------------------------------
# Interval arithmetic with outward rounding (reference: src/interval.rs)
# --------------------------------------------------------------------------

class Interval(_NumberBase):
    """Error-bound arithmetic: every operation computes with the underlying
    rounding and then widens both endpoints by one ULP
    (reference: interval.rs:29-31 ``widen``)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi

    # -- constructors -------------------------------------------------
    @classmethod
    def exact(cls, lo, hi):
        return cls(lo, hi)

    @classmethod
    def precisely(cls, x):
        return cls(x, x)

    @classmethod
    def widen(cls, lo, hi):
        return cls(lo.next_down(), hi.next_up())

    # The scalar-class context: Interval is generic over the element type;
    # classmethod constructors require a bound element class.  We provide a
    # small factory producing a bound subclass.
    _elem = F64

    @classmethod
    def over(cls, elem_cls):
        name = f"Interval_{elem_cls.__name__}"
        sub = _INTERVAL_CACHE.get(name)
        if sub is None:
            sub = type(name, (cls,), {"_elem": elem_cls, "__slots__": ()})
            _INTERVAL_CACHE[name] = sub
        return sub

    @classmethod
    def zero(cls):
        return cls(cls._elem.zero(), cls._elem.zero())

    @classmethod
    def one(cls):
        return cls(cls._elem.one(), cls._elem.one())

    @classmethod
    def from_u32(cls, n: int):
        x = cls._elem.from_u32(n)
        return cls(x, x)

    # from_ratio: default trait impl over interval ops (widens), matching
    # the reference which does not override it for Interval<T>.

    @classmethod
    def nan(cls):
        return cls(cls._elem.nan(), cls._elem.nan())

    @classmethod
    def infinity(cls):
        return cls(cls._elem.infinity(), cls._elem.infinity())

    # -- predicates ----------------------------------------------------
    def is_zero(self):
        return self.lo.is_zero() and self.hi.is_zero()

    def is_one(self):
        return self.lo.is_one() and self.hi.is_one()

    def is_finite(self):
        return self.lo.is_finite() and self.hi.is_finite()

    def is_nan(self):
        return self.lo.is_nan() or self.hi.is_nan()

    def is_infinite(self):
        return self.lo.is_infinite() or self.hi.is_infinite()

    def contains(self, x) -> bool:
        return bool(self.lo <= x) and bool(x <= self.hi)

    def union(self, x):
        return type(self)(self.lo.minimum(x), self.hi.maximum(x))

    def extract_point(self):
        return self.lo if self.lo == self.hi else None

    def center(self):
        return (self.lo + self.hi) / self._elem.from_u32(2)

    def ensure_lower_bound(self, new_lo):
        if self.lo < new_lo:
            return type(self)(new_lo, self.hi)
        return self

    def ensure_upper_bound(self, new_hi):
        if self.hi > new_hi:
            return type(self)(self.lo, new_hi)
        return self

    # -- arithmetic (reference: interval.rs:117-241) -------------------
    def __add__(self, other):
        if self.is_zero():
            return other
        if other.is_zero():
            return self
        return type(self).widen(self.lo + other.lo, self.hi + other.hi)

    def __neg__(self):
        return type(self)(-self.hi, -self.lo)

    def __mul__(self, other):
        cls = type(self)
        if (self.is_zero() and other.is_finite()) or (self.is_finite() and other.is_zero()):
            return cls.zero()
        if self.is_one():
            return other
        if other.is_one():
            return self
        if (-self).is_one():
            return -other
        if (-other).is_one():
            return -self
        a = self.lo * other.lo
        b = self.lo * other.hi
        c = self.hi * other.lo
        d = self.hi * other.hi
        lo = a.minimum(b).minimum(c).minimum(d)
        hi = a.maximum(b).maximum(c).maximum(d)
        return cls.widen(lo, hi)

    def __truediv__(self, other):
        cls = type(self)
        if self.is_nan() or other.is_nan():
            return cls.nan()
        if self.is_zero() and not other.is_zero():
            return self
        if other.is_one():
            return self
        elem = cls._elem
        lo, hi = elem.infinity(), -elem.infinity()
        zero = elem.zero()
        if other.contains(zero):
            if zero <= self.lo:
                hi = elem.infinity()
            else:
                lo = -elem.infinity()
            if self.hi <= zero:
                lo = -elem.infinity()
            else:
                hi = elem.infinity()
        a = self.lo / other.lo
        b = self.lo / other.hi
        c = self.hi / other.lo
        d = self.hi / other.hi
        lo = lo.minimum(a).minimum(b).minimum(c).minimum(d)
        hi = hi.maximum(a).maximum(b).maximum(c).maximum(d)
        return cls.widen(lo, hi)

    def exp(self):
        if self.is_zero():
            return type(self).one()
        return type(self).widen(self.lo.exp(), self.hi.exp())

    def log(self):
        if self.is_one():
            return type(self).zero()
        return type(self).widen(self.lo.log(), self.hi.log())

    def pow_u32(self, n: int):
        cls = type(self)
        result = cls.widen(self.lo.pow_u32(n), self.hi.pow_u32(n))
        if self.contains(cls._elem.zero()):
            return result.union(cls._elem.zero())
        return result

    def sqrt(self):
        cls = type(self)
        elem = cls._elem
        lo = elem.zero() if self.lo < elem.zero() else self.lo.sqrt()
        return cls.widen(lo, self.hi.sqrt())

    def maximum(self, other):
        return type(self)(self.lo.maximum(other.lo), self.hi.maximum(other.hi))

    def minimum(self, other):
        return type(self)(self.lo.minimum(other.lo), self.hi.minimum(other.hi))

    def abs_(self):
        cls = type(self)
        result = cls.widen(self.lo.abs_(), self.hi.abs_())
        if self.contains(cls._elem.zero()):
            return result.union(cls._elem.zero())
        return result

    # -- partial order (reference: interval.rs:249-261) ----------------
    def __eq__(self, other):
        return (
            isinstance(other, Interval)
            and self.lo == other.lo
            and self.hi == other.hi
        )

    def __lt__(self, other):
        if self == other:
            return False
        return bool(self.hi <= other.lo)

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        if self == other:
            return False
        return bool(self.lo >= other.hi)

    def __ge__(self, other):
        return self == other or self > other

    def __hash__(self):
        return hash(("Interval", self.lo, self.hi))

    def to_float(self) -> float:
        return self.center().to_float()

    def display(self) -> str:
        return f"[{self.lo.display()}, {self.hi.display()}]"


_INTERVAL_CACHE: dict[str, type] = {}
