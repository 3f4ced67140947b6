"""Abstract domain for variable supports (reference: src/support.rs and
the VarSupport product domain from src/semantics/support.rs:8-146).

A support set is Empty, an integer range {start..end} (end may be None =
unbounded), or a rational interval [start, end] for continuous variables.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

_INF = None  # unbounded end marker for rational intervals uses Fraction/inf


class SupportSet:
    __slots__ = ("kind", "start", "end")

    EMPTY = "empty"
    RANGE = "range"
    INTERVAL = "interval"

    def __init__(self, kind, start=0, end=None):
        self.kind = kind
        self.start = start
        self.end = end  # None = unbounded (RANGE) / math.inf-like (INTERVAL)

    # -- constructors --------------------------------------------------
    @staticmethod
    def empty():
        return SupportSet(SupportSet.EMPTY)

    @staticmethod
    def zero():
        return SupportSet.point(0)

    @staticmethod
    def point(x: int):
        return SupportSet(SupportSet.RANGE, x, x)

    @staticmethod
    def naturals():
        return SupportSet(SupportSet.RANGE, 0, None)

    @staticmethod
    def range_incl(start: int, end: int):
        if start > end:
            return SupportSet.empty()
        return SupportSet(SupportSet.RANGE, start, end)

    @staticmethod
    def range_excl(start: int, end: int):
        if end <= start:
            return SupportSet.empty()
        return SupportSet(SupportSet.RANGE, start, end - 1)

    @staticmethod
    def range_from(start: int):
        return SupportSet(SupportSet.RANGE, start, None)

    @staticmethod
    def interval(start: Fraction, end) -> "SupportSet":
        if end is not None and start > end:
            return SupportSet.empty()
        return SupportSet(SupportSet.INTERVAL, start, end)

    @staticmethod
    def interval_ratio(start, end) -> "SupportSet":
        s = Fraction(start.numer, start.denom)
        e = None if end.denom == 0 else Fraction(end.numer, end.denom)
        return SupportSet.interval(s, e)

    @staticmethod
    def nonneg_reals():
        return SupportSet.interval(Fraction(0), None)

    # -- predicates ----------------------------------------------------
    def is_empty(self):
        return self.kind == SupportSet.EMPTY

    def is_zero_point(self):
        return self.kind == SupportSet.RANGE and self.start == 0 and self.end == 0

    def is_discrete(self):
        return self.kind in (SupportSet.EMPTY, SupportSet.RANGE)

    def finite_nonempty_range(self) -> Optional[range]:
        if self.kind != SupportSet.RANGE or self.end is None:
            return None
        return range(self.start, self.end + 1)

    def contains(self, i: int) -> bool:
        if self.kind == SupportSet.EMPTY:
            return False
        if self.kind == SupportSet.RANGE:
            return i >= self.start and (self.end is None or i <= self.end)
        return self.start <= i and (self.end is None or i <= self.end)

    def __eq__(self, other):
        return (
            isinstance(other, SupportSet)
            and self.kind == other.kind
            and self.start == other.start
            and self.end == other.end
        )

    def __hash__(self):
        return hash((self.kind, self.start, self.end))

    # -- lattice / arithmetic (reference: support.rs:57-126, 372-518) ---
    def join(self, other: "SupportSet") -> "SupportSet":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        if self.kind == SupportSet.RANGE and other.kind == SupportSet.RANGE:
            end = None
            if self.end is not None and other.end is not None:
                end = max(self.end, other.end)
            return SupportSet(SupportSet.RANGE, min(self.start, other.start), end)
        a, b = self._as_interval(), other._as_interval()
        end = None if a[1] is None or b[1] is None else max(a[1], b[1])
        return SupportSet(SupportSet.INTERVAL, min(a[0], b[0]), end)

    def _as_interval(self):
        if self.kind == SupportSet.RANGE:
            return (
                Fraction(self.start),
                None if self.end is None else Fraction(self.end),
            )
        return (self.start, self.end)

    def saturating_sub(self, n: int) -> "SupportSet":
        if self.is_empty():
            return self
        if self.kind == SupportSet.RANGE:
            return SupportSet(
                SupportSet.RANGE,
                max(0, self.start - n),
                None if self.end is None else max(0, self.end - n),
            )
        return SupportSet(
            SupportSet.INTERVAL,
            max(Fraction(0), self.start - n),
            None if self.end is None else max(Fraction(0), self.end - n),
        )

    def __add__(self, other: "SupportSet") -> "SupportSet":
        # Minkowski sum (reference: support.rs:372-431)
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        if self.kind == SupportSet.RANGE and other.kind == SupportSet.RANGE:
            end = None
            if self.end is not None and other.end is not None:
                end = self.end + other.end
            return SupportSet(SupportSet.RANGE, self.start + other.start, end)
        a, b = self._as_interval(), other._as_interval()
        end = None if a[1] is None or b[1] is None else a[1] + b[1]
        return SupportSet(SupportSet.INTERVAL, a[0] + b[0], end)

    def mul_const(self, n: int) -> "SupportSet":
        if self.is_empty():
            return self
        if self.kind == SupportSet.RANGE:
            return SupportSet(
                SupportSet.RANGE,
                self.start * n,
                None if self.end is None else self.end * n,
            )
        return SupportSet(
            SupportSet.INTERVAL,
            self.start * n,
            None if self.end is None else self.end * n,
        )

    def __mul__(self, other: "SupportSet") -> "SupportSet":
        if self.is_zero_point() or other.is_zero_point():
            return SupportSet.point(0)
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        if self.kind == SupportSet.RANGE and other.kind == SupportSet.RANGE:
            end = None
            if self.end is not None and other.end is not None:
                end = self.end * other.end
            return SupportSet(SupportSet.RANGE, self.start * other.start, end)
        a, b = self._as_interval(), other._as_interval()
        end = None if a[1] is None or b[1] is None else a[1] * b[1]
        return SupportSet(SupportSet.INTERVAL, a[0] * b[0], end)

    def is_subset_of(self, other: "SupportSet") -> bool:
        if self.is_empty():
            return True
        if other.is_empty():
            return False
        if self.kind == SupportSet.INTERVAL and other.kind == SupportSet.RANGE:
            return False
        if self.kind == SupportSet.RANGE and other.kind == SupportSet.RANGE:
            if self.start < other.start:
                return False
            if other.end is None:
                return True
            return self.end is not None and self.end <= other.end
        a, b = self._as_interval(), other._as_interval()
        if a[0] < b[0]:
            return False
        if b[1] is None:
            return True
        return a[1] is not None and a[1] <= b[1]

    def retain_only(self, values) -> "SupportSet":
        """Refine to the given integer values (reference: support.rs:190-219)."""
        values = sorted(values)
        if self.kind != SupportSet.RANGE:
            return self
        new_start = new_end = None
        for v in values:
            if self.start <= v and (self.end is None or v <= self.end):
                if new_start is None:
                    new_start = v
                new_end = v
        if new_start is None:
            return SupportSet.empty()
        return SupportSet(SupportSet.RANGE, new_start, new_end)

    def remove_all(self, values) -> "SupportSet":
        """Remove the given integer values, staying a range
        (reference: support.rs:221-257)."""
        if self.kind != SupportSet.RANGE:
            return self
        values = sorted(values)
        start, end = self.start, self.end
        for v in values:
            if v == start:
                start = v + 1
        if end is not None:
            for v in reversed(values):
                if v == end:
                    if v == 0:
                        return SupportSet.empty()
                    end = v - 1
        if end is not None and start > end:
            return SupportSet.empty()
        return SupportSet(SupportSet.RANGE, start, end)

    def to_interval_scalar(self, IV):
        """Convert to a host Interval scalar of the given bound class
        (reference: support.rs:259-278)."""
        T = IV._elem
        if self.is_empty():
            return None
        if self.kind == SupportSet.RANGE:
            lo = T.from_u32(self.start)
            hi = T.infinity() if self.end is None else T.from_u32(self.end)
            return IV.exact(lo, hi)
        lo = T.from_ratio(self.start.numerator, self.start.denominator)
        if self.end is None:
            hi = T.infinity()
        else:
            hi = T.from_ratio(self.end.numerator, self.end.denominator)
        return IV.exact(lo, hi)

    def __str__(self):
        if self.kind == SupportSet.EMPTY:
            return "∅"
        if self.kind == SupportSet.RANGE:
            if self.end is not None:
                if self.start == self.end:
                    return f"{{{self.start}}}"
                return f"{{{self.start}, ..., {self.end}}}"
            return f"{{{self.start}, ...}}"
        start = _fmt_frac(self.start)
        if self.end is None:
            return f"[{start}, ∞)"
        return f"[{start}, {_fmt_frac(self.end)}]"

    __repr__ = __str__


def _fmt_frac(f: Fraction) -> str:
    if f.denominator == 1:
        return str(f.numerator)
    return f"{f.numerator}/{f.denominator}"


class VarSupport:
    """Product domain over variables, normalized to Empty if any component
    is empty (reference: semantics/support.rs:8-146)."""

    __slots__ = ("empty_len", "supports")

    def __init__(self, supports=None, empty_len=None):
        if supports is not None:
            self.supports = list(supports)
            self.empty_len = None
            self._normalize()
        else:
            self.supports = None
            self.empty_len = empty_len

    @staticmethod
    def empty(num_vars: int) -> "VarSupport":
        return VarSupport(empty_len=num_vars)

    @classmethod
    def _trusted(cls, supports: list) -> "VarSupport":
        """Construct from components known non-empty (clone/join of
        already-normalized domains) without the O(num_vars) rescan —
        the rescan per construction made the transformer quadratic-ish
        on many-variable programs (digitRecognition: 794 vars)."""
        vs = cls.__new__(cls)
        vs.supports = supports
        vs.empty_len = None
        return vs

    @staticmethod
    def zero(count: int) -> "VarSupport":
        return VarSupport([SupportSet.zero() for _ in range(count)])

    def is_empty(self) -> bool:
        return self.supports is None

    def _normalize(self):
        if self.supports is not None and any(s.is_empty() for s in self.supports):
            self.empty_len = len(self.supports)
            self.supports = None

    def num_vars(self) -> int:
        if self.supports is None:
            return self.empty_len
        return len(self.supports)

    def __getitem__(self, v: int) -> SupportSet:
        if self.supports is None:
            return SupportSet.empty()
        return self.supports[v]

    def push(self, support: SupportSet):
        if self.supports is None:
            self.empty_len += 1
        else:
            self.supports.append(support)

    def set(self, v: int, new: SupportSet):
        self.update(v, lambda _: new)

    def update(self, v: int, f):
        if self.supports is not None:
            new = f(self.supports[v])
            self.supports[v] = new
            # only the changed component can introduce emptiness
            if new.is_empty():
                self.empty_len = len(self.supports)
                self.supports = None

    def clone(self) -> "VarSupport":
        if self.supports is None:
            return VarSupport.empty(self.empty_len)
        return VarSupport._trusted(list(self.supports))

    def join(self, other: "VarSupport") -> "VarSupport":
        if self.supports is None:
            return other.clone()
        if other.supports is None:
            return self.clone()
        assert len(self.supports) == len(other.supports)
        # unions of non-empty components are non-empty
        return VarSupport._trusted(
            [a.join(b) for a, b in zip(self.supports, other.supports)]
        )

    def is_subset_of(self, other: "VarSupport") -> bool:
        if self.supports is None:
            return True
        if other.supports is None:
            return False
        return all(
            a.is_subset_of(b) for a, b in zip(self.supports, other.supports)
        )

    def __eq__(self, other):
        if not isinstance(other, VarSupport):
            return NotImplemented
        if self.supports is None or other.supports is None:
            return (self.supports is None) == (other.supports is None)
        return self.supports == other.supports

    def __str__(self):
        if self.supports is None:
            return "empty"
        return ", ".join(str(s) for s in self.supports)

    __repr__ = __str__
