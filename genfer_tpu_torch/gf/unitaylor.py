"""Univariate truncated Taylor expansions, generic over the coefficient
type (reference: src/univariate_taylor.rs).

Crucially instantiated both at host scalars (the ``--symbolic`` extraction
path evaluates a closed-form expression over these Taylor numbers,
reference symbolic.rs:238-299) and at symbolic expressions themselves
(``taylor_coeffs`` produces a Taylor series whose coefficients are
SymGenFun nodes, reference symbolic.rs:788-841).
"""

from __future__ import annotations

from typing import Sequence


class TaylorExpansion:
    """Constant(x) or Polynomial([c0..cn]) (reference:
    univariate_taylor.rs:9-13)."""

    __slots__ = ("coeffs", "const", "ecls")

    def __init__(self, ecls, const=None, coeffs=None):
        self.ecls = ecls  # element "class": zero()/one()/from_u32()
        self.const = const
        self.coeffs = coeffs

    # -- constructors ---------------------------------------------------
    @staticmethod
    def constant(x, ecls=None):
        return TaylorExpansion(ecls or type(x), const=x)

    @staticmethod
    def var(x, order: int, ecls=None):
        ecls = ecls or type(x)
        coeffs = [ecls.zero() for _ in range(order + 1)]
        if len(coeffs) > 1:
            coeffs[1] = ecls.one()
        coeffs[0] = x
        return TaylorExpansion(ecls, coeffs=coeffs)

    @staticmethod
    def from_coefficients(coeffs: Sequence, ecls=None):
        coeffs = list(coeffs)
        return TaylorExpansion(ecls or type(coeffs[0]), coeffs=coeffs)

    def zero_like(self):
        return TaylorExpansion(self.ecls, const=self.ecls.zero())

    def one_like(self):
        return TaylorExpansion(self.ecls, const=self.ecls.one())

    # -- accessors ------------------------------------------------------
    def is_constant(self):
        return self.coeffs is None

    def coeff(self, order: int):
        if self.coeffs is not None:
            return self.coeffs[order]
        if order == 0:
            return self.const
        return self.ecls.zero()

    def derivative_at0(self, order: int):
        """order-th derivative (coefficient times order!)."""
        if self.coeffs is None:
            return self.const if order == 0 else self.ecls.zero()
        f = self.ecls.one()
        for i in range(1, order + 1):
            f = f * self.ecls.from_u32(i)
        return f * self.coeffs[order]

    def taylor_expansion_of_coeff(self, n: int):
        """reference: univariate_taylor.rs:69-89."""
        if self.coeffs is None:
            if n == 0:
                return TaylorExpansion(self.ecls, const=self.const.exp())
            return self.zero_like()
        res = list(self.coeffs[n:])
        factor = self.ecls.one()
        for k in range(1, len(res)):
            factor = factor * self.ecls.from_u32(n + k) / self.ecls.from_u32(k)
            res[k] = res[k] * factor
        return TaylorExpansion(self.ecls, coeffs=res)

    def subst(self, subst: "TaylorExpansion"):
        """Horner composition (reference: univariate_taylor.rs:93-115)."""
        if self.coeffs is None:
            return self
        res = self.zero_like()
        for c in reversed(self.coeffs):
            res = res * subst + TaylorExpansion(self.ecls, const=c)
        return res

    # -- predicates -----------------------------------------------------
    def is_zero(self):
        return self.coeffs is None and self.const.is_zero()

    def is_one(self):
        return self.coeffs is None and self.const.is_one()

    # -- arithmetic (reference: univariate_taylor.rs:268-445) -----------
    def __add__(self, other: "TaylorExpansion"):
        if other.coeffs is None:
            if self.coeffs is None:
                return TaylorExpansion(self.ecls, const=self.const + other.const)
            out = list(self.coeffs)
            out[0] = out[0] + other.const
            return TaylorExpansion(self.ecls, coeffs=out)
        if self.coeffs is None:
            out = list(other.coeffs)
            out[0] = out[0] + self.const
            return TaylorExpansion(self.ecls, coeffs=out)
        order = min(len(self.coeffs), len(other.coeffs))
        return TaylorExpansion(
            self.ecls,
            coeffs=[self.coeffs[i] + other.coeffs[i] for i in range(order)],
        )

    def __neg__(self):
        if self.coeffs is None:
            return TaylorExpansion(self.ecls, const=-self.const)
        return TaylorExpansion(self.ecls, coeffs=[-c for c in self.coeffs])

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other: "TaylorExpansion"):
        if self.coeffs is None and other.coeffs is None:
            return TaylorExpansion(self.ecls, const=self.const * other.const)
        if self.coeffs is None:
            return TaylorExpansion(
                self.ecls, coeffs=[c * self.const for c in other.coeffs]
            )
        if other.coeffs is None:
            return TaylorExpansion(
                self.ecls, coeffs=[c * other.const for c in self.coeffs]
            )
        us, ws = self.coeffs, other.coeffs
        order = min(len(us), len(ws))
        zero = self.ecls.zero()
        out = []
        for k in range(order):
            s = zero
            for j in range(k + 1):
                s = s + us[j] * ws[k - j]
            out.append(s)
        return TaylorExpansion(self.ecls, coeffs=out)

    def __truediv__(self, other: "TaylorExpansion"):
        ecls = self.ecls
        if self.coeffs is None and other.coeffs is None:
            return TaylorExpansion(ecls, const=self.const / other.const)
        if other.coeffs is None:
            return TaylorExpansion(
                ecls, coeffs=[c / other.const for c in self.coeffs]
            )
        ws = other.coeffs
        scale = ecls.one() / ws[0]
        if self.coeffs is None:
            order = len(ws)
            out = [self.const * scale]
            for k in range(1, order):
                s = ecls.zero()
                for i in range(k):
                    s = s - out[i] * ws[k - i]
                out.append(scale * s)
            return TaylorExpansion(ecls, coeffs=out)
        us = self.coeffs
        order = min(len(us), len(ws))
        out = [scale * us[0]]
        for k in range(1, order):
            s = us[k]
            for i in range(k):
                s = s - out[i] * ws[k - i]
            out.append(scale * s)
        return TaylorExpansion(ecls, coeffs=out)

    def exp(self):
        """reference: univariate_taylor.rs:151-168."""
        ecls = self.ecls
        if self.coeffs is None:
            return TaylorExpansion(ecls, const=self.const.exp())
        coeffs = self.coeffs
        order = len(coeffs)
        res = [coeffs[0].exp()]
        for k in range(1, order):
            s = ecls.zero()
            for j in range(1, k + 1):
                s = s + res[k - j] * coeffs[j] * ecls.from_u32(j)
            res.append(s / ecls.from_u32(k))
        return TaylorExpansion(ecls, coeffs=res)

    def log(self):
        """reference: univariate_taylor.rs:170-189."""
        ecls = self.ecls
        if self.coeffs is None:
            return TaylorExpansion(ecls, const=self.const.log())
        coeffs = self.coeffs
        order = len(coeffs)
        res = [coeffs[0].log()]
        for k in range(1, order):
            s = ecls.zero()
            for j in range(1, k):
                s = s + coeffs[k - j] * res[j] * ecls.from_u32(j)
            res.append(
                (coeffs[k] * ecls.from_u32(k) - s) / coeffs[0] / ecls.from_u32(k)
            )
        return TaylorExpansion(ecls, coeffs=res)

    def pow_u32(self, n: int):
        res = self.one_like()
        base = self
        while n > 0:
            if n & 1:
                res = res * base
            base = base * base
            n >>= 1
        return res

    def maximum(self, other: "TaylorExpansion"):
        assert self.coeffs is None and other.coeffs is None, (
            "Maximum can only be applied to constant Taylor expansions."
        )
        return TaylorExpansion(self.ecls, const=self.const.maximum(other.const))

    def __repr__(self):
        if self.coeffs is None:
            return f"TaylorExpansion(const={self.const})"
        return f"TaylorExpansion({self.coeffs})"
