"""Closed-form symbolic generating functions (``--symbolic`` mode,
reference: src/symbolic.rs).

A ``SymGenFun`` is an Rc-style shared DAG of {Variable, Lit, Add, Mul, Div,
Exp, Log, Pow, Max} with aggressive algebraic rewriting in the smart
constructors (reference symbolic.rs:397-602).  Extraction evaluates the
whole expression over univariate Taylor numbers whose coefficients may
themselves be symbolic (reference symbolic.rs:238-299, 788-841).
"""

from __future__ import annotations

from .extract import factorial_moments_to_moments
from .ir import GenFun
from .unitaylor import TaylorExpansion

VARIABLE = "Variable"
LIT = "Lit"
ADD = "Add"
MUL = "Mul"
DIV = "Div"
EXP = "Exp"
LOG = "Log"
POW = "Pow"
MAX = "Max"


class SymGenFun:
    __slots__ = ("kind", "a", "b", "value", "var", "n", "T")

    def __init__(self, kind, T, a=None, b=None, value=None, var=None, n=None):
        self.kind = kind
        self.T = T
        self.a = a
        self.b = b
        self.value = value
        self.var = var
        self.n = n

    # -- constructors with algebraic rewriting --------------------------
    @staticmethod
    def lit(T, x) -> "SymGenFun":
        return SymGenFun(LIT, T, value=x)

    @staticmethod
    def var_(T, v: int) -> "SymGenFun":
        return SymGenFun(VARIABLE, T, var=v)

    @staticmethod
    def zero(T):
        return SymGenFun.lit(T, T.zero())

    @staticmethod
    def one(T):
        return SymGenFun.lit(T, T.one())

    def is_lit_zero(self):
        return self.kind == LIT and self.value.is_zero()

    def is_lit_one(self):
        return self.kind == LIT and self.value.is_one()

    # reference symbolic.rs:397-427 (add)
    @staticmethod
    def add(lhs: "SymGenFun", rhs: "SymGenFun") -> "SymGenFun":
        T = lhs.T
        if lhs.kind == LIT and lhs.value.is_zero():
            return rhs
        if rhs.kind == LIT and rhs.value.is_zero():
            return lhs
        if lhs.kind == LIT and rhs.kind == LIT:
            return SymGenFun.lit(T, lhs.value + rhs.value)
        if lhs.kind == LIT and rhs.kind == ADD:
            b, a = rhs.a, rhs.b
            if a.kind == LIT:
                return SymGenFun.add(b, SymGenFun.lit(T, lhs.value + a.value))
            return SymGenFun(ADD, T, a=rhs, b=lhs)
        if rhs.kind == LIT and lhs.kind == ADD:
            a, b = lhs.a, lhs.b
            if a.kind == LIT:
                return SymGenFun.add(b, SymGenFun.lit(T, rhs.value + a.value))
            return SymGenFun(ADD, T, a=lhs, b=rhs)
        if lhs.kind == ADD and rhs.kind == ADD:
            a, b = lhs.a, lhs.b
            c, d = rhs.a, rhs.b
            if b.kind == LIT and d.kind == LIT:
                return SymGenFun.add(
                    SymGenFun.add(a, c), SymGenFun.lit(T, b.value + d.value)
                )
            if b.kind == LIT:
                return SymGenFun.add(SymGenFun.add(a, rhs), b)
            if d.kind == LIT:
                return SymGenFun.add(SymGenFun.add(lhs, c), d)
        return SymGenFun(ADD, T, a=lhs, b=rhs)

    # reference symbolic.rs:429-532 (mul)
    @staticmethod
    def mul(lhs: "SymGenFun", rhs: "SymGenFun") -> "SymGenFun":
        T = lhs.T
        # literal simplifications
        if lhs.kind == LIT and lhs.value.is_zero():
            return SymGenFun.zero(T)
        if rhs.kind == LIT and rhs.value.is_zero():
            return SymGenFun.zero(T)
        if lhs.kind == LIT and lhs.value.is_one():
            return rhs
        if rhs.kind == LIT and rhs.value.is_one():
            return lhs
        if lhs.kind == EXP and rhs.kind == EXP:
            return SymGenFun.exp_(SymGenFun.add(lhs.a, rhs.a))
        if lhs.kind == LIT and rhs.kind == LIT:
            return SymGenFun.lit(T, lhs.value * rhs.value)
        if lhs.kind == LIT and rhs.kind == MUL and rhs.a.kind == LIT:
            return SymGenFun(
                MUL, T, a=SymGenFun.lit(T, lhs.value * rhs.a.value), b=rhs.b
            )
        if rhs.kind == LIT and lhs.kind == MUL and lhs.a.kind == LIT:
            return SymGenFun(
                MUL, T, a=SymGenFun.lit(T, rhs.value * lhs.a.value), b=lhs.b
            )
        # exp simplifications
        for x, y in ((lhs, rhs), (rhs, lhs)):
            if x.kind == MUL and y.kind == EXP:
                a1, a2 = x.a, x.b
                if a2.kind == EXP:
                    return SymGenFun.mul(
                        a1, SymGenFun.exp_(SymGenFun.add(a2.a, y.a))
                    )
                if a1.kind == EXP:
                    return SymGenFun.mul(
                        a2, SymGenFun.exp_(SymGenFun.add(a1.a, y.a))
                    )
        if lhs.kind == MUL and rhs.kind == MUL:
            a1, a2 = lhs.a, lhs.b
            b1, b2 = rhs.a, rhs.b
            if a1.kind == EXP and b1.kind == EXP:
                return SymGenFun.mul(
                    SymGenFun.mul(a2, b2),
                    SymGenFun.exp_(SymGenFun.add(a1.a, b1.a)),
                )
            if a1.kind == EXP and b2.kind == EXP:
                return SymGenFun.mul(
                    SymGenFun.mul(a2, b1),
                    SymGenFun.exp_(SymGenFun.add(a1.a, b2.a)),
                )
            if a2.kind == EXP and b1.kind == EXP:
                return SymGenFun.mul(
                    SymGenFun.mul(a1, b2),
                    SymGenFun.exp_(SymGenFun.add(a2.a, b1.a)),
                )
            if a2.kind == EXP and b2.kind == EXP:
                return SymGenFun.mul(
                    SymGenFun.mul(a1, b1),
                    SymGenFun.exp_(SymGenFun.add(a2.a, b2.a)),
                )
        # moving literals left
        if lhs.kind == MUL and rhs.kind == MUL:
            if lhs.a.kind == LIT and rhs.a.kind == LIT:
                return SymGenFun(
                    MUL,
                    T,
                    a=SymGenFun.lit(T, lhs.a.value * rhs.a.value),
                    b=SymGenFun.mul(lhs.b, rhs.b),
                )
        if lhs.kind == MUL and lhs.a.kind == LIT:
            return SymGenFun(MUL, T, a=lhs.a, b=SymGenFun.mul(lhs.b, rhs))
        if rhs.kind == MUL and rhs.a.kind == LIT:
            return SymGenFun(MUL, T, a=rhs.a, b=SymGenFun.mul(rhs.b, lhs))
        # pow simplifications (pointer identity, reference 512-527)
        if lhs.kind == MUL:
            a1, a2 = lhs.a, lhs.b
            if a2 is rhs:
                return SymGenFun.mul(a1, SymGenFun.pow_(a2, 2))
            if rhs.kind == POW and a2 is rhs.a:
                return SymGenFun.mul(a1, SymGenFun.pow_(a2, rhs.n + 1))
            if rhs.kind == POW and a2.kind == POW and a2.a is rhs.a:
                return SymGenFun.mul(a1, SymGenFun.pow_(a2.a, a2.n + rhs.n))
        if rhs.kind == LIT:
            return SymGenFun(MUL, T, a=rhs, b=lhs)
        return SymGenFun(MUL, T, a=lhs, b=rhs)

    @staticmethod
    def div(lhs: "SymGenFun", rhs: "SymGenFun") -> "SymGenFun":
        T = lhs.T
        if lhs.kind == LIT and lhs.value.is_zero():
            return SymGenFun.zero(T)
        if rhs.kind == LIT and rhs.value.is_one():
            return lhs
        return SymGenFun(DIV, T, a=lhs, b=rhs)

    @staticmethod
    def neg(arg: "SymGenFun") -> "SymGenFun":
        return SymGenFun.mul(SymGenFun.lit(arg.T, -arg.T.one()), arg)

    @staticmethod
    def exp_(arg: "SymGenFun") -> "SymGenFun":
        T = arg.T
        if arg.kind == LIT:
            if arg.value.is_zero():
                return SymGenFun.one(T)
            return SymGenFun.lit(T, arg.value.exp())
        if arg.kind == ADD and arg.b.kind == LIT:
            return SymGenFun.mul(
                SymGenFun.lit(T, arg.b.value.exp()), SymGenFun.exp_(arg.a)
            )
        return SymGenFun(EXP, T, a=arg)

    @staticmethod
    def log_(arg: "SymGenFun") -> "SymGenFun":
        T = arg.T
        if arg.kind == LIT:
            if arg.value.is_one():
                return SymGenFun.zero(T)
            return SymGenFun.lit(T, arg.value.log())
        if arg.kind == MUL and arg.a.kind == LIT:
            return SymGenFun.add(
                SymGenFun.log_(arg.b), SymGenFun.lit(T, arg.a.value.log())
            )
        return SymGenFun(LOG, T, a=arg)

    @staticmethod
    def pow_(base: "SymGenFun", n: int) -> "SymGenFun":
        T = base.T
        if n == 0:
            return SymGenFun.one(T)
        if n == 1:
            return base
        if base.kind == LIT and base.value.is_zero():
            return SymGenFun.zero(T)
        if base.kind == LIT and base.value.is_one():
            return SymGenFun.one(T)
        return SymGenFun(POW, T, a=base, n=n)

    @staticmethod
    def max_(lhs: "SymGenFun", rhs: "SymGenFun") -> "SymGenFun":
        return SymGenFun(MAX, lhs.T, a=lhs, b=rhs)

    # -- operator protocol (used as a Number by TaylorExpansion) --------
    def __add__(self, other):
        return SymGenFun.add(self, other)

    def __sub__(self, other):
        return SymGenFun.add(self, SymGenFun.neg(other))

    def __neg__(self):
        return SymGenFun.neg(self)

    def __mul__(self, other):
        return SymGenFun.mul(self, other)

    def __truediv__(self, other):
        return SymGenFun.div(self, other)

    def exp(self):
        return SymGenFun.exp_(self)

    def log(self):
        return SymGenFun.log_(self)

    def pow_u32(self, n: int):
        return SymGenFun.pow_(self, n)

    def maximum(self, other):
        return SymGenFun.max_(self, other)

    def is_zero(self):
        return self.is_lit_zero()

    def is_one(self):
        return self.is_lit_one()

    # -- substitution / differentiation (reference: 608-786) ------------
    def substitute_var(self, v: int, val: "SymGenFun") -> "SymGenFun":
        cache: dict = {}

        def subst(term: SymGenFun) -> SymGenFun:
            key = id(term)
            hit = cache.get(key)
            if hit is not None and hit[0] is term:
                return hit[1]
            k = term.kind
            if k == VARIABLE:
                out = val if term.var == v else term
            elif k == LIT:
                out = term
            elif k in (ADD, MUL, DIV, MAX):
                a2, b2 = subst(term.a), subst(term.b)
                if a2 is term.a and b2 is term.b:
                    out = term
                else:
                    ctor = {ADD: SymGenFun.add, MUL: SymGenFun.mul,
                            DIV: SymGenFun.div, MAX: SymGenFun.max_}[k]
                    out = ctor(a2, b2)
            elif k in (EXP, LOG):
                a2 = subst(term.a)
                if a2 is term.a:
                    out = term
                else:
                    out = SymGenFun.exp_(a2) if k == EXP else SymGenFun.log_(a2)
            elif k == POW:
                a2 = subst(term.a)
                out = term if a2 is term.a else SymGenFun.pow_(a2, term.n)
            else:
                raise AssertionError(k)
            cache[key] = (term, out)
            return out

        return subst(self)

    def derive(self, var: int) -> "SymGenFun":
        cache: dict = {}
        T = self.T

        def d(term: SymGenFun) -> SymGenFun:
            key = id(term)
            hit = cache.get(key)
            if hit is not None and hit[0] is term:
                return hit[1]
            k = term.kind
            if k == VARIABLE:
                out = SymGenFun.one(T) if term.var == var else SymGenFun.zero(T)
            elif k == LIT:
                out = SymGenFun.zero(T)
            elif k == ADD:
                out = SymGenFun.add(d(term.a), d(term.b))
            elif k == MUL:
                x = SymGenFun.mul(term.a, d(term.b))
                y = SymGenFun.mul(term.b, d(term.a))
                out = SymGenFun.add(x, y)
            elif k == DIV:
                x = SymGenFun.mul(term.a, d(term.b))
                y = SymGenFun.mul(term.b, d(term.a))
                b2 = SymGenFun.pow_(term.b, 2)
                out = SymGenFun.div(
                    SymGenFun.add(y, SymGenFun.neg(x)), b2
                )
            elif k == EXP:
                out = SymGenFun.mul(d(term.a), term)
            elif k == LOG:
                out = SymGenFun.div(d(term.a), term.a)
            elif k == POW:
                assert term.n != 0
                da = d(term.a)
                out = SymGenFun.mul(
                    SymGenFun.mul(SymGenFun.lit(T, T.from_u32(term.n)), da),
                    SymGenFun.pow_(term.a, term.n - 1),
                )
            else:
                raise AssertionError("Maximum shouldn't be differentiated.")
            cache[key] = (term, out)
            return out

        return d(self)

    # -- Taylor expansion with symbolic coefficients (reference 788-841) -
    def taylor_coeffs(self, var: int, order: int) -> TaylorExpansion:
        return self._taylor_coeffs_impl(var, None, order)

    def taylor_coeffs_at(self, var: int, x, order: int) -> TaylorExpansion:
        return self._taylor_coeffs_impl(var, x, order)

    def _taylor_coeffs_impl(self, var, x, order) -> TaylorExpansion:
        cache: dict = {}
        T = self.T
        ecls = _SymElems(T)

        def tc(term: SymGenFun) -> TaylorExpansion:
            key = id(term)
            hit = cache.get(key)
            if hit is not None and hit[0] is term:
                return hit[1]
            k = term.kind
            if k == VARIABLE:
                if term.var == var:
                    point = (
                        SymGenFun.lit(T, x) if x is not None
                        else SymGenFun.var_(T, var)
                    )
                    out = TaylorExpansion.var(point, order, ecls=ecls)
                else:
                    out = TaylorExpansion.constant(term, ecls=ecls)
            elif k == LIT:
                out = TaylorExpansion.constant(term, ecls=ecls)
            elif k == ADD:
                out = tc(term.a) + tc(term.b)
            elif k == MUL:
                out = tc(term.a) * tc(term.b)
            elif k == DIV:
                out = tc(term.a) / tc(term.b)
            elif k == EXP:
                out = tc(term.a).exp()
            elif k == LOG:
                out = tc(term.a).log()
            elif k == POW:
                out = tc(term.a).pow_u32(term.n)
            else:
                raise AssertionError("Maximum shouldn't be differentiated.")
            cache[key] = (term, out)
            return out

        return tc(self)

    # -- evaluation (reference: symbolic.rs:324-373) ---------------------
    def evaluate(self, lit_map, var_map):
        cache: dict = {}

        def ev(term: SymGenFun):
            key = id(term)
            hit = cache.get(key)
            if hit is not None and hit[0] is term:
                return hit[1]
            k = term.kind
            if k == VARIABLE:
                out = var_map(term.var)
            elif k == LIT:
                out = lit_map(term.value)
            elif k == ADD:
                out = ev(term.a) + ev(term.b)
            elif k == MUL:
                out = ev(term.a) * ev(term.b)
            elif k == DIV:
                out = ev(term.a) / ev(term.b)
            elif k == EXP:
                out = ev(term.a).exp()
            elif k == LOG:
                out = ev(term.a).log()
            elif k == POW:
                out = ev(term.a).pow_u32(term.n)
            elif k == MAX:
                out = ev(term.a).maximum(ev(term.b))
            else:
                raise AssertionError(k)
            cache[key] = (term, out)
            return out

        return ev(self)

    def evaluate_closed(self):
        def no_var(v):
            raise AssertionError("term should be closed")

        return self.evaluate(lambda x: x, no_var)

    # -- pretty printing (reference: symbolic.rs:844-903) ----------------
    def _precedence(self):
        return {ADD: 0, MUL: 1, DIV: 1, POW: 2}.get(self.kind, 10)

    def _fmt(self, parent: int, out: list):
        prec = self._precedence()
        if prec < parent:
            out.append("(")
        k = self.kind
        if k == VARIABLE:
            out.append(_var_name(self.var))
        elif k == LIT:
            out.append(self.value.display())
        elif k == ADD:
            self.a._fmt(prec, out)
            out.append(" + ")
            self.b._fmt(prec, out)
        elif k == MUL:
            self.a._fmt(prec, out)
            out.append("*")
            self.b._fmt(prec, out)
        elif k == DIV:
            self.a._fmt(prec, out)
            out.append("/")
            self.b._fmt(prec + 1, out)
        elif k == EXP:
            out.append("exp(")
            self.a._fmt(0, out)
            out.append(")")
        elif k == LOG:
            out.append("log(")
            self.a._fmt(0, out)
            out.append(")")
        elif k == POW:
            self.a._fmt(prec + 1, out)
            out.append(f"^{self.n}")
        else:
            out.append("max(")
            self.a._fmt(0, out)
            out.append(", ")
            self.b._fmt(0, out)
            out.append(")")
        if prec < parent:
            out.append(")")

    def __str__(self):
        out: list = []
        self._fmt(0, out)
        return "".join(out)


def _var_name(i: int) -> str:
    if i < 26:
        return chr(ord("a") + i)
    return f"x_{i}"


class _SymElems:
    """Element-class adapter so TaylorExpansion can create SymGenFun
    zeros/ones/naturals."""

    _cache: dict = {}

    def __new__(cls, T):
        inst = cls._cache.get(T)
        if inst is None:
            inst = super().__new__(cls)
            inst.T = T
            cls._cache[T] = inst
        return inst

    def zero(self):
        return SymGenFun.zero(self.T)

    def one(self):
        return SymGenFun.one(self.T)

    def from_u32(self, n: int):
        return SymGenFun.lit(self.T, self.T.from_u32(n))


# ----------------------------------------------------------------------
# GF -> symbolic conversion (reference: generating_function.rs:767-831)
# ----------------------------------------------------------------------

def to_computation(gf: GenFun, T) -> SymGenFun:
    cache: dict = {}

    def conv(node: GenFun) -> SymGenFun:
        key = id(node)
        hit = cache.get(key)
        if hit is not None and hit[0] is node:
            return hit[1]
        k = node.kind
        if k == "Var":
            out = SymGenFun.var_(T, node.var)
        elif k == "Const":
            out = SymGenFun.lit(T, node.value)
        elif k == "Add":
            out = conv(node.args[0]) + conv(node.args[1])
        elif k == "Neg":
            out = -conv(node.args[0])
        elif k == "Mul":
            out = conv(node.args[0]) * conv(node.args[1])
        elif k == "Div":
            out = conv(node.args[0]) / conv(node.args[1])
        elif k == "Polynomial":
            out = _fold_coeffs(T, node.poly, node.order)
        elif k == "Exp":
            out = conv(node.args[0]).exp()
        elif k == "Log":
            out = conv(node.args[0]).log()
        elif k == "Pow":
            out = conv(node.args[0]).pow_u32(node.order)
        elif k == "Max":
            out = conv(node.args[0]).maximum(conv(node.args[1]))
        elif k == "UniformMgf":
            g = conv(node.args[0])
            out = (g.exp() - SymGenFun.one(T)) / g
        elif k == "Subst":
            out = conv(node.args[0]).substitute_var(node.var, conv(node.args[1]))
        elif k == "Derivative":
            out = conv(node.args[0])
            for _ in range(node.order):
                out = out.derive(node.var)
        elif k == "TaylorPolynomial":
            v = node.var
            orders = node.orders
            max_order = max(orders) if orders else 0
            taylor = conv(node.args[0]).taylor_coeffs(v, max_order)
            keep = [i in set(orders) for i in range(max_order + 1)]
            acc = SymGenFun.zero(T)
            for i in reversed(range(max_order + 1)):
                if keep[i]:
                    acc = acc * SymGenFun.var_(T, v) + taylor.coeff(i)
                else:
                    acc = acc * SymGenFun.var_(T, v)
            out = acc
        elif k == "TaylorCoeffAtZero":
            out = (
                conv(node.args[0])
                .taylor_coeffs_at(node.var, T.zero(), node.order)
                .coeff(node.order)
            )
        elif k == "TaylorCoeff":
            out = conv(node.args[0]).taylor_coeffs(node.var, node.order).coeff(
                node.order
            )
        elif k == "ShiftTaylorAtZero":
            raise NotImplementedError(
                "symbolic mode does not support the decrement operator"
            )
        else:
            raise AssertionError(k)
        cache[key] = (node, out)
        return out

    return conv(gf)


def _fold_coeffs(T, nested, ndim: int) -> SymGenFun:
    """Horner unfolding of a dense coefficient tensor: the last axis is
    folded outermost, recursing over the remaining axes
    (reference: generating_function.rs:916-934)."""

    def fold_axis(sub, ndim_left):
        # sub: nested list with ndim_left axes
        if ndim_left == 0:
            return SymGenFun.lit(T, sub)
        v = ndim_left - 1
        # iterate over the *last* axis => transpose access: recurse on
        # each slice along the last axis
        length = _axis_len(sub, v)
        result = SymGenFun.zero(T)
        for i in reversed(range(length)):
            result = result * SymGenFun.var_(T, _global_axis(ndim_left, v))
            coeff = fold_axis(_index_axis(sub, v, i), ndim_left - 1)
            result = result + coeff
        return result

    def _axis_len(sub, axis):
        if axis == 0:
            return len(sub)
        return _axis_len(sub[0], axis - 1)

    def _index_axis(sub, axis, i):
        if axis == 0:
            return sub[i]
        return [_index_axis(x, axis - 1, i) for x in sub]

    def _global_axis(ndim_left, v):
        # axes are consumed from the last one; the axis being folded is
        # always the last remaining one, whose global index is ndim_left-1
        return ndim_left - 1

    if ndim == 0:
        return SymGenFun.lit(T, nested)
    return fold_axis(nested, ndim)


# ----------------------------------------------------------------------
# extraction (reference: symbolic.rs:238-299)
# ----------------------------------------------------------------------

def probs_symbolic(pgf: SymGenFun, v: int, var_info, n: int):
    T = pgf.T
    var = TaylorExpansion.var(T.zero(), n, ecls=T)
    taylor = pgf.evaluate(
        lambda x: TaylorExpansion.constant(x, ecls=T),
        lambda w: var
        if w == v
        else (
            TaylorExpansion.constant(T.one(), ecls=T)
            if var_info[w].is_discrete()
            else TaylorExpansion.constant(T.zero(), ecls=T)
        ),
    )
    return [taylor.coeff(i) for i in range(n)]


def moments_symbolic(pgf: SymGenFun, v: int, var_info, limit: int):
    T = pgf.T
    if var_info[v].is_discrete():
        var = TaylorExpansion.var(T.one(), limit, ecls=T)
    else:
        var = TaylorExpansion.var(T.zero(), limit, ecls=T)
    taylor = pgf.evaluate(
        lambda x: TaylorExpansion.constant(x, ecls=T),
        lambda w: var
        if w == v
        else (
            TaylorExpansion.constant(T.one(), ecls=T)
            if var_info[w].is_discrete()
            else TaylorExpansion.constant(T.zero(), ecls=T)
        ),
    )
    result = []
    factor = T.one()
    for i in range(limit):
        result.append(taylor.coeff(i) * factor)
        factor = factor * T.from_u32(i + 1)
    if var_info[v].is_discrete():
        return factorial_moments_to_moments(result)
    total = result[0]
    moments = [x / total for x in result[1:]]
    return total, moments
