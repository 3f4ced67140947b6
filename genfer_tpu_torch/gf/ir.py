"""Generating-function expression IR.

Host-side immutable DAG of generating-function operations
(reference: src/generating_function.rs).  Node constants are host scalars
from :mod:`genfer_tpu.numbers`; evaluation lowers the DAG into TensorPoly
operations on a chosen array backend.

Structural sharing is the memoization key: shared sub-DAGs are evaluated
once per (inputs, degree) thanks to an id-keyed cache, mirroring the
reference's Rc-pointer caches (generating_function.rs:186-222).  Under the
whole-graph view this is common-subexpression reuse inside one XLA program.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..taylor.tensorpoly import CHECK_INVARIANTS as _CHECK

import os as _os

# debug escape hatch: evaluate at exactly the requested degree (the
# reference's behavior) instead of the degree-demand target
_NO_DEMAND = bool(_os.environ.get("GENFER_NO_DEMAND"))
from ..taylor.tensorpoly import INF_DEGREE, TaylorPoly

# node kinds
VAR = "Var"
CONST = "Const"
ADD = "Add"
NEG = "Neg"
MUL = "Mul"
DIV = "Div"
POLYNOMIAL = "Polynomial"
EXP = "Exp"
LOG = "Log"
POW = "Pow"
UNIFORM_MGF = "UniformMgf"
SUBST = "Subst"
DERIVATIVE = "Derivative"
TAYLOR_POLYNOMIAL = "TaylorPolynomial"
TAYLOR_COEFF_AT_ZERO = "TaylorCoeffAtZero"
TAYLOR_COEFF = "TaylorCoeff"
SHIFT_TAYLOR_AT_ZERO = "ShiftTaylorAtZero"
MAX = "Max"
#: the kinds a constant-only subtree holds above its Const leaves
_CONST_OPS = (ADD, MUL, NEG)


class GenFun:
    """One node of the generating-function DAG (17 node kinds,
    reference: generating_function.rs:301-323)."""

    __slots__ = ("kind", "args", "var", "order", "orders", "value", "poly",
                 "_uv", "_ct")

    def __init__(self, kind, args=(), var=None, order=None, orders=None,
                 value=None, poly=None):
        self.kind = kind
        self.args = args          # child GenFun nodes
        self.var = var            # variable index
        self.order = order        # int (Pow exponent / derivative order)
        self.orders = orders      # list of ints (TaylorPolynomial)
        self.value = value        # host scalar (Const)
        self.poly = poly          # host nested coeff lists (Polynomial)
        # used_vars computed eagerly: children exist before parents, so
        # this is O(len(args)) per node and used_vars() is O(1) — the
        # per-call DAG walk was O(whole DAG) per observe (12k observes in
        # switchpoint made GF construction quadratic).  Branch order:
        # leaf kinds (Const dominates large programs) take the cheap
        # empty-args path.
        if not args:
            if kind == VAR:
                self._uv = var + 1
            elif kind == POLYNOMIAL:
                self._uv = order  # ndim
            else:  # CONST
                self._uv = 0
        elif kind == SUBST:
            g, subst = args
            uv = g._uv
            if var + 1 == uv:
                uv = var
            sv = subst._uv
            self._uv = uv if uv >= sv else sv
        elif kind == TAYLOR_COEFF_AT_ZERO:
            uv = args[0]._uv
            if var + 1 == uv:
                uv = var
            self._uv = uv
        elif len(args) == 1:
            self._uv = args[0]._uv
        else:
            uv = 0
            for a in args:
                if a._uv > uv:
                    uv = a._uv
            self._uv = uv
        # a constant-only subtree: Const leaves under Add / Mul / Neg (the
        # operand a constant spine's link applies, see _eval)
        self._ct = (kind == CONST if not args else kind in _CONST_OPS
                    and all(a._ct for a in args))

    # -- smart constructors (reference: generating_function.rs:49-149) --
    @staticmethod
    def var_(v: int) -> "GenFun":
        return GenFun(VAR, var=v)

    @staticmethod
    def constant(x) -> "GenFun":
        return GenFun(CONST, value=x)

    @staticmethod
    def zero(T) -> "GenFun":
        return GenFun.constant(T.zero())

    @staticmethod
    def one(T) -> "GenFun":
        return GenFun.constant(T.one())

    @staticmethod
    def from_u32(T, n: int) -> "GenFun":
        return GenFun.constant(T.from_u32(n))

    @staticmethod
    def from_ratio(T, numer: int, denom: int) -> "GenFun":
        return GenFun.constant(T.from_ratio(numer, denom))

    @staticmethod
    def polynomial(nested_host_coeffs, ndim: int) -> "GenFun":
        return GenFun(POLYNOMIAL, poly=nested_host_coeffs, order=ndim)

    def exp(self):
        return GenFun(EXP, args=(self,))

    def log(self):
        return GenFun(LOG, args=(self,))

    def pow(self, n: int):
        return GenFun(POW, args=(self,), order=int(n))

    def max_(self, other: "GenFun"):
        return GenFun(MAX, args=(self, other))

    @staticmethod
    def uniform_mgf(g: "GenFun"):
        """(e^x - 1)/x continuously extended at 0
        (reference: generating_function.rs:94-96, 314-315)."""
        return GenFun(UNIFORM_MGF, args=(g,))

    def derive(self, v: int, order: int):
        return GenFun(DERIVATIVE, args=(self,), var=v, order=order)

    def taylor_polynomial_at_zero(self, v: int, orders: Sequence[int]):
        return GenFun(TAYLOR_POLYNOMIAL, args=(self,), var=v, orders=list(orders))

    def taylor_coeff_at_zero(self, v: int, order: int):
        return GenFun(TAYLOR_COEFF_AT_ZERO, args=(self,), var=v, order=order)

    def taylor_coeff(self, v: int, order: int):
        return GenFun(TAYLOR_COEFF, args=(self,), var=v, order=order)

    def shift_down_taylor_at_zero(self, v: int, order: int):
        return GenFun(SHIFT_TAYLOR_AT_ZERO, args=(self,), var=v, order=order)

    def substitute_var(self, v: int, val: "GenFun"):
        return GenFun(SUBST, args=(self, val), var=v)

    def substitute_all(self, val: "GenFun"):
        num_vars = self.used_vars()
        result = self
        for v in range(num_vars):
            result = result.substitute_var(v, val)
        return result

    # -- operators ------------------------------------------------------
    # Constant-folding smart constructors, gated on EXACT_RING scalar
    # types (Rational) only.  In float modes the DAG must be structurally
    # identical to the reference's (generating_function.rs:235-292 folds
    # NOTHING): even a bit-exact elision like 1·x changes which
    # observation-optimizer pattern (generating_function.rs:840-914)
    # matches downstream, silently selecting a different — differently
    # rounded — evaluation strategy.  (Round 2 shipped unconditional
    # folds; eliding `Add * Const(1)` in nested_infer_goals flipped an
    # optimizer match and moved Z one ULP onto exactly 1.0, flipping the
    # is_normalized output template of main.rs:419.)  For exact scalars
    # every strategy yields the identical exact value, so folding only
    # affects speed — long chains of constant factors (digitRecognition's
    # 7840 constant-probability observations) collapse at construction.
    # Float modes get the equivalent speedup from the iterative
    # constant-chain evaluation in _eval (same multiplication sequence as
    # the reference, no per-node overhead).  0 · X is never folded
    # (X may evaluate to ±inf; IEEE 0·inf = NaN).
    def __add__(self, other):
        if self.kind == CONST and self.value.EXACT_RING:
            if other.kind == CONST:
                return GenFun.constant(self.value + other.value)
            if self.value.is_zero():
                return other
        elif (
            other.kind == CONST
            and other.value.EXACT_RING
            and other.value.is_zero()
        ):
            # x + 0 -> x: the zero summand comes from dead/Fail branches
            # (observe desugars to if/else with a zero else-translation)
            return self
        return GenFun(ADD, args=(self, other))

    def __neg__(self):
        if self.kind == CONST and self.value.EXACT_RING:
            return GenFun.constant(-self.value)
        return GenFun(NEG, args=(self,))

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        a, b = self, other
        if a.kind == CONST and a.value.EXACT_RING:
            if b.kind == CONST:
                return GenFun.constant(a.value * b.value)
            if a.value.is_one():
                return b
            if b.kind == MUL:
                b0, b1 = b.args
                if b0.kind == CONST and not b0.value.is_zero():
                    return GenFun.constant(a.value * b0.value) * b1
                if b1.kind == CONST and not b1.value.is_zero():
                    return b0 * GenFun.constant(a.value * b1.value)
        elif b.kind == CONST and b.value.EXACT_RING:
            if b.value.is_one():
                return a
            if a.kind == MUL:
                a0, a1 = a.args
                if a0.kind == CONST and not a0.value.is_zero():
                    return GenFun.constant(b.value * a0.value) * a1
                if a1.kind == CONST and not a1.value.is_zero():
                    return a0 * GenFun.constant(b.value * a1.value)
        return GenFun(MUL, args=(self, other))

    def __truediv__(self, other):
        return GenFun(DIV, args=(self, other))

    # -- structural equality (used by the observation recognizers;
    #    reference relies on derived PartialEq) ------------------------
    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, GenFun):
            return NotImplemented
        if self.kind != other.kind:
            return False
        if self.kind == VAR:
            return self.var == other.var
        if self.kind == CONST:
            return self.value == other.value
        if (
            self.var != other.var
            or self.order != other.order
            or self.orders != other.orders
        ):
            return False
        if len(self.args) != len(other.args):
            return False
        return all(a == b for a, b in zip(self.args, other.args))

    __hash__ = object.__hash__

    # -- used variables (reference: generating_function.rs:428-449) -----
    def used_vars(self, cache: Optional[dict] = None) -> int:
        """Return num_vars = max used var id + 1 (reference VarRange).

        O(1): computed eagerly at construction (``_uv``); the ``cache``
        parameter is kept for API compatibility and ignored.
        """
        return self._uv

    # -- pretty printer (reference: generating_function.rs:330-426) -----
    def _precedence(self) -> int:
        k = self.kind
        if k in (ADD, NEG, POLYNOMIAL):
            return 0
        if k in (MUL, DIV):
            return 1
        if k == POW:
            return 2
        return 10

    def _fmt(self, parent_prec: int, out: list):
        prec = self._precedence()
        if prec < parent_prec:
            out.append("(")
        k = self.kind
        if k == VAR:
            out.append(_var_name(self.var))
        elif k == CONST:
            out.append(self.value.display())
        elif k == ADD:
            self.args[0]._fmt(prec, out)
            out.append(" + ")
            self.args[1]._fmt(prec, out)
        elif k == NEG:
            out.append("-")
            self.args[0]._fmt(prec + 1, out)
        elif k == MUL:
            self.args[0]._fmt(prec, out)
            out.append(" * ")
            self.args[1]._fmt(prec, out)
        elif k == DIV:
            self.args[0]._fmt(prec, out)
            out.append(" / ")
            self.args[1]._fmt(prec + 1, out)
        elif k == POLYNOMIAL:
            out.append(_fmt_polynomial(self.poly))
        elif k == EXP:
            out.append("exp(")
            self.args[0]._fmt(0, out)
            out.append(")")
        elif k == LOG:
            out.append("log(")
            self.args[0]._fmt(0, out)
            out.append(")")
        elif k == POW:
            self.args[0]._fmt(prec + 1, out)
            out.append(f"^{self.order}")
        elif k == MAX:
            out.append("max(")
            self.args[0]._fmt(0, out)
            out.append(", ")
            self.args[1]._fmt(0, out)
            out.append(")")
        elif k == UNIFORM_MGF:
            out.append("uniform_mgf(")
            self.args[0]._fmt(0, out)
            out.append(")")
        elif k == SUBST:
            out.append(f"[{_var_name(self.var)} -> ")
            self.args[1]._fmt(0, out)
            out.append(" in ")
            self.args[0]._fmt(0, out)
            out.append("]")
        elif k == DERIVATIVE:
            out.append(f"d_{_var_name(self.var)}^{self.order}(")
            self.args[0]._fmt(0, out)
            out.append(")")
        elif k == TAYLOR_POLYNOMIAL:
            out.append("taylor(")
            self.args[0]._fmt(0, out)
            out.append(f" of {_var_name(self.var)}^i with i ∈ {self.orders})")
        elif k == TAYLOR_COEFF_AT_ZERO:
            out.append("coeff_at_zero(")
            self.args[0]._fmt(0, out)
            out.append(f" of {_var_name(self.var)}^{self.order})")
        elif k == TAYLOR_COEFF:
            out.append("coeff(")
            self.args[0]._fmt(0, out)
            out.append(f" of {_var_name(self.var)}^{self.order})")
        elif k == SHIFT_TAYLOR_AT_ZERO:
            out.append("shift(")
            self.args[0]._fmt(0, out)
            out.append(f" of {_var_name(self.var)} by {self.order})")
        if prec < parent_prec:
            out.append(")")

    def __str__(self):
        out: list = []
        self._fmt(0, out)
        return "".join(out)

    # -- simplification (reference: generating_function.rs:151-177,
    #    474-545): bottom-up constant/polynomial folding ----------------
    def simplify(self, backend) -> "GenFun":
        cache: dict = {}
        taylor = self._simplify_with(backend, cache)
        if taylor is not None:
            nested = taylor.to_nested_host()
            return GenFun.polynomial(nested, len(taylor.coeffs_shape()))
        return self

    def _simplify_with(self, backend, cache) -> Optional[TaylorPoly]:
        key = id(self)
        hit = cache.get(key)
        if hit is not None and hit[0] is self:
            return hit[1]
        result = self._simplify(backend, cache)
        cache[key] = (self, result)
        return result

    def _simplify(self, backend, cache) -> Optional[TaylorPoly]:
        k = self.kind
        if k == VAR:
            return TaylorPoly.var_with_degrees_p1(
                backend,
                self.var,
                backend.scalar_cls.zero(),
                (INF_DEGREE,) * (self.var + 1),
            )
        if k == CONST:
            return TaylorPoly.from_scalar(backend, self.value)
        if k == ADD:
            p1 = self.args[0]._simplify_with(backend, cache)
            p2 = self.args[1]._simplify_with(backend, cache)
            if p1 is not None and p2 is not None:
                return p1 + p2
            return None
        if k == NEG:
            p = self.args[0]._simplify_with(backend, cache)
            return -p if p is not None else None
        if k == MUL:
            p1 = self.args[0]._simplify_with(backend, cache)
            p2 = self.args[1]._simplify_with(backend, cache)
            if p1 is not None and p2 is not None:
                return p1 * p2
            return None
        if k == DIV:
            p1 = self.args[0]._simplify_with(backend, cache)
            p2 = self.args[1]._simplify_with(backend, cache)
            if p1 is not None and p2 is not None and p2.extract_constant() is not None:
                return p1 / p2
            return None
        if k in (POLYNOMIAL, EXP, LOG, MAX, UNIFORM_MGF):
            return None
        if k == POW:
            p = self.args[0]._simplify_with(backend, cache)
            return p.pow(self.order) if p is not None else None
        if k == SUBST:
            p = self.args[0]._simplify_with(backend, cache)
            q = self.args[1]._simplify_with(backend, cache)
            if p is not None and q is not None:
                return p.subst_var(self.var, q)
            return None
        if k == DERIVATIVE:
            p = self.args[0]._simplify_with(backend, cache)
            return p.derivative(self.var, self.order) if p is not None else None
        if k == TAYLOR_POLYNOMIAL:
            p = self.args[0]._simplify_with(backend, cache)
            if p is not None:
                return p.taylor_polynomial_terms(self.var, self.orders)
            return None
        if k == TAYLOR_COEFF_AT_ZERO:
            p = self.args[0]._simplify_with(backend, cache)
            if p is None:
                return None
            res = p.coefficients_of_term(self.var, self.order)
            if self.var + 1 == res.num_vars():
                res = res.remove_last_variable()
            return res
        if k == TAYLOR_COEFF:
            p = self.args[0]._simplify_with(backend, cache)
            if p is not None:
                return p.taylor_expansion_of_coeff(self.var, self.order)
            return None
        if k == SHIFT_TAYLOR_AT_ZERO:
            p = self.args[0]._simplify_with(backend, cache)
            return p.shift_down(self.var, self.order) if p is not None else None
        raise AssertionError(f"unknown kind {k}")

    # -- evaluation (reference: generating_function.rs:179-222, 548-765) -
    def eval(self, backend, inputs, degree_p1) -> TaylorPoly:
        d = Demand.of(degree_p1, len(inputs))
        # the native C++ evaluator mirrors eval_with/_eval for the
        # NumpyF64Backend (native/evaltape.cpp); it returns None when the
        # DAG or a runtime case is outside its mirrored surface
        from .nativeeval import try_native_eval

        res = try_native_eval(self, backend, inputs, d)
        if res is not None:
            return res
        return self.eval_with(backend, list(inputs), d, _EvalCache(self, d))

    def eval_with(self, backend, inputs, degree_p1, cache) -> TaylorPoly:
        if not isinstance(degree_p1, Demand):
            degree_p1 = Demand.of(degree_p1, len(inputs))
        if isinstance(cache, dict):  # plain-dict compatibility (tests)
            c = _EvalCache(self, degree_p1)
            cache = c
        hit = cache.get(self, degree_p1, inputs)
        if hit is not None:
            return hit
        # Evaluate once at the maximum degree any (static) parent will
        # ever demand; lower-degree requests are served by truncation
        # (power-series ops are graded: low-order coefficients never
        # depend on higher-order ones).  Without this, a tower of N
        # derivative-style observations evaluates each node at up to N
        # distinct degrees — O(N) redundant full evaluations per node.
        # (The reference re-evaluates on degree mismatch,
        # generating_function.rs:199-204 — its own TODO asks for `<=`.)
        target = (
            degree_p1
            if _NO_DEMAND
            else degree_p1.join(cache.demand(self))
        )
        result = self._eval(backend, inputs, target, cache)
        if _CHECK:
            assert all(
                dg == target.axis(i)
                for i, dg in enumerate(result.degrees_p1)
            ), f"unexpected eval degrees {result.degrees_p1} for target {target}"
        cache.put(self, target, inputs, result)
        # Release children after this node's FIRST completed evaluation:
        # when every static parent of a child has evaluated once, the
        # child's cached tensors can be dropped (pure memo — eviction can
        # only cost a recompute, never correctness).  This bounds live
        # memory by the working set instead of the whole DAG's tensors
        # (a 100-observation tower would otherwise hold O(N) full-order
        # coefficient tensors at once).
        if cache.first_eval(self):
            for child in self.args:
                cache.release(child)
        if target.axes != degree_p1.axes:
            # uni-only differences need no truncation (uni affects only
            # composition depth, already baked into the arrays)
            result = _trunc_demand(result, degree_p1)
        return result

    def _eval(self, backend, inputs, degree_p1, cache) -> TaylorPoly:
        k = self.kind
        T = backend.scalar_cls
        if k == VAR:
            return _tp_var(backend, self.var, inputs[self.var], degree_p1)
        if k == CONST:
            return TaylorPoly.from_scalar(backend, self.value)
        if k == ADD or k == MUL:
            # Iterative constant-spine evaluation: a tower of Add/Mul
            # nodes with one constant-only operand each — e.g.
            # digitRecognition's 7840 constant-probability observations,
            # each of which contributes Add(Mul(G, p), Mul(0, 1 - p))
            # (semantics/gf.rs:169-174, 306-316) — is handed to the
            # backend's ``eval_spine`` innermost link first.  Its base
            # implementation performs the *same sequence* of TaylorPoly
            # operations as the recursive eval (bit-identical results,
            # unlike folding the constants away at construction time,
            # which changes which observation optimizer matches) while
            # avoiding O(N) Python recursion and cache bookkeeping.  Only
            # unshared links are inlined: a shared node keeps its cache
            # entry for its other consumers.
            spine = []
            node = self
            while node.kind in (ADD, MUL) and (
                    not spine or cache.sole_consumer(node)):
                x, y = node.args
                if x._ct and not y._ct:
                    spine.append((node.kind, x, True))
                    node = y
                elif y._ct and not x._ct:
                    spine.append((node.kind, y, False))
                    node = x
                else:
                    break
            if spine:
                def constant(c):
                    if c.kind == CONST:
                        return TaylorPoly.from_scalar(backend, c.value)
                    return c.eval_with(backend, inputs, degree_p1, cache)

                base = node.eval_with(backend, inputs, degree_p1, cache)
                spine.reverse()
                return backend.eval_spine(base, spine, constant)
            if k == ADD:
                return self.args[0].eval_with(backend, inputs, degree_p1, cache) + \
                    self.args[1].eval_with(backend, inputs, degree_p1, cache)
            return self.args[0].eval_with(backend, inputs, degree_p1, cache) * \
                self.args[1].eval_with(backend, inputs, degree_p1, cache)
        if k == NEG:
            return -self.args[0].eval_with(backend, inputs, degree_p1, cache)
        if k == DIV:
            return self.args[0].eval_with(backend, inputs, degree_p1, cache) / \
                self.args[1].eval_with(backend, inputs, degree_p1, cache)
        if k == POLYNOMIAL:
            arr = backend.from_nested(self.poly)
            ndim = len(backend.shape(arr))
            taylor = TaylorPoly.new(backend, arr, (INF_DEGREE,) * ndim)
            for v, inp in enumerate(inputs):
                taylor = taylor.subst_var(
                    v, _tp_var(backend, v, inp, degree_p1)
                )
            nd = taylor.num_vars()
            if nd > len(inputs):
                assert nd == len(inputs) + 1
                taylor = taylor.remove_last_variable()
            taylor = taylor.extend_to_dim(len(inputs), degree_p1.maxv)
            return _trunc_demand(taylor, degree_p1)
        if k == EXP:
            return self.args[0].eval_with(backend, inputs, degree_p1, cache).exp()
        if k == LOG:
            return self.args[0].eval_with(backend, inputs, degree_p1, cache).log()
        if k == MAX:
            s = self.args[0].eval_with(backend, inputs, degree_p1, cache)
            t = self.args[1].eval_with(backend, inputs, degree_p1, cache)
            assert s.is_constant() and t.is_constant(), "Max only for constants"
            if getattr(backend, "concrete", True):
                sv = s.constant_term_host()
                tv = t.constant_term_host()
                return TaylorPoly.from_scalar(backend, sv.maximum(tv))
            # traced backends (compiled mode) cannot lower device values
            # to host scalars: take the elementwise max of the constant
            # coefficient arrays instead
            m = backend.jnp.maximum(
                backend.reshape(s.coeffs, ()), backend.reshape(t.coeffs, ())
            )
            return TaylorPoly.new(backend, m, ())
        if k == POW:
            return self.args[0].eval_with(backend, inputs, degree_p1, cache).pow(
                self.order
            )
        if k == UNIFORM_MGF:
            x = self.args[0].eval_with(backend, inputs, degree_p1, cache)
            c = _const_term_host(x)
            # series-composition depth: the substituted y spans all of
            # x's axes, so the expansion must reach the summed demand
            dmax = degree_p1.comp_depth(self.args[0].used_vars())
            if c.is_zero():
                # evaluate (e^y - 1)/y as a series in y, then substitute
                y = TaylorPoly.var_at_zero(backend, 0, dmax + 1)
                numerator = y.exp() - TaylorPoly.one(backend)
                arr = backend.slice_axis(
                    numerator.coeffs, 0, 1, backend.shape(numerator.coeffs)[0]
                )
                fraction = TaylorPoly.new(backend, arr, (dmax,))
                return _trunc_demand(fraction.subst_var(0, x), degree_p1)
            numerator = x.exp() - TaylorPoly.one(backend)
            return _trunc_demand(numerator / x, degree_p1)
        if k == SUBST:
            g, replacement = self.args
            v = self.var
            subst = replacement.eval_with(backend, inputs, degree_p1, cache)
            c = _const_term_host(subst)
            subst = subst - TaylorPoly.from_scalar(backend, c)
            new_inputs = list(inputs)
            if v < len(inputs):
                new_inputs[v] = c
            else:
                assert v == len(inputs)
                new_inputs.append(c)
            # the Horner composition consumes one power of the (zero-
            # constant-term) replacement per v-degree of g; a replacement
            # spanning k axes contributes total degree >= j at power j,
            # so completeness for every retained coefficient needs g's
            # v-axis evaluated to the summed demand over the
            # replacement's axes (NOT the max — clinicalTrial2)
            depth = degree_p1.comp_depth(replacement.used_vars())
            g_demand = degree_p1.with_axis(
                v, max(depth, degree_p1.axis(v))
            )
            taylor = g.eval_with(backend, new_inputs, g_demand, cache)
            result = taylor.subst_var(v, subst)
            if len(taylor.degrees_p1) > len(inputs):
                assert len(taylor.degrees_p1) == len(inputs) + 1
                result = result.remove_last_variable()
            # the substituted series has constant term exactly 0 (c was
            # split off), so the composite's order-0 coefficient equals the
            # child's
            if result.const0 is None:
                result.const0 = taylor.const0
            # g was evaluated at the widened axis-v demand; a zero (or
            # low-degree) substitution keeps that widened degree, so
            # truncate back to the caller's demand
            return _trunc_demand(result, degree_p1)
        if k == DERIVATIVE:
            taylor = self.args[0].eval_with(
                backend, inputs, degree_p1.bump(self.var, self.order), cache
            )
            return _trunc_demand(
                taylor.derivative(self.var, self.order), degree_p1
            )
        if k == TAYLOR_POLYNOMIAL:
            v = self.var
            new_inputs = list(inputs)
            new_inputs[v] = T.zero()
            max_order = max(self.orders) if self.orders else 0
            taylor = self.args[0].eval_with(
                backend, new_inputs, degree_p1.bump(v, max_order), cache
            )
            result = taylor.taylor_polynomial_terms(v, self.orders)
            result = result.subst_var(
                v, _tp_var(backend, v, inputs[v], degree_p1)
            )
            return _trunc_demand(result, degree_p1)
        if k == TAYLOR_COEFF_AT_ZERO:
            return _eval_taylor_coeff_at_zero(
                self.args[0], self.var, self.order, backend, inputs, degree_p1, cache
            )
        if k == TAYLOR_COEFF:
            taylor = self.args[0].eval_with(
                backend, inputs, degree_p1.bump(self.var, self.order), cache
            )
            result = taylor.taylor_expansion_of_coeff(self.var, self.order)
            return _trunc_demand(result, degree_p1)
        if k == SHIFT_TAYLOR_AT_ZERO:
            g = self.args[0]
            v, order = self.var, self.order
            if inputs[v].is_zero():
                taylor = g.eval_with(
                    backend, inputs, degree_p1.bump(v, order), cache
                )
                return _trunc_demand(taylor.shift_down(v, order), degree_p1)
            first_terms = g.taylor_polynomial_at_zero(v, list(range(order)))
            additional_mass = first_terms.substitute_var(v, GenFun.one(T))
            h = (g - first_terms) / GenFun.var_(v).pow(order) + additional_mass
            return h.eval_with(backend, inputs, degree_p1, cache)
        raise AssertionError(f"unknown kind {k}")

    # Conversion to the closed-form symbolic representation lives in
    # genfer_tpu.gf.symbolic (to_computation).


def _var_name(i: int) -> str:
    if i < 26:
        return chr(ord("a") + i)
    return f"x_{i}"


def _fmt_polynomial(nested) -> str:
    """Pretty-print a coefficient tensor as a polynomial
    (reference: multivariate_taylor.rs:694-724)."""
    terms = []

    def rec(n, index):
        if isinstance(n, list):
            for i, x in enumerate(n):
                rec(x, index + [i])
        else:
            if n.is_zero():
                return
            s = n.display()
            for v, e in enumerate(index):
                if e == 0:
                    continue
                s += _var_name(v)
                if e > 1:
                    s += f"^{e}"
            terms.append(s)

    rec(nested, [])
    if not terms:
        return "0"
    return " + ".join(terms)


def _inputs_key(inputs):
    return tuple(inputs)


class Demand:
    """Per-axis degree_p1 demand vector + the reference's uniform degree.

    The reference evaluates with a single uniform truncation degree
    (generating_function.rs:179-222): every derivative-style node bumps
    the demand of *all* variables, so an observation chain on one
    variable inflates the coefficient grids of every other variable as
    well.  Power-series ops are graded per axis, so low-order
    coefficients along one axis never depend on higher-order
    coefficients along another: demands can be tracked per variable.
    For multivariate observation-chain models this shrinks the grids
    from (base + total_inflation)^n to prod_v (base_v + inflation_v).

    ``uni`` is the uniform degree the reference would be evaluating
    this node at (root degree + every bump so far; Subst does not
    bump).  Series compositions (Subst, UniformMgf) are the one place
    per-axis grading fails: their depth is capped at ``min(uni,
    span)`` — ``uni`` reproduces the reference's truncation exactly,
    and depths beyond ``span`` contribute provably-zero terms to every
    retained coefficient (so the min never changes values, it only
    avoids needless work).

    Axes beyond the explicit length default to 1 (point value only) —
    used for aux variables appended during TaylorCoeffAtZero.
    """

    __slots__ = ("axes", "uni")

    def __init__(self, axes, uni=None):
        self.axes = tuple(axes)
        if uni is None:
            uni = max(self.axes) if self.axes else 1
        self.uni = uni

    def __len__(self):
        return len(self.axes)

    def __iter__(self):
        return iter(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        if isinstance(other, Demand):
            return self.axes == other.axes and self.uni == other.uni
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return hash((self.axes, self.uni))

    def __repr__(self):
        return f"Demand({self.axes}, uni={self.uni})"

    def axis(self, v):
        return self.axes[v] if v < len(self.axes) else 1

    @property
    def maxv(self):
        return max(self.axes) if self.axes else 1

    def bump(self, v, o):
        if o == 0:
            return self
        a = self.axes
        if v < len(a):
            na = tuple(x + o if i == v else x for i, x in enumerate(a))
        else:
            na = a + (1,) * (v - len(a)) + (1 + o,)
        return Demand(na, self.uni + o)

    def span(self, n_axes: int):
        """1 + sum of (axis demand - 1) over the first ``n_axes`` axes:
        an upper bound on the total retained degree, hence on the
        series-composition depth that can contribute to any retained
        coefficient."""
        t = 1
        for i in range(n_axes):
            x = self.axis(i)
            if x == INF_DEGREE:
                return INF_DEGREE
            t += x - 1
        return t

    def comp_depth(self, n_axes: int):
        """Series-composition depth for a replacement spanning the
        first ``n_axes`` axes: the reference's uniform degree, capped
        at the span beyond which terms vanish from every retained
        coefficient.  (Capping at span alone compounds through nested
        Substs — alarm regression; widening only to maxv loses
        observation-derivative mass — clinicalTrial2 regression.)"""
        return min(self.uni, self.span(n_axes))

    def with_axis(self, v, value):
        a = self.axes
        if v < len(a):
            if a[v] == value:
                return self
            na = tuple(value if i == v else x for i, x in enumerate(a))
        else:
            na = a + (1,) * (v - len(a)) + (value,)
        return Demand(na, self.uni)

    def join(self, other):
        if self == other:
            return self
        n = max(len(self), len(other))
        return Demand(
            (max(self.axis(i), other.axis(i)) for i in range(n)),
            max(self.uni, other.uni),
        )

    def covers(self, other) -> bool:
        n = max(len(self), len(other))
        return self.uni >= other.uni and all(
            self.axis(i) >= other.axis(i) for i in range(n)
        )

    @staticmethod
    def of(degree_p1, n_vars: int) -> "Demand":
        if isinstance(degree_p1, Demand):
            return degree_p1
        return Demand((degree_p1,) * max(n_vars, 1), degree_p1)


_EMPTY_DEMAND = Demand(())


def _trunc_demand(poly: TaylorPoly, d: Demand) -> TaylorPoly:
    degs = [d.axis(i) for i in range(len(poly.degrees_p1))]
    return poly._truncate_degrees_p1(degs)


def _tp_var(backend, v: int, x, d: Demand) -> TaylorPoly:
    """TaylorPoly.var with per-axis degree metadata from the demand."""
    p = TaylorPoly.var(backend, v, x, d.axis(v))
    degs = tuple(d.axis(i) for i in range(v + 1))
    if degs != p.degrees_p1:
        p = p._with_degrees(degs)
    return p


def _tp_var_at_zero(backend, v: int, d: Demand) -> TaylorPoly:
    p = TaylorPoly.var_at_zero(backend, v, d.axis(v))
    degs = tuple(d.axis(i) for i in range(v + 1))
    if degs != p.degrees_p1:
        p = p._with_degrees(degs)
    return p


def _recognize_observation(g, aux_var):
    """Any of the three observation-optimizer recognizers
    (reference generating_function.rs:840-914)."""
    return (
        _recognize_discrete_poisson_observation(g, aux_var)
        or _recognize_continuous_poisson_observation(g, aux_var)
        or _recognize_negative_binomial_observation(g, aux_var)
    )


def _child_demands(node, d: Demand, bypass_subst) -> list:
    """Static per-child demand vectors (upper bounds used as eval
    targets; mirrors the degree arithmetic in GenFun._eval and the
    observation optimizers in _eval_taylor_coeff_at_zero)."""
    k = node.kind
    if k in (DERIVATIVE, TAYLOR_COEFF, SHIFT_TAYLOR_AT_ZERO):
        return [d.bump(node.var, node.order)]
    if k == TAYLOR_POLYNOMIAL:
        mo = max(node.orders) if node.orders else 0
        return [d.bump(node.var, mo)]
    if k == TAYLOR_COEFF_AT_ZERO:
        g = node.args[0]
        rec = _recognize_observation(g, node.var)
        if rec is not None:
            # the optimizer evaluates g's inner child directly at the
            # param-var-bumped demand; g itself (a Subst) is never
            # evaluated — tag it so the Subst rule below passes the
            # demand through unchanged instead of widening axis v
            bypass_subst[id(g)] = g
            return [d.bump(rec[0], node.order)]
        return [d.bump(node.var, node.order)]
    if k == SUBST:
        bp = bypass_subst.get(id(node))
        if bp is not None and bp is node:
            return [d, d]
        # mirror GenFun._eval's SUBST rule: composition depth = summed
        # demand over the replacement's axes
        depth = d.comp_depth(node.args[1].used_vars())
        return [d.with_axis(node.var, max(depth, d.axis(node.var))), d]
    return [d] * len(node.args)


class _EvalCache:
    """Evaluation memo with degree-demand targets and consumer-count
    eviction.

    The reference evaluates its GF DAG with pointer-identity memoization
    keyed on exact (inputs, degree) (generating_function.rs:179-222),
    which has two costs this class removes:

    1. *Degree thrash*: a parent mix of Add and Derivative demands a
       child at several degrees, re-evaluating it once per degree — for a
       tower of N observation nodes that is O(N) full evaluations per
       node.  We pre-compute each node's maximum statically-demanded
       degree (a top-down pass over the DAG), evaluate once at that
       degree, and serve lower requests by truncation (power-series ops
       are graded, so low-order coefficients are independent of the
       truncation order).
    2. *Peak memory*: holding every intermediate tensor to the end makes
       memory proportional to the whole DAG.  We pre-count static parents
       and drop a node's cached tensors once all of them have evaluated.
       Eviction can only cost a recompute, never correctness.

    Nodes created dynamically during evaluation (observation optimizers,
    ShiftTaylorAtZero rewrites) have no static counts: they are never
    evicted and their demand is the requested degree.

    NOTE: all maps store the node object itself to pin its id — Python
    reuses ids of collected objects.
    """

    __slots__ = ("entries", "uses", "evaled", "demands")

    def __init__(self, root, degree_p1):
        if not isinstance(degree_p1, Demand):
            degree_p1 = Demand((degree_p1,))
        self.entries = {}  # id -> (node, {inputs_key: (demand, result)})
        self.evaled = {}  # id -> node: nodes whose _eval completed once
        uses = {}  # id -> [node, remaining static parent count]
        stack = [root]
        seen = {id(root): root}
        while stack:
            n = stack.pop()
            for c in n.args:
                entry = uses.get(id(c))
                if entry is not None and entry[0] is c:
                    entry[1] += 1
                else:
                    uses[id(c)] = [c, 1]
                if id(c) not in seen or seen[id(c)] is not c:
                    seen[id(c)] = c
                    stack.append(c)
        self.uses = uses
        # top-down demand propagation in topological order (Kahn on the
        # static parent counts)
        demands = {id(root): [root, degree_p1]}
        indeg = {nid: e[1] for nid, e in uses.items()}
        bypass_subst = {}
        queue = [root]
        while queue:
            n = queue.pop()
            d = demands[id(n)][1]
            child_ds = _child_demands(n, d, bypass_subst)
            for c, cdnew in zip(n.args, child_ds):
                cd = demands.get(id(c))
                if cd is not None and cd[0] is c:
                    cd[1] = cd[1].join(cdnew)
                else:
                    demands[id(c)] = [c, cdnew]
                indeg[id(c)] -= 1
                if indeg[id(c)] == 0:
                    queue.append(c)
        self.demands = demands

    def demand(self, node) -> Demand:
        d = self.demands.get(id(node))
        if d is not None and d[0] is node:
            return d[1]
        return _EMPTY_DEMAND  # dynamic node: no static demand

    def get(self, node, degree_p1, inputs):
        per = self.entries.get(id(node))
        if per is None or per[0] is not node:
            return None
        rec = per[1].get(_inputs_key(inputs))
        if rec is None or not rec[0].covers(degree_p1):
            return None
        if rec[0].axes == degree_p1.axes:
            return rec[1]
        return _trunc_demand(rec[1], degree_p1)

    def put(self, node, degree_p1, inputs, result):
        per = self.entries.get(id(node))
        if per is None or per[0] is not node:
            per = (node, {})
            self.entries[id(node)] = per
        ik = _inputs_key(inputs)
        rec = per[1].get(ik)
        if rec is None or degree_p1.covers(rec[0]):
            per[1][ik] = (degree_p1, result)

    def sole_consumer(self, node) -> bool:
        """True if at most one static parent still needs this node's
        value (dynamic nodes report False): bypassing its cache entry
        cannot cost any other consumer a recompute."""
        entry = self.uses.get(id(node))
        if entry is None or entry[0] is not node:
            return False
        return entry[1] <= 1

    def first_eval(self, node) -> bool:
        """Mark node as evaluated; True only the first time."""
        prev = self.evaled.get(id(node))
        if prev is node:
            return False
        self.evaled[id(node)] = node
        return True

    def release(self, child) -> None:
        entry = self.uses.get(id(child))
        if entry is None or entry[0] is not child:
            return  # dynamic node: no static count, never evicted
        entry[1] -= 1
        if entry[1] <= 0:
            per = self.entries.get(id(child))
            if per is not None and per[0] is child:
                del self.entries[id(child)]


def _const_term_host(poly: TaylorPoly):
    """Constant term as a host scalar, using metadata when available to
    avoid a device sync (required under tracing)."""
    if poly.const0 is not None:
        return poly.const0
    if poly.host_const is not None and poly.is_constant():
        return poly.host_const
    if poly.linear is not None:
        return poly.linear[0]
    return poly.constant_term_host()


# ----------------------------------------------------------------------
# TaylorCoeffAtZero evaluation with observation optimizers
# (reference: generating_function.rs:670-765)
# ----------------------------------------------------------------------


def _obs_chain_native(backend, arr, v, lam_f, c_f, order, dv0, discrete,
                      degrees):
    """Run the whole derivative chain in the C extension: one
    cache-resident double-buffered pass per row instead of ~5 numpy
    array passes (+ allocations) per step.  Mutates ``degrees`` to the
    final per-axis bounds on success; returns None (``degrees``
    untouched) when the native kernel is unavailable or a mid-chain
    shape case requires the generic fallback."""
    from ..taylor.host import _SERIESOPS
    from ..taylor.tensorpoly import _sat_sub

    if _SERIESOPS is None or not hasattr(_SERIESOPS, "obs_chain"):
        return None
    np_ = backend.jnp
    # precompute the per-step derivative/result lengths (must mirror the
    # numpy loop below exactly)
    cur = arr.shape[v]
    degv = degrees[v]
    Ls, newLs = [], []
    for k in range(1, order + 1):
        if cur <= 1:
            return None  # chain exhausts the array: generic path handles
        m = cur - 1
        tgt = dv0 + order - k
        L = m if tgt == INF_DEGREE else min(m, int(tgt))
        degv = _sat_sub(degv, 1)
        if tgt != INF_DEGREE:
            degv = min(degv, int(tgt))
        if discrete:
            newL = L + 1 if degv == INF_DEGREE else min(int(degv), L + 1)
            if newL < L:
                return None  # numpy path would not broadcast either
        else:
            newL = L
        Ls.append(L)
        newLs.append(newL)
        cur = newL
    if cur < 1:
        return None
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np_.ascontiguousarray(arr)
    out_shape = list(arr.shape)
    out_shape[v] = cur
    out = np_.empty(out_shape, dtype=arr.dtype)
    _SERIESOPS.obs_chain(
        arr, arr.shape, v, out, lam_f, c_f, bool(discrete),
        tuple(Ls), tuple(newLs),
    )
    degrees[v] = degv
    return TaylorPoly(backend, out, tuple(degrees))


def _fused_chain_f64(backend, gpoly, v, lam, csub, order, degree_p1,
                     discrete):
    """Run the compound-Poisson derivative chain as raw-array stencils.

    One chain step at truncation target ``tgt`` is

        R[i] = (lam/k) * (c*(i+1)*G[i+1] + i*G[i])        (discrete)
        R[i] = (lam/k) * (i+1)*G[i+1]                      (continuous)

    which is exactly ``derivative -> truncate -> mul_linear/scalar``
    (reference generating_function.rs:684-694 folds 1/k! the same way)
    but in ~3 array passes instead of ~50 Python-level TensorPoly calls
    per step.  Observation-chain models evaluate this O(n^2) times on
    the substitution lattice, so the dispatch overhead dominated
    end-to-end time (mixture: 218 observes -> 24k chain evaluations).

    Only active on concrete host-f64 backends; returns ``None`` to fall
    back to the generic TensorPoly loop (identical semantics) otherwise.
    """
    from ..numbers.scalar import F64
    from ..taylor.host import NumpyF64Backend
    from ..taylor.tensorpoly import _sat_sub

    if order < 1 or not isinstance(backend, NumpyF64Backend):
        return None
    if backend.scalar_cls is not F64 or not isinstance(lam, F64):
        return None
    if discrete and not isinstance(csub, F64):
        return None
    arr = gpoly.coeffs
    nd = arr.ndim
    if v >= nd or arr.shape[v] <= 1:
        return None
    np_ = backend.jnp
    dt = backend.dtype
    lam_f = lam.v
    c_f = csub.v if discrete else 0.0
    degrees = list(gpoly.degrees_p1)
    dv0 = degree_p1.axis(v)
    native = _obs_chain_native(
        backend, arr, v, lam_f, c_f, order, dv0, discrete, degrees
    )
    if native is not None:
        return native
    for k in range(1, order + 1):
        L0 = arr.shape[v]
        if L0 <= 1:
            # array exhausted: remaining steps collapse to the zero poly
            # with 1-sized axes, matching TaylorPoly.derivative's zero
            # case; the generic ops handle this without array work.
            return None
        # only axis v shrinks: the other axes already sit at their own
        # demand (inner was evaluated at the param-var-bumped demand)
        tgt = dv0 + order - k
        # derivative along v (keeps the k! factor): D[i] = (i+1)*G[i+1]
        m = L0 - 1
        sl = [slice(None)] * nd
        sl[v] = slice(1, L0)
        fac = np_.arange(1, m + 1, dtype=dt).reshape(
            [1] * v + [m] + [1] * (nd - v - 1)
        )
        D = arr[tuple(sl)] * fac
        degrees[v] = _sat_sub(degrees[v], 1)
        if tgt != INF_DEGREE:
            t = int(tgt)
            if D.shape[v] > t:
                sl_t = [slice(None)] * nd
                sl_t[v] = slice(0, t)
                D = D[tuple(sl_t)]
            degrees[v] = min(degrees[v], t)
        L = D.shape[v]
        if discrete:
            # multiply by (c + x_v): shift-by-one plus c-scaled copy
            deg_v = degrees[v]
            newL = L + 1 if deg_v == INF_DEGREE else min(int(deg_v), L + 1)
            shape_res = list(D.shape)
            shape_res[v] = newL
            res = np_.zeros(shape_res, dtype=dt)
            sl_dst = [slice(None)] * nd
            sl_dst[v] = slice(1, newL)
            sl_src = [slice(None)] * nd
            sl_src[v] = slice(0, newL - 1)
            res[tuple(sl_dst)] = D[tuple(sl_src)]
            sl_head = [slice(None)] * nd
            sl_head[v] = slice(0, L)
            res[tuple(sl_head)] += c_f * D
        else:
            res = D
        res = res * (lam_f / float(k))
        arr = res
    return TaylorPoly(backend, arr, tuple(degrees))


def _eval_taylor_coeff_at_zero(g, v, order, backend, inputs, degree_p1, cache):
    T = backend.scalar_cls
    rec = _recognize_discrete_poisson_observation(g, v)
    if rec is not None:
        # compound Poisson (discrete parameter): iterate D(G) = λ·y·G'(y)
        # then substitute y -> e^(-λ)·y, folding 1/n! per step
        # (reference: generating_function.rs:678-694).
        # The chain is applied as a direct TensorPoly loop instead of
        # building 3·order dynamic GenFun nodes per (re-)evaluation: the
        # op sequence (derivative, multiply by the var polynomial,
        # scalar scale, then the diagonal e^{-λ·i} substitution scaling)
        # is identical to what evaluating the rewritten DAG performs, so
        # results match bit for bit while skipping the node allocation
        # and per-node cache bookkeeping that dominated observation-chain
        # models (mixture: 218 observations, re-evaluated O(n) times
        # each under distinct substituted inputs).
        param_var, lam, inner = rec
        a = (-lam).exp()
        # the substitution's Taylor series around the current input:
        # a·(x0 + dy) — its constant term becomes the new input point
        sub = TaylorPoly.from_scalar(backend, a) * _tp_var(
            backend, param_var, inputs[param_var], degree_p1
        )
        csub = _const_term_host(sub)
        sub0 = sub - TaylorPoly.from_scalar(backend, csub)
        new_inputs = list(inputs)
        new_inputs[param_var] = csub
        gpoly = inner.eval_with(
            backend, new_inputs, degree_p1.bump(param_var, order), cache
        )
        inner_const0 = gpoly.const0
        fused = _fused_chain_f64(
            backend, gpoly, param_var, lam, csub, order, degree_p1, True
        )
        if fused is not None:
            gpoly = fused
        else:
            for k in range(1, order + 1):
                tgt = degree_p1.axis(param_var) + order - k
                step_d = degree_p1.with_axis(param_var, tgt)
                var_poly = _tp_var(backend, param_var, csub, step_d)
                gpoly = (
                    _trunc_demand(gpoly.derivative(param_var, 1), step_d)
                    * var_poly
                ) * TaylorPoly.from_scalar(backend, lam / T.from_u32(k))
        gpoly = _trunc_demand(gpoly, degree_p1)
        result = gpoly.subst_var(param_var, sub0)
        if result.const0 is None:
            result.const0 = gpoly.const0 if order > 0 else inner_const0
        return _trunc_demand(result, degree_p1)
    rec = _recognize_continuous_poisson_observation(g, v)
    if rec is not None:
        # compound Poisson (continuous parameter): D(G) = λ·G'(y), then
        # substitute y -> y - λ (reference: 695-711).  Same fused
        # evaluation as the discrete case; the final substitution is
        # y -> x0 - λ + dy (slope one), i.e. only the evaluation point
        # moves — no coefficient rescaling is needed.
        param_var, lam, inner = rec
        c0 = inputs[param_var] + (-lam)
        new_inputs = list(inputs)
        new_inputs[param_var] = c0
        gpoly = inner.eval_with(
            backend, new_inputs, degree_p1.bump(param_var, order), cache
        )
        fused = _fused_chain_f64(
            backend, gpoly, param_var, lam, None, order, degree_p1, False
        )
        if fused is not None:
            gpoly = fused
        else:
            for k in range(1, order + 1):
                tgt = degree_p1.axis(param_var) + order - k
                step_d = degree_p1.with_axis(param_var, tgt)
                gpoly = _trunc_demand(
                    gpoly.derivative(param_var, 1), step_d
                ) * TaylorPoly.from_scalar(backend, lam / T.from_u32(k))
        return _trunc_demand(gpoly, degree_p1)
    rec = _recognize_negative_binomial_observation(g, v)
    if rec is not None:
        # NegBinomial via Lah-number recurrence (reference: 712-751)
        param_var, p, inner = rec
        one_mp = T.one() - p
        lahs = [T.one()]
        for d in range(1, order + 1):
            nxt = []
            for i in range(d + 1):
                lah_dm1_i = lahs[i] if i < len(lahs) else T.zero()
                lah_dm1_im1 = lahs[i - 1] if 1 <= i <= len(lahs) else T.zero()
                lah_d_i = (
                    one_mp
                    / T.from_u32(d)
                    * (lah_dm1_i * T.from_u32(d + i - 1) + lah_dm1_im1)
                )
                nxt.append(lah_d_i)
            lahs = nxt
        total = TaylorPoly.zero_with(
            backend, tuple(degree_p1.axis(i) for i in range(len(inputs)))
        )
        new_inputs = list(inputs)
        new_inputs[param_var] = p * inputs[param_var]
        inner_result = inner.eval_with(
            backend, new_inputs, degree_p1.bump(param_var, order), cache
        )
        p_var_power = TaylorPoly.one(backend)
        param_var_tp = _tp_var(backend, param_var, inputs[param_var], degree_p1)
        p_param_var = TaylorPoly.from_scalar(backend, p) * param_var_tp
        for lah in lahs:
            subst = TaylorPoly.from_scalar(backend, p) * _tp_var_at_zero(
                backend, param_var, degree_p1
            )
            total = total + (
                inner_result.subst_var(param_var, subst)
                * p_var_power
                * TaylorPoly.from_scalar(backend, lah)
            )
            p_var_power = p_var_power * p_param_var
            inner_result = inner_result.derivative(param_var, 1)
        return _trunc_demand(total, degree_p1)
    # general case (reference: 752-765)
    T = backend.scalar_cls
    new_inputs = list(inputs)
    if v == len(inputs):
        new_inputs.append(T.zero())
        taylor = g.eval_with(
            backend, new_inputs, degree_p1.bump(v, order), cache
        )
        result = taylor.coefficients_of_term(v, order).remove_last_variable()
    else:
        new_inputs[v] = T.zero()
        taylor = g.eval_with(
            backend, new_inputs, degree_p1.bump(v, order), cache
        )
        result = taylor.coefficients_of_term(v, order)
    return _trunc_demand(result, degree_p1)


# pattern recognizers (reference: generating_function.rs:840-914)

def _recognize_discrete_poisson_observation(g: GenFun, aux_var: int):
    """Match Subst(inner, w, w * exp(λ·(x_aux - 1)))."""
    if g.kind != SUBST:
        return None
    inner, repl = g.args
    param_var = g.var
    if repl.kind != MUL:
        return None
    lhs, rhs = repl.args
    if not (lhs.kind == VAR and lhs.var == param_var):
        return None
    if rhs.kind != EXP:
        return None
    h = rhs.args[0]
    if h.kind != MUL:
        return None
    c, d = h.args
    if c.kind != CONST:
        return None
    if _is_var_minus_one(d, aux_var):
        return (param_var, c.value, inner)
    return None


def _recognize_continuous_poisson_observation(g: GenFun, aux_var: int):
    """Match Subst(inner, w, w + λ·(x_aux - 1))."""
    if g.kind != SUBST:
        return None
    inner, repl = g.args
    param_var = g.var
    if repl.kind != ADD:
        return None
    lhs, rhs = repl.args
    if not (lhs.kind == VAR and lhs.var == param_var):
        return None
    if rhs.kind != MUL:
        return None
    c, d = rhs.args
    if c.kind != CONST:
        return None
    if _is_var_minus_one(d, aux_var):
        return (param_var, c.value, inner)
    return None


def _recognize_negative_binomial_observation(g: GenFun, aux_var: int):
    """Match Subst(inner, w, w * (p / (1 - (1-p)·x_aux)))."""
    if g.kind != SUBST:
        return None
    inner, repl = g.args
    param_var = g.var
    if repl.kind != MUL:
        return None
    lhs, rhs = repl.args
    if not (lhs.kind == VAR and lhs.var == param_var):
        return None
    if rhs.kind != DIV:
        return None
    num, den = rhs.args
    if num.kind != CONST:
        return None
    p = num.value
    expected = GenFun.one(type(p)) - GenFun.constant(
        type(p).one() - p
    ) * GenFun.var_(aux_var)
    if den == expected:
        return (param_var, p, inner)
    return None


def _is_var_minus_one(node: GenFun, v: int) -> bool:
    """Match ``Var(v) - 1``: ``Add(Var(v), Neg(Const(1)))`` or, with the
    constant-folding smart constructors, ``Add(Var(v), Const(-1))``."""
    if node.kind != ADD:
        return False
    a, b = node.args
    if not (a.kind == VAR and a.var == v):
        return False
    if b.kind == NEG:
        c = b.args[0]
        return c.kind == CONST and c.value.is_one()
    if b.kind == CONST:
        return (-b.value).is_one()
    return False
