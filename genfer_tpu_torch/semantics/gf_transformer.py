"""Program -> generating-function statement transformers
(reference: src/semantics/gf.rs).

Encoding convention (reference: semantics/gf.rs:637-649): each program
variable is one formal variable of the GF; discrete variables use the PGF
convention (marginalize by substituting 1), continuous variables use the
MGF convention E[e^(vX)] (marginalize by substituting 0).
"""

from __future__ import annotations

import os as _os
import sys

from ..gf.ir import GenFun
from ..taylor.tensorpoly import CHECK_INVARIANTS as _CHECK
from ..lang import ast
from .support_transform import SupportTransformer
from .supportset import SupportSet, VarSupport


class GfTranslation:
    """Translation state (reference: semantics/gf.rs:12-19): ``rest``
    over-approximates probability mass lost to unfinished loop iterations."""

    __slots__ = ("var_info", "gf", "rest", "rest_info")

    def __init__(self, var_info, gf, rest, rest_info):
        self.var_info = var_info
        self.gf = gf
        self.rest = rest
        self.rest_info = rest_info

    @staticmethod
    def zero(T, num_vars: int) -> "GfTranslation":
        return GfTranslation(
            VarSupport.empty(num_vars),
            GenFun.zero(T),
            GenFun.zero(T),
            VarSupport.empty(num_vars),
        )

    def join(self, other: "GfTranslation") -> "GfTranslation":
        """If-branch join: gfs add, rests take the max
        (reference: semantics/gf.rs:31-44)."""
        return GfTranslation(
            self.var_info.join(other.var_info),
            self.gf + other.gf,
            self.rest.max_(other.rest),
            self.rest_info.join(other.rest_info),
        )

    def add(self, other: "GfTranslation") -> "GfTranslation":
        return GfTranslation(
            self.var_info.join(other.var_info),
            self.gf + other.gf,
            self.rest + other.rest,
            self.rest_info.join(other.rest_info),
        )

    def mul_const(self, factor) -> "GfTranslation":
        return GfTranslation(
            self.var_info,
            self.gf * GenFun.constant(factor),
            self.rest * GenFun.constant(factor),
            self.rest_info,
        )


class GfTransformer:
    def __init__(self, T, unroll: int = 0):
        self.T = T
        self.unroll = unroll
        self.support = SupportTransformer(unroll=unroll)

    # -- Transformer trait ----------------------------------------------
    def init(self, program: ast.Program) -> GfTranslation:
        var_info = self.support.init(program)
        return GfTranslation(
            var_info,
            GenFun.one(self.T),
            GenFun.zero(self.T),
            VarSupport.empty(var_info.num_vars()),
        )

    def semantics(self, program: ast.Program) -> GfTranslation:
        return self.transform_statements(program.stmts, self.init(program))

    def transform_statements(self, stmts, init: GfTranslation) -> GfTranslation:
        cur = init
        i = 0
        n = len(stmts)
        while i < n:
            j = self._cont_poisson_run_end(stmts, i, cur.var_info)
            if j > i + 1:
                cur = self._fuse_cont_poisson_observes(
                    stmts[i:j], cur
                )
                i = j
            else:
                cur = self.transform_statement(stmts[i], cur)
                i += 1
        return cur

    # -- fused continuous-Poisson observation runs ----------------------
    # A run of `observe c_i ~ Poisson(f_i * x)` on one continuous x
    # composes in MGF space to a single operation:
    #     G'(t) = (prod f_i^{c_i} / c_i!) * G^{(sum c_i)}(t - sum f_i)
    # (each observe multiplies the density by x^{c_i} e^{-f_i x} times a
    # constant; x^c <-> the c-th t-derivative, e^{-fx} <-> shifting t).
    # The reference applies the observes one at a time
    # (semantics/gf.rs:538-587 + the per-observe optimizer chains of
    # generating_function.rs:670-765); fusing a 111-observation
    # switchpoint branch replaces ~400 DAG nodes by 3.  Disable with
    # GENFER_NO_FUSE_OBS=1.
    def _cont_poisson_obs(self, stmt, var_info):
        """(c, rate_ratio, x) if stmt is observe-sugar for a
        continuous-rate Poisson data event, else None."""
        if not isinstance(stmt, ast.IfThenElse):
            return None
        ev = stmt.recognize_observe()
        if not isinstance(ev, ast.DataFromDist):
            return None
        d = ev.dist
        if not isinstance(d, ast.PoissonVarRate):
            return None
        if isinstance(d.rate, ast.ParamRatio):
            return None
        if var_info[d.var].is_discrete() or var_info[d.var].is_empty():
            return None
        return ev.data, d.rate, d.var

    def _cont_poisson_run_end(self, stmts, i, var_info) -> int:
        if _os.environ.get("GENFER_NO_FUSE_OBS"):
            return i
        first = self._cont_poisson_obs(stmts[i], var_info)
        if first is None:
            return i
        x = first[2]
        j = i + 1
        while j < len(stmts):
            nxt = self._cont_poisson_obs(stmts[j], var_info)
            if nxt is None or nxt[2] != x:
                break
            j += 1
        return j

    #: max total derivative order per fused chunk: the intermediate
    #: G^(M) inflates coefficients by ~(k+M)!/k! before the chunk's
    #: compensating constant (prod f^c/c!) brings them back; M <= 64
    #: keeps the inflation far from the f64 overflow threshold (the
    #: unnormalized MGF coefficients themselves are <= O(1))
    _FUSE_MAX_ORDER = 64

    def _fuse_cont_poisson_observes(self, run, translation: GfTranslation):
        T = self.T
        var_info = translation.var_info
        gf = translation.gf
        i = 0
        while i < len(run):
            total_c = 0
            total_f = T.zero()
            factor = T.one()
            j = i
            while j < len(run):
                c, f, _ = self._cont_poisson_obs(run[j], var_info)
                if j > i and total_c + c > self._FUSE_MAX_ORDER:
                    break
                fs = ast.ratio_to_scalar(T, f)
                total_c += c
                total_f = total_f + fs
                factor = factor * fs.pow_u32(c)
                for k in range(2, c + 1):
                    factor = factor / T.from_u32(k)
                j += 1
            x = self._cont_poisson_obs(run[i], var_info)[2]
            if total_c > 0:
                gf = gf.derive(x, total_c)
            gf = gf.substitute_var(
                x, GenFun.var_(x) - GenFun.constant(total_f)
            )
            gf = GenFun.constant(factor) * gf
            i = j
        return GfTranslation(
            var_info.clone(), gf, translation.rest,
            translation.rest_info.clone(),
        )

    # -- event conditioning (reference: semantics/gf.rs:98-205) ---------
    def transform_event(self, event: ast.Event, init: GfTranslation):
        T = self.T
        var_info = init.var_info.clone()
        rest_info = init.rest_info.clone()
        rest = init.rest
        gf = init.gf

        def gf_in_set(var: int, values, g: GenFun) -> GenFun:
            if len(values) == 1:
                order = values[0]
                return g.taylor_coeff_at_zero(var, order) * GenFun.var_(var).pow(
                    order
                )
            return g.taylor_polynomial_at_zero(var, list(values))

        if isinstance(event, ast.InSet):
            new_gf = gf_in_set(event.var, list(event.set), gf)
        elif isinstance(event, ast.VarComparison):
            v1, comp, v2 = event.v1, event.comp, event.v2
            if var_info.is_empty():
                # unreachable program point: no mass to condition
                # (the reference panics here; an empty support means the
                # surrounding branch is dead, so zero is the exact answer)
                then_info, else_info = self.support.transform_event(
                    event, var_info
                )
                zero = GenFun.zero(T)
                return (
                    GfTranslation(then_info, zero, rest, rest_info.clone()),
                    GfTranslation(
                        else_info, init.gf - zero, rest, rest_info.clone()
                    ),
                )
            r1 = var_info[v1].finite_nonempty_range()
            r2 = var_info[v2].finite_nonempty_range()
            if r1 is None and r2 is None:
                raise AssertionError(
                    "Cannot compare two variables with infinite support."
                )
            if r1 is None:
                scrutinee, other, reversed_, rng = v2, v1, False, r2
            elif r2 is None:
                scrutinee, other, reversed_, rng = v1, v2, True, r1
            elif (r1.stop - r1.start) <= (r2.stop - r2.start):
                scrutinee, other, reversed_, rng = v1, v2, True, r1
            else:
                scrutinee, other, reversed_, rng = v2, v1, False, r2
            result = GenFun.zero(T)
            for i in rng:
                gf_eq_i = gf_in_set(scrutinee, [i], gf)
                if comp == ast.Comparison.EQ:
                    summand = gf_in_set(other, [i], gf_eq_i)
                elif comp == ast.Comparison.LT and not reversed_:
                    summand = gf_in_set(other, list(range(i)), gf_eq_i)
                elif comp == ast.Comparison.LT:
                    summand = gf_eq_i - gf_in_set(
                        other, list(range(i + 1)), gf_eq_i
                    )
                elif comp == ast.Comparison.LE and not reversed_:
                    summand = gf_in_set(other, list(range(i + 1)), gf_eq_i)
                else:
                    summand = gf_eq_i - gf_in_set(other, list(range(i)), gf_eq_i)
                result = result + summand
            new_gf = result
        elif isinstance(event, ast.DataFromDist):
            factor = event.recognize_const_prob(T)
            if factor is not None:
                new_gf = GenFun.constant(factor) * gf
            else:
                new_gf = self.transform_data_from_dist(
                    event.data, event.dist, var_info, gf
                )
        elif isinstance(event, ast.Complement):
            _, els = self.transform_event(event.event, init)
            new_gf = els.gf
        elif isinstance(event, ast.Intersection):
            then_result = init
            for e in event.events:
                then_result, _ = self.transform_event(e, then_result)
            new_gf = then_result.gf
        else:
            raise AssertionError(f"unknown event {event}")

        then_info, else_info = self.support.transform_event(event, var_info)
        then_rest_info, else_rest_info = self.support.transform_event(
            event, rest_info
        )
        then_t = GfTranslation(then_info, new_gf, rest, then_rest_info)
        else_t = GfTranslation(else_info, init.gf - new_gf, rest, else_rest_info)
        return then_t, else_t

    # -- statements (reference: semantics/gf.rs:208-348) ----------------
    def transform_statement(self, stmt, init: GfTranslation) -> GfTranslation:
        T = self.T
        direct_var_info = None
        if _CHECK:
            direct_var_info = self.support.transform_statement(
                stmt, init.var_info.clone()
            )
        if isinstance(stmt, ast.Sample):
            result = self.transform_distribution(
                stmt.distribution, stmt.var, init, stmt.add_previous_value
            )
        elif isinstance(stmt, ast.Assign):
            v = stmt.var
            gf = init.gf
            var_info = init.var_info
            var = GenFun.var_(v)
            v_exp = 1 if stmt.add_previous_value else 0
            w_subst = None
            if stmt.addend is not None:
                factor, w = stmt.addend
                if v == w:
                    v_exp += factor
                elif var_info[w].is_discrete():
                    w_subst = (w, GenFun.var_(w) * var.pow(factor))
                else:
                    assert not (
                        var_info[v].is_discrete() and stmt.add_previous_value
                    ), "cannot add a continuous to a discrete variable"
                    w_subst = (w, GenFun.var_(w) + var * GenFun.from_u32(T, factor))
            if var_info[v].is_discrete():
                gf = gf.substitute_var(v, var.pow(v_exp))
            else:
                gf = gf.substitute_var(v, var * GenFun.from_u32(T, v_exp))
            if w_subst is not None:
                gf = gf.substitute_var(w_subst[0], w_subst[1])
            new_var_info = self.support.transform_statement(stmt, var_info)
            new_rest_info = self.support.transform_statement(stmt, init.rest_info)
            if new_var_info[v].is_discrete():
                gf = gf * var.pow(stmt.offset)
            else:
                gf = gf * (var * GenFun.from_u32(T, stmt.offset)).exp()
            result = GfTranslation(new_var_info, gf, init.rest, new_rest_info)
        elif isinstance(stmt, ast.Decrement):
            v = stmt.var
            assert init.var_info[v].is_discrete(), (
                "cannot decrement continuous variables"
            )
            new_var_info = self.support.transform_statement(stmt, init.var_info)
            new_rest_info = self.support.transform_statement(stmt, init.rest_info)
            gf = init.gf.shift_down_taylor_at_zero(v, stmt.offset)
            result = GfTranslation(new_var_info, gf, init.rest, new_rest_info)
        elif isinstance(stmt, ast.IfThenElse):
            factor = stmt.cond.recognize_const_prob(T)
            if factor is not None:
                # avoid path explosion by blending after transforming both
                # branches on the whole GF (reference: gf.rs:302-310)
                t_then = self.transform_statements(stmt.then, init)
                t_else = self.transform_statements(stmt.els, init)
                t_then = t_then.mul_const(factor)
                t_else = t_else.mul_const(T.one() - factor)
                result = t_then.add(t_else)
            else:
                then_before, else_before = self.transform_event(stmt.cond, init)
                then_after = self.transform_statements(stmt.then, then_before)
                else_after = self.transform_statements(stmt.els, else_before)
                result = then_after.join(else_after)
        elif isinstance(stmt, ast.While):
            print(
                "WARNING: support for while loops is EXPERIMENTAL",
                file=sys.stderr,
            )
            print(
                "WARNING: results are APPROXIMATE due to presence of loops: "
                "exact inference is only possible for loop-free programs"
            )
            result = GfTranslation.zero(T, init.var_info.num_vars())
            rest = init
            count = stmt.unroll if stmt.unroll is not None else self.unroll
            for _ in range(count):
                loop_enter, loop_exit = self.transform_event(stmt.cond, rest)
                result = result.join(loop_exit)
                rest = self.transform_statements(stmt.body, loop_enter)
            result.rest = result.rest + marginalize_all(T, rest.gf, rest.var_info)
            invariant = self.support.find_while_invariant(
                stmt.cond, stmt.body, rest.var_info
            )
            _, loop_exit = self.support.transform_event(stmt.cond, invariant.clone())
            result.rest_info = result.rest_info.join(loop_exit)
            result.var_info = result.var_info.join(result.rest_info)
        elif isinstance(stmt, ast.Fail):
            result = GfTranslation.zero(T, init.var_info.num_vars())
        elif isinstance(stmt, ast.Normalize):
            result = self.transform_normalize(stmt.given_vars, stmt.stmts, init)
        else:
            raise AssertionError(f"unknown statement {stmt}")
        if _CHECK and direct_var_info is not None:
            assert result.var_info == direct_var_info, (
                f"inconsistent variable support info for:\n{stmt}"
            )
        return result

    # -- distributions (reference: semantics/gf.rs:358-536) -------------
    @staticmethod
    def _compound_dist(gf, base, sampled_var, param_var, add_previous_value,
                       param_var_discrete, subst):
        """reference: semantics/gf.rs:358-386."""
        if sampled_var == param_var:
            if add_previous_value:
                if param_var_discrete:
                    substitution = GenFun.var_(param_var) * subst
                else:
                    substitution = GenFun.var_(param_var) + subst
                return gf.substitute_var(param_var, substitution)
            return gf.substitute_var(param_var, subst)
        if param_var_discrete:
            substitution = GenFun.var_(param_var) * subst
        else:
            substitution = GenFun.var_(param_var) + subst
        return base.substitute_var(param_var, substitution)

    def transform_distribution(self, dist, v, translation: GfTranslation,
                               add_previous_value: bool) -> GfTranslation:
        T = self.T
        if add_previous_value:
            base = translation.gf
        else:
            base = marginalize_out(T, v, translation.gf, translation.var_info)
        new_var_info = SupportTransformer.transform_distribution(
            dist, v, translation.var_info, add_previous_value
        )
        new_rest_info = SupportTransformer.transform_distribution(
            dist, v, translation.rest_info, add_previous_value
        )
        gf = translation.gf
        var = GenFun.var_(v)

        def rat(r):
            return GenFun.constant(ast.ratio_to_scalar(T, r))

        if isinstance(dist, ast.Dirac):
            a = dist.a.as_integer()
            if a is not None:
                dirac = var.pow(a)
            else:
                dirac = (var * rat(dist.a)).exp()
            new_gf = dirac * base
        elif isinstance(dist, ast.Bernoulli):
            bernoulli = rat(dist.p) * var + rat(dist.p.complement())
            new_gf = bernoulli * base
        elif isinstance(dist, ast.BernoulliVarProb):
            w = dist.var
            if translation.var_info[w].is_discrete():
                prob_times_gf = gf.derive(w, 1) * GenFun.var_(w)
            else:
                prob_times_gf = gf.derive(w, 1)
            if add_previous_value:
                prob_times_base = prob_times_gf
            else:
                prob_times_base = marginalize_out(
                    T, v, prob_times_gf, translation.var_info
                )
            if new_var_info[v].is_discrete():
                v_term = var
            else:
                v_term = var.exp()
            new_gf = base + (v_term - GenFun.one(T)) * prob_times_base
        elif isinstance(dist, ast.BinomialVarTrials):
            subst = rat(dist.p) * var + rat(dist.p.complement())
            new_gf = self._compound_dist(
                gf, base, v, dist.var, add_previous_value, True, subst
            )
        elif isinstance(dist, ast.Binomial):
            binomial = (rat(dist.p) * var + rat(dist.p.complement())).pow(dist.n)
            new_gf = binomial * base
        elif isinstance(dist, ast.Categorical):
            categorical = GenFun.zero(T)
            for r in reversed(dist.rs):
                categorical = categorical * var
                categorical = categorical + rat(r)
            new_gf = categorical * base
        elif isinstance(dist, ast.NegBinomialVarSuccesses):
            subst = rat(dist.p) / (
                GenFun.one(T) - rat(dist.p.complement()) * var
            )
            new_gf = self._compound_dist(
                gf, base, v, dist.var, add_previous_value, True, subst
            )
        elif isinstance(dist, ast.NegBinomial):
            geometric = rat(dist.p) / (
                GenFun.one(T) - rat(dist.p.complement()) * var
            )
            new_gf = geometric.pow(dist.n) * base
        elif isinstance(dist, ast.Geometric):
            geometric = rat(dist.p) / (
                GenFun.one(T) - rat(dist.p.complement()) * var
            )
            new_gf = geometric * base
        elif isinstance(dist, ast.Poisson):
            poisson = (rat(dist.rate) * (var - GenFun.one(T))).exp()
            new_gf = poisson * base
        elif isinstance(dist, ast.PoissonVarRate):
            w = dist.var
            w_discrete = translation.var_info[w].is_discrete()
            if w_discrete:
                subst = (rat(dist.rate) * (var - GenFun.one(T))).exp()
            else:
                subst = rat(dist.rate) * (var - GenFun.one(T))
            new_gf = self._compound_dist(
                gf, base, v, w, add_previous_value, w_discrete, subst
            )
        elif isinstance(dist, ast.UniformDisc):
            assert dist.end > dist.start, "Uniform distribution cannot have length 0"
            length = dist.end - dist.start
            weight = rat(ast.PosRatio(1, length))
            uniform = GenFun.zero(T)
            for _ in range(length):
                uniform = weight + var * uniform
            uniform = uniform * var.pow(dist.start)
            new_gf = uniform * base
        elif isinstance(dist, ast.Exponential):
            beta = rat(dist.rate)
            exponential = beta / (beta - var)
            new_gf = exponential * base
        elif isinstance(dist, ast.Gamma):
            beta = rat(dist.rate)
            shape_int = dist.shape.as_integer()
            if shape_int is not None:
                gamma = (beta / (beta - var)).pow(shape_int)
            else:
                gamma = (rat(dist.shape) * (beta.log() - (beta - var).log())).exp()
            new_gf = gamma * base
        elif isinstance(dist, ast.UniformCont):
            width = ast.ratio_to_scalar(T, dist.end) - ast.ratio_to_scalar(
                T, dist.start
            )
            x = GenFun.constant(width) * var
            uniform = GenFun.uniform_mgf(x) * (rat(dist.start) * var).exp()
            new_gf = uniform * base
        else:
            raise AssertionError(f"unknown distribution {dist}")
        return GfTranslation(new_var_info, new_gf, translation.rest, new_rest_info)

    # -- observed data (reference: semantics/gf.rs:538-587) -------------
    def transform_data_from_dist(self, data: int, dist, var_info, gf: GenFun):
        T = self.T
        if isinstance(dist, ast.BernoulliVarProb):
            w = dist.var
            if var_info[w].is_discrete():
                prob_times_gf = gf.derive(w, 1) * GenFun.var_(w)
            else:
                prob_times_gf = gf.derive(w, 1)
            if data == 0:
                return gf - prob_times_gf
            if data == 1:
                return prob_times_gf
            return GenFun.zero(T)
        if isinstance(dist, ast.BinomialVarTrials):
            w = dist.var
            replacement = GenFun.constant(
                ast.ratio_to_scalar(T, dist.p.complement())
            ) * GenFun.var_(w)
            return gf.taylor_coeff(w, data).substitute_var(w, replacement) * (
                GenFun.constant(ast.ratio_to_scalar(T, dist.p)) * GenFun.var_(w)
            ).pow(data)
        # general case: sample into a fresh temporary variable, extract the
        # coefficient, marginalize the temporary out (reference: 565-586)
        new_var = gf.used_vars()
        sample_stmt = ast.Sample(
            var=new_var, distribution=dist, add_previous_value=False
        )
        translation = GfTranslation(
            var_info.clone(),
            gf,
            GenFun.zero(T),
            VarSupport.empty(var_info.num_vars()),
        )
        new_translation = self.transform_statement(sample_stmt, translation)
        out = new_translation.gf.taylor_coeff_at_zero(new_var, data)
        return marginalize_out(T, new_var, out, new_translation.var_info)

    # -- normalize blocks (reference: semantics/gf.rs:589-634) ----------
    def transform_normalize(self, given_vars, block, translation: GfTranslation):
        T = self.T
        if not given_vars:
            total_before = marginalize_all(T, translation.gf, translation.var_info)
            rest_before = translation.rest
            translation = self.transform_statements(block, translation)
            total_after = marginalize_all(T, translation.gf, translation.var_info)
            rest_after = translation.rest
            min_factor = total_before / (total_after + rest_after)
            max_factor = (total_before + rest_before) / total_after
            return GfTranslation(
                translation.var_info,
                min_factor * translation.gf,
                max_factor * translation.rest,
                translation.rest_info,
            )
        v = given_vars[0]
        rest_vars = given_vars[1:]
        support = translation.var_info[v]
        rng = support.finite_nonempty_range()
        assert rng is not None, (
            f"Cannot normalize with respect to variable `{ast.var_name(v)}`, "
            "because its value could not be proven to be bounded."
        )
        joined = GfTranslation.zero(T, translation.var_info.num_vars())
        for i in rng:
            summand_gf = translation.gf.taylor_coeff_at_zero(v, i) * GenFun.var_(
                v
            ).pow(i)
            var_info = translation.var_info.clone()
            var_info.set(v, SupportSet.point(i))
            rest_info = translation.rest_info.clone()
            rest_info.set(v, SupportSet.point(i))
            summand = GfTranslation(
                var_info, summand_gf, translation.rest, rest_info
            )
            result = self.transform_normalize(rest_vars, block, summand)
            joined = joined.join(result)
        return joined


def marginalize_out(T, v: int, gf: GenFun, var_info: VarSupport) -> GenFun:
    """Substitute 1 (discrete, PGF) or 0 (continuous, MGF) for a variable
    (reference: semantics/gf.rs:637-649).  A variable index equal to
    num_vars is the temporary introduced for ``observe c ~ D(X)`` events
    and is always discrete."""
    if v >= var_info.num_vars():
        assert v == var_info.num_vars()
        return gf.substitute_var(v, GenFun.one(T))
    if var_info[v].is_discrete():
        return gf.substitute_var(v, GenFun.one(T))
    return gf.substitute_var(v, GenFun.zero(T))


def marginalize_all(T, gf: GenFun, var_info: VarSupport) -> GenFun:
    result = gf
    for v in range(var_info.num_vars()):
        result = marginalize_out(T, v, result, var_info)
    return result
