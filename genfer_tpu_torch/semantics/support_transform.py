"""Abstract interpreter computing variable supports
(reference: src/semantics/support.rs:148-386 and the Transformer trait,
src/semantics/mod.rs:6-26)."""

from __future__ import annotations

from fractions import Fraction

from ..lang import ast
from .supportset import SupportSet, VarSupport


class SupportTransformer:
    def __init__(self, unroll: int = 0):
        self.unroll = unroll

    # -- Transformer trait (reference: semantics/mod.rs) ----------------
    def init(self, program: ast.Program) -> VarSupport:
        return VarSupport.zero(program.used_vars())

    def semantics(self, program: ast.Program) -> VarSupport:
        return self.transform_statements(program.stmts, self.init(program))

    def transform_statements(self, stmts, init: VarSupport) -> VarSupport:
        cur = init
        for stmt in stmts:
            cur = self.transform_statement(stmt, cur)
        return cur

    # -- events (reference: semantics/support.rs:167-193) ---------------
    def transform_event(self, event: ast.Event, init: VarSupport):
        if isinstance(event, ast.InSet):
            then_support = init.clone()
            then_support.update(event.var, lambda s: s.retain_only(event.set))
            else_support = init.clone()
            else_support.update(event.var, lambda s: s.remove_all(event.set))
            return then_support, else_support
        if isinstance(event, (ast.DataFromDist, ast.VarComparison)):
            return init.clone(), init.clone()
        if isinstance(event, ast.Complement):
            then_s, else_s = self.transform_event(event.event, init)
            return else_s, then_s
        if isinstance(event, ast.Intersection):
            else_support = VarSupport.empty(init.num_vars())
            then_support = init
            for e in event.events:
                new_then, new_else = self.transform_event(e, then_support)
                then_support = new_then
                else_support = else_support.join(new_else)
            return then_support, else_support
        raise AssertionError(f"unknown event {event}")

    # -- statements (reference: semantics/support.rs:195-256) -----------
    def transform_statement(self, stmt: ast.Statement, init: VarSupport) -> VarSupport:
        if isinstance(stmt, ast.Sample):
            return self.transform_distribution(
                stmt.distribution, stmt.var, init, stmt.add_previous_value
            )
        if isinstance(stmt, ast.Assign):
            new_support = init[stmt.var]
            if not stmt.add_previous_value:
                new_support = SupportSet.zero()
            if stmt.addend is not None:
                factor, w = stmt.addend
                new_support = new_support + init[w].mul_const(factor)
            new_support = new_support + SupportSet.point(stmt.offset)
            res = init.clone()
            res.set(stmt.var, new_support)
            return res
        if isinstance(stmt, ast.Decrement):
            res = init.clone()
            res.update(stmt.var, lambda s: s.saturating_sub(stmt.offset))
            return res
        if isinstance(stmt, ast.IfThenElse):
            then_res, else_res = self.transform_event(stmt.cond, init)
            then_res = self.transform_statements(stmt.then, then_res)
            else_res = self.transform_statements(stmt.els, else_res)
            return then_res.join(else_res)
        if isinstance(stmt, ast.While):
            unroll_count = stmt.unroll if stmt.unroll is not None else self.unroll
            fix = self.find_unroll_fixpoint(stmt.cond, stmt.body, init.clone())
            if fix is not None:
                unroll_count = max(unroll_count, fix[0])
            pre_loop = init
            rest = VarSupport.empty(pre_loop.num_vars())
            for _ in range(unroll_count):
                new_pre_loop, loop_exit = self.one_iteration(
                    pre_loop.clone(), stmt.body, stmt.cond
                )
                rest = rest.join(loop_exit)
                pre_loop = new_pre_loop
            invariant = self.find_while_invariant(stmt.cond, stmt.body, pre_loop)
            _, loop_exit = self.transform_event(stmt.cond, invariant.clone())
            return rest.join(loop_exit)
        if isinstance(stmt, ast.Fail):
            return VarSupport.empty(init.num_vars())
        if isinstance(stmt, ast.Normalize):
            return self.transform_normalize(stmt.given_vars, stmt.stmts, init)
        raise AssertionError(f"unknown statement {stmt}")

    # -- distributions (reference: semantics/support.rs:260-276) --------
    @staticmethod
    def transform_distribution(dist, v, init: VarSupport, add_previous_value):
        result = init.clone()
        if v == result.num_vars():
            result.push(SupportSet.zero())
        assert v < result.num_vars()
        if not add_previous_value:
            result.set(v, SupportSet.zero())
        result.update(v, lambda s: s + dist.support())
        return result

    # -- loop analysis (reference: semantics/support.rs:278-361) --------
    def find_unroll_fixpoint(self, cond, body, init: VarSupport):
        pre_loop = init
        rest = VarSupport.empty(pre_loop.num_vars())
        for i in range(100):
            new_pre_loop, loop_exit = self.one_iteration(pre_loop.clone(), body, cond)
            rest = rest.join(loop_exit)
            if pre_loop == new_pre_loop:
                return i, pre_loop, rest
            pre_loop = new_pre_loop
        return None

    def find_while_invariant(self, cond, body, init: VarSupport) -> VarSupport:
        pre_loop = init
        for _ in range(100):
            new_pre_loop, _ = self.one_iteration(pre_loop.clone(), body, cond)
            if new_pre_loop.is_subset_of(pre_loop):
                return pre_loop
            pre_loop = pre_loop.join(new_pre_loop)
        # interval widening: each variable widened at most twice
        for _ in range(2 * pre_loop.num_vars() + 1):
            new_pre_loop, _ = self.one_iteration(pre_loop.clone(), body, cond)
            if new_pre_loop.is_subset_of(pre_loop):
                return pre_loop
            for v in range(pre_loop.num_vars()):
                pre_loop.set(v, self._widen(pre_loop[v], new_pre_loop[v]))
        new_pre_loop, _ = self.one_iteration(pre_loop.clone(), body, cond)
        assert new_pre_loop.is_subset_of(pre_loop), "Widening failed."
        return pre_loop

    @staticmethod
    def _widen(cur: SupportSet, new: SupportSet) -> SupportSet:
        if new.is_subset_of(cur):
            # already stable: nothing to widen.  For ranges this equals
            # the widening formula's result; for non-range supports
            # (continuous intervals the loop never touches) it avoids
            # the reference's panic (support.rs:348) — a graceful
            # extension, not a divergence: the reference cannot run
            # while programs alongside continuous priors at all
            return cur
        if cur.kind == SupportSet.RANGE and new.kind == SupportSet.RANGE:
            start = cur.start if cur.start <= new.start else 0
            end = None
            if cur.end is not None and new.end is not None and new.end <= cur.end:
                end = cur.end
            return SupportSet(SupportSet.RANGE, start, end)
        # continuous (or mixed) supports: the same widening formula on
        # the interval hulls — drop whichever bound failed to stabilize.
        # The reference panics here (support.rs:348) because it cannot
        # run while programs over continuous state at all; the mass
        # compiler only needs is-continuous + a sound over-approximation
        # (the Dirac value-set analysis computes the actual node grid).
        ca, cb = cur._as_interval()
        na, nb = new._as_interval()
        start = ca if ca <= na else Fraction(0)
        end = None
        if cb is not None and nb is not None and nb <= cb:
            end = cb
        return SupportSet.interval(start, end)

    def one_iteration(self, init: VarSupport, body, cond):
        enter, exit_ = self.transform_event(cond, init)
        post = self.transform_statements(body, enter)
        return post, exit_

    # -- nested inference (reference: semantics/support.rs:363-385) -----
    def transform_normalize(self, given_vars, block, var_info: VarSupport):
        if not given_vars:
            return self.transform_statements(block, var_info)
        v = given_vars[0]
        rest = given_vars[1:]
        support = var_info[v]
        rng = support.finite_nonempty_range()
        assert rng is not None, (
            f"Cannot normalize with respect to variable `{ast.var_name(v)}`, "
            "because its value could not be proven to be bounded."
        )
        joined = VarSupport.empty(var_info.num_vars())
        for i in rng:
            new_var_info = var_info.clone()
            new_var_info.set(v, SupportSet.point(i))
            result = self.transform_normalize(rest, block, new_var_info)
            joined = joined.join(result)
        return joined
