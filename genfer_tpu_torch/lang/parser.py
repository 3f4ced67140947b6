"""Recursive-descent parser for the SGCL probabilistic language
(reference: src/parser.rs, a nom combinator grammar).

Grammar features mirrored from the reference:

* statements: sample (``~`` / ``+~``), affine assignment (``:=`` / ``+=``),
  decrement (``-=``), ``if``/``else``, ``observe`` (sugar for
  ``if e {} else { fail }``), ``loop n {}`` (unrolled at parse time,
  parser.rs:540-551), ``while`` with optional ``unroll n``, ``fail``,
  ``normalize [vars] { ... }``, final ``return x``
* events with ``and``/``or``/``not`` (also ``&&``, ``||``, ``!``),
  comparisons ``=  !=  <  <=  >  >=`` incl. unicode ``≤ ≥ ≠ ∈ ∉``,
  ``in [..]`` membership
* ``#`` line comments and ``#= ... =#`` block comments (parser.rs:564-580)
* decimal literals parsed as exact rationals (parser.rs:41-68)
* variables are created on first assignment (parser.rs:98-109)
"""

from __future__ import annotations

import re

from . import ast
from .ast import Event, PosRatio


class ParseError(Exception):
    pass


_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_NAT_RE = re.compile(r"[0-9]+")
# whitespace + comments in one pass; the line-comment branch excludes
# `#=` so an unterminated block comment stops the match and is reported
_WS_RE = re.compile(r"(?:\s+|#=.*?=#|#(?!=)[^\n]*)+", re.DOTALL)


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.vars: list[str] = []
        self._clean = -1  # position already known whitespace-free

    # -- low-level helpers ---------------------------------------------
    def error(self, msg: str):
        line = self.text.count("\n", 0, self.pos) + 1
        col = self.pos - self.text.rfind("\n", 0, self.pos)
        raise ParseError(f"Parse error at line {line}, column {col}: {msg}")

    def skip_ws(self):
        # every peek calls this; positions already cleaned are memoized
        # (pos is monotonic, so a stale marker can never match again)
        if self.pos == self._clean:
            return
        m = _WS_RE.match(self.text, self.pos)
        if m:
            self.pos = m.end()
        if self.text.startswith("#=", self.pos):
            self.error(
                "Unterminated comment: found opening `#=` but no closing `=#`"
            )
        self._clean = self.pos

    def peek_str(self, s: str) -> bool:
        self.skip_ws()
        return self.text.startswith(s, self.pos)

    def try_str(self, s: str) -> bool:
        if self.peek_str(s):
            self.pos += len(s)
            return True
        return False

    def expect_str(self, s: str):
        if not self.try_str(s):
            self.error(f"expected `{s}`")

    def peek_keyword(self, kw: str) -> bool:
        self.skip_ws()
        if not self.text.startswith(kw, self.pos):
            return False
        end = self.pos + len(kw)
        if end < len(self.text) and (
            self.text[end].isalnum() or self.text[end] == "_"
        ):
            return False
        return True

    def try_keyword(self, kw: str) -> bool:
        if self.peek_keyword(kw):
            self.pos += len(kw)
            return True
        return False

    def natural(self) -> int:
        self.skip_ws()
        m = _NAT_RE.match(self.text, self.pos)
        if not m:
            self.error("expected a natural number")
        self.pos = m.end()
        return int(m.group())

    def identifier(self) -> str:
        self.skip_ws()
        m = _IDENT_RE.match(self.text, self.pos)
        if not m:
            self.error("expected an identifier")
        self.pos = m.end()
        return m.group()

    def pos_ratio(self):
        """Rational: ``a/b`` or decimal ``12.34`` as exact ratio
        (reference: parser.rs:41-68); additionally ``$name`` denotes an
        inference-time parameter (compiled mode extension)."""
        self.skip_ws()
        if self.pos < len(self.text) and self.text[self.pos] == "$":
            self.pos += 1
            return ast.ParamRatio(self.identifier())
        n = self.natural()
        if self.try_str("/"):
            d = self.natural()
            return PosRatio(n, d)
        # NOTE: no whitespace allowed around the '.' in a decimal
        if self.pos < len(self.text) and self.text[self.pos] == ".":
            self.pos += 1
            m = _NAT_RE.match(self.text, self.pos)
            if not m:
                self.error("expected digits after decimal point")
            frac = m.group()
            self.pos = m.end()
            return PosRatio(int(str(n) + frac), 10 ** len(frac))
        return PosRatio(n, 1)

    def natural_list(self) -> list[int]:
        self.expect_str("[")
        out = []
        self.skip_ws()
        if not self.peek_str("]"):
            out.append(self.natural())
            while self.try_str(","):
                out.append(self.natural())
        self.expect_str("]")
        return out

    # -- variables ------------------------------------------------------
    def find_or_create_var(self, name: str) -> int:
        if name in self.vars:
            return self.vars.index(name)
        self.vars.append(name)
        return len(self.vars) - 1

    def expect_var(self, name: str) -> int:
        if name not in self.vars:
            self.error(f"Unknown variable {name}")
        return self.vars.index(name)

    # -- distributions (reference: parser.rs:361-473) --------------------
    def distribution(self) -> ast.Distribution:
        name = self.identifier()
        self.expect_str("(")
        if name == "Dirac":
            d = ast.Dirac(self.pos_ratio())
        elif name == "Bernoulli":
            d = self._ratio_or_var(
                lambda p: ast.Bernoulli(p),
                lambda v: ast.BernoulliVarProb(v),
            )
        elif name == "Binomial":
            d = self._nat_or_var_with_ratio(
                lambda n, p: ast.Binomial(n, p),
                lambda v, p: ast.BinomialVarTrials(v, p),
            )
        elif name == "Categorical":
            rs = [self.pos_ratio()]
            while self.try_str(","):
                rs.append(self.pos_ratio())
            d = ast.Categorical(tuple(rs))
        elif name == "NegBinomial":
            d = self._nat_or_var_with_ratio(
                lambda n, p: ast.NegBinomial(n, p),
                lambda v, p: ast.NegBinomialVarSuccesses(v, p),
            )
        elif name == "Geometric":
            d = ast.Geometric(self.pos_ratio())
        elif name == "Poisson":
            d = self._poisson()
        elif name == "UniformDisc":
            start = self.natural()
            self.expect_str(",")
            end = self.natural()
            d = ast.UniformDisc(start, end)
        elif name == "Exponential":
            d = ast.Exponential(self.pos_ratio())
        elif name == "Gamma":
            shape = self.pos_ratio()
            self.expect_str(",")
            rate = self.pos_ratio()
            d = ast.Gamma(shape, rate)
        elif name == "UniformCont":
            start = self.pos_ratio()
            self.expect_str(",")
            end = self.pos_ratio()
            d = ast.UniformCont(start, end)
        else:
            self.error(f"Unknown distribution {name}")
        self.expect_str(")")
        return d

    def _ratio_or_var(self, mk_ratio, mk_var):
        self.skip_ws()
        if _NAT_RE.match(self.text, self.pos) or self.text.startswith(
            "$", self.pos
        ):
            return mk_ratio(self.pos_ratio())
        return mk_var(self.expect_var(self.identifier()))

    def _nat_or_var_with_ratio(self, mk_nat, mk_var):
        self.skip_ws()
        if _NAT_RE.match(self.text, self.pos):
            n = self.natural()
            self.expect_str(",")
            return mk_nat(n, self.pos_ratio())
        v = self.expect_var(self.identifier())
        self.expect_str(",")
        return mk_var(v, self.pos_ratio())

    def _poisson(self):
        """Poisson(λ), Poisson(λ * x) or Poisson(x)
        (reference: parser.rs:422-441)."""
        self.skip_ws()
        if _NAT_RE.match(self.text, self.pos):
            rate = self.pos_ratio()
            if self.try_str("*"):
                v = self.expect_var(self.identifier())
                return ast.PoissonVarRate(rate, v)
            return ast.Poisson(rate)
        v = self.expect_var(self.identifier())
        return ast.PoissonVarRate(PosRatio(1, 1), v)

    # -- events (reference: parser.rs:135-304) ---------------------------
    def operand(self):
        self.skip_ws()
        if _NAT_RE.match(self.text, self.pos):
            return ("nat", self.natural())
        return ("var", self.expect_var(self.identifier()))

    def _event_eq(self, lhs, rhs) -> Event:
        if lhs[0] == "var" and rhs[0] == "var":
            return ast.VarComparison(lhs[1], ast.Comparison.EQ, rhs[1])
        if lhs[0] == "var":
            return ast.InSet(lhs[1], (rhs[1],))
        if rhs[0] == "var":
            return ast.InSet(rhs[1], (lhs[1],))
        return Event.always() if lhs[1] == rhs[1] else Event.never()

    def _event_lt(self, lhs, rhs) -> Event:
        if lhs[0] == "var" and rhs[0] == "var":
            return ast.VarComparison(lhs[1], ast.Comparison.LT, rhs[1])
        if lhs[0] == "var":
            return ast.InSet(lhs[1], tuple(range(rhs[1])))
        if rhs[0] == "var":
            return ast.InSet(rhs[1], tuple(range(lhs[1] + 1))).complement()
        return Event.always() if lhs[1] < rhs[1] else Event.never()

    def _event_le(self, lhs, rhs) -> Event:
        if lhs[0] == "var" and rhs[0] == "var":
            return ast.VarComparison(lhs[1], ast.Comparison.LE, rhs[1])
        if lhs[0] == "var":
            return ast.InSet(lhs[1], tuple(range(rhs[1] + 1)))
        if rhs[0] == "var":
            return ast.InSet(rhs[1], tuple(range(lhs[1]))).complement()
        return Event.always() if lhs[1] <= rhs[1] else Event.never()

    def _event_in(self, lhs, ns) -> Event:
        if lhs[0] == "var":
            return ast.InSet(lhs[1], tuple(ns))
        return Event.always() if lhs[1] in ns else Event.never()

    def comparison_or_data(self) -> Event:
        # data-from-dist: `nat ~ Dist(...)`
        save = self.pos
        self.skip_ws()
        if _NAT_RE.match(self.text, self.pos):
            n = self.natural()
            if self.try_str("~"):
                return ast.DataFromDist(n, self.distribution())
            self.pos = save
        lhs = self.operand()
        self.skip_ws()
        if self.try_str("="):
            return self._event_eq(lhs, self.operand())
        if self.try_str("<=") or self.try_str("≤"):
            return self._event_le(lhs, self.operand())
        if self.try_str("<"):
            return self._event_lt(lhs, self.operand())
        if self.try_str("!=") or self.try_str("≠"):
            return self._event_eq(lhs, self.operand()).complement()
        if self.try_str(">=") or self.try_str("≥"):
            return self._event_le(self.operand(), lhs)
        if self.try_str(">"):
            return self._event_lt(self.operand(), lhs)
        if self.try_keyword("not in") or self.try_str("∉"):
            return self._event_in(lhs, self.natural_list()).complement()
        if self.try_keyword("in") or self.try_str("∈"):
            return self._event_in(lhs, self.natural_list())
        self.error("expected a comparison operator")

    def atomic_event(self) -> Event:
        self.skip_ws()
        if self.try_str("!") or self.try_keyword("not"):
            return self.atomic_event().complement()
        if self.try_str("("):
            e = self.event()
            self.expect_str(")")
            return e
        return self.comparison_or_data()

    def event(self) -> Event:
        e = self.atomic_event()
        self.skip_ws()
        if self.peek_keyword("and") or self.peek_str("&&"):
            es = [e]
            while self.try_keyword("and") or self.try_str("&&"):
                es.append(self.event())
            return Event.intersection(es)
        if self.peek_keyword("or") or self.peek_str("||"):
            es = [e]
            while self.try_keyword("or") or self.try_str("||"):
                es.append(self.event())
            return Event.disjunction(es)
        return e

    # -- statements (reference: parser.rs:475-622) -----------------------
    def block(self) -> list[ast.Statement]:
        self.expect_str("{")
        stmts = []
        while True:
            self.skip_ws()
            if self.peek_str("}"):
                break
            stmts.extend(self.statement())
        self.expect_str("}")
        return stmts

    def statement(self) -> list[ast.Statement]:
        self.skip_ws()
        if self.peek_keyword("normalize"):
            self.try_keyword("normalize")
            given = []
            while True:
                self.skip_ws()
                if self.peek_str("{"):
                    break
                given.append(self.expect_var(self.identifier()))
            stmts = self.block()
            return [ast.Normalize(tuple(given), tuple(stmts))]
        if self.peek_keyword("if"):
            return [self.if_event()]
        if self.peek_keyword("observe"):
            self.try_keyword("observe")
            e = self.event()
            self.expect_str(";")
            return [ast.IfThenElse(e, (), (ast.Fail(),))]
        if self.peek_keyword("loop"):
            self.try_keyword("loop")
            count = self.natural()
            body = self.block()
            out = []
            for _ in range(count):
                out.extend(body)
            return out
        if self.peek_keyword("while"):
            self.try_keyword("while")
            cond = self.event()
            unroll = None
            if self.try_keyword("unroll"):
                unroll = self.natural()
            body = self.block()
            return [ast.While(cond, unroll, tuple(body))]
        if self.peek_keyword("fail"):
            self.try_keyword("fail")
            self.expect_str(";")
            return [ast.Fail()]
        return [self.assign()]

    def if_event(self) -> ast.Statement:
        self.try_keyword("if")
        cond = self.event()
        then = self.block()
        els: list = []
        if self.try_keyword("else"):
            if self.peek_keyword("if"):
                els = [self.if_event()]
            else:
                els = self.block()
        return ast.IfThenElse(cond, tuple(then), tuple(els))

    def assign(self) -> ast.Statement:
        lhs = self.identifier()
        self.skip_ws()
        if self.try_str("+~"):
            stmt = self._sample(lhs, True)
        elif self.try_str("~"):
            stmt = self._sample(lhs, False)
        elif self.try_str("-="):
            offset = self.natural()
            var = self.find_or_create_var(lhs)
            stmt = ast.Decrement(var, offset)
        else:
            stmt = self._affine(lhs)
        self.expect_str(";")
        return stmt

    def _sample(self, lhs: str, add_previous: bool) -> ast.Statement:
        var = self.find_or_create_var(lhs)
        dist = self.distribution()
        return ast.Sample(var, dist, add_previous)

    def _affine(self, lhs: str) -> ast.Statement:
        """``x := [a *] y [+ b]`` or ``x := b`` (reference: parser.rs:327-359).

        Note: a leading natural could be either a factor (``2 * y``) or a
        plain constant; disambiguate on the following ``*``."""
        if self.try_str("+="):
            add_previous = True
        elif self.try_str(":="):
            add_previous = False
        else:
            self.error("expected `:=`, `+=`, `-=`, `~` or `+~`")
        self.skip_ws()
        addend = None
        offset = 0
        if _NAT_RE.match(self.text, self.pos):
            n = self.natural()
            if self.try_str("*"):
                w = self.expect_var(self.identifier())
                addend = (n, w)
                if self.try_str("+"):
                    offset = self.natural()
            else:
                offset = n
        else:
            w = self.expect_var(self.identifier())
            addend = (1, w)
            if self.try_str("+"):
                offset = self.natural()
        var = self.find_or_create_var(lhs)
        return ast.Assign(var, add_previous, addend, offset)

    # -- program ---------------------------------------------------------
    def program(self) -> ast.Program:
        stmts = []
        while True:
            self.skip_ws()
            if self.pos >= len(self.text) or self.peek_keyword("return"):
                break
            stmts.extend(self.statement())
        if not self.try_keyword("return"):
            self.error("expected `return`")
        result = self.expect_var(self.identifier())
        self.try_str(";")
        self.skip_ws()
        if self.pos != len(self.text):
            self.error("unexpected trailing input")
        return ast.Program(tuple(stmts), result, tuple(self.vars))


def parse_program(text: str) -> ast.Program:
    return _Parser(text).program()


def parse_file(path) -> ast.Program:
    with open(path, "r", encoding="utf-8") as f:
        return parse_program(f.read())
