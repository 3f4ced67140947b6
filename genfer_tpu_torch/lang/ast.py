"""SGCL abstract syntax tree (reference: src/ppl.rs).

Variables are plain ints (displayed a..z then x_i, reference ppl.rs:107-117);
naturals are plain Python ints; positive rationals are ``PosRatio``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..semantics.supportset import SupportSet


def var_name(i: int) -> str:
    if i < 26:
        return chr(ord("a") + i)
    return f"x_{i}"


@dataclass(frozen=True)
class ParamRatio:
    """A named inference-time parameter in a probability position
    (``$name`` in the source); used by the compiled/batched mode
    (genfer_tpu.compile) - not part of the reference language."""

    name: str
    complemented: bool = False

    def complement(self) -> "ParamRatio":
        return ParamRatio(self.name, not self.complemented)

    def as_integer(self):
        return None

    def is_zero(self) -> bool:
        return False

    def __str__(self):
        return ("1-$" if self.complemented else "$") + self.name


def ratio_to_scalar(T, r):
    """Lift a PosRatio or ParamRatio into a host scalar of type T."""
    if isinstance(r, ParamRatio):
        expr = T.param(r.name)
        if r.complemented:
            return T.one() - expr
        return expr
    return T.from_ratio(r.numer, r.denom)


@dataclass(frozen=True)
class PosRatio:
    """Nonnegative rational with u64 numerator/denominator
    (reference: ppl.rs:34-95)."""

    numer: int
    denom: int = 1

    def complement(self) -> "PosRatio":
        assert self.numer <= self.denom
        return PosRatio(self.denom - self.numer, self.denom)

    def as_integer(self) -> Optional[int]:
        if self.denom != 0 and self.numer % self.denom == 0:
            v = self.numer // self.denom
            return v if v < 2**32 else None
        return None

    def is_zero(self) -> bool:
        return self.numer == 0 and self.denom != 0

    def __str__(self):
        if self.denom == 1:
            return str(self.numer)
        return f"{self.numer}/{self.denom}"


# ----------------------------------------------------------------------
# distributions (reference: ppl.rs:177-293)
# ----------------------------------------------------------------------

class Distribution:
    def support(self) -> SupportSet:
        raise NotImplementedError

    def used_vars(self) -> int:
        return 0

    def to_genfun_params(self):
        raise NotImplementedError


@dataclass(frozen=True)
class Dirac(Distribution):
    a: PosRatio

    def support(self):
        v = self.a.as_integer()
        if v is not None:
            return SupportSet.point(v)
        return SupportSet.interval_ratio(self.a, self.a)

    def __str__(self):
        return f"Dirac({self.a})"


@dataclass(frozen=True)
class Bernoulli(Distribution):
    p: PosRatio

    def support(self):
        return SupportSet.range_incl(0, 1)

    def __str__(self):
        return f"Bernoulli({self.p})"


@dataclass(frozen=True)
class BernoulliVarProb(Distribution):
    var: int

    def support(self):
        return SupportSet.range_incl(0, 1)

    def used_vars(self):
        return self.var + 1

    def __str__(self):
        return f"Bernoulli({var_name(self.var)})"


@dataclass(frozen=True)
class BinomialVarTrials(Distribution):
    var: int
    p: PosRatio

    def support(self):
        return SupportSet.naturals()

    def used_vars(self):
        return self.var + 1

    def __str__(self):
        return f"Binomial({var_name(self.var)}, {self.p})"


@dataclass(frozen=True)
class Binomial(Distribution):
    n: int
    p: PosRatio

    def support(self):
        return SupportSet.range_incl(0, self.n)

    def __str__(self):
        return f"Binomial({self.n}, {self.p})"


@dataclass(frozen=True)
class Categorical(Distribution):
    rs: tuple

    def support(self):
        return SupportSet.range_excl(0, len(self.rs))

    def __str__(self):
        return "Categorical(" + ", ".join(str(r) for r in self.rs) + ")"


@dataclass(frozen=True)
class NegBinomialVarSuccesses(Distribution):
    var: int
    p: PosRatio

    def support(self):
        return SupportSet.naturals()

    def used_vars(self):
        return self.var + 1

    def __str__(self):
        return f"NegBinomial({var_name(self.var)}, {self.p})"


@dataclass(frozen=True)
class NegBinomial(Distribution):
    n: int
    p: PosRatio

    def support(self):
        return SupportSet.naturals()

    def __str__(self):
        return f"NegBinomial({self.n}, {self.p})"


@dataclass(frozen=True)
class Geometric(Distribution):
    p: PosRatio

    def support(self):
        return SupportSet.naturals()

    def __str__(self):
        return f"Geometric({self.p})"


@dataclass(frozen=True)
class Poisson(Distribution):
    rate: PosRatio

    def support(self):
        return SupportSet.naturals()

    def __str__(self):
        return f"Poisson({self.rate})"


@dataclass(frozen=True)
class PoissonVarRate(Distribution):
    rate: PosRatio
    var: int

    def support(self):
        return SupportSet.naturals()

    def used_vars(self):
        return self.var + 1

    def __str__(self):
        return f"Poisson({self.rate} * {var_name(self.var)})"


@dataclass(frozen=True)
class UniformDisc(Distribution):
    """Uniform on the integers {start, ..., end-1} (reference: ppl.rs:190-194)."""

    start: int
    end: int

    def support(self):
        return SupportSet.range_excl(self.start, self.end)

    def __str__(self):
        return f"Uniform({self.start}, {self.end})"


@dataclass(frozen=True)
class Exponential(Distribution):
    rate: PosRatio

    def support(self):
        return SupportSet.nonneg_reals()

    def __str__(self):
        return f"Exponential({self.rate})"


@dataclass(frozen=True)
class Gamma(Distribution):
    shape: PosRatio
    rate: PosRatio

    def support(self):
        return SupportSet.nonneg_reals()

    def __str__(self):
        return f"Gamma({self.shape}, {self.rate})"


@dataclass(frozen=True)
class UniformCont(Distribution):
    start: PosRatio
    end: PosRatio

    def support(self):
        return SupportSet.interval_ratio(self.start, self.end)

    def __str__(self):
        return f"UniformCont({self.start}, {self.end})"


# ----------------------------------------------------------------------
# events (reference: ppl.rs:295-445)
# ----------------------------------------------------------------------

class Comparison:
    EQ = "="
    LT = "<"
    LE = "<="


class Event:
    def used_vars(self) -> int:
        raise NotImplementedError

    def complement(self) -> "Event":
        if isinstance(self, Complement):
            return self.event
        return Complement(self)

    def and_(self, other: "Event") -> "Event":
        a = list(self.events) if isinstance(self, Intersection) else [self]
        b = list(other.events) if isinstance(other, Intersection) else [other]
        return Intersection(tuple(a + b))

    @staticmethod
    def intersection(events) -> "Event":
        conjuncts = []
        for e in events:
            if isinstance(e, Intersection):
                conjuncts.extend(e.events)
            else:
                conjuncts.append(e)
        if len(conjuncts) == 1:
            return conjuncts[0]
        return Intersection(tuple(conjuncts))

    @staticmethod
    def disjunction(events) -> "Event":
        # De Morgan (reference: ppl.rs:401-407)
        if len(events) == 1:
            return events[0]
        return Event.intersection([e.complement() for e in events]).complement()

    @staticmethod
    def always() -> "Event":
        return Event.intersection([])

    @staticmethod
    def never() -> "Event":
        return Event.always().complement()

    def recognize_const_prob(self, T):
        """If the event has a constant probability, return it as a scalar of
        type T (reference: ppl.rs:334-357)."""
        if isinstance(self, DataFromDist):
            if isinstance(self.dist, Bernoulli):
                p = self.dist.p
                if self.data == 0:
                    return ratio_to_scalar(T, p.complement())
                if self.data == 1:
                    return ratio_to_scalar(T, p)
                return T.zero()
            return None
        if isinstance(self, Complement):
            inner = self.event.recognize_const_prob(T)
            if inner is None:
                return None
            return T.one() - inner
        if isinstance(self, Intersection):
            result = T.one()
            for e in self.events:
                p = e.recognize_const_prob(T)
                if p is None:
                    return None
                result = result * p
            return result
        return None


@dataclass(frozen=True)
class InSet(Event):
    var: int
    set: tuple  # of ints

    def used_vars(self):
        return self.var + 1

    def __str__(self):
        return f"{var_name(self.var)} ∈ {list(self.set)}"


@dataclass(frozen=True)
class VarComparison(Event):
    v1: int
    comp: str
    v2: int

    def used_vars(self):
        return max(self.v1, self.v2) + 1

    def __str__(self):
        return f"{var_name(self.v1)} {self.comp} {var_name(self.v2)}"


@dataclass(frozen=True)
class DataFromDist(Event):
    data: int
    dist: Distribution

    def used_vars(self):
        return self.dist.used_vars()

    def __str__(self):
        return f"{self.data} ~ {self.dist}"


@dataclass(frozen=True)
class Complement(Event):
    event: Event

    def used_vars(self):
        return self.event.used_vars()

    def __str__(self):
        return f"not ({self.event})"


@dataclass(frozen=True)
class Intersection(Event):
    events: tuple

    def used_vars(self):
        return max((e.used_vars() for e in self.events), default=0)

    def __str__(self):
        if not self.events:
            return "true"
        return " and ".join(str(e) for e in self.events)


# ----------------------------------------------------------------------
# statements (reference: ppl.rs:447-656)
# ----------------------------------------------------------------------

class Statement:
    def uses_observe(self) -> bool:
        return False

    def used_vars(self) -> int:
        raise NotImplementedError

    def size(self) -> int:
        return 1

    def recognize_observe(self):
        return None

    def _fmt(self, indent: int) -> str:
        raise NotImplementedError

    def __str__(self):
        return self._fmt(0)


def _fmt_block(stmts, indent: int) -> str:
    pad = " " * indent
    return "".join(pad + s._fmt(indent) for s in stmts)


@dataclass(frozen=True)
class Sample(Statement):
    var: int
    distribution: Distribution
    add_previous_value: bool = False

    def used_vars(self):
        return max(self.var + 1, self.distribution.used_vars())

    def _fmt(self, indent):
        op = "+~" if self.add_previous_value else "~"
        return f"{var_name(self.var)} {op} {self.distribution};\n"


@dataclass(frozen=True)
class Assign(Statement):
    var: int
    add_previous_value: bool
    addend: Optional[tuple]  # (factor:int, var:int)
    offset: int

    def used_vars(self):
        out = self.var + 1
        if self.addend is not None:
            out = max(out, self.addend[1] + 1)
        return out

    def _fmt(self, indent):
        op = "+=" if self.add_previous_value else ":="
        s = f"{var_name(self.var)} {op} "
        if self.addend is not None:
            factor, w = self.addend
            if factor != 1:
                s += f"{factor} * "
            s += var_name(w)
            if self.offset != 0:
                s += f" + {self.offset}"
        else:
            s += str(self.offset)
        return s + ";\n"


@dataclass(frozen=True)
class Decrement(Statement):
    var: int
    offset: int

    def used_vars(self):
        return self.var + 1

    def _fmt(self, indent):
        return f"{var_name(self.var)} -= {self.offset};\n"


@dataclass(frozen=True)
class IfThenElse(Statement):
    cond: Event
    then: tuple
    els: tuple

    def uses_observe(self):
        return any(s.uses_observe() for s in self.then) or any(
            s.uses_observe() for s in self.els
        )

    def used_vars(self):
        out = self.cond.used_vars()
        for s in list(self.then) + list(self.els):
            out = max(out, s.used_vars())
        return out

    def size(self):
        return 1 + sum(s.size() for s in self.then) + sum(s.size() for s in self.els)

    def recognize_observe(self):
        """``observe e`` sugar: if e {} else { fail }
        (reference: ppl.rs:499-506)."""
        if not self.then and len(self.els) == 1 and isinstance(self.els[0], Fail):
            return self.cond
        return None

    def _fmt(self, indent):
        ev = self.recognize_observe()
        if ev is not None:
            return f"observe {ev};\n"
        pad = " " * indent
        s = f"if {self.cond} {{\n" + _fmt_block(self.then, indent + 2)
        if not self.els:
            s += f"{pad}}}\n"
        elif len(self.els) == 1 and isinstance(self.els[0], IfThenElse):
            s += f"{pad}}} else " + self.els[0]._fmt(indent)
        else:
            s += f"{pad}}} else {{\n" + _fmt_block(self.els, indent + 2) + f"{pad}}}\n"
        return s


@dataclass(frozen=True)
class While(Statement):
    cond: Event
    unroll: Optional[int]
    body: tuple

    def uses_observe(self):
        return any(s.uses_observe() for s in self.body)

    def used_vars(self):
        out = self.cond.used_vars()
        for s in self.body:
            out = max(out, s.used_vars())
        return out

    def size(self):
        return 1 + sum(s.size() for s in self.body)

    def _fmt(self, indent):
        pad = " " * indent
        s = f"while {self.cond} "
        if self.unroll is not None:
            s += f"unroll {self.unroll} "
        s += "{\n" + _fmt_block(self.body, indent + 2) + f"{pad}}}\n"
        return s


@dataclass(frozen=True)
class Fail(Statement):
    def uses_observe(self):
        return True

    def used_vars(self):
        return 0

    def _fmt(self, indent):
        return "fail;\n"


@dataclass(frozen=True)
class Normalize(Statement):
    given_vars: tuple
    stmts: tuple

    def uses_observe(self):
        return any(s.uses_observe() for s in self.stmts)

    def used_vars(self):
        return max((s.used_vars() for s in self.stmts), default=0)

    def size(self):
        return 1 + sum(s.size() for s in self.stmts)

    def _fmt(self, indent):
        pad = " " * indent
        s = "normalize"
        for v in self.given_vars:
            s += f" {var_name(v)}"
        s += " {\n" + _fmt_block(self.stmts, indent + 2) + f"{pad}}}\n"
        return s


@dataclass(frozen=True)
class Program:
    stmts: tuple
    result: int
    field_names: tuple = field(default=())

    def uses_observe(self) -> bool:
        return any(s.uses_observe() for s in self.stmts)

    def has_while(self) -> bool:
        def walk(stmts):
            return any(
                isinstance(s, While)
                or (isinstance(s, IfThenElse)
                    and (walk(s.then) or walk(s.els)))
                or (isinstance(s, Normalize) and walk(s.stmts))
                for s in stmts
            )
        return walk(self.stmts)

    def used_vars(self) -> int:
        return max((s.used_vars() for s in self.stmts), default=0)

    def size(self) -> int:
        return sum(s.size() for s in self.stmts)

    def __str__(self):
        return _fmt_block(self.stmts, 0) + f"return {var_name(self.result)}"
