"""SGCL -> WebPPL / Anglican translator (reference: src/bin/translate.rs).

Used to produce the approximate-inference baselines for the NeurIPS 2023
comparison: the same model is run under WebPPL's and Anglican's generic
inference algorithms.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..lang import ast
from ..lang.parser import parse_file


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genfer-translate")
    ap.add_argument("target", choices=["webppl", "anglican"])
    ap.add_argument("file_name", type=Path)
    args = ap.parse_args(argv)
    program = parse_file(args.file_name)
    name = args.file_name.stem
    if args.target == "webppl":
        print(WebPpl().program(program, name))
    else:
        print(Anglican().program(program, name))


def _vname(v: int) -> str:
    return ast.var_name(v)


def _ratio(r: ast.PosRatio) -> str:
    return str(r)


def _round(r: ast.PosRatio) -> float:
    return r.numer / r.denom


# ----------------------------------------------------------------------
# WebPPL
# ----------------------------------------------------------------------

class WebPpl:
    def __init__(self):
        self.out: list[str] = []

    def w(self, s=""):
        self.out.append(s)

    def program(self, program: ast.Program, name: str) -> str:
        self.w(f"var {name} = function() {{")
        for v in range(program.used_vars()):
            self.w(f"  {self.var(v)} = 0;")
        stmts = program.stmts
        if (
            len(stmts) == 1
            and isinstance(stmts[0], ast.Normalize)
            and not stmts[0].given_vars
        ):
            self.block(stmts[0].stmts, 2)
        else:
            self.block(stmts, 2)
        self.w(f"  return {self.var(program.result)};")
        self.w("};")
        self.w(f"var result = Infer({{ model: {name} }});")
        self.w("viz(result)")
        self.w("viz.table(result)")
        return "\n".join(self.out) + "\n"

    def var(self, v: int) -> str:
        return f"globalStore.{_vname(v)}"

    def block(self, stmts, indent: int):
        for stmt in stmts:
            self.statement(stmt, indent)

    def statement(self, stmt, indent: int):
        pad = " " * indent
        if isinstance(stmt, ast.Sample):
            op = "+=" if stmt.add_previous_value else "="
            self.w(
                f"{pad}{self.var(stmt.var)} {op} sample("
                f"{self.dist(stmt.distribution)});"
            )
        elif isinstance(stmt, ast.Assign):
            op = "+=" if stmt.add_previous_value else "="
            if stmt.addend is not None:
                factor, w = stmt.addend
                rhs = (f"{factor} * " if factor != 1 else "") + self.var(w)
                if stmt.offset != 0:
                    rhs += f" + {stmt.offset}"
            else:
                rhs = str(stmt.offset)
            self.w(f"{pad}{self.var(stmt.var)} {op} {rhs};")
        elif isinstance(stmt, ast.Decrement):
            v = self.var(stmt.var)
            n = stmt.offset
            self.w(f"{pad}{v} = ({v} < {n}) ? 0 : ({v} - {n});")
        elif isinstance(stmt, ast.IfThenElse):
            ev = stmt.recognize_observe()
            if ev is not None:
                if isinstance(ev, ast.DataFromDist):
                    self.w(f"{pad}observe({self.dist(ev.dist)}, {ev.data});")
                else:
                    self.w(f"{pad}condition({self.event(ev)});")
                return
            self.w(f"{pad}if ({self.event(stmt.cond)}) {{")
            self.block(stmt.then, indent + 2)
            els = stmt.els
            if not els:
                self.w(f"{pad}}}")
            elif (
                len(els) == 1
                and isinstance(els[0], ast.IfThenElse)
                and els[0].recognize_observe() is None
            ):
                # `} else if ...` chain
                marker = len(self.out)
                self.statement(els[0], indent)
                self.out[marker] = f"{pad}}} else " + self.out[marker].lstrip()
            else:
                self.w(f"{pad}}} else {{")
                self.block(els, indent + 2)
                self.w(f"{pad}}}")
        elif isinstance(stmt, ast.While):
            self.w(f"{pad}while ({self.event(stmt.cond)}) {{")
            self.block(stmt.body, indent + 2)
            self.w(f"{pad}}}")
        elif isinstance(stmt, ast.Fail):
            self.w(f"{pad}condition(false);")
        elif isinstance(stmt, ast.Normalize):
            num_vars = stmt.used_vars()
            for v in range(num_vars):
                if v in stmt.given_vars:
                    continue
                wv = self.var(v)
                self.w(
                    f"{pad}if ({wv} != 0) {{ error('This form of nested "
                    "inference is not supported in WebPPL: the variable "
                    f"`{wv}` should either be unassigned (i.e. 0) at this "
                    "point or part of the `normalize` statement.'); }"
                )
            self.w(f"{pad}var assignment = sample(Infer(function(){{")
            self.block(stmt.stmts, indent + 2)
            vars_ = "".join(f"{self.var(v)}, " for v in range(num_vars))
            self.w(f"{pad}  return [{vars_}];")
            self.w(f"{pad}}}));")
            for v in range(num_vars):
                self.w(f"{pad}{self.var(v)} = assignment[{v}];")
        else:
            raise AssertionError(stmt)

    def dist(self, d) -> str:
        if isinstance(d, ast.Dirac):
            return f"Delta({{v: {_ratio(d.a)}}}"
        if isinstance(d, ast.Bernoulli):
            # WebPPL's Bernoulli yields booleans; use Binomial(1, p)
            return f"Binomial({{n: 1, p: {_ratio(d.p)}}})"
        if isinstance(d, ast.BernoulliVarProb):
            return f"Binomial({{n: 1, p: {self.var(d.var)}}})"
        if isinstance(d, ast.BinomialVarTrials):
            n = self.var(d.var)
            return f"({n} == 0 ? Delta({{v: 0}}) : Binomial({{n: {n}, p: {_ratio(d.p)}}}))"
        if isinstance(d, ast.Binomial):
            if d.n == 0:
                return "Delta({v: 0})"
            return f"Binomial({{n: {d.n}, p: {_ratio(d.p)}}})"
        if isinstance(d, ast.Categorical):
            ps = "".join(f"{i}, " for i in range(len(d.rs)))
            vs = "".join(f"{_ratio(r)}, " for r in d.rs)
            return f"Categorical({{ ps: [{ps}], vs: [{vs}] }})"
        if isinstance(d, (ast.NegBinomial, ast.NegBinomialVarSuccesses)):
            raise AssertionError(
                "Negative binomial distribution is not supported by WebPPL"
            )
        if isinstance(d, ast.Geometric):
            # approximate with a truncated Categorical
            threshold = 1e-6
            p = _round(d.p)
            ps, vs = [], []
            for i in range(100):
                q = p * (1 - p) ** i
                if q <= threshold:
                    break
                vs.append(f"{i}, ")
                ps.append(f"{q}, ")
            return f"Categorical({{ ps: [{''.join(ps)}], vs: [{''.join(vs)}] }})"
        if isinstance(d, ast.Poisson):
            if d.rate.is_zero():
                return "Delta({v: 0})"
            return f"Poisson({{mu: {_ratio(d.rate)}}})"
        if isinstance(d, ast.PoissonVarRate):
            mu = self.var(d.var)
            lam = _ratio(d.rate)
            return (
                f"({lam} * {mu} == 0 ? Delta({{v: 0}}) : "
                f"Poisson({{mu: {lam} * {mu}}}))"
            )
        if isinstance(d, ast.UniformDisc):
            if d.start == 0:
                return f"RandomInteger({{n: {d.end}}})"
            raise AssertionError("Uniform distribution is not supported by WebPPL")
        if isinstance(d, ast.Exponential):
            return f"Exponential({{a: {_ratio(d.rate)}}})"
        if isinstance(d, ast.Gamma):
            return f"Gamma({{shape: {_ratio(d.shape)}, scale: {1.0 / _round(d.rate)}}})"
        if isinstance(d, ast.UniformCont):
            return f"Uniform({{a: {_ratio(d.start)}, b: {_ratio(d.end)}}})"
        raise AssertionError(d)

    def event(self, e) -> str:
        if isinstance(e, ast.InSet):
            var = self.var(e.var)
            return " || ".join(f"{var} === {i}" for i in e.set)
        if isinstance(e, ast.VarComparison):
            op = {"=": "===", "<": "<", "<=": "<="}[e.comp]
            return f"{self.var(e.v1)} {op} {self.var(e.v2)}"
        if isinstance(e, ast.DataFromDist):
            return f"sample({self.dist(e.dist)}) === {e.data}"
        if isinstance(e, ast.Complement):
            return f"!({self.event(e.event)})"
        if isinstance(e, ast.Intersection):
            return "(" + " && ".join(self.event(x) for x in e.events) + ")"
        raise AssertionError(e)


# ----------------------------------------------------------------------
# Anglican
# ----------------------------------------------------------------------

_ANGLICAN_PRELUDE = r"""
(ns model
  (:require [gorilla-plot.core :as plot])
  (:use [anglican core emit runtime stat
          [state :only [get-predicts get-log-weight get-result]]]))

(defdist geometric
"Geometric distribution on support {0,1,2....}"
[p] []
(sample* [this]
        (loop [value 0]
            (if (sample* (flip p))
            value
            (recur (inc value)))))
(observe* [this value] (+ (log p) (* value (log (- 1 p))))))

(defdist dirac [x]
    (sample* [this] x)
    (observe* [this value]
              (if (= value x)
                0
                (- (/ 1.0 0.0)))))

"""


class Anglican:
    def __init__(self, num_vars=0):
        self.num_vars = num_vars
        self.nested: list[str] = []

    def var_list(self) -> str:
        return "".join(f" {_vname(v)}" for v in range(self.num_vars))

    def program(self, program: ast.Program, name: str) -> str:
        self.num_vars = program.used_vars()
        var_list = self.var_list()
        out = [_ANGLICAN_PRELUDE]
        out.append("(with-primitive-procedures [dirac geometric]")
        main_query: list[str] = []
        main_query.append("  (defquery model [method- options- ]")
        main_query.append(
            f"    (let [[{var_list}] [ {'0 ' * self.num_vars}]"
        )
        main_query.append(f"          [{var_list}]")
        stmts = program.stmts
        if (
            len(stmts) == 1
            and isinstance(stmts[0], ast.Normalize)
            and not stmts[0].given_vars
        ):
            main_query.append(self.block(stmts[0].stmts, 10))
        else:
            main_query.append(self.block(stmts, 10))
        main_query.append("         ]")
        main_query.append(f"    {_vname(program.result)}")
        main_query.append("    )")
        main_query.append("  )")
        for i in reversed(range(len(self.nested))):
            out.append(f"  (defquery nested{i} [method- options- {var_list}]")
            out.append(self.nested[i])
            out.append("  )")
        out.append("\n".join(main_query))
        out.append(")\n\n")
        out.append(f'(def model_name "{name}")')
        out.append(f'(def outfile "{name}_anglican.json")')
        out.append(_ANGLICAN_DRIVER)
        return "\n".join(out)

    def block(self, stmts, indent: int) -> str:
        var_list = self.var_list()
        pad = " " * indent
        if not stmts:
            return f"{pad}[{var_list} ]"
        lines = [f"{pad}(let ["]
        vpad = " " * (indent + 6)
        for stmt in stmts:
            lines.append(vpad + self.statement(stmt, indent + 6))
        lines.append(f"{pad}     ]")
        lines.append(f"{pad}  [{var_list} ]")
        lines.append(f"{pad})")
        return "\n".join(lines)

    def statement(self, stmt, indent: int) -> str:
        pad = " " * indent
        if isinstance(stmt, ast.Sample):
            v = _vname(stmt.var)
            d = self.dist(stmt.distribution)
            if stmt.add_previous_value:
                return f"{v} (+ {v} (sample {d}))"
            return f"{v} (sample {d})"
        if isinstance(stmt, ast.Assign):
            v = _vname(stmt.var)
            parts = [f"{v} (+"]
            if stmt.add_previous_value:
                parts.append(f" {v}")
            if stmt.addend is not None:
                factor, w = stmt.addend
                parts.append(f" (* {factor} {_vname(w)})")
            else:
                parts.append(" 0")
            parts.append(f" {stmt.offset})")
            return "".join(parts)
        if isinstance(stmt, ast.Decrement):
            v = _vname(stmt.var)
            n = stmt.offset
            return f"{v} (if (< {v} {n}) 0 (- {v} {n}))"
        if isinstance(stmt, ast.IfThenElse):
            ev = stmt.recognize_observe()
            if ev is not None:
                if isinstance(ev, ast.DataFromDist):
                    return f"_unused (observe {self.dist(ev.dist)} {ev.data})"
                return f"_unused (observe (flip 1.0) {self.event(ev)})"
            var_list = self.var_list()
            lines = [f"[{var_list}] (cond"]
            statement = stmt
            rest = stmt.els
            while isinstance(statement, ast.IfThenElse):
                lines.append(f"{pad}  {self.event(statement.cond)}")
                lines.append(self.block(statement.then, indent + 2))
                els = statement.els
                if (
                    len(els) == 1
                    and isinstance(els[0], ast.IfThenElse)
                    and els[0].recognize_observe() is None
                ):
                    statement = els[0]
                    continue
                rest = els
                break
            lines.append(f"{pad}  :else")
            lines.append(self.block(rest, indent + 2))
            lines.append(f"{pad})")
            return "\n".join(lines)
        if isinstance(stmt, ast.While):
            raise NotImplementedError("while loops in Anglican translation")
        if isinstance(stmt, ast.Fail):
            return "_ (observe (flip 1.0) false)"
        if isinstance(stmt, ast.Normalize):
            lines = []
            for v in range(self.num_vars):
                if v not in stmt.given_vars:
                    lines.append(
                        f'_unused (assert (= {_vname(v)} 0) "This form of '
                        "nested inference is not supported in Anglican: the "
                        f"variable `{_vname(v)}` should either be unassigned "
                        '(i.e. 0) at this point or part of the `normalize` '
                        'statement.")'
                    )
            var_list = self.var_list()
            nested_id = len(self.nested)
            sub = Anglican(self.num_vars)
            sub.nested = list(self.nested)
            body = sub.block(stmt.stmts, 4)
            self.nested.append(body)
            self.nested.extend(sub.nested[nested_id + 1 :])
            lines.append(
                f"[{var_list}] (sample ((apply conditional nested{nested_id} "
                f"method- options-) method- options- {var_list}))"
            )
            return f"\n{pad}".join(lines)
        raise AssertionError(stmt)

    def dist(self, d) -> str:
        if isinstance(d, ast.Dirac):
            return f"(dirac {_round(d.a)})"
        if isinstance(d, ast.Bernoulli):
            return f"(bernoulli {_round(d.p)})"
        if isinstance(d, ast.BernoulliVarProb):
            return f"(bernoulli {_vname(d.var)})"
        if isinstance(d, ast.BinomialVarTrials):
            return f"(binomial {_vname(d.var)} {_round(d.p)})"
        if isinstance(d, ast.Binomial):
            return f"(binomial {d.n} {_round(d.p)})"
        if isinstance(d, ast.Categorical):
            body = "".join(f"[{i} {_round(r)}] " for i, r in enumerate(d.rs))
            return f"(categorical [{body}])"
        if isinstance(d, (ast.NegBinomial, ast.NegBinomialVarSuccesses)):
            raise AssertionError(
                "Negative binomial distribution is not supported by Anglican"
            )
        if isinstance(d, ast.Geometric):
            return f"(geometric {_round(d.p)})"
        if isinstance(d, ast.Poisson):
            if d.rate.is_zero():
                return "(dirac 0)"
            return f"(poisson {_round(d.rate)})"
        if isinstance(d, ast.PoissonVarRate):
            lam = _round(d.rate)
            mu = _vname(d.var)
            return f"(if (zero? (* {lam} {mu})) (dirac 0) (poisson (* {lam} {mu})))"
        if isinstance(d, ast.UniformDisc):
            return f"(uniform-discrete {d.start} {d.end})"
        if isinstance(d, ast.Exponential):
            return f"(exponential {_round(d.rate)})"
        if isinstance(d, ast.Gamma):
            return f"(gamma {_round(d.shape)} {_round(d.rate)})"
        if isinstance(d, ast.UniformCont):
            return f"(uniform-continuous {_round(d.start)} {_round(d.end)})"
        raise AssertionError(d)

    def event(self, e) -> str:
        if isinstance(e, ast.InSet):
            body = "".join(f"{i} " for i in e.set)
            return f"(contains? [ {body}] {_vname(e.var)})"
        if isinstance(e, ast.VarComparison):
            op = {"=": "=", "<": "<", "<=": "<="}[e.comp]
            return f"({op} {_vname(e.v1)} {_vname(e.v2)})"
        if isinstance(e, ast.DataFromDist):
            return f"(= (sample {self.dist(e.dist)}) {e.data})"
        if isinstance(e, ast.Complement):
            return f"(not {self.event(e.event)})"
        if isinstance(e, ast.Intersection):
            return "(and" + "".join(f" {self.event(x)}" for x in e.events) + ")"
        raise AssertionError(e)


_ANGLICAN_DRIVER = r"""
; (def configurations [:rmh []])
(def configurations
  [
    [:importance []]
    [:lmh []]
    [:rmh []]
    [:smc []]
    [:smc [:number-of-particles 100]]
    [:pgibbs []]
    [:ipmcmc []]
  ])

; (def num_samples_options [1000])
(def num_samples_options [1000 10000])
(def thinning 1)

(spit outfile "[\n" :append false)

(def num-chains 20)

(doall
  (for [ num_samples num_samples_options
         [method options] configurations
         chain (range 0 num-chains)]
    (do
      (println (format "\nMethod %s with %s samples and options %s" method num_samples options))
      (println (format "Chain no. %s" chain))
      (let [start (. System (nanoTime))
            warmup (/ num_samples 5)
            samples (take-nth thinning (take (* num_samples thinning) (drop warmup (apply doquery method model [method options] options))))
            results (collect-results samples)
            values (map (fn [s] (get-result s)) samples)
            max-value (apply max values)
            mean (empirical-mean results)
            variance (empirical-variance results)
            std (empirical-std results)
            skewness (if (zero? std) (/ 0.0 0.0) (empirical-skew results))
            kurtosis (if (zero? std) (/ 0.0 0.0) (empirical-kurtosis results))
            distribution (empirical-distribution (collect-results samples))
            masses (for [n (range 0 (inc max-value))] (get distribution n 0.0))
            end (. System (nanoTime))
            elapsed_ms (/ (- end start) 1e6)]
        (println (format "Elapsed time: %s ms" elapsed_ms))
        (println (format "Empirical mean: %s" mean))
        (println (format "Empirical variance: %s" variance))
        (println (format "Empirical std: %s" std))
        (println (format "Empirical skewness: %s" skewness))
        (println (format "Empirical kurtosis: %s" kurtosis))
        (spit outfile (format
                   "{\"model\": \"%s\", \"system\": \"anglican\", \"method\": \"%s\", \"options\": \"%s\", \"num_samples\": %s, \"time_ms\": %s, \"total\": 1.0, \"mean\": %s, \"variance\": %s, \"stddev\": %s, \"skewness\": %s, \"kurtosis\": %s, \"masses\": [%s] },\n"
                   model_name method options num_samples elapsed_ms mean variance std skewness kurtosis
                   (clojure.string/join ", " masses)) :append true)
      )
    )
  )
)

(spit outfile "]\n" :append true)
"""


if __name__ == "__main__":
    main()
