"""Generic scan compilation of repeated-observation SGCL programs: the
twin of genfer_tpu's ``scanc.py`` over torch.

The approx-benchmark family (reference ``src/bin/generate_*.rs``:
hmm, mixture, population, population_modified, two_populations) all
share one shape: a short prologue followed by a long straight-line
repetition of one observation block whose iterations differ only in
numeric constants (the data).  The generic GF interpreter — like the
reference's (``src/generating_function.rs:670-765``) — rebuilds and
re-evaluates per-iteration expression nodes, so cost grows with the
dataset.

This module detects that repetition in the *parsed AST* (no
hand-modeling) and compiles the whole program into value-space "mass
semantics" on a truncated integer grid, with the repeated block as one
loop over the per-iteration constants:

* state: the joint unnormalized mass tensor ``g[v0, v1, ...]`` over the
  program's integer-valued variables (for integer-valued programs the
  PGF coefficient vector IS the mass vector, so this matches the GF
  semantics up to the same truncation the reference's Taylor engine
  applies at its evaluation degree);
* every statement is a (multi-)linear operator on ``g``: fresh samples
  are marginalize+outer, ``+~`` increments are truncated convolutions
  (Toeplitz matrix products), observations are diagonal likelihood
  reweightings, if/else blocks split on the event weight and recombine;
* per-iteration real parameters become HOST-precomputed f64 pmf rows
  fed through the loop, observation counts become host-built weight
  rows, and the carry max-rescales by powers of two with the final
  ``2**logz`` applied on the host (genfer_tpu's numeric policy, kept);
* truncation is self-validating: the program is run at order N and 2N
  and accepted only when the result marginals agree to ~1e-13, doubling
  otherwise (``compile_scan``).

What the JAX package ran as XLA becomes torch on one device:
``jax.lax.scan`` a Python loop over the steps, ``jax.vmap`` over a batch
of datasets or ``$param`` bindings ``torch.func.vmap``, and ``jax.jit``
of those batched entry points a CUDA graph captured per batch shape
(``compile.GraphedEntry``).  A one-shot run (``run``, ``run_with_data``,
the doubling check and the CLI's ``--compile-scan``) walks the loop
eagerly: each doubling order is a new object run once, so a capture
would cost more than it saves there.  The products stay library calls, as
they were XLA dots outside any Pallas kernel: ``torch.tensordot`` for the
kernels, a Toeplitz matrix (``taylor.backend._toeplitz``) times the state
for the increments, ``torch.einsum`` for the pair assignments.  Every
constant a block needs is made when the block is compiled, on its device,
so a captured walk copies nothing from the host.

``device``: the torch device (``None``: the CUDA card, which must exist;
``"cpu"``: the host).  genfer_tpu defaults to ``"cpu"`` because a
one-shot compile for its TPU cost 20-40 s; the port follows its own rule
that entry points run on the card unless the caller asks for the CPU.

Programs outside the supported fragment (continuous distributions,
``while`` loops, nested ``normalize``, no detectable repetition, ...)
raise :class:`UnsupportedForScan`; the CLI falls back to the generic
interpreter.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Optional

import numpy as np
import torch

from .compile import GraphedEntry
from .lang import ast
from .semantics.supportset import SupportSet, VarSupport
from .semantics.support_transform import SupportTransformer
from .taylor.backend import _resolve_device, _toeplitz
from .taylor.xp import TorchNamespace


class UnsupportedForScan(Exception):
    """The program (or a statement in it) is outside the scan-compilable
    fragment; callers should fall back to the generic interpreter."""


@dataclass(frozen=True)
class Slot:
    """A per-iteration data slot in the detected block template."""

    idx: int


# ----------------------------------------------------------------------
# structural signatures: statements serialized with literal positions
# (PosRatio values, observe data) replaced by markers
# ----------------------------------------------------------------------

def _sig_lits(obj, lits: list) -> str:
    if isinstance(obj, ast.PosRatio):
        lits.append(Fraction(obj.numer, obj.denom) if obj.denom else None)
        return "R"
    if isinstance(obj, ast.ParamRatio):
        return f"$({obj.name},{obj.complemented})"
    if isinstance(obj, ast.DataFromDist):
        lits.append(obj.data)
        return "D(" + _sig_lits(obj.dist, lits) + ")"
    if dataclasses.is_dataclass(obj):
        parts = [type(obj).__name__]
        for f in dataclasses.fields(obj):
            parts.append(_sig_lits(getattr(obj, f.name), lits))
        return "(" + ",".join(parts) + ")"
    if isinstance(obj, tuple):
        return "[" + ",".join(_sig_lits(x, lits) for x in obj) + "]"
    return repr(obj)


def _rebuild(obj, next_lit: Callable):
    """Rebuild ``obj`` visiting literal positions in the same order as
    :func:`_sig_lits`, replacing each with ``next_lit(original)`` (which
    returns either the original literal or a :class:`Slot`)."""
    if isinstance(obj, ast.PosRatio):
        return next_lit(obj)
    if isinstance(obj, ast.ParamRatio):
        return obj
    if isinstance(obj, ast.DataFromDist):
        data = next_lit(obj.data)
        return ast.DataFromDist(data, _rebuild(obj.dist, next_lit))
    if dataclasses.is_dataclass(obj):
        kw = {
            f.name: _rebuild(getattr(obj, f.name), next_lit)
            for f in dataclasses.fields(obj)
        }
        return type(obj)(**kw)
    if isinstance(obj, tuple):
        return tuple(_rebuild(x, next_lit) for x in obj)
    return obj


@dataclass
class Repetition:
    prologue: tuple
    template: tuple      # statements with varying literals -> Slot
    data: list           # data[j] = np.ndarray over iterations (slot j)
    n_iters: int
    epilogue: tuple


def detect_repetition(stmts, min_iters: int = 4) -> Optional[Repetition]:
    """Find the largest straight-line repetition of a block template in
    the top-level statement list (iterations differ only in numeric
    literals).  Returns None when no block repeats >= min_iters times."""
    sigs, lits = [], []
    for s in stmts:
        ls: list = []
        sigs.append(_sig_lits(s, ls))
        lits.append(ls)
    n = len(stmts)
    best = None  # (coverage, -period, start, period, count)
    max_p = min(32, n // max(min_iters, 2))
    for p in range(1, max_p + 1):
        i = 0
        while i + 2 * p <= n:
            if all(sigs[i + k] == sigs[i + p + k] for k in range(p)):
                count = 2
                while i + (count + 1) * p <= n and all(
                    sigs[i + k] == sigs[i + count * p + k] for k in range(p)
                ):
                    count += 1
                cov = count * p
                if count >= min_iters:
                    cand = (cov, -p, i, p, count)
                    if best is None or cand[:2] > best[:2]:
                        best = cand
                i += count * p
            else:
                i += 1
    if best is None:
        return None
    _, _, start, p, count = best
    # per-iteration literal rows (concatenated over the p statements)
    rows = [
        sum((lits[start + it * p + k] for k in range(p)), [])
        for it in range(count)
    ]
    n_slots = len(rows[0])
    varying = [
        any(rows[it][j] != rows[0][j] for it in range(count))
        for j in range(n_slots)
    ]
    data = []
    slot_of_pos = {}
    for j in range(n_slots):
        if varying[j]:
            vals = [rows[it][j] for it in range(count)]
            if any(v is None for v in vals):
                return None  # 0-denominator ratio; leave to interpreter
            arr = np.asarray([float(v) for v in vals], dtype=np.float64)
            slot_of_pos[j] = len(data)
            data.append(arr)
    pos = iter(range(n_slots))
    template = tuple(
        _rebuild(
            stmts[start + k],
            lambda orig: (
                Slot(slot_of_pos[j]) if varying[j := next(pos)] else orig
            ),
        )
        for k in range(p)
    )
    return Repetition(
        prologue=tuple(stmts[:start]),
        template=template,
        data=data,
        n_iters=count,
        epilogue=tuple(stmts[start + count * p:]),
    )


# ----------------------------------------------------------------------
# host-side pmf/kernel builders (real f64; stable recurrences, no
# device transcendentals — TPU numeric policy)
# ----------------------------------------------------------------------

def _pois_vec(lam: float, n: int) -> np.ndarray:
    out = np.zeros(n)
    out[0] = math.exp(-lam)
    for j in range(1, n):
        out[j] = out[j - 1] * lam / j
    return out


def _geom_vec(p: float, n: int) -> np.ndarray:
    return p * (1.0 - p) ** np.arange(n, dtype=np.float64)


def _bern_vec(p: float, n: int) -> np.ndarray:
    out = np.zeros(max(n, 2))
    out[0], out[1] = 1.0 - p, p
    return out[:n]


def _binom_vec(trials: int, p: float, n: int) -> np.ndarray:
    out = np.zeros(n)
    q = 1.0 - p
    w = q ** trials
    for k in range(min(trials, n - 1) + 1):
        out[k] = w
        if k < trials:
            w = w * (trials - k) / (k + 1) * (p / q) if q > 0 else 0.0
    if q == 0.0:  # degenerate p=1
        out[:] = 0.0
        if trials < n:
            out[trials] = 1.0
    return out


def _negbinom_vec(r: int, p: float, n: int) -> np.ndarray:
    """Failures before the r-th success, success prob p:
    pmf(k) = C(k+r-1, k) p^r (1-p)^k (reference ppl.rs NegBinomial pgf
    (p/(1-(1-p)x))^r)."""
    out = np.zeros(n)
    if r == 0:
        out[0] = 1.0
        return out
    out[0] = p ** r
    for k in range(1, n):
        out[k] = out[k - 1] * (k + r - 1) / k * (1.0 - p)
    return out


def _uniform_vec(start: int, end: int, n: int) -> np.ndarray:
    out = np.zeros(n)
    w = 1.0 / (end - start)
    out[max(0, start):max(0, min(end, n))] = w
    return out


def _dirac_vec(v: int, n: int) -> np.ndarray:
    out = np.zeros(n)
    if 0 <= v < n:
        out[v] = 1.0
    return out


def _categorical_vec(ps, n: int) -> np.ndarray:
    out = np.zeros(n)
    for i, p in enumerate(ps[:n]):
        out[i] = p
    return out


def _pascal_matrix(n_src: int, n_dst: int, p: float) -> np.ndarray:
    """K[s, d] = C(s, d) p^d (1-p)^(s-d) — Binomial(s, p) pmf rows."""
    K = np.zeros((n_src, n_dst))
    K[0, 0] = 1.0
    for i in range(1, n_src):
        K[i, 0] = K[i - 1, 0] * (1.0 - p)
        hi = min(i, n_dst - 1)
        K[i, 1:hi + 1] = (
            K[i - 1, 1:hi + 1] * (1.0 - p) + K[i - 1, 0:hi] * p
        )
        if i < n_dst:
            K[i, i] = p ** i
    return K


def _pois_rate_kernel(f: float, n_src: int, n_dst: int) -> np.ndarray:
    """K[s, d] = Poisson(d; f*s)."""
    lam = f * np.arange(n_src, dtype=np.float64)
    K = np.zeros((n_src, n_dst))
    K[:, 0] = np.exp(-lam)
    for d in range(1, n_dst):
        K[:, d] = K[:, d - 1] * lam / d
    return K


def _negbinom_var_kernel(p: float, n_src: int, n_dst: int) -> np.ndarray:
    """K[s, d] = NegBinomial(d; r=s, p)."""
    K = np.zeros((n_src, n_dst))
    for s in range(n_src):
        K[s] = _negbinom_vec(s, p, n_dst)
    return K


# observation weight rows (likelihood of observing count c per grid value)

def _obs_pois_rate_row(c: int, f: float, n: int) -> np.ndarray:
    """row[s] = Poisson(c; f*s) by the stable ratio recurrence (same
    convention as the committed scan families)."""
    lam = f * np.arange(n, dtype=np.float64)
    out = np.exp(-lam)
    for k in range(1, c + 1):
        out = out * lam / k
    return out


def _obs_binom_trials_row(c: int, rho: float, n: int) -> np.ndarray:
    """row[s] = C(s, c) rho^c (1-rho)^(s-c) for s >= c else 0, by the
    cumulative-ratio recurrence (exact nonnegative products)."""
    out = np.zeros(n)
    if c >= n:
        return out
    out[c] = rho ** c
    for s in range(c + 1, n):
        out[s] = out[s - 1] * s / (s - c) * (1.0 - rho)
    return out


def _obs_negbinom_var_row(c: int, p: float, n: int) -> np.ndarray:
    out = np.zeros(n)
    for s in range(n):
        if s == 0:
            out[s] = 1.0 if c == 0 else 0.0
        else:
            v = p ** s
            for k in range(1, c + 1):
                v = v * (k + s - 1) / k * (1.0 - p)
            out[s] = v
    return out


def _const_dist_pmf(dist, c: int) -> float:
    """pmf at integer c of a var-free distribution (host f64)."""
    if isinstance(dist, ast.Bernoulli):
        p = float(Fraction(dist.p.numer, dist.p.denom))
        return p if c == 1 else (1.0 - p) if c == 0 else 0.0
    if isinstance(dist, ast.Poisson):
        lam = float(Fraction(dist.rate.numer, dist.rate.denom))
        return _pois_vec(lam, c + 1)[c]
    if isinstance(dist, ast.Geometric):
        p = float(Fraction(dist.p.numer, dist.p.denom))
        return p * (1.0 - p) ** c
    if isinstance(dist, ast.Binomial):
        p = float(Fraction(dist.p.numer, dist.p.denom))
        return _binom_vec(dist.n, p, c + 1)[c]
    if isinstance(dist, ast.NegBinomial):
        p = float(Fraction(dist.p.numer, dist.p.denom))
        return _negbinom_vec(dist.n, p, c + 1)[c]
    if isinstance(dist, ast.UniformDisc):
        return 1.0 / (dist.end - dist.start) if dist.start <= c < dist.end else 0.0
    if isinstance(dist, ast.Dirac):
        v = dist.a.as_integer()
        if v is None:
            raise UnsupportedForScan("non-integer Dirac observation")
        return 1.0 if c == v else 0.0
    if isinstance(dist, ast.Categorical):
        if c < len(dist.rs):
            r = dist.rs[c]
            return float(Fraction(r.numer, r.denom))
        return 0.0
    raise UnsupportedForScan(f"observation from {dist}")


# ----------------------------------------------------------------------
# grid sizing from support analysis
# ----------------------------------------------------------------------

_FINITE_CAP = 4096


class _ContGrid:
    """Value grid of a continuous variable: quadrature nodes + weights
    (``dirac`` grids are finite value sets with unit weights).

    ``values_union`` marks grids whose node set is the forward
    value-set may-analysis union (_dirac_value_sets) — only then may
    affine assignments compile as value-lookup index kernels, because
    only then is a missing destination value PROVEN unreachable (zero
    mass) rather than silently dropped."""

    __slots__ = ("xs", "gw", "dirac", "values_union")

    def __init__(self, xs, gw, dirac=False, values_union=False):
        self.xs = np.asarray(xs, dtype=np.float64)
        self.gw = np.asarray(gw, dtype=np.float64)
        self.dirac = dirac
        self.values_union = values_union or dirac


def _collect_samples(stmts, out, copies=None):
    for s in stmts:
        if isinstance(s, ast.Sample):
            out.setdefault(s.var, []).append(s)
        elif copies is not None and _is_copy_assign(s):
            copies.setdefault(s.var, set()).add(s.addend[1])
        elif isinstance(s, ast.IfThenElse):
            _collect_samples(s.then, out, copies)
            _collect_samples(s.els, out, copies)
        elif isinstance(s, ast.Normalize):
            _collect_samples(s.stmts, out, copies)
        elif isinstance(s, ast.While):
            _collect_samples(s.body, out, copies)


def _is_copy_assign(s) -> bool:
    """``v := w`` exactly (a value copy: factor 1, offset 0, no
    previous-value add) — the one assignment form that is grid-exact on
    continuous value grids (the target aliases the source's grid)."""
    return (isinstance(s, ast.Assign) and not s.add_previous_value
            and s.addend is not None and s.addend[0] == 1
            and not isinstance(s.offset, Slot) and s.offset == 0)


def _static_ratio_f(r) -> float:
    if isinstance(r, Slot):
        raise UnsupportedForScan("varying continuous-grid parameter")
    return _ratio_f(r)


def _cont_domain(dist):
    """Static (lo, hi) quadrature domain of a continuous prior (the
    half-infinite tail bound matches the cascade quadrature's
    _prior_grid)."""
    import math

    if isinstance(dist, ast.UniformCont):
        return _static_ratio_f(dist.start), _static_ratio_f(dist.end)
    if isinstance(dist, ast.Exponential):
        b = _static_ratio_f(dist.rate)
        return 0.0, (1.0 + 40.0 * math.sqrt(2.0) + 120.0) / b
    if isinstance(dist, ast.Gamma):
        a = _static_ratio_f(dist.shape)
        b = _static_ratio_f(dist.rate)
        # shape < 1 has a singular pdf at 0 (x^{a-1}); the grid builder
        # removes the singularity analytically with the u = x^a power
        # substitution (see grid_sizes) — the raw x-domain stays the
        # same tail-bounded interval
        return 0.0, (a + 40.0 * math.sqrt(a + 1.0) + 120.0) / b
    raise UnsupportedForScan(f"continuous grid for {dist}")


def _uniform_cont_mass(lo, hi, xs, gw):
    wid = max(hi - lo, 1e-300)
    return np.where((xs >= lo) & (xs <= hi), 1.0 / wid, 0.0) * gw


def _gamma_mass(a, b, xs, gw):
    """pdf(Gamma(a, b)) * quadrature weight, stable at x = 0."""
    import math

    with np.errstate(divide="ignore", invalid="ignore"):
        logpdf = np.where(
            xs > 0,
            a * math.log(b)
            + (a - 1.0) * np.log(np.where(xs > 0, xs, 1.0))
            - b * xs - math.lgamma(a),
            (math.log(b) if a == 1.0 else -np.inf),
        )
        pdf = np.exp(logpdf)
    return np.nan_to_num(pdf, nan=0.0, posinf=0.0) * gw


def _pois_obs_vals(c: int, lams: np.ndarray) -> np.ndarray:
    """Poisson(c; lam) elementwise over an array of rates (host f64,
    stable for lam = 0)."""
    import math

    with np.errstate(divide="ignore", invalid="ignore"):
        if c == 0:
            row = np.exp(-lams)
        else:
            lg = np.where(lams > 0,
                          np.log(np.where(lams > 0, lams, 1.0)), -np.inf)
            row = np.exp(c * lg - lams - math.lgamma(c + 1))
    return np.nan_to_num(row, nan=0.0, posinf=0.0, neginf=0.0)


def _stmt_reads(s) -> set:
    reads = set()
    if isinstance(s, ast.Sample):
        d = s.distribution
        if hasattr(d, "var"):
            reads.add(d.var)
        if s.add_previous_value:
            reads.add(s.var)
    elif isinstance(s, ast.Assign):
        if s.addend is not None:
            reads.add(s.addend[1])
        if s.add_previous_value:
            reads.add(s.var)
    elif isinstance(s, ast.Decrement):
        reads.add(s.var)
    return reads


def _event_reads(ev) -> set:
    if isinstance(ev, ast.InSet):
        return {ev.var}
    if isinstance(ev, ast.VarComparison):
        return {ev.v1, ev.v2}
    if isinstance(ev, ast.DataFromDist):
        d = ev.dist
        return {d.var} if hasattr(d, "var") else set()
    if isinstance(ev, ast.Complement):
        return _event_reads(ev.event)
    if isinstance(ev, ast.Intersection):
        out = set()
        for e in ev.events:
            out |= _event_reads(e)
        return out
    return set()


def _check_cont_sampled_first(stmts, cont_vars: set, sampled: set) -> set:
    """The initial joint mass sits at grid INDEX 0, whose node value is
    not 0 on a quadrature grid — so a continuous variable may only be
    read after it has been sampled on every path."""
    for s in stmts:
        if isinstance(s, ast.IfThenElse):
            bad = (_event_reads(s.cond) & cont_vars) - sampled
            if bad:
                raise UnsupportedForScan(
                    "continuous var read before its first sample"
                )
            a = _check_cont_sampled_first(s.then, cont_vars, set(sampled))
            b = _check_cont_sampled_first(s.els, cont_vars, set(sampled))
            sampled = a & b
            continue
        if isinstance(s, ast.Normalize):
            sampled = _check_cont_sampled_first(
                s.stmts, cont_vars, sampled
            )
            continue
        if isinstance(s, ast.While):
            bad = (_event_reads(s.cond) & cont_vars) - sampled
            if bad:
                raise UnsupportedForScan(
                    "continuous var read before its first sample"
                )
            # the body may execute zero times: vars it samples do not
            # count as sampled afterwards
            _check_cont_sampled_first(s.body, cont_vars, set(sampled))
            continue
        bad = (_stmt_reads(s) & cont_vars) - sampled
        if bad:
            raise UnsupportedForScan(
                "continuous var read before its first sample"
            )
        if isinstance(s, ast.Sample) and not s.add_previous_value:
            sampled.add(s.var)
        elif isinstance(s, ast.Assign) and not s.add_previous_value:
            # fresh value (constant or affine of reads checked above)
            sampled.add(s.var)
    return sampled


_DENSITY_DISTS = (ast.UniformCont, ast.Exponential, ast.Gamma)

_VAR_DISTS = (ast.BinomialVarTrials, ast.PoissonVarRate,
              ast.NegBinomialVarSuccesses, ast.BernoulliVarProb)


def _is_cont_valued(dist) -> bool:
    """Sampling from ``dist`` leaves the variable holding a value that
    needs a VALUE grid (continuous density or fractional Dirac)."""
    if isinstance(dist, _DENSITY_DISTS):
        return True
    if isinstance(dist, ast.Dirac):
        try:
            a = _ratio_f(dist.a)
        except UnsupportedForScan:
            return False
        return a != int(a)
    return False


def _sub_event(ev, m: dict):
    if isinstance(ev, ast.InSet):
        return dataclasses.replace(ev, var=m.get(ev.var, ev.var))
    if isinstance(ev, ast.VarComparison):
        return dataclasses.replace(
            ev, v1=m.get(ev.v1, ev.v1), v2=m.get(ev.v2, ev.v2)
        )
    if isinstance(ev, ast.DataFromDist):
        d = ev.dist
        if hasattr(d, "var") and d.var in m:
            return dataclasses.replace(
                ev, dist=dataclasses.replace(d, var=m[d.var])
            )
        return ev
    if isinstance(ev, ast.Complement):
        return dataclasses.replace(ev, event=_sub_event(ev.event, m))
    if isinstance(ev, ast.Intersection):
        return dataclasses.replace(
            ev, events=tuple(_sub_event(e, m) for e in ev.events)
        )
    return ev


def _sub_stmt(s, m: dict):
    """Statement with every variable reference substituted through m
    (targets included: the map renames the *name*, not one use)."""
    if not m:
        return s
    if isinstance(s, ast.Sample):
        d = s.distribution
        if hasattr(d, "var") and d.var in m:
            d = dataclasses.replace(d, var=m[d.var])
        return dataclasses.replace(s, var=m.get(s.var, s.var),
                                   distribution=d)
    if isinstance(s, ast.Assign):
        add = s.addend
        if add is not None and add[1] in m:
            add = (add[0], m[add[1]])
        return dataclasses.replace(s, var=m.get(s.var, s.var),
                                   addend=add)
    if isinstance(s, ast.Decrement):
        return dataclasses.replace(s, var=m.get(s.var, s.var))
    if isinstance(s, ast.IfThenElse):
        return dataclasses.replace(
            s, cond=_sub_event(s.cond, m),
            then=tuple(_sub_stmt(t, m) for t in s.then),
            els=tuple(_sub_stmt(t, m) for t in s.els),
        )
    if isinstance(s, ast.While):
        return dataclasses.replace(
            s, cond=_sub_event(s.cond, m),
            body=tuple(_sub_stmt(t, m) for t in s.body),
        )
    if isinstance(s, ast.Normalize):
        return dataclasses.replace(
            s, given_vars=tuple(m.get(v, v) for v in s.given_vars),
            stmts=tuple(_sub_stmt(t, m) for t in s.stmts),
        )
    return s


def _rename_type_changes(program: ast.Program) -> ast.Program:
    """SSA-lite pre-pass: rewrite ``X ~ D(X)`` — a variable holding a
    CONTINUOUS value resampled from a discrete distribution
    parameterized by itself (reference semantics: the new draw depends
    on the old value, then replaces it; e.g. sample/
    bernoulli-compound-same-var.sgcl, sample/exponential-poisson.sgcl)
    — into ``X' ~ D(X)`` with a fresh ``X'`` substituted into every
    later reference.  One variable then lives on ONE static grid per
    axis (the continuous prior keeps its quadrature grid, the discrete
    redraw gets an integer grid) and the existing continuous-parent
    kernels apply.  Purely a renaming: the joint semantics are
    untouched.  Top-level straight-line only; at most one rename per
    variable (a repeated continuous->discrete->continuous cycle returns
    the program unchanged, falling back to the interpreter rather than
    growing an axis per occurrence)."""
    m: dict = {}
    cont_now: set = set()
    renamed: set = set()
    next_id = program.used_vars()
    out = []

    def _may_cont(block):
        # may-analysis inside branches: only ADDS vars (a var cont on
        # either path must be treated as cont afterwards; over-renaming
        # is semantically harmless, it just costs an axis)
        for t in block:
            if isinstance(t, ast.Sample) and not t.add_previous_value:
                if _is_cont_valued(t.distribution):
                    cont_now.add(t.var)
            elif isinstance(t, ast.Assign):
                add = t.addend
                frac = (not isinstance(t.offset, Slot)
                        and float(t.offset) != int(float(t.offset)))
                if frac or (add is not None and add[1] in cont_now):
                    cont_now.add(t.var)
            elif isinstance(t, ast.IfThenElse):
                _may_cont(t.then)
                _may_cont(t.els)
            elif isinstance(t, (ast.While, ast.Normalize)):
                _may_cont(getattr(t, "body", None)
                          or getattr(t, "stmts", ()))

    for s in program.stmts:
        s = _sub_stmt(s, m)
        if isinstance(s, ast.Sample) and not s.add_previous_value:
            d = s.distribution
            if (isinstance(d, _VAR_DISTS) and d.var == s.var
                    and s.var in cont_now):
                if s.var in renamed:
                    return program  # second cycle: interpreter path
                fresh = next_id
                next_id += 1
                m[s.var] = fresh
                renamed.add(fresh)
                cont_now.discard(s.var)
                out.append(dataclasses.replace(s, var=fresh))
                continue
            if _is_cont_valued(d):
                cont_now.add(s.var)
            elif not isinstance(d, _VAR_DISTS) or d.var != s.var:
                cont_now.discard(s.var)
        elif isinstance(s, ast.Assign):
            _may_cont((s,))
        elif isinstance(s, (ast.IfThenElse, ast.While, ast.Normalize)):
            _may_cont((s,))
        out.append(s)
    if not m:
        return program
    return dataclasses.replace(
        program, stmts=tuple(out),
        result=m.get(program.result, program.result),
    )


_DIRAC_SET_CAP = 256


def _dirac_value_sets(stmts, dvars: set, bound, infinite,
                      quad_seeds: dict, unroll: int = 8):
    """Forward may-analysis of the value sets of continuous variables.

    Dirac-class variables (defined only by fractional Dirac samples and
    affine assignments — reference corpus: test/expect/assign/*-cont.sgcl)
    start empty; quadrature-class variables (``quad_seeds``: var -> node
    array) start at their quadrature node set, so affine writes onto a
    quadrature grid are covered too — the image nodes join the grid with
    ZERO quadrature weight (only index kernels can move mass there; a
    fresh density re-sample deposits on the weighted seed nodes only).
    The union over all program points is each variable's static value
    grid; affine ops become index kernels on it.  Value arithmetic here
    uses the EXACT float expressions the kernel builders use
    (``y + (f*x + off)``), so kernel-time lookups match bit-for-bit.
    May-union over branches is sound: a superset grid only adds
    never-hit nodes."""
    vals: dict = {v: set() for v in dvars}
    seeds = {v: {float(x) for x in xs} for v, xs in quad_seeds.items()}
    for v, s in seeds.items():
        vals[v] = set(s)
    # a quadrature seed makes order-sized sets legitimate: scale the
    # growth cap with the largest seed (an affine chain in a while body
    # adds one image of the node set per unrolled iteration, so the
    # genuine union of a single-site loop is (unroll+1) seeds; allow
    # one extra straight-line site on top and refuse beyond — the axis
    # memory is real, every image node is a grid column)
    cap = max(_DIRAC_SET_CAP,
              (unroll + 2) * max((len(s) for s in seeds.values()),
                                 default=0))

    def src_vals(w):
        if w in vals:
            if not vals[w]:
                raise UnsupportedForScan(
                    "dirac-grid var read before its first definition"
                )
            return vals[w]
        if infinite[w]:
            raise UnsupportedForScan(
                "affine dirac assignment from an unbounded var"
            )
        if bound[w] > _DIRAC_SET_CAP:
            raise UnsupportedForScan("dirac assignment source too large")
        return {float(k) for k in range(bound[w])}

    def visit(block):
        for s in block:
            if isinstance(s, ast.IfThenElse):
                visit(s.then)
                visit(s.els)
            elif isinstance(s, ast.Normalize):
                visit(s.stmts)
            elif isinstance(s, ast.While):
                # the while compiles to `unroll` exit-split copies of
                # its body (see _while_op): absorb the body's writes
                # the same number of times (fixpoint-stopped).  A value
                # first reached at depth exactly `unroll` carries live
                # mass only AFTER the final body application — it is
                # tapped as rest, never fed through the kernel again —
                # so the union stays a sound may-analysis.
                u = s.unroll if s.unroll is not None else unroll
                for _ in range(u):
                    before = {v: len(vals[v]) for v in vals}
                    visit(s.body)
                    if all(len(vals[v]) == before[v] for v in vals):
                        break
            elif isinstance(s, ast.Sample) and s.var in vals:
                d = s.distribution
                if s.add_previous_value:
                    # `v +~ Bernoulli(v)`: each node x may move to
                    # x + 1.0 (same float expression the compound
                    # kernel's node matcher uses).  NO [0, 1] validity
                    # filter: the engine computes the FORMAL algebra
                    # G + (t-1)*dG (weight 1-x goes negative for
                    # x > 1, total mass preserved) and the kernel
                    # mirrors it, so the closure must cover the formal
                    # images too.  Inside a while the absorb loop adds
                    # one image per unrolled iteration — exactly the
                    # maximum application count of the exit-split body.
                    if not (isinstance(d, ast.BernoulliVarProb)
                            and d.var == s.var):
                        raise UnsupportedForScan(
                            f"dirac-grid var sampled from {d}"
                        )
                    vals[s.var] |= {
                        x + 1.0 for x in src_vals(s.var)
                    }
                elif s.var in seeds:
                    # fresh density sample on a quadrature-class var:
                    # marginalize+outer deposits pdf*gw mass on the
                    # weighted seed nodes only
                    vals[s.var] |= seeds[s.var]
                elif isinstance(d, ast.Dirac):
                    vals[s.var].add(_static_ratio_f(d.a))
                else:
                    raise UnsupportedForScan(
                        f"dirac-grid var sampled from {d}"
                    )
            elif isinstance(s, ast.Assign) and s.var in vals:
                off = s.offset
                if isinstance(off, Slot) or (
                    s.addend is not None and isinstance(s.addend[0], Slot)
                ):
                    raise UnsupportedForScan(
                        "varying dirac assignment constant"
                    )
                off = float(off)
                if s.addend is None:
                    adds = {off}
                else:
                    f, w = s.addend
                    adds = {f * x + off for x in src_vals(w)}
                if s.add_previous_value:
                    vals[s.var] |= {
                        y + a for y in src_vals(s.var) for a in adds
                    }
                else:
                    vals[s.var] |= adds
                if len(vals[s.var]) > cap:
                    raise UnsupportedForScan("dirac value grid too large")
            elif isinstance(s, ast.Decrement) and s.var in vals:
                raise UnsupportedForScan(
                    "decrement on a dirac value grid"
                )

    visit(stmts)
    return vals


def _writes_any(block, dvars: set) -> bool:
    for s in block:
        if isinstance(s, (ast.Sample, ast.Assign, ast.Decrement)):
            if s.var in dvars:
                return True
        elif isinstance(s, ast.IfThenElse):
            if _writes_any(s.then, dvars) or _writes_any(s.els, dvars):
                return True
        elif isinstance(s, ast.While):
            if _writes_any(s.body, dvars):
                return True
        elif isinstance(s, ast.Normalize):
            if _writes_any(s.stmts, dvars):
                return True
    return False


def _affine_writes_any(stmts, cvars: set) -> bool:
    """True if any non-copy Assign targets a var in ``cvars`` (at any
    block depth) — the trigger for running the value-set analysis over
    quadrature-class variables (their grids then grow image nodes)."""
    for s in stmts:
        if isinstance(s, ast.Assign) and s.var in cvars:
            if not _is_copy_assign(s):
                return True
        elif isinstance(s, ast.IfThenElse):
            if (_affine_writes_any(s.then, cvars)
                    or _affine_writes_any(s.els, cvars)):
                return True
        elif isinstance(s, ast.While):
            if _affine_writes_any(s.body, cvars):
                return True
        elif isinstance(s, ast.Normalize):
            if _affine_writes_any(s.stmts, cvars):
                return True
    return False


def grid_sizes(program: ast.Program, order: int, unroll: int = 8):
    """Per-variable axis sizes plus the continuous value grids.

    Discrete variables get integer grids (the running support join,
    finite bounds kept exact, infinite supports truncated at ``order``).
    A variable whose support ever goes non-discrete gets a quadrature
    grid over the hull of its sampling distributions' domains
    (composite Gauss-Legendre — exact for the polynomial likelihoods of
    the beta-bernoulli family, fast-converging for analytic ones);
    fractional Dirac supports become finite value-set grids.  Returns
    ``(sizes, cont)`` with ``cont`` mapping var -> _ContGrid."""
    nv = program.used_vars()
    bound = [1] * nv
    infinite = [False] * nv
    is_cont = [False] * nv

    class _Absorb(SupportTransformer):
        def transform_statement(self, stmt, init):
            out = super().transform_statement(stmt, init)
            for v in range(min(nv, out.num_vars())):
                s = out[v]
                if s.is_empty():
                    continue
                if not s.is_discrete():
                    is_cont[v] = True
                    continue
                rng = s.finite_nonempty_range()
                if rng is None:
                    infinite[v] = True
                else:
                    bound[v] = max(bound[v], rng.stop)
            return out

    try:
        _Absorb(unroll=unroll).semantics(program)
    except AssertionError as e:  # e.g. widening failure on loops
        raise UnsupportedForScan(str(e))
    cont = {}
    if any(is_cont):
        samples: dict = {}
        copies: dict = {}
        _collect_samples(program.stmts, samples, copies)
        # a copy-assigned continuous var aliases its sources' grid:
        # fold the sources' sample statements in (iterate: copies of
        # copies)
        for _ in range(nv):
            changed = False
            for v, srcs in copies.items():
                if not is_cont[v]:
                    continue
                cur = samples.setdefault(v, [])
                for w in srcs:
                    for s in samples.get(w, []):
                        if s not in cur:
                            cur.append(s)
                            changed = True
            if not changed:
                break
        dirac_class = []
        cont_compound = False
        for v in range(nv):
            if not is_cont[v]:
                continue
            ss = samples.get(v, [])
            dists = [s.distribution for s in ss]
            if not any(isinstance(d, _DENSITY_DISTS) for d in dists):
                # defined only by fractional Diracs and/or affine
                # assignments: a finite value set — computed by the
                # forward value-set analysis below (second pass, after
                # the quadrature grids exist so sources can be checked)
                dirac_class.append(v)
                continue
            compounds = [s for s in ss if s.add_previous_value]
            for s in compounds:
                d = s.distribution
                if not (isinstance(d, ast.BernoulliVarProb)
                        and d.var == v):
                    raise UnsupportedForScan(
                        "additive sample on a continuous var"
                    )
            if len(compounds) > 1:
                raise UnsupportedForScan(
                    "multiple additive compounds on one continuous var"
                )
            dists = [s.distribution for s in ss
                     if not s.add_previous_value]
            if any(isinstance(d, ast.Dirac) for d in dists):
                raise UnsupportedForScan(
                    "mixed Dirac/continuous sampling of one var"
                )
            lo = hi = None
            warp = None  # u = x^warp substitution (Gamma shape < 1)
            for d in dists:
                dl, dh = _cont_domain(d)
                lo = dl if lo is None else min(lo, dl)
                hi = dh if hi is None else max(hi, dh)
                if isinstance(d, ast.Gamma):
                    a = _static_ratio_f(d.shape)
                    if a < 1.0:
                        warp = a if warp is None else min(warp, a)
            if warp is None:
                xs, gw = _quad_grid(lo, hi, order)
            else:
                # Gamma(a < 1) pdf is singular at 0 (x^{a-1}): naive
                # panels plateau and FOOL the doubling check (measured:
                # Gamma(0.25, 0.1) stable at Z=0.9307 across three
                # doublings, truth 1.0).  Substituting x = u^{1/a}
                # cancels the singularity ANALYTICALLY:
                # x^{a-1} e^{-bx} dx = (1/a) e^{-b u^{1/a}} du — the
                # u-integrand is smooth (analytic when 1/a is integral),
                # so composite GL converges spectrally again.  The grid
                # stores x-nodes with dx-measure weights gw = du·dx/du;
                # every density on the grid (pdf(x)·gw) stays correct,
                # including other priors sharing the variable (a shape
                # a2 > warp contributes u^{(a2-warp)/warp}: bounded).
                if lo != 0.0:  # pragma: no cover - gamma domains are
                    raise UnsupportedForScan(  # [0, hi], uniforms >= 0
                        "power-warped grid with nonzero lower bound"
                    )
                us, uw = _quad_grid(0.0, hi ** warp, order)
                inv = 1.0 / warp
                xs = us ** inv
                gw = uw * inv * us ** (inv - 1.0)
            if compounds:
                # `v +~ Bernoulli(v)`: the value support extends to
                # x + 1 per application — the forward value-set
                # analysis below computes the closure (one image per
                # straight-line site, per-unrolled-iteration images
                # inside while bodies), and the shifted nodes join the
                # grid with ZERO quadrature weight: no density can
                # deposit prior mass there; they only receive mass
                # through the compound kernel (a later fresh density
                # sample correctly re-concentrates on the weighted
                # nodes, since sampling is marginalize+outer)
                cont_compound = True
            cont[v] = _ContGrid(xs, gw)
        if (dirac_class or cont_compound
                or _affine_writes_any(program.stmts, set(cont))):
            for v in dirac_class:
                comps = [s for s in samples.get(v, [])
                         if s.add_previous_value]
                for s in comps:
                    d = s.distribution
                    if not (isinstance(d, ast.BernoulliVarProb)
                            and d.var == v):
                        raise UnsupportedForScan(
                            "additive sample on a continuous var"
                        )
                if len(comps) > 1:
                    # the value-set closure bounds its depth assuming
                    # ONE compound site (images per unrolled iteration
                    # of that site); a second statement would need a
                    # per-site product closure nothing computes
                    # (quadrature grids have the same limit)
                    raise UnsupportedForScan(
                        "multiple additive compounds on one continuous "
                        "var"
                    )
            sets = _dirac_value_sets(
                program.stmts, set(dirac_class), bound, infinite,
                {v: g.xs for v, g in cont.items()}, unroll=unroll,
            )
            for v in dirac_class:
                vv = sets[v]
                if not vv:
                    raise UnsupportedForScan(
                        f"continuous {ast.var_name(v)} never defined"
                    )
                cont[v] = _ContGrid(
                    sorted(vv), np.ones(len(vv)), dirac=True
                )
            for v, g in list(cont.items()):
                # affine writes onto a quadrature grid: the image nodes
                # join the grid with ZERO quadrature weight (no density
                # deposits prior mass there; only the affine index
                # kernels move mass onto them).  Every quadrature grid
                # that went through the analysis is a value union now —
                # affine assigns may compile as value-lookup kernels.
                if v in dirac_class:
                    continue
                ext = sorted(sets[v] - {float(x) for x in g.xs})
                cont[v] = _ContGrid(
                    np.concatenate([g.xs, np.asarray(ext)])
                    if ext else g.xs,
                    np.concatenate([g.gw, np.zeros(len(ext))])
                    if ext else g.gw,
                    values_union=True,
                )
        sampled = _check_cont_sampled_first(program.stmts, set(cont), set())
        if program.result in cont and program.result not in sampled:
            # the result var's VALUE is consumed (moments): mass left at
            # grid index 0 on an unsampled path would read node value
            # xs[0] != 0 and the error is grid-independent — the
            # doubling check cannot catch it
            raise UnsupportedForScan(
                "continuous result not sampled on every path"
            )
    sizes = []
    for v in range(nv):
        if v in cont:
            sizes.append(len(cont[v].xs))
        elif infinite[v]:
            sizes.append(int(order))
        else:
            if bound[v] > _FINITE_CAP:
                raise UnsupportedForScan(
                    f"finite support of {ast.var_name(v)} too large "
                    f"({bound[v]})"
                )
            sizes.append(bound[v])
    return sizes, cont


# ----------------------------------------------------------------------
# mass-semantics compiler
# ----------------------------------------------------------------------

def _ratio_or_slot(x):
    """A PosRatio/Slot/ParamRatio parameter -> ('static', float) |
    ('slot', idx) | ('param', (name, complemented))."""
    if isinstance(x, Slot):
        return ("slot", x.idx)
    if isinstance(x, ast.ParamRatio):
        return ("param", (x.name, x.complemented))
    if isinstance(x, ast.PosRatio):
        if x.denom == 0:
            raise UnsupportedForScan("ratio with zero denominator")
        return ("static", float(Fraction(x.numer, x.denom)))
    if isinstance(x, int):
        return ("static", float(x))
    raise UnsupportedForScan(f"unsupported parameter {x!r}")


class _MassCompiler:
    """Compiles statement blocks to functions ``g, xs -> g`` on the
    joint mass tensor; per-iteration quantities are host-precomputed
    arrays delivered through ``xs`` (one entry per registered feed).
    Every constant a block needs is made here, on ``device`` (``None``:
    the CUDA card)."""

    def __init__(self, sizes, cont=None, unroll: int = 8, device=None):
        self.jnp = TorchNamespace(_resolve_device(device))
        self.sizes = sizes
        self.cont = cont or {}  # var -> _ContGrid (continuous values)
        self.nv = len(sizes)
        #: default unroll count for While statements without an
        #: ``unroll n`` annotation (the CLI's --unroll, reference
        #: default 8)
        self.unroll = int(unroll)
        #: given axes of the enclosing ``normalize`` statements at the
        #: current COMPILE position: rest-mass combining (if-joins,
        #: normalize rescaling) mirrors the reference's per-given-value
        #: enumeration by reducing rest tensors to this granularity
        #: before taking maxima (gf_transformer.transform_normalize
        #: hands each slice the scalar rest and maxes the slice
        #: results)
        self._gv_active: frozenset = frozenset()
        # per-step feeds: fn(slot_values, params) -> np.ndarray, read
        # from env[0] (the scan's per-iteration xs)
        self.feeds = []
        # binding-only feeds ($param, no per-iteration slot): fn(params)
        # -> np.ndarray, read from env[1] (per-run constants) — legal in
        # the prologue/epilogue too
        self.const_feeds = []

    # -- feed/static helpers -------------------------------------------
    def _maybe_feed(self, prep: Callable, params: list):
        """prep(*param_floats) -> np.ndarray.  All-static params give a
        baked device constant; otherwise registers a per-iteration feed and
        returns a closure reading it from xs."""
        kinds = [_ratio_or_slot(p) for p in params]
        if all(k == "static" for k, _ in kinds):
            arr = self.jnp.asarray(prep(*[v for _, v in kinds]))
            return lambda env: arr

        def _arg(k, v, slot_values, penv):
            if k == "static":
                return v
            if k == "slot":
                return slot_values[v]
            name, comp = v  # param
            try:
                val = penv[name]
            except (KeyError, TypeError):
                raise UnsupportedForScan(
                    f"unbound $param {name!r}: pass params= to "
                    f"compile_scan_program / run_with_data"
                )
            return 1.0 - float(val) if comp else float(val)

        if not any(k == "slot" for k, _ in kinds):
            # $param-only: constant across iterations, rebuilt per
            # binding and passed as a run-time argument
            def cresolve(penv):
                return prep(*[
                    _arg(k, v, None, penv) for k, v in kinds
                ])
            cidx = len(self.const_feeds)
            self.const_feeds.append(cresolve)
            return lambda env: env[1][cidx]

        def resolve(slot_values, penv=None):
            return prep(*[
                _arg(k, v, slot_values, penv) for k, v in kinds
            ])
        idx = len(self.feeds)
        self.feeds.append(resolve)
        return lambda env: env[0][idx]

    # -- axis helpers ---------------------------------------------------
    def _vals(self, v: int) -> np.ndarray:
        """Grid node VALUES of axis v (= arange for integer grids)."""
        g = self.cont.get(v)
        if g is not None:
            return g.xs
        return np.arange(self.sizes[v], dtype=np.float64)

    def _bshape(self, axis: int, ln: int):
        sh = [1] * self.nv
        sh[axis] = ln
        return tuple(sh)

    def _bshape2(self, ax1: int, ln1: int, ax2: int, ln2: int):
        sh = [1] * self.nv
        sh[ax1] = ln1
        sh[ax2] = ln2
        return tuple(sh)

    def _matrix_apply(self, g, axis: int, K):
        """g' = sum_src g[.., src, ..] K[src, dst] along ``axis``."""
        jnp = self.jnp
        h = jnp.moveaxis(g, axis, -1)
        h = jnp.tensordot(h, K, axes=([h.ndim - 1], [0]))
        return jnp.moveaxis(h, -1, axis)

    def _conv_along(self, g, axis: int, vec):
        """Truncated convolution of axis ``axis`` with pmf ``vec``."""
        jnp = self.jnp
        n = g.shape[axis]
        h = jnp.moveaxis(g, axis, 0)
        sh = h.shape
        h2 = h.reshape(n, -1)
        T = _toeplitz(vec, n, n)
        out = T @ h2
        return jnp.moveaxis(out.reshape(sh), 0, axis)

    def _skew_add(self, g, ax_w: int, ax_v: int):
        """g'[.., n_w, .., m_v] = g[.., n_w, .., (m - n)_v]: the
        ``v += w`` remap as a pure pad/reshape/slice skew (no gathers;
        mass with m >= size_v is dropped = truncation)."""
        jnp = self.jnp
        R = g.shape[ax_w]
        C = g.shape[ax_v]
        h = jnp.moveaxis(g, (ax_w, ax_v), (0, 1))
        sh = h.shape
        h2 = h.reshape(R, C, -1)
        B = h2.shape[-1]
        pad = jnp.zeros((R, R, B), h2.dtype)
        P = jnp.concatenate([h2, pad], axis=1)          # (R, C+R, B)
        s = C + R - 1
        flat = P.reshape(R * (C + R), B)
        out = flat[: R * s].reshape(R, s, B)[:, :C]
        return jnp.moveaxis(out.reshape(sh), (0, 1), (ax_w, ax_v))

    def _shift_along(self, g, axis: int, c: int):
        if c == 0:
            return g
        jnp = self.jnp
        n = g.shape[axis]
        h = jnp.moveaxis(g, axis, 0)
        if c >= n:
            return jnp.moveaxis(jnp.zeros_like(h), 0, axis)
        z = jnp.zeros((c,) + h.shape[1:], h.dtype)
        out = jnp.concatenate([z, h[: n - c]], axis=0)
        return jnp.moveaxis(out, 0, axis)

    # -- distributions --------------------------------------------------
    def _dist_vec(self, dist, v: int, n: int):
        """Var-free distribution -> mass row fn(xs) of length n on
        axis ``v``'s grid (pmf on integer grids; pdf * quadrature weight
        on continuous grids; one-hot on Dirac value grids)."""
        g = self.cont.get(v)
        if g is not None:
            if isinstance(dist, ast.Dirac):
                a = _static_ratio_f(dist.a)
                row = (np.abs(g.xs - a) <= 1e-12 * max(abs(a), 1.0))
                if row.sum() != 1:
                    raise UnsupportedForScan(
                        "Dirac value missing from the value grid"
                    )
                arr = self.jnp.asarray(row.astype(np.float64))
                return lambda xs: arr
            if g.dirac:
                raise UnsupportedForScan(
                    "continuous sample into a Dirac value grid"
                )
            if isinstance(dist, ast.UniformCont):
                return self._maybe_feed(
                    lambda lo, hi, xs=g.xs, gw=g.gw:
                        _uniform_cont_mass(lo, hi, xs, gw),
                    [dist.start, dist.end],
                )
            if isinstance(dist, ast.Exponential):
                return self._maybe_feed(
                    lambda b, xs=g.xs, gw=g.gw: _gamma_mass(1.0, b, xs, gw),
                    [dist.rate],
                )
            if isinstance(dist, ast.Gamma):
                return self._maybe_feed(
                    lambda a, b, xs=g.xs, gw=g.gw: _gamma_mass(a, b, xs, gw),
                    [dist.shape, dist.rate],
                )
            raise UnsupportedForScan(
                f"distribution {dist} on a continuous grid"
            )
        if isinstance(dist, (ast.UniformCont, ast.Exponential, ast.Gamma)):
            raise UnsupportedForScan(
                f"continuous {dist} into an integer grid"
            )
        if isinstance(dist, ast.Poisson):
            return self._maybe_feed(lambda lam: _pois_vec(lam, n),
                                    [dist.rate])
        if isinstance(dist, ast.Geometric):
            return self._maybe_feed(lambda p: _geom_vec(p, n), [dist.p])
        if isinstance(dist, ast.Bernoulli):
            return self._maybe_feed(lambda p: _bern_vec(p, n), [dist.p])
        if isinstance(dist, ast.Binomial):
            if isinstance(dist.n, Slot):
                raise UnsupportedForScan("varying Binomial trial count")
            return self._maybe_feed(
                lambda p: _binom_vec(dist.n, p, n), [dist.p]
            )
        if isinstance(dist, ast.NegBinomial):
            if isinstance(dist.n, Slot):
                raise UnsupportedForScan("varying NegBinomial successes")
            return self._maybe_feed(
                lambda p: _negbinom_vec(dist.n, p, n), [dist.p]
            )
        if isinstance(dist, ast.UniformDisc):
            if isinstance(dist.start, Slot) or isinstance(dist.end, Slot):
                raise UnsupportedForScan("varying Uniform bounds")
            arr = self.jnp.asarray(_uniform_vec(dist.start, dist.end, n))
            return lambda xs: arr
        if isinstance(dist, ast.Dirac):
            return self._maybe_feed(
                lambda a: _dirac_vec(int(round(a)), n), [dist.a]
            )
        if isinstance(dist, ast.Categorical):
            return self._maybe_feed(
                lambda *ps: _categorical_vec(ps, n), list(dist.rs)
            )
        raise UnsupportedForScan(f"distribution {dist}")

    def _dist_kernel(self, dist, n_src: int, n_dst: int,
                     shift_rows: bool = False):
        """Var-dependent distribution -> (w, kernel_fn) with
        K[w_value, sampled_value].  ``shift_rows`` shifts row s right by
        s (host-side), turning a delta kernel into the ``v +~ D(v)``
        destination kernel."""
        post = _shift_kernel_rows if shift_rows else (lambda K: K)
        gsrc = self.cont.get(dist.var)
        if gsrc is not None:
            # continuous parent: kernel rows evaluated at the node
            # VALUES (the parent axis keeps its quadrature masses; the
            # kernel is a plain conditional pmf, no weights)
            if shift_rows:
                raise UnsupportedForScan(
                    "additive sample from a continuous parent"
                )
            xs_nodes = gsrc.xs
            if isinstance(dist, ast.PoissonVarRate):
                return dist.var, self._maybe_feed(
                    lambda f, xsn=xs_nodes: np.stack(
                        [_pois_vec(f * x, n_dst) for x in xsn]
                    ),
                    [dist.rate],
                )
            if isinstance(dist, ast.BernoulliVarProb):
                K = np.zeros((len(xs_nodes), n_dst))
                K[:, 0] = 1.0 - xs_nodes
                if n_dst > 1:
                    K[:, 1] = xs_nodes
                arr = self.jnp.asarray(K)
                return dist.var, (lambda xs, arr=arr: arr)
            raise UnsupportedForScan(
                f"sample from {dist} with a continuous parent"
            )
        if isinstance(dist, ast.BinomialVarTrials):
            return dist.var, self._maybe_feed(
                lambda p: post(_pascal_matrix(n_src, n_dst, p)), [dist.p]
            )
        if isinstance(dist, ast.PoissonVarRate):
            return dist.var, self._maybe_feed(
                lambda f: post(_pois_rate_kernel(f, n_src, n_dst)),
                [dist.rate],
            )
        if isinstance(dist, ast.NegBinomialVarSuccesses):
            return dist.var, self._maybe_feed(
                lambda p: post(_negbinom_var_kernel(p, n_src, n_dst)),
                [dist.p],
            )
        if isinstance(dist, ast.BernoulliVarProb):
            if n_src > 2:
                raise UnsupportedForScan(
                    "Bernoulli(var) with non-boolean support"
                )
            K = post(np.eye(n_src, n_dst))
            arr = self.jnp.asarray(K)
            return dist.var, (lambda xs: arr)
        raise UnsupportedForScan(f"distribution {dist}")

    @staticmethod
    def _dist_has_var(dist) -> bool:
        return isinstance(dist, (
            ast.BinomialVarTrials, ast.PoissonVarRate,
            ast.NegBinomialVarSuccesses, ast.BernoulliVarProb,
        ))

    # -- event weights --------------------------------------------------
    def _event_weight(self, event) -> Callable:
        """Event -> fn(xs) returning a [0,1] weight broadcastable over
        the mass tensor (the per-grid-point probability of the event)."""
        jnp = self.jnp
        if isinstance(event, ast.InSet):
            v = event.var
            n = self.sizes[v]
            g = self.cont.get(v)
            if g is not None and not g.dirac:
                raise UnsupportedForScan(
                    "set membership on a continuous grid"
                )
            ind = np.zeros(n)
            for x in event.set:
                if isinstance(x, Slot):
                    raise UnsupportedForScan("varying InSet member")
                if g is not None:  # Dirac value grid: match by VALUE
                    ind[np.abs(g.xs - float(x)) <= 1e-12] = 1.0
                elif 0 <= x < n:
                    ind[x] = 1.0
            arr = jnp.asarray(ind.reshape(self._bshape(v, n)))
            return lambda xs: arr
        if isinstance(event, ast.VarComparison):
            v1, v2 = event.v1, event.v2
            n1, n2 = self.sizes[v1], self.sizes[v2]
            a = self._vals(v1)[:, None]
            b = self._vals(v2)[None, :]
            if event.comp == ast.Comparison.EQ:
                ind = (a == b).astype(np.float64)
            elif event.comp == ast.Comparison.LT:
                ind = (a < b).astype(np.float64)
            elif event.comp == ast.Comparison.LE:
                ind = (a <= b).astype(np.float64)
            else:
                raise UnsupportedForScan(f"comparison {event.comp}")
            if v1 == v2:
                diag = np.diagonal(ind).copy().reshape(
                    self._bshape(v1, n1)
                )
                arr = jnp.asarray(diag)
            else:
                if v1 > v2:
                    ind = ind.T
                arr = jnp.asarray(
                    ind.reshape(self._bshape2(v1, n1, v2, n2))
                )
            return lambda xs: arr
        if isinstance(event, ast.DataFromDist):
            return self._data_from_dist_weight(event.data, event.dist)
        if isinstance(event, ast.Complement):
            inner = self._event_weight(event.event)
            return lambda xs: 1.0 - inner(xs)
        if isinstance(event, ast.Intersection):
            parts = [self._event_weight(e) for e in event.events]
            if not parts:
                one = jnp.asarray(1.0)
                return lambda xs: one
            def w(xs):
                out = parts[0](xs)
                for p in parts[1:]:
                    out = out * p(xs)
                return out
            return w
        raise UnsupportedForScan(f"event {event}")

    def _data_from_dist_weight(self, data, dist) -> Callable:
        """Likelihood of drawing ``data`` from ``dist`` per grid point."""
        if self._dist_has_var(dist):
            w = dist.var
            n = self.sizes[w]
            sh = self._bshape(w, n)
            gsrc = self.cont.get(w)
            if gsrc is not None:
                xs_nodes = gsrc.xs
                if isinstance(dist, ast.PoissonVarRate):
                    return self._maybe_feed(
                        lambda c, f, xsn=xs_nodes: _pois_obs_vals(
                            int(round(c)), f * xsn).reshape(sh),
                        [data, dist.rate],
                    )
                if isinstance(dist, ast.BernoulliVarProb):
                    def bern_row(c, xsn=xs_nodes):
                        c = int(round(c))
                        if c == 1:
                            row = xsn
                        elif c == 0:
                            row = 1.0 - xsn
                        else:  # impossible observation: zero likelihood
                            row = np.zeros_like(xsn)
                        return row.reshape(sh)

                    return self._maybe_feed(bern_row, [data])
                raise UnsupportedForScan(
                    f"observation from {dist} with a continuous parent"
                )
            if isinstance(dist, ast.PoissonVarRate):
                fn = self._maybe_feed(
                    lambda c, f: _obs_pois_rate_row(
                        int(round(c)), f, n).reshape(sh),
                    [data, dist.rate],
                )
            elif isinstance(dist, ast.BinomialVarTrials):
                fn = self._maybe_feed(
                    lambda c, p: _obs_binom_trials_row(
                        int(round(c)), p, n).reshape(sh),
                    [data, dist.p],
                )
            elif isinstance(dist, ast.NegBinomialVarSuccesses):
                fn = self._maybe_feed(
                    lambda c, p: _obs_negbinom_var_row(
                        int(round(c)), p, n).reshape(sh),
                    [data, dist.p],
                )
            elif isinstance(dist, ast.BernoulliVarProb):
                if n > 2:
                    raise UnsupportedForScan(
                        "Bernoulli(var) with non-boolean support"
                    )
                fn = self._maybe_feed(
                    lambda c: np.asarray(
                        [1.0 if int(round(c)) == s else 0.0
                         for s in range(n)]
                    ).reshape(sh),
                    [data],
                )
            else:  # pragma: no cover
                raise UnsupportedForScan(f"observation from {dist}")
            return fn
        # var-free: scalar likelihood (params as host f64)
        plist = _collect_ratio_params(dist)
        if not isinstance(data, Slot) and not any(
            isinstance(p, Slot) for p in plist
        ):
            arr = self.jnp.asarray(_const_dist_pmf(dist, int(data)))
            return lambda xs: arr
        pmf = _const_dist_pmf_fn(dist)
        return self._maybe_feed(
            lambda c, *ps: np.asarray(pmf(int(round(c)), *ps)),
            [data] + plist,
        )

    # -- statements -----------------------------------------------------
    #
    # Rest-mass threading (mirrors GfTranslation.rest through the
    # reference's statement rules, gf_transformer.py:230-380): a block
    # compiles to ``g, rest, xs -> (g, rest)``.  Ordinary statements
    # never touch ``rest`` and keep the plain ``g, xs -> g`` signature;
    # only While (adds the still-live mass), IfThenElse with rest-aware
    # branches (join = max for event conditions, blend = weighted sum
    # for const-prob conditions), Fail (zeroes it, GfTranslation.zero)
    # and Normalize (factor interval) are wrapped.  ``rest`` stays the
    # python float 0.0 until a While contributes, so loop-free programs
    # trace exactly as before.
    def compile_block(self, stmts) -> Callable:
        ops = [self._stmt_op(s) for s in stmts]
        touches = any(getattr(op, "rest_aware", False) for op in ops)

        def apply(g, rest, xs):
            for op in ops:
                if getattr(op, "rest_aware", False):
                    g, rest = op(g, rest, xs)
                else:
                    g = op(g, xs)
            return g, rest

        apply.rest_aware = True
        apply.touches_rest = touches
        return apply

    def _red(self, t, axes):
        """Reduce a rest tensor over ``axes`` (keepdims) — the
        granularity step before a reference-style rest max.  Scalars
        (python 0.0 or 0-d) pass through."""
        if not axes or isinstance(t, float) or getattr(t, "ndim", 0) == 0:
            return t
        return self.jnp.sum(t, axis=axes, keepdims=True)

    def _stmt_op(self, stmt) -> Callable:
        jnp = self.jnp
        if isinstance(stmt, ast.IfThenElse):
            ev = stmt.recognize_observe()
            if ev is not None:
                w = self._event_weight(ev)
                return lambda g, xs: g * w(xs)
            w = self._event_weight(stmt.cond)
            then_ap = self.compile_block(stmt.then)
            else_fails = (
                len(stmt.els) == 1 and isinstance(stmt.els[0], ast.Fail)
            )
            then_fails = (
                len(stmt.then) == 1 and isinstance(stmt.then[0], ast.Fail)
            )
            from .numbers.scalar import F64

            const_p = stmt.cond.recognize_const_prob(F64)
            if else_fails:
                def ap_ef(g, rest, xs):
                    gt, rt = then_ap(g * w(xs), rest, xs)
                    if const_p is not None:
                        # reference const-prob blend with a zero (fail)
                        # branch: rest_out = p*(rest_in + adds); the
                        # branch ran on the weighted mass so its adds
                        # are already scaled — rescale only rest_in
                        return gt, rt - (1.0 - float(const_p)) * rest
                    # event join with GfTranslation.zero: max keeps the
                    # live branch's rest
                    return gt, rt
                ap_ef.rest_aware = True
                return ap_ef
            else_ap = self.compile_block(stmt.els)
            if then_fails:
                def ap_tf(g, rest, xs):
                    ge, re_ = else_ap(g * (1.0 - w(xs)), rest, xs)
                    if const_p is not None:
                        return ge, re_ - float(const_p) * rest
                    return ge, re_
                ap_tf.rest_aware = True
                return ap_tf
            if not (then_ap.touches_rest or else_ap.touches_rest):
                def ap(g, xs):
                    wv = w(xs)
                    gt, _ = then_ap(g * wv, 0.0, xs)
                    ge, _ = else_ap(g * (1.0 - wv), 0.0, xs)
                    return gt + ge
                return ap
            red_axes = tuple(
                a for a in range(self.nv) if a not in self._gv_active
            )

            def ap2(g, rest, xs):
                wv = w(xs)
                gt, rt = then_ap(g * wv, rest, xs)
                ge, re_ = else_ap(g * (1.0 - wv), rest, xs)
                if const_p is not None:
                    # reference const-prob blend (gf.rs:302-310 =
                    # gf_transformer.py:334-342): rests add; each
                    # branch's additions are already weighted because
                    # the branch ran on the weighted mass, so undo the
                    # doubly-counted incoming rest
                    return gt + ge, rt + re_ - rest
                # event join (GfTranslation.join): rests take the max,
                # at the enclosing given-variable granularity
                comb = jnp.maximum(self._red(rt, red_axes),
                                   self._red(re_, red_axes))
                return gt + ge, comb

            ap2.rest_aware = True
            return ap2
        if isinstance(stmt, ast.Sample):
            return self._sample_op(stmt)
        if isinstance(stmt, ast.Assign):
            return self._assign_op(stmt)
        if isinstance(stmt, ast.Decrement):
            v, c = stmt.var, stmt.offset
            if v in self.cont:
                raise UnsupportedForScan("decrement on a continuous grid")
            if isinstance(c, Slot):
                raise UnsupportedForScan("varying decrement offset")
            n = self.sizes[v]
            D = np.zeros((n, n))
            for s in range(n):
                D[s, max(s - c, 0)] = 1.0
            K = self.jnp.asarray(D)
            return lambda g, xs: self._matrix_apply(g, v, K)
        if isinstance(stmt, ast.Fail):
            # reference: Fail -> GfTranslation.zero (gf and rest BOTH
            # zeroed, gf_transformer.py:372-373)
            def ap_fail(g, rest, xs):
                return jnp.zeros_like(g), 0.0
            ap_fail.rest_aware = True
            return ap_fail
        if isinstance(stmt, ast.Normalize):
            return self._normalize_op(stmt)
        if isinstance(stmt, ast.While):
            return self._while_op(stmt)
        raise UnsupportedForScan(f"statement {type(stmt).__name__}")

    def _check_while_cont_writes(self, block):
        """Reject the continuous-grid writes a while body cannot carry
        per-iteration (see _while_op); everything else compiles through
        the ordinary statement operators."""
        for s in block:
            if isinstance(s, ast.Sample) and s.var in self.cont:
                if s.add_previous_value:
                    d = s.distribution
                    if not (isinstance(d, ast.BernoulliVarProb)
                            and d.var == s.var):
                        raise UnsupportedForScan(
                            "additive sample on a continuous var"
                        )
                    # `v +~ Bernoulli(v)` is fine per-iteration: the
                    # value-set analysis closed the grid over x -> x+1
                    # images through the unrolled body (one image per
                    # iteration), and the kernel applies the engine's
                    # FORMAL algebra at every node — stay-weight 1-x
                    # even where that is negative (see _sample_op)
            elif isinstance(s, ast.Assign) and s.var in self.cont:
                if (not self.cont[s.var].values_union
                        and not _is_copy_assign(s)):
                    raise UnsupportedForScan(
                        "while writes a quadrature-grid variable"
                    )
            elif isinstance(s, ast.Decrement) and s.var in self.cont:
                raise UnsupportedForScan(
                    "decrement on a continuous grid"
                )
            elif isinstance(s, ast.IfThenElse):
                self._check_while_cont_writes(s.then)
                self._check_while_cont_writes(s.els)
            elif isinstance(s, ast.While):
                self._check_while_cont_writes(s.body)
            elif isinstance(s, ast.Normalize):
                self._check_while_cont_writes(s.stmts)

    def _while_op(self, stmt: ast.While) -> Callable:
        """Bounded unrolling with a rest-mass tap (reference:
        semantics/gf.rs while rule = gf_transformer.py:348-370): each
        iteration splits the live mass by the loop condition — the
        exiting part joins the result, the entering part runs the body —
        and whatever is still live after ``unroll`` iterations is
        tapped as rest mass (it makes the printed results intervals:
        p(k) in [p_k, p_k + rest]).  The condition weight is a function
        of grid coordinates/feeds only, so it is computed once; mass
        the body pushes past the grid end is recovered by the
        grid-doubling validation (a truncating grid disagrees with its
        doubling).

        Rest rule (mirrors gf_transformer.py:348-366): the joined loop
        exits carry the rest as it stood BEFORE the last body run (the
        reference's per-iteration join maxes the exits' rests), and the
        whole still-live mass is then added."""
        jnp = self.jnp
        if self.cont:
            # per-iteration continuous writes that stay grid-exact are
            # allowed: fresh samples (marginalize+outer re-concentrates
            # on the SAME static grid; Dirac values were absorbed by
            # the unrolled value-set may-analysis), exact copy-assigns
            # (target aliases the source grid), and affine assigns onto
            # value-union grids — Dirac value sets AND quadrature grids
            # extended with their affine image nodes (the may-analysis
            # ran the body `unroll` times, matching the exit-split
            # count, so the union covers every reachable node), and
            # `v +~ Bernoulli(v)` compounds (the same analysis closes
            # the grid over the x -> x+1 images per iteration).
            self._check_while_cont_writes(stmt.body)
        w = self._event_weight(stmt.cond)
        body = self.compile_block(stmt.body)
        count = stmt.unroll if stmt.unroll is not None else self.unroll
        body_touches = body.touches_rest
        red_axes = tuple(
            a for a in range(self.nv) if a not in self._gv_active
        )

        def ap(g, rest, xs):
            wv = w(xs)
            done = jnp.zeros_like(g)
            live = g
            r = rest
            r_join = None
            for _ in range(count):
                if body_touches:
                    # exits join: rests max (at the enclosing given
                    # granularity) over iterations — only a rest-aware
                    # body (nested While/Normalize) can change r
                    rr = self._red(r, red_axes)
                    r_join = rr if r_join is None else (
                        jnp.maximum(r_join, rr)
                    )
                done = done + live * (1.0 - wv)
                live, r = body(live * wv, r, xs)
            if not body_touches:
                r_join = rest  # every exit carried the incoming rest
            # rest invariant: granularity == enclosing given axes (a
            # scalar-like keepdims tensor at top level, per-slice totals
            # inside a given-vars normalize — the reference's
            # slice-enumeration scalar).  Adding the FULL live tensor
            # would broadcast the incoming scalar across every grid
            # cell and multi-count it at the next sum.
            return done, r_join + self._red(live, red_axes)

        ap.rest_aware = True
        return ap

    def _normalize_op(self, stmt: ast.Normalize) -> Callable:
        """Nested inference, batched: the reference (and the GF
        interpreter, gf_transformer.transform_normalize = gf.rs:589-634)
        enumerates every value of the given variables, extracting and
        renormalizing one coefficient slice per value.  In mass space
        the block operators are linear and slice-preserving in the
        given axes, so ALL slices renormalize in one vectorized pass:
        scale = pre-mass / post-mass per joint given-value slice
        (zero-mass slices contribute zero, the engine's documented
        graceful handling of the reference's panic)."""
        jnp = self.jnp
        gv = set(stmt.given_vars)
        # the block must not resample/overwrite a given variable: that
        # would mix mass across the slices being conditioned on
        def check(stmts):
            for s in stmts:
                if isinstance(s, (ast.Sample, ast.Assign, ast.Decrement)):
                    if s.var in gv:
                        raise UnsupportedForScan(
                            "normalize block resamples a given variable"
                        )
                elif isinstance(s, ast.IfThenElse):
                    check(s.then)
                    check(s.els)
                elif isinstance(s, ast.Normalize):
                    check(s.stmts)
                elif isinstance(s, ast.While):
                    check(s.body)
        check(stmt.stmts)
        outer_gv = self._gv_active
        self._gv_active = frozenset(outer_gv | gv)
        inner = self.compile_block(stmt.stmts)
        self._gv_active = outer_gv
        # slice granularity: this normalize's given axes PLUS any
        # enclosing normalize's (the reference enumerates the outer
        # values first, so factors are per JOINT given-value slice)
        own_other = tuple(
            a for a in range(self.nv) if a not in gv and a not in outer_gv
        )
        outer_other = tuple(
            a for a in range(self.nv) if a not in outer_gv
        )
        own_axes = tuple(sorted(gv - set(outer_gv)))

        def ap(g, rest, xs):
            pre = (jnp.sum(g, axis=own_other, keepdims=True)
                   if own_other else g)
            h, rest_after = inner(g, rest, xs)
            post = (jnp.sum(h, axis=own_other, keepdims=True)
                    if own_other else h)
            no_rest = (isinstance(rest, float) and rest == 0.0
                       and not inner.touches_rest)
            if no_rest:
                safe = jnp.where(post > 0, post, 1.0)
                return h * jnp.where(post > 0, pre / safe, 0.0), rest
            # rest mass in play: the normalization factor is only known
            # as an interval — scale the retained mass by the factor's
            # lower bound and the rest by its upper bound (reference:
            # gf.rs normalize rule = gf_transformer.py:563-578).  With
            # given variables the reference enumerates the slices,
            # handing EACH the incoming scalar rest and maxing the
            # slice results (transform_normalize:588-601); the block
            # operators are slice-preserving in the given axes, so the
            # vectorized pass reads the per-slice inner additions
            # straight off the threaded rest tensor.
            rb = self._red(rest, outer_other)
            adds_sl = (self._red(rest_after, own_other)
                       - self._red(rest, own_other))
            rest_after_sl = rb + adds_sl
            den_min = post + rest_after_sl
            min_f = jnp.where(
                den_min > 0,
                pre / jnp.where(den_min > 0, den_min, 1.0),
                0.0,
            )
            max_f = jnp.where(
                post > 0,
                (pre + rb) / jnp.where(post > 0, post, 1.0),
                0.0,
            )
            rest_out = max_f * rest_after_sl
            if own_axes and getattr(rest_out, "ndim", 0) > 0:
                # join over this normalize's enumerated values: max
                rest_out = jnp.max(rest_out, axis=own_axes,
                                   keepdims=True)
            return h * min_f, rest_out

        ap.rest_aware = True
        return ap

    def _sample_op(self, stmt: ast.Sample) -> Callable:
        jnp = self.jnp
        v = stmt.var
        n = self.sizes[v]
        dist = stmt.distribution
        if not self._dist_has_var(dist):
            if stmt.add_previous_value and v in self.cont:
                raise UnsupportedForScan(
                    "additive sample on a continuous grid"
                )
            vec = self._dist_vec(dist, v, n)
            if stmt.add_previous_value:
                return lambda g, xs: self._conv_along(g, v, vec(xs))
            sh = self._bshape(v, n)
            def ap(g, xs):
                m = jnp.sum(g, axis=v, keepdims=True)
                return m * vec(xs).reshape(sh)
            return ap
        if v in self.cont:
            g = self.cont[v]
            if (stmt.add_previous_value
                    and isinstance(dist, ast.BernoulliVarProb)
                    and dist.var == v):
                # v +~ Bernoulli(v) on the extended value grid (the
                # value-set analysis closed the grid over the x -> x+1
                # images, one per possible application): node x keeps
                # mass with weight 1-x and moves it to node x+1 with
                # weight x.  This is the engine's FORMAL algebra
                # G + (t-1)*dG — for x > 1 the stay-weight 1-x is
                # negative and total mass is still preserved, matching
                # gf_transformer's BernoulliVarProb rule exactly (the
                # earlier zero-row convention silently LOST that mass
                # and tripped the doubling validation on any prior with
                # support above 1).  A node whose image is off the grid
                # can only be reached by more applications than the
                # closure depth — impossible for the single compound
                # statement the grid build enforces.
                xs_nodes = g.xs
                nn = len(xs_nodes)
                K = np.zeros((nn, nn))
                for i, x in enumerate(xs_nodes):
                    j = np.where(
                        np.abs(xs_nodes - (x + 1.0))
                        <= 1e-12 * (x + 1.0)
                    )[0]
                    K[i, i] = 1.0 - x
                    if len(j) == 1:
                        K[i, int(j[0])] = x
                arr = jnp.asarray(K)
                return lambda g_, xs: self._matrix_apply(g_, v, arr)
            raise UnsupportedForScan(
                "var-parameterized sample into a continuous grid"
            )
        w = dist.var
        if w == v:
            # self-referential: kernel on (old value -> new value).
            # For ``v +~ D(v)`` the destination kernel is the delta
            # kernel with row s shifted right by s — built on the host
            # inside the (possibly per-iteration) prep.
            kf = self._dist_kernel(
                dist, n, n, shift_rows=stmt.add_previous_value
            )[1]
            return lambda g, xs: self._matrix_apply(g, v, kf(xs))
        nw = self.sizes[w]
        _, kf = self._dist_kernel(dist, nw, n)
        sh = self._bshape2(w, nw, v, n)
        if not stmt.add_previous_value:
            # reshape of the (nw, n) kernel into the broadcast shape is
            # row-major: transpose first when axis w comes after axis v
            def ap(g, xs):
                K = kf(xs)
                m = jnp.sum(g, axis=v, keepdims=True)
                return m * (K if w < v else K.mT).reshape(sh)
            return ap
        if w in self.cont:
            raise UnsupportedForScan(
                "additive sample from a continuous parent"
            )
        # v +~ D(w): per-w-value truncated convolution along v.  The
        # supported kernels all factorize over w — D(n) = D(1)^(*n) in
        # pgf terms — so instead of an O(N^3) band tensor we apply the
        # binary decomposition D(n) = prod_j D(2^j)^{bit_j(n)}: one
        # masked Toeplitz matmul per bit of the w axis (O(log N) MXU
        # matmuls, O(N^2) memory).
        base = self._conv_power_bases(dist, nw, n)
        bits = max(1, (nw - 1).bit_length())
        masks = []
        for j in range(bits):
            m = ((np.arange(nw) >> j) & 1).astype(np.float64)
            masks.append(jnp.asarray(
                m.reshape(self._bshape(w, nw))
            ))

        def ap(g, xs):
            rows = base(xs)  # (bits, n): pmf of D(2^j)
            for j in range(bits):
                T = _toeplitz(rows[j], n, n)
                gK = self._matrix_apply(g, v, T.mT)
                g = masks[j] * gK + (1.0 - masks[j]) * g
            return g
        return ap

    def _conv_power_bases(self, dist, nw: int, n: int):
        """fn(xs) -> (bits, n) array of D(2^j) pmf rows for the binary
        decomposition of ``v +~ D(w)`` (host-precomputed f64)."""
        bits = max(1, (nw - 1).bit_length())
        if isinstance(dist, ast.BinomialVarTrials):
            return self._maybe_feed(
                lambda p: np.stack([
                    _binom_vec(1 << j, p, n) for j in range(bits)
                ]),
                [dist.p],
            )
        if isinstance(dist, ast.PoissonVarRate):
            return self._maybe_feed(
                lambda f: np.stack([
                    _pois_vec(f * (1 << j), n) for j in range(bits)
                ]),
                [dist.rate],
            )
        if isinstance(dist, ast.NegBinomialVarSuccesses):
            return self._maybe_feed(
                lambda p: np.stack([
                    _negbinom_vec(1 << j, p, n) for j in range(bits)
                ]),
                [dist.p],
            )
        raise UnsupportedForScan(
            f"increment from non-factorizing {dist}"
        )

    def _assign_op(self, stmt: ast.Assign) -> Callable:
        jnp = self.jnp
        v = stmt.var
        if v in self.cont or (
            stmt.addend is not None and stmt.addend[1] in self.cont
        ):
            # the one grid-exact continuous assignment between
            # QUADRATURE grids: a pure value copy between IDENTICAL
            # grids (index copy)
            w = stmt.addend[1] if stmt.addend is not None else None
            if (
                _is_copy_assign(stmt) and w != v
                and v in self.cont and w in self.cont
                and np.array_equal(self.cont[v].xs, self.cont[w].xs)
            ):
                n = self.sizes[v]
                I = np.eye(self.sizes[w], n)
                if w > v:
                    I = I.T
                arr = self.jnp.asarray(
                    I.reshape(self._bshape2(w, self.sizes[w], v, n))
                )

                def ap(g, xs):
                    m = jnp.sum(g, axis=v, keepdims=True)
                    return m * arr

                return ap
            gv = self.cont.get(v)
            gw = self.cont.get(w) if w is not None else None
            if ((gv is None or gv.values_union)
                    and (gw is None or gw.values_union)):
                # value-union grids on every participating axis (Dirac
                # value sets, or quadrature grids extended with their
                # affine image nodes): affine ops are index kernels
                return self._value_assign_op(stmt)
            raise UnsupportedForScan("assignment on a continuous grid")
        n = self.sizes[v]
        off = stmt.offset
        if isinstance(off, Slot):
            raise UnsupportedForScan("varying assignment offset")
        if stmt.addend is None:
            if stmt.add_previous_value:
                return lambda g, xs: self._shift_along(g, v, off)
            onehot = self.jnp.asarray(
                _dirac_vec(off, n).reshape(self._bshape(v, n))
            )
            def ap(g, xs):
                m = jnp.sum(g, axis=v, keepdims=True)
                return m * onehot
            return ap
        factor, w = stmt.addend
        if isinstance(factor, Slot):
            raise UnsupportedForScan("varying assignment factor")
        if w == v:
            # v := f*v + off  /  v += f*v + off
            mult = factor + (1 if stmt.add_previous_value else 0)
            M = np.zeros((n, n))
            for s in range(n):
                d = mult * s + off
                if d < n:
                    M[s, d] = 1.0
            K = self.jnp.asarray(M)
            return lambda g, xs: self._matrix_apply(g, v, K)
        nw = self.sizes[w]
        if stmt.add_previous_value:
            # v += f*w + off: f skew passes then static shift
            def ap(g, xs):
                for _ in range(factor):
                    g = self._skew_add(g, w, v)
                return self._shift_along(g, v, off)
            return ap
        # v := f*w + off: marginalize v, then indicator kernel
        I = np.zeros((nw, n))
        for s in range(nw):
            d = factor * s + off
            if d < n:
                I[s, d] = 1.0
        if w > v:
            I = I.T
        arr = self.jnp.asarray(I.reshape(self._bshape2(w, nw, v, n)))
        def ap(g, xs):
            m = jnp.sum(g, axis=v, keepdims=True)
            return m * arr
        return ap

    def _value_assign_op(self, stmt: ast.Assign) -> Callable:
        """Affine assignment where some participating axis is a Dirac
        VALUE grid: destinations are found by value lookup (the grids
        were built by _dirac_value_sets from the SAME float
        expressions, so lookups match exactly).  An integer target
        rounds and drops out-of-range mass like the integer path."""
        jnp = self.jnp
        v = stmt.var
        n = self.sizes[v]
        tvals = self._vals(v)
        t_is_value = v in self.cont
        off = stmt.offset
        if isinstance(off, Slot):
            raise UnsupportedForScan("varying assignment offset")
        off = float(off)

        def dcol(x):
            """Destination column for value x (None = dropped).  A
            destination MISSING from a value grid is exact to drop: the
            grid is the forward may-analysis union, so a source value
            whose image is absent was proven impossible at this site —
            its row carries zero mass (e.g. Y += 2X+1 enumerates grid
            node 2.5 as a source, but 2.5 only EXISTS after the +=)."""
            if t_is_value:
                j = np.where(
                    np.abs(tvals - x) <= 1e-12 * max(1.0, abs(x))
                )[0]
                if len(j) > 1:
                    raise UnsupportedForScan(
                        "ambiguous value match on the value grid"
                    )
                return int(j[0]) if len(j) == 1 else None
            d = int(round(x))
            if abs(x - d) > 1e-9 or d < 0:
                raise UnsupportedForScan(
                    "non-integer value assigned to an integer grid"
                )
            return d if d < n else None

        def outer_from(rows: np.ndarray, w: int, nw: int):
            I = rows if w < v else rows.T
            arr = jnp.asarray(I.reshape(self._bshape2(w, nw, v, n)))

            def ap(g, xs):
                m = jnp.sum(g, axis=v, keepdims=True)
                return m * arr

            return ap

        if stmt.addend is None:
            if not stmt.add_previous_value:
                row = np.zeros(n)
                j = dcol(off)
                if j is not None:
                    row[j] = 1.0
                arr = jnp.asarray(row.reshape(self._bshape(v, n)))

                def ap(g, xs):
                    m = jnp.sum(g, axis=v, keepdims=True)
                    return m * arr

                return ap
            M = np.zeros((n, n))
            for t in range(n):
                j = dcol(tvals[t] + off)
                if j is not None:
                    M[t, j] = 1.0
            K = jnp.asarray(M)
            return lambda g, xs: self._matrix_apply(g, v, K)
        f, w = stmt.addend
        if isinstance(f, Slot):
            raise UnsupportedForScan("varying assignment factor")
        if w == v:
            M = np.zeros((n, n))
            for t in range(n):
                a = f * tvals[t] + off
                j = dcol(tvals[t] + a if stmt.add_previous_value else a)
                if j is not None:
                    M[t, j] = 1.0
            K = jnp.asarray(M)
            return lambda g, xs: self._matrix_apply(g, v, K)
        nw = self.sizes[w]
        wvals = self._vals(w)
        if not stmt.add_previous_value:
            I = np.zeros((nw, n))
            for s in range(nw):
                j = dcol(f * wvals[s] + off)
                if j is not None:
                    I[s, j] = 1.0
            return outer_from(I, w, nw)
        # v += f*w + off across distinct axes: pair kernel T[s, t, d]
        if nw * n > 4096:
            raise UnsupportedForScan(
                "dirac pair-assignment grid too large"
            )
        T = np.zeros((nw, n, n))
        for s in range(nw):
            a = f * wvals[s] + off
            for t in range(n):
                j = dcol(tvals[t] + a)
                if j is not None:
                    T[s, t, j] = 1.0
        Tj = jnp.asarray(T)

        def ap(g, xs):
            h = jnp.moveaxis(g, (w, v), (0, 1))
            sh = h.shape
            h2 = h.reshape(nw, n, -1)
            out = jnp.einsum("stb,std->sdb", h2, Tj)
            return jnp.moveaxis(out.reshape(sh), (0, 1), (w, v))

        return ap


def _shift_kernel_rows(K: np.ndarray) -> np.ndarray:
    """K'[s, d] = K[s, d - s] (d >= s), zero otherwise; drops mass above
    the truncation boundary exactly like the Taylor engine."""
    n_src, n_dst = K.shape
    out = np.zeros_like(K)
    for s in range(n_src):
        hi = max(0, n_dst - s)
        out[s, s:] = K[s, :hi]
    return out


def _const_dist_pmf_fn(dist) -> Callable:
    """pmf evaluator (c, *float_params) -> float for a var-free
    distribution whose PosRatio parameters are passed positionally in
    :func:`_collect_ratio_params` order."""
    if isinstance(dist, ast.Bernoulli):
        return lambda c, p: p if c == 1 else (1.0 - p) if c == 0 else 0.0
    if isinstance(dist, ast.Poisson):
        return lambda c, lam: _pois_vec(lam, c + 1)[c]
    if isinstance(dist, ast.Geometric):
        return lambda c, p: p * (1.0 - p) ** c
    if isinstance(dist, ast.Binomial):
        if isinstance(dist.n, Slot):
            raise UnsupportedForScan("varying Binomial trial count")
        return lambda c, p: _binom_vec(dist.n, p, c + 1)[c]
    if isinstance(dist, ast.NegBinomial):
        if isinstance(dist.n, Slot):
            raise UnsupportedForScan("varying NegBinomial successes")
        return lambda c, p: _negbinom_vec(dist.n, p, c + 1)[c]
    if isinstance(dist, ast.UniformDisc):
        lo, hi = dist.start, dist.end
        if isinstance(lo, Slot) or isinstance(hi, Slot):
            raise UnsupportedForScan("varying Uniform bounds")
        return lambda c: 1.0 / (hi - lo) if lo <= c < hi else 0.0
    if isinstance(dist, ast.Dirac):
        return lambda c, a: 1.0 if c == int(round(a)) else 0.0
    if isinstance(dist, ast.Categorical):
        k = len(dist.rs)
        return lambda c, *ps: ps[c] if 0 <= c < k else 0.0
    raise UnsupportedForScan(f"observation from {dist}")


def _collect_ratio_params(dist) -> list:
    """Ordered PosRatio/Slot parameters of a var-free distribution, in
    _sig_lits order."""
    out = []
    def walk(obj):
        if isinstance(obj, (ast.PosRatio, Slot)):
            out.append(obj)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        elif isinstance(obj, tuple):
            for x in obj:
                walk(x)
    walk(dist)
    return out


# ----------------------------------------------------------------------
# whole-program compilation
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# telescoping if-cascade compilation (switchpoint family)
# ----------------------------------------------------------------------
#
# The generated switchpoint programs (reference src/bin/
# generate_switchpoint.rs; benchmarks/neurips2023/approx/switchpoint,
# test/expect/real_world/switchpoint, cont_switchpoint) are a nested
# if-cascade
#
#     v ~ Prior;
#     if 1 ~ Bernoulli(p_0)      { pivot; U_1 .. U_n;  sp := k_0 }
#     else if 1 ~ Bernoulli(p_1) { U_1; pivot; U_2 .. U_n; sp := k_1 }
#     ...
#
# where branch s runs the first s observation units at the outer prior
# draw, freshly resamples the observed variable (the pivot), runs the
# remaining units, and records the switch position.  The generic GF
# interpreter pays O(n^2 * order) for this; because every unit is a
# DIAGONAL reweighting of the prior grid and the pivot makes the suffix
# independent of the prefix, the whole cascade factorizes into one
# forward and one backward cumulative scan over the unit likelihood
# rows:
#
#     weight(s) = q_s * [ sum_x w0(x) prod_{i<=s} row_i(x) ]
#                     * [ sum_x h0(x) prod_{i>s}  row_i(x) ]
#
# (w0 = outer prior mass row, h0 = pivot prior row, q_s = the Bernoulli
# chain's branch probability) — O(n * grid) on device, with the rows
# host-precomputed in real f64 (TPU numeric policy: no device
# transcendentals) and power-of-two rescaling in the scan carries.
#
# Continuous priors (Exponential/Gamma/UniformCont) use a composite
# Gauss-Legendre quadrature grid on geometric panels, so the same mass
# semantics covers the continuous-latent switchpoint models; validation
# doubles both the node count and (for half-infinite domains) the
# domain bound.


@dataclass
class CascadeForm:
    prologue: tuple      # Sample statements before the cascade
    qs: list             # exact branch probabilities (Fractions)
    units: list          # unit observe statements U_1..U_n (instances)
    pivot: tuple         # pivot Sample statements (same in every branch)
    assign_var: int
    assign_vals: list    # branch value of assign_var
    prefix_lens: list    # per-branch prefix unit count P_k
    n_units: int


def _branch_weight(cond) -> Optional[Fraction]:
    """P(observe-cond) for the cascade's `1 ~ Bernoulli(p)` guards."""
    if not isinstance(cond, ast.DataFromDist):
        return None
    if not isinstance(cond.dist, ast.Bernoulli):
        return None
    if isinstance(cond.data, Slot) or isinstance(
        cond.dist.p, ast.ParamRatio
    ):
        return None
    p = Fraction(cond.dist.p.numer, cond.dist.p.denom)
    d = int(cond.data)
    if d == 1:
        return p
    if d == 0:
        return 1 - p
    return None


def detect_cascade(stmts) -> Optional[CascadeForm]:
    """Recognize the telescoping if-cascade form.  Returns None when the
    program is not in the family (callers fall back)."""
    # locate the cascade root: the single non-observe IfThenElse
    root_idx = None
    for i, st in enumerate(stmts):
        if isinstance(st, ast.IfThenElse) and st.recognize_observe() is None:
            root_idx = i
            break
    if root_idx is None or root_idx != len(stmts) - 1:
        return None
    prologue = tuple(stmts[:root_idx])
    if not all(isinstance(s, ast.Sample) and not s.add_previous_value
               for s in prologue):
        return None
    # unfold else-if chain
    branches = []  # (weight Fraction, body tuple)
    cur = stmts[root_idx]
    while True:
        w = _branch_weight(cur.cond)
        if w is None:
            return None
        branches.append((w, tuple(cur.then)))
        els = cur.els
        if len(els) == 1 and isinstance(els[0], ast.IfThenElse) and \
                els[0].recognize_observe() is None:
            cur = els[0]
            continue
        if len(els) != 0:
            return None
        break
    n_br = len(branches)
    if n_br < 3:
        return None
    # exact branch probabilities; the empty final else must be dead
    qs, rest = [], Fraction(1)
    for w, _ in branches:
        qs.append(rest * w)
        rest *= 1 - w
    if rest != 0:
        return None
    # each body: a trailing `sp := k` (same var across branches), before
    # it P_k prefix observes, a shared pivot block, suffix observes
    def is_unit(st):
        return (isinstance(st, ast.IfThenElse)
                and st.recognize_observe() is not None)

    def key(st):
        ls: list = []
        return (_sig_lits(st, ls), tuple(ls))

    assign_var = None
    assign_vals, prefix_lens = [], []
    pivot = pk = None
    units: list = []
    n_units = p_len = None
    for _, body in branches:
        if not body or not isinstance(body[-1], ast.Assign):
            return None
        a = body[-1]
        if a.add_previous_value or a.addend is not None:
            return None
        if assign_var is None:
            assign_var = a.var
        elif a.var != assign_var:
            return None
        assign_vals.append(int(a.offset))
        body = body[:-1]
        # split: prefix observes | pivot (non-observes) | suffix observes
        P = 0
        while P < len(body) and is_unit(body[P]):
            P += 1
        q = P
        while q < len(body) and not is_unit(body[q]):
            q += 1
        if q == P:  # no pivot block
            return None
        if not all(is_unit(st) for st in body[q:]):
            return None
        piv = body[P:q]
        if pivot is None:
            pivot, pk, p_len = piv, [key(st) for st in piv], q - P
            n_units = len(body) - p_len
            units = [None] * n_units
        elif (q - P != p_len or [key(st) for st in piv] != pk
              or len(body) - p_len != n_units):
            return None
        prefix_lens.append(P)
        inst = list(body[:P]) + list(body[q:])
        for i, st in enumerate(inst):
            if units[i] is None:
                units[i] = st
            elif key(units[i]) != key(st):
                return None
    if n_units is None or n_units < 2 or any(u is None for u in units):
        return None
    if len(set(assign_vals)) != n_br:
        return None
    for st in pivot:
        if not (isinstance(st, ast.Sample) and not st.add_previous_value
                and st.distribution.used_vars() == 0):
            return None
    return CascadeForm(
        prologue=prologue, qs=qs, units=list(units), pivot=tuple(pivot),
        assign_var=assign_var, assign_vals=assign_vals,
        prefix_lens=prefix_lens, n_units=n_units,
    )


def _ratio_f(r) -> float:
    if isinstance(r, ast.ParamRatio):
        raise UnsupportedForScan("$param in cascade")
    if isinstance(r, int):
        return float(r)
    if r.denom == 0:
        raise UnsupportedForScan("zero-denominator ratio")
    return float(Fraction(r.numer, r.denom))


_CONT_DISTS = (ast.Exponential, ast.Gamma, ast.UniformCont)


def _quad_grid(lo: float, hi: float, order: int):
    """Composite Gauss-Legendre nodes/weights: geometric panels from
    hi/1e4 up when lo == 0 (resolves posterior bumps anywhere in the
    domain at relative node spacing ~panel count/order), linear panels
    otherwise."""
    from numpy.polynomial.legendre import leggauss

    # panel count saturates at 32 so the per-panel node count grows
    # with the order: composite GL converges exponentially in nodes-
    # per-panel for analytic integrands, which is what makes the
    # order-doubling validation terminate early
    npan = max(8, min(32, order // 16))
    per = max(4, order // npan)
    gx, gw = leggauss(per)
    if lo == 0.0 and hi > 0:
        r = 1e-4 ** (1.0 / (npan - 1))
        edges = [0.0] + [hi * r ** (npan - 1 - k) for k in range(npan)]
    else:
        edges = list(np.linspace(lo, hi, npan + 1))
    xs, ws = [], []
    for a, b in zip(edges[:-1], edges[1:]):
        c, h = 0.5 * (a + b), 0.5 * (b - a)
        xs.append(c + h * gx)
        ws.append(h * gw)
    return np.concatenate(xs), np.concatenate(ws)


def _cascade_units_poisson(units) -> list:
    """Extract (c_i, f_i, var) from `observe c ~ Poisson(f*v)` units
    (the quadrature-compatible fragment; continuous priors)."""
    out = []
    for st in units:
        ev = st.recognize_observe()
        if not isinstance(ev, ast.DataFromDist):
            raise UnsupportedForScan(f"cascade unit {st}")
        d = ev.dist
        if isinstance(d, ast.PoissonVarRate):
            out.append((int(ev.data), _ratio_f(d.rate), d.var))
        else:
            raise UnsupportedForScan(f"cascade unit observes {d}")
    return out


def _cascade_event_row(ev, n: int):
    """(var, row) for a diagonal observation event on the integer grid
    0..n-1 (DataFromDist of a var-dependent distribution, InSet,
    Complement and Intersections thereof)."""
    if isinstance(ev, ast.DataFromDist):
        d = ev.dist
        c = int(ev.data)
        if isinstance(d, ast.PoissonVarRate):
            return d.var, _obs_pois_rate_row(c, _ratio_f(d.rate), n)
        if isinstance(d, ast.BinomialVarTrials):
            return d.var, _obs_binom_trials_row(c, _ratio_f(d.p), n)
        if isinstance(d, ast.NegBinomialVarSuccesses):
            return d.var, _obs_negbinom_var_row(c, _ratio_f(d.p), n)
        raise UnsupportedForScan(f"cascade unit observes {d}")
    if isinstance(ev, ast.InSet):
        row = np.zeros(n)
        for x in ev.set:
            if isinstance(x, Slot):
                raise UnsupportedForScan("varying InSet member")
            if 0 <= int(x) < n:
                row[int(x)] = 1.0
        return ev.var, row
    if isinstance(ev, ast.Complement):
        v, row = _cascade_event_row(ev.event, n)
        return v, 1.0 - row
    if isinstance(ev, ast.Intersection):
        var, row = None, np.ones(n)
        for e in ev.events:
            v, r = _cascade_event_row(e, n)
            if var is None:
                var = v
            elif v != var:
                raise UnsupportedForScan("cascade event mixes vars")
            row = row * r
        if var is None:
            raise UnsupportedForScan("empty cascade intersection")
        return var, row
    raise UnsupportedForScan(f"cascade unit event {ev}")


def _cascade_pair_vars(ev):
    """(v1, v2) when the event is a two-variable comparison (possibly
    complemented), else None."""
    if isinstance(ev, ast.Complement):
        return _cascade_pair_vars(ev.event)
    if isinstance(ev, ast.VarComparison) and ev.v1 != ev.v2:
        return ev.v1, ev.v2
    return None


def _cascade_pair_row(ev, vlo: int, nlo: int, nhi: int) -> np.ndarray:
    """(nlo, nhi) indicator of a two-variable comparison event on the
    integer grids of (vlo, vhi) with vlo < vhi."""
    if isinstance(ev, ast.Complement):
        return 1.0 - _cascade_pair_row(ev.event, vlo, nlo, nhi)
    if not isinstance(ev, ast.VarComparison):
        raise UnsupportedForScan(f"cascade pair event {ev}")
    n1, n2 = (nlo, nhi) if ev.v1 == vlo else (nhi, nlo)
    a = np.arange(n1)[:, None]
    b = np.arange(n2)[None, :]
    if ev.comp == ast.Comparison.EQ:
        ind = (a == b).astype(np.float64)
    elif ev.comp == ast.Comparison.LT:
        ind = (a < b).astype(np.float64)
    elif ev.comp == ast.Comparison.LE:
        ind = (a <= b).astype(np.float64)
    else:
        raise UnsupportedForScan(f"comparison {ev.comp}")
    return ind if ev.v1 == vlo else ind.T


def _log_pois_rows(cs, fs, xs) -> np.ndarray:
    """rows[i, j] = Poisson(c_i; f_i * xs_j), stable host f64."""
    import math

    cmax = int(max(cs)) if len(cs) else 0
    logfact = np.zeros(cmax + 1)
    for k in range(2, cmax + 1):
        logfact[k] = logfact[k - 1] + math.log(k)
    rows = np.empty((len(cs), len(xs)))
    with np.errstate(divide="ignore", invalid="ignore"):
        for i, (c, f) in enumerate(zip(cs, fs)):
            lam = f * xs
            if c == 0:
                rows[i] = np.exp(-lam)
            else:
                lg = np.where(lam > 0, np.log(np.where(lam > 0, lam, 1.0)),
                              -np.inf)
                rows[i] = np.exp(c * lg - lam - logfact[c])
    return np.nan_to_num(rows, nan=0.0, posinf=0.0, neginf=0.0)


def _prior_grid(dist, order: int, units_cf):
    """(xs, w0) for a prior distribution: integer grid + pmf for
    discrete supports, composite quadrature + pdf*weight for continuous.
    ``units_cf`` = [(c, f)] of the Poisson units, used to bound the
    half-infinite quadrature domain (beyond min_i (c_i + 60*sqrt(c_i+1)
    + 160)/f_i every branch posterior is negligible: each unit row is a
    factor <= 1 of every branch product that includes it, and both
    prefix and suffix products include a unit beyond any split)."""
    import math

    if isinstance(dist, _CONT_DISTS):
        if isinstance(dist, ast.UniformCont):
            lo, hi = _ratio_f(dist.start), _ratio_f(dist.end)
            xs, gw = _quad_grid(lo, hi, order)
            w0 = gw / max(hi - lo, 1e-300)
            return xs, w0
        if isinstance(dist, ast.Exponential):
            lam = _ratio_f(dist.rate)
            a, b = 1.0, lam
        else:  # Gamma
            a, b = _ratio_f(dist.shape), _ratio_f(dist.rate)
        hi_prior = (a + 40.0 * math.sqrt(a + 1) + 120.0) / b
        hi_lik = min(
            ((c + 60.0 * math.sqrt(c + 1) + 160.0) / f)
            for c, f in units_cf
        ) if units_cf else hi_prior
        hi = min(hi_prior, hi_lik)
        xs, gw = _quad_grid(0.0, hi, order)
        with np.errstate(divide="ignore"):
            logpdf = np.where(
                xs > 0,
                a * math.log(b) + (a - 1.0) * np.log(np.where(xs > 0, xs, 1.0))
                - b * xs - math.lgamma(a),
                (0.0 if a == 1.0 else -np.inf),
            )
            pdf = np.exp(np.where(xs > 0, logpdf, np.log(b) if a == 1.0
                                  else -np.inf))
        return xs, np.nan_to_num(pdf, nan=0.0, posinf=0.0) * gw
    # discrete: integer grid
    xs = np.arange(order, dtype=np.float64)
    if isinstance(dist, ast.Geometric):
        w0 = _geom_vec(_ratio_f(dist.p), order)
    elif isinstance(dist, ast.Poisson):
        w0 = _pois_vec(_ratio_f(dist.rate), order)
    elif isinstance(dist, ast.UniformDisc):
        w0 = _uniform_vec(dist.start, dist.end, order)
    elif isinstance(dist, ast.Bernoulli):
        w0 = _bern_vec(_ratio_f(dist.p), order)
    elif isinstance(dist, ast.Binomial):
        w0 = _binom_vec(dist.n, _ratio_f(dist.p), order)
    elif isinstance(dist, ast.NegBinomial):
        w0 = _negbinom_vec(dist.n, _ratio_f(dist.p), order)
    else:
        raise UnsupportedForScan(f"cascade prior {dist}")
    return xs, w0


class CascadeCompiled:
    """Compiled telescoping cascade at one grid order (API-compatible
    subset of :class:`ScanCompiled`: ``run`` and ``rep.n_iters``).

    The per-order state is one grid row (~order f64 values) and the
    scans are ~n_units elementwise passes over it — host-sized work.
    It runs in numpy on the host on purpose, as genfer_tpu's does: a
    kernel launch per pass would cost more than the pass, and the device
    path is kept for the grid-tensor models (ScanCompiled) where device
    compute pays."""

    def __init__(self, program: ast.Program, form: CascadeForm,
                 order: int):
        self.program = program
        self.form = form
        self.order = order
        self.rep = dataclasses.make_dataclass(
            "_R", ["n_iters"]
        )(n_iters=form.n_units)
        # continuous priors need the Poisson-rate fragment (analytic
        # quadrature rows); integer grids take the general unit set
        probe = [st for st in form.prologue if isinstance(st, ast.Sample)]
        continuous = any(
            isinstance(st.distribution, _CONT_DISTS) for st in probe
        )
        if program.result != form.assign_var:
            raise UnsupportedForScan("cascade result is not the switch var")
        pivot_by_var = {}
        for st in form.pivot:
            if st.var in pivot_by_var:
                raise UnsupportedForScan("pivot resamples a var twice")
            pivot_by_var[st.var] = st
        # units may touch several prologue variables; each unit is
        # diagonal in one var, and with independent priors the branch
        # weight factorizes per var:
        #   weight(s) = q_s * prod_{v pivot-resampled} fwd_v(s)*bwd_v(s)
        #                   * prod_{v not resampled}   (full product)
        # (a var the pivot never refreshes contributes the same factor
        # whether its units sit in the prefix or the suffix).  Groups
        # hold per-var grids, prior/pivot mass rows and unit indices.
        self._continuous = continuous
        self._groups = []  # dicts: idxs, w0, h0 (None = static), rows
        self._qs = np.asarray([float(q) for q in form.qs])
        if continuous:
            units = _cascade_units_poisson(form.units)
            uvars = {v for (_, _, v) in units}
            if len(uvars) != 1:
                raise UnsupportedForScan(
                    "continuous cascade units touch several vars"
                )
            v = uvars.pop()
            pivot_d = pivot_by_var.get(v)
            if pivot_d is None:
                raise UnsupportedForScan(
                    "pivot does not resample the unit var"
                )
            prior_out = [st for st in form.prologue if st.var == v]
            if not prior_out:
                raise UnsupportedForScan("no outer prior for the unit var")
            units_cf = [(c, f) for (c, f, _) in units]
            xs0, w0 = _prior_grid(prior_out[-1].distribution, order,
                                  units_cf)
            xs1, h0 = _prior_grid(pivot_d.distribution, order, units_cf)
            if len(xs0) != len(xs1) or not np.array_equal(xs0, xs1):
                raise UnsupportedForScan("prior/pivot grids differ")
            cs = [c for (c, _, _) in units]
            fs = [f for (_, f, _) in units]
            self._unit_fs = fs
            self._xs_grid = xs0
            self._groups.append({
                "idxs": list(range(form.n_units)),
                "w0": np.asarray(w0),
                "h0": np.asarray(h0),
                "rows": np.asarray(_log_pois_rows(cs, fs, xs0)),
            })
            return
        self._unit_fs = None
        self._xs_grid = None
        evs = [st.recognize_observe() for st in form.units]
        # classify units: single-var diagonal or two-var comparison.
        # Comparison units couple their two variables into one group
        # (a var may be compared against at most one partner).
        pair_of = {}
        unit_tag = []  # ("single", v) | ("pair", (vlo, vhi))
        for ev in evs:
            pv = _cascade_pair_vars(ev)
            if pv is not None:
                vlo, vhi = min(pv), max(pv)
                for x, y in ((vlo, vhi), (vhi, vlo)):
                    if pair_of.setdefault(x, y) != y:
                        raise UnsupportedForScan(
                            "a variable is compared against two others"
                        )
                unit_tag.append(("pair", (vlo, vhi)))
            else:
                v, _ = _cascade_event_row(ev, 2)
                unit_tag.append(("single", v))

        def comp_key(tag):
            kind, p = tag
            if kind == "single":
                if p in pair_of:
                    return (min(p, pair_of[p]), max(p, pair_of[p]))
                return (p,)
            return p

        comps = list(dict.fromkeys(comp_key(t) for t in unit_tag))

        def prior_for(v):
            prior_out = [st for st in form.prologue if st.var == v]
            if not prior_out:
                raise UnsupportedForScan("no outer prior for a unit var")
            if prior_out[-1].distribution.used_vars() != 0:
                raise UnsupportedForScan(
                    "unit-var prior depends on another var"
                )
            xs0, w0 = _prior_grid(prior_out[-1].distribution, order, [])
            return len(xs0), np.asarray(w0)

        def pivot_grid(v, n_expected):
            piv = pivot_by_var.get(v)
            if piv is None:
                return None
            xs1, h0 = _prior_grid(piv.distribution, order, [])
            if len(xs1) != n_expected:
                raise UnsupportedForScan("prior/pivot grids differ")
            return np.asarray(h0)

        def single_rebuild(ev, n, wrap):
            """fn(count) -> row in the group's storage format: serving
            replaces the observation value of DataFromDist units; event
            units (set membership, comparisons) keep their row."""
            if isinstance(ev, ast.DataFromDist):
                return lambda c: wrap(_cascade_event_row(
                    ast.DataFromDist(int(c), ev.dist), n)[1])
            fixed = wrap(_cascade_event_row(ev, n)[1])
            return lambda c: fixed

        for comp in comps:
            idxs = [i for i, t in enumerate(unit_tag)
                    if comp_key(t) == comp]
            if len(comp) == 1:
                v = comp[0]
                n, w0 = prior_for(v)
                h0 = pivot_grid(v, n)
                reb = [single_rebuild(evs[i], n, lambda r: r)
                       for i in idxs]
                rows = np.stack(
                    [_cascade_event_row(evs[i], n)[1] for i in idxs]
                )
                self._groups.append({
                    "idxs": idxs, "w0": w0, "h0": h0, "rows": rows,
                    "rebuild": reb,
                })
                continue
            vlo, vhi = comp
            nlo, wl = prior_for(vlo)
            nhi, wh = prior_for(vhi)
            hlo = pivot_grid(vlo, nlo)
            hhi = pivot_grid(vhi, nhi)
            both = hlo is not None and hhi is not None
            neither = hlo is None and hhi is None
            # matrix layout: (vlo grid, vhi grid), re-oriented to
            # (refreshed, spectator) in the one-refreshed case
            flip = not (both or neither) and hlo is None

            def as_mat(i, flip=flip):
                kind, p = unit_tag[i]
                if kind == "pair":
                    m = _cascade_pair_row(evs[i], vlo, nlo, nhi)
                    return m.T if flip else m

                def wrap(row, v=p, flip=flip):
                    m = (np.broadcast_to(row[:, None], (nlo, nhi))
                         if v == vlo else
                         np.broadcast_to(row[None, :], (nlo, nhi)))
                    return (m.T if flip else m).copy()

                return wrap(_cascade_event_row(
                    evs[i], nlo if p == vlo else nhi)[1])

            def mat_rebuild(i, flip=flip):
                kind, p = unit_tag[i]
                if kind == "pair" or not isinstance(
                        evs[i], ast.DataFromDist):
                    fixed = as_mat(i)
                    return lambda c: fixed
                n = nlo if p == vlo else nhi
                axis_lo = p == vlo

                def build(c, n=n, axis_lo=axis_lo, ev=evs[i], flip=flip):
                    row = _cascade_event_row(
                        ast.DataFromDist(int(c), ev.dist), n)[1]
                    m = (np.broadcast_to(row[:, None], (nlo, nhi))
                         if axis_lo else
                         np.broadcast_to(row[None, :], (nlo, nhi)))
                    return (m.T if flip else m).copy()

                return build

            mats = [as_mat(i) for i in idxs]
            reb = [mat_rebuild(i) for i in idxs]
            if both or neither:
                # both refreshed: the pair is one pseudo-variable on the
                # ravelled joint grid (standard telescoping); neither:
                # one static joint factor
                self._groups.append({
                    "idxs": idxs,
                    "w0": np.outer(wl, wh).ravel(),
                    "h0": (np.outer(hlo, hhi).ravel() if both else None),
                    "rows": np.stack([m.ravel() for m in mats]),
                    "rebuild": [
                        (lambda c, f=f: f(c).ravel()) for f in reb
                    ],
                })
            else:
                # exactly one refreshed: coupled-spectator vector scans —
                # the spectator axis survives the per-step sums and is
                # contracted against its prior at branch-weight time
                w0, h0, wspec = (
                    (wl, hlo, wh) if hlo is not None else (wh, hhi, wl)
                )
                self._groups.append({
                    "idxs": idxs, "w0": w0, "h0": h0, "wspec": wspec,
                    "rows": np.stack(mats), "rebuild": reb,
                })

    @staticmethod
    def _cumscan(w0: np.ndarray, rows: np.ndarray):
        """Forward masses with power-of-two rescaling: after step i the
        carry holds w0 times the product of rows[:i+1]; returns the
        per-step (mantissa sum, exponent) arrays."""
        n = rows.shape[0]
        sums = np.empty(n)
        es = np.empty(n)
        w = w0.copy()
        e = 0.0
        for i in range(n):
            w *= rows[i]
            m = w.max()
            if m > 0:
                ee = float(np.floor(np.log2(m)))
                w *= 2.0 ** -ee
                e += ee
            sums[i] = w.sum()
            es[i] = e
        return sums, es

    @staticmethod
    def _cumscan_vec(W0: np.ndarray, rows: np.ndarray):
        """Like :meth:`_cumscan` but the carry is a (refreshed-var,
        spectator-var) matrix and only the refreshed axis is summed —
        the per-step results are spectator-indexed vectors."""
        n = rows.shape[0]
        sums = np.empty((n, W0.shape[1]))
        es = np.empty(n)
        W = W0.copy()
        e = 0.0
        for i in range(n):
            W *= rows[i]
            m = W.max()
            if m > 0:
                ee = float(np.floor(np.log2(m)))
                W *= 2.0 ** -ee
                e += ee
            sums[i] = W.sum(axis=0)
            es[i] = e
        return sums, es

    def run_with_counts(self, counts):
        """Serve a fresh dataset through the compiled cascade: ``counts``
        replaces the per-unit observation values (same unit kinds/
        factors); likelihood rows are rebuilt on the host (the only
        data-dependent part) and the same factorized scans run."""
        form = self.form
        counts = [int(c) for c in counts]
        if len(counts) != form.n_units:
            raise ValueError(
                f"expected {form.n_units} counts, got {len(counts)}"
            )
        saved = [g["rows"] for g in self._groups]
        try:
            if self._continuous:
                g = self._groups[0]
                g["rows"] = np.asarray(
                    _log_pois_rows(counts, self._unit_fs, self._xs_grid)
                )
            else:
                # DataFromDist units take the fresh observation value;
                # event units (set membership, comparisons) have no
                # observation value and keep their row
                for g in self._groups:
                    g["rows"] = np.stack([
                        fn(counts[i])
                        for fn, i in zip(g["rebuild"], g["idxs"])
                    ])
            return self.run()
        finally:
            for g, r in zip(self._groups, saved):
                g["rows"] = r

    def run(self):
        form = self.form
        n_br = len(form.prefix_lens)
        # branch k: P_k prefix units at the outer draw, suffix units
        # P_k+1..n at the pivot draw; per var-group the split index is
        # the number of that group's units among the first P_k
        mant = self._qs.copy()
        ee = np.zeros(n_br)
        for g in self._groups:
            rows = g["rows"]
            if rows.ndim == 3:
                # coupled pair, one var refreshed: vector scans over the
                # (refreshed, spectator) matrices, spectator contracted
                # against its prior per branch
                nspec = rows.shape[2]
                W0 = np.broadcast_to(
                    g["w0"][:, None], rows.shape[1:]
                ).copy()
                fsums, fes = self._cumscan_vec(W0, rows)
                a = np.concatenate(
                    [[np.full(nspec, g["w0"].sum())], fsums]
                )
                ae = np.concatenate([[0.0], fes])
                H0 = np.broadcast_to(
                    g["h0"][:, None], rows.shape[1:]
                ).copy()
                bsums, bes = self._cumscan_vec(H0, rows[::-1])
                b = np.concatenate(
                    [[np.full(nspec, g["h0"].sum())], bsums]
                )[::-1]
                be = np.concatenate([[0.0], bes])[::-1]
                idxs = g["idxs"]
                cnt = np.asarray(
                    [sum(1 for i in idxs if i < P)
                     for P in form.prefix_lens],
                    dtype=np.int64,
                )
                mant = mant * np.asarray([
                    float((g["wspec"] * a[c] * b[c]).sum()) for c in cnt
                ])
                ee += ae[cnt] + be[cnt]
                continue
            if g["h0"] is None:
                # never resampled: the same full product in every branch
                if len(rows):
                    sums, es = self._cumscan(g["w0"], rows)
                    mant = mant * sums[-1]
                    ee += es[-1]
                else:
                    mant = mant * g["w0"].sum()
                continue
            fsums, fes = self._cumscan(g["w0"], rows)
            a = np.concatenate([[g["w0"].sum()], fsums])
            ae = np.concatenate([[0.0], fes])
            bsums, bes = self._cumscan(g["h0"], rows[::-1])
            b = np.concatenate([[g["h0"].sum()], bsums])[::-1]
            be = np.concatenate([[0.0], bes])[::-1]
            idxs = g["idxs"]
            cnt = np.asarray(
                [sum(1 for i in idxs if i < P) for P in form.prefix_lens],
                dtype=np.int64,
            )
            mant = mant * a[cnt]
            mant = mant * b[cnt]
            ee += ae[cnt] + be[cnt]
        live = mant != 0
        mmax = float(ee[live].max()) if live.any() else 0.0
        wts = mant * np.exp2(ee - mmax) * 2.0 ** mmax
        size = max(form.assign_vals) + 1
        masses = np.zeros(size)
        for k, val in enumerate(form.assign_vals):
            masses[val] += wts[k]
        return masses, float(masses.sum())


class ScanCompiled:
    """A compiled scan program at one grid order.

    ``run()`` returns ``(masses, Z)``: the full unnormalized posterior
    marginal of the result variable (length = its axis size) and the
    total retained mass, both host-f64.

    Serving mode: the compiled loop is independent of the observation
    DATA (the detected per-iteration constants) — ``run_with_data``
    re-runs it on a new dataset (shorter datasets are padded with
    valid-masked no-op steps up to ``max_steps``), ``run_batch`` serves a
    whole batch of datasets and ``run_param_sweep`` a batch of ``$param``
    bindings, each through ``torch.func.vmap`` of the loop, captured as
    one CUDA graph per batch shape on the card (``compile.GraphedEntry``,
    the counterpart of genfer_tpu's ``jit(vmap(run))``).  ``run`` and
    ``run_with_data`` walk the loop eagerly: a capture costs one warm-up
    walk and one captured walk, which a single run never earns back.
    This is the hand-built model families' "parameterized observation
    counts" serving mode (``models/population.py``), available for ANY
    detected program.

    ``device``: the torch device of the state and every constant
    (``None``: the CUDA card, which must exist; genfer_tpu's default is
    the CPU, see the module docstring)."""

    def __init__(self, program: ast.Program, rep: Repetition, order: int,
                 max_steps: Optional[int] = None,
                 params: Optional[dict] = None, unroll: int = 8,
                 device=None):
        self.device = _resolve_device(device)
        self.program = program
        self.order = order
        self.rep = rep
        self.params = dict(params) if params else {}
        self.max_steps = int(max_steps or max(rep.n_iters, 1))
        #: rest mass (mass still live in While loops after their
        #: unrollings) of the most recent run; printed results become
        #: intervals [x, x + rest] when nonzero
        self.last_rest = 0.0
        sizes, cont = grid_sizes(program, order, unroll=unroll)
        self.sizes = sizes
        self.cont = cont
        rv0 = program.result
        self.result_vals = cont[rv0].xs if rv0 in cont else None

        mc = _MassCompiler(sizes, cont, unroll=unroll, device=self.device)
        pre_ap = mc.compile_block(rep.prologue)
        if mc.feeds:
            raise UnsupportedForScan("slots escaped into the prologue")
        tpl_ap = mc.compile_block(rep.template)
        self._feeds = list(mc.feeds)
        n_tpl = len(mc.feeds)
        post_ap = mc.compile_block(rep.epilogue)
        if len(mc.feeds) != n_tpl:
            raise UnsupportedForScan("slots escaped into the epilogue")
        self._const_feeds = list(mc.const_feeds)
        self._xs = self.prepare_xs(rep.data, rep.n_iters)
        self._consts0 = self._consts(self.params)
        rv = program.result
        jnp = mc.jnp
        # the threaded rest starts as the literal 0.0: made a tensor by
        # a scalar add to this constant, never by a host copy
        zero = jnp.zeros(())

        has_scan = rep.n_iters > 0 and len(rep.template) > 0

        def rest_total(r):
            # the threaded rest may be the literal 0.0, a reduced
            # keepdims tensor, or a full live-mass tensor
            if not torch.is_tensor(r):
                return zero + r
            return r.sum() if r.ndim > 0 else r

        def rescale(g):
            # the power-of-two exponent of g's max (0 for an all-zero g)
            m = g.amax()
            return torch.where(m > 0, torch.floor(torch.log2(m)), 0.0)

        def run(g0, xs, consts):
            g, rest = pre_ap(g0, 0.0, ((), consts))
            rest = rest_total(rest)
            e0 = rescale(g)
            g = g / torch.exp2(e0)
            rest = rest / torch.exp2(e0)
            logz = e0
            if has_scan:
                feeds, valids = xs[:-1], xs[-1]
                for t in range(valids.shape[0]):
                    # rest rides the carry and its per-step rescaling,
                    # so its unit scale stays aligned with logz (the
                    # threaded rest inside the template sees it in carry
                    # units — exactly the reference's sequential rest
                    # flow)
                    gn, rest_n = tpl_ap(
                        g, rest, (tuple(f[t] for f in feeds), consts)
                    )
                    rest_n = rest_total(rest_n)
                    e = rescale(gn)
                    gn = gn / torch.exp2(e)
                    rest_n = rest_n / torch.exp2(e)
                    valid = valids[t] > 0
                    g = torch.where(valid, gn, g)
                    logz = logz + torch.where(valid, e, 0.0)
                    rest = torch.where(valid, rest_n, rest)
            g, rest = post_ap(g, rest, ((), consts))
            rest = rest_total(rest)
            axes = tuple(a for a in range(len(sizes)) if a != rv)
            marg = g.sum(dim=axes) if axes else g
            return marg, logz, rest

        n_xs = len(self._xs)
        n_c = len(self._consts0)

        def flat(g0, *args):
            # GraphedEntry takes tensors: xs, then the binding's constants
            return run(g0, args[:n_xs], args[n_xs:])

        self._run = run
        vmap = torch.func.vmap
        self._run_batch = GraphedEntry(
            vmap(flat, in_dims=(None,) + (0,) * n_xs + (None,) * n_c),
            self.device, "run_batch",
        )
        self._run_sweep = GraphedEntry(
            vmap(flat, in_dims=(None,) + (0,) * (n_xs + n_c)), self.device,
            "run_param_sweep",
        )
        g0 = np.zeros(sizes)
        g0[(0,) * len(sizes)] = 1.0
        self._g0 = torch.as_tensor(g0, device=self.device)

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)

    def _consts(self, params):
        """Per-binding constant feed rows ($param-only feeds)."""
        penv = params if params is not None else self.params
        return tuple(self._dev(f(penv)) for f in self._const_feeds)

    # -- data preparation ----------------------------------------------
    def prepare_xs(self, data_cols, n_steps: Optional[int] = None,
                   memo: Optional[dict] = None,
                   params: Optional[dict] = None):
        """Host-precompute the stacked per-iteration feed arrays for a
        dataset (one array per slot, each of length <= max_steps) plus
        the trailing valid mask; shorter datasets are padded with
        masked copies of their last step.  ``memo`` (keyed by
        (feed index, slot-value tuple)) may be shared across a batch.
        Returns them as tensors on the device."""
        if data_cols:
            n = len(data_cols[0])
        else:
            n = n_steps if n_steps is not None else self.rep.n_iters
        if n == 0 and self._feeds:
            raise UnsupportedForScan("empty dataset")
        cap = max(getattr(self, "max_steps", n), n)
        keys = [
            tuple(col[i] for col in data_cols) for i in range(n)
        ]
        if memo is None:
            memo = {}
        penv = self.params if params is None else params
        pkey = tuple(sorted(penv.items())) if penv else ()
        xs_stacked = []
        for fi, spec in enumerate(self._feeds):
            # iteration values repeat heavily (observation counts draw
            # from a small alphabet): memoize the host row per distinct
            # slot-value tuple (+ the parameter binding)
            rows = []
            for i in range(n):
                mk = (fi, keys[i], pkey)
                row = memo.get(mk)
                if row is None:
                    row = np.asarray(
                        spec(list(keys[i]), penv), dtype=np.float64
                    )
                    memo[mk] = row
                rows.append(row)
            rows += [rows[-1]] * (cap - n)
            xs_stacked.append(np.stack(rows))
        valid = np.concatenate(
            [np.ones(n), np.zeros(cap - n)]
        )
        xs_stacked.append(valid)
        return tuple(self._dev(a) for a in xs_stacked)

    def _rest(self, logz, rest):
        """Total rest mass in true units: the threaded rest rides the
        carry rescaling, so it carries the accumulated 2**logz scale."""
        return rest.cpu().numpy() * 2.0 ** logz.cpu().numpy()

    def _one(self, xs, consts):
        """One eager walk of the loop: host masses and Z."""
        marg, logz, rr = self._run(self._g0, xs, consts)
        masses = marg.cpu().numpy() * 2.0 ** float(logz)
        self.last_rest = float(self._rest(logz, rr))
        return masses, float(masses.sum())

    def _many(self, entry, xs, consts, gather=None):
        """One call of a batched entry point: host masses and totals;
        ``gather`` joins each of its device results (the marginals, the
        log scales, the rest masses) with the other ranks' (``run_batch``
        on a mesh)."""
        marg, logz, rr = entry(self._g0, *xs, *consts)
        if gather is not None:
            marg, logz, rr = gather(marg), gather(logz), gather(rr)
        scale = 2.0 ** logz.cpu().numpy()
        masses = marg.cpu().numpy() * scale[:, None]
        self.last_rest = self._rest(logz, rr)
        return masses, masses.sum(axis=1)

    def run(self):
        return self._one(self._xs, self._consts0)

    def run_with_data(self, data_cols, params: Optional[dict] = None):
        """Unnormalized posterior masses for a new dataset (list of
        per-slot value arrays, same slot order as ``rep.data``),
        optionally under a new ``$param`` binding."""
        xs = self.prepare_xs(
            [np.asarray(c, dtype=np.float64) for c in data_cols],
            params=params,
        )
        consts = self._consts(params) if params is not None \
            else self._consts0
        return self._one(xs, consts)

    def run_batch(self, batch_cols, mesh=None, batch_axis: str = "dp"):
        """Batched serving: ``batch_cols`` is a list over slots of
        (B, n_steps) arrays; returns (B, result_size) masses and (B,)
        totals through one vmapped call (a replayed CUDA graph on the
        card).

        Host prep is vectorized: the per-step slot-value tuples draw
        from a small alphabet (observation counts), so each feed's rows
        are built once per distinct tuple and scattered to the (B,
        steps) layout with one fancy-indexing gather.

        ``mesh``: a ``parallel.mesh.Mesh`` (the process group's ranks):
        shard the batch over its ``batch_axis`` (data-parallel serving
        across devices; B must be divisible by the axis size).  Each rank
        serves its slice through its own batched entry (its own graph on
        its card), and the masses and totals are all-gathered over the
        axis, so every rank returns the whole batch's.  A slot-less
        program has a pseudo-batch of one: the mesh is a no-op there."""
        if mesh is None or not batch_cols:
            return self._many(self._run_batch, self.batch_xs(batch_cols),
                              self._consts0)
        n = mesh.shape[batch_axis]
        B = np.asarray(batch_cols[0]).shape[0]
        if B % n:
            raise ValueError(
                f"batch {B} not divisible by mesh axis '{batch_axis}' "
                f"({n}) — pad the batch"
            )
        k, per = mesh.coords[batch_axis], B // n
        part = [np.asarray(c)[k * per:(k + 1) * per] for c in batch_cols]
        return self._many(self._run_batch, self.batch_xs(part),
                          self._consts0,
                          lambda t: mesh.gather(batch_axis, t))

    def batch_xs(self, batch_cols):
        """``run_batch``'s host prep: the (B, steps, ...) feed tensors and
        the (B, steps) valid mask on the device."""
        if not batch_cols:
            # slot-less program: a single pseudo-batch of one
            return tuple(a[None] for a in self.prepare_xs([]))
        cols = [np.asarray(c, dtype=np.float64) for c in batch_cols]
        B, n = cols[0].shape
        if n == 0 and self._feeds:
            raise UnsupportedForScan("empty dataset")
        cap = max(getattr(self, "max_steps", n), n)
        keymat = np.stack(cols, axis=-1).reshape(B * n, len(cols))
        uniq, inv = np.unique(keymat, axis=0, return_inverse=True)
        xs_stacked = []
        penv = self.params
        for spec in self._feeds:
            table = np.stack([
                np.asarray(spec(list(row), penv), dtype=np.float64)
                for row in uniq
            ])
            arr = table[inv].reshape((B, n) + table.shape[1:])
            if cap > n:
                pad = np.repeat(arr[:, -1:], cap - n, axis=1)
                arr = np.concatenate([arr, pad], axis=1)
            xs_stacked.append(self._dev(arr))
        valid = np.concatenate(
            [np.ones((B, n)), np.zeros((B, cap - n))], axis=1
        )
        return tuple(xs_stacked) + (self._dev(valid),)

    def run_param_sweep(self, settings, data_cols=None):
        """Serve one dataset under a sweep of ``$param`` bindings:
        ``settings`` is a list of {name: value} dicts; rows are rebuilt
        per binding on the host (memo shared across the sweep) and the
        whole sweep runs as one vmapped call (a replayed CUDA graph on
        the card).  Returns (S, result_size) masses and (S,) totals."""
        if data_cols is None:
            data_cols = self.rep.data
        cols = [np.asarray(c, dtype=np.float64) for c in data_cols]
        memo: dict = {}
        per = [
            self.prepare_xs(cols, memo=memo, params=p)
            for p in settings
        ]
        xs = tuple(
            torch.stack([pp[j] for pp in per])
            for j in range(len(per[0]))
        )
        cper = [self._consts(p) for p in settings]
        consts = tuple(
            torch.stack([cc[j] for cc in cper])
            for j in range(len(self._const_feeds))
        )
        return self._many(self._run_sweep, xs, consts)


def compile_scan(program: ast.Program, order: int = 128,
                 min_iters: int = 4, max_order: int = 4096,
                 rtol: float = 1e-12, unroll: int = 8,
                 device=None):
    """Detect repetition, compile, and validate truncation by doubling
    the grid order until two consecutive orders agree to ``rtol``.
    Returns ``(masses, Z, obj)`` — ``obj.rep.n_iters`` is the detected
    iteration count and ``obj.result_vals`` the result variable's node
    values when it is continuous (None = integer grid, masses[k] is the
    mass of value k).  Programs with While loops report the mass still
    live after ``unroll`` iterations as ``obj.last_rest`` (results are
    lower bounds, reference-style intervals [x, x + rest]).  Raises
    UnsupportedForScan if the program is outside the fragment or never
    converges; any other error (a CUDA fault, an out-of-memory error)
    propagates.  ``device`` as in :class:`ScanCompiled` (``None``: the
    CUDA card)."""
    obj, (masses, Z) = compile_scan_program(
        program, order=order, min_iters=min_iters,
        max_order=max_order, rtol=rtol, unroll=unroll, device=device,
    )
    return masses, Z, obj


def compile_scan_program(program: ast.Program, order: int = 128,
                         min_iters: int = 4, max_order: int = 4096,
                         rtol: float = 1e-12,
                         max_steps: Optional[int] = None,
                         params: Optional[dict] = None,
                         unroll: int = 8,
                         device=None):
    """Like :func:`compile_scan` but returns the converged
    :class:`ScanCompiled` object (for serving: ``run_with_data`` /
    ``run_batch``) together with its ``(masses, Z)`` on the committed
    dataset.

    ``device``: ``None`` (default) runs the compiled program on the CUDA
    card, ``"cpu"`` on the host.  genfer_tpu defaults to the CPU, whose
    one-shot runs beat a fresh TPU compile; the port's entry points run
    on the card unless the caller asks for the CPU.  Each doubling order
    is a new object run once, eagerly (no capture): see
    :class:`ScanCompiled`."""
    program = _rename_type_changes(program)
    casc = detect_cascade(program.stmts)
    rep = None
    if casc is None:
        rep = detect_repetition(program.stmts, min_iters=min_iters)
        if rep is None:
            # no repeated block: compile the whole program as
            # straight-line mass semantics (still grid-validated by
            # order doubling) — this covers e.g. nested-inference
            # programs, whose normalize blocks batch over the
            # given-variable axes instead of enumerating
            if program.size() > 2000:
                # straight-line mass compilation builds every statement
                # into one closure chain; a repetition-free program this
                # large (e.g. an unrecognized cascade variant) would
                # compile for minutes — the interpreter is faster
                raise UnsupportedForScan(
                    "no repetition detected in a large program"
                )
            rep = Repetition(
                prologue=tuple(program.stmts), template=(), data=[],
                n_iters=0, epilogue=(),
            )
    def _grid_fingerprint(obj):
        """The compiled grids as a comparable value: if two doubling
        steps share it, they ran the IDENTICAL program and their
        agreement proves nothing."""
        cont = getattr(obj, "cont", None)
        if cont is not None:  # ScanCompiled
            return (tuple(obj.sizes),
                    tuple((v, g.xs.tobytes())
                          for v, g in sorted(cont.items())))
        xs = getattr(obj, "_xs_grid", None)  # CascadeCompiled
        return (tuple(len(g["w0"]) for g in obj._groups),
                None if xs is None else xs.tobytes())

    def _uses_quadrature(obj):
        # Dirac value grids are EXACT (the nodes are the support values
        # with unit weights — no quadrature error), so identical grids
        # across a doubling validate like pure integer grids; only a
        # true quadrature grid needs the grids-must-differ rule.
        cont = getattr(obj, "cont", None)
        if cont and any(not g.dirac for g in cont.values()):
            return True
        return bool(getattr(obj, "_continuous", False))

    prev = prev_obj = None
    o = order
    while o <= max_order:
        if casc is not None:
            obj = CascadeCompiled(program, casc, o)
        else:
            obj = ScanCompiled(program, rep, o, max_steps=max_steps,
                               params=params, unroll=unroll,
                               device=device)
        cur = obj.run()
        if prev is not None:
            r_prev = float(getattr(prev_obj, "last_rest", 0.0) or 0.0)
            r_cur = float(getattr(obj, "last_rest", 0.0) or 0.0)
            rest_ok = abs(r_prev - r_cur) <= rtol * max(
                r_prev, r_cur, prev[1], cur[1], 1e-300
            )
            # quadrature error never vanishes exactly: two orders whose
            # node grids came out IDENTICAL (the composite-GL panel/node
            # floors coincide at small orders) must not validate each
            # other — keep doubling until the grids actually differ.
            # Pure integer grids are exempt: identical sizes there mean
            # the finite supports are fully covered (exact results).
            if _uses_quadrature(obj) and (
                _grid_fingerprint(obj) == _grid_fingerprint(prev_obj)
            ):
                prev, prev_obj = cur, obj
                o *= 2
                continue
            m_prev, z_prev = prev
            m_cur, z_cur = cur
            pv = getattr(prev_obj, "result_vals", None)
            cv = getattr(obj, "result_vals", None)
            if pv is not None and cv is not None:
                # continuous result: the node sets differ between grid
                # orders, so compare Z and the posterior moments the
                # caller reads instead of raw node masses (moments up
                # to 6: posterior-shape agreement, not just the mean)
                def _summ(m, z, vals):
                    if z <= 0.0:
                        return np.zeros(7)
                    return np.asarray(
                        [z] + [float((m * vals ** k).sum()) / z
                               for k in (1, 2, 3, 4, 5, 6)]
                    )

                sp = _summ(m_prev, z_prev, pv)
                sc = _summ(m_cur, z_cur, cv)
                ok = all(
                    abs(a - b) <= rtol * max(abs(a), abs(b), 1e-12)
                    for a, b in zip(sp, sc)
                )
                if ok and rest_ok:
                    return prev_obj, prev
                prev, prev_obj = cur, obj
                o *= 2
                continue
            k = min(len(m_prev), len(m_cur))
            scale = max(z_cur, np.max(m_cur) if len(m_cur) else 0.0)
            zero_measure = (
                scale == 0.0
                and z_prev == 0.0
                and not np.any(m_prev)
            )
            if rest_ok and (zero_measure or (scale > 0.0 and np.allclose(
                m_prev[:k], m_cur[:k], rtol=rtol, atol=scale * 1e-15
            ) and abs(z_prev - z_cur) <= rtol * scale)):
                # the smaller grid is the validated one (it agrees with
                # its doubling to rtol) — keep it: half the memory and
                # traffic for serving reruns
                return prev_obj, prev
        prev, prev_obj = cur, obj
        o *= 2
    raise UnsupportedForScan(
        f"truncation did not converge below order {max_order}"
    )
