"""The scan compiler of the port (``genfer_tpu_torch.scanc``) against
genfer_tpu's (``genfer_tpu.scanc``): every case of ``tests/test_scanc.py``
that runs without the reference's corpus, the same program and data
through both packages, the JAX package on the CPU as its own tests run it,
the port with ``device="cpu"``.  Masses agree at rtol 1e-12 (both run the
same IEEE f64 arithmetic; XLA and torch sum in other orders; a mass below
the smallest normal f64 keeps fewer than 53 bits and is held absolutely
at that bound), the rest mass at 1e-12 of the larger of it and Z (the
doubling check's own scale: the rest is a cancelling sum where a loop
compounds formally negative weights), the converged grid order is equal, and the CLI's ``--compile-scan`` output is
equal line by line at the reference's is_close (rel 1e-9 / abs 1e-8) with
the same printed keys.  The closed forms the JAX tests check are checked
on the port's results too.  On the card: the batched entry points through
their CUDA graphs against the same object on the CPU."""

import io
import math
import random
import re
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

# genfer_tpu's scanc and cli import jax only where they run it: the card
# machine, which has no jax, collects this file for its ``cuda`` tests
import genfer_tpu.cli as jcli
import genfer_tpu.scanc as J
from genfer_tpu.lang import ast as jast
from genfer_tpu.lang.parser import parse_program as jparse
from genfer_tpu_torch import api as tapi
from genfer_tpu_torch import cli as tcli
from genfer_tpu_torch import scanc as S
from genfer_tpu_torch.lang import ast as tast
from genfer_tpu_torch.lang.parser import parse_program as tparse
from genfer_tpu_torch.printed import IS_CLOSE
from genfer_tpu_torch.tools.generators import (
    generate_mixture,
    generate_two_populations,
)

RTOL = 1e-12
TINY = np.finfo(np.float64).tiny  # the smallest normal f64


def _same_masses(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=TINY)


def _both(src, **kw):
    """``compile_scan`` of ``src`` in both packages; the port's result
    after checking it against genfer_tpu's: masses, Z, the rest, the
    converged order and the result grid's values."""
    jm, jz, jobj = J.compile_scan(jparse(src), **kw)
    tm, tz, tobj = S.compile_scan(tparse(src), device="cpu", **kw)
    assert type(tobj).__name__ == type(jobj).__name__
    assert tobj.order == jobj.order
    _same_masses(tm, jm)
    assert tz == pytest.approx(jz, rel=RTOL, abs=0)
    j_rest = float(getattr(jobj, "last_rest", 0.0) or 0.0)
    t_rest = float(getattr(tobj, "last_rest", 0.0) or 0.0)
    assert abs(t_rest - j_rest) <= RTOL * max(j_rest, jz, TINY)
    jv, tv = getattr(jobj, "result_vals", None), getattr(tobj, "result_vals",
                                                        None)
    assert (jv is None) == (tv is None)
    if tv is not None:
        np.testing.assert_array_equal(tv, jv)
    return tm, tz, tobj


def _cli(main, src, *flags):
    with tempfile.NamedTemporaryFile("w", suffix=".sgcl",
                                     delete=False) as f:
        f.write(src)
        path = f.name
    buf = io.StringIO()
    with redirect_stdout(buf):
        main([path, "--no-timing", *flags])
    return buf.getvalue()


def _port_cli(src, *flags):
    """The port's CLI on the CPU (``cli.main`` always takes the card)."""
    args = tcli.build_arg_parser().parse_args(["model.sgcl", "--no-timing",
                                               *flags])
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = tcli.run(tparse(src), args, device="cpu")
    return buf.getvalue(), out


_VALUE = re.compile(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|NaN|inf)")


def _same_cli(src, *flags):
    """The port's ``--compile-scan`` stdout against genfer_tpu's: the
    same lines with the same text, every number on them at is_close.
    Returns the port's stdout."""
    got, obj = _port_cli(src, *flags, "--compile-scan")
    want = _cli(jcli.main, src, *flags, "--compile-scan")
    rel, atol = IS_CLOSE
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines)
    for g, w in zip(g_lines, w_lines):
        assert _VALUE.sub("#", g) == _VALUE.sub("#", w), (g, w)
        for a, b in zip(_VALUE.findall(g), _VALUE.findall(w)):
            a, b = float(a), float(b)
            assert a == b or abs(a - b) <= max(rel * max(abs(a), abs(b)), atol), (g, w)
    return got, obj


def _parse_probs(out):
    probs = {
        int(m.group(1)): float(m.group(2))
        for m in re.finditer(
            r"Unnormalized: p\((\d+)\)\s*=\s*([\d.e+-]+)", out
        )
    }
    if not probs:  # normalized printing (no observe)
        probs = {
            int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"p\((\d+)\) = ([\d.e+-]+)", out)
        }
    return probs


# ----------------------------------------------------------------------
# the CLI (tests/test_scanc.py's _cli cases), port against genfer_tpu
# ----------------------------------------------------------------------

def _cascade_src():
    units = ["observe 2 ~ Poisson(0.5 * r);", "observe 0 ~ Poisson(0.5 * r);",
             "observe 3 ~ Poisson(0.5 * r);", "observe 1 ~ Poisson(0.5 * r);",
             "observe 4 ~ Poisson(0.5 * r);"]
    n = len(units)
    src = "r ~ Geometric(0.3);\n"
    for k in range(n + 1):
        body = units[:k] + ["r ~ Geometric(0.3);"] + units[k:]
        body.append(f"sp := {10 + 2 * k};")
        kw = "if" if k == 0 else "} else if"
        src += f"{kw} 1 ~ Bernoulli(1 / {n + 1 - k}) {{\n"
        src += "\n".join(body) + "\n"
    return src + "} else {}\nreturn sp;"


SYNTH = """
state := 1;
count ~ Poisson(3.25);
count ~ Binomial(count, 1/4);
count +~ Geometric(0.7);
if state = 1 {
    observe 2 ~ Poisson(0.5 * count);
    state ~ Bernoulli(1/3);
}
count +~ Poisson(1.5);
observe 1 ~ Binomial(count, 0.3);
if state = 1 {
    observe 3 ~ Poisson(0.5 * count);
    state ~ Bernoulli(1/3);
}
count +~ Poisson(2.5);
observe 2 ~ Binomial(count, 0.3);
if state = 1 {
    observe 1 ~ Poisson(0.5 * count);
    state ~ Bernoulli(1/3);
}
count +~ Poisson(0.5);
observe 0 ~ Binomial(count, 0.3);
if state = 1 {
    observe 2 ~ Poisson(0.5 * count);
    state ~ Bernoulli(1/3);
}
count +~ Poisson(1.25);
observe 1 ~ Binomial(count, 0.3);
return count
"""

NESTED_WIDE = """
Class ~ Binomial(15, 0.5);
normalize Class {
    Rate ~ Geometric(0.1);
    observe 5 ~ Poisson(0.2 * Rate);
    if Class <= 7 {
        observe 3 ~ Poisson(0.2 * Rate);
    } else {
        observe 8 ~ Poisson(0.2 * Rate);
    }
}
observe 4 ~ Poisson(0.1 * Rate);
return Class
"""

CLI_CASES = {
    # test_cli_scan_matches_interpreter: thinning, increments, var-rate
    # observe, state branching
    "synthetic": (SYNTH, ["--limit", "25"], 1e-11),
    # test_cascade_synthetic_vs_interpreter (its p(k) held at the larger
    # of |p(k)| and 1e-12 Z, as there)
    "cascade": (_cascade_src(), [], 1e-8),
    # test_nested_normalize_wide_matches_interpreter
    "nested_wide": (NESTED_WIDE, ["--limit", "16"], 1e-10),
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_scan_matches_genfer_tpu(name):
    """``--compile-scan`` on the program: the port's stdout is genfer_tpu's
    line by line, its masses are genfer_tpu's at rtol 1e-12, and its
    p(k) are the port's own interpreter's as the JAX test holds them."""
    src, flags, rtol = CLI_CASES[name]
    out, obj = _same_cli(src, *flags)
    assert isinstance(obj, (S.ScanCompiled, S.CascadeCompiled))
    _both(src)
    got = _parse_probs(out)
    ref_out, _ = _port_cli(src, *flags)
    ref = _parse_probs(ref_out)
    assert got
    if name == "cascade":
        Zi = float(re.search(r"Z = ([\d.e+-]+)", ref_out).group(1))
        Zs = float(re.search(r"Z = ([\d.e+-]+)", out).group(1))
        assert abs(Zs - Zi) / Zi <= 1e-9
        assert set(ref) <= set(got)
        for k, v in ref.items():
            assert abs(got[k] - v) <= rtol * max(abs(v), Zi * 1e-12), (k, got[k], v)
    else:
        assert set(got) == set(ref)
        for k, v in ref.items():
            if v > 1e-280:
                assert abs(got[k] - v) <= rtol * v, (k, got[k], v)


FALLBACK = "x ~ Geometric(1/2);\nwhile x > 0 { x -= 1; }\nreturn x"
# a continuous result left unsampled on one path: outside the fragment
UNSAMPLED = ("c ~ Bernoulli(1/2);\n"
             "if c = 1 { P ~ UniformCont(0,1); } else { }\n"
             "return P")


@pytest.mark.parametrize("src,scanned", [(FALLBACK, True),
                                         (UNSAMPLED, False)],
                         ids=["while", "unsupported"])
def test_cli_scan_fallback(src, scanned):
    """The output stays valid and is genfer_tpu's whether the scan path
    takes the program or falls back to the interpreter; only
    ``UnsupportedForScan`` falls back."""
    out, obj = _same_cli(src)
    assert isinstance(obj, S.ScanCompiled) == scanned
    if scanned:
        assert "p(0)" in out
    else:
        with pytest.raises(S.UnsupportedForScan):
            S.compile_scan(tparse(src), device="cpu")
        assert "Total measure" in out


def test_scan_errors_other_than_unsupported_propagate(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(S, "compile_scan", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _port_cli(SYNTH, "--compile-scan")


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------

def test_increment_binary_decomposition():
    """v +~ Binomial(w, p) by the bit decomposition, in both packages, and
    against the brute-force band operator."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    nw, nv = 13, 17
    g = rng.random((nw, nv))

    def stmt(a):
        return a.Sample(var=1, distribution=a.BinomialVarTrials(
            var=0, p=a.PosRatio(3, 10)), add_previous_value=True)

    want = np.asarray(J._MassCompiler([nw, nv])._stmt_op(stmt(jast))(
        jnp.asarray(g), ()))
    got = S._MassCompiler([nw, nv], device="cpu")._stmt_op(stmt(tast))(
        torch.from_numpy(g), ()).numpy()
    _same_masses(got, want)
    brute = np.zeros_like(g)
    for n in range(nw):
        pmf = S._binom_vec(n, 0.3, nv)
        for m in range(nv):
            brute[n, m] = sum(g[n, m - k] * pmf[k] for k in range(m + 1))
    _same_masses(got, brute)


@pytest.mark.parametrize("R,C", [(5, 9), (8, 8), (11, 4)])
def test_skew_add(R, C):
    """v += w as pad, reshape and slice: genfer_tpu's bits, and the
    brute-force shift."""
    import jax.numpy as jnp

    g = np.random.default_rng(1).random((R, C))
    got = S._MassCompiler([R, C], device="cpu")._skew_add(
        torch.from_numpy(g), 0, 1).numpy()
    want = np.asarray(J._MassCompiler([R, C])._skew_add(jnp.asarray(g), 0,
                                                        1))
    np.testing.assert_array_equal(got, want)
    brute = np.zeros_like(g)
    for r in range(R):
        for c in range(r, C):
            brute[r, c] = g[r, c - r]
    np.testing.assert_array_equal(got, brute)


# ----------------------------------------------------------------------
# continuous and Dirac grids
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_continuous_grid_beta_bernoulli_exact(seed):
    rng = random.Random(4200 + seed)
    obs = [rng.randrange(2) for _ in range(rng.randrange(1, 12))]
    src = "P ~ UniformCont(0, 1);\n"
    src += "".join(f"observe {o} ~ Bernoulli(P);\n" for o in obs)
    src += "return P"
    masses, Z, obj = _both(src, order=64)
    h, t = sum(obs), len(obs) - sum(obs)
    z_exact = math.gamma(1 + h) * math.gamma(1 + t) / math.gamma(2 + h + t)
    assert abs(Z - z_exact) <= 1e-13 * z_exact
    e = float((masses * obj.result_vals).sum()) / Z
    assert abs(e - (1 + h) / (2 + h + t)) <= 1e-12 * e


def test_continuous_copy_assign_clickgraph_shape():
    src = """
same ~ Bernoulli(1/2);
if same = 1 {
    b1 ~ UniformCont(0, 1);
    b2 := b1;
} else {
    b1 ~ UniformCont(0, 1);
    b2 ~ UniformCont(0, 1);
}
observe 1 ~ Bernoulli(b1);
observe 0 ~ Bernoulli(b2);
observe 1 ~ Bernoulli(b1);
return same
"""
    masses, Z, _ = _both(src, order=64)
    w1, w0 = 0.5 / 12.0, 0.5 / 6.0
    assert abs(Z - (w0 + w1)) <= 1e-13
    assert abs(masses[1] - w1) <= 1e-13 and abs(masses[0] - w0) <= 1e-13


def test_continuous_serving_fresh_data():
    """``run_with_data`` and ``run_batch`` on fresh Bernoulli strings: the
    port's rows equal genfer_tpu's and the exact Beta integral."""
    obs = [1, 0, 1, 1, 0, 1]
    src = ("P ~ UniformCont(0, 1);\n"
           + "".join(f"observe {o} ~ Bernoulli(P);\n" for o in obs)
           + "return P")
    jobj, _ = J.compile_scan_program(jparse(src), order=64)
    tobj, _ = S.compile_scan_program(tparse(src), order=64, device="cpu")
    assert tobj.order == jobj.order

    def z_exact(b):
        h, t = int(sum(b)), int(len(b) - sum(b))
        return (math.gamma(1 + h) * math.gamma(1 + t)
                / math.gamma(2 + h + t))

    fresh = [0, 0, 1, 0, 0, 0]
    m, Z = tobj.run_with_data([fresh])
    jm, _ = jobj.run_with_data([fresh])
    _same_masses(m, jm)
    assert abs(Z - z_exact(fresh)) <= 1e-13 * z_exact(fresh)
    batch = np.asarray([[1, 1, 1, 0, 1, 1], [0, 1, 0, 0, 1, 0]])
    mb, Zs = tobj.run_batch([batch])
    jmb, _ = jobj.run_batch([batch])
    _same_masses(mb, jmb)
    for Zb, b in zip(Zs, batch):
        assert abs(Zb - z_exact(b)) <= 1e-12 * z_exact(b)


def test_continuous_grid_regressions():
    _, Z, _ = _both(
        "P ~ UniformCont(0,1);\nobserve 2 ~ Bernoulli(P);\nreturn P",
        order=64)
    assert Z == 0.0
    unsampled = ("c ~ Bernoulli(1/2);\n"
                 "if c = 1 { P ~ UniformCont(0,1); } else { }\n"
                 "return P")
    with pytest.raises(J.UnsupportedForScan):
        J.compile_scan(jparse(unsampled), order=128)
    with pytest.raises(S.UnsupportedForScan):
        S.compile_scan(tparse(unsampled), order=128, device="cpu")
    m, Z, obj = _both("P ~ UniformCont(0,1);\n"
                      "observe 1 ~ Bernoulli(P);\nobserve 1 ~ Bernoulli(P);\n"
                      "return P", order=8)
    assert abs(Z - 1.0 / 3.0) <= 1e-14
    assert abs(float((m * obj.result_vals).sum()) / Z - 0.75) <= 1e-13


@pytest.mark.parametrize("shape", [0.25, 0.5, 0.7])
def test_gamma_shape_lt1_exact_conjugacy(shape):
    b, c = 0.1, 4
    m, Z, obj = _both(f"X ~ Gamma({shape}, {b});\nreturn X", order=64)
    assert abs(Z - 1.0) <= 1e-11
    for k in (1, 2, 3, 4):
        mk = float((m * obj.result_vals ** k).sum()) / Z
        exact = math.prod((shape + i) / b for i in range(k))
        assert abs(mk - exact) <= 1e-10 * exact
    m, Z, obj = _both(
        f"X ~ Gamma({shape}, {b});\nobserve {c} ~ Poisson(X);\nreturn X",
        order=64)
    ap, bp = shape + c, 1.0 + b
    z_exact = (math.gamma(ap) / math.gamma(shape)) * (
        b ** shape / bp ** ap) / math.factorial(c)
    assert abs(Z - z_exact) <= 1e-11 * z_exact


# ----------------------------------------------------------------------
# serving: $param sweeps and cascades
# ----------------------------------------------------------------------

SWEEP_SRC = """nr ~ Poisson(6);
observe 2 ~ Binomial(nr, {p});
nr +~ Poisson(3);
observe 1 ~ Binomial(nr, {p});
nr +~ Poisson(3);
observe 3 ~ Binomial(nr, {p});
nr +~ Poisson(3);
observe 2 ~ Binomial(nr, {p});
nr +~ Poisson(3);
observe 4 ~ Binomial(nr, {p});
return nr;"""
SWEEPS = [{"p": 0.2}, {"p": 0.3}, {"p": 0.5}]


def test_param_ratio_serving_sweep():
    """``run_param_sweep`` (``torch.func.vmap`` over the bindings, each
    binding's increments a Toeplitz matrix of its own): genfer_tpu's rows,
    the committed binding's run, and the host interpreter with the value
    inlined."""
    src = SWEEP_SRC.format(p="$p")
    jobj, _ = J.compile_scan_program(jparse(src), order=64,
                                     params={"p": 0.3})
    tobj, (m0, _) = S.compile_scan_program(tparse(src), order=64,
                                           params={"p": 0.3}, device="cpu")
    assert tobj.order == jobj.order
    masses, totals = tobj.run_param_sweep(SWEEPS)
    jmasses, _ = jobj.run_param_sweep(SWEEPS)
    _same_masses(masses, jmasses)
    _same_masses(masses[1], m0)
    for row, tot, setting in zip(masses, totals, SWEEPS):
        out, _ = _port_cli(SWEEP_SRC.format(p=repr(setting["p"])))
        Z = float(re.search(r"Z = ([\d.e+-]+)", out).group(1))
        for k, pv in _parse_probs(out).items():
            if k < len(row):
                assert abs(row[k] - pv) <= 1e-9 * Z
        assert abs(tot - Z) / Z <= 1e-9


def _cascade_single(cs):
    n = len(cs)
    out = "r ~ Geometric(0.3);\n"
    for k in range(n + 1):
        body = [f"observe {c} ~ Poisson(0.5 * r);" for c in cs[:k]]
        body.append("r ~ Geometric(0.3);")
        body += [f"observe {c} ~ Poisson(0.5 * r);" for c in cs[k:]]
        body.append(f"sp := {k};")
        kw = "if" if k == 0 else "} else if"
        out += f"{kw} 1 ~ Bernoulli(1 / {n + 1 - k}) {{\n"
        out += "\n".join(body) + "\n"
    return out + "} else {}\nreturn sp;"


def _cascade_multivar(cs):
    n = len(cs)

    def unit(i, c):
        v = "r" if i % 2 == 0 else "s"
        return f"observe {c} ~ Poisson(0.5 * {v});"

    out = "r ~ Geometric(0.3);\ns ~ Poisson(2);\n"
    for k in range(n + 1):
        body = [unit(i, c) for i, c in enumerate(cs[:k])]
        body.append("r ~ Geometric(0.3);")
        body += [unit(k + i, c) for i, c in enumerate(cs[k:])]
        body.append(f"sp := {k};")
        kw = "if" if k == 0 else "} else if"
        out += f"{kw} 1 ~ Bernoulli(1 / {n + 1 - k}) {{\n"
        out += "\n".join(body) + "\n"
    return out + "} else {}\nreturn sp;"


@pytest.mark.parametrize("src_for,groups", [
    (_cascade_single, None),        # test_cascade_serving_fresh_counts
    (_cascade_multivar, {True, False}),  # ..._multivar_serving_...
], ids=["single", "multivar"])
def test_cascade_serving_fresh_counts(src_for, groups):
    """``run_with_counts`` on fresh counts (host numpy in both packages):
    genfer_tpu's masses, and the port's host interpreter on the rewritten
    source; the committed counts still give the committed result."""
    units, fresh = [2, 0, 3, 1, 4, 2], [1, 2, 0, 4, 3, 1]
    jobj, _ = J.compile_scan_program(jparse(src_for(units)), order=64)
    tobj, (m0, _) = S.compile_scan_program(tparse(src_for(units)), order=64,
                                           device="cpu")
    assert isinstance(tobj, S.CascadeCompiled) and tobj.order == jobj.order
    if groups is not None:
        assert {g["h0"] is None for g in tobj._groups} == groups
    masses, Z = tobj.run_with_counts(fresh)
    jmasses, _ = jobj.run_with_counts(fresh)
    _same_masses(masses, jmasses)
    out, _ = _port_cli(src_for(fresh))
    Zi = float(re.search(r"Z = ([\d.e+-]+)", out).group(1))
    assert abs(Z - Zi) / Zi <= 1e-9
    for k, pv in _parse_probs(out).items():
        if k < len(masses):
            assert abs(masses[k] - pv) <= 1e-9 * Zi
    m1, _ = tobj.run_with_counts(units)
    _same_masses(m1, m0)


# ----------------------------------------------------------------------
# while loops: bounded unrolling with rest-mass intervals
# ----------------------------------------------------------------------

WHILE_GEOMETRIC = ("X := 0;\nwhile 0 ~ Bernoulli(1/2) { X += 1; }\n"
                   "return X")
WHILE_CASES = {
    # test_while_in_given_normalize_matches_interpreter
    "given_normalize": ("c ~ Bernoulli(1/2);\nnormalize c {\n  X := 0;\n"
                        "  while 0 ~ Bernoulli(1/2) { X += 1; }\n}\n"
                        "return X", dict(order=64)),
    # test_while_reads_continuous_matches_interpreter
    "reads_continuous": ("P ~ UniformCont(0, 1);\nX := 0;\n"
                         "while 0 ~ Bernoulli(1/2) { X += 1; }\n"
                         "observe 1 ~ Bernoulli(P);\nreturn X",
                         dict(order=64)),
    # test_while_additive_compound_on_quadrature_grid
    "additive_compound": ("P ~ UniformCont(0, 1/2);\nX := 0;\n"
                          "while 0 ~ Bernoulli(1/2) { X += 1; "
                          "P +~ Bernoulli(P); }\n"
                          "observe 1 ~ Bernoulli(P);\nreturn X",
                          dict(order=64, unroll=8)),
    # test_straightline_compound_support_above_one
    "compound_above_one": ("X ~ UniformCont(0, 2);\nX +~ Bernoulli(X);\n"
                           "Y ~ Poisson(X);\nreturn Y", dict(order=64)),
    # test_while_writes_affine_quadrature_grid
    "affine_quadrature": ("P ~ UniformCont(0, 1);\nX := 0;\n"
                          "while 0 ~ Bernoulli(1/2) { X += 1; "
                          "P := 2 * P + 0; }\n"
                          "observe 1 ~ Bernoulli(P);\nreturn X",
                          dict(order=32, unroll=6)),
    # test_while_writes_continuous_fresh_resample
    "fresh_resample": ("flip ~ Bernoulli(1/2);\nc := 0;\n"
                       "while flip = 1 {\n    X ~ Exponential(2);\n"
                       "    observe 1 ~ Poisson(1 * X);\n"
                       "    flip ~ Bernoulli(1/2);\n    c += 1;\n}\n"
                       "return c", dict(order=64, unroll=8)),
    # test_while_writes_dirac_value_grid (both of its programs)
    "dirac_value": ("P ~ Dirac(1/1024);\nflip ~ Bernoulli(1/2);\n"
                    "while flip = 1 {\n    P := 2 * P + 0;\n"
                    "    flip ~ Bernoulli(1/3);\n}\n"
                    "observe 1 ~ Bernoulli(P);\nreturn flip",
                    dict(order=64, unroll=8)),
    "dirac_bounded": ("P ~ Dirac(1/16);\nn := 0;\nwhile n < 3 {\n"
                      "    P := 2 * P + 0;\n    n += 1;\n}\n"
                      "Q ~ Bernoulli(P);\nreturn Q", dict(order=64)),
}


@pytest.mark.parametrize("name", sorted(WHILE_CASES))
def test_while_scan_matches_genfer_tpu(name):
    src, kw = WHILE_CASES[name]
    masses, Z, obj = _both(src, **kw)
    if name == "affine_quadrature":  # unnormalized p(k) = 1/4 exactly
        assert all(abs(masses[k] - 0.25) <= 1e-12 for k in range(6))
        assert abs(obj.last_rest - 0.5 ** 6) <= 1e-12
    if name == "fresh_resample":
        for k in range(8):
            want = 0.5 ** (k + 1) * (2.0 / 9.0) ** k
            assert abs(masses[k] - want) <= 1e-11 * want
    if name == "dirac_bounded":
        assert obj.last_rest == 0.0 and abs(masses[1] - 0.5) <= 1e-15


@pytest.mark.parametrize("unroll", [8, 14])
def test_while_scan_rest_mass_direct(unroll):
    masses, Z, obj = _both(WHILE_GEOMETRIC, order=64, unroll=unroll)
    for k in range(unroll):
        assert masses[k] == 2.0 ** -(k + 1)
    assert obj.last_rest == 2.0 ** -unroll


def test_while_in_scanned_template_matches_genfer_tpu():
    """A While inside the repeated block: the rest rides the loop's carry
    and its power-of-two rescaling, in both packages."""
    data = (1, 2, 0, 1, 3, 0, 2, 1, 0, 0, 1, 2)
    src = "X := 1;\n" + "".join(
        "X +~ Bernoulli(1/4);\n"
        "while 0 ~ Bernoulli(1/3) { X += 1; }\n"
        "observe %d ~ Poisson(0.3 * X);\n" % c
        for c in data
    ) + "return X"
    rep = S.detect_repetition(tparse(src).stmts)
    assert rep.n_iters == len(data) and len(rep.template) == 3
    _, _, obj = _both(src, order=96, unroll=8)
    assert obj.last_rest > 0


# ----------------------------------------------------------------------
# the generated models: batched serving and a full run
# ----------------------------------------------------------------------

def test_run_batch_mixture_matches_genfer_tpu():
    """The mixture model at order 128, 128 steps: a seeded batch of 4
    datasets of 40 counts (padded to 128) through ``run_batch`` equals
    genfer_tpu's ``run_batch`` and the port's own ``run_with_data``."""
    src = generate_mixture(None)
    jobj, (jm, _) = J.compile_scan_program(jparse(src), order=128,
                                           max_steps=128)
    tobj, (tm, _) = S.compile_scan_program(tparse(src), order=128,
                                           max_steps=128, device="cpu")
    assert tobj.order == jobj.order == 128
    _same_masses(tm, jm)
    bc = np.random.default_rng(3).integers(0, 7, size=(4, 40)).astype(float)
    cols = [bc] * len(tobj.rep.data)
    mb, zb = tobj.run_batch(cols)
    jmb, jzb = jobj.run_batch(cols)
    _same_masses(mb, jmb)
    _same_masses(zb, jzb)
    for i in (0, 3):
        mi, _ = tobj.run_with_data([c[i] for c in cols])
        _same_masses(mb[i], mi)
    # the mesh (parallel.mesh, run on gloo ranks in
    # tests/test_torch_sharded.py) refuses a batch that does not divide
    # its axis before any collective
    two = type("TwoRanks", (), {"shape": {"dp": 2}, "coords": {"dp": 0}})
    with pytest.raises(ValueError, match="not divisible"):
        tobj.run_batch([c[:3] for c in cols], mesh=two())


def test_two_populations_500_end_to_end():
    """two_populations(500) through ``compile_scan_program``: the same
    converged order (256) and masses as genfer_tpu."""
    src = generate_two_populations(None, 500)
    _, _, obj = _both(src, order=128)
    assert obj.order == 256 and obj.sizes == [256, 256]


def test_compile_serving_returns_the_compiled_object():
    """``api.compile_serving`` is the scan compiler as a library call:
    the object serves fresh datasets as genfer_tpu's does."""
    from genfer_tpu import api as japi

    src = SWEEP_SRC.format(p="0.3")
    obj = tapi.compile_serving(src, order=64, device="cpu")
    jobj = japi.compile_serving(src, order=64)
    assert isinstance(obj, S.ScanCompiled) and obj.order == jobj.order
    fresh = [np.asarray([1.0, 2.0, 0.0, 4.0])]
    _same_masses(obj.run_with_data(fresh)[0], jobj.run_with_data(fresh)[0])


def test_scan_compiler_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.compile_scan(tparse(SYNTH))
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.compile_serving(SYNTH)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_scan_serving_on_card():
    """The mixture batch through its CUDA graph (captured once, replayed)
    and the $param sweep on the card equal the same objects on the CPU at
    rtol 1e-12; the eager one-shot runs converge at the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = generate_mixture(None)
    card, (cm, _) = S.compile_scan_program(tparse(src), order=128,
                                           max_steps=128)
    cpu, (hm, _) = S.compile_scan_program(tparse(src), order=128,
                                          max_steps=128, device="cpu")
    assert card.device.type == "cuda" and card.order == cpu.order
    _same_masses(cm, hm)
    bc = np.random.default_rng(5).integers(0, 8, size=(16, 109)).astype(float)
    cols = [bc] * len(card.rep.data)
    first, _ = card.run_batch(cols)
    again, _ = card.run_batch(cols)
    assert len(card._run_batch.graphs) == 1
    np.testing.assert_array_equal(again, first)
    _same_masses(first, cpu.run_batch(cols)[0])
    sweep = SWEEP_SRC.format(p="$p")
    card, _ = S.compile_scan_program(tparse(sweep), order=64,
                                     params={"p": 0.3})
    cpu, _ = S.compile_scan_program(tparse(sweep), order=64,
                                    params={"p": 0.3}, device="cpu")
    _same_masses(card.run_param_sweep(SWEEPS)[0],
                 cpu.run_param_sweep(SWEEPS)[0])
