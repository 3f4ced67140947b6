"""Constant spines of the GF DAG in one launch (``ops.spine_f64``,
``compile.TracedF64Backend.eval_spine``) on the CPU, where the op runs its
plain version: the fused walk against the link-by-link loop with
``torch.equal``, every fused spine's TaylorPoly fields against the loop's
(host constant, ``linear``, ``const0`` compared by their symbolic form),
the ``walk.spines_fused`` count, and the host backends, which keep the
loop.  The op's vmap rule and its operands' checks besides.  The kernel
itself runs only on the card (``chip_smoke.py`` phase 11)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from genfer_tpu_torch import cli, trace
from genfer_tpu_torch import compile as C
from genfer_tpu_torch.gf import nativeeval
from genfer_tpu_torch.gf.ir import GenFun
from genfer_tpu_torch.ops import spine_f64 as ops
from genfer_tpu_torch.ops.spine_f64 import (
    pack_adds,
    spine_f64,
    spine_f64_reference,
    spine_op,
)
from genfer_tpu_torch.taylor.host import Backend
from genfer_tpu_torch.tools.generators import DIGIT_PRIORS

SCAM = """
calls ~ Poisson(10);
scams ~ Binomial(calls, $p);
observe(scams = 1);
return calls;
"""


def digit_source(pixels, probability=None):
    """A naive-Bayes model of 10 classes: pixel i of class c observes 1
    for even i and 0 for odd i, from ``Bernoulli($e<c>_<i>)`` or, with
    ``probability``, from a literal one."""
    lines = ["y ~ Categorical(" + ", ".join(DIGIT_PRIORS) + ");"]
    params = []
    for c in range(10):
        lines.append(f"if y = {c} {{")
        for i in range(pixels):
            p = (f"$e{c}_{i}" if probability is None
                 else repr(probability(c, i)))
            lines.append(f"    observe {1 - i % 2} ~ Bernoulli({p});")
            params.append(f"e{c}_{i}")
        lines.append("}")
    lines.append("return y")
    return "\n".join(lines), params if probability is None else []


TWO_VARS = "\n".join(
    ["x ~ Binomial(5, $q);", "y ~ Binomial(x, $p);"]
    + [f"observe {i % 2} ~ Bernoulli($e{i});" for i in range(10)]
    + ["return x"])


@pytest.fixture
def loop(monkeypatch):
    """Makes every walk take the loop (the threshold out of reach)."""
    return lambda: monkeypatch.setattr(C, "SPINE_MIN_LINKS", 10 ** 9)


def _meta(poly):
    return (poly.degrees_p1, repr(poly.host_const), repr(poly.linear),
            repr(poly.const0))


@pytest.fixture
def fields(monkeypatch):
    """Holds every spine of an unbatched walk that is long enough to fuse
    to the loop's, field by field; gives the list of their link counts."""
    held = []
    fused = C.TracedF64Backend.eval_spine

    def both(self, base, links, constant):
        got = fused(self, base, links, constant)
        if len(links) >= C.SPINE_MIN_LINKS:
            want = Backend.eval_spine(self, base, links, constant)
            assert torch.equal(got.coeffs, want.coeffs)
            assert _meta(got) == _meta(want)
            held.append(len(links))
        return got

    monkeypatch.setattr(C.TracedF64Backend, "eval_spine", both)
    return held


def _batch(program, params, rows, seed):
    rng = np.random.default_rng(seed)
    return program.probs_batch(rng.uniform(0.05, 0.95, (rows, params)))


def test_digit_shaped_batch_equals_the_loop(loop):
    """10 classes x 12 pixels, observes of 0 and 1, a batch of 64 under
    vmap: one fused spine a class, the loop's bits."""
    src, params = digit_source(12)
    program = C.CompiledProgram(src, params, 10, device="cpu")
    with trace.recording() as rec:
        got = _batch(program, len(params), 64, 0)
    assert rec.count("walk.spines_fused", phase="eager") == 10
    assert rec.count("walk.spines_fused", links=24) == 10
    loop()
    want = _batch(C.CompiledProgram(src, params, 10, device="cpu"),
                  len(params), 64, 0)
    assert torch.equal(got, want)


def test_digit_shaped_spines_carry_the_loops_fields(fields):
    src, params = digit_source(12)
    program = C.CompiledProgram(src, params, 10, device="cpu")
    program.probs(np.random.default_rng(1).uniform(0.05, 0.95, len(params)))
    # the first class's series is a constant: its host constant is carried
    assert fields == [24] * 10


def test_two_variables_equal_the_loop(monkeypatch, loop, fields):
    """A 2-axis series under ten observations: one spine on (x, y), its
    fields the loop's; a batch of 16 the loop's bits."""
    names = ["q", "p"] + [f"e{i}" for i in range(10)]
    program = C.CompiledProgram(TWO_VARS, names, 6, device="cpu")
    program.probs(np.random.default_rng(2).uniform(0.05, 0.95, 12))
    assert fields == [20]
    monkeypatch.undo()  # the field checks do not run under vmap
    with trace.recording() as rec:
        got = _batch(program, 12, 16, 2)
    assert rec.count("walk.spines_fused") == 1
    loop()
    want = _batch(C.CompiledProgram(TWO_VARS, ["q", "p"]
                                    + [f"e{i}" for i in range(10)], 6,
                                    device="cpu"), 12, 16, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("source, params, spines", [
    (SCAM, ["p"], 0),
    (*digit_source(3), 0),  # 6 links a class: below SPINE_MIN_LINKS
], ids=["scam", "digit-3-pixels"])
def test_spines_that_are_not_fused(source, params, spines):
    assert 2 * 3 < C.SPINE_MIN_LINKS
    program = C.CompiledProgram(source, params, 8, device="cpu")
    with trace.recording() as rec:
        _batch(program, len(params), 4, 3)
    assert rec.count("walk.spines_fused") == spines


# ----------------------------------------------------------------------
# hand-built spines: every kind of link and template
# ----------------------------------------------------------------------

NAMES = [f"p{i}" for i in range(8)]
SP = C.make_param_scalar(NAMES)


def _const(i):
    """The constant-only subtrees a link may apply: a parameter, a literal,
    an observation's zero summand, a sum, a negation, a parameter times a
    literal, a literal one (a Mul by it is skipped), an exponential (made
    one link at a time)."""
    p = GenFun.constant(SP.param(NAMES[i % len(NAMES)]))
    kinds = [
        lambda: p,
        lambda: GenFun.constant(SP._lit(0.5 + i / 64)),
        lambda: GenFun.constant(SP.zero()) * GenFun.constant(
            SP.one() - SP.param(NAMES[i % len(NAMES)])),
        lambda: p + GenFun.constant(SP._lit(0.25)),
        lambda: -p,
        lambda: GenFun.constant(SP._lit(1.5)) * p,
        lambda: GenFun.constant(SP.one()),
        lambda: GenFun.constant(SP.param(NAMES[i % len(NAMES)]).exp()),
    ]
    return kinds[i % len(kinds)]()


def _chain(base, links, start=0):
    """``links`` Add / Mul links above ``base``, the constant on either
    side; the zero summand only in an Add, as an observation has it."""
    node = base
    for i in range(start, start + links):
        c = _const(i)
        if i % 3 == 0 or i % 8 == 2:
            node = c + node if i % 2 else node + c
        else:
            node = c * node if i % 2 else node * c
    return node


def _walk(root, params, degree=5):
    """``root`` evaluated by the compiled walk's backend at x = 1."""
    backend = C.TracedF64Backend(params, SP, "cpu", {})
    return root.eval(backend, [SP.one()], degree)


def _series():
    """A series with a linear form: p0 + x (so ``linear`` and ``const0``
    are carried through the links)."""
    x = GenFun.var_(0)
    return GenFun.constant(SP.param("p0")) + x


@pytest.mark.parametrize("links", [8, 40])
def test_mixed_links_either_side_equal_the_loop(fields, links):
    params = torch.tensor(np.random.default_rng(4).uniform(0.2, 0.9, 8))
    root = _chain(_series(), links)
    with trace.recording() as rec:
        got = _walk(root, params)
    assert fields == [links + 1]  # the series' own Add is a link
    assert rec.count("walk.spines_fused") == 1
    want = Backend.eval_spine  # the loop, through the whole walk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C.TracedF64Backend, "eval_spine", want)
        ref = _walk(root, params)
    assert torch.equal(got.coeffs, ref.coeffs) and _meta(got) == _meta(ref)


def test_a_shared_node_cuts_the_spine(fields):
    """A node with two consumers keeps its cache entry: the chain below it
    is one spine, each chain above it another."""
    params = torch.tensor(np.random.default_rng(5).uniform(0.2, 0.9, 8))
    shared = _chain(_series(), 12)
    root = _chain(shared, 10, 12) + _chain(shared, 9, 30)
    with trace.recording() as rec:
        got = _walk(root, params)
    assert sorted(fields) == [9, 10, 13]
    assert rec.count("walk.spines_fused") == 3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C.TracedF64Backend, "eval_spine", Backend.eval_spine)
        ref = _walk(root, params)
    assert torch.equal(got.coeffs, ref.coeffs)


def test_a_mul_by_zero_leaves_the_spine_to_the_loop(fields):
    params = torch.tensor(np.random.default_rng(6).uniform(0.2, 0.9, 8))
    zero = GenFun.constant(SP.zero())
    root = _chain(_chain(_series(), 6) * zero, 6, 6)
    with trace.recording() as rec:
        _walk(root, params)
    assert rec.count("walk.spines_fused") == 0 and fields == [14]


# ----------------------------------------------------------------------
# the host backends keep the loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_host_backends_take_the_loop(tmp_path, monkeypatch, backend):
    """A digit-shaped program with literal probabilities through
    ``NumpyF64Backend`` (its Python walk: the native tape off) and
    ``TorchF64Backend``: its long spines reach the base class's loop,
    nothing is fused, and the CLI prints byte for byte what it prints when
    only ``Const`` leaves make links, as before spines took constant-only
    subtrees (each observation's ``Add`` then evaluated by the
    recursion)."""
    src, _ = digit_source(12, lambda c, i: round(
        0.05 + 0.9 * ((7 * c + 3 * i) % 17) / 16, 4))
    path = tmp_path / "digit.sgcl"
    path.write_text(src)
    argv = [str(path), "--no-timing", "--backend", backend]
    monkeypatch.setattr(nativeeval, "try_native_eval", lambda *a: None)
    spines = []
    loop = Backend.eval_spine

    def spy(self, base, links, constant):
        spines.append(len(links))
        return loop(self, base, links, constant)

    monkeypatch.setattr(Backend, "eval_spine", spy)
    with trace.recording() as rec:
        got = _printed(argv)
    assert rec.count("walk.spines_fused") == 0
    # a class's spine: one a class but the one that ``simplify`` folds
    assert len(spines) >= 9 and set(spines) == {24}
    monkeypatch.setattr(GenFun, "_ct", property(
        lambda node: node.kind == "Const", lambda node, value: None))
    spines.clear()
    assert _printed(argv) == got and "Total measure" in got
    assert set(spines) == {1}


def _printed(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv, device="cpu")
    return buf.getvalue()


# ----------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------

def _operands(rng, rows, n, links, x_rows=None, c_rows=None):
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (x_rows or rows, n)))
    c = torch.from_numpy(rng.uniform(0.5, 1.5, (c_rows or rows, links)))
    src = torch.from_numpy(rng.permutation(links).astype(np.int32))
    adds = torch.from_numpy(pack_adds(rng.random(links) < 0.5))
    return x, c, src, adds


def test_op_is_the_loop_of_links():
    rng = np.random.default_rng(7)
    x, c, src, adds = _operands(rng, 5, 6, 70)
    flags = [bool(int(adds[l >> 5]) >> (l & 31) & 1) for l in range(70)]
    want = x.clone()
    for l, s in enumerate(src.tolist()):
        if flags[l]:
            want[:, 0] = want[:, 0] + c[:, s]
        else:
            want = want * c[:, s:s + 1]
    assert torch.equal(spine_f64(x, c, src, adds), want)
    # one row of x or of c serves every row
    one = spine_f64(x[:1], c, src, adds)
    assert torch.equal(one, spine_f64_reference(x[:1].expand(5, -1), c,
                                                src, adds))
    assert torch.equal(spine_f64(x, c[:1], src, adds),
                       spine_f64_reference(x, c[:1].expand(5, -1), src,
                                           adds))


@pytest.mark.parametrize("x_dim, c_dim", [(0, 0), (0, None), (None, 0),
                                          (1, 1)])
def test_op_under_vmap_is_one_call(monkeypatch, x_dim, c_dim):
    """The vmap rule folds the vmapped dimension into the rows: one call,
    each entry the unbatched op's bits."""
    rng = np.random.default_rng(8)
    x, c, src, adds = _operands(rng, 6, 4, 40)
    xs = x[:, None] if x_dim is not None else x[:1]
    cs = c[:, None] if c_dim is not None else c[:1]
    if x_dim == 1:
        xs, cs = xs.movedim(0, 1), cs.movedim(0, 1)
    calls = []
    monkeypatch.setattr(ops, "spine_f64",
                        lambda *a: calls.append(a) or spine_f64(*a))
    got = torch.func.vmap(lambda a, b: spine_op(a, b, src, adds),
                          in_dims=(x_dim, c_dim))(xs, cs)
    assert len(calls) == 1
    for r in range(6):
        xr = xs.movedim(x_dim, 0)[r] if x_dim is not None else xs
        cr = cs.movedim(c_dim, 0)[r] if c_dim is not None else cs
        assert torch.equal(got[r], spine_f64(xr, cr, src, adds))


def test_op_refuses_what_it_does_not_take():
    rng = np.random.default_rng(9)
    x, c, src, adds = _operands(rng, 3, 2, 40)
    with pytest.raises(ValueError, match="float64"):
        spine_f64(x.float(), c, src, adds)
    with pytest.raises(ValueError, match="neither is 1"):
        spine_f64(x, c[:2], src, adds)
    with pytest.raises(ValueError, match="words"):
        spine_f64(x, c, src, adds[:1])
    with pytest.raises(ValueError, match="int32"):
        spine_f64(x, c, src.long(), adds)


def test_pack_adds_bit_order():
    flags = np.arange(70) % 3 == 0
    words = pack_adds(flags).view(np.uint32)
    assert len(words) == 3
    assert [bool(words[l >> 5] >> (l & 31) & 1) for l in range(70)] == list(
        flags)
