"""Compiled / batched inference (serving mode): the twin of genfer_tpu's
``compile.py`` over torch.

A *parameterized* SGCL program (``$name`` placeholders in probability
positions) is translated once into a GF DAG over **symbolic** constants,
and each entry point walks that DAG over a parameter tensor:

    from genfer_tpu_torch.compile import compile_program
    c = compile_program(\"\"\"
        calls ~ Poisson(10);
        scams ~ Binomial(calls, $p);
        observe(scams = 1);
        return calls;
    \"\"\", params=["p"], limit=26, device=None)   # None: the CUDA card
    probs = c.probs(torch.tensor([0.2]))            # one dataset
    batch = c.probs_batch(torch.tensor([[0.1], [0.2], [0.3]]))

The JAX package traces the walk once under ``jit`` and batches it with
``vmap``.  Here ``jax.vmap`` becomes ``torch.func.vmap`` (K1 reaches it
through its custom op, ``ops.conv2d_f64.k1_op``, whose vmap rule makes
one launch a vmapped product), and ``jit`` becomes a CUDA graph: on the
card each entry point is captured once per parameter shape, after one
eager warm-up walk, and replayed on a static parameter buffer (the
output is cloned).  Torch would otherwise re-walk the whole DAG in Python
on every call.  Every constant the walk makes (literals, factor vectors,
the moments' Stirling matrix) comes from a cache on the program that the
warm-up walk fills, so the captured walk copies nothing from the host; a
capture that fails raises (there is no eager path on the card).  On the
CPU (``device="cpu"``) each call walks the DAG eagerly.

A constant spine of the DAG (``gf/ir.py::GenFun._eval``: a tower of Add
/ Mul nodes with one constant-only operand each, as a chain of
observations of constant probability makes) of at least
``SPINE_MIN_LINKS`` links is applied in one launch of
``ops.spine_f64`` (``TracedF64Backend.eval_spine``), its links' constants
made a template at a time: the 784-pixel naive-Bayes model's 15,680 links
take 10 launches of it and ~30 others, not ~46,000, with the loop's bits.

Every walk runs on a thread with a large stack (``_translate_big_stack``):
deep observation chains such as the 784-pixel naive-Bayes model recurse
past the default limit.

``while`` loops compile through the same unrolling as the CLI; the mass
left in unfinished iterations is ``rest_bound(params)``.  A program whose
walk must read a traced value on the host (a multi-axis division, exp or
log checks finiteness and its leading coefficient there) raises, as it
does under genfer_tpu's ``jit``.

Limitations (as genfer_tpu's): f64 only, the result variable must be
discrete for ``probs``, observation outcomes are structural constants.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from . import trace
from .gf.symbolic import SymGenFun
from .lang import ast
from .lang.parser import parse_program
from .numbers.scalar import F64
from .ops.conv2d_f64 import k1_op
from .ops.spine_f64 import pack_adds, spine_op
from .semantics.gf_transformer import GfTransformer
from .taylor.backend import TorchF64Backend, _conv_impl, _resolve_device
from .taylor.host import _norm_shape
from .taylor.tensorpoly import TaylorPoly
from .taylor.xp import TorchNamespace


# ----------------------------------------------------------------------
# symbolic host scalars over named parameters
# ----------------------------------------------------------------------

def make_param_scalar(param_names: Sequence[str]):
    """Create a host-scalar class whose values are closed-form expressions
    over the named parameters (implemented on SymGenFun nodes over F64
    literals)."""
    index = {name: i for i, name in enumerate(param_names)}

    class ParamScalar:
        __slots__ = ("expr",)
        _param_index = index
        #: not an exact ring: the IR's constant-folding smart constructors
        #: must not re-associate symbolic parameter expressions
        EXACT_RING = False

        def __init__(self, expr: SymGenFun):
            self.expr = expr

        # -- constructors ---------------------------------------------
        #: literal/param scalars are interned so that equal values are
        #: the *same object*: the GF evaluation cache keys inputs by
        #: hash/identity, and fresh zero()/one() objects per lookup
        #: (e.g. from TaylorCoeffAtZero rebuilding its input vector)
        #: would miss the cache and turn shared-DAG evaluation
        #: exponential (the 10-way class split of the naive-Bayes model
        #: evaluated 2^10 times instead of 10)
        _interned: dict = {}

        @classmethod
        def _lit(cls, v: float):
            key = ("lit", v)
            hit = cls._interned.get(key)
            if hit is None:
                hit = cls._interned[key] = cls(SymGenFun.lit(F64, F64(v)))
            return hit

        @classmethod
        def zero(cls):
            return cls._lit(0.0)

        @classmethod
        def one(cls):
            return cls._lit(1.0)

        @classmethod
        def from_u32(cls, n: int):
            return cls._lit(float(n))

        @classmethod
        def from_ratio(cls, numer: int, denom: int):
            x = F64.from_ratio(numer, denom)
            return cls(SymGenFun.lit(F64, x))

        @classmethod
        def param(cls, name: str):
            if name not in index:
                raise KeyError(
                    f"program uses undeclared parameter ${name}; "
                    f"declared: {list(index)}"
                )
            key = ("param", name)
            hit = cls._interned.get(key)
            if hit is None:
                hit = cls._interned[key] = cls(
                    SymGenFun.var_(F64, index[name])
                )
            return hit

        # -- predicates (literal-only; conservative) --------------------
        def is_zero(self):
            return self.expr.is_lit_zero()

        def is_one(self):
            return self.expr.is_lit_one()

        def is_nan(self):
            return False

        # -- arithmetic --------------------------------------------------
        def __add__(self, other):
            return ParamScalar(self.expr + other.expr)

        def __sub__(self, other):
            return ParamScalar(self.expr - other.expr)

        def __neg__(self):
            return ParamScalar(-self.expr)

        def __mul__(self, other):
            return ParamScalar(self.expr * other.expr)

        def __truediv__(self, other):
            return ParamScalar(self.expr / other.expr)

        def exp(self):
            return ParamScalar(self.expr.exp())

        def log(self):
            return ParamScalar(self.expr.log())

        def pow_u32(self, n: int):
            return ParamScalar(self.expr.pow_u32(n))

        def maximum(self, other):
            return ParamScalar(self.expr.maximum(other.expr))

        def display(self):
            return str(self.expr)

        __str__ = display

        def __repr__(self):
            return f"ParamScalar({self.expr})"

    return ParamScalar


def _integer_pow(x, n: int):
    """``x ** n`` for an int ``n >= 1`` by binary powering, in the order of
    XLA's ``integer_pow`` (what genfer_tpu's ``x ** n`` lowers to)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _eval_sym(expr: SymGenFun, params, cache: dict, const):
    """Evaluate a SymGenFun over torch values (``params`` is the parameter
    vector; ``const(v)`` makes the f64 constant ``v`` on its device)."""
    key = id(expr)
    hit = cache.get(key)
    if hit is not None and hit[0] is expr:
        return hit[1]

    def sub(e):
        return _eval_sym(e, params, cache, const)

    k = expr.kind
    if k == "Variable":
        out = params[expr.var]
    elif k == "Lit":
        out = const(expr.value.v)
    elif k == "Add":
        out = sub(expr.a) + sub(expr.b)
    elif k == "Mul":
        out = sub(expr.a) * sub(expr.b)
    elif k == "Div":
        out = sub(expr.a) / sub(expr.b)
    elif k == "Exp":
        out = torch.exp(sub(expr.a))
    elif k == "Log":
        out = torch.log(sub(expr.a))
    elif k == "Pow":
        out = (torch.ones_like(sub(expr.a)) if expr.n == 0
               else _integer_pow(sub(expr.a), expr.n))
    elif k == "Max":
        out = torch.maximum(sub(expr.a), sub(expr.b))
    else:
        raise AssertionError(k)
    cache[key] = (expr, out)
    return out


#: the spans of ``GraphedEntry.capture`` that name a walk's phase
_PHASES = {"entry.warmup": "warmup", "entry.capture": "capture"}


# ----------------------------------------------------------------------
# constant spines in one launch (TracedF64Backend.eval_spine)
# ----------------------------------------------------------------------

#: a spine of fewer links keeps the link-by-link loop: the fused path
#: launches a gather and an elementwise op or two a constant template, one
#: concatenation and the kernel, so it saves launches only past that many
#: links (the loop launches one to six a link)
SPINE_MIN_LINKS = 8


def _sym_template(expr, slots: list):
    """``_eval_sym``'s operations on ``expr`` with its leaves abstracted:
    a nested tuple whose leaves are ``("param",)`` and ``("lit",)``, their
    values appended to ``slots`` in evaluation order; None where an
    ``Exp`` or ``Log`` is met (torch's vectorized exp and log on the CPU
    may round other than on one element)."""
    k = expr.kind
    if k == "Variable":
        slots.append(("param", expr.var))
        return ("param",)
    if k == "Lit":
        slots.append(("lit", expr.value.v))
        return ("lit",)
    if k == "Pow":
        a = _sym_template(expr.a, slots)
        return None if a is None else ("Pow", expr.n, a)
    if k in ("Add", "Mul", "Div", "Max"):
        a = _sym_template(expr.a, slots)
        b = _sym_template(expr.b, slots)
        return None if a is None or b is None else (k, a, b)
    return None


def _const_template(node, scalar_cls, slots: list):
    """(host constant, template) of a constant-only subtree (``Const``
    leaves under ``Add`` / ``Mul`` / ``Neg``) as ``TaylorPoly`` evaluates
    it: the same host constant, and the elementwise operations that make
    its value, ``Mul``'s zero and one fast paths taken on the host
    constants as ``TaylorPoly.__mul__`` takes them.  The template is a
    nested tuple over ``_sym_template``'s leaves, ``("zero",)``,
    ``("neg", a)`` and the kinds ``Add``, ``Mul``; None where a leaf has
    none (its slots are then meaningless)."""
    k = node.kind
    if k == "Const":
        x = node.value
        if hasattr(x, "expr"):
            return x, _sym_template(x.expr, slots)
        slots.append(("lit", x.v if isinstance(x, F64) else float(x)))
        return x, ("lit",)
    if k == "Neg":
        hc, t = _const_template(node.args[0], scalar_cls, slots)
        return -hc, None if t is None else ("neg", t)
    sa, sb = [], []
    ha, ta = _const_template(node.args[0], scalar_cls, sa)
    hb, tb = _const_template(node.args[1], scalar_cls, sb)
    if k == "Mul":
        if ha.is_zero() or hb.is_zero():
            return scalar_cls.zero(), ("zero",)
        if ha.is_one():
            slots.extend(sb)
            return hb, tb
        if hb.is_one():
            slots.extend(sa)
            return ha, ta
    slots.extend(sa)
    slots.extend(sb)
    hc = ha + hb if k == "Add" else ha * hb
    return hc, None if ta is None or tb is None else (k, ta, tb)


def _eval_template(t, slots, zeros):
    """The vector of a template's values, its slots' vectors taken in
    order from the iterator ``slots``; ``zeros()`` is the zero vector."""
    k = t[0]
    if k in ("param", "lit"):
        return next(slots)
    if k == "zero":
        return zeros()
    if k == "neg":
        return -_eval_template(t[1], slots, zeros)
    if k == "Pow":
        x = _eval_template(t[2], slots, zeros)
        return torch.ones_like(x) if t[1] == 0 else _integer_pow(x, t[1])
    a = _eval_template(t[1], slots, zeros)
    b = _eval_template(t[2], slots, zeros)
    if k == "Add":
        return a + b
    if k == "Mul":
        return a * b
    if k == "Div":
        return a / b
    return torch.maximum(a, b)


class _ConstantNamespace(TorchNamespace):
    """``TorchNamespace`` whose ``asarray`` serves each distinct constant
    from ``cache`` (a dict the program owns): the first walk copies it to
    the device, every later walk, a captured one included, reuses that
    tensor.  Nothing writes into a tensor ``asarray`` returns.  Each copy
    counts in ``walk.constants_copied`` by the walk's phase (``warmup``,
    ``capture``, or ``eager`` outside a capture)."""

    def __init__(self, device, cache: dict):
        super().__init__(device)
        self.cache = cache

    def asarray(self, x, dtype=None):
        arr = np.array(x)
        key = (dtype, arr.dtype.str, arr.shape, arr.tobytes())
        hit = self.cache.get(key)
        if hit is None:
            hit = self.cache[key] = super().asarray(arr, dtype)
            if trace.on:
                trace.count("walk.constants_copied", phase=_PHASES.get(
                    trace.enclosing(_PHASES), "eager"))
        return hit


class TracedF64Backend(TorchF64Backend):
    """f64 backend for the compiled walk: host "scalars" are symbolic
    parameter expressions evaluated against the parameter tensor (batched
    under ``torch.func.vmap``), constants come from the program's cache,
    2-axis products go through K1's custom op.  Marked non-concrete so the
    engine never materializes device values into host constants
    (tensorpoly._materialize_const); reading a value on the host raises,
    as a traced value does under genfer_tpu's ``jit``."""

    concrete = False

    def __init__(self, params, param_scalar_cls, device, constants: dict):
        super().__init__(device)
        self.jnp = _ConstantNamespace(self.device, constants)
        self.params = params
        self.scalar_cls = param_scalar_cls
        self._sym_cache: dict = {}

    def _const(self, v: float):
        return self.jnp.asarray(v, dtype=self.dtype)

    def scalar(self, x):
        if isinstance(x, F64):
            return self._const(x.v)
        if hasattr(x, "expr"):
            return _eval_sym(x.expr, self.params, self._sym_cache,
                             self._const)
        return self._const(float(x))

    def to_host(self, arr0d):
        raise AssertionError(
            "compiled mode cannot lower traced values to host scalars"
        )

    def _all_finite(self, arr) -> bool:
        raise TypeError(
            "compiled mode cannot read a traced value on the host (a "
            "multi-axis div, exp or log checks its operand there)"
        )

    def from_nested(self, nested):
        def build(n):
            if isinstance(n, (list, tuple)):
                return [build(x) for x in n]
            return self.scalar(n)

        def stack(n):
            if isinstance(n, list):
                return self.jnp.stack([stack(x) for x in n])
            return n

        return stack(build(nested))

    def scale_axis(self, arr, axis, factors):
        if any(hasattr(x, "expr") for x in factors):
            f = self.jnp.stack([self.scalar(x) for x in factors])
        else:  # one cached vector (the same values as the stack)
            f = self.jnp.asarray(
                [x.v if isinstance(x, F64) else float(x) for x in factors],
                dtype=self.dtype)
        shape = [1] * arr.ndim
        shape[axis] = len(factors)
        return arr * f.reshape(shape)

    def conv_trunc(self, a, b, out_shape):
        return _conv_impl(a, b, _norm_shape(out_shape), conv2d=k1_op)

    def eval_spine(self, base, links, constant):
        """A spine of at least ``SPINE_MIN_LINKS`` links in one launch of
        ``ops.spine_f64``: each link's constant is made by its template
        (``_const_template``), a template's links together, a gather of
        the parameters and its elementwise ops over the gathered vectors
        (a link whose template has an ``Exp`` or ``Log`` by ``constant``,
        one by one).  The host constants, ``linear`` and ``const0`` follow
        ``TaylorPoly``'s ``G * c`` and ``G + c`` link by link, and so do
        its fast paths: a ``Mul`` by a host constant one is skipped; one
        that would make the series zero, or take the constant's place,
        leaves the whole spine to the loop.  The result equals the loop's
        in every field; counted in ``walk.spines_fused`` {links, phase}."""
        if len(links) < SPINE_MIN_LINKS:
            return super().eval_spine(base, links, constant)
        loop = functools.partial(super().eval_spine, base, links, constant)
        constant_base = base.is_constant()
        ghc, lin, c0 = base.host_const, base.linear, base.const0
        fused = []  # is_add, a link the kernel applies
        groups: dict = {}  # template -> [(position, slots)]
        opaque = []  # (position, node)
        for op, node, left in links:
            slots: list = []
            hc, t = _const_template(node, self.scalar_cls, slots)
            if op == "Mul":
                if hc.is_zero() or constant_base and ghc is not None and (
                        ghc.is_zero() or ghc.is_one()):
                    return loop()
                if hc.is_one():
                    continue
                # a constant series on the left keeps no linear form
                lin = (None if lin is None or constant_base and not left
                       else (hc * lin[0], hc * lin[1], lin[2]))
                if ghc is not None:
                    ghc = hc * ghc if left else ghc * hc
                if c0 is not None:
                    c0 = hc * c0 if left else c0 * hc
            else:
                if lin is not None:
                    lin = (lin[0] + hc, lin[1], lin[2])
                if ghc is not None:
                    ghc = hc + ghc if left else ghc + hc
                if c0 is not None:
                    c0 = hc + c0 if left else c0 + hc
            if c0 is None:  # TaylorPoly's constructor
                c0 = ghc if ghc is not None else (
                    None if lin is None else lin[0])
            if t is None:
                opaque.append((len(fused), node))
            else:
                groups.setdefault(t, []).append((len(fused), slots))
            fused.append(op == "Add")
        if len(fused) < SPINE_MIN_LINKS:
            return loop()
        xp, dt = self.jnp, self.dtype
        parts, src = [], np.zeros(len(fused), dtype=np.int32)
        made = 0  # constants in ``parts``
        for t, members in groups.items():
            cols = []
            for col in zip(*(slots for _, slots in members)):
                values = [v for _, v in col]
                if col[0][0] == "param":
                    cols.append(self.params[xp.asarray(
                        np.array(values, dtype=np.int64), dtype=torch.long)])
                else:
                    cols.append(xp.asarray(values, dtype=dt))
            n = len(members)
            src[[pos for pos, _ in members]] = made + np.arange(n)
            made += n
            parts.append(_eval_template(
                t, iter(cols), lambda: xp.asarray(np.zeros(n), dtype=dt)))
        if opaque:
            src[[pos for pos, _ in opaque]] = made + np.arange(len(opaque))
            parts.append(torch.stack(
                [constant(node).coeffs.reshape(()) for _, node in opaque]))
        consts = parts[0] if len(parts) == 1 else torch.cat(parts)
        coeffs = spine_op(base.coeffs.reshape(1, -1), consts.reshape(1, -1),
                          xp.asarray(src, dtype=torch.int32),
                          xp.asarray(pack_adds(fused), dtype=torch.int32))
        if trace.on:
            trace.count("walk.spines_fused", links=len(links),
                        phase=_PHASES.get(trace.enclosing(_PHASES), "eager"))
        return TaylorPoly(self, coeffs.reshape(base.coeffs.shape),
                          base.degrees_p1, host_const=ghc, linear=lin,
                          const0=c0)


def _translate_big_stack(work, stack_mb: int = 256,
                         limit: int = 100_000):
    """Run ``work`` on a dedicated thread with a large stack and a
    scoped recursion limit (mirrors cli.main / reference main.rs:96-106);
    restores the process-wide limit afterwards.  ``work``'s spans nest in
    the span open around the call (``trace.carry``)."""
    import sys
    import threading

    out: list = []
    work = trace.carry(work)

    def runner():
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, limit))
        try:
            out.append(("ok", work()))
        except BaseException as e:
            out.append(("err", e))
        finally:
            sys.setrecursionlimit(old)

    threading.stack_size(stack_mb * 1024 * 1024)
    try:
        t = threading.Thread(target=runner)
        t.start()
        t.join()
    finally:
        threading.stack_size(0)
    kind, val = out[0]
    if kind == "err":
        raise val
    return val


def _clone(out):
    if isinstance(out, tuple):
        return tuple(_clone(x) for x in out)
    return out.clone()


#: ``CUgraphNodeType`` values (``cuda.h``) the counts name; the rest are
#: ``other``
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(raw: int) -> Counter:
    """The nodes of the CUDA graph ``raw`` (a ``cudaGraph_t``, as
    ``CUDAGraph.raw_cuda_graph()`` gives it) by kind: ``kernel``,
    ``memcpy``, ``memset``, ``other``; read through ``libcuda``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]

    def check(err):
        if err != 0:
            raise RuntimeError(f"libcuda error {err} reading a graph")

    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)))
    kinds: Counter = Counter()
    kind = ctypes.c_int()
    for node in nodes[: n.value]:
        check(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)))
        kinds[_NODE_KINDS.get(kind.value, "other")] += 1
    return kinds


class GraphedEntry:
    """One entry point ``fn(*tensors)``, named ``name`` in the traces: on
    the CPU an eager call; on the card a CUDA graph for each set of
    argument shapes and types, captured after one eager warm-up call
    (which fills the constant caches, K1's plan tables and its library;
    ``eager`` with the same shapes counts as that call) and replayed on
    static argument buffers; the output is cloned.  Every call and the
    capture run on the big-stack thread, on the stream current there.  A
    failed capture raises.

    While a ``trace`` recording is open a call is the span ``entry.call``
    {entry, key} with the children ``entry.copy_in``, ``entry.replay``
    and ``entry.clone``, or ``entry.eager`` on the CPU; a capture adds
    ``entry.warmup`` and ``entry.capture`` (child ``entry.instantiate``)
    and counts the graph's nodes by kind in ``graph.nodes``;
    ``entry.captures`` and ``entry.replays`` count by key."""

    def __init__(self, fn, device: torch.device, name: str):
        self.fn = fn
        self.device = device
        self.name = name
        #: argument shapes and types -> (static inputs, CUDAGraph,
        #: static output)
        self.graphs: dict = {}
        #: the keys of ``graphs`` an eager call has warmed up
        self.warmed: set = set()

    def _args(self, args):
        return [torch.as_tensor(a, device=self.device) for a in args]

    @staticmethod
    def _key(args):
        return tuple((tuple(a.shape), a.dtype) for a in args)

    def __call__(self, *args):
        args = self._args(args)
        key = self._key(args)
        with trace.span("entry.call", new_call=True, entry=self.name,
                        key=key):
            if self.device.type != "cuda":
                with trace.span("entry.eager"):
                    return _translate_big_stack(lambda: self.fn(*args))
            if key not in self.graphs:
                self.graphs[key] = self.capture(args)
            static, graph, out = self.graphs[key]
            if trace.on:
                trace.count("entry.replays", entry=self.name, key=key)
            with trace.span("entry.copy_in"):
                for s, a in zip(static, args):
                    s.copy_(a)
            with trace.span("entry.replay"):
                graph.replay()
            with trace.span("entry.clone"):
                return _clone(out)

    def _warm_up(self, static) -> None:
        """One eager call on a side stream, then wait for the card."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn(*static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def capture(self, args):
        """Capture ``fn`` on copies of ``args``, after a warm-up call on a
        side stream unless ``eager`` warmed these shapes up: returns
        (static inputs, CUDAGraph, static output).  While a recording is
        open the graph is kept past its instantiation (``keep_graph``),
        which is then a span of its own, and its nodes are counted."""
        static = [a.clone() for a in args]
        key = self._key(args)
        warm = key not in self.warmed
        tag = {"entry": self.name, "key": key}
        trace.count("entry.captures", **tag)

        def work():
            if warm:
                with trace.span("entry.warmup", **tag):
                    self._warm_up(static)
            else:
                torch.cuda.synchronize(self.device)
            recorded = trace.on
            graph = (torch.cuda.CUDAGraph(keep_graph=True) if recorded
                     else torch.cuda.CUDAGraph())
            with trace.span("entry.capture", **tag):
                with torch.cuda.graph(graph):
                    out = self.fn(*static)
                if recorded:
                    with trace.span("entry.instantiate"):
                        graph.instantiate()
            if recorded:
                for kind, n in graph_nodes(graph.raw_cuda_graph()).items():
                    trace.count("graph.nodes", n, kind=kind, **tag)
            return graph, out

        graph, out = _translate_big_stack(work)
        self.warmed.add(key)
        return static, graph, out

    def eager(self, *args):
        """One eager call on ``device`` (what the graph replays)."""
        args = self._args(args)
        key = self._key(args)
        with trace.span("entry.eager", new_call=True, entry=self.name,
                        key=key):
            out = _translate_big_stack(lambda: self.fn(*args))
        self.warmed.add(key)
        return out


class CompiledProgram:
    """A parameterized SGCL program compiled for batched serving."""

    def __init__(self, source: str, params: Sequence[str], limit: int,
                 unroll: int = 8, device=None):
        self.device = _resolve_device(device)
        self.param_names = list(params)
        self.limit = limit
        SP = make_param_scalar(self.param_names)
        self.SP = SP
        with trace.span("compile.translate"):
            with trace.span("compile.parse"):
                self.program = parse_program(source)
            # deep observation chains (e.g. the 784-pixel naive-Bayes
            # model) nest the GF DAG deeper than the default recursion
            # limit.  Translate on a dedicated big-stack thread (like
            # cli.main): a raised recursion limit on a small-stack thread
            # would turn a catchable RecursionError into a hard C-stack
            # overflow, and the process-wide limit must not leak past the
            # constructor.
            with trace.span("compile.gf"):
                self.translation = _translate_big_stack(
                    lambda: GfTransformer(SP, unroll=unroll).semantics(
                        self.program
                    )
                )
        rest = self.translation.rest
        self.has_rest = not (
            rest.kind == "Const" and rest.value.is_zero()
        )
        self.var_info = self.translation.var_info
        self.num_vars = self.var_info.num_vars()
        self.result = self.program.result
        assert self.var_info[self.result].is_discrete(), (
            "probs require a discrete result variable"
        )
        #: the walks' constants on ``device`` (``_ConstantNamespace``)
        self.constants: dict = {}
        vmap = torch.func.vmap
        dev = self.device
        self._probs = GraphedEntry(self._probs_impl, dev, "probs")
        self._moments = GraphedEntry(self._moments_impl, dev, "moments")
        self._probs_batch = GraphedEntry(vmap(self._probs_impl), dev,
                                         "probs_batch")
        self._moments_batch = GraphedEntry(vmap(self._moments_impl), dev,
                                           "moments_batch")
        self._rest = GraphedEntry(self._rest_impl, dev, "rest")
        self._rest_batch = GraphedEntry(vmap(self._rest_impl), dev,
                                        "rest_batch")

    # -- traced pipelines ------------------------------------------------
    def _backend(self, params):
        return TracedF64Backend(params, self.SP, self.device,
                                self.constants)

    def _eval_expansion(self, params, substs_hint, degree):
        backend = self._backend(params)
        SP = self.SP
        substs = []
        for i in range(self.num_vars):
            if i == self.result and substs_hint == "probs":
                substs.append(SP.zero())
            elif self.var_info[i].is_discrete():
                substs.append(SP.one())
            else:
                substs.append(SP.zero())
        expansion = self.translation.gf.eval(backend, substs, degree)
        return expansion

    def _coeff_vector(self, expansion, length):
        arr = expansion.coeffs
        # index 0 on every axis except the result variable's
        ndim = arr.ndim
        for axis in reversed(range(ndim)):
            if axis != self.result:
                arr = arr.select(axis, 0)
        if self.result >= ndim:
            arr = arr.reshape(1)
        vec = arr.reshape(-1)[: length]
        if vec.shape[0] < length:
            vec = torch.nn.functional.pad(vec, (0, length - vec.shape[0]))
        return vec

    def _rest_impl(self, params):
        """Upper bound on the probability mass lost to unfinished while
        iterations (reference rest handling, main.rs:171-173): the rest
        GF evaluated at the all-zero point to degree 1."""
        backend = self._backend(params)
        if not self.has_rest:
            return backend.jnp.zeros(())
        SP = self.SP
        substs = [SP.zero() for _ in range(self.num_vars)]
        expansion = self.translation.rest.eval(backend, substs, 1)
        arr = expansion.coeffs
        return arr.reshape(-1)[0]

    def _probs_impl(self, params):
        expansion = self._eval_expansion(params, "probs", self.limit + 1)
        return self._coeff_vector(expansion, self.limit)

    def _moments_impl(self, params):
        expansion = self._eval_expansion(params, "moments", 5)
        coeffs = self._coeff_vector(expansion, 5)
        xp = self._backend(params).jnp
        factorials = xp.asarray([1.0, 1.0, 2.0, 6.0, 24.0])
        fm = coeffs * factorials  # factorial moments
        # Stirling transform (reference generating_function.rs:1008-1033)
        S = np.zeros((5, 5))
        for n in range(5):
            S[n][n] = 1.0
            for kk in range(1, n):
                S[n][kk] = S[n - 1][kk - 1] + kk * S[n - 1][kk]
        total = fm[0]
        raw = (xp.asarray(S) @ fm)[1:] / total
        return total, raw

    # -- public API --------------------------------------------------------
    # ``params``: a vector of the declared parameters (``params_batch``: a
    # matrix, one vector a row), any array or tensor, taken as f64 on
    # ``device``; results are tensors on ``device``
    @staticmethod
    def _f64(params):
        return torch.as_tensor(params, dtype=torch.float64)

    def probs(self, params, normalized: bool = False):
        """Unnormalized (or normalized) posterior masses p(0..limit-1)."""
        out = self._probs(self._f64(params))
        if normalized:
            total, _ = self._moments(self._f64(params))
            return out / total
        return out

    def probs_batch(self, params_batch, normalized: bool = False):
        out = self._probs_batch(self._f64(params_batch))
        if normalized:
            totals, _ = self._moments_batch(self._f64(params_batch))
            return out / totals[:, None]
        return out

    def moments(self, params):
        """(total Z, raw moments 1..4 normalized by Z)."""
        return self._moments(self._f64(params))

    def moments_batch(self, params_batch):
        return self._moments_batch(self._f64(params_batch))

    def rest_bound(self, params):
        """Mass not accounted for by unrolled while iterations: probs are
        exact lower bounds, probs + rest_bound upper bounds."""
        return self._rest(self._f64(params))

    def rest_bound_batch(self, params_batch):
        return self._rest_batch(self._f64(params_batch))


def _has_while(stmts) -> bool:
    for s in stmts:
        if isinstance(s, ast.While):
            return True
        for attr in ("then", "els", "body", "stmts"):
            sub = getattr(s, attr, None)
            if sub and _has_while(sub):
                return True
    return False


@functools.lru_cache(maxsize=None)
def _compile_cached(source: str, params: tuple, limit: int, unroll: int,
                    device: torch.device):
    return CompiledProgram(source, list(params), limit, unroll, device)


def compile_program(source: str, params: Sequence[str], limit: int,
                    unroll: int = 8, device=None) -> CompiledProgram:
    """``CompiledProgram`` on ``device`` (``None``: the CUDA card, which
    must exist; ``"cpu"``: eager walks on the host), cached per
    arguments."""
    return _compile_cached(source, tuple(params), limit, unroll,
                           _resolve_device(device))
