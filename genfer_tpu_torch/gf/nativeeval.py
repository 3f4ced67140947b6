"""Native GF-DAG evaluation: flatten a GenFun DAG to the node-table form
consumed by the C++ evaluator (genfer_tpu_torch._evaltape) and wrap its result
back into a TaylorPoly.

The native evaluator mirrors GenFun.eval_with/_eval and the TaylorPoly
op set for the NumpyF64Backend exactly (same demand targets, same
fast-path selection); see csrc/host/evaltape.cpp.  Anything outside the
mirrored surface — non-F64 scalars, dynamic ShiftTaylorAtZero rewrites,
multivariate div/exp/log Newton paths — raises ``_evaltape.Unsupported``
at flatten or run time, and the caller falls back to the Python
interpreter (identical semantics, reference gf.rs parity path).

Enabled by default on the NumpyF64Backend and on the Hybrid/Pallas
backends (whose host semantics are identical; evaluations that reach a
conv above their accelerator-offload threshold bail back to the Python
path so big products still offload); ``GENFER_NATIVE_EVAL=0`` disables
it, ``GENFER_NATIVE_EVAL=check`` runs both evaluators and cross-checks
the results (used by the test suite).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..numbers.scalar import F64

from .._host_build import load_extension

_evaltape = load_extension("_evaltape")  # None: native extension not built

def _mode() -> str:
    # read per eval() call (a handful per inference) so tests can toggle
    # modes with monkeypatch.setenv without reimporting the package
    return os.environ.get("GENFER_NATIVE_EVAL", "1")


# 256 MB, not "as much as fits": on the deployment microVM a fresh page
# costs ~25 us to fault in (userfault-backed memory, measured 0.13 GB/s
# first-touch), so a large retained memo trades negligible recompute for
# massive kernel time — mixture: 4096 MB budget = 43 s wall / 36 s sys,
# 256 MB = 7 s wall / 0.4 s sys, identical output.  The other heavy
# goldens are insensitive to the cut (hmm / digitRecognition / both
# switchpoints measured identical wall at 256 vs 4096 MB — their live
# sets fit either way); on a conventional host with cheap first-touch a
# larger GENFER_NATIVE_EVAL_BUDGET_MB only helps if a profile shows
# memo-miss recompute, which none of the committed corpus exhibits.
_BUDGET_MB = int(os.environ.get("GENFER_NATIVE_EVAL_BUDGET_MB", "256"))

# kind codes (must match the Kind enum in native/evaltape_eval.inc)
_KIND_CODE = {
    "Var": 0,
    "Const": 1,
    "Add": 2,
    "Neg": 3,
    "Mul": 4,
    "Div": 5,
    "Polynomial": 6,
    "Exp": 7,
    "Log": 8,
    "Pow": 9,
    "UniformMgf": 10,
    "Subst": 11,
    "Derivative": 12,
    "TaylorPolynomial": 13,
    "TaylorCoeffAtZero": 14,
    "TaylorCoeff": 15,
    "ShiftTaylorAtZero": 16,
    "Max": 17,
}


class _Flat:
    __slots__ = (
        "root_obj", "n", "kinds", "arg0", "arg1", "var", "order", "value",
        "uv", "rec_kind", "rec_var", "rec_lam", "rec_inner", "bypassed",
        "extras", "root_id",
    )


class _UnsupportedDag(Exception):
    pass


def _flatten(root) -> _Flat:
    """Iterative post-order flatten of the GenFun DAG (children first).

    Recognizes the three observation-optimizer patterns at the
    TaylorCoeffAtZero nodes (reference generating_function.rs:840-914 via
    gf/ir.py recognizers) so the C++ evaluator can run the fused chains,
    and marks the recognized Subst children as demand-bypassed exactly
    like _EvalCache's propagation does.
    """
    from .ir import (
        CONST, POLYNOMIAL, TAYLOR_COEFF_AT_ZERO, TAYLOR_POLYNOMIAL,
        _recognize_continuous_poisson_observation,
        _recognize_discrete_poisson_observation,
        _recognize_negative_binomial_observation,
    )

    ids: dict = {}  # id(node) -> (node, index)
    order_nodes: list = []
    stack = [(root, False)]
    while stack:
        node, done = stack.pop()
        ent = ids.get(id(node))
        if ent is not None and ent[0] is node:
            continue
        if done:
            ids[id(node)] = (node, len(order_nodes))
            order_nodes.append(node)
            continue
        stack.append((node, True))
        for c in node.args:
            e = ids.get(id(c))
            if e is None or e[0] is not c:
                stack.append((c, False))
    n = len(order_nodes)
    f = _Flat()
    f.root_obj = (root, order_nodes)  # pin every node: ids are id()-keyed
    f.n = n
    f.kinds = np.zeros(n, dtype=np.int32)
    f.arg0 = np.full(n, -1, dtype=np.int32)
    f.arg1 = np.full(n, -1, dtype=np.int32)
    f.var = np.full(n, -1, dtype=np.int32)
    f.order = np.zeros(n, dtype=np.int64)
    f.value = np.zeros(n, dtype=np.float64)
    f.uv = np.zeros(n, dtype=np.int32)
    f.rec_kind = np.zeros(n, dtype=np.int32)
    f.rec_var = np.full(n, -1, dtype=np.int32)
    f.rec_lam = np.zeros(n, dtype=np.float64)
    f.rec_inner = np.full(n, -1, dtype=np.int32)
    f.bypassed = np.zeros(n, dtype=np.int32)
    f.extras = []
    for i, node in enumerate(order_nodes):
        code = _KIND_CODE.get(node.kind)
        if code is None:
            raise _UnsupportedDag(f"unknown kind {node.kind}")
        f.kinds[i] = code
        args = node.args
        if len(args) > 2:
            raise _UnsupportedDag("node with >2 args")
        if len(args) >= 1:
            f.arg0[i] = ids[id(args[0])][1]
        if len(args) == 2:
            f.arg1[i] = ids[id(args[1])][1]
        if node.var is not None:
            f.var[i] = node.var
        if node.order is not None and node.kind != POLYNOMIAL:
            f.order[i] = node.order
        f.uv[i] = node.used_vars()
        if node.kind == CONST:
            v = node.value
            if not isinstance(v, F64):
                raise _UnsupportedDag("non-F64 constant")
            f.value[i] = v.v
        elif node.kind == POLYNOMIAL:
            arr = _nested_to_f64(node.poly)
            f.extras.append((i, 0, arr, tuple(arr.shape)))
        elif node.kind == TAYLOR_POLYNOMIAL:
            f.extras.append((i, 1, tuple(int(o) for o in node.orders)))
        elif node.kind == TAYLOR_COEFF_AT_ZERO:
            g = args[0]
            rec = _recognize_discrete_poisson_observation(g, node.var)
            rk = 1
            if rec is None:
                rec = _recognize_continuous_poisson_observation(g, node.var)
                rk = 2
            if rec is None:
                rec = _recognize_negative_binomial_observation(g, node.var)
                rk = 3
            if rec is not None:
                param_var, lam, inner = rec
                if not isinstance(lam, F64):
                    raise _UnsupportedDag("non-F64 optimizer rate")
                f.rec_kind[i] = rk
                f.rec_var[i] = param_var
                f.rec_lam[i] = lam.v
                f.rec_inner[i] = ids[id(inner)][1]
                f.bypassed[ids[id(g)][1]] = 1
    f.root_id = ids[id(root)][1]
    return f


def _nested_to_f64(nested) -> np.ndarray:
    def build(x):
        if isinstance(x, (list, tuple)):
            return [build(e) for e in x]
        if isinstance(x, F64):
            return x.v
        if isinstance(x, (int, float)):
            return float(x)
        raise _UnsupportedDag("non-F64 polynomial coefficient")

    return np.ascontiguousarray(np.asarray(build(nested), dtype=np.float64))


# flatten cache: id-keyed, stores the root object to pin its id (Python
# reuses ids of collected objects)
_FLAT_CACHE: dict = {}
_FLAT_CACHE_MAX = 64


def _get_flat(root):
    ent = _FLAT_CACHE.get(id(root))
    if ent is not None and ent[0] is root:
        return ent[1]
    try:
        flat = _flatten(root)
    except _UnsupportedDag:
        flat = None
    if len(_FLAT_CACHE) >= _FLAT_CACHE_MAX:
        _FLAT_CACHE.clear()
    _FLAT_CACHE[id(root)] = (root, flat)
    return flat


def native_eval_enabled(backend) -> bool:
    if _evaltape is None or _mode() == "0":
        return False
    if os.environ.get("GENFER_NO_DEMAND"):
        return False  # debug mode evaluates at exact requested degrees
    from ..taylor.backend import HybridBackend, PallasBackend
    from ..taylor.host import NumpyF64Backend

    # Hybrid/Pallas keep numpy host semantics and offload only convs
    # above a flop threshold: the tape runs them too, bailing out (via
    # max_conv_flops) when an evaluation reaches an op the backend
    # would offload, so big-order work still lands on the accelerator
    return (type(backend) in (NumpyF64Backend, HybridBackend,
                              PallasBackend)
            and backend.scalar_cls is F64)


def _offload_threshold(backend) -> float:
    from ..taylor.backend import HybridBackend

    if isinstance(backend, HybridBackend):
        thr = float(backend.CONV_OFFLOAD_FLOPS)
        pal = getattr(backend, "PALLAS_OFFLOAD_FLOPS", None)
        if pal is not None:
            thr = min(thr, float(pal))
        return thr
    return 0.0


def try_native_eval(root, backend, inputs, demand) -> Optional["TaylorPoly"]:
    """Run the native evaluator; None => caller uses the Python path."""
    from ..taylor.tensorpoly import INF_DEGREE, TaylorPoly

    if not native_eval_enabled(backend):
        return None
    if not all(isinstance(x, F64) for x in inputs):
        return None
    flat = _get_flat(root)
    if flat is None:
        return None
    axes = np.asarray(
        [-1 if a == INF_DEGREE else int(a) for a in demand.axes],
        dtype=np.int64,
    )
    uni = -1 if demand.uni == INF_DEGREE else int(demand.uni)
    inp = np.asarray([x.v for x in inputs], dtype=np.float64)
    try:
        data, shape, deg, meta = _evaltape.eval(
            flat.n, flat.kinds, flat.arg0, flat.arg1, flat.var, flat.order,
            flat.value, flat.uv, flat.rec_kind, flat.rec_var, flat.rec_lam,
            flat.rec_inner, flat.bypassed, flat.root_id, flat.extras, inp,
            axes, uni, _BUDGET_MB * 1024 * 1024, 0,
            _offload_threshold(backend),
        )
    except _evaltape.Unsupported:
        return None
    arr = np.frombuffer(data, dtype=np.float64).reshape(shape).copy()
    degrees = tuple(INF_DEGREE if d < 0 else d for d in deg)
    has_c0, c0, has_hc, hc = meta
    result = TaylorPoly(
        backend, arr, degrees,
        host_const=F64(hc) if has_hc else None,
        const0=F64(c0) if has_c0 else None,
    )
    if _mode() == "check":
        ref = _python_eval(root, backend, inputs, demand)
        _cross_check(result, ref)
    return result


def _python_eval(root, backend, inputs, demand):
    from .ir import _EvalCache

    return root.eval_with(
        backend, list(inputs), demand, _EvalCache(root, demand)
    )


def _cross_check(native, ref):
    assert native.degrees_p1 == ref.degrees_p1, (
        f"native eval degrees {native.degrees_p1} != {ref.degrees_p1}"
    )
    a = np.asarray(native.coeffs)
    b = np.asarray(ref.coeffs)
    assert a.shape == b.shape, f"native eval shape {a.shape} != {b.shape}"
    if a.size:
        scale = np.max(np.abs(b)) or 1.0
        diff = np.max(np.abs(a - b))
        assert diff <= 1e-9 * scale or np.allclose(
            a, b, rtol=1e-9, atol=1e-12, equal_nan=True
        ), f"native eval deviates: max abs diff {diff} at scale {scale}"
