"""Benchmark of the port's kernels on one CUDA card: the twin of the f64
headline and of the ``--pallas`` sections of genfer_tpu's ``bench.py``.

    python -m genfer_tpu_torch.bench [--seed N]
    python -m genfer_tpu_torch.bench --pallas [--seed N]
    python -m genfer_tpu_torch.bench --serving --scan [--reference DIR]
    python -m genfer_tpu_torch.bench --nested
    python -m genfer_tpu_torch.bench --ozaki --highorder

The headline (no option) twins ``bench_kernel`` and ``bench_host_kernel``:

* ``f64_kernel``: the 2-variable truncated f64 product at ``ORDER`` (512,
  the JAX bench's default) through ``_conv_impl`` (K1 on the card),
  iterated ``ITERS`` times, each step's output renormalized by its max and
  fed to the next step with the step's first operand, in GF/s (two flops a
  useful multiply-add); beside it the plain version's time (the einsum
  PyTorch computes the same function with, one step), K1's bound and
  share of it, and K1's max error against the plain version;
* ``host_kernel``: the same product on the port's host C++ kernel
  (``_seriesops``), in GF/s, and K1's speed over it (``vs_host``).

The ``--pallas`` sections, at the JAX bench's own sizes:

* ``pallas_kernel``: the row-strip kernel's twin ``conv2d_trunc_f32`` at
  orders 256 and 512, with its max relative error against the f64
  product;
* ``pallas_batched``: ``conv2d_trunc_f32_batched`` at 256 x B32 and
  512 x B8; entry 0 must equal the single-pair kernel bit for bit;
* ``pallas_rowstrip``: the row-strip twin against the tile
  (``conv2d_trunc_f32_tile``) and grouped (``conv2d_trunc_f32_grouped``)
  kernels at orders 256, 384 and 512.  On the card the row-strip twin
  runs its work units in f32 FMAs and the tile and grouped kernels run
  theirs as split-TF32 products on the tensor cores, so they agree to
  f32 rounding, not bit for bit as on the TPU.

Operands are uniform in [0, 1), drawn from ``--seed`` with a numpy
generator.  Times come from CUDA events over back-to-back calls after a
synchronize.  Every section carries the card's name and power limit from
``nvidia-smi``, and each kernel's bound: the least time the card could
take for the same work (``bound_ms``) and the measured time's share of it
(``bound_share``), in place of the JAX bench's ``issue_util`` / ``mfu``,
which used the TPU's ceiling.  A failed check raises.  The results are
printed as one JSON line and written to ``build/bench-results-torch.json``.

``--serving`` twins ``bench_serving``: the scam model compiled once
(``compile.compile_program``) and served over a grid of ``SERVING_BATCH``
parameter values as one replayed CUDA graph, against the port's host
``api.infer`` one inference at a time, and ``bench_generic_serving``:
the scan compiler (``scanc.py``) on the mixture model, compiled once and
served a batch of ``GENERIC_BATCH`` seeded datasets of 109 counts as one
replayed CUDA graph.  ``--scan`` twins ``bench_population_scan``:
``models.CompiledPopulation`` at limit 256, 20 steps, single and at
batch 64, and, where ``--reference`` names the reference's checkout,
``CompiledHMM`` and ``CompiledMixture`` on its committed hmm and mixture
benchmarks against their posteriors (skipped without it); and
``bench_cascade_switchpoint``: the telescoping-cascade compiler on the
discrete and the continuous switchpoint model (host numpy, as in
genfer_tpu), compile-and-validate seconds and steady re-run
milliseconds, the continuous one against its exact Gamma-Poisson value.
``--nested`` twins ``bench_nested``: the nested-inference program
``_NESTED_WIDE`` at k = 63 through the CLI, the host interpreter against
``--compile-scan`` on the card (first and steady run), their outputs held
to each other at the reference's is_close.  The JAX sections read the
reference's mixture and switchpoint files, which the repo does not hold:
the twins run the same model families from ``tools/generators.py``
instead, and each row's ``_meta`` names that substitution.  Their times
are host clocks around work that ends in a read-back to the host, best
of three after the first call (which captures the graphs).

``--ozaki`` twins ``bench_ozaki``: at orders 256, 384 and 512 the f64
product through ``_conv_impl``, K1 (``GENFER_OZAKI=0``; one row for the
JAX bench's two XLA f64 rows) against K5, the ozaki route (``force``),
at int8 pair_bits 7 and 6 and bf16 7; the JAX bench's ``nostair`` row
has no twin, since K5 has no staircase knob (its ``_meta`` says so).
``--highorder`` twins ``bench_highorder``: ``ops/blocked_conv.py`` at
orders 1024 and 2048 with K2 (P = 512), K1 (P = 256) and K5 (P = 512)
inside.  Both keep the reference's evidence rules: a ``_meta`` stamp, a
failed row recorded and the others run, and a spot check of 64 output
coefficients against host-exact f64 dots.

The other sections of genfer_tpu's bench are not ported yet; asking for
one raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .taylor.host import _conv_pair_flops

RESULTS = Path(__file__).resolve().parent.parent / "build" / (
    "bench-results-torch.json")

#: one H100 SXM's IEEE-f32 rate outside the tensor cores (67 TFLOP/s, two
#: flops a fused multiply-add) and its memory bandwidth, NVIDIA's data
#: sheet, at the 700 W power limit
F32_FMA_PER_S = 67e12 / 2
BYTES_PER_S = 3.35e12
#: its dense TF32 rate on the tensor cores (495 TFLOP/s, the same data
#: sheet), in ``mma`` multiply-adds a second: the ceiling of the kernels
#: that run an f32 product as several TF32 passes
TF32_MMA_PER_S = 495e12 / 2
#: TF32 passes of the split product of K4a / K4b (hi*hi, hi*lo, lo*hi)
SPLIT_PASSES = 3
#: its dense FP64 tensor-core rate (67 TFLOP/s, the same data sheet), in
#: ``mma`` multiply-adds a second: the ceiling of K1
F64_MMA_PER_S = 67e12 / 2
#: the bound of K1 (``bound_ms``'s third rate)
F64_MMA = "f64 mma"
#: its dense int8 (1,979 TOPS) and bf16 (989 TFLOP/s) tensor-core rates, the
#: same data sheet, in ``mma`` multiply-adds a second: the ceilings of K5's
#: integer and bf16 passes, whose bound is its pair passes times the useful
#: multiply-adds over that rate (``bound_ms``'s ``rate`` with ``passes``)
INT8_MMA_PER_S = 1979e12 / 2
BF16_MMA_PER_S = 989e12 / 2
INT8_MMA = "int8 mma"
BF16_MMA = "bf16 mma"

#: genfer_tpu bench options this twin does not run yet -> ROADMAP item
UNPORTED = {
    "suite": "Queue 1 item 3 (bench twin; end-to-end suite)",
    "scaling": "Queue 1 item 3 (bench twin; the scaling table over K1, the "
               "host kernel and K2, which Queue 1 item 1 unblocked)",
    "all": "Queue 1 item 3 (bench twin; every section)",
}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def bound_ms(macs: float, nbytes: float, passes: int | None = None,
             rate: str | None = None) -> tuple[float, str]:
    """The least time one H100 could take for ``macs`` f32 multiply-adds
    that read and write ``nbytes`` (each input read once, each output
    written once), and which of the two bounds it.  ``passes``: the
    kernel runs every multiply-add as that many TF32 ``mma`` multiply-adds
    on the tensor cores, whose rate is then the ceiling (a time under the
    FFMA bound is possible there, and a share of it above 1 would read as
    impossible).  ``rate=F64_MMA``: f64 multiply-adds on the FP64 tensor
    cores (K1); ``rate=INT8_MMA`` or ``BF16_MMA``: ``passes`` (1 by
    default) int8 or bf16 ``mma`` multiply-adds each (K5's pair passes)."""
    if rate == F64_MMA:
        ops_ms, by = macs / F64_MMA_PER_S * 1e3, "tensor operations"
    elif rate in (INT8_MMA, BF16_MMA):
        per_s = INT8_MMA_PER_S if rate == INT8_MMA else BF16_MMA_PER_S
        ops_ms = (passes or 1) * macs / per_s * 1e3
        by = "tensor operations"
    elif passes is None:
        ops_ms, by = macs / F32_FMA_PER_S * 1e3, "operations"
    else:
        ops_ms = passes * macs / TF32_MMA_PER_S * 1e3
        by = "tensor operations"
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    return (ops_ms, by) if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def product_bound(a_shape, b_shape, out_shape, batch: int = 1,
                  passes: int | None = None,
                  rate: str | None = None) -> tuple[float, str]:
    """``bound_ms`` of ``batch`` truncated products of f32 operands (one
    operand of each pair batched, the other shared), or of f64 operands
    with ``rate`` ``F64_MMA``, ``INT8_MMA`` or ``BF16_MMA``."""
    macs = batch * _conv_pair_flops(tuple(a_shape), tuple(b_shape),
                                    tuple(out_shape))
    n = (np.prod(a_shape) * batch + np.prod(b_shape)
         + np.prod(out_shape) * batch)
    word = 8.0 if rate in (F64_MMA, INT8_MMA, BF16_MMA) else 4.0
    return bound_ms(macs, word * n, passes, rate)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls,
    from CUDA events, after ``warmup`` calls and a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _operand(rng, shape):
    return torch.from_numpy(rng.random(shape)).float().cuda()


def _max_rel(got, want) -> float:
    return float(((got.double() - want).abs()
                  / (want.abs() + 1e-300)).max())


def bench_pallas_kernel(rng, order: int, iters: int, where: str) -> dict:
    """``bench.py::bench_pallas_kernel``: the single-pair kernel's time
    and its max relative error against the f64 product."""
    from .ops import conv2d_trunc_f32, conv2d_trunc_f64_reference

    shape = (order, order)
    a, b = rng.random(shape), rng.random(shape)
    a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    a32, b32 = a64.float(), b64.float()
    rel = _max_rel(conv2d_trunc_f32(a32, b32, shape),
                   conv2d_trunc_f64_reference(a64, b64, shape))
    if not rel < 1e-4:  # genfer_tpu's bench holds its smoke to 1e-4
        raise RuntimeError(f"conv2d_trunc_f32 order {order}: max rel err "
                           f"{rel:.3e} against f64")
    ms = time_ms(lambda: conv2d_trunc_f32(a32, b32, shape), iters)
    flops = 2 * _conv_pair_flops(shape, shape, shape)
    bound = product_bound(shape, shape, shape)[0]
    return {"ms": ms, "gflops": flops / ms / 1e6,
            "max_rel_err_vs_f64": rel, "bound_ms": bound,
            "bound_share": bound / ms, "card": where}


def bench_pallas_batched(rng, order: int, batch: int, iters: int,
                         where: str) -> dict:
    """``bench.py::bench_pallas_batched``: a batch sharing one b; entry 0
    must equal the single-pair kernel bit for bit."""
    from .ops import conv2d_trunc_f32, conv2d_trunc_f32_batched

    shape = (order, order)
    a, b = _operand(rng, (batch, *shape)), _operand(rng, shape)
    got = conv2d_trunc_f32_batched(a, b, shape)
    if not torch.equal(got[0], conv2d_trunc_f32(a[0], b, shape)):
        raise RuntimeError(f"conv2d_trunc_f32_batched {order}x{batch}: "
                           "entry 0 differs from the single-pair kernel")
    ms = time_ms(lambda: conv2d_trunc_f32_batched(a, b, shape), iters)
    flops = 2 * _conv_pair_flops(shape, shape, shape) * batch
    bound = product_bound(shape, shape, shape, batch)[0]
    return {"ms_batch": ms, "ms_per_elem": ms / batch,
            "tflops": flops / ms / 1e9, "bound_ms": bound,
            "bound_share": bound / ms, "card": where}


def bench_pallas_rowstrip(rng, order: int, iters: int, where: str) -> dict:
    """``bench.py::bench_pallas_rowstrip``: the row-strip twin against the
    tile and grouped kernels.  The tile kernel matches the row-strip twin
    to f32 rounding here (FFMA against split TF32, other sum orders), and
    the grouped one matches the tile kernel to f32 rounding, as on the
    TPU."""
    from .ops import (
        conv2d_trunc_f32,
        conv2d_trunc_f32_grouped,
        conv2d_trunc_f32_tile,
    )

    shape = (order, order)
    a, b = _operand(rng, shape), _operand(rng, shape)
    strip = conv2d_trunc_f32(a, b, shape)
    tile = conv2d_trunc_f32_tile(a, b, shape)
    grouped = conv2d_trunc_f32_grouped(a, b, shape)
    tile_err = _max_rel(tile, strip.double())
    grouped_err = _max_rel(grouped, tile.double())
    for name, err in (("tile", tile_err), ("grouped", grouped_err)):
        if not err < 1e-4:  # genfer_tpu's bar for the grouped kernel
            raise RuntimeError(f"{name} kernel order {order} diverged: "
                               f"{err:.3e}")
    dt = {name: time_ms(lambda f=f: f(a, b, shape), iters)
          for name, f in (("strip", conv2d_trunc_f32),
                          ("tile", conv2d_trunc_f32_tile),
                          ("grouped", conv2d_trunc_f32_grouped))}
    flops = 2 * _conv_pair_flops(shape, shape, shape)
    bound = product_bound(shape, shape, shape)[0]
    # the tile and grouped kernels run three TF32 passes on the tensor
    # cores: their ceiling is that rate, not the FFMA rate
    mma_bound = product_bound(shape, shape, shape, passes=SPLIT_PASSES)[0]
    return {"ms": dt["strip"], "gflops": flops / dt["strip"] / 1e6,
            "tile_ms": dt["tile"],
            "speedup_vs_tile": dt["tile"] / dt["strip"],
            "grouped_ms": dt["grouped"],
            "grouped_gflops": flops / dt["grouped"] / 1e6,
            "tile_err": tile_err, "grouped_err": grouped_err,
            "bound_ms": bound, "bound_share": bound / dt["strip"],
            "mma_bound_ms": mma_bound,
            "tile_bound_share": mma_bound / dt["tile"],
            "grouped_bound_share": mma_bound / dt["grouped"], "card": where}


ORDER = 512  # the headline's order (genfer_tpu's bench default)
ITERS = 8  # steps of the headline's chain (bench_kernel's default)
HOST_ITERS = 3  # timed host calls (bench_host_kernel's default)


def bench_f64_kernel(rng, order: int, iters: int, where: str) -> dict:
    """``bench.py::bench_kernel`` on the card: ``iters`` steps of the
    truncated f64 product through ``_conv_impl`` (K1), each output
    renormalized by its max and multiplied with the step's first operand
    next, timed with CUDA events after a warm chain; the plain version
    (one step, timed once: it is the slow part) and K1's max error
    against it over the first step's max."""
    from .ops.conv2d_f64 import conv2d_trunc_f64_reference
    from .taylor.backend import _conv_impl

    shape = (order, order)
    a = torch.from_numpy(rng.random(shape)).cuda()
    b = torch.from_numpy(rng.random(shape)).cuda()

    def chain():
        x, y = a, b
        for _ in range(iters):
            out = _conv_impl(x, y, shape)
            x, y = out / out.abs().max(), x
        return x

    got = _conv_impl(a, b, shape)
    want = conv2d_trunc_f64_reference(a, b, shape)
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= 1e-12:
        raise RuntimeError(f"K1 order {order}: max abs err {err:.3e} of the "
                           "max against the plain version")
    ms = time_ms(chain, 1, warmup=1) / iters
    plain_ms = time_ms(lambda: conv2d_trunc_f64_reference(a, b, shape), 1,
                       warmup=0)
    flops = 2 * _conv_pair_flops(shape, shape, shape)
    bound = product_bound(shape, shape, shape, rate=F64_MMA)[0]
    return {"ms": ms, "gflops": flops / ms / 1e6, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_share": bound / ms,
            "max_err_vs_plain": err, "iters": iters, "card": where}


def bench_host_kernel(rng, order: int, iters: int) -> dict:
    """``bench.py::bench_host_kernel``: the same product on the port's
    host C++ kernel, one warm-up call, then ``iters`` timed calls."""
    from .taylor.host import _SERIESOPS

    if _SERIESOPS is None:
        raise RuntimeError("the port's host C++ kernel did not build")
    shape = (order, order)
    a, b = rng.random(shape), rng.random(shape)
    out = np.zeros(shape)
    _SERIESOPS.conv_trunc(a, shape, b, shape, out, shape)
    t0 = time.perf_counter()
    for _ in range(iters):
        out.fill(0.0)
        _SERIESOPS.conv_trunc(a, shape, b, shape, out, shape)
    ms = (time.perf_counter() - t0) / iters * 1e3
    flops = 2 * _conv_pair_flops(shape, shape, shape)
    return {"ms": ms, "gflops": flops / ms / 1e6, "iters": iters}


def run_headline(seed: int = 0, iters: int = ITERS,
                 host_iters: int = HOST_ITERS) -> dict:
    """The f64 headline: K1's chain and the host kernel at ``ORDER``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures the CUDA card and found none")
    where = card()
    rng = np.random.default_rng(seed)
    kernel = bench_f64_kernel(rng, ORDER, iters, where)
    host = bench_host_kernel(rng, ORDER, host_iters)
    return {
        "f64_kernel": {str(ORDER): kernel},
        "host_kernel": {str(ORDER): host},
        "vs_host": kernel["gflops"] / host["gflops"],
        "_meta": {"device": torch.cuda.get_device_name(0), "card": where,
                  "seed": seed, "run": time.strftime("%Y-%m-%dT%H:%M:%S")},
    }


def run_pallas(seed: int = 0, iters: int | None = None) -> dict:
    """The three sections at the JAX bench's sizes and iteration counts
    (``iters`` overrides the counts)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures the CUDA card and found none")
    where = card()
    rng = np.random.default_rng(seed)
    return {
        "pallas_kernel": {
            str(order): bench_pallas_kernel(rng, order, iters or 8, where)
            for order in (256, 512)
        },
        "pallas_batched": {
            f"{order}x{batch}": bench_pallas_batched(rng, order, batch,
                                                     iters or 4, where)
            for order, batch in ((256, 32), (512, 8))
        },
        "pallas_rowstrip": {
            str(order): bench_pallas_rowstrip(rng, order, iters or 8, where)
            for order in (256, 384, 512)
        },
        "_meta": {"device": torch.cuda.get_device_name(0), "card": where,
                  "seed": seed, "run": time.strftime("%Y-%m-%dT%H:%M:%S")},
    }


SERVING_SRC = """
calls ~ Poisson(10);
scams ~ Binomial(calls, $p);
observe(scams = 1);
return calls;
"""
SERVING_LIMIT = 26
SERVING_BATCH = 4096  # bench.py::bench_serving's batch
HOST_INFERENCES = 20  # host api.infer calls timed, one at a time


def _best_of(fn, reps: int = 3) -> float:
    """Least host seconds of ``fn()`` (which ends in a read-back) over
    ``reps`` calls."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def bench_serving(batch: int, where: str) -> dict:
    """``bench.py::bench_serving``: the compiled scam model over a grid of
    ``batch`` values of $p, one replayed CUDA graph a batch, against the
    host interpreter (``api.infer``, host f64) one inference at a time."""
    from . import api
    from .compile import compile_program

    t0 = time.perf_counter()
    c = compile_program(SERVING_SRC, params=["p"], limit=SERVING_LIMIT,
                        device=None)
    translate = time.perf_counter() - t0
    grid = torch.linspace(0.01, 0.99, batch, dtype=torch.float64,
                          device="cuda").reshape(batch, 1)
    t0 = time.perf_counter()
    c.probs_batch(grid).cpu()  # warm-up walk and capture
    capture = time.perf_counter() - t0
    best = _best_of(lambda: c.probs_batch(grid).cpu())
    dev_rate = batch / best
    t0 = time.perf_counter()
    for i in range(HOST_INFERENCES):
        api.infer(SERVING_SRC.replace("$p", str(0.1 + 0.001 * i)))
    host = (time.perf_counter() - t0) / HOST_INFERENCES
    host_rate = 1.0 / host
    return {
        "batch": batch,
        "translate_seconds": translate,
        "capture_seconds": capture,
        "batch_seconds": best,
        "device_inferences_per_s": dev_rate,
        "host_inferences_per_s": host_rate,
        "speedup": dev_rate / host_rate,
        "card": where,
    }


def _expect(path: Path) -> dict:
    """The unnormalized masses a reference ``.expect`` file commits."""
    import re

    return {
        int(m.group(1)): float(m.group(2))
        for m in re.finditer(
            r"Unnormalized: p\((\d+)\)\s*=\s*([\d.e+-]+)",
            path.read_text())
    }


def _golden_row(model, counts, ref: dict, where: str) -> dict:
    """Steady seconds of ``model.probs(counts)`` and its max relative
    deviation from the committed posterior ``ref``."""
    got = model.probs(np.asarray(counts))  # capture
    best = _best_of(lambda: model.probs(np.asarray(counts)))
    dev = max(abs(got[k] - v) / v for k, v in ref.items() if v > 1e-290)
    return {"steady_ms": best * 1e3, "max_rel_dev_vs_golden": dev,
            "card": where}


def bench_population_scan(limit: int, steps: int, batch: int, where: str,
                          reference: Path | None = None) -> dict:
    """``bench.py::bench_population_scan``: ``CompiledPopulation`` single
    and batched (best of three after the capturing call); the hmm and
    mixture benchmarks of the reference's checkout ``reference`` against
    their committed posteriors where it is given."""
    import re

    from .models import CompiledHMM, CompiledMixture, CompiledPopulation

    rng = np.random.RandomState(0)
    cp = CompiledPopulation(0.2636, 0.2, limit=limit, max_steps=steps,
                            init_lambda=0.0257 * 4 * limit, slack=96,
                            device=None)
    lams = rng.uniform(10, 50, steps)
    cs = rng.poisson(8, steps)
    t0 = time.perf_counter()
    cp.probs(lams, cs)
    capture = time.perf_counter() - t0
    best = _best_of(lambda: cp.probs(lams, cs))
    bl = rng.uniform(10, 50, (batch, steps))
    bc = rng.poisson(8, (batch, steps))
    t0 = time.perf_counter()
    cp.probs_batch(bl, bc)
    bcapture = time.perf_counter() - t0
    bbest = _best_of(lambda: cp.probs_batch(bl, bc))
    out = {
        "limit": limit,
        "steps": steps,
        "capture_seconds": capture,
        "single_ms": best * 1e3,
        "batch": batch,
        "batch_capture_seconds": bcapture,
        "batch_seconds": bbest,
        "datasets_per_s": batch / bbest,
        "card": where,
    }
    approx = None if reference is None else (
        Path(reference) / "benchmarks" / "neurips2023" / "approx")
    hmm = None if approx is None else approx / "hmm" / "hmm.expect"
    if hmm is not None and hmm.exists():
        counts = [int(x) for x in re.search(
            r"\[(.*?)\]", hmm.with_suffix(".sgcl").read_text()
        ).group(1).split(",")]
        ref = _expect(hmm)
        out["hmm"] = _golden_row(
            CompiledHMM(n_rates=256, max_steps=32, limit=max(ref) + 1,
                        device=None), counts, ref, where)
    else:
        out["hmm"] = {"skipped": "no --reference checkout with "
                                 "benchmarks/neurips2023/approx/hmm"}
    mix = None if approx is None else approx / "mixture"
    if mix is not None and (mix / "mixture.expect").exists():
        counts = [int(m.group(1)) for m in re.finditer(
            r"observe (\d+) ~ Poisson\(0\.1 \* Rate1\)",
            (mix / "mixture.sgcl").read_text())]
        ref = _expect(mix / "mixture.expect")
        out["mixture"] = _golden_row(
            CompiledMixture(n_rates=320, max_steps=128, limit=max(ref) + 1,
                            device=None), counts, ref, where)
    else:
        out["mixture"] = {"skipped": "no --reference checkout with "
                                     "benchmarks/neurips2023/approx/mixture"}
    return out


GENERIC_BATCH, GENERIC_STEPS = 256, 109  # bench.py::bench_generic_serving
GENERIC_ORDER, GENERIC_MAX_STEPS = 128, 128
#: what the scan compiler's rows run in place of the reference's files
GENERIC_SOURCE = ("tools/generators.py::generate_mixture (the reference's "
                  "benchmarks/neurips2023/approx/mixture/mixture.sgcl is "
                  "not in the repo)")
CASCADE_SOURCE = ("tools/generators.py::generate_switchpoint(continuous="
                  "False / True) (the reference's test/expect/real_world/"
                  "switchpoint.sgcl and benchmarks/neurips2023/approx/"
                  "switchpoint/switchpoint.sgcl are not in the repo)")
CASCADE_RERUNS = 10  # steady re-runs timed (bench.py's count)


def _generated(generate, **kw):
    """The parsed program a generator of ``tools/generators.py`` writes."""
    from .lang.parser import parse_program

    return parse_program(generate(None, **kw))


def bench_generic_serving(where: str, batch: int = GENERIC_BATCH,
                          steps: int = GENERIC_STEPS, device=None) -> dict:
    """``bench.py::bench_generic_serving``: the mixture model compiled once
    by the scan compiler (``compile_scan_program``, order 128, 128 steps),
    then a batch of seeded datasets of ``steps`` counts served through
    ``run_batch`` (one replayed CUDA graph on the card): the first call
    (host prep and the capture), the best of three after it, and the
    batch's rows against ``run_with_data`` on two of them (rel 1e-12)."""
    from .scanc import compile_scan_program
    from .tools.generators import generate_mixture

    t0 = time.perf_counter()
    obj, _ = compile_scan_program(_generated(generate_mixture),
                                  order=GENERIC_ORDER,
                                  max_steps=GENERIC_MAX_STEPS, device=device)
    compile_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    bc = rng.integers(0, 8, size=(batch, steps)).astype(np.float64)
    cols = [bc] * len(obj.rep.data)
    t0 = time.perf_counter()
    masses, _ = obj.run_batch(cols)
    warm = time.perf_counter() - t0
    best = _best_of(lambda: obj.run_batch(cols))
    for i in (0, batch - 1):
        one, _ = obj.run_with_data([c[i] for c in cols])
        if not np.allclose(masses[i], one, rtol=1e-12, atol=0.0):
            raise RuntimeError(f"generic serving: batch row {i} differs "
                               "from run_with_data")
    return {
        "model": "mixture (parsed, scanc)",
        "batch": batch,
        "steps": steps,
        "grid_order": obj.order,
        "compile_validate_s": compile_s,
        "warm_seconds": warm,
        "steady_seconds": best,
        "inferences_per_s": batch / best,
        "card": where,
        "_meta": {"source": GENERIC_SOURCE},
    }


def _switchpoint_exact_z(form) -> float:
    """The continuous switchpoint's Z from the Gamma-Poisson conjugacy
    (an Exponential(1) rate, unit factors 1): prefix likelihood
    Gamma(A+1) / (P+1)^(A+1) / prod c_i!, A the prefix's count sum."""
    import math

    from .scanc import _cascade_units_poisson

    units = _cascade_units_poisson(form.units)
    cs = [c for c, _, _ in units]
    n = len(cs)

    def loglik(cseg, nseg):
        a = sum(cseg)
        return (math.lgamma(a + 1) - (a + 1) * math.log(nseg + 1)
                - sum(math.lgamma(c + 1) for c in cseg))

    logws = np.asarray([
        math.log(float(q)) + loglik(cs[:p], p) + loglik(cs[p:], n - p)
        for q, p in zip(form.qs, form.prefix_lens)
    ])
    m = logws.max()
    return float(np.exp(logws - m).sum() * math.exp(m))


def bench_cascade_switchpoint(where: str) -> dict:
    """``bench.py::bench_cascade_switchpoint``: the cascade compiler on the
    discrete and the continuous switchpoint model (``CascadeCompiled``
    runs in numpy on the host, as genfer_tpu's does): compile-and-validate
    seconds, the mean of ``CASCADE_RERUNS`` steady re-runs, Z, and for the
    continuous model its relative error against the exact value."""
    from .scanc import CascadeCompiled, compile_scan_program
    from .tools.generators import generate_switchpoint

    out: dict = {}
    for label, continuous in (("discrete", False), ("continuous", True)):
        prog = _generated(generate_switchpoint, continuous=continuous)
        t0 = time.perf_counter()
        obj, (_, z) = compile_scan_program(prog, order=128)
        compile_s = time.perf_counter() - t0
        if not isinstance(obj, CascadeCompiled):
            raise RuntimeError(f"{label} switchpoint did not compile as a "
                               "cascade")
        t0 = time.perf_counter()
        for _ in range(CASCADE_RERUNS):
            obj.run()
        steady = (time.perf_counter() - t0) / CASCADE_RERUNS
        row = {"compile_validate_s": compile_s, "steady_ms": steady * 1e3,
               "Z": z, "units": obj.rep.n_iters, "grid_order": obj.order}
        if continuous:
            row["rel_err_vs_exact"] = abs(z - _switchpoint_exact_z(obj.form)
                                          ) / _switchpoint_exact_z(obj.form)
        out[label] = row
    out["card"] = where
    out["_meta"] = {"source": CASCADE_SOURCE, "runs_on": "host numpy"}
    return out


#: genfer_tpu's bench.py::_NESTED_WIDE: the nested-inference program whose
#: given variable takes k + 1 values
NESTED_WIDE = """
Class ~ Binomial({k}, 0.5);
normalize Class {{
    Rate ~ Geometric(0.1);
    observe 5 ~ Poisson(0.2 * Rate);
    if Class <= {half} {{
        observe 3 ~ Poisson(0.2 * Rate);
    }} else {{
        observe 8 ~ Poisson(0.2 * Rate);
    }}
}}
observe 4 ~ Poisson(0.1 * Rate);
return Class
"""
NESTED_K = 63  # bench.py::bench_nested's default


def bench_nested(where: str, k: int = NESTED_K, device=None) -> dict:
    """``bench.py::bench_nested``: the CLI on ``NESTED_WIDE`` with the host
    interpreter (``--backend numpy``), then ``--compile-scan`` on
    ``device`` twice (first and steady), wall seconds each; the scan
    runs' printed values must agree with the interpreter's as
    ``printed.disagreements`` holds them."""
    import contextlib
    import io

    from . import cli
    from .lang.parser import parse_program
    from .printed import disagreements, read_masses, read_results

    program = parse_program(NESTED_WIDE.format(k=k, half=k // 2))
    out: dict = {}
    printed = {}
    for name, flags in (("interpreter", ["--backend", "numpy"]),
                        ("mass_compiled", ["--compile-scan"]),
                        ("mass_compiled_steady", ["--compile-scan"])):
        args = cli.build_arg_parser().parse_args(
            ["nested.sgcl", "--no-timing", "--limit", str(k + 1), *flags])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.run(program, args, device=device)
        out[name] = time.perf_counter() - t0
        printed[name] = (read_results(buf.getvalue()),
                         read_masses(buf.getvalue()))
    points, masses = printed["interpreter"]
    for name in ("mass_compiled", "mass_compiled_steady"):
        bad = (disagreements(printed[name][0], points)
               + disagreements(printed[name][1], masses, points["Z"]))
        if bad:
            raise RuntimeError(f"nested {name}: " + "; ".join(bad[:5])
                               + " (against the interpreter)")
    out["given_range"] = k + 1
    out["speedup_steady"] = out["interpreter"] / out["mass_compiled_steady"]
    out["card"] = where
    return out


@contextlib.contextmanager
def _env_patch(env: dict):
    """Set the given environment variables and restore them on exit: the
    sections toggle the route's variables to A/B kernels, and a leaked
    value would change every later section of the same run."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _launches() -> dict:
    """K1's and K5's launch counts, to say which kernel a row ran."""
    from .ops.conv2d_f64 import conv2d_trunc_f64
    from .ops.ozaki_conv import ozaki_conv2d

    return {"k1": conv2d_trunc_f64.launches, "k5": ozaki_conv2d.launches}


OZAKI_ORDERS = (256, 384, 512)  # bench.py::bench_ozaki's orders
OZAKI_ITERS = 6
_FORCE = {"GENFER_OZAKI": "force", "GENFER_OZAKI_MIN_FLOPS": "0"}
#: bench.py::bench_ozaki's variants; its two XLA f64 rows (the emulation
#: and the staircase) are one here, K1, the card's native f64 route, and
#: its ozaki_int8_pb7_nostair row is absent (``_meta``)
OZAKI_VARIANTS = (
    ("k1", {"GENFER_OZAKI": "0"}),
    ("ozaki_int8_pb7", {"GENFER_OZAKI_IMPL": "int8",
                        "GENFER_OZAKI_PAIR_BITS": "7"}),
    ("ozaki_int8_pb6", {"GENFER_OZAKI_IMPL": "int8",
                        "GENFER_OZAKI_PAIR_BITS": "6"}),
    ("ozaki_bf16_pb7", {"GENFER_OZAKI_IMPL": "bf16",
                        "GENFER_OZAKI_PAIR_BITS": "7"}),
)


def bench_ozaki(where: str, orders=OZAKI_ORDERS,
                iters: int = OZAKI_ITERS) -> dict:
    """``bench.py::bench_ozaki``: the f64-accuracy 2-variable product at
    square truncated orders through ``_conv_impl``, K1 (``GENFER_OZAKI=0``)
    against K5 (``force``) across pass types and pair cutoffs.  Each row
    times a chain of ``iters`` products (each output renormalized by its
    max and multiplied with the step's first operand next) with CUDA
    events after a warm chain, and spot-checks one product against
    host-exact f64 dots (``blocked_conv.spot_check``, 64 coefficients);
    beside it the bound (K1: the FP64 tensor rate; K5: its pair passes
    over the int8 or bf16 rate) and the launches that show the route.  A
    row that fails is recorded as ``FAILED ...`` and the others run."""
    from .ops.blocked_conv import spot_check
    from .ops.ozaki_conv import pair_passes
    from .taylor.backend import _conv_impl

    results = {}
    for order in orders:
        shape = (order, order)
        rng = np.random.RandomState(0)
        a0 = torch.from_numpy(rng.rand(*shape)).cuda()
        b0 = torch.from_numpy(rng.rand(*shape)).cuda()
        macs = _conv_pair_flops(shape, shape, shape)
        row = {}
        for name, env in OZAKI_VARIANTS:
            env = dict(env) if name == "k1" else {**_FORCE, **env}
            try:
                with _env_patch(env):
                    def chain():
                        a, b = a0, b0
                        for _ in range(iters):
                            out = _conv_impl(a, b, shape)
                            a, b = out / out.abs().max(), a
                        return a

                    before = _launches()
                    out = _conv_impl(a0, b0, shape)
                    torch.cuda.synchronize()
                    ran = {k: v - before[k] for k, v in _launches().items()}
                    ms = time_ms(chain, 1, warmup=1) / iters
                err = spot_check(a0.cpu().numpy(), b0.cpu().numpy(),
                                 out.cpu().numpy(), 64)
                if name == "k1":
                    bound, by = product_bound(shape, shape, shape,
                                              rate=F64_MMA)
                else:
                    impl = env["GENFER_OZAKI_IMPL"]
                    bound, by = product_bound(
                        shape, shape, shape,
                        passes=pair_passes(int(env["GENFER_OZAKI_PAIR_BITS"])),
                        rate=INT8_MMA if impl == "int8" else BF16_MMA)
                row[name] = {"ms": ms, "gflops": 2 * macs / ms / 1e6,
                             "spot_rel_err": err, "bound_ms": bound,
                             "bound_by": by, "bound_share": bound / ms,
                             "launches": ran}
            except Exception as e:  # record, keep going
                row[name] = f"FAILED {type(e).__name__}: {e}"
            print(f"ozaki {order} {name}: {row[name]}", file=sys.stderr,
                  flush=True)
        results[str(order)] = row
    results["_meta"] = {
        **_meta(where),
        "note": "k1 replaces the JAX bench's two XLA f64 rows (emulation, "
                "staircase); ozaki_int8_pb7_nostair is absent: K5 has no "
                "staircase knob (its unit plan clips the band and the "
                "truncation), so that row would time ozaki_int8_pb7's "
                "kernel again",
    }
    return results


HIGHORDER_ORDERS = (1024, 2048)  # bench.py::bench_highorder's orders


def _pairwise(kernel, dtype=None):
    """``inner`` for ``conv2d_blocked`` from a single-pair kernel: one call
    a pair of the group (in ``dtype`` where given), stacked in f64."""
    def inner(x, y):
        full = (2 * x.shape[1] - 1, 2 * x.shape[2] - 1)
        if dtype is not None:
            x, y = x.to(dtype), y.to(dtype)
        return torch.stack([kernel(x[z].contiguous(), y[z].contiguous(), full)
                            for z in range(x.shape[0])]).double()

    return inner


def bench_highorder(where: str, orders=HIGHORDER_ORDERS) -> dict:
    """``bench.py::bench_highorder``: the P-block decomposition
    (``ops/blocked_conv.py``) at orders 1024 and 2048, each small product
    a full (2P-1)^2 one: ``pallas_f32`` K2 at P = 512 (f32, groups of 32
    pairs), ``xla_f64`` K1 at P = 256 (its batched call, groups of 25),
    ``ozaki_f64`` K5 at P = 512 (int8, pair_bits 7, groups of 4).
    Seconds of the second call (host clock to a synchronize), GF/s of the
    truncated product's useful multiply-adds, and a host-exact spot check
    of 64 coefficients; failed rows recorded as ``FAILED ...``."""
    from .ops import conv2d_trunc_f32, conv2d_trunc_f64_batched
    from .ops.blocked_conv import conv2d_blocked, spot_check
    from .ops.ozaki_conv import ozaki_conv2d

    def k1(x, y):
        full = (2 * x.shape[1] - 1, 2 * x.shape[2] - 1)
        return conv2d_trunc_f64_batched(x.contiguous(), y.contiguous(), full)

    rows = (
        ("pallas_f32", 512, _pairwise(conv2d_trunc_f32, torch.float32), 32),
        ("xla_f64", 256, k1, 25),
        ("ozaki_f64", 512, _pairwise(ozaki_conv2d), 4),
    )
    results = {}
    rng = np.random.default_rng(0)
    for order in orders:
        shape = (order, order)
        a = torch.from_numpy(rng.random(shape)).cuda()
        b = torch.from_numpy(rng.random(shape)).cuda()
        macs = _conv_pair_flops(shape, shape, shape)
        row = {}
        for name, P, inner, group in rows:
            try:
                conv2d_blocked(a, b, shape, P, inner, group=group,
                               out_dtype=torch.float64)  # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = conv2d_blocked(a, b, shape, P, inner, group=group,
                                     out_dtype=torch.float64)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                err = spot_check(a.cpu().numpy(), b.cpu().numpy(),
                                 out.cpu().numpy(), 64)
                row[name] = {"seconds": dt, "gflops": 2 * macs / dt / 1e9,
                             "spot_rel_err": err, "P": P, "group": group}
            except Exception as e:  # record, keep going
                row[name] = f"FAILED {type(e).__name__}: {e}"
            print(f"highorder {order} {name}: {row[name]}", file=sys.stderr,
                  flush=True)
        results[str(order)] = row
    results["_meta"] = {
        **_meta(where),
        "note": "pallas_f32 runs K2 and xla_f64 K1 (the card's kernels for "
                "the JAX bench's Pallas f32 and XLA f64 rows); ozaki_f64 "
                "runs K5 directly (no routing env needed)",
    }
    return results


def _meta(where: str) -> dict:
    return {"device": torch.cuda.get_device_name(0), "card": where,
            "run": time.strftime("%Y-%m-%dT%H:%M:%S")}


def _card() -> str:
    """The card's nvidia-smi line; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures the CUDA card and found none")
    return card()


def run_serving(batch: int = SERVING_BATCH) -> dict:
    """``--serving``: compiled serving and the scan compiler's serving."""
    where = _card()
    return {
        "serving": bench_serving(batch, where),
        "generic_serving": bench_generic_serving(where),
        "_meta": _meta(where),
    }


def run_scan(reference: Path | None = None, limit: int = 256,
             steps: int = 20, batch: int = 64) -> dict:
    """``--scan``: the scan models and the cascade compiler."""
    where = _card()
    return {
        "population_scan": bench_population_scan(limit, steps, batch, where,
                                                 reference),
        "cascade_switchpoint": bench_cascade_switchpoint(where),
        "_meta": _meta(where),
    }


def run_nested(k: int = NESTED_K) -> dict:
    """``--nested``: the interpreter against ``--compile-scan`` on the
    card."""
    where = _card()
    return {"nested": bench_nested(where, k), "_meta": _meta(where)}


def run_ozaki(orders=OZAKI_ORDERS, iters: int = OZAKI_ITERS) -> dict:
    """``--ozaki``: K1 against K5 at square truncated orders."""
    return {"ozaki": bench_ozaki(_card(), orders, iters)}


def run_highorder(orders=HIGHORDER_ORDERS) -> dict:
    """``--highorder``: the blocked products at orders 1024 and 2048."""
    return {"highorder": bench_highorder(_card(), orders)}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m genfer_tpu_torch.bench")
    ap.add_argument("--pallas", action="store_true",
                    help="the f32 kernel sections (default: the f64 "
                    "headline)")
    ap.add_argument("--serving", action="store_true",
                    help="compiled serving: the scam model at batch "
                    f"{SERVING_BATCH} against the host interpreter")
    ap.add_argument("--scan", action="store_true",
                    help="the scan models (population at limit 256)")
    ap.add_argument("--nested", action="store_true",
                    help="nested inference at k = 63: the interpreter "
                    "against --compile-scan on the card")
    ap.add_argument("--ozaki", action="store_true",
                    help="K1 against K5, the ozaki route, at orders "
                    f"{', '.join(map(str, OZAKI_ORDERS))}")
    ap.add_argument("--highorder", action="store_true",
                    help="blocked products (K2, K1, K5 inside) at orders "
                    f"{', '.join(map(str, HIGHORDER_ORDERS))}")
    ap.add_argument("--reference", type=Path, default=None,
                    help="the reference's checkout: --scan then also runs "
                    "its committed hmm and mixture benchmarks")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the numpy generator of the operands")
    for name in UNPORTED:
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"not ported yet: ROADMAP {UNPORTED[name]}")
    return ap


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    for name, item in UNPORTED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name} is not ported yet: ROADMAP {item}")
    results: dict = {}
    if args.pallas:
        results.update(run_pallas(args.seed))
    if args.serving:
        results.update(run_serving())
    if args.scan:
        results.update(run_scan(args.reference))
    if args.nested:
        results.update(run_nested())
    if args.ozaki:
        results.update(run_ozaki())
    if args.highorder:
        results.update(run_highorder())
    if not results:
        results = run_headline(args.seed)
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    RESULTS.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
