#!/usr/bin/env python3
"""Smoke run of genfer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before a
result):

1. a CUDA card must be present; print nvidia-smi's name and power limit;
2. build the CUDA kernels from ``genfer_tpu_torch/csrc`` with nvcc;
3. every kernel against its plain PyTorch version and the f64 product on
   the card, at rtol 5e-5 / atol 1e-6 against f64 (the bar of the Pallas
   kernels' tests; rtol 2e-5 for the 1-D product, its test's bar):
   ``conv2d_trunc_f32`` (K2), ``conv2d_trunc_f32_tile`` (K4a) and
   ``conv2d_trunc_f32_grouped`` (K4b) on ``SHAPES`` and on the
   extreme-scale pair ``EXTREME`` (column scales from 1e-30 to 1e30),
   ``conv2d_trunc_f32_batched`` (K3) on the same at B = 3 and 32 (order
   768 at B = 3 only: its cuDNN yardstick alone would take half a
   minute at B = 32), and ``conv1d_trunc_f32`` (K6) on ``SHAPES_1D`` (up
   to length 262144) and on the geometric pair ``GEOMETRIC_LEN`` (outputs
   from 1 down to 1e-36, each held at its own scale, atol 1e-37), its f64
   reference the folded product on the card.  K2, K4a, K4b and K6 must
   each give the same bits twice, and every K3 entry K2's bits; each
   shape prints the body K4a / K4b or K6 ran for it (split TF32 on the
   tensor cores, or FFMA for a thin or small product).  Times
   of the kernel, of its plain version and of one library call computing
   the same function (``torch.nn.functional.conv2d`` / ``conv1d`` of the
   flipped operand, cuDNN in IEEE f32; timed once per operands), all
   from CUDA events.  Then the work-unit plans at the dense orders,
   K2's and that of K4a / K4b, and K6's at its long lengths, and the
   host and device microseconds of one K2 call at the end-to-end run's
   largest shape and of one K6 call at length 4096;
4. end to end: the two-population model (``generate_two_populations``,
   seed 0, size ``SIZE``) through ``python -m genfer_tpu_torch --backend
   pallas`` in-process, against the host f64 ``--backend numpy`` run of
   the same CLI.  Z, the moments and every normalized p(k)/Z >= 1e-6
   must agree at rel 1e-5, and K2 must have been launched;
5. the bench twin, ``python -m genfer_tpu_torch.bench --pallas``, in
   process with ``BENCH_ITERS`` iterations: its three sections and their
   checks (max rel err against f64, the batch's bit parity with the
   single-pair kernel, tile and grouped against the row strip); K2, K3,
   K4a and K4b must have been launched;
6. the ``ops`` API's 1-D product (``genfer_tpu_torch.ops.
   conv1d_trunc_f32``, the twin of genfer_tpu's ``ops.conv1d_pallas``):
   the distribution of the sum of two independent Poisson counts as the
   product of their probability series, against the Poisson pmf of the
   summed rate in f64; K6 must have been launched.

7. K1 (``conv2d_trunc_f64``, the f64 2-D product: its small body on
   the FFMA units and its dense body on the FP64 tensor cores, as given
   or transposed, ``k1_route`` picking one from the shapes) against its
   plain version (``conv2d_trunc_f64_reference``, in row strips above
   order 512) on the card: on ``K1_SHAPES`` (those of
   tests/test_conv_block.py) and the square ``K1_ORDERS`` 256 to 1024
   with standard-normal operands (max abs error over max |plain| <=
   ``K1_TOL`` = 1e-12) and with operands in [0, 1) (elementwise rtol
   1e-12, to 512), on the main path's shape classes ``K1_CLASSES`` (two
   2x2 stencils, the (n, 1) operands of two_populations(2000)) in [0, 1),
   on the extreme pair ``K1_EXTREME`` (a's columns 1e-150 .. 1e150, b's
   1e-20 .. 1e20, each output column against its own max), the same bits
   twice everywhere, and the body each shape took; for each body a batch
   whose entries equal their single-pair calls bit for bit; a 3-axis
   product through ``TorchF64Backend.conv_trunc`` (one launch over every
   pair) against the host f64 product.  Times of K1, its plain version
   and, at the classes and the orders, one cuDNN f64 ``conv2d`` (timed
   once where it takes over 0.5 s), each beside its bound; the host and
   device microseconds of one K1 and one cuDNN call at the main path's
   stencil and its largest product;
8. ``--backend jax`` (``TorchF64Backend``, every coefficient tensor on the
   card) end to end through ``python -m genfer_tpu_torch`` in-process on
   ``examples/*.sgcl``, two_populations (seed 0, size ``E2E_SIZE`` =
   2000, where the f32 route prints NaN) and population (size 1000, 2
   variables), against ``--backend numpy`` at the reference's is_close
   (rel 1e-9, abs 1e-8) on the moments and every printed p(k) (and the
   intervals a program with loops prints), Z at rel 1e-9 of itself; one ``--bounds --backend
   jax`` run (``TorchIntervalBackend``) whose intervals hold the host
   f64 points; K1 must have been launched, and its launches by body on
   two_populations and population are printed: the small body must have
   run on both, and carried at least ``K1_SMALL_MIN`` of
   two_populations' K1 launches;
9. the ``entry()`` twin (``genfer_tpu_torch.entry``) on the card against
   the same operands on the CPU; K1 must have been launched;
10. the bench twin's f64 headline at order 512 (K1's chain in GF/s, the
   host C++ kernel's, K1's bound); K1 must have been launched.

11. compiled serving (``genfer_tpu_torch.compile``): the bench's scam
   model (``bench.SERVING_SRC``) over a grid of ``bench.SERVING_BATCH``
   = 4096 values of $p: one eager walk on the card, then the CUDA graph
   captured from the next walk, which must launch K1's small body once a
   product
   (``SERVING_PRODUCTS`` = 26, no other body); every replay must equal the
   eager walk bit for bit, and ``SERVING_CHECK`` = 16 grid points must
   agree with the host f64 ``api.infer`` at is_close; translate, capture
   and replay seconds, inferences a second, and from torch.profiler the
   kernels a replay launches and the card's busy share of it.  K1's small
   body alone at the walk's largest product, (27,27)x(2,2)->(27,28) over
   the 4096-entry batch, against its plain version and one grouped f64
   ``conv2d`` (the library yardstick), beside its bound.  Then the 784-pixel digit model
   (``tools.generators.digit_serving_source``) at batch ``DIGIT_BATCH`` =
   1024, a seeded theta and images drawn from it, through its graph,
   against the port's eager CPU walk on ``DIGIT_CHECK`` = 4 rows (rel
   1e-9);
12. the scan models (``genfer_tpu_torch.models``) at the bench's sizes
   through their graphs: ``CompiledPopulation`` at limit 256, 20 steps
   (the bench's data) single, against the port's host interpreter on the
   generated SGCL (rel 1e-10), and at batch 64 against the same class on
   the CPU; ``CompiledTwoPopulations`` at limit 256, 20 steps against the
   host interpreter; ``CompiledHMM`` (256 rates, 30 seeded counts) and
   ``CompiledMixture`` (320 rates, the 109 coal-mining counts) against the
   same classes on the CPU (rel 1e-9); capture and replay times.
13. the scan compiler (``genfer_tpu_torch.scanc``) on the card:
   ``python -m genfer_tpu_torch <file> --compile-scan`` in a child process
   (the card, the port's default) on ``SCAN_PROGRAMS`` (hmm(30), the
   mixture, the discrete switchpoint, population(500, 1) and
   two_populations at 500 and 2000, from ``tools/generators.py``), each
   against the host interpreter (``--backend numpy``): the moments and
   each p(k)/Z at is_close, Z and every unnormalized p(k) at rel 1e-9 of
   Z (they lie far below is_close's absolute 1e-8); in process the same
   masses held to the interpreter's, the converged order (it must be
   genfer_tpu's), the compile-and-validate wall, the peak
   device memory, and from torch.profiler the card's busy time in cuBLAS
   DGEMM against the other kernels.  ``api.compile_serving`` on the
   mixture and ``run_batch`` at ``bench.GENERIC_BATCH`` = 256 seeded
   datasets of 109 counts through one CUDA graph: every row against
   ``run_with_data`` and the same object on the CPU at rtol 1e-12, replay
   time, inferences a second and the replay's profile; a ``$param``
   sweep over ``SWEEP_P`` against the host interpreter, masses and Z at
   rel 1e-9 of Z; the discrete switchpoint's cascade on fresh seeded
   counts, served at the order the rewritten source converges at, against
   compiling that source (rtol 1e-12) and the host interpreter on it (rel
   1e-9 of Z), with the deviation it shows when served at the committed
   counts' order (a cascade checks no convergence for fresh counts).

Each of phases 4-6 and 8-13 sets the launch counts to 0 just before it
and reads them just after (phase 11's K1 launches are those of the
captured walk: a replay runs the graph, not the wrappers). Before the
table, the shares of their bounds of K2, K3, K4a, K4b, K6 (the tensor-core
kernels against the TF32 rate, three passes) with K2's time beside K4a's
and K4b's, and of K1 (against the FP64 tensor rate). The second-to-last line is the kernel table as
JSON, with one entry for each of K1's bodies; the last line is ``{"ok":
true, "device": {...}}``. Everything is reached through
``genfer_tpu_torch``; nothing here imports jax or genfer_tpu.

Why size 500 with ``GENFER_PALLAS_OFFLOAD_FLOPS=1e5``: the f32 route
casts f64 coefficients to f32 without scaling (as genfer_tpu's
``PallasBackend`` does).  This model's coefficient tensors outgrow the
f32 range at size >= 700 (operands up to 1e66 at size 2000), where both
packages print NaN; 500 is the largest size tried at which the route
stays finite, and 1e5 is a threshold at which that size routes products.
No model of the in-repo generators sends products of >= 1e6
multiply-adds to the route and stays inside the f32 range.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from genfer_tpu_torch.printed import (
    IS_CLOSE,
    disagreements,
    read_masses,
    read_results,
)

#: the f32 route's threshold for phase 4, in multiply-adds; set in the
#: environment before the port's backend module is imported
OFFLOAD_FLOPS = "1e5"
SIZE = 500
RTOL, ATOL = 5e-5, 1e-6  # f32 2-D kernels against f64
RTOL_1D = 2e-5  # the 1-D kernel against f64
E2E_RTOL = 1e-5  # end-to-end results against the host f64 run
P_MIN = 1e-6  # normalized masses below this are not compared
BENCH_ITERS = 2  # timed calls per kernel in phase 5 (the bench runs 4-8)
BATCHES = (3, 32)  # batch sizes of K3 in phase 3
POISSON_RATES = (1000.0, 1500.0)  # phase 6
POISSON_LEN = 4096

# (a shape, b shape, out shape): the ragged shapes of the Pallas tests
# (tests/test_parallel_ops.py), two edge shapes of tests/test_conv_block.py
# (a longer than the output; output wider than the full product), the
# largest products the end-to-end run routes (size 500) and the largest
# it would route at size 2000, and dense truncated products at the bench's
# orders 256, 384 and 512 and at the backend's largest routed order, 768
SHAPES = [
    ((5, 7), (4, 6), (8, 12)),
    ((130, 140), (120, 100), (130, 140)),
    ((100, 120), (130, 140), (130, 140)),
    ((1, 130), (130, 1), (130, 130)),
    ((70, 80), (60, 50), (70, 80)),
    ((200, 300), (150, 100), (280, 380)),
    ((16, 5), (3, 40), (10, 12)),
    ((33, 64), (64, 20), (96, 83)),
    ((95, 1), (95, 87), (95, 87)),
    ((1, 87), (95, 87), (95, 87)),
    ((308, 274), (308, 1), (308, 274)),
    ((1, 274), (308, 274), (308, 274)),
    ((256, 256), (256, 256), (256, 256)),
    ((384, 384), (384, 384), (384, 384)),
    ((512, 512), (512, 512), (512, 512)),
    ((768, 768), (768, 768), (768, 768)),
]
# operands whose columns are scaled by 10^-30 .. 10^30 (a) and 10^-6 .. 10^6
# (b): every product stays inside f32's range, and each output column is
# held to the rtol at its own scale (atol ``ATOL_EXTREME``)
EXTREME = ((130, 140), (120, 100), (130, 140))
ATOL_EXTREME = 1e-37
MAX_ORDER_B32 = 512  # larger outputs run K3 at the first of BATCHES only
# (la, lb, lc): the Pallas test's shape, edge lengths, phase 6's, and
# the long lengths where K6 does real work
LONG_1D = (16384, 65536, 262144)
SHAPES_1D = [
    (100, 37, 120),
    (1, 1, 1),
    (300, 7, 129),
    (7, 300, 300),
    (POISSON_LEN, POISSON_LEN, POISSON_LEN),
    *((n, n, n) for n in LONG_1D),
]
# a[i] = u_i rho^i, b[j] = v_j rho^j (u, v in [0.5, 1)), rho^n = 1e-36:
# output k is a sum of terms of one scale rho^k, held at atol 1e-37
GEOMETRIC_LEN = 16384
DENSE_512 = ((512, 512), (512, 512), (512, 512))
DENSE_256 = ((256, 256), (256, 256), (256, 256))
MAIN_PATH = ((95, 1), (95, 87), (95, 87))  # phase 4's largest product
# the largest product phase 8's two_populations run gives K1 (an (n, 1)
# operand: K1's dense body transposed)
K1_MAIN_PATH = ((308, 1), (308, 274), (308, 274))
# the shape classes of K1's calls on phase 8's two_populations(2000): 2x2
# stencils (nearly every call) and (n, 1) operands; the small body takes
# those of at most SMALL_MAX_COEFFS coefficients, the dense body
# transposed the longer ones
K1_SMALL_PATH = ((255, 268), (2, 2), (255, 268))
K1_CLASSES = [
    K1_SMALL_PATH,
    ((308, 314), (2, 2), (308, 314)),
    ((268, 274), (41, 1), (268, 274)),
    K1_MAIN_PATH,
]
K1_DENSE_512 = ((512, 512),) * 3
#: K1's body -> (source, the shape of the kernel table's times: the main
#: path's stencil, the bench's order, the main path's largest product)
K1_BODIES = {
    "small": ("genfer_tpu_torch/csrc/conv2d_small_f64.cu", K1_SMALL_PATH),
    "dense": ("genfer_tpu_torch/csrc/conv2d_trunc_f64.cu", K1_DENSE_512),
    "dense_t": ("genfer_tpu_torch/csrc/conv2d_trunc_f64.cu", K1_MAIN_PATH),
}
K1_REPLACES = "genfer_tpu/taylor/backend.py:979"
DENSE_ORDERS = (256, 384, 512, 768)

#: kernel -> (source, TPU kernel it replaces, the shape of the kernel
#: table's times: the largest product phase 4 sends K2, the bench's
#: largest order for K4a / K4b, its 256 x B32 for K3, phase 6's for K6)
KERNELS = {
    "conv2d_trunc_f32": (
        "genfer_tpu_torch/csrc/conv2d_trunc_f32.cu",
        "genfer_tpu/ops/pallas_conv2d.py:189",
        (MAIN_PATH, 1)),
    "conv2d_trunc_f32_tile": (
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_tile.cu",
        "genfer_tpu/ops/pallas_conv2d.py:80", (DENSE_512, 1)),
    "conv2d_trunc_f32_grouped": (
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_grouped.cu",
        "genfer_tpu/ops/pallas_conv2d.py:297", (DENSE_512, 1)),
    "conv2d_trunc_f32_batched": (
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_batched.cu",
        "genfer_tpu/ops/pallas_conv2d.py:457", (DENSE_256, 32)),
    "conv1d_trunc_f32": (
        "genfer_tpu_torch/csrc/conv1d_trunc_f32.cu",
        "genfer_tpu/ops/pallas_conv.py:29",
        ((POISSON_LEN, POISSON_LEN, POISSON_LEN), 1)),
    # one table entry for each of its bodies (``K1_BODIES``)
    "conv2d_trunc_f64": None,
}

# K1, the f64 2-D product (phases 7-10).  Its shapes: those of
# tests/test_conv_block.py::SHAPES (ragged, c1 > a1 + b1 - 1, square
# truncated, full, c0 < b0, degenerate first axis) and square orders, each
# on standard-normal operands (max abs error over max |plain| <= K1_TOL)
# and on operands in [0, 1) (elementwise rtol K1_TOL); a 3-axis product
# through TorchF64Backend.conv_trunc (one launch over the pairs); and an
# extreme pair, a's columns scaled 1e-150 .. 1e150 and b's 1e-20 .. 1e20,
# each output column held against its own max
K1_TOL = 1e-12
K1_SHAPES = [
    ((60, 47), (52, 61), (55, 50)),
    ((33, 64), (64, 20), (96, 83)),
    ((64, 64), (64, 64), (64, 64)),
    ((64, 64), (64, 64), (127, 127)),
    ((40, 30), (20, 25), (59, 54)),
    ((16, 5), (3, 40), (10, 12)),
    ((1, 33), (9, 33), (9, 40)),
]
K1_ORDERS = (256, 512, 768, 1024)
K1_3AXIS = ((24, 20, 18), (16, 20, 18), (24, 20, 18))
K1_EXTREME = ((130, 140), (120, 100), (130, 140))
K1_BATCH = 4  # entries of the batched call held against single pairs
# a batch of each body: dense, small, dense transposed
K1_BATCH_SHAPES = [K1_EXTREME, K1_SMALL_PATH, K1_MAIN_PATH]
PLAIN_ROWS = 128  # output rows a strip of the plain version above 512
# phase 8: --backend jax end to end at these sizes (seed 0), against the
# host f64 --backend numpy run at the reference's is_close
E2E_SIZE = 2000  # two_populations; the f32 route prints Z = NaN here
POP_SIZE, POP_VARS = 1000, 2
K1_SMALL_MIN = 1400  # of two_populations(2000)'s K1 launches (of ~1530)
BOUNDS_EXAMPLE = "scam_calls.sgcl"
HEADLINE_ITERS, HEADLINE_HOST_ITERS = 4, 1  # the bench's are 8 and 3

# phase 11: compiled serving (at bench.SERVING_BATCH = 4096)
SERVING_PRODUCTS = 26  # K1 products a walk of the scam model at limit 26
SERVING_CHECK = 16  # grid points held against the host api.infer
SERVING_LARGEST = ((27, 27), (2, 2), (27, 28))  # its largest K1 product
DIGIT_PIXELS, DIGIT_BATCH, DIGIT_CHECK = 784, 1024, 4
DIGIT_SEED = 0
MODEL_REL = 1e-9  # phase 12 against the CPU classes, and phase 11's digits
POP_REL = 1e-10  # phase 12 against the host interpreter
SCAN_LIMIT, SCAN_STEPS, SCAN_BATCH = 256, 20, 64  # the bench's sizes

# phase 13: the scan compiler (scanc.py).  Each program of the in-repo
# generators (seed 0) with the order genfer_tpu's compile_scan_program
# converges at from order 128 on the CPU (tests/test_torch_scanc.py holds
# the port to genfer_tpu's order at the smaller sizes)
SCAN_PROGRAMS = (  # label, generator, its arguments, converged order
    ("hmm(30)", "generate_hmm", (30,), 256),
    ("mixture", "generate_mixture", (), 128),
    ("switchpoint", "generate_switchpoint", (), 128),
    ("population(500, 1)", "generate_population", (500, 1), 256),
    ("two_populations(500)", "generate_two_populations", (500,), 256),
    ("two_populations(2000)", "generate_two_populations", (2000,), 1024),
)
SCAN_ORDER = 128  # the CLI's --scan-order
SCAN_REL = 1e-12  # batched serving against run_with_data and the CPU
# masses below the smallest normal f64 keep fewer than 53 bits: held
# absolutely there (as tests/test_torch_scanc.py does)
SCAN_ATOL = float(np.finfo(np.float64).tiny)
# tests/test_scanc.py::test_param_ratio_serving_sweep's program
SWEEP_TEMPLATE = """nr ~ Poisson(6);
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
SWEEP_P = (0.2, 0.3, 0.5)
CASCADE_SEED = 0  # the fresh counts of the cascade's serving run

#: the kernels whose operations bound is the tensor cores' TF32 rate (K6
#: where it runs its tensor-core body: ``_passes``)
TENSOR_CORE_KERNELS = ("conv2d_trunc_f32_tile", "conv2d_trunc_f32_grouped",
                       "conv1d_trunc_f32")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase1_card() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    # the f32 plain versions are cuBLAS products and the library calls
    # cuDNN convolutions: keep both in IEEE f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase2_build() -> None:
    from genfer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s wall, nvcc "
          f"{_build.build_seconds:.3f} s -> {_build.library_path().name}")


SLOW_MS = 500.0  # a call above this is timed once, cold


def _time(fn) -> float:
    """Milliseconds a call of ``fn``, from CUDA events: the first call is
    timed cold and kept if it took over ``SLOW_MS`` (a yardstick hundreds
    of times slower than the kernel needs no second digit); otherwise one
    timed probe, then as many calls as fit in ~0.1 s (1 to 200)."""
    from genfer_tpu_torch.bench import time_ms

    cold = time_ms(fn, 1, warmup=0)
    if cold > SLOW_MS:
        return cold
    probe = time_ms(fn, 1, warmup=0)
    reps = max(1, min(200, int(100.0 / max(probe, 1e-3))))
    return probe if reps == 1 else time_ms(fn, reps, warmup=0)


def _conv2d_library(a, b, out):
    """One cuDNN call computing the truncated product of ``a`` (B, a0, a1)
    with ``b`` (b0, b1): a correlation of ``a`` padded by (b0-1, b1-1) in
    front with the flipped ``b``.  The padding and the flip are made once,
    outside the timed call."""
    (b0, b1), (c0, c1) = b.shape, out
    x = torch.zeros((a.shape[0], 1, c0 + b0 - 1, c1 + b1 - 1),
                    dtype=a.dtype, device=a.device)
    r0, r1 = min(a.shape[1], c0), min(a.shape[2], c1)
    x[:, 0, b0 - 1:b0 - 1 + r0, b1 - 1:b1 - 1 + r1] = a[:, :r0, :r1]
    w = torch.flip(b, dims=(0, 1))[None, None].contiguous()
    return lambda: F.conv2d(x, w)


def _conv1d_library(a, b, lc):
    lb = b.shape[0]
    x = torch.zeros((1, 1, lc + lb - 1), dtype=a.dtype, device=a.device)
    r = min(a.shape[0], lc)
    x[0, 0, lb - 1:lb - 1 + r] = a[:r]
    w = torch.flip(b, dims=(0,))[None, None].contiguous()
    return lambda: F.conv1d(x, w)


def _check(name, got, want, rtol, atol=ATOL) -> tuple[float, float]:
    """Fail unless ``got`` is finite, of ``want``'s shape and within
    ``rtol`` / ``atol`` of it; return its max abs and rel error."""
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        fail(f"{name}: bad shape {tuple(got.shape)} or non-finite")
    diff = (got.double() - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        err = (diff / (atol + rtol * want.abs())).max().item()
        fail(f"{name}: off by {err:.3g}x the rtol {rtol} / atol {atol} bar "
             "against f64")
    return diff.max().item(), (diff / want.abs().clamp_min(atol)).max().item()


def _library(library, want, atol=ATOL) -> tuple[float, float]:
    """Time ``library()`` and read its max rel error against ``want``
    (printed, not held: cuDNN may pick an algorithm of another accuracy).
    The call that yields the result is timed, and is the only one where it
    takes over ``SLOW_MS``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lib = library().reshape(want.shape).double()
    end.record()
    torch.cuda.synchronize()
    cold = start.elapsed_time(end)
    ms = cold if cold > SLOW_MS else _time(library)
    return ms, ((lib - want).abs()
                / want.abs().clamp_min(atol)).max().item()


def _measure(name, kernel, plain, library, want, rtol, label,
             atol=ATOL) -> dict:
    """Hold ``kernel()`` and ``plain()`` against ``want`` and time both;
    ``library`` is ``_library``'s result for the same operands."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err = _check(f"{name} {label}", got, want, rtol, atol)
    _check(f"{name} plain {label}", ref, want, rtol, atol)
    row = {"max_abs_err": abs_err, "max_rel_err": rel_err,
           "ms": _time(kernel), "plain_ms": _time(plain),
           "library_ms": library[0]}
    print(f"phase 3 {name} {label}: max abs err {abs_err:.3e}, max rel err "
          f"{rel_err:.3e}; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
          f"(max rel err {library[1]:.3e})")
    return row


def phase3_kernels() -> dict:
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.ops.conv2d import tile_body
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64_reference

    rng = np.random.default_rng(0)
    rows: dict = {name: {} for name in KERNELS}
    cases = [(shape, ATOL) for shape in SHAPES] + [(EXTREME, ATOL_EXTREME)]
    for (sa, sb, out), atol in cases:
        a, b = rng.random(sa), rng.random(sb)
        if atol == ATOL_EXTREME:
            a = a * 10.0 ** np.linspace(-30, 30, sa[1])
            b = b * 10.0 ** np.linspace(-6, 6, sb[1])
        a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        a32, b32 = a64.float(), b64.float()
        want = conv2d_trunc_f64_reference(a64, b64, out)
        library = _library(_conv2d_library(a32[None], b32, out), want, atol)
        label = f"{sa}x{sb}->{out}" + (
            " extreme scales" if atol == ATOL_EXTREME else "")
        key = (sa, sb, out) if atol == ATOL else "extreme"
        for name in ("conv2d_trunc_f32", "conv2d_trunc_f32_tile",
                     "conv2d_trunc_f32_grouped"):
            kernel = getattr(ops, name)
            rows[name][(key, 1)] = _measure(
                name, lambda k=kernel: k(a32, b32, out),
                lambda: ops.conv2d_trunc_f32_reference(a32, b32, out),
                library, want, RTOL, label, atol)
        for name in ("conv2d_trunc_f32", "conv2d_trunc_f32_tile",
                     "conv2d_trunc_f32_grouped"):
            kernel = getattr(ops, name)
            if not torch.equal(kernel(a32, b32, out), kernel(a32, b32, out)):
                fail(f"{name} {label}: two calls differ")
        print(f"phase 3 {label}: same bits twice from K2, K4a and K4b; "
              f"K4a / K4b ran the {tile_body(sa, sb)} body")
        del want
        for batch in (BATCHES if max(out) <= MAX_ORDER_B32
                      else BATCHES[:1]):
            ab = rng.random((batch, *sa))
            if atol == ATOL_EXTREME:
                ab = ab * 10.0 ** np.linspace(-30, 30, sa[1])
            ab = torch.from_numpy(ab).cuda()
            ab32 = ab.float()
            want_b = torch.stack([conv2d_trunc_f64_reference(x, b64, out)
                                  for x in ab])
            blabel = f"B={batch} {label}"
            rows["conv2d_trunc_f32_batched"][(key, batch)] = _measure(
                "conv2d_trunc_f32_batched",
                lambda: ops.conv2d_trunc_f32_batched(ab32, b32, out),
                lambda: ops.conv2d_trunc_f32_batched_reference(
                    ab32, b32, out),
                _library(_conv2d_library(ab32, b32, out), want_b, atol),
                want_b, RTOL, blabel, atol)
            got_b = ops.conv2d_trunc_f32_batched(ab32, b32, out)
            for g in range(batch):
                if not torch.equal(
                        got_b[g], ops.conv2d_trunc_f32(ab32[g], b32, out)):
                    fail(f"conv2d_trunc_f32_batched {blabel}: entry {g} "
                         "differs from the single-pair kernel")
            del ab, ab32, want_b, got_b
    rows["conv1d_trunc_f32"] = phase3_conv1d(rng)
    return rows


def phase3_conv1d(rng) -> dict:
    """K6 on ``SHAPES_1D`` and the geometric pair against its plain
    version and the folded f64 product, the same bits twice, and the body
    it ran."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.ops.conv1d import fold_body, folded_product

    rows = {}
    # cuDNN's first conv1d of the process sets itself up (0.6 s): not in
    # any timed call
    x = torch.ones((1, 1, 8), device="cuda")
    F.conv1d(x, x[..., :3])
    torch.cuda.synchronize()
    cases = [(shape, False) for shape in SHAPES_1D]
    cases.append(((GEOMETRIC_LEN,) * 3, True))
    for (la, lb, lc), geometric in cases:
        if geometric:
            rho = 10.0 ** (-36.0 / lc)
            a = (0.5 + 0.5 * rng.random(la)) * rho ** np.arange(la)
            b = (0.5 + 0.5 * rng.random(lb)) * rho ** np.arange(lb)
        else:
            a, b = rng.random(la), rng.random(lb)
        a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        a32, b32 = a64.float(), b64.float()
        want = folded_product(a64, b64, lc)
        atol = ATOL_EXTREME if geometric else ATOL
        label = f"({la},)x({lb},)->({lc},)" + (
            " geometric" if geometric else "")

        def kernel():
            return ops.conv1d_trunc_f32(a32, b32, lc)

        rows[("geometric" if geometric else (la, lb, lc), 1)] = _measure(
            "conv1d_trunc_f32", kernel,
            lambda: ops.conv1d_trunc_f32_reference(a32, b32, lc),
            _library(_conv1d_library(a32, b32, lc), want, atol), want,
            RTOL_1D, label, atol)
        if not torch.equal(kernel(), kernel()):
            fail(f"conv1d_trunc_f32 {label}: two calls differ")
        print(f"phase 3 {label}: same bits twice from K6; it ran the "
              f"{fold_body(la, lb, lc)} body")
        del want
    return rows


def _kernel_name(name: str) -> str:
    """A device event's kernel name without namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]


def device_us_by_kernel(call, calls: int) -> dict:
    """The card's time of one ``call()`` in microseconds by kernel name:
    the device events ``torch.profiler`` records over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.name)
            kernels[name] = (kernels.get(name, 0.0)
                             + e.time_range.elapsed_us() / calls)
    return kernels


def _host_and_device_us(call, what: str, calls: int = 200) -> str:
    """What one ``call()`` costs the host (the wrapper and its launches,
    not waiting for the card) and the card (``device_us_by_kernel``)."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    kernels = device_us_by_kernel(call, calls)
    device_us = sum(kernels.values())
    if not device_us > 0:
        fail(f"torch.profiler recorded no device time for {what}")
    return (f"host {host_us:.2f} us a call (wrapper and launch, not "
            f"waiting), device {device_us:.2f} us a call (torch.profiler: "
            + ", ".join(f"{k} {v:.2f}" for k, v in kernels.items()) + ")")


def phase3_plans_and_host_cost() -> None:
    """The work-unit plans at the dense orders (K2's, which K3 shares, and
    the j0-only plan of K4a / K4b with the multiply-adds it issues over the
    useful ones) and K6's at its long lengths, and what one K2 call of the
    end-to-end run's largest shape and one K6 call of phase 6's length
    cost the host and the card (``_host_and_device_us``)."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.ops import conv1d as C1
    from genfer_tpu_torch.ops.conv2d import issued_macs, unit_plan
    from genfer_tpu_torch.taylor.host import _conv_pair_flops

    for order in DENSE_ORDERS:
        shape = (order, order)
        for kernels, cut_j1 in (("K2 / K3", True), ("K4a / K4b", False)):
            plan = unit_plan(shape, shape, shape, cut_j1)
            w = plan.weights()
            useful = _conv_pair_flops(shape, shape, shape)
            issued = "" if cut_j1 else (
                ", issued / useful multiply-adds "
                f"{issued_macs(plan, shape, shape) / useful:.3f}")
            print(f"phase 3 unit plan order {order} {kernels}: {len(w)} "
                  f"units, {len(plan.sums)} tiles of several units, "
                  f"{plan.slots} slots, heaviest unit "
                  f"{w.max() / w.mean():.3f} x the mean{issued}")
    for n in (POISSON_LEN, *LONG_1D):
        plan = C1.fold_plan(n, n, n)
        w = plan.weights()
        print(f"phase 3 fold plan length {n} K6: {len(w)} units, "
              f"{len(plan.sums)} tiles of several units, {plan.slots} "
              f"slots, heaviest unit {w.max() / w.mean():.3f} x the mean, "
              "issued / useful multiply-adds "
              f"{C1.issued_macs(plan) / (n * (n + 1) / 2):.4f}")
    sa, sb, out = MAIN_PATH
    a = torch.rand(sa, device="cuda")
    b = torch.rand(sb, device="cuda")
    cost = _host_and_device_us(lambda: ops.conv2d_trunc_f32(a, b, out),
                               "conv2d_trunc_f32")
    print(f"phase 3 conv2d_trunc_f32 {sa}x{sb}->{out}: "
          f"{len(unit_plan(sa, sb, out).units)} units; {cost}")
    n = POISSON_LEN
    a, b = torch.rand(n, device="cuda"), torch.rand(n, device="cuda")
    cost = _host_and_device_us(lambda: ops.conv1d_trunc_f32(a, b, n),
                               "conv1d_trunc_f32")
    print(f"phase 3 conv1d_trunc_f32 ({n},)x({n},)->({n},): "
          f"{len(C1.fold_plan(n, n, n).units)} units, "
          f"{C1.fold_body(n, n, n)} body; {cost}")


def _capture(main, argv) -> tuple[str, float]:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue(), time.perf_counter() - t0


def _wrappers() -> dict:
    from genfer_tpu_torch import ops

    return {name: getattr(ops, name) for name in KERNELS}


def _k1_by_body() -> dict:
    """K1's launch counts by body, under their kernel-table names."""
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64

    return {f"conv2d_trunc_f64[{body}]": n
            for body, n in conv2d_trunc_f64.launches_by_body.items()}


@contextlib.contextmanager
def _counted(launches: dict, must: tuple, what: str):
    """Set every kernel's launch count (and K1's by body) to 0, run the
    block, then add the counts to ``launches``; fail if a kernel of
    ``must`` was not launched."""
    from genfer_tpu_torch.ops.conv2d_f64 import reset_launches

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    reset_launches()
    yield
    counts = {name: w.launches for name, w in wrappers.items()}
    counts.update(_k1_by_body())
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    for name in must:
        if counts[name] < 1:
            fail(f"{what} never launched {name}")
    print(f"{what}: launches " + ", ".join(
        f"{name} {n}" for name, n in counts.items() if n))


def phase4_end_to_end(launches: dict) -> None:
    from genfer_tpu_torch import cli
    from genfer_tpu_torch.taylor.backend import PallasBackend
    from genfer_tpu_torch.tools.generators import generate_two_populations

    if PallasBackend.PALLAS_OFFLOAD_FLOPS != int(float(OFFLOAD_FLOPS)):
        fail(f"PallasBackend routes at {PallasBackend.PALLAS_OFFLOAD_FLOPS} "
             f"multiply-adds, not {OFFLOAD_FLOPS}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"two_populations_{SIZE}.sgcl"
        generate_two_populations(path, SIZE, seed=0)
        flags = [str(path), "--no-timing", "--backend"]
        with _counted(launches, ("conv2d_trunc_f32",), "phase 4"):
            port_out, port_s = _capture(cli.main, flags + ["pallas"])
        host_out, host_s = _capture(cli.main, flags + ["numpy"])
    got, want = read_results(port_out), read_results(host_out)
    if set(got) != set(want):
        fail(f"printed results differ: {sorted(set(got) ^ set(want))}")
    worst = 0.0
    compared = 0
    for key, w in want.items():
        if key.endswith("/ Z") and w < P_MIN:
            continue
        g = got[key]
        if not np.isfinite(g):
            fail(f"{key} = {g}")
        dev = abs(g - w) / max(abs(w), 1e-300)
        if not dev <= E2E_RTOL:
            fail(f"{key}: {g} vs host f64 {w} (rel {dev:.3e})")
        worst = max(worst, dev)
        compared += 1
    print(f"phase 4 two_populations({SIZE}) --backend pallas: {compared} "
          f"results within rel {E2E_RTOL} of host f64 (max rel dev "
          f"{worst:.3e}; tail bounds not compared: they are differences of "
          f"nearly equal sums), port {port_s:.3f} s, host {host_s:.3f} s "
          "wall")
    _check_no_jax()


def _check_no_jax() -> None:
    loaded = [m for m in sys.modules
              if m in ("jax", "genfer_tpu")
              or m.startswith(("jax.", "genfer_tpu."))]
    if loaded:
        fail(f"the port loaded {loaded[:5]}")


def phase5_bench(launches: dict) -> dict:
    from genfer_tpu_torch import bench

    with _counted(launches, ("conv2d_trunc_f32", "conv2d_trunc_f32_tile",
                             "conv2d_trunc_f32_grouped",
                             "conv2d_trunc_f32_batched"), "phase 5"):
        results = bench.run_pallas(seed=0, iters=BENCH_ITERS)
    for key, rows in results.items():
        if key.startswith("pallas_"):
            for size, row in rows.items():
                print(f"phase 5 {key} {size}: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in row.items()
                    if isinstance(v, float)))
    return results


def phase6_ops_api(launches: dict) -> None:
    """The law of the sum of two independent Poisson counts, as the
    truncated product of their pmf series through the ops API."""
    from genfer_tpu_torch.ops import conv1d_trunc_f32

    k = np.arange(POISSON_LEN)

    def pmf(rate):
        logs = k * math.log(rate) - rate - np.array(
            [math.lgamma(i + 1.0) for i in k])
        return np.exp(logs)

    p1, p2 = (torch.from_numpy(pmf(r)).float().cuda()
              for r in POISSON_RATES)
    with _counted(launches, ("conv1d_trunc_f32",), "phase 6"):
        got = conv1d_trunc_f32(p1, p2, POISSON_LEN)
        torch.cuda.synchronize()
    want = torch.from_numpy(pmf(sum(POISSON_RATES))).cuda()
    abs_err, _ = _check("phase 6 Poisson sum", got, want, RTOL_1D)
    print(f"phase 6 Poisson({POISSON_RATES[0]:g}) + "
          f"Poisson({POISSON_RATES[1]:g}) through ops.conv1d_trunc_f32: "
          f"pmf within rtol {RTOL_1D} / atol {ATOL} of "
          f"Poisson({sum(POISSON_RATES):g}) (max abs err {abs_err:.3e}, "
          f"total mass {float(got.double().sum()):.9f})")


def _plain_rows(out):
    """Strip height of K1's plain version: whole above order 512 would
    hold ~8 c0 a1 b1 doubles (~69 GB at 1024)."""
    return PLAIN_ROWS if max(out) > 512 else None


def _k1_gate(name, got, want, how) -> float:
    """Fail unless ``got`` is finite, of ``want``'s shape and within
    ``K1_TOL`` of it: ``"norm"`` (max abs error over max |want|),
    ``"elementwise"`` (each entry at rtol), ``"columns"`` (each output
    column against its own max).  Returns the max abs error."""
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        fail(f"{name}: bad shape {tuple(got.shape)} or non-finite")
    diff = (got - want).abs()
    if how == "norm":
        bar = K1_TOL * want.abs().max()
    elif how == "elementwise":
        bar = K1_TOL * want.abs()
    else:
        bar = K1_TOL * want.abs().amax(dim=-2, keepdim=True)
    if not bool((diff <= bar).all()):
        worst = float((diff / bar.clamp_min(1e-300)).max())
        fail(f"{name}: off by {worst:.3g}x the {how} bar {K1_TOL}")
    return float(diff.max())


def phase7_k1() -> dict:
    """K1 against its plain version on the card (module docstring)."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import F64_MMA, product_bound
    from genfer_tpu_torch.ops.conv2d_f64 import dense_issued_macs, k1_body
    from genfer_tpu_torch.taylor.backend import TorchF64Backend
    from genfer_tpu_torch.taylor.host import NumpyF64Backend, _conv_pair_flops

    K = ops.conv2d_trunc_f64
    rng = np.random.default_rng(1)
    rows: dict = {}
    cases = [(shape, "normal") for shape in K1_SHAPES]
    cases += [(((n, n),) * 3, "normal") for n in K1_ORDERS]
    cases += [(shape, "uniform") for shape in K1_SHAPES]
    cases += [(((n, n),) * 3, "uniform") for n in K1_ORDERS[:2]]
    cases += [(shape, "uniform") for shape in K1_CLASSES]
    cases += [(K1_EXTREME, "extreme")]
    # cuDNN beside the classes and the orders (standard-normal operands)
    library_cases = [(shape, "uniform") for shape in K1_CLASSES]
    library_cases += [(((n, n),) * 3, "normal") for n in K1_ORDERS]
    for (sa, sb, out), kind in cases:
        if kind == "normal":
            a, b = rng.standard_normal(sa), rng.standard_normal(sb)
        else:
            a, b = rng.random(sa), rng.random(sb)
        if kind == "extreme":
            a = a * 10.0 ** np.linspace(-150, 150, sa[1])
            b = b * 10.0 ** np.linspace(-20, 20, sb[1])
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        body = k1_body(sa, sb, out)
        label = f"{sa}x{sb}->{out} {kind} ({body} body)"
        before = dict(K.launches_by_body)
        got = K(a, b, out)
        if K.launches_by_body[body] != before[body] + 1:
            fail(f"conv2d_trunc_f64 {label}: the {body} body did not run")
        want = ops.conv2d_trunc_f64_reference(a, b, out, _plain_rows(out))
        how = {"normal": "norm", "uniform": "elementwise",
               "extreme": "columns"}[kind]
        err = _k1_gate(f"conv2d_trunc_f64 {label}", got, want, how)
        of_max = err / float(want.abs().max())
        if not torch.equal(got, K(a, b, out)):
            fail(f"conv2d_trunc_f64 {label}: two calls differ")
        del want
        row = {"body": body, "max_abs_err": err,
               "ms": _time(lambda: K(a, b, out)),
               "plain_ms": _time(lambda: ops.conv2d_trunc_f64_reference(
                   a, b, out, _plain_rows(out)))}
        if ((sa, sb, out), kind) in library_cases:
            row["library_ms"], lib_err = _library(
                _conv2d_library(a[None], b, out), got, ATOL)
        bound, by = product_bound(sa, sb, out, rate=F64_MMA)
        row["bound_ms"], row["bound_by"] = bound, by
        rows[((sa, sb, out), kind)] = row
        issued = "" if body == "small" else (
            ", issued / useful multiply-adds {:.3f}".format(
                dense_issued_macs(sa, sb, out, body == "dense_t")
                / _conv_pair_flops(sa, sb, out)))
        print(f"phase 7 conv2d_trunc_f64 {label}: max abs err {err:.3e} "
              f"({of_max:.3e} of the max; {how} gate {K1_TOL}), same bits "
              "twice; kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
              + (f", library {row['library_ms']:.4f} ms (cuDNN f64, max "
                 f"rel err {lib_err:.3e})" if "library_ms" in row else "")
              + f", bound {bound:.4g} ms ({by}), share "
              f"{100 * bound / row['ms']:.1f}%{issued}")
        del got
    # host and device time of one call at the main path's stencil and its
    # largest product, K1 beside cuDNN (calls of a few us read the host's
    # launch rate in CUDA-event time)
    for sa, sb, out in (K1_SMALL_PATH, K1_MAIN_PATH):
        a = torch.from_numpy(rng.random(sa)).cuda()
        b = torch.from_numpy(rng.random(sb)).cuda()
        k1 = _host_and_device_us(lambda: K(a, b, out), "conv2d_trunc_f64")
        lib = _host_and_device_us(_conv2d_library(a[None], b, out),
                                  "cuDNN conv2d")
        print(f"phase 7 {sa}x{sb}->{out} ({k1_body(sa, sb, out)} body): "
              f"K1 {k1}; cuDNN f64 {lib}")
    # a batch of each body: every entry equals its single-pair call
    for sa, sb, out in K1_BATCH_SHAPES:
        ab = torch.from_numpy(rng.standard_normal((K1_BATCH, *sa))).cuda()
        bb = torch.from_numpy(rng.standard_normal((K1_BATCH, *sb))).cuda()
        got = ops.conv2d_trunc_f64_batched(ab, bb, out)
        body = k1_body(sa, sb, out)
        _k1_gate(f"conv2d_trunc_f64_batched {sa}x{sb} ({body} body)", got,
                 ops.conv2d_trunc_f64_batched_reference(ab, bb, out), "norm")
        for z in range(K1_BATCH):
            if not torch.equal(got[z], K(ab[z], bb[z], out)):
                fail(f"conv2d_trunc_f64_batched {sa}x{sb} ({body} body) "
                     f"entry {z} differs from the single-pair call")
        print(f"phase 7 batch of {K1_BATCH} {sa}x{sb}->{out} normal ({body} "
              "body): every entry equals its single-pair call bit for bit")
    # a 3-axis product: one launch over every pair of leading rows
    sa, sb, out = K1_3AXIS
    a, b = rng.standard_normal(sa), rng.standard_normal(sb)
    before = K.launches
    got = TorchF64Backend().conv_trunc(torch.from_numpy(a).cuda(),
                                       torch.from_numpy(b).cuda(), out)
    launched = K.launches - before
    want = torch.from_numpy(NumpyF64Backend().conv_trunc(a, b, out)).cuda()
    err = _k1_gate("TorchF64Backend.conv_trunc 3-axis", got, want, "norm")
    if launched != 1:
        fail(f"the 3-axis product launched K1 {launched} times, not once")
    print(f"phase 7 TorchF64Backend.conv_trunc {sa}x{sb}->{out}: one K1 "
          f"launch over {sa[0] * sb[0]} pairs, max abs err {err:.3e} "
          "against the host f64 product (norm gate)")
    return rows


def _agree(got: dict, want: dict, what: str, scale: float | None = None
           ) -> int:
    """Hold ``got`` to ``want`` as ``printed.disagreements`` does (is_close,
    ``Z`` and, with ``scale``, every value relative to that scale); return
    the number compared."""
    bad = disagreements(got, want, scale)
    if bad:
        fail(f"{what}: " + "; ".join(bad[:5]) + " (host f64)")
    return len(want)


def read_intervals(text: str) -> dict[str, tuple[float, float]]:
    """The intervals a run printed (``X ∈ [lo, hi]``), by symbol, as
    ``read_results`` reads points."""
    out = {}
    for line in text.splitlines():
        if "∈ [" in line and "<=" not in line:
            key, rest = line.split("∈ [")
            lo, hi = rest.rstrip("]").split(", ")
            out[key.split(":")[-1].strip()] = (float(lo), float(hi))
    return out


def _endpoints(text: str) -> dict[str, float]:
    return {f"{key} {end}": v for key, iv in read_intervals(text).items()
            for end, v in zip(("lo", "hi"), iv)}


def phase8_backend_jax(launches: dict) -> None:
    """``--backend jax`` end to end on the card against ``--backend
    numpy``: the examples, two_populations and population at the sizes
    above; one ``--bounds --backend jax`` run whose intervals hold the
    host f64 points."""
    from genfer_tpu_torch import cli
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64
    from genfer_tpu_torch.tools.generators import (
        generate_population,
        generate_two_populations,
    )

    examples = sorted((Path(__file__).resolve().parent / "examples")
                      .glob("*.sgcl"))
    with tempfile.TemporaryDirectory() as tmp:
        tp = Path(tmp) / f"two_populations_{E2E_SIZE}.sgcl"
        generate_two_populations(tp, E2E_SIZE, seed=0)
        pop = Path(tmp) / f"population_{POP_SIZE}_{POP_VARS}.sgcl"
        generate_population(pop, POP_SIZE, POP_VARS, seed=0)
        by_body = conv2d_trunc_f64.launches_by_body
        with _counted(launches, ("conv2d_trunc_f64",
                                 "conv2d_trunc_f64[small]"), "phase 8"):
            for path in [*examples, tp, pop]:
                flags = [str(path), "--no-timing", "--backend"]
                before = dict(by_body)
                port_out, port_s = _capture(cli.main, flags + ["jax"])
                runs = {k: by_body[k] - before[k] for k in by_body}
                host_out, host_s = _capture(cli.main, flags + ["numpy"])
                n = _agree(read_results(port_out), read_results(host_out),
                           path.name)
                n += _agree(_endpoints(port_out), _endpoints(host_out),
                            path.name)
                print(f"phase 8 {path.name} --backend jax: {n} results at "
                      f"is_close (rel {IS_CLOSE[0]}, abs {IS_CLOSE[1]}; Z at "
                      f"rel {IS_CLOSE[0]} of itself) to "
                      f"--backend numpy; port {port_s:.3f} s, host "
                      f"{host_s:.3f} s wall; K1 launches by body "
                      + ", ".join(f"{k} {v}" for k, v in runs.items()))
                if path in (tp, pop) and runs["small"] < 1:
                    fail(f"{path.name}: K1's small body never ran")
                if path == tp and runs["small"] < K1_SMALL_MIN:
                    fail(f"{path.name}: K1's small body ran {runs['small']} "
                         f"of {sum(runs.values())} launches, under "
                         f"{K1_SMALL_MIN}")
            path = [p for p in examples if p.name == BOUNDS_EXAMPLE][0]
            flags = [str(path), "--no-timing", "--backend"]
            iv_out, iv_s = _capture(cli.main, flags + ["jax", "--bounds"])
            host_out, _ = _capture(cli.main, flags + ["numpy"])
            ivs, points = read_intervals(iv_out), read_results(host_out)
            held = 0
            for key, v in points.items():
                if key in ivs and math.isfinite(v):
                    lo, hi = ivs[key]
                    if not lo <= v <= hi:
                        fail(f"--bounds --backend jax {path.name}: {key} = "
                             f"{v} outside [{lo}, {hi}]")
                    held += 1
            if held < 3:
                fail(f"--bounds --backend jax {path.name}: {held} intervals")
            print(f"phase 8 {path.name} --bounds --backend jax: {held} "
                  f"intervals hold the host f64 points ({iv_s:.3f} s wall)")
    _check_no_jax()


def phase9_entry(launches: dict) -> None:
    """The ``entry()`` twin on the card against its operands on the CPU."""
    from genfer_tpu_torch.entry import entry

    with _counted(launches, ("conv2d_trunc_f64",), "phase 9"):
        forward, args = entry()
        quot, total = forward(*args)
        torch.cuda.synchronize()
    want_q, want_t = forward(*(x.cpu() for x in args))
    err = _k1_gate("entry() quotient", quot.cpu(), want_q, "norm")
    dt = abs(float(total) - float(want_t))
    if not dt <= K1_TOL * abs(float(want_t)):
        fail(f"entry() total {float(total)} against {float(want_t)}")
    print(f"phase 9 entry(): quotient {tuple(quot.shape)} within {K1_TOL} "
          f"of its max of the CPU run (max abs err {err:.3e}), total "
          f"{float(total):.15g}")


def phase10_headline(launches: dict) -> dict:
    from genfer_tpu_torch import bench

    with _counted(launches, ("conv2d_trunc_f64",), "phase 10"):
        results = bench.run_headline(seed=0, iters=HEADLINE_ITERS,
                                     host_iters=HEADLINE_HOST_ITERS)
    row = results["f64_kernel"][str(bench.ORDER)]
    host = results["host_kernel"][str(bench.ORDER)]
    print(f"phase 10 f64 headline order {bench.ORDER}: K1 {row['ms']:.4f} ms "
          f"a step, {row['gflops']:.1f} GF/s ({HEADLINE_ITERS} steps), "
          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({100 * row['bound_share']:.1f}%), max err "
          f"{row['max_err_vs_plain']:.3e} of the max; host C++ "
          f"{host['ms']:.1f} ms, {host['gflops']:.2f} GF/s; K1 "
          f"{results['vs_host']:.1f} x the host")
    return results


def _profiled(call):
    """``call()`` under torch.profiler: its result, the wall seconds, and
    by kernel name the launches and the card's busy milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "Memcpy" not in e.name \
                and "Memset" not in e.name:
            n, ms = kernels.get(_kernel_name(e.name), (0, 0.0))
            kernels[_kernel_name(e.name)] = (
                n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out, wall, kernels


def _replay_profile(call, reps: int = 3) -> tuple[float, float, dict]:
    """``reps`` calls of ``call()`` (a graph replay) under torch.profiler:
    the wall milliseconds of one, the card's busy milliseconds of one (the
    sum of its kernels), and by kernel name the launches and busy
    milliseconds of one."""
    call()
    _, wall, kernels = _profiled(lambda: [call() for _ in range(reps)])
    kernels = {k: (n / reps, ms / reps) for k, (n, ms) in kernels.items()}
    busy = sum(ms for _, ms in kernels.values())
    return wall / reps * 1e3, busy, kernels


def _profile_line(wall: float, busy: float, kernels: dict) -> str:
    """A replay's profile: wall, busy share, kernels, the four costliest
    kernel names with their launches and busy milliseconds."""
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:4]
    return (f"a replay under torch.profiler: {wall:.3f} ms wall, card busy "
            f"{busy:.3f} ms ({100 * busy / wall:.1f}%), "
            f"{sum(n for n, _ in kernels.values()):.0f} kernels ("
            + ", ".join(f"{k} {n:.0f} launches {ms:.3f} ms"
                        for k, (n, ms) in top)
            + ")")


def _grouped_library(a, b, out):
    """One ``conv2d`` call computing the truncated products of every pair
    ``a[z]`` (a0, a1), ``b[z]`` (b0, b1): a grouped correlation of the
    padded ``a`` (one channel an entry) with the flipped ``b`` (one filter
    a group)."""
    batch, (b0, b1), (c0, c1) = a.shape[0], b.shape[1:], out
    x = torch.zeros((1, batch, c0 + b0 - 1, c1 + b1 - 1), dtype=a.dtype,
                    device=a.device)
    r0, r1 = min(a.shape[1], c0), min(a.shape[2], c1)
    x[0, :, b0 - 1:b0 - 1 + r0, b1 - 1:b1 - 1 + r1] = a[:, :r0, :r1]
    w = torch.flip(b, dims=(1, 2))[:, None].contiguous()
    return lambda: F.conv2d(x, w, groups=batch)


def phase11_k1_batched(rng) -> dict:
    """K1's small body at the serving walk's largest product over the
    4096-entry batch: against its plain version (elementwise rtol K1_TOL)
    and one grouped f64 ``conv2d``; times, device time and bound."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import F64_MMA, SERVING_BATCH, bound_ms
    from genfer_tpu_torch.ops.conv2d_f64 import k1_body
    from genfer_tpu_torch.taylor.host import _conv_pair_flops

    sa, sb, out = SERVING_LARGEST
    batch = SERVING_BATCH
    a = torch.from_numpy(rng.random((batch, *sa))).cuda()
    b = torch.from_numpy(rng.random((batch, *sb))).cuda()
    body = k1_body(sa, sb, out)
    got = ops.conv2d_trunc_f64_batched(a, b, out)
    want = ops.conv2d_trunc_f64_batched_reference(a, b, out)
    err = _k1_gate(f"conv2d_trunc_f64_batched B={batch} {sa}x{sb}", got,
                   want, "elementwise")
    library = _grouped_library(a, b, out)
    lib_err = float(((library()[0] - want).abs()
                     / want.abs().clamp_min(1e-300)).max())
    macs = batch * _conv_pair_flops(sa, sb, out)
    nbytes = 8.0 * batch * (np.prod(sa) + np.prod(sb) + np.prod(out))
    bound, by = bound_ms(macs, nbytes, rate=F64_MMA)
    row = {"body": body, "max_abs_err": err,
           "ms": _time(lambda: ops.conv2d_trunc_f64_batched(a, b, out)),
           "plain_ms": _time(lambda: ops.conv2d_trunc_f64_batched_reference(
               a, b, out)),
           "library_ms": _time(library), "bound_ms": bound, "bound_by": by}
    dev = _graph_ms(lambda: ops.conv2d_trunc_f64_batched(a, b, out))
    lib_dev = _graph_ms(library)
    print(f"phase 11 K1 batched B={batch} {sa}x{sb}->{out} ({body} body): "
          f"max abs err {err:.3e} (elementwise gate {K1_TOL}); kernel "
          f"{row['ms']:.4f} ms ({dev:.4f} ms a call in a graph of "
          f"{GRAPH_CALLS}), plain {row['plain_ms']:.4f} ms, the grouped f64 "
          f"conv2d {row['library_ms']:.4f} ms ({lib_dev:.4f} ms in a graph; "
          f"max rel err {lib_err:.3e}), bound {bound:.4g} ms ({by}), share "
          f"{100 * bound / row['ms']:.1f}% of the kernel's time, "
          f"{100 * bound / dev:.1f}% of its time in a graph")
    return row


GRAPH_CALLS = 20  # calls captured in _graph_ms's graph


def _graph_ms(call) -> float:
    """Milliseconds a call of ``call()`` on the card without the host's
    share: ``GRAPH_CALLS`` calls captured in one CUDA graph, its replays
    timed with CUDA events (the gaps between the graph's nodes included;
    torch.profiler's device time of this call varied threefold between
    runs of this script)."""
    from genfer_tpu_torch.bench import time_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            call()
    return time_ms(graph.replay, 5) / GRAPH_CALLS


def _points_agree(got, want, what: str) -> float:
    """Hold each ``got`` to ``want`` at the reference's is_close; return
    the max relative deviation."""
    rel, abs_ = IS_CLOSE
    worst = 0.0
    for g, w in zip(got, want):
        if not abs(g - w) <= abs_ + rel * abs(w):
            fail(f"{what}: {g} against host f64 {w}")
        worst = max(worst, abs(g - w) / max(abs(w), 1e-300))
    return worst


def _rel_agree(got, want, rel: float, what: str, atol: float = 0.0
               ) -> float:
    """Fail unless every entry of ``got`` is within ``rel`` of ``want``'s
    or within ``atol`` of it (elementwise, finite); return the max
    relative deviation."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        fail(f"{what}: shape {got.shape} against {want.shape}, or "
             "non-finite")
    dev = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    if not np.all((dev <= rel) | (got == want)
                  | (np.abs(got - want) <= atol)):
        fail(f"{what}: max rel deviation {dev.max():.3e} over {rel}")
    return float(dev.max())


def _digit_evidence(rng, batch: int):
    """A seeded theta (10 classes x DIGIT_PIXELS: about a quarter of the
    pixels inked, theta in [0.05, 0.95] there and [0.001, 0.02] on the
    background) and ``batch`` images drawn from it, folded into the
    evidence vectors ``e = x theta + (1 - x)(1 - theta)`` in the model's
    parameter order (class-major)."""
    n = DIGIT_PIXELS
    ink = rng.random(n) < 0.25
    theta = np.where(ink, rng.uniform(0.05, 0.95, (10, n)),
                     rng.uniform(0.001, 0.02, (10, n)))
    images = rng.random((batch, n)) < theta[rng.integers(0, 10, batch)]
    x = images[:, None, :].astype(np.float64)
    return (x * theta + (1.0 - x) * (1.0 - theta)).reshape(batch, 10 * n)


def phase11_serving(launches: dict) -> dict:
    """Compiled serving on the card (module docstring)."""
    from genfer_tpu_torch import api
    from genfer_tpu_torch.bench import (
        SERVING_BATCH,
        SERVING_LIMIT,
        SERVING_SRC,
        _best_of,
    )
    from genfer_tpu_torch.compile import CompiledProgram
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64
    from genfer_tpu_torch.tools.generators import digit_serving_source

    out: dict = {}
    t0 = time.perf_counter()
    c = CompiledProgram(SERVING_SRC, ["p"], SERVING_LIMIT, device="cuda")
    translate = time.perf_counter() - t0
    batch = SERVING_BATCH
    grid = torch.linspace(0.01, 0.99, batch, dtype=torch.float64,
                          device="cuda").reshape(batch, 1)
    t0 = time.perf_counter()
    eager = c._probs_batch.eager(grid)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    by_body = conv2d_trunc_f64.launches_by_body
    with _counted(launches, ("conv2d_trunc_f64", "conv2d_trunc_f64[small]"),
                  "phase 11 serving capture"):
        t0 = time.perf_counter()
        got = c.probs_batch(grid)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        captured = dict(by_body)
    if captured != {"small": SERVING_PRODUCTS, "dense": 0, "dense_t": 0}:
        fail(f"the captured serving walk launched K1 {captured}, not "
             f"{SERVING_PRODUCTS} small-body launches")
    if not torch.equal(got, eager):
        fail("serving: the replay differs from the eager walk")
    if not torch.equal(c.probs_batch(grid), got):
        fail("serving: two replays differ")
    other = grid.flip(0)
    if not torch.equal(c.probs_batch(other), c._probs_batch.eager(other)):
        fail("serving: the replay on a second grid differs from its eager "
             "walk")
    if tuple(got.shape) != (batch, SERVING_LIMIT) or not bool(
            torch.isfinite(got).all()):
        fail(f"serving: shape {tuple(got.shape)} or non-finite")
    idx = np.linspace(0, batch - 1, SERVING_CHECK).round().astype(int)
    host = got.cpu().numpy()
    worst = 0.0
    for i in idx:
        p = float(grid[i, 0])
        r = api.infer(SERVING_SRC.replace("$p", repr(p)))
        want = [x.to_float() for x in r.probs(SERVING_LIMIT,
                                              normalized=False)]
        worst = max(worst, _points_agree(host[i], want, f"serving p={p}"))
    replay = _best_of(lambda: c.probs_batch(grid).cpu(), 5)
    wall, busy, kernels = _replay_profile(lambda: c.probs_batch(grid))
    small = sum(n for k, (n, _) in kernels.items() if "small_f64" in k)
    if small != SERVING_PRODUCTS:
        fail(f"serving: a replay launched K1's small body {small} times")
    out["serving"] = {"translate_s": translate, "eager_s": eager_s,
                      "capture_s": capture_s, "replay_s": replay,
                      "inferences_per_s": batch / replay,
                      "replay_wall_ms": wall, "replay_busy_ms": busy,
                      "kernels_per_replay": sum(
                          n for n, _ in kernels.values())}
    print(f"phase 11 serving scam model B={batch}: replay equals the eager "
          f"walk bit for bit (two grids); {SERVING_CHECK} points at "
          f"is_close to host f64 api.infer (max rel dev {worst:.3e}); "
          f"translate {translate:.3f} s, eager walk {eager_s:.3f} s, "
          f"capture {capture_s:.3f} s, replay {replay * 1e3:.3f} ms with "
          f"read-back = {batch / replay:.0f} inferences/s; "
          + _profile_line(wall, busy, kernels))
    # K1 alone at the walk's largest product, before the digit model's
    # profile (~47,000 kernels a replay) fills the profiler's buffers
    out["k1_batched"] = phase11_k1_batched(np.random.default_rng(DIGIT_SEED))
    # the 784-pixel digit model
    rng = np.random.default_rng(DIGIT_SEED)
    src, params = digit_serving_source(DIGIT_PIXELS)
    t0 = time.perf_counter()
    d = CompiledProgram(src, params, 10, device="cuda")
    translate = time.perf_counter() - t0
    ev = torch.from_numpy(_digit_evidence(rng, DIGIT_BATCH)).cuda()
    with _counted(launches, (), "phase 11 digit capture"):
        t0 = time.perf_counter()
        dgot = d.probs_batch(ev)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    replay = _best_of(lambda: d.probs_batch(ev).cpu())
    wall, busy, kernels = _replay_profile(lambda: d.probs_batch(ev), 1)
    cpu = CompiledProgram(src, params, 10, device="cpu")
    want = cpu.probs_batch(ev[:DIGIT_CHECK].cpu()).numpy()
    worst = _rel_agree(dgot[:DIGIT_CHECK].cpu().numpy(), want, MODEL_REL,
                       "digit model")
    post = dgot / dgot.sum(dim=1, keepdim=True)
    if not bool(torch.isfinite(post).all()):
        fail("digit model: a posterior is not finite")
    out["digit"] = {"translate_s": translate, "capture_s": capture_s,
                    "replay_s": replay,
                    "inferences_per_s": DIGIT_BATCH / replay,
                    "replay_wall_ms": wall, "replay_busy_ms": busy,
                    "kernels_per_replay": sum(
                        n for n, _ in kernels.values())}
    print(f"phase 11 digit model {DIGIT_PIXELS} pixels B={DIGIT_BATCH}: "
          f"{DIGIT_CHECK} rows within rel {MODEL_REL} of the eager CPU walk "
          f"(max rel dev {worst:.3e}); translate {translate:.3f} s, warm-up "
          f"and capture {capture_s:.3f} s, replay {replay * 1e3:.3f} ms "
          f"with read-back = {DIGIT_BATCH / replay:.0f} images/s; "
          + _profile_line(wall, busy, kernels))
    _check_no_jax()
    return out


def _host_text(src: str, *flags: str) -> str:
    """The port's host interpreter (``--backend numpy``) on ``src``."""
    from genfer_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.sgcl"
        path.write_text(src)
        text, _ = _capture(cli.main, [str(path), "--no-timing", *flags,
                                      "--backend", "numpy"])
    return text


def _host_probs(src: str, limit: int) -> dict[int, float]:
    """The host interpreter's unnormalized masses on ``src``."""
    return {int(k[2:-1]): v for k, v in read_masses(
        _host_text(src, "--limit", str(limit))).items()}


def _against_host(got, ref: dict, what: str) -> float:
    if len(ref) < 10:
        fail(f"{what}: the host run printed {len(ref)} masses")
    worst = 0.0
    for k, v in ref.items():
        if v > 1e-290:
            dev = abs(got[k] - v) / v
            if not dev <= POP_REL:
                fail(f"{what}: p({k}) = {got[k]} against host {v} (rel "
                     f"{dev:.3e})")
            worst = max(worst, dev)
    return worst


def _timed_model(call) -> tuple[np.ndarray, float, float]:
    """The first call's result and seconds (it captures the graph), and
    the least seconds of three more (each ends in a read-back)."""
    from genfer_tpu_torch.bench import _best_of

    t0 = time.perf_counter()
    got = call()
    first = time.perf_counter() - t0
    return got, first, _best_of(call)


def phase12_scan_models(launches: dict) -> dict:
    """The scan models on the card (module docstring)."""
    from genfer_tpu_torch.models import (
        CompiledHMM,
        CompiledMixture,
        CompiledPopulation,
        CompiledTwoPopulations,
    )
    from genfer_tpu_torch.tools.generators import (
        COAL_MINING_DATA,
        population_scan_source,
        two_populations_scan_source,
    )

    out: dict = {}
    rows = []
    with _counted(launches, (), "phase 12"):
        rng = np.random.RandomState(0)  # the bench's data
        kw = dict(limit=SCAN_LIMIT, max_steps=SCAN_STEPS,
                  init_lambda=0.0257 * 4 * SCAN_LIMIT, slack=96)
        cp = CompiledPopulation(0.2636, 0.2, device="cuda", **kw)
        lams, cs = rng.uniform(10, 50, SCAN_STEPS), rng.poisson(8, SCAN_STEPS)
        got, first, best = _timed_model(lambda: cp.probs(lams, cs))
        dev = _against_host(got, _host_probs(population_scan_source(
            kw["init_lambda"], lams, cs, 0.2636, 0.2), SCAN_LIMIT),
            "population")
        rows.append(("population", first, best, f"host interpreter, max rel "
                     f"dev {dev:.3e}"))
        bl = rng.uniform(10, 50, (SCAN_BATCH, SCAN_STEPS))
        bc = rng.poisson(8, (SCAN_BATCH, SCAN_STEPS))
        got, first, best = _timed_model(lambda: cp.probs_batch(bl, bc))
        cpu = CompiledPopulation(0.2636, 0.2, device="cpu", **kw)
        dev = _rel_agree(got, cpu.probs_batch(bl, bc), MODEL_REL,
                         "population batch")
        rows.append((f"population B={SCAN_BATCH}", first, best,
                     f"CPU class, max rel dev {dev:.3e}"))
        d1, d2, mig, rho, init = 0.23724, 0.2636, 0.1, 0.2, (2.313, 0.257)
        tp = CompiledTwoPopulations(d1, d2, mig, rho, rho, limit=SCAN_LIMIT,
                                    max_steps=SCAN_STEPS, init_lams=init,
                                    slack=48, device="cuda")
        args = (rng.uniform(5, 20, SCAN_STEPS), rng.uniform(1, 3, SCAN_STEPS),
                rng.poisson(3, SCAN_STEPS), rng.poisson(1, SCAN_STEPS))
        got, first, best = _timed_model(lambda: tp.probs(*args))
        dev = _against_host(got, _host_probs(two_populations_scan_source(
            init, *args, d1, d2, mig, rho), SCAN_LIMIT), "two populations")
        rows.append(("two populations", first, best,
                     f"host interpreter, max rel dev {dev:.3e}"))
        counts = rng.poisson(2, 30)
        h = CompiledHMM(n_rates=256, max_steps=32, device="cuda")
        got, first, best = _timed_model(lambda: h.probs(counts))
        dev = _rel_agree(got, CompiledHMM(n_rates=256, max_steps=32,
                                          device="cpu").probs(counts),
                         MODEL_REL, "hmm")
        rows.append(("hmm 256 rates, 30 counts", first, best,
                     f"CPU class, max rel dev {dev:.3e}"))
        coal = [c for c in COAL_MINING_DATA if c >= 0]
        m = CompiledMixture(n_rates=320, max_steps=128, device="cuda")
        got, first, best = _timed_model(lambda: m.probs(coal))
        dev = _rel_agree(got, CompiledMixture(n_rates=320, max_steps=128,
                                              device="cpu").probs(coal),
                         MODEL_REL, "mixture")
        rows.append((f"mixture 320 rates, {len(coal)} counts", first, best,
                     f"CPU class, max rel dev {dev:.3e}"))
    for name, first, best, held in rows:
        out[name] = {"capture_s": first, "replay_ms": best * 1e3}
        print(f"phase 12 {name}: against the {held}; first call (capture) "
              f"{first:.3f} s, replay {best * 1e3:.3f} ms with read-back")
    _check_no_jax()
    return out


def _gemm_line(wall: float, kernels: dict) -> str:
    """The card's busy time split into cuBLAS DGEMM and the rest."""
    gemm = [v for k, v in kernels.items() if "gemm" in k.lower()]
    rest = [v for k, v in kernels.items() if "gemm" not in k.lower()]
    g_ms, r_ms = sum(ms for _, ms in gemm), sum(ms for _, ms in rest)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:3]
    return (f"card busy {g_ms + r_ms:.3f} ms of {wall * 1e3:.1f} ms traced "
            f"wall ({100 * (g_ms + r_ms) / (wall * 1e3):.2f}%): DGEMM "
            f"{g_ms:.3f} ms in {sum(n for n, _ in gemm)} launches, other "
            f"kernels {r_ms:.3f} ms in {sum(n for n, _ in rest)} ("
            + ", ".join(f"{k} {n} launches {ms:.3f} ms"
                        for k, (n, ms) in top) + ")")


def _scan_cli(path: Path) -> tuple[str, float]:
    """``python -m genfer_tpu_torch <path> --compile-scan`` in a child
    process (the port's default device: the card): stdout and wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "genfer_tpu_torch", str(path), "--no-timing",
         "--compile-scan"], capture_output=True, text=True, timeout=900,
        cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"--compile-scan {path.name}: rc {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    if "falling back" in proc.stderr:
        fail(f"--compile-scan {path.name} fell back: {proc.stderr.strip()}")
    return proc.stdout, wall


def _masses_agree(got, text: str, what: str) -> int:
    """Hold masses ``got`` (host numpy) and their sum to the unnormalized
    masses and Z an interpreter run printed, each at rel 1e-9 of that Z."""
    host = read_masses(text)
    if len(host) < 3:
        fail(f"{what}: the interpreter printed {len(host)} masses")
    mine = {k: float(got[int(k[2:-1])]) for k in host}
    mine["Z"] = float(np.sum(got))
    host["Z"] = read_results(text)["Z"]
    return _agree(mine, host, what, scale=host["Z"])


def phase13_scan_compiler(launches: dict) -> dict:
    """The scan compiler on the card (module docstring)."""
    from genfer_tpu_torch import api, cli
    from genfer_tpu_torch.bench import (
        GENERIC_BATCH,
        GENERIC_MAX_STEPS,
        GENERIC_ORDER,
        GENERIC_STEPS,
        _best_of,
        card,
    )
    from genfer_tpu_torch.lang.parser import parse_program
    from genfer_tpu_torch.scanc import (
        CascadeCompiled,
        ScanCompiled,
        compile_scan_program,
    )
    from genfer_tpu_torch.tools import generators

    out: dict = {}
    tag = f"phase 13 [{card()}]"
    with _counted(launches, (), "phase 13"), \
            tempfile.TemporaryDirectory() as tmp:
        for label, gen, gen_args, order in SCAN_PROGRAMS:
            path = Path(tmp) / f"{gen}.sgcl"
            text = getattr(generators, gen)(path, *gen_args)
            host_out, host_s = _capture(cli.main, [
                str(path), "--no-timing", "--backend", "numpy"])
            port_out, port_s = _scan_cli(path)
            host_z = read_results(host_out)["Z"]
            n = _agree(read_results(port_out), read_results(host_out), label)
            got, want = read_masses(port_out), read_masses(host_out)
            n += _agree(got, want, label, scale=host_z)
            dev = max(abs(got[k] - w) for k, w in want.items()) / host_z
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            obj, (masses, _) = compile_scan_program(parse_program(text),
                                                    order=SCAN_ORDER)
            torch.cuda.synchronize()
            in_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**20
            n += _masses_agree(masses, host_out, f"{label} in process")
            if obj.order != order:
                fail(f"{label}: converged at order {obj.order}, not {order}")
            kind = type(obj).__name__
            if isinstance(obj, ScanCompiled) and obj.device.type != "cuda":
                fail(f"{label}: compiled for {obj.device}")
            _, wall, kernels = _profiled(lambda: compile_scan_program(
                parse_program(text), order=SCAN_ORDER))
            out[label] = {"order": obj.order, "cli_s": port_s,
                          "host_s": host_s, "compile_validate_s": in_s,
                          "peak_mib": peak}
            print(f"{tag} {label} --compile-scan: {kind} converged at "
                  f"order {obj.order}; {n} results agree with --backend "
                  f"numpy (moments and p(k)/Z at is_close, rel {IS_CLOSE[0]}"
                  f" / abs {IS_CLOSE[1]}; Z and the unnormalized masses of "
                  "the CLI run and of the in-process object at rel "
                  f"{IS_CLOSE[0]} of Z, the CLI's masses within {dev:.2e} Z, "
                  f"Z = {host_z:.6e}); "
                  f"CLI {port_s:.3f} s wall in a child process (host "
                  f"interpreter {host_s:.3f} s in process); in process "
                  f"compile and validate {in_s:.3f} s, peak device memory "
                  f"{peak:.1f} MiB; under torch.profiler "
                  + (_gemm_line(wall, kernels) if kernels else
                     f"no kernel ({wall * 1e3:.1f} ms, host numpy)"))

        # serving: the mixture batch through one CUDA graph
        gen_src = generators.generate_mixture(None)
        t0 = time.perf_counter()
        obj = api.compile_serving(gen_src, order=GENERIC_ORDER,
                                  max_steps=GENERIC_MAX_STEPS)
        compile_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)  # the bench's counts
        bc = rng.integers(0, 8, size=(GENERIC_BATCH, GENERIC_STEPS)
                          ).astype(np.float64)
        cols = [bc] * len(obj.rep.data)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got, totals = obj.run_batch(cols)
        capture_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        again, _ = obj.run_batch(cols)
        if not np.array_equal(again, got):
            fail("generic serving: two replays differ")
        if got.shape != (GENERIC_BATCH, obj.sizes[obj.program.result]) or \
                not (np.isfinite(got).all() and (totals > 0).all()):
            fail(f"generic serving: shape {got.shape} or a bad total")
        worst = 0.0
        for i in range(GENERIC_BATCH):
            one, _ = obj.run_with_data([c[i] for c in cols])
            worst = max(worst, _rel_agree(got[i], one, SCAN_REL,
                                          f"generic serving row {i}",
                                          SCAN_ATOL))
        cpu = api.compile_serving(gen_src, order=GENERIC_ORDER,
                                  max_steps=GENERIC_MAX_STEPS, device="cpu")
        cpu_dev = _rel_agree(got, cpu.run_batch(cols)[0], SCAN_REL,
                             "generic serving on the CPU", SCAN_ATOL)
        replay = _best_of(lambda: obj.run_batch(cols))
        wall, busy, kernels = _replay_profile(lambda: obj.run_batch(cols))
        out["generic_serving"] = {
            "order": obj.order, "compile_validate_s": compile_s,
            "capture_s": capture_s, "replay_s": replay,
            "inferences_per_s": GENERIC_BATCH / replay,
            "replay_wall_ms": wall, "replay_busy_ms": busy,
            "kernels_per_replay": sum(n for n, _ in kernels.values()),
            "peak_mib": peak}
        print(f"{tag} generic serving mixture B={GENERIC_BATCH} x "
              f"{GENERIC_STEPS} counts (order {obj.order}, "
              f"{GENERIC_MAX_STEPS} steps): every row within rel {SCAN_REL} "
              f"of run_with_data (max rel dev {worst:.3e}) and of the CPU "
              f"object (max rel dev {cpu_dev:.3e}); compile and validate "
              f"{compile_s:.3f} s, first run_batch (host prep, warm-up and "
              f"capture) {capture_s:.3f} s, peak device memory {peak:.1f} "
              f"MiB; replay {replay * 1e3:.3f} ms with host prep and "
              f"read-back = {GENERIC_BATCH / replay:.0f} inferences/s; "
              + _profile_line(wall, busy, kernels))

        # a $param sweep through one vmapped graph
        sweep = api.compile_serving(SWEEP_TEMPLATE.format(p="$p"), order=64,
                                    params={"p": SWEEP_P[1]})
        masses, _ = sweep.run_param_sweep([{"p": p} for p in SWEEP_P])
        n = 0
        for row, p in zip(masses, SWEEP_P):
            n += _masses_agree(row, _host_text(SWEEP_TEMPLATE.format(
                p=repr(p)), "--limit", str(len(row))), f"sweep p={p}")
        print(f"{tag} $param sweep over p = {SWEEP_P} (order "
              f"{sweep.order}): {n} masses and totals at rel 1e-9 of Z to the "
              "host interpreter with each value inlined")

        # cascade serving: fresh counts of the discrete switchpoint.  A
        # cascade serves fresh counts at the order it was compiled at and
        # checks no convergence for them (as genfer_tpu's does: ROADMAP
        # Queue 3), so it is held to the interpreter at the order the
        # rewritten source converges at; at the committed data's order
        # its deviation is printed
        src = generators.generate_switchpoint(None)
        casc = api.compile_serving(src, order=SCAN_ORDER)
        if not isinstance(casc, CascadeCompiled):
            fail(f"switchpoint compiled as {type(casc).__name__}")
        data = list(generators.COAL_MINING_DATA)
        committed = [d for d in data if d >= 0]
        fresh = np.random.default_rng(CASCADE_SEED).poisson(
            np.mean(committed), casc.rep.n_iters)
        it = iter(fresh.tolist())
        fresh_src = generators.generate_switchpoint(
            None, data=[next(it) if d >= 0 else d for d in data])
        _rel_agree(casc.run_with_counts(committed)[0], casc.run()[0],
                   SCAN_REL, "cascade serving of the committed counts")
        fobj, (fmasses, _) = compile_scan_program(parse_program(fresh_src),
                                                  order=SCAN_ORDER)
        host = _host_text(fresh_src, "--limit", str(len(fmasses)))
        host_z, want = read_results(host)["Z"], read_masses(host)
        low, _ = casc.run_with_counts(fresh)
        low_dev = max(abs(low[int(k[2:-1])] - w) for k, w in want.items())
        served = api.compile_serving(src, order=fobj.order)
        if served.order != fobj.order:
            fail(f"cascade serving compiled at order {fobj.order} "
                 f"converged at {served.order}")
        t0 = time.perf_counter()
        masses, _ = served.run_with_counts(fresh)
        casc_s = time.perf_counter() - t0
        dev = _rel_agree(masses, fmasses, SCAN_REL,
                         "cascade serving against compiling its counts")
        n = _masses_agree(masses, host, "cascade serving")
        print(f"{tag} cascade serving: discrete switchpoint on "
              f"{casc.rep.n_iters} fresh seeded counts (host numpy, "
              f"{casc_s * 1e3:.3f} ms) at order {served.order}, where the "
              f"rewritten source converges: within rel {SCAN_REL} of "
              f"compiling it (max rel dev {dev:.3e}), {n} masses and Z at "
              "rel 1e-9 of Z to the host interpreter on it; served at the "
              f"committed counts' order {casc.order} instead, the masses "
              f"deviate by up to {low_dev / host_z:.3e} Z (truncation; "
              "ROADMAP Queue 3)")
    _check_no_jax()
    return out


def print_shares(rows: dict, bench: dict) -> None:
    """The kernels' shares of their bounds (``bound_ms`` over the
    measured time): K2, K4a and K4b from phase 3's dense orders (K4a and
    K4b against the tensor cores' rate for their three TF32 passes, with
    K2's time in the same run beside theirs), K3 from phase 5's
    batches."""
    from genfer_tpu_torch.bench import F64_MMA, SPLIT_PASSES, product_bound

    for name, passes in (("conv2d_trunc_f32", None),
                         ("conv2d_trunc_f32_tile", SPLIT_PASSES),
                         ("conv2d_trunc_f32_grouped", SPLIT_PASSES)):
        parts = []
        for order in DENSE_ORDERS:
            shape = (order, order)
            key = ((shape,) * 3, 1)
            ms = rows[name][key]["ms"]
            bound, by = product_bound(shape, shape, shape, passes=passes)
            if not bound <= ms:
                fail(f"{name} order {order}: {ms} ms is under its bound "
                     f"{bound} ms")
            beside = "" if passes is None else (
                f" (K2 {rows['conv2d_trunc_f32'][key]['ms']:.4f} ms)")
            parts.append(f"{order}: {ms:.4f} ms = {100 * bound / ms:.1f}%"
                         f"{beside}")
        print(f"share of bound ({by}), {name} " + ", ".join(parts))
    print("share of bound, conv2d_trunc_f32_batched " + ", ".join(
        f"{size}: {row['ms_batch']:.4f} ms = {100 * row['bound_share']:.1f}%"
        for size, row in bench["pallas_batched"].items()))
    parts = []
    for n in (POISSON_LEN, *LONG_1D):
        shape = (n, n, n)
        ms = rows["conv1d_trunc_f32"][(shape, 1)]["ms"]
        bound, by = product_bound((n,), (n,), (n,),
                                  passes=_passes("conv1d_trunc_f32", shape))
        if not bound <= ms:
            fail(f"conv1d_trunc_f32 length {n}: {ms} ms is under its bound "
                 f"{bound} ms")
        parts.append(f"{n}: {ms:.4f} ms = {100 * bound / ms:.1f}% of "
                     f"{bound:.4g} ms, {by}")
    print("share of bound, conv1d_trunc_f32 " + ", ".join(parts))
    parts = []
    for n in K1_ORDERS:
        shape = (n, n)
        ms = rows["conv2d_trunc_f64"][((shape,) * 3, "normal")]["ms"]
        bound, by = product_bound(shape, shape, shape, rate=F64_MMA)
        if not bound <= ms:
            fail(f"conv2d_trunc_f64 order {n}: {ms} ms is under its bound "
                 f"{bound} ms")
        parts.append(f"{n}: {ms:.4f} ms = {100 * bound / ms:.1f}%")
    print(f"share of bound ({by}, {F64_MMA}), conv2d_trunc_f64 "
          + ", ".join(parts))


def _passes(name: str, shape) -> int | None:
    """The TF32 passes behind ``name``'s bound at ``shape`` (None: the
    FFMA rate): K4a and K4b always, K6 where it runs its tensor-core
    body."""
    from genfer_tpu_torch.bench import SPLIT_PASSES
    from genfer_tpu_torch.ops.conv1d import fold_body

    if name not in TENSOR_CORE_KERNELS:
        return None
    if name == "conv1d_trunc_f32" and fold_body(*shape) == "ffma":
        return None
    return SPLIT_PASSES


def _entry(name, source, replaces, launches, row, rows, bound, by,
           bound_rate) -> dict:
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        # over the unit-scale shapes (the extreme and geometric pairs'
        # outputs reach 1e36 and 1e-36, and are held by their relative
        # error)
        "max_abs_err": max(r["max_abs_err"] for k, r in rows.items()
                           if k[0] not in ("extreme", "geometric")
                           and k[1] != "extreme"),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        # "operations": of the f32 FMA rate, of the TF32 tensor rate for
        # the kernels that run there, or of the FP64 tensor rate for K1
        # (``bound_rate``)
        "bound_ms": bound, "bound_by": by.split()[-1],
        "bound_rate": bound_rate, "library_ms": row["library_ms"],
    }


def kernel_table(rows: dict, launches: dict) -> list:
    from genfer_tpu_torch.bench import F64_MMA, product_bound

    table = []
    for name, spec in KERNELS.items():
        if name == "conv2d_trunc_f64":
            continue
        source, replaces, key = spec
        shape, batch = key
        passes = _passes(name, shape)
        row = rows[name][key]
        if name == "conv1d_trunc_f32":
            la, lb, lc = shape
            bound, by = product_bound((la,), (lb,), (lc,), passes=passes)
        else:
            bound, by = product_bound(*shape, batch=batch, passes=passes)
        table.append(_entry(name, source, replaces, launches.get(name, 0),
                            row, rows[name], bound, by,
                            "f32 fma" if passes is None else "tf32 mma x 3"))
    k1 = rows["conv2d_trunc_f64"]
    for body, (source, shape) in K1_BODIES.items():
        kind = "normal" if shape == K1_DENSE_512 else "uniform"
        bound, by = product_bound(*shape, rate=F64_MMA)
        name = f"conv2d_trunc_f64[{body}]"
        table.append(_entry(
            name, source, K1_REPLACES, launches.get(name, 0),
            k1[(shape, kind)],
            {k: r for k, r in k1.items() if r["body"] == body}, bound, by,
            F64_MMA))
    return table


def main() -> None:
    # routing only: phase 4's f32 route takes 2-axis products of at least
    # OFFLOAD_FLOPS multiply-adds (the backend reads it at import)
    os.environ["GENFER_PALLAS_OFFLOAD_FLOPS"] = OFFLOAD_FLOPS
    phase1_card()
    phase2_build()
    rows = phase3_kernels()
    phase3_plans_and_host_cost()
    launches: dict = {}
    phase4_end_to_end(launches)
    bench = phase5_bench(launches)
    phase6_ops_api(launches)
    rows["conv2d_trunc_f64"] = phase7_k1()
    phase8_backend_jax(launches)
    phase9_entry(launches)
    phase10_headline(launches)
    phase11_serving(launches)
    phase12_scan_models(launches)
    phase13_scan_compiler(launches)
    print_shares(rows, bench)
    print(json.dumps({"kernels": kernel_table(rows, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
