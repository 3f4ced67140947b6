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
   ``conv2d`` (the library yardstick), beside its bound.  The spine
   kernel (``ops.spine_f64``: a constant spine of the walk in one launch)
   at ``SPINE_SHAPES`` (the digit model's, a 2-axis and a ragged one) bit
   for bit against its plain version, twice, its device time in a CUDA
   graph beside its bytes bound and the time of one block's rows (the
   chain of dependent f64 operations alone).  Then the 784-pixel digit
   model (``tools.generators.digit_serving_source``) at batch
   ``DIGIT_BATCH`` = 1024, a seeded theta and images drawn from it,
   through its graph (its warm-up and capture must launch the spine
   kernel once a class each), against the port's eager CPU walk on
   ``DIGIT_CHECK`` = 4 rows (rel 1e-9);
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
14. K5, the ozaki route (``genfer_tpu_torch.ops.ozaki_conv``): the split
   (``csrc/ozaki_split.cu``, both operands of every product in one
   launch) on the card equal to its plain version bit for bit (chunks in
   the kernel's layout, exponents, flags) at ``OZAKI_SHAPES`` for every
   (pair_bits, impl) of ``OZAKI_PASSES`` and on a batch with a non-finite
   entry, and the float split refused there; K5 (``csrc/ozaki_conv2d.cu``:
   its dense body, ``wgmma`` for int8, and its small body) against its
   plain version (``ozaki_conv2d_reference``, in row strips above order
   512) at ``OZAKI_TOL`` = 1e-13 of each output column's max, the same
   bits twice, at ``OZAKI_SHAPES`` (tests/test_ozaki_conv.py's), the
   square orders 256, 512 and 1024, the forced main path's shape classes
   ``OZAKI_MAIN_PATH`` (2x2 stencils, (n, 1) and (1, n) operands) and the
   extreme pairs (2^+-300 column scales, columns at 2^950 and 2^-980, the
   mixed case), each at pair_bits 5, 6, 7 in int8 and 7 in bf16, with the
   kernel's, the plain version's and K1's times, the bound, host and
   device microseconds a call (guarded, and of the split and K5 alone),
   and cuDNN's f64 ``conv2d`` at order 512 and at the main path's shapes;
   a NaN operand, which K5 leaves to the guard (K1's IEEE bits, counted
   on the device); the small body over the serving batch
   (``OZAKI_SERVING`` x 4096), a sample held to the plain version;
   ``ops.blocked_conv.conv2d_blocked`` with K5 inside at order 1024 (P =
   512) against a host-exact spot check; then the main path end to end:
   ``--backend jax`` on two_populations (seed 0) with
   ``GENFER_OZAKI=force`` and ``GENFER_OZAKI_MIN_FLOPS=0`` on the card,
   int8 and bf16, each against the same forced run on the CPU at rel
   ``OZAKI_REL`` = 1e-12 on every printed value: at ``E2E_SIZE`` = 2000,
   whose forced answer collapses to Z = 0 (the route's componentwise
   cliff, on the CPU as well), and at ``OZAKI_E2E_SIZE`` = 200, where it
   must stay finite with Z > 0 and route every product the default run
   sends to K1.  In each run every 2-axis f64 product is routed (int8),
   K5, the split and K1 predicated on the guard's flags launch once for
   every routed product, the guard's device count equals the routed
   products with a non-finite operand, and every
   ``OZAKI_E2E_STRIDE``-th routed product's operands and output are kept
   and held to the plain version at ``OZAKI_TOL`` after the counts are
   read, K5 run again on them for the same bits; the deviation from host
   f64 printed, not held; and the default env, which launches no K5.
   Last, the compiled mode under force (``_ozaki_compiled``): the scam
   model's batched walk over 4096 datasets, eager with no synchronize
   (torch.profiler), captured (K5 once a product of the captured walk)
   and replayed, equal to the eager walk bit for bit and to the eager
   forced ``--backend jax`` run at ``OZAKI_REL``, the guard's device count
   read; and a captured ``ozaki_op`` with a NaN entry, guarded at every
   replay.
15. the CLI's flags, the bench's ``--scaling`` and ``--suite``:
   ``--backend jax --profile DIR`` on two_populations(``OZAKI_E2E_SIZE``
   = 200), whose Chrome trace must parse and hold K1's kernels;
   ``--backend jax --debug-nans`` on two_populations(``E2E_SIZE``), which
   must print what the same run without the flag prints (no false alarm
   on the main path); one NaN forced through ``TorchF64Backend
   .conv_trunc`` (inf times 0 in K1) with the check on, which must raise
   ``FloatingPointError``; ``bench.bench_order_scaling`` at order and
   limit ``SCALING_SMOKE`` = 256, with no failed row, ``jax`` and
   ``hybrid`` at is_close of ``numpy`` and ``pallas`` within rel
   ``E2E_RTOL`` on Z, the moments and every p(k)/Z >= 1e-6 (phase 4's
   bar: this process routes at phase 4's ``OFFLOAD_FLOPS``); and the
   suite's in-repo stand-in over ``examples/*.sgcl`` (fp, ``--rational``
   and ``--backend jax``), every row held to host f64.
16. the mesh layer (``genfer_tpu_torch.parallel.mesh``): (a) the
   ``dryrun_multichip`` twin (``genfer_tpu_torch.entry``) on a one-rank
   NCCL group, its stage lines printed, K1's windowed launches (its
   inference step's) required; (b) every rank's local body of tp = 2, 4
   and 8 splits (``MESH_TPS``) on K1 at ``MESH_SHAPES`` (orders 512 and
   1024 dense, two_populations(2000)'s dense_t class): each rank's row
   window equal to the whole product's rows bit for bit and to the plain
   version's rows (``rows=``) at ``K1_TOL``, its ms per block
   beside the whole product's and the window's bound, the inference
   step's batched body likewise, and the halo schedule's bodies run in
   lock step at ``MESH_HALO`` against K1's whole product at rel
   ``K1_TOL``; (c) ``--backend sharded`` in-process on phase 8's
   two_populations and population (a group of one rank: no route
   shards) against ``--backend jax`` at is_close, with the walls.
17. the one-pass mode (``highest=False``: one TF32 pass, the TPU
   kernels' DEFAULT precision; each the ``wgmma`` body on operands that
   its C entry rounds once a call, K4b's in residue-major order, a chain
   per class) of K2, K4a, K4b (``SHAPES`` and
   ``EXTREME``) and K3 (at ``BATCHES``, order 768 at B = 3 only): each
   within phase 3's rtol / atol of its one-pass plain version (the f32
   product of ``tf32_round`` of both operands), within the one-pass bound
   of f64 (``ONE_PASS`` = 2^-10 plus ``RTOL`` of the product, the
   operands being >= 0, plus the atol), never equal to the three-pass
   result, the same bits twice; K2's one pass the one-pass tile kernel's
   bits, K4b's within 2e-6 relative (plus the atol) of them, every K3
   entry the single-pair one pass's; times of the kernel
   (K2, K4a and K4b in turns, the least of two each), its plain version
   and one cuDNN f32 ``conv2d`` with TF32 on (the same one-pass
   function) at ``ONE_PASS_TIMED``, and at its dense
   orders and K3's 256 x B32 a line of device microseconds a call
   (``device_us_queued``: CUDA events around calls queued behind a spin,
   so no host time is in them) of the tile kernel's call (its rounding
   launch and slot sum included) beside K4b's, each with the share of
   the issued bound (the line fails above 100%), and
   torch.profiler's split by kernel where its events cover the calls and
   sum to within 25% of the events' time.  The rounding kernel at every
   shape of ``SHAPES``: bit for bit ``tf32_round`` (the pad columns
   zero) and its device time beside its bytes bound; at order 512 also
   its time and its plain version's.  Then the
   mode's main path, counted: ``tune_port.py`` probe 19 (the twin of
   ``scripts/ozaki_diag.py::pallas_floor_decomposition``) at 256 and 512,
   which must launch all four one-pass kernels and the rounding kernel;
   the example twins at
   their defaults: ``examples/digit_serving_torch.py`` (784 pixels,
   batch 1024, a ``digitParams.csv`` written from ``RandomState(0)``),
   rows ``DIGIT_HOST_ROWS`` at is_close of the host interpreter, and
   ``examples/switchpoint_serving_torch.py`` on the generated coal-mining
   cascade (order 128, 200 datasets), the committed dataset's posterior
   at is_close of the host interpreter (Z printed beside it: the cascade
   at order 128 and the interpreter differ by ~1e-8 of it).

Each of phases 4-6, 8-13, 15, 16 (around (a) and each run of (c)) and
17 (around each of its main path's runs) sets the launch counts to 0 just
before it and reads them just after (phase 11's K1 launches are those of
the captured walk: a replay runs the graph, not the wrappers); phase 14
does the same for K5 and its split around each forced run.  Before the
table, the shares of their bounds of K2, K3, K4a, K4b, K6 (the
tensor-core kernels against the TF32 rate, three passes) with K2's time
beside K4a's and K4b's, of K1 (against the FP64 tensor rate) and of the
one-pass K2, K4a and K4b (one TF32 pass).  The second-to-last line is
the kernel table as JSON, with one entry for each of K1's bodies (and its
launches with a row window in phase 16, ``window_launches``), each of
K5's impls, one for the split, one for each one-pass kernel
(``[1pass]``), one for the rounding kernel and one for the spine kernel
(at the digit model's shape); the last line is
``{"ok": true, "device": {...}}``.
Everything is reached through ``genfer_tpu_torch``; nothing here imports
jax or genfer_tpu.

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
    read_endpoints,
    read_intervals,
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
#: the spine kernel (ops/spine_f64.py) at the digit model's shape (rows,
#: coefficients, links: one class's 784 observations, Mul by e then Add of
#: 0), at a 2-axis one (the scam walk's largest series, 27 x 28, and 64
#: links of mixed kinds) and at a ragged one (one coefficient, rows and
#: links no multiple of a block's or a flag word's); and the rows of one
#: block, where the chain of dependent f64 operations alone sets the time
SPINE_SHAPES = {"digit": (DIGIT_BATCH, (11,), 2 * DIGIT_PIXELS),
                "2-axis": (4096, (27, 28), 64),
                "ragged": (1000, (1,), 1001)}
SPINE_CHAIN_ROWS = 8
SPINE_SOURCE = "genfer_tpu_torch/csrc/spine_f64.cu"
SPINE_REPLACES = ("none: XLA fused the JAX walk's constant chain under "
                  "jit (gf/ir.py::GenFun._eval)")
#: the launches of the spine kernel a digit walk makes: one a class
DIGIT_SPINES = 10
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

# phase 14: K5, the ozaki route (ops/ozaki_conv.py).  Its shapes: those of
# tests/test_ozaki_conv.py::SHAPES (full, truncated square, ragged, outer,
# thin) and square truncated orders, at each (pair_bits, impl) of
# OZAKI_PASSES, against its plain version at OZAKI_TOL of each output
# column's max; the extreme pairs of that file (2^+-300 column scales,
# columns at 2^950 and 2^-980 and their mixed case) and a non-finite one
OZAKI_TOL = 1e-13
OZAKI_SHAPES = [
    ((64, 64), (64, 64), (127, 127)),
    ((64, 64), (64, 64), (64, 64)),
    ((33, 17), (21, 45), (40, 40)),
    ((128, 1), (1, 128), (128, 128)),
    ((5, 128), (128, 5), (132, 132)),
]
OZAKI_ORDERS = (256, 512, 1024)
#: the shape classes of the forced main path: K1's on two_populations(2000)
#: (2x2 stencils, the (n, 1) operands) and the forced run's (1, n) ones
OZAKI_MAIN_PATH = [
    *K1_CLASSES,
    ((200, 213), (2, 2), (200, 213)),
    ((1, 259), (2, 2), (2, 259)),
    ((1, 259), (259, 1), (259, 259)),
]
OZAKI_PASSES = ((5, "int8"), (6, "int8"), (7, "int8"), (7, "bf16"))
OZAKI_TABLE_ORDER = 512  # the kernel table's K5 shape (the bench's order)
OZAKI_BLOCKED = (1024, 512)  # conv2d_blocked with K5 inside: order, P
OZAKI_REL = 1e-12  # the forced --backend jax run, card against CPU
#: two_populations size of the second forced run: under force, E2E_SIZE's
#: answer collapses to Z = 0 (the route's componentwise cliff, on the CPU
#: too); at this size it stays finite, Z > 0, within ~5e-4 of host
OZAKI_E2E_SIZE = 200
OZAKI_E2E_STRIDE = 10  # every 10th routed product is held (_hold_kept)
#: the serving walk's largest product (the scam model's, tune_port.py
#: probe 12) over bench.SERVING_BATCH entries: K5's small body batched, as
#: the compiled mode's vmap rule runs it; every OZAKI_SERVING_STRIDE-th
#: entry is held to the plain version
OZAKI_SERVING = ((27, 27), (2, 2), (27, 28))
OZAKI_SERVING_STRIDE = 64
#: the compiled mode under force: the scam model (tests/
#: test_torch_ozaki_compile.py) at its 26 products a walk, served over
#: bench.SERVING_BATCH datasets, and the $p values held to the eager run
OZAKI_COMPILED_SRC = """calls ~ Poisson(10);
scams ~ Binomial(calls, $p);
observe(scams = 1);
return calls;"""
OZAKI_COMPILED_LIMIT = 26
OZAKI_COMPILED_HELD = (0.05, 0.5, 0.95)
#: host CUDA calls that wait for the card: none may run in the route
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
OZAKI_REPLACES = {
    "ozaki_split": "genfer_tpu/ops/ozaki_conv.py:121",
    "ozaki_conv2d": "genfer_tpu/ops/ozaki_conv.py:192",
}
OZAKI_SOURCES = {
    "ozaki_split": "genfer_tpu_torch/csrc/ozaki_split.cu",
    "ozaki_conv2d": "genfer_tpu_torch/csrc/ozaki_conv2d.cu",
}

# phase 16: the mesh layer (parallel/mesh.py) on the card.  The local
# bodies of every rank of a tp = MESH_TPS split, each on K1 in this
# process, at these shapes (dense orders 512 and 1024, and the dense_t
# class of two_populations(2000)); the halo schedule's bodies in lock
# step at MESH_HALO
MESH_TPS = (2, 4, 8)
MESH_SHAPES = [((512, 512),) * 3, ((1024, 1024),) * 3, K1_MAIN_PATH]
MESH_HALO = ((1024, 96), (1024, 80), (1024, 128))
#: --backend sharded end to end, against --backend jax (phase 8's models)
MESH_CLI = (("two_populations", "generate_two_populations", (E2E_SIZE,)),
            ("population", "generate_population", (POP_SIZE, POP_VARS)))

# phase 17: the one-pass mode (highest=False) of K2, K3, K4a and K4b.  Its
# bar against f64: (ONE_PASS + RTOL) of the product of the absolute values
# (the operands here lie in [0, 1): the product itself) plus the atol
ONE_PASS = 2.0 ** -10  # two TF32 roundings: 2u + u^2, u = 2^-11
#: one-pass wrapper -> (its kernel-table name, source, the TPU kernel's
#: precision switch it replaces, the table's shape and batch: the
#: decomposition's order 512 for the single pairs, K3's 256 x B32)
ONE_PASS_KERNELS = {
    "conv2d_trunc_f32": (
        "conv2d_trunc_f32[1pass]",
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_tile.cu",
        "genfer_tpu/ops/pallas_conv2d.py:213", (DENSE_512, 1)),
    "conv2d_trunc_f32_tile": (
        "conv2d_trunc_f32_tile[1pass]",
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_tile.cu",
        "genfer_tpu/ops/pallas_conv2d.py:99", (DENSE_512, 1)),
    "conv2d_trunc_f32_grouped": (
        "conv2d_trunc_f32_grouped[1pass]",
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_grouped.cu",
        "genfer_tpu/ops/pallas_conv2d.py:334", (DENSE_512, 1)),
    "conv2d_trunc_f32_batched": (
        "conv2d_trunc_f32_batched[1pass]",
        "genfer_tpu_torch/csrc/conv2d_trunc_f32_batched_1pass.cu",
        "genfer_tpu/ops/pallas_conv2d.py:479", (DENSE_256, 32)),
}
#: the shapes at which phase 17 times each one-pass wrapper (the others it
#: checks only): the end-to-end run's largest product and the dense orders
ONE_PASS_TIMED = [MAIN_PATH, *(((n, n),) * 3 for n in DENSE_ORDERS)]
#: the one-pass rounding kernel (the one-pass C entries launch it; alone,
#: ``ops.conv2d.tf32_round_operands``): its table name, source, the TPU
#: kernel whose one pass it is part of, shape
ROUND_KERNEL = ("tf32_round_operands",
                "genfer_tpu_torch/csrc/conv2d_wgmma.cuh",
                "genfer_tpu/ops/pallas_conv2d.py:99", DENSE_512)
#: the example twins: the digit model's rows held to the host interpreter
DIGIT_HOST_ROWS = (0, DIGIT_BATCH - 1)

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
    from genfer_tpu_torch import _build, trace

    t0 = time.perf_counter()
    with trace.recording() as rec:
        _build.load()
    nvcc = sum(s.ns for s in rec.find("kernels.build")) / 1e9
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s wall, nvcc "
          f"{nvcc:.3f} s -> {_build.library_path().name}")


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


def _host_us_and_kernels(call, calls: int) -> tuple[float, dict]:
    """What one ``call()`` costs the host (the wrapper and its launches,
    not waiting for the card) and the card by kernel
    (``device_us_by_kernel``, tried twice: torch.profiler at times records
    no device event for one of many short sessions)."""
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    for _ in range(2):
        kernels = device_us_by_kernel(call, calls)
        if sum(kernels.values()) > 0:
            break
    return host_us, kernels


def _us_line(host_us: float, kernels: dict) -> str:
    return (f"host {host_us:.2f} us a call (wrapper and launch, not "
            f"waiting), device {sum(kernels.values()):.2f} us a call "
            "(torch.profiler: " + ", ".join(
                f"{k} {v:.2f}" for k, v in kernels.items()) + ")")


def _host_and_device_us(call, what: str, calls: int = 200) -> str:
    """``_host_us_and_kernels`` as a line; fails without device time."""
    host_us, kernels = _host_us_and_kernels(call, calls)
    if not sum(kernels.values()) > 0:
        fail(f"torch.profiler recorded no device time for {what}")
    return _us_line(host_us, kernels)


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
    """Set every kernel's launch count (and K1's by body, and the one-pass
    modes') to 0, run the block, then add the counts to ``launches``; fail
    if a kernel of ``must`` was not launched."""
    from genfer_tpu_torch.ops.conv2d import tf32_round_operands
    from genfer_tpu_torch.ops.conv2d_f64 import reset_launches
    from genfer_tpu_torch.ops.spine_f64 import spine_f64

    wrappers = _wrappers()
    for name, w in wrappers.items():
        w.launches = 0
        if name in ONE_PASS_KERNELS:
            w.launches_1pass = 0
    tf32_round_operands.launches = 0
    spine_f64.launches = 0
    reset_launches()
    yield
    counts = {name: w.launches for name, w in wrappers.items()}
    counts["spine_f64"] = spine_f64.launches
    counts.update({ONE_PASS_KERNELS[name][0]: w.launches_1pass
                   for name, w in wrappers.items()
                   if name in ONE_PASS_KERNELS})
    counts[ROUND_KERNEL[0]] = tf32_round_operands.launches
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
                n += _agree(read_endpoints(port_out), read_endpoints(host_out),
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


def _spine_operands(rng, rows, shape, links, kind):
    """Operands of ``ops.spine_f64`` on the card: the digit model's (the
    links alternate Mul by an evidence value and Add of 0, the constants
    concatenated as the walk makes them, evidence first) or a seeded mix
    of Mul and Add links with constants in [0.5, 1.5)."""
    from genfer_tpu_torch.ops.spine_f64 import pack_adds

    n = int(np.prod(shape))
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (rows, n))).cuda()
    if kind == "digit":
        half = links // 2
        is_add = np.arange(links) % 2 == 1
        src = np.where(is_add, half + np.arange(links) // 2,
                       np.arange(links) // 2)
        c = np.concatenate([rng.uniform(0.5, 1.0, (rows, half)),
                            np.zeros((rows, half))], axis=1)
    else:
        is_add = rng.random(links) < 0.5
        src = rng.permutation(links)
        c = rng.uniform(0.5, 1.5, (rows, links))
    return (x, torch.from_numpy(c).cuda(),
            torch.from_numpy(src.astype(np.int32)).cuda(),
            torch.from_numpy(pack_adds(is_add)).cuda())


def phase11_spine(rng) -> dict:
    """The spine kernel against its plain version bit for bit at
    ``SPINE_SHAPES``, its device time (in a CUDA graph) beside its bound
    (the bytes of x, c and the result over 3.35 TB/s) and, at
    ``SPINE_CHAIN_ROWS`` rows, the time the chain alone takes; the kernel
    table's row is the digit shape's."""
    from genfer_tpu_torch.bench import bound_ms
    from genfer_tpu_torch.ops.spine_f64 import (
        spine_f64,
        spine_f64_reference,
    )

    rows_out = {}
    for kind, (rows, shape, links) in SPINE_SHAPES.items():
        x, c, src, adds = _spine_operands(rng, rows, shape, links, kind)
        got = spine_f64(x, c, src, adds)
        want = spine_f64_reference(x, c, src, adds)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"spine_f64 {kind}: {bad} words differ from the plain "
                 "version")
        if not torch.equal(spine_f64(x, c, src, adds), got):
            fail(f"spine_f64 {kind}: two calls differ")
        nbytes = 8.0 * (x.numel() + c.numel() + got.numel())
        bound, by = bound_ms(0.0, nbytes)
        dev = _graph_ms(lambda: spine_f64(x, c, src, adds))
        chain = _graph_ms(lambda: spine_f64(
            x[:SPINE_CHAIN_ROWS], c[:SPINE_CHAIN_ROWS], src, adds))
        row = {"max_abs_err": 0.0, "ms": dev,
               "plain_ms": _time(lambda: spine_f64_reference(x, c, src,
                                                             adds)),
               "library_ms": None, "bound_ms": bound, "bound_by": by,
               "chain_ms": chain}
        rows_out[(kind, rows, shape, links)] = row
        print(f"phase 11 spine_f64 {kind} {rows} rows x {shape} "
              f"coefficients, {links} links: the plain version's bits "
              f"(twice); device {dev * 1e3:.2f} us a call in a graph of "
              f"{GRAPH_CALLS}, bound {bound * 1e3:.2f} us ({by}, "
              f"{100 * bound / dev:.1f}%), {SPINE_CHAIN_ROWS} rows alone "
              f"{chain * 1e3:.2f} us (the chain), plain version "
              f"{row['plain_ms']:.3f} ms")
    return rows_out


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
    from genfer_tpu_torch.ops.spine_f64 import spine_f64
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
    out["spine_f64"] = phase11_spine(np.random.default_rng(DIGIT_SEED))
    # the 784-pixel digit model
    rng = np.random.default_rng(DIGIT_SEED)
    src, params = digit_serving_source(DIGIT_PIXELS)
    t0 = time.perf_counter()
    d = CompiledProgram(src, params, 10, device="cuda")
    translate = time.perf_counter() - t0
    ev = torch.from_numpy(_digit_evidence(rng, DIGIT_BATCH)).cuda()
    with _counted(launches, ("spine_f64",), "phase 11 digit capture"):
        t0 = time.perf_counter()
        dgot = d.probs_batch(ev)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    # the warm-up walk's and the captured walk's
    if spine_f64.launches != 2 * DIGIT_SPINES:
        fail(f"the digit model's warm-up and capture launched the spine "
             f"kernel {spine_f64.launches} times, not {2 * DIGIT_SPINES}")
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


def _col_err(got, want) -> float:
    """Max abs error of each output column over that column's max."""
    col = want.abs().amax(dim=0, keepdim=True).clamp_min(1e-300)
    return float(((got - want).abs() / col).max())


def _ozaki_gate(name, got, want) -> float:
    """Fail unless ``got`` is finite, of ``want``'s shape and within
    ``OZAKI_TOL`` of each output column's max; return that error."""
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        fail(f"{name}: bad shape {tuple(got.shape)} or non-finite")
    err = _col_err(got, want)
    if not err <= OZAKI_TOL:
        fail(f"{name}: {err:.3e} of the column max, over {OZAKI_TOL}")
    return err


def _host_us(call, calls: int = 3) -> float:
    """What ``call()`` costs the host, not waiting for the card."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _ozaki_split_rows(rng) -> dict:
    """The split on the card against its plain version, bit for bit
    (chunks in the kernel's layout, exponents, flags), at the shapes, on a
    batch with a non-finite entry and at the table's order; its time
    there."""
    from genfer_tpu_torch.bench import bound_ms
    from genfer_tpu_torch.ops import ozaki_conv as Z

    def same(a, b, pb, impl):
        """Flags equal; chunks and exponents equal for every product
        whose operands are finite (those of a flagged one are never
        read: the guard takes it)."""
        got = [x.cpu() for x in Z.ozaki_split(a, b, pb, impl)]
        want = Z.ozaki_split_batched_reference(a.cpu(), b.cpu(), pb, impl)
        ok = want[4] == 0
        if not torch.equal(got[4], want[4]):
            return False
        view = torch.int8 if impl == "int8" else torch.int16
        for g, w in zip(got[:4], want[:4]):
            if g.dtype in (torch.int8, torch.bfloat16):
                g, w = g.view(view), w.view(view)
            if not torch.equal(g[ok], w[ok]):
                return False
        return True

    def operand(shape, batch=1):
        x = rng.standard_normal((batch, *shape)) * 10.0 ** rng.integers(
            -200, 200, (batch, 1, shape[1]))
        return torch.from_numpy(x).cuda()

    checked = 0
    for sa, sb, _ in OZAKI_SHAPES:
        a, b = operand(sa), operand(sb)
        for pb, impl in OZAKI_PASSES:
            if not same(a, b, pb, impl):
                fail(f"ozaki_split {sa} and {sb} {impl} P={pb}: differs "
                     "from the plain split")
            checked += 1
    a, b = operand((37, 70), 5), operand((21, 3), 5)
    b[3, 4, 1] = float("inf")
    flags = Z.ozaki_split(a, b, 7, "int8")[4]
    if flags.tolist() != [0, 0, 0, 1, 0] or not same(a, b, 7, "int8"):
        fail("ozaki_split over a batch of 5: differs from the plain split")
    # the float split runs in the plain version only: refused on the card
    os.environ["GENFER_OZAKI_CHUNK"] = "float"
    before = Z.ozaki_split.launches
    try:
        Z.ozaki_split(a, b, 7, "int8")
        fail("ozaki_split under GENFER_OZAKI_CHUNK=float: not refused")
    except NotImplementedError:
        pass
    finally:
        os.environ.pop("GENFER_OZAKI_CHUNK")
    if Z.ozaki_split.launches != before:
        fail("ozaki_split under GENFER_OZAKI_CHUNK=float launched")
    n = OZAKI_TABLE_ORDER
    x = torch.from_numpy(rng.random((1, n, n))).cuda()
    y = torch.from_numpy(rng.random((1, n, n))).cuda()
    if not same(x, y, 7, "int8"):
        fail(f"ozaki_split ({n}, {n}): differs from the plain split")
    row = {"max_abs_err": 0.0,
           "ms": _time(lambda: Z.ozaki_split(x, y, 7, "int8")),
           "plain_ms": _time(lambda: Z.ozaki_split_batched_reference(
               x, y, 7, "int8")),
           "library_ms": None}
    # both operands read once; 8 int8 chunks an entry and the int32
    # exponents written once
    row["bound_ms"], row["bound_by"] = bound_ms(
        0.0, 2 * (n * n * (8 + 8) + 4 * n))
    cost = _profiled_us(lambda: Z.ozaki_split(x, y, 7, "int8"),
                        "ozaki_split", 50)
    print(f"phase 14 ozaki_split: {checked} operand pairs x (pair_bits, "
          "impl) and a batch of 5 (one non-finite entry, flagged) equal to "
          "the plain split bit for bit (chunks in the kernel's layout, "
          "exponents, flags), the float split refused; both operands of "
          f"({n}, {n}) x ({n}, {n}) int8 P=7 in one launch: "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4g} ms (bytes); {cost}")
    return row


def _ozaki_cases(rng):
    """(label, a, b, out) of phase 14's products on the card."""
    cases = []
    for sa, sb, out in OZAKI_SHAPES:
        cases.append((f"{sa}x{sb}->{out}", rng.random(sa), rng.random(sb),
                      out))
    for n in OZAKI_ORDERS:
        cases.append((f"order {n}", rng.random((n, n)), rng.random((n, n)),
                      (n, n)))
    for sa, sb, out in OZAKI_MAIN_PATH:
        cases.append((f"main path {sa}x{sb}->{out}", rng.random(sa),
                      rng.random(sb), out))
    a, b = rng.standard_normal((96, 48)), rng.standard_normal((96, 48))
    a *= np.exp2(rng.integers(-300, 300, 48))[None, :]
    b *= np.exp2(rng.integers(-300, 300, 48))[None, :]
    cases.append(("signed, columns 2^+-300", a, b, (96, 95)))
    for mag in (2.0 ** 950, 2.0 ** -980):
        cases.append((f"columns at 2^{int(np.log2(mag))}",
                      np.full((16, 2), mag), np.ones((16, 2)), (16, 3)))
    cases.append(("2^-980 against 2^300", np.full((16, 2), 2.0 ** -980),
                  np.full((16, 2), 2.0 ** 300), (16, 3)))
    return cases


class _RouteTap:
    """Counts what the forced route sees while installed: the 2-axis f64
    products ``_conv_impl`` asks ``ozaki_applicable`` about (``asked``),
    the products it routes (``routed``: calls of ``ozaki_conv2d_guarded``),
    and keeps every ``OZAKI_E2E_STRIDE``-th routed product's operands and
    output (``kept``: a, b, out_shape, result) for the hold against the
    plain version, and whether each routed product's operands are finite
    (``flagged``: those the guard must send to K1, read after the run).
    It counts no launch: those are the wrappers' own."""

    def __init__(self, Z):
        self.Z = Z
        self.asked = self.routed = 0
        self.kept = []
        self.finite = []

    @property
    def flagged(self) -> int:
        """Routed products whose operands hold a non-finite entry."""
        return sum(not bool(f) for f in self.finite)

    def __enter__(self):
        Z = self.Z
        self.real = Z.ozaki_applicable, Z.ozaki_conv2d_guarded

        def applicable(*args):
            self.asked += 1
            return self.real[0](*args)

        def guarded(a, b, out_shape, *args):
            got = self.real[1](a, b, out_shape, *args)
            # whether the guard must take it, kept on the card and read
            # after the run (the tap waits for no value during it)
            self.finite.append(torch.isfinite(a).all()
                               & torch.isfinite(b).all())
            if self.routed % OZAKI_E2E_STRIDE == 0:
                self.kept.append((a.clone(), b.clone(), tuple(out_shape),
                                  got.clone()))
            self.routed += 1
            return got

        Z.ozaki_applicable, Z.ozaki_conv2d_guarded = applicable, guarded
        return self

    def __exit__(self, *exc):
        self.Z.ozaki_applicable, self.Z.ozaki_conv2d_guarded = self.real


def _hold_kept(kept, impl: str) -> tuple[int, float, set]:
    """Hold each kept product of a forced run against the plain version
    at ``OZAKI_TOL`` of each output column's max (K1's bits where the
    guard took it), and K5 again on its operands for the same bits;
    return (products held, worst error, their shapes).  These launches
    come after the run's counts were read."""
    from genfer_tpu_torch.ops import ozaki_conv as Z
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64

    pb, worst, shapes = Z.default_pair_bits(), 0.0, set()
    for a, b, out, got in kept:
        label = (f"forced run's {tuple(a.shape)}x{tuple(b.shape)}->{out} "
                 f"{impl} P={pb}")
        if not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
            want = conv2d_trunc_f64(a, b, out)
            nan = torch.isnan(want)
            if not (torch.equal(torch.isnan(got), nan)
                    and torch.equal(got[~nan], want[~nan])):
                fail(f"{label}: the guard's result is not K1's")
            continue
        want = Z.ozaki_conv2d_reference(a, b, out, pb, impl)
        worst = max(worst, _ozaki_gate(label, got, want))
        if not torch.equal(got, Z.ozaki_conv2d(a, b, out, pb, impl)):
            fail(f"{label}: K5 again on its operands gives other bits")
        shapes.add((tuple(a.shape), tuple(b.shape), out))
    return len(kept), worst, shapes


def _ozaki_e2e(launches: dict, path: Path, degenerate: bool) -> None:
    """The slice end to end: ``--backend jax`` under ``GENFER_OZAKI=force``
    (and ``GENFER_OZAKI_MIN_FLOPS=0``) on the card, int8 then bf16, each
    against the same forced run on the CPU (K5's plain version) at rel
    ``OZAKI_REL``.  Every 2-axis f64 product is routed (int8; bf16
    refuses contractions above its cap), K5, the split and K1 predicated
    on the guard's flags launch once for every routed product, the
    guard's device count equals the routed products with a non-finite
    operand, and a sample of the routed products is held to the plain
    version (``_hold_kept``).  Unless ``degenerate`` (the route's componentwise
    cliff collapses the answer: printed, not held), the forced run must
    print finite values with Z > 0 and route every product the default
    run sends to K1.  The deviation from host f64 is printed, not held;
    the default env launches no K5."""
    from genfer_tpu_torch import cli
    from genfer_tpu_torch.lang.parser import parse_program
    from genfer_tpu_torch.ops import ozaki_conv as Z
    from genfer_tpu_torch.ops import conv2d_f64
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64

    text = path.read_text()
    args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--backend", "jax"])

    def printed(device=None) -> tuple[dict, float]:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.run(parse_program(text), args, device=device)
        return read_results(buf.getvalue()), time.perf_counter() - t0

    host_out, host_s = _capture(
        cli.main, [str(path), "--no-timing", "--backend", "numpy"])
    host = read_results(host_out)
    conv2d_f64.reset_launches()
    Z.reset_launches()
    with _RouteTap(Z) as tap:
        default, _ = printed()
    if Z.ozaki_conv2d.launches or Z.ozaki_split.launches or tap.routed:
        fail(f"{path.name}: the default env routed or launched K5")
    k1_default, products = conv2d_trunc_f64.launches, tap.asked
    force = {"GENFER_OZAKI": "force", "GENFER_OZAKI_MIN_FLOPS": "0"}
    os.environ.update(force)
    try:
        cpu, cpu_s = printed("cpu")
        for impl in Z.IMPLS:
            os.environ["GENFER_OZAKI_IMPL"] = impl
            conv2d_f64.reset_launches()
            Z.reset_launches()
            with _RouteTap(Z) as tap:
                card, card_s = printed()
                torch.cuda.synchronize()
            k5, guarded = Z.ozaki_conv2d.launches_by_impl[impl], \
                Z.guarded_count()
            split, routed = Z.ozaki_split.launches, tap.routed
            k1_guard = conv2d_trunc_f64.predicated
            bodies = dict(Z.ozaki_conv2d.launches_by_body)
            name = f"ozaki_conv2d[{impl}]"
            launches[name] = launches.get(name, 0) + k5
            launches["ozaki_split"] = launches.get("ozaki_split", 0) + split
            what = f"{path.name} forced {impl} run"
            if (k5 < 1 or k5 != routed or split != routed
                    or k1_guard != routed or guarded != tap.flagged):
                fail(f"{what}: {k5} K5 launches, {split} split launches, "
                     f"{k1_guard} predicated K1 launches and {guarded} "
                     f"guarded ({tap.flagged} flagged) for {routed} routed "
                     "products")
            if impl == "int8" and routed != tap.asked:
                fail(f"{what}: routed {routed} of {tap.asked} 2-axis f64 "
                     "products")
            if not degenerate and routed != products:
                fail(f"{what}: routed {routed} products, the default run "
                     f"sends {products} to K1")
            if set(card) != set(cpu):
                fail(f"{what}: printed keys differ from the CPU")
            if not degenerate and not (
                    all(math.isfinite(v) for v in card.values())
                    and card.get("Z", 0.0) > 0.0):
                fail(f"{what}: a degenerate answer {card}")
            worst = 0.0
            for key, w in cpu.items():
                g = card[key]
                if g == w or (math.isnan(g) and math.isnan(w)):
                    continue
                dev = abs(g - w) / max(abs(w), 1e-300)
                if not dev <= OZAKI_REL:
                    fail(f"{what}: {key} = {g} against the CPU's {w} (rel "
                         f"{dev:.3e})")
                worst = max(worst, dev)
            held, held_err, shapes = _hold_kept(tap.kept, impl)
            dev_host = max((abs(card[k] - w) / abs(w) for k, w in
                            host.items() if k in card and w), default=0.0)
            print(f"phase 14 {what}: {tap.asked} 2-axis f64 products "
                  f"({products} in the default run), {routed} routed, K5 "
                  f"launched {k5} times ({bodies}), the guard sent "
                  f"{guarded} to K1 (counted on the device), split {split}, "
                  f"K1 {conv2d_trunc_f64.launches} ({k1_guard} of them "
                  "predicated on the guard's flags, the rest >= 3-axis and "
                  f"refused products); {len(cpu)} results "
                  f"within rel {OZAKI_REL} of the forced CPU run (max rel "
                  f"dev {worst:.3e}); {held} of its products ({len(shapes)}"
                  f" shapes) held to the plain version, max err "
                  f"{held_err:.3e} of the column max, K5 again the same "
                  f"bits; card {card_s:.3f} s, CPU {cpu_s:.3f} s wall; "
                  "against host f64 (printed, not held: the route's "
                  f"componentwise cliff): max rel dev {dev_host:.3e}, Z "
                  f"{card.get('Z')!r} vs {host.get('Z')!r}, E "
                  f"{card.get('E')!r} vs {host.get('E')!r}")
    finally:
        for key in (*force, "GENFER_OZAKI_IMPL"):
            os.environ.pop(key, None)
    print(f"phase 14 {path.name} --backend jax, default env: 0 K5 "
          f"launches, K1 {k1_default}; Z {default.get('Z')!r} (host "
          f"{host.get('Z')!r}, {host_s:.3f} s)")


def _profiled_us(call, what: str, calls: int) -> str:
    """``_host_and_device_us`` for phase 14's many timing lines: where the
    profiler records no device event, the device time is reported as not
    measured (a measurement, not a check of the kernel)."""
    host_us, kernels = _host_us_and_kernels(call, calls)
    if sum(kernels.values()) > 0:
        return _us_line(host_us, kernels)
    return (f"host {host_us:.2f} us a call (not waiting), device time not "
            f"measured for {what} (torch.profiler recorded no event)")


def _ozaki_serving_batch(rng) -> None:
    """K5's small body over the serving batch (``OZAKI_SERVING`` x
    bench.SERVING_BATCH), as the compiled mode's vmap rule launches it:
    every ``OZAKI_SERVING_STRIDE``-th entry held to the plain version at
    ``OZAKI_TOL`` and equal to its single-pair call, the same bits twice;
    its time beside K1's small body, cuDNN's grouped f64 ``conv2d`` and
    the byte bound."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import SERVING_BATCH, bound_ms
    from genfer_tpu_torch.ops import ozaki_conv as Z

    sa, sb, out = OZAKI_SERVING
    batch = SERVING_BATCH
    a = torch.from_numpy(rng.random((batch, *sa))).cuda()
    b = torch.from_numpy(rng.random((batch, *sb))).cuda()
    got = Z.ozaki_conv2d_batched(a, b, out)
    if not torch.equal(got, Z.ozaki_conv2d_batched(a, b, out)):
        fail("ozaki_conv2d serving batch: two calls differ")
    worst = 0.0
    for z in range(0, batch, OZAKI_SERVING_STRIDE):
        want = Z.ozaki_conv2d_reference(a[z], b[z], out)
        worst = max(worst, _ozaki_gate(f"ozaki serving batch entry {z}",
                                       got[z], want))
        if not torch.equal(got[z], Z.ozaki_conv2d(a[z], b[z], out)):
            fail(f"ozaki serving batch entry {z}: not its single call")
    ms = _time(lambda: Z.ozaki_conv2d_batched(a, b, out))
    k1_ms = _time(lambda: ops.conv2d_trunc_f64_batched(a, b, out))
    bound = bound_ms(0.0, 8 * batch * (sa[0] * sa[1] + sb[0] * sb[1]
                                       + out[0] * out[1]))[0]
    # one grouped correlation over the batch (tune_port.py probe 12's
    # yardstick)
    (b0, b1), (c0, c1) = sb, out
    x = torch.zeros((1, batch, c0 + b0 - 1, c1 + b1 - 1), dtype=a.dtype,
                    device=a.device)
    x[0, :, b0 - 1:, b1 - 1:b1 - 1 + sa[1]] = a[:, :c0, :]
    w = torch.flip(b, dims=(1, 2))[:, None].contiguous()
    lib_ms = _time(lambda: F.conv2d(x, w, groups=batch))
    cost = _profiled_us(lambda: Z.ozaki_conv2d_batched(a, b, out),
                        "ozaki serving batch", 20)
    print(f"phase 14 ozaki_conv2d[int8] small body {sa}x{sb}->{out} x "
          f"{batch}: {batch // OZAKI_SERVING_STRIDE} entries within "
          f"{worst:.3e} of each column's max of the plain version and equal "
          f"to their single calls, the same bits twice; {ms:.4f} ms a call "
          f"(guarded), K1 small body {k1_ms:.4f} ms, cuDNN grouped f64 "
          f"conv2d {lib_ms:.4f} ms, bound {bound:.4g} ms (bytes); {cost}")


def _profiled_syncs(call) -> list:
    """The host CUDA calls among ``SYNC_CALLS`` that ``call()`` made, from
    ``torch.profiler`` (the CPU's runtime events inside the call's own
    range, not the profiler's start and stop)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("call under test"):
            call()
    torch.cuda.synchronize()
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "call under test"]
    start = min(t.start for t in spans)
    end = max(t.end for t in spans)
    return sorted({e.name for e in events
                   if any(c in e.name for c in SYNC_CALLS)
                   and start <= e.time_range.start <= end})


def _ozaki_compiled(launches: dict) -> None:
    """The compiled mode under ``GENFER_OZAKI=force``: the scam model's
    batched walk (``OZAKI_COMPILED_SRC``, 26 products) over
    bench.SERVING_BATCH datasets on the card.  The eager warm-up walk
    launches the split, K5 and K1 predicated once a vmapped product, with
    no synchronize (torch.profiler); the captured walk launches them once
    a product again; replays equal the eager walk bit for bit and the
    eager ``--backend jax`` run of the bound program (``api.infer``) at
    ``OZAKI_REL``; the guard's device count stays 0, and a captured
    ``ozaki_op`` over a batch with a NaN entry counts it at every replay
    and returns K1's bits there."""
    from genfer_tpu_torch import api
    from genfer_tpu_torch.bench import SERVING_BATCH
    from genfer_tpu_torch.compile import CompiledProgram, GraphedEntry
    from genfer_tpu_torch.ops import conv2d_f64 as K
    from genfer_tpu_torch.ops import ozaki_conv as Z

    force = {"GENFER_OZAKI": "force", "GENFER_OZAKI_MIN_FLOPS": "0"}
    os.environ.update(force)
    try:
        n = OZAKI_COMPILED_LIMIT
        prog = CompiledProgram(OZAKI_COMPILED_SRC, ["p"], limit=n)
        grid = torch.linspace(0.01, 0.99, SERVING_BATCH,
                              dtype=torch.float64).reshape(-1, 1)
        grid[:len(OZAKI_COMPILED_HELD), 0] = torch.tensor(
            OZAKI_COMPILED_HELD, dtype=torch.float64)
        a = torch.rand(255, 268, dtype=torch.float64, device="cuda")
        b = torch.rand(2, 2, dtype=torch.float64, device="cuda")
        Z.ozaki_conv2d_guarded(a, b, (255, 268))
        syncs = _profiled_syncs(lambda: Z.ozaki_conv2d_guarded(
            a, b, (255, 268)))
        if syncs:
            fail(f"the eager forced route called {syncs}")
        grid = grid.cuda()
        prog._probs_batch.eager(grid)  # the constants' and plans' copies
        Z.reset_launches()
        K.reset_launches()
        syncs = _profiled_syncs(lambda: prog._probs_batch.eager(grid))
        eager = prog._probs_batch.eager(grid)
        if syncs:
            fail(f"compiled mode under force: the eager walk called {syncs}")
        counts = (Z.ozaki_conv2d.launches, Z.ozaki_split.launches,
                  K.conv2d_trunc_f64.predicated)
        if counts != (2 * n,) * 3:
            fail(f"compiled mode under force: two eager walks launched K5, "
                 f"the split and K1 predicated {counts} times, not {n} each "
                 "a walk")
        Z.reset_launches()
        K.reset_launches()
        t0 = time.perf_counter()
        first = prog.probs_batch(grid)
        capture_s = time.perf_counter() - t0
        k5 = Z.ozaki_conv2d.launches
        by_body = dict(Z.ozaki_conv2d.launches_by_body)
        launches["ozaki_conv2d[int8]"] = (
            launches.get("ozaki_conv2d[int8]", 0) + k5)
        launches["ozaki_split"] = (launches.get("ozaki_split", 0)
                                   + Z.ozaki_split.launches)
        if (k5, Z.ozaki_split.launches, K.conv2d_trunc_f64.predicated) != (
                n, n, n):
            fail(f"compiled mode under force: the captured walk launched K5 "
                 f"{k5} times, not once for each of its {n} products")
        if not torch.equal(first, eager):
            fail("compiled mode under force: the replay differs from the "
                 "eager walk")
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            replay = prog.probs_batch(grid)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) / reps * 1e3
        if not torch.equal(replay, eager) or Z.ozaki_conv2d.launches != k5:
            fail("compiled mode under force: replays differ or launched")
        if Z.guarded_count() != 0:
            fail("compiled mode under force: the guard counted a product")
        worst = 0.0
        for i, p in enumerate(OZAKI_COMPILED_HELD):
            r = api.infer(OZAKI_COMPILED_SRC.replace("$p", repr(p)),
                          backend="jax")
            ref = torch.tensor([x.to_float()
                                for x in r.probs(n, normalized=False)],
                               dtype=torch.float64)
            got = replay[i].cpu()
            dev = float(((got - ref).abs()
                         / ref.abs().clamp_min(1e-300)).max())
            if not dev <= OZAKI_REL:
                fail(f"compiled mode under force, $p = {p}: {dev:.3e} from "
                     "the eager forced --backend jax run")
            worst = max(worst, dev)
        # the guard inside a graph: one NaN entry of a vmapped batch
        rng = np.random.default_rng(141)
        a = torch.from_numpy(rng.random((8, 40, 33))).cuda()
        b = torch.from_numpy(rng.random((8, 2, 2))).cuda()
        a[5, 7, 9] = float("nan")
        out = (40, 34)
        entry = GraphedEntry(torch.func.vmap(
            lambda x, y: Z.ozaki_op(x[None], y[None], out)[0]),
            torch.device("cuda"), "ozaki_guarded")
        entry.eager(a, b)
        Z.reset_launches()
        for _ in range(3):
            guarded = entry(a, b)
        torch.cuda.synchronize()
        want = K.conv2d_trunc_f64(a[5], b[5], out)
        nan = torch.isnan(want)
        if (Z.guarded_count() != 3 or Z.ozaki_conv2d.launches != 1
                or not torch.equal(torch.isnan(guarded[5]), nan)
                or not torch.equal(guarded[5][~nan], want[~nan])
                or not torch.equal(guarded[4], Z.ozaki_conv2d(a[4], b[4],
                                                              out))):
            fail("compiled mode under force: the captured guard is not K1's "
                 "result or not counted at each replay")
    finally:
        for key in force:
            os.environ.pop(key, None)
    print(f"phase 14 compiled mode under force, scam model x "
          f"{SERVING_BATCH} datasets: eager walk and an eager forced "
          f"product with no {SYNC_CALLS[0]} / {SYNC_CALLS[1]} "
          f"(torch.profiler), {n} split, K5 and predicated "
          f"K1 launches a walk; the captured walk launched K5 {k5} times "
          f"({by_body}), capture {capture_s:.3f} s, replay {replay_ms:.3f} "
          "ms with read-back, equal to the eager walk bit for bit; the "
          f"guard's device count 0; $p {OZAKI_COMPILED_HELD} within "
          f"{worst:.3e} of the eager forced --backend jax run; a captured "
          "vmapped ozaki_op with one NaN entry: counted at each of 3 "
          "replays, K1's bits there, K5's elsewhere")


def phase14_ozaki(launches: dict) -> dict:
    """K5 and its split on the card against their plain versions, the
    forced main path end to end, and ``conv2d_blocked`` with K5 inside
    (module docstring)."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import (
        BF16_MMA,
        F64_MMA,
        INT8_MMA,
        product_bound,
    )
    from genfer_tpu_torch.ops import ozaki_conv as Z
    from genfer_tpu_torch.ops.blocked_conv import conv2d_blocked, spot_check
    from genfer_tpu_torch.tools.generators import generate_two_populations

    rng = np.random.default_rng(14)
    rows: dict = {"ozaki_split": _ozaki_split_rows(rng)}
    for impl in Z.IMPLS:
        rows[f"ozaki_conv2d[{impl}]"] = {}
    k1_ms = {}
    for label, a, b, out in _ozaki_cases(rng):
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        plain_rows = 128 if max(out) > 512 else None
        big = max(out) >= OZAKI_ORDERS[0]
        if big or label.startswith("main path"):
            k1_ms[out] = _time(lambda: ops.conv2d_trunc_f64(a, b, out))
        for pb, impl in OZAKI_PASSES:
            name = f"ozaki_conv2d[{impl}]"
            if b.shape[0] > Z._max_k(impl):
                print(f"phase 14 {name} {label} P={pb}: above the impl's "
                      f"contraction cap {Z._max_k(impl)} (refused)")
                continue
            before = Z.ozaki_conv2d.launches
            got = Z.ozaki_conv2d(a, b, out, pb, impl)
            if Z.ozaki_conv2d.launches != before + 1:
                fail(f"{name} {label}: K5 did not launch")
            if not torch.equal(got, Z.ozaki_conv2d(a, b, out, pb, impl)):
                fail(f"{name} {label} P={pb}: two calls differ")
            want = Z.ozaki_conv2d_reference(a, b, out, pb, impl, plain_rows)
            err = _ozaki_gate(f"{name} {label} P={pb}", got, want)
            line = (f"phase 14 {name} {label} P={pb}: same bits twice, max "
                    f"err {err:.3e} of each output column's max")
            main = label.startswith("main path")
            if big or main or label.startswith("("):
                ms = _time(lambda: Z.ozaki_conv2d(a, b, out, pb, impl))
                plain_ms = _time(lambda: Z.ozaki_conv2d_reference(
                    a, b, out, pb, impl, plain_rows))
                bound, by = product_bound(
                    a.shape, b.shape, out, passes=Z.pair_passes(pb),
                    rate=INT8_MMA if impl == "int8" else BF16_MMA)
                # the guarded call (split, K5, K1 predicated on the flags
                # and the select) waits for nothing; from order 256 the
                # card is busy for the whole call, and its CUDA-event time
                # is the device time
                def call():
                    return Z.ozaki_conv2d(a, b, out, pb, impl)

                cost = (_profiled_us(call, name, 50) if not big
                        else f"host {_host_us(call):.2f} us a call (not "
                        f"waiting), device {1e3 * ms:.2f} us a call (CUDA "
                        "events)")
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bound:.4g} ms ({by}, "
                         f"{Z.pair_passes(pb)} passes), share "
                         f"{100 * bound / ms:.1f}%; {cost}")
                line += f"; K5 body {Z.k5_body(a.shape, b.shape)}"
                if pb == 7:
                    line += ("; unguarded (split and K5 alone): " +
                             _profiled_us(
                                 lambda: Z.ozaki_conv2d(a, b, out, pb, impl,
                                                        guard=False),
                                 name, 50 if not big else 5))
                if big or main:
                    line += f"; K1 {k1_ms[out]:.4f} ms"
                if main and (pb, impl) == (7, "int8"):
                    lib, lib_err = _library(
                        _conv2d_library(a[None], b, out), want, ATOL)
                    line += (f"; cuDNN f64 {lib:.4f} ms (max rel err "
                             f"{lib_err:.3e}); K1 "
                             + _profiled_us(
                                 lambda: ops.conv2d_trunc_f64(a, b, out),
                                 "K1", 50))
                if pb == 7 and out == (OZAKI_TABLE_ORDER,) * 2:
                    lib, lib_err = _library(
                        _conv2d_library(a[None], b, out), want, ATOL)
                    line += (f"; cuDNN f64 {lib:.4f} ms (max rel err "
                             f"{lib_err:.3e})")
                    rows[name][(out, pb)] = {
                        "max_abs_err": float((got - want).abs().max()),
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                        "bound_ms": bound, "bound_by": by.split()[-1],
                        "bound_rate": INT8_MMA if impl == "int8"
                        else BF16_MMA}
            print(line)
            del got, want
    # a non-finite operand: the guard sends the product to K1 (IEEE)
    a = torch.from_numpy(rng.random((16, 16))).cuda()
    b = torch.from_numpy(rng.random((16, 16))).cuda()
    a[3, 5] = float("nan")
    Z.reset_launches()
    got = Z.ozaki_conv2d(a, b, (31, 31))
    want = ops.conv2d_trunc_f64(a, b, (31, 31))
    nan = torch.isnan(want)
    if (Z.ozaki_conv2d.launches != 1 or Z.guarded_count() != 1
            or not torch.equal(torch.isnan(got), nan)
            or not torch.equal(got[~nan], want[~nan])):
        fail("ozaki_conv2d with a NaN operand: not K1's IEEE result")
    print(f"phase 14 ozaki_conv2d (16,16)x(16,16) with a NaN: K5 launched, "
          "its blocks wrote nothing, the guard counted 1 on the device and "
          f"the result is K1's: {int(nan.sum())} NaN outputs, the rest K1's "
          "bits")
    _ozaki_serving_batch(rng)
    for n in OZAKI_ORDERS:
        shape = (n, n)
        bound = product_bound(shape, shape, shape, rate=F64_MMA)[0]
        print(f"phase 14 K1 order {n}: {k1_ms[(n, n)]:.4f} ms (bound "
              f"{bound:.4g} ms, FP64 tensor rate), beside K5's rows above")
    # conv2d_blocked with K5 inside, at order 1024 (2048 runs in the bench)
    order, P = OZAKI_BLOCKED
    a = torch.from_numpy(rng.random((order, order))).cuda()
    b = torch.from_numpy(rng.random((order, order))).cuda()
    full = (2 * P - 1, 2 * P - 1)

    def inner(x, y):
        return torch.stack([Z.ozaki_conv2d(x[z].contiguous(),
                                           y[z].contiguous(), full)
                            for z in range(x.shape[0])])

    t0 = time.perf_counter()
    out = conv2d_blocked(a, b, (order, order), P, inner, group=4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = spot_check(a.cpu().numpy(), b.cpu().numpy(), out.cpu().numpy(), 64)
    if not err < 1e-12:
        fail(f"conv2d_blocked with K5, order {order}: spot err {err:.3e}")
    print(f"phase 14 conv2d_blocked order {order}, P = {P}, K5 inside: "
          f"{dt:.3f} s (first call), spot check of 64 coefficients against "
          f"host-exact f64 {err:.3e}")
    with tempfile.TemporaryDirectory() as tmp:
        for size in (E2E_SIZE, OZAKI_E2E_SIZE):
            tp = Path(tmp) / f"two_populations_{size}.sgcl"
            generate_two_populations(tp, size, seed=0)
            _ozaki_e2e(launches, tp, degenerate=size == E2E_SIZE)
    _ozaki_compiled(launches)
    _check_no_jax()
    return rows


SCALING_SMOKE = 256  # phase 15's order and limit of bench --scaling
#: the device kernels of K1's bodies, as torch.profiler names them
K1_KERNELS = ("conv2d_small_f64_kernel", "conv2d_trunc_f64_kernel")


def _flag_runs() -> None:
    """Phase 15's CLI flags on the card: ``--profile`` and ``--debug-nans``
    on two_populations, and one forced NaN."""
    from genfer_tpu_torch import cli
    from genfer_tpu_torch.taylor.backend import TorchF64Backend
    from genfer_tpu_torch.tools.generators import generate_two_populations

    with tempfile.TemporaryDirectory() as tmp:
        small = Path(tmp) / f"two_populations_{OZAKI_E2E_SIZE}.sgcl"
        generate_two_populations(small, OZAKI_E2E_SIZE, seed=0)
        trace_dir = Path(tmp) / "trace"
        _, dt = _capture(cli.main, [str(small), "--no-timing", "--backend",
                                    "jax", "--profile", str(trace_dir)])
        events = json.loads((trace_dir / cli.TRACE_FILE).read_text())[
            "traceEvents"]
        k1 = [e for e in events if e.get("cat") == "kernel"
              and any(k in e.get("name", "") for k in K1_KERNELS)]
        if not k1:
            fail(f"--profile: the trace of {len(events)} events holds no K1 "
                 "kernel")
        print(f"phase 15 --backend jax --profile on {small.name}: "
              f"{cli.TRACE_FILE} parses, {len(events)} events, {len(k1)} K1 "
              f"kernels, {sum(e.get('cat') == 'kernel' for e in events)} device "
              f"kernels in all ({dt:.3f} s wall)")
        big = Path(tmp) / f"two_populations_{E2E_SIZE}.sgcl"
        generate_two_populations(big, E2E_SIZE, seed=0)
        flags = [str(big), "--no-timing", "--backend", "jax"]
        checked, checked_s = _capture(cli.main, flags + ["--debug-nans"])
        plain, plain_s = _capture(cli.main, flags)
        if checked != plain:
            fail("--debug-nans: two_populations printed other text with the "
                 "check than without it")
        print(f"phase 15 --backend jax --debug-nans on {big.name}: the text "
              f"of the run without the flag ({checked_s:.3f} s wall with "
              f"the check, {plain_s:.3f} s without)")
    backend = TorchF64Backend()
    backend.enable_nan_check()
    a = torch.tensor([[math.inf, 0.0], [0.0, 0.0]], dtype=torch.float64,
                     device="cuda")
    b = torch.tensor([[0.0, 1.0], [1.0, 1.0]], dtype=torch.float64,
                     device="cuda")
    try:
        backend.conv_trunc(a, b, (2, 2))
    except FloatingPointError as e:
        print(f"phase 15 a NaN forced through K1 with the check on: "
              f"FloatingPointError ({e})")
    else:
        fail("--debug-nans: a NaN from conv_trunc did not raise")


def phase15_flags_and_bench(launches: dict) -> None:
    """The CLI's ``--profile`` and ``--debug-nans``, then the bench's
    ``--scaling`` at ``SCALING_SMOKE`` and ``--suite``'s stand-in over the
    examples."""
    from genfer_tpu_torch import bench

    where = bench.card()
    with _counted(launches, ("conv2d_trunc_f64", "conv2d_trunc_f64[small]",
                             "conv2d_trunc_f32"), "phase 15"):
        _flag_runs()
        scaling = bench.bench_order_scaling(where, limits=(SCALING_SMOKE,),
                                            orders=(SCALING_SMOKE,))
        suite = bench._suite_stand_in(None, families=())
    kernel = scaling["kernel"][str(SCALING_SMOKE)]
    e2e = scaling["end_to_end"][str(SCALING_SMOKE)]
    for name, cell in [*kernel.items(), *e2e.items()]:
        if isinstance(cell, str) and cell.startswith("FAILED"):
            fail(f"bench --scaling {name}: {cell}")
    for backend in ("hybrid", "jax"):
        if not e2e[backend]["is_close"]:
            fail(f"bench --scaling {backend}: not at is_close of numpy "
                 f"({e2e[backend]})")
    if not e2e["pallas"]["max_rel_dev_results"] <= E2E_RTOL:
        fail(f"bench --scaling pallas: {e2e['pallas']} beyond rel {E2E_RTOL}")
    print(f"phase 15 bench --scaling order {SCALING_SMOKE}: K2 "
          f"{kernel['pallas_f32_ms']:.4f} ms (max rel err "
          f"{kernel['pallas_rel_err']:.2e}), K1 {kernel['f64_ms']:.4f} ms, "
          f"host C++ {kernel['host_cpp_ms']:.3f} ms (f64_vs_host "
          f"{kernel['f64_vs_host']:.1f})")
    for backend, row in e2e.items():
        print(f"phase 15 bench --scaling population{bench.SCALING_MODEL} "
              f"limit {SCALING_SMOKE} --backend {backend}: {row['s']:.3f} s "
              f"warm ({row['first_s']:.3f} s first), max rel dev "
              f"{row['max_rel_dev']:.2e} (masses) / "
              f"{row['max_rel_dev_results']:.2e} (Z, moments, p/Z >= "
              f"{bench.P_MIN:g}), is_close {row['is_close']}"
              + (f", {row['device_ops']} device ops" if "device_ops" in row
                 else ""))
    for label, row in suite.items():
        for mode, cell in row.items():
            if not isinstance(cell, dict):
                fail(f"bench --suite stand-in {label} [{mode}]: {cell}")
        print(f"phase 15 bench --suite stand-in {label}: " + ", ".join(
            f"{mode} {cell['s']:.3f} s ({cell['held']} values held)"
            for mode, cell in row.items()))
    _check_no_jax()


def _window_bound(a_shape, b_shape, out, rows) -> float:
    """``bound_ms`` of K1's rows [r0, r1): the multiply-adds of those rows
    (the truncated product to r1 rows less that to r0), the operands read
    once and the window written once, at the FP64 tensor rate."""
    from genfer_tpu_torch.bench import F64_MMA, _conv_pair_flops, bound_ms

    (r0, r1), c1 = rows, out[1]
    macs = (_conv_pair_flops(a_shape, b_shape, (r1, c1))
            - (_conv_pair_flops(a_shape, b_shape, (r0, c1)) if r0 else 0))
    nbytes = 8.0 * (np.prod(a_shape) + np.prod(b_shape) + (r1 - r0) * c1)
    return bound_ms(macs, nbytes, None, F64_MMA)[0]


def _halo_lock_step(a, b, out, tp):
    """The halo schedule of a tp-rank group run in this process: every
    rank's local bodies (``halo_local_conv``, ``halo_keep``,
    ``halo_take``) step by step, the broadcast, the spill ring (rank r
    receives r - 1's) and the rotation (r receives r + 1's accumulator)
    done by indexing; the output blocks concatenated."""
    from genfer_tpu_torch.parallel.mesh import (
        halo_keep,
        halo_local_conv,
        halo_take,
    )

    B = out[0] // tp
    a_blk = [a[r * B:(r + 1) * B].contiguous() for r in range(tp)]
    b_blk = [b[r * B:(r + 1) * B].contiguous() for r in range(tp)]
    acc = [a.new_zeros((B, out[1])) for _ in range(tp)]
    for s in range(tp):
        kept = [halo_keep(acc[r], halo_local_conv(a_blk[s], b_blk[r], out,
                                                  tp), r, s, tp)
                for r in range(tp)]
        acc = [halo_take(kept[r][0], kept[(r - 1) % tp][1], r, s, tp)
               for r in range(tp)]
        acc = [acc[(r + 1) % tp] for r in range(tp)]
    return torch.cat(acc)


def phase16_mesh(launches: dict) -> dict:
    """The mesh layer on the card: (a) the ``dryrun_multichip`` twin on a
    one-rank NCCL group; (b) the local bodies of every rank of tp = 2, 4,
    8 splits on K1, each window held to the whole product's rows bit for
    bit and to the plain version's rows (``rows=``) at ``K1_TOL``, with
    the ms per block beside the whole product's and the
    window's bound, and the halo schedule in lock step against K1's whole
    product; (c) ``--backend sharded`` end to end (a group of one rank:
    no route shards) against ``--backend jax``.  Returns K1's windowed
    launches by body (its kernel-table rows)."""
    from genfer_tpu_torch import cli
    from genfer_tpu_torch.entry import dryrun_multichip
    from genfer_tpu_torch.ops import conv2d_f64 as K
    from genfer_tpu_torch.parallel import mesh as M
    from genfer_tpu_torch.tools import generators

    windowed = dict.fromkeys(K.BODIES, 0)

    def add_windowed():
        for body, n in K.conv2d_trunc_f64.windowed_by_body.items():
            windowed[body] += n

    # (a) the dryrun twin
    t0 = time.perf_counter()
    with _counted(launches, ("conv2d_trunc_f64",), "phase 16 (a)"):
        text, _ = _capture(lambda argv: dryrun_multichip(1), None)
        add_windowed()
    for stage in ("1", "1b", "1c", "2", "3"):
        if f"dryrun_multichip stage {stage} OK" not in text:
            fail(f"phase 16 dryrun_multichip: no stage {stage} line:\n"
                 f"{text}")
    if "dryrun_multichip OK on mesh dp=1 tp=1" not in text:
        fail(f"phase 16 dryrun_multichip: no OK line:\n{text}")
    for line in text.splitlines():
        print(f"phase 16 (a) {line}")
    print(f"phase 16 (a) dryrun_multichip(1) on a one-rank NCCL group: "
          f"{time.perf_counter() - t0:.3f} s wall; K1 windowed launches "
          + ", ".join(f"{k} {v}" for k, v in windowed.items()))

    # (b) every rank's local body of tp = 2, 4, 8 splits
    rng = np.random.default_rng(16)
    for sa, sb, out in MESH_SHAPES:
        a = torch.from_numpy(rng.standard_normal(sa)).cuda()
        b = torch.from_numpy(rng.standard_normal(sb)).cuda()
        whole = K.conv2d_trunc_f64(a, b, out)
        whole_ms = _time(lambda: K.conv2d_trunc_f64(a, b, out))
        body = K.k1_body(sa, sb, out)
        for tp in MESH_TPS:
            windows = M.row_windows(out[0], tp)
            blocks = [M.conv_2d_block(a, b, out, tp, r) for r in range(tp)]
            err = 0.0
            for (r0, r1), blk in zip(windows, blocks):
                if not torch.equal(blk, whole[r0:r1]):
                    fail(f"phase 16 {sa}x{sb} tp={tp}: rank rows "
                         f"[{r0}, {r1}) differ from K1's whole product")
                want = K.conv2d_trunc_f64_reference(
                    a, b, out, _plain_rows(out), rows=(r0, r1))
                err = max(err, _k1_gate(
                    f"phase 16 {sa}x{sb} tp={tp} rows [{r0}, {r1})", blk,
                    want, "norm"))
                del want
            ms = [_time(lambda r=r: M.conv_2d_block(a, b, out, tp, r))
                  for r in range(tp)]
            bounds = [_window_bound(sa, sb, out, w) for w in windows]
            print(f"phase 16 (b) {sa}x{sb} {body} tp={tp}: every rank's "
                  f"window equals the whole product's rows bit for bit and "
                  f"the plain version's rows within max abs err {err:.3e} "
                  f"(norm gate {K1_TOL}); "
                  f"ms per block " + " / ".join(f"{t:.4f}" for t in ms)
                  + f" (max {max(ms):.4f}, sum {sum(ms):.4f}) against the "
                  f"whole {whole_ms:.4f} ms; bound per block "
                  + " / ".join(f"{t:.4g}" for t in bounds) + " ms")
        # the inference step's body: a batch of 2, every rank's rows
        ab, bb = torch.stack([a, -a]), torch.stack([b, b])
        for tp in MESH_TPS:
            parts = [M.inference_block(ab, bb, out, tp, r) for r in
                     range(tp)]
            prod = torch.cat([p for p, _ in parts], dim=1)
            if not (torch.equal(prod[0], whole) and torch.equal(prod[1],
                                                                 -whole)):
                fail(f"phase 16 {sa}x{sb} tp={tp}: inference_block rows "
                     "differ from K1's whole product")
            total = sum(t for _, t in parts)
            err = float(((total - prod.sum(dim=(1, 2))).abs()
                         / prod.abs().sum(dim=(1, 2))).max())
            if not err <= K1_TOL:
                fail(f"phase 16 {sa}x{sb} tp={tp}: totals off by {err:.3g}")
        print(f"phase 16 (b) {sa}x{sb}: inference_block of every rank at "
              f"tp = {MESH_TPS} equals the whole batch bit for bit")
        del whole, a, b, ab, bb
    sa, sb, out = MESH_HALO
    a = torch.from_numpy(rng.random(sa)).cuda()
    b = torch.from_numpy(rng.random(sb)).cuda()
    whole = K.conv2d_trunc_f64(a, b, out)
    for tp in MESH_TPS:
        halo = _halo_lock_step(a, b, out, tp)
        err = float(((halo - whole).abs() / whole.abs()).max())
        if not err <= K1_TOL:
            fail(f"phase 16 halo {sa}x{sb} tp={tp}: rel err {err:.3g}")
        ms = _time(lambda: _halo_lock_step(a, b, out, tp))
        print(f"phase 16 (b) halo {sa}x{sb}->{out} tp={tp}: every rank's "
              f"bodies in lock step within rel {err:.2e} of K1's whole "
              f"product; {ms:.4f} ms for all ranks' steps in one process")

    # (c) --backend sharded end to end
    with tempfile.TemporaryDirectory() as tmp:
        for label, gen, gargs in MESH_CLI:
            path = Path(tmp) / f"{label}.sgcl"
            getattr(generators, gen)(path, *gargs, seed=0)
            flags = [str(path), "--no-timing", "--backend"]
            with _counted(launches, ("conv2d_trunc_f64",),
                          f"phase 16 (c) {label}{gargs}"):
                sharded_out, sharded_s = _capture(cli.main,
                                                  flags + ["sharded"])
                add_windowed()
            M.close_group()
            jax_out, jax_s = _capture(cli.main, flags + ["jax"])
            n = _agree(read_results(sharded_out), read_results(jax_out),
                       f"{label} sharded")
            print(f"phase 16 (c) {label}{gargs} --backend sharded (one "
                  f"rank): {n} results at is_close of --backend jax "
                  f"(identical text: {sharded_out == jax_out}); sharded "
                  f"{sharded_s:.3f} s, jax {jax_s:.3f} s wall")
    _check_no_jax()
    return windowed


def _one_pass_hold(name, got, plain, want, three, atol, label) -> tuple:
    """Fail unless the one-pass ``got`` is finite, within phase 3's bar of
    its one-pass ``plain`` version, within the one-pass bound of the f64
    ``want`` (operands >= 0: |a| * |b| is the product) and not the
    three-pass result ``three``; its max abs and rel error against f64."""
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        fail(f"{name} {label}: bad shape {tuple(got.shape)} or non-finite")
    bar = atol + RTOL * plain.abs()
    if not bool(((got - plain).abs() <= bar).all()):
        fail(f"{name} {label}: off its one-pass plain version by "
             f"{float(((got - plain).abs() / bar).max()):.3g} x the rtol "
             f"{RTOL} / atol {atol} bar")
    diff = (got.double() - want).abs()
    bound = atol + (ONE_PASS + RTOL) * want.abs()
    if not bool((diff <= bound).all()):
        fail(f"{name} {label}: off f64 by {float((diff / bound).max()):.3g}"
             " x the one-pass bound")
    if torch.equal(got, three):
        fail(f"{name} {label}: the one-pass result equals the three-pass "
             "one: it ran three passes")
    return (diff.max().item(),
            (diff / want.abs().clamp_min(atol)).max().item())


def _tf32_library(library, want, atol) -> tuple[float, float]:
    """``_library`` with cuDNN's TF32 on: one cuDNN f32 ``conv2d`` on
    TF32-rounded operands, the one-pass function, timed after one untimed
    call (cuDNN's first call with TF32 picks its algorithm: several times
    the next one's time at 512); the flag restored."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        library()
        return _library(library, want, atol)
    finally:
        torch.backends.cudnn.allow_tf32 = before


def device_us_queued(call, calls: int = 20) -> float:
    """The card's microseconds a ``call()``, the host's time kept out:
    the stream is held by a spin (``torch.cuda._sleep``) three times as
    long as the host takes to queue ``calls`` calls (at least 5 ms), and
    CUDA events bracket the calls queued behind it.  Fails if the host
    had not queued them all when the spin ended."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    held.record()
    torch.cuda._sleep(int(max(5.0, 3.0 * host_ms) * 2e6))  # <= 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if queued_ms >= held.elapsed_time(start):
        fail(f"device_us_queued: the host took {queued_ms:.3f} ms to queue "
             f"{calls} calls, longer than the {held.elapsed_time(start):.3f}"
             " ms spin")
    return start.elapsed_time(end) * 1e3 / calls


def _profiler_split(call, device_us: float, calls: int = 20) -> str:
    """torch.profiler's device microseconds a ``call()`` by kernel, where
    every kernel's events number a multiple of ``calls`` and sum to within
    25% of ``device_us`` (the events' time); otherwise that the split is
    not kept, with the events' counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    us: dict = {}
    count: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.name)
            us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / calls
            count[name] = count.get(name, 0) + 1
    total = sum(us.values())
    if (count and all(n % calls == 0 for n in count.values())
            and abs(total - device_us) <= 0.25 * device_us):
        return "torch.profiler: " + ", ".join(
            f"{k} {v:.2f}" for k, v in us.items())
    return ("torch.profiler's split not kept: its events (" + ", ".join(
        f"{k} x{n}" for k, n in count.items()) + f" over {calls} calls) sum "
        f"to {total:.2f} us a call")


def _one_pass_macs(sa, sb, out) -> tuple[float, float]:
    """The multiply-adds the one-pass tile kernel issues for one product
    of these shapes (``ops.conv2d.rowstrip_issued_flops``), and the useful
    ones."""
    from genfer_tpu_torch.bench import _conv_pair_flops
    from genfer_tpu_torch.ops.conv2d import rowstrip_issued_flops

    return (rowstrip_issued_flops(sa, sb, out, highest=False) / 2.0,
            float(_conv_pair_flops(sa, sb, out)))


def _one_pass_device_line(label, call, k4b_call, issued_macs: float,
                          useful_macs: float, k4b_calls: int = 20) -> dict:
    """The card's microseconds a call (``device_us_queued``) of the tile
    kernel's (or K3's) one pass ``call`` and, in the same process, of
    K4b's one pass on the same operands (``k4b_call``: the same ``wgmma``
    body in residue-major order, issuing the same ``issued_macs``), each
    with the split by kernel that torch.profiler gives where it agrees.
    Fails where a time is under the TF32 rate's bound for the
    multiply-adds the call issues.  ``k4b_calls``: the calls of
    ``k4b_call`` queued at once (a loop of wrappers fills the card's
    launch queue, and a full queue holds the host back)."""
    from genfer_tpu_torch.bench import TF32_MMA_PER_S

    issued_us = issued_macs / TF32_MMA_PER_S * 1e6
    new = device_us_queued(call)
    k4b = device_us_queued(k4b_call, k4b_calls)
    for what, us in (("the tile kernel's one pass", new),
                     ("K4b's one pass", k4b)):
        if us < issued_us:
            fail(f"phase 17 {label}: {what} {us:.2f} us a call is under "
                 f"the TF32 rate's {issued_us:.2f} us for its "
                 f"{issued_macs:.4g} multiply-adds: not a real time")
    print(f"phase 17 {label} device us a call (CUDA events, calls queued "
          f"behind a spin; shares of the TF32 rate at the "
          f"{issued_macs / useful_macs:.4f} x issued multiply-adds): the "
          f"tile kernel's one pass {new:.2f} ({issued_us / new:.1%}; "
          f"{_profiler_split(call, new)}); K4b's one pass in the same call "
          f"{k4b:.2f} ({issued_us / k4b:.1%}; "
          f"{_profiler_split(k4b_call, k4b, k4b_calls)})")
    return {"device_us": new, "k4b_device_us": k4b}


def _round_bound_ms(a_shape, b_shape) -> float:
    """The rounding kernel's bytes bound: each operand word read once,
    each rounded word (rows padded to 4) written once."""
    from genfer_tpu_torch.bench import BYTES_PER_S

    (a0, a1), (b0, b1) = a_shape, b_shape
    moved = 4 * (a0 * a1 + b0 * b1 + a0 * -(-a1 // 4) * 4
                 + b0 * -(-b1 // 4) * 4)
    return moved / BYTES_PER_S * 1e3


def _round_kernel_line(a, b, label) -> float:
    """The rounding kernel on the one-pass operands ``a``, ``b``: fail
    unless it gives ``tf32_round``'s bits with zero pads; print its device
    time (``device_us_queued``) beside its bytes bound, and return it."""
    from genfer_tpu_torch.ops.conv2d import tf32_round, tf32_round_operands

    (ra, rb) = tf32_round_operands(a, b)
    torch.cuda.synchronize()
    for x, rx in ((a, ra), (b, rb)):
        want = F.pad(tf32_round(x), (0, -x.shape[1] % 4))
        if not torch.equal(rx.view(torch.int32), want.view(torch.int32)):
            fail(f"tf32_round_operands {label}: not tf32_round's bits")
    us = device_us_queued(lambda: tf32_round_operands(a, b))
    bound_us = _round_bound_ms(tuple(a.shape), tuple(b.shape)) * 1e3
    print(f"phase 17 {ROUND_KERNEL[0]} {label}: tf32_round's bits, pads "
          f"zero; device {us:.2f} us a call (CUDA events, calls queued "
          f"behind a spin) against its bytes bound {bound_us:.3f} us "
          f"({bound_us / us:.1%})")
    return us


def _round_kernel_row(a, b) -> dict:
    """The rounding kernel on the one-pass operands ``a``, ``b`` for the
    kernel table: its time, its plain version's and its device time
    (``_round_kernel_line``, which holds its bits)."""
    from genfer_tpu_torch.ops.conv2d import tf32_round, tf32_round_operands

    def plain():
        return tuple(F.pad(tf32_round(x), (0, -x.shape[1] % 4))
                     for x in (a, b))

    device_us = _round_kernel_line(a, b, f"{tuple(a.shape)}, "
                                   f"{tuple(b.shape)}")
    call = lambda: tf32_round_operands(a, b)  # noqa: E731
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    row = {"max_abs_err": 0.0, "ms": _time(call), "plain_ms": _time(plain),
           "library_ms": None, "device_us": device_us}
    print(f"phase 17 {ROUND_KERNEL[0]} {tuple(a.shape)}, {tuple(b.shape)}: "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; host "
          f"{host_us:.2f} us a call (wrapper and launch, not waiting)")
    return row


def phase17_one_pass_kernels() -> dict:
    """The one-pass wrappers against their plain versions and f64 on
    ``SHAPES`` and ``EXTREME``, K3's at ``BATCHES`` (module docstring)."""
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64_reference

    rng = np.random.default_rng(17)
    rows: dict = {name: {} for name in ONE_PASS_KERNELS}
    single = [name for name in ONE_PASS_KERNELS
              if name != "conv2d_trunc_f32_batched"]
    cases = [(shape, ATOL) for shape in SHAPES] + [(EXTREME, ATOL_EXTREME)]
    for (sa, sb, out), atol in cases:
        a, b = rng.random(sa), rng.random(sb)
        if atol == ATOL_EXTREME:
            a = a * 10.0 ** np.linspace(-30, 30, sa[1])
            b = b * 10.0 ** np.linspace(-6, 6, sb[1])
        a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        a32, b32 = a64.float(), b64.float()
        want = conv2d_trunc_f64_reference(a64, b64, out)
        label = f"{sa}x{sb}->{out}" + (
            " extreme scales" if atol == ATOL_EXTREME else "")
        key = (sa, sb, out) if atol == ATOL else "extreme"
        timed = (sa, sb, out) in ONE_PASS_TIMED
        library = (_tf32_library(_conv2d_library(a32[None], b32, out), want,
                                 atol) if timed else None)
        plain = ops.conv2d_trunc_f32_reference(a32, b32, out, highest=False)
        for name in single:
            kernel = getattr(ops, name)
            got = kernel(a32, b32, out, highest=False)
            abs_err, rel_err = _one_pass_hold(
                f"{name} one pass", got, plain, want, kernel(a32, b32, out),
                atol, label)
            if not torch.equal(kernel(a32, b32, out, highest=False), got):
                fail(f"{name} one pass {label}: two calls differ")
            rows[name][(key, 1)] = {"max_abs_err": abs_err,
                                    "max_rel_err": rel_err}
        if timed:
            # in turns (K2, K4a, K4b, K4b, K4a, K2), the least of each: a
            # host-bound call's mean moves with the host between runs
            ms: dict = {}
            for name in single + single[::-1]:
                kernel = getattr(ops, name)
                ms[name] = min(ms.get(name, math.inf), _time(
                    lambda k=kernel: k(a32, b32, out, highest=False)))
            plain_ms = _time(lambda: ops.conv2d_trunc_f32_reference(
                a32, b32, out, highest=False))
            for name in single:
                rows[name][(key, 1)].update(ms=ms[name], plain_ms=plain_ms,
                                            library_ms=library[0])
        if not torch.equal(ops.conv2d_trunc_f32(a32, b32, out, highest=False),
                           ops.conv2d_trunc_f32_tile(a32, b32, out,
                                                     highest=False)):
            fail(f"conv2d_trunc_f32 one pass {label}: not the one-pass "
                 "tile kernel's bits")
        if timed and sa == sb == out and len(set(sa)) == 1:
            rows["conv2d_trunc_f32_tile"][(key, 1)].update(
                _one_pass_device_line(
                    label, lambda: ops.conv2d_trunc_f32_tile(
                        a32, b32, out, highest=False),
                    lambda: ops.conv2d_trunc_f32_grouped(
                        a32, b32, out, highest=False),
                    *_one_pass_macs(sa, sb, out)))
        if (sa, sb, out) == ROUND_KERNEL[3]:
            rows[ROUND_KERNEL[0]] = {(key, 1): _round_kernel_row(a32, b32)}
        elif atol == ATOL:
            _round_kernel_line(a32, b32, label)
        grouped = ops.conv2d_trunc_f32_grouped(a32, b32, out, highest=False)
        tile = ops.conv2d_trunc_f32_tile(a32, b32, out, highest=False)
        if not bool(((grouped - tile).abs()
                     <= 2e-6 * tile.abs() + atol).all()):
            fail(f"conv2d_trunc_f32_grouped one pass {label}: not the "
                 "one-pass tile kernel's result to f32 rounding")
        del grouped, tile
        print(f"phase 17 {label}: K2, K4a, K4b one pass within rtol {RTOL} /"
              f" atol {atol} of the plain version and the one-pass bound of "
              f"f64 (max rel err " + ", ".join(
                  f"{rows[n][(key, 1)]['max_rel_err']:.3e}" for n in single)
              + "), not the three-pass result, the same bits twice, K2 the "
              "tile kernel's bits" + ("; " + ", ".join(
                  f"{n} {rows[n][(key, 1)]['ms']:.4f} ms" for n in single)
                  + f", plain {rows[single[0]][(key, 1)]['plain_ms']:.4f} "
                  f"ms, cuDNN TF32 {library[0]:.4f} ms (max rel err "
                  f"{library[1]:.3e})" if timed else ""))
        del want, plain
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
            got_b = ops.conv2d_trunc_f32_batched(ab32, b32, out,
                                                 highest=False)
            abs_err, rel_err = _one_pass_hold(
                "conv2d_trunc_f32_batched one pass", got_b,
                ops.conv2d_trunc_f32_batched_reference(ab32, b32, out,
                                                       highest=False),
                want_b, ops.conv2d_trunc_f32_batched(ab32, b32, out), atol,
                blabel)
            if not torch.equal(ops.conv2d_trunc_f32_batched(
                    ab32, b32, out, highest=False), got_b):
                fail(f"conv2d_trunc_f32_batched one pass {blabel}: two "
                     "calls differ")
            for g in range(batch):
                if not torch.equal(got_b[g], ops.conv2d_trunc_f32(
                        ab32[g], b32, out, highest=False)):
                    fail(f"conv2d_trunc_f32_batched one pass {blabel}: "
                         f"entry {g} differs from the single-pair one pass")
            row = {"max_abs_err": abs_err, "max_rel_err": rel_err}
            if (key, batch) == ONE_PASS_KERNELS[
                    "conv2d_trunc_f32_batched"][3]:
                row.update(
                    ms=_time(lambda: ops.conv2d_trunc_f32_batched(
                        ab32, b32, out, highest=False)),
                    plain_ms=_time(
                        lambda: ops.conv2d_trunc_f32_batched_reference(
                            ab32, b32, out, highest=False)),
                    library_ms=_tf32_library(
                        _conv2d_library(ab32, b32, out), want_b, atol)[0])
                row.update(_one_pass_device_line(
                    blabel, lambda: ops.conv2d_trunc_f32_batched(
                        ab32, b32, out, highest=False),
                    lambda: [ops.conv2d_trunc_f32_grouped(
                        x, b32, out, highest=False) for x in ab32],
                    *(batch * m for m in _one_pass_macs(sa, sb, out)),
                    k4b_calls=2))
            rows["conv2d_trunc_f32_batched"][(key, batch)] = row
            print(f"phase 17 K3 one pass {blabel}: within the bars (max rel "
                  f"err {rel_err:.3e}), not the three-pass result, the same "
                  "bits twice, every entry the single-pair one pass's bits"
                  + (f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
                     f", cuDNN TF32 {row['library_ms']:.4f} ms"
                     if "ms" in row else ""))
            del ab, ab32, want_b, got_b
    return rows


def _digit_twin(launches: dict) -> None:
    """``examples/digit_serving_torch.py`` at its defaults (784 pixels,
    batch 1024) on a seeded theta, the ``DIGIT_HOST_ROWS`` posteriors
    held to the host interpreter at is_close."""
    import re

    from genfer_tpu_torch.printed import IS_CLOSE

    digit = _example("digit_serving_torch")
    rel, absolute = IS_CLOSE
    with tempfile.TemporaryDirectory() as tmp:
        theta = np.random.RandomState(0).uniform(0.05, 0.95,
                                                 (10, DIGIT_PIXELS))
        np.savetxt(Path(tmp) / "digitParams.csv", theta, delimiter=",")
        digit.DATA = Path(tmp)
        err = io.StringIO()
        with _counted(launches, (), "phase 17 digit twin"):
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                post = digit.main([])
            wall = time.perf_counter() - t0
        images = (np.random.RandomState(0).rand(DIGIT_BATCH, DIGIT_PIXELS)
                  < 0.15).astype(np.float64)
        ev = digit.evidence_params(images, theta, "cpu").numpy()
        src, params = digit.model_source(DIGIT_PIXELS)
        worst = 0.0
        for i in DIGIT_HOST_ROWS:
            values = dict(zip(params, ev[i]))
            text = _host_text(re.sub(r"\$(e\d+_\d+)",
                                     lambda m: repr(float(values[m[1]])),
                                     src))
            host = read_results(text)
            for k in range(10):
                want = host[f"p({k}) / Z"]
                dev = abs(post[i, k] - want)
                if not dev <= absolute + rel * abs(want):
                    fail(f"digit twin row {i}: p({k}) = {post[i, k]} "
                         f"against host {want}")
                worst = max(worst, dev / max(abs(want), 1e-300))
    if post.shape != (DIGIT_BATCH, 10):
        fail(f"digit twin: posteriors of shape {post.shape}")
    lines = [line for line in err.getvalue().splitlines() if "steady" in line]
    print(f"phase 17 digit twin {DIGIT_PIXELS} pixels B={DIGIT_BATCH}: rows "
          f"{list(DIGIT_HOST_ROWS)} at is_close of the host interpreter "
          f"(max rel dev {worst:.3e}); {wall:.3f} s wall; "
          + (lines[0].strip() if lines else "no steady line"))


def _switchpoint_twin(launches: dict) -> None:
    """``examples/switchpoint_serving_torch.py`` at its defaults (order
    128, 200 datasets) on the generated coal-mining cascade, the
    committed dataset's posterior held to the host interpreter."""
    from genfer_tpu_torch.tools.generators import generate_switchpoint

    twin = _example("switchpoint_serving_torch")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "switchpoint.sgcl"
        generate_switchpoint(path, continuous=True)
        out = io.StringIO()
        with _counted(launches, (), "phase 17 switchpoint twin"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                (masses, z), posts = twin.main(["--file", str(path)])
            wall = time.perf_counter() - t0
        host = read_results(_host_text(path.read_text()))
    # the posterior p(k) / Z at is_close; Z itself is printed, not held:
    # the cascade at order 128 and the interpreter differ by ~1e-8 of it
    want = {k: v for k, v in host.items() if k.startswith("p(")}
    if not 0 < len(want) <= len(masses) or len(posts) != 200:
        fail(f"switchpoint twin: {len(want)} host masses for "
             f"{len(masses)}, {len(posts)} datasets served")
    got = {k: masses[int(k[2:k.index(")")])] / z for k in want}
    compared = _agree(got, want, "switchpoint twin")
    for line in out.getvalue().strip().splitlines():
        print(f"phase 17 switchpoint twin: {line}")
    print(f"phase 17 switchpoint twin: the committed dataset's {compared} "
          f"p(k) / Z at is_close of the host interpreter, Z {z!r} against "
          f"{host['Z']!r} (rel {abs(z - host['Z']) / host['Z']:.3e}); "
          f"{wall:.3f} s wall (the cascade is host numpy, as in genfer_tpu)")


def _example(name: str):
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase17_main_path(launches: dict) -> dict:
    """The one-pass mode's main path, counted: ``tune_port.py`` probe 19's
    decomposition at 256 and 512 (every one-pass wrapper must launch);
    then the two example twins."""
    from tune_port import FLOOR_ORDERS, floor_decomposition

    with _counted(launches, (*(n for n, *_ in ONE_PASS_KERNELS.values()),
                             ROUND_KERNEL[0]),
                  "phase 17 floor decomposition"):
        floor = floor_decomposition(FLOOR_ORDERS, label="phase 17")
    _digit_twin(launches)
    _switchpoint_twin(launches)
    _check_no_jax()
    return floor


def print_shares(rows: dict, bench: dict) -> None:
    """The kernels' shares of their bounds (``bound_ms`` over the
    measured time): K2, K4a and K4b from phase 3's dense orders (K4a and
    K4b against the tensor cores' rate for their three TF32 passes, with
    K2's time in the same run beside theirs), K3 from phase 5's
    batches, K6, K1, and the one-pass K2, K4a and K4b from phase 17's
    dense orders (one TF32 pass)."""
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
    for wrapper, (name, *_) in ONE_PASS_KERNELS.items():
        if wrapper == "conv2d_trunc_f32_batched":
            continue
        parts = []
        for order in DENSE_ORDERS:
            shape = (order, order)
            ms = rows[name][((shape,) * 3, 1)]["ms"]
            bound, by = product_bound(shape, shape, shape, passes=1)
            if not bound <= ms:
                fail(f"{name} order {order}: {ms} ms is under its bound "
                     f"{bound} ms")
            parts.append(f"{order}: {ms:.4f} ms = {100 * bound / ms:.1f}%")
        print(f"share of bound ({by}, tf32 mma x 1), {name} "
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


def kernel_table(rows: dict, launches: dict, windowed: dict) -> list:
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
    for wrapper, (name, source, replaces, key) in ONE_PASS_KERNELS.items():
        shape, batch = key
        bound, by = product_bound(*shape, batch=batch, passes=1)
        table.append(_entry(name, source, replaces, launches.get(name, 0),
                            rows[name][key], rows[name], bound, by,
                            "tf32 mma x 1"))
    name, source, replaces, shape = ROUND_KERNEL
    (row,) = rows[name].values()
    table.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches.get(name, 0),
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": _round_bound_ms(shape[0], shape[1]), "bound_by": "bytes",
        "library_ms": None, "device_us": row["device_us"]})
    split = rows["ozaki_split"]
    table.append({
        "name": "ozaki_split", "route": "cuda",
        "source": OZAKI_SOURCES["ozaki_split"],
        "replaces": OZAKI_REPLACES["ozaki_split"],
        "launches": launches.get("ozaki_split", 0), **split})
    for impl in ("int8", "bf16"):
        name = f"ozaki_conv2d[{impl}]"
        (row,) = rows[name].values()
        table.append({
            "name": name, "route": "cuda",
            "source": OZAKI_SOURCES["ozaki_conv2d"],
            "replaces": OZAKI_REPLACES["ozaki_conv2d"],
            "launches": launches.get(name, 0), **row})
    ((_, rows_n, shape, links), row), *_ = rows["spine_f64"].items()
    table.append({
        "name": "spine_f64", "route": "cuda", "source": SPINE_SOURCE,
        "replaces": SPINE_REPLACES, "launches": launches.get("spine_f64", 0),
        "shape": [rows_n, list(shape), links], **row})
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
        # of those, the launches with an output-row window (phase 16)
        table[-1]["window_launches"] = windowed[body]
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
    rows["spine_f64"] = phase11_serving(launches)["spine_f64"]
    phase12_scan_models(launches)
    phase13_scan_compiler(launches)
    rows.update(phase14_ozaki(launches))
    phase15_flags_and_bench(launches)
    windowed = phase16_mesh(launches)
    one_pass = phase17_one_pass_kernels()
    phase17_main_path(launches)
    rows.update({ONE_PASS_KERNELS[name][0] if name in ONE_PASS_KERNELS
                 else name: r for name, r in one_pass.items()})
    print_shares(rows, bench)
    print(json.dumps({"kernels": kernel_table(rows, launches, windowed)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
