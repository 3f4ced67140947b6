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

Each of phases 4-6 sets the launch counts to 0 just before it and reads
them just after.  Before the table, the shares of their bounds of K2,
K3, K4a, K4b and K6 (the tensor-core kernels against the TF32 rate,
three passes) with K2's time beside K4a's and K4b's.  The
second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Everything is reached through
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
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
}

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
    from genfer_tpu_torch.taylor.backend import _conv_impl

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
        want = _conv_impl(a64, b64, out)
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
            want_b = torch.stack([_conv_impl(x, b64, out) for x in ab])
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
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
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


_POINT = re.compile(r"^(?:Normalized:\s+)?(.+?)\s+=\s+(\S+)$")


def read_results(text: str) -> dict[str, float]:
    """The point results a run printed: ``Z``, ``E``, ``σ`` and the other
    moments by their symbol, each ``p(k)`` of a normalized program, and
    each ``p(k) / Z`` of an unnormalized one (its unnormalized lines and
    the "p(n) <= ..." tail bounds are left out)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("Unnormalized:") or "<=" in line:
            continue
        m = _POINT.match(line.strip())
        if m is not None:
            out[m.group(1).split(":")[-1].strip()] = float(m.group(2))
    return out


def _capture(main, argv) -> tuple[str, float]:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue(), time.perf_counter() - t0


def _wrappers() -> dict:
    from genfer_tpu_torch import ops

    return {name: getattr(ops, name) for name in KERNELS}


@contextlib.contextmanager
def _counted(launches: dict, must: tuple, what: str):
    """Set every kernel's launch count to 0, run the block, then add the
    counts to ``launches``; fail if a kernel of ``must`` was not
    launched."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    yield
    counts = {name: w.launches for name, w in wrappers.items()}
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


def print_shares(rows: dict, bench: dict) -> None:
    """The kernels' shares of their bounds (``bound_ms`` over the
    measured time): K2, K4a and K4b from phase 3's dense orders (K4a and
    K4b against the tensor cores' rate for their three TF32 passes, with
    K2's time in the same run beside theirs), K3 from phase 5's
    batches."""
    from genfer_tpu_torch.bench import SPLIT_PASSES, product_bound

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


def kernel_table(rows: dict, launches: dict) -> list:
    from genfer_tpu_torch.bench import product_bound

    table = []
    for name, (source, replaces, key) in KERNELS.items():
        row = rows[name][key]
        shape, batch = key
        passes = _passes(name, shape)
        if name == "conv1d_trunc_f32":
            la, lb, lc = shape
            bound, by = product_bound((la,), (lb,), (lc,), passes=passes)
        else:
            bound, by = product_bound(*shape, batch=batch, passes=passes)
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            # over the unit-scale shapes (the extreme and geometric
            # pairs' outputs reach 1e36 and 1e-36, and are held by their
            # relative error)
            "max_abs_err": max(r["max_abs_err"]
                               for k, r in rows[name].items()
                               if k[0] not in ("extreme", "geometric")),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            # "operations": of the f32 FMA rate, or of the TF32 tensor
            # rate (``bound_rate``) for the kernels that run there
            "bound_ms": bound, "bound_by": by.split()[-1],
            "bound_rate": "f32 fma" if passes is None else "tf32 mma x 3",
            "library_ms": row["library_ms"],
        })
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
    print_shares(rows, bench)
    print(json.dumps({"kernels": kernel_table(rows, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
