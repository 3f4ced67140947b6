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
   ``conv2d_trunc_f32_grouped`` (K4b) on ``SHAPES``,
   ``conv2d_trunc_f32_batched`` (K3) on ``SHAPES`` at B = 3 and 32, and
   ``conv1d_trunc_f32`` (K6) on ``SHAPES_1D``.  Times of the kernel, of
   its plain version and of one library call computing the same function
   (``torch.nn.functional.conv2d`` / ``conv1d`` of the flipped operand,
   cuDNN in IEEE f32), all from CUDA events;
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
them just after.  The second-to-last line is the kernel table as JSON; the
last line is ``{"ok": true, "device": {...}}``.  Everything is reached
through ``genfer_tpu_torch``; nothing here imports jax or genfer_tpu.

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
# orders 256, 384 and 512
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
]
# (la, lb, lc): the Pallas test's shape, edge lengths, and phase 6's
SHAPES_1D = [
    (100, 37, 120),
    (1, 1, 1),
    (300, 7, 129),
    (7, 300, 300),
    (POISSON_LEN, POISSON_LEN, POISSON_LEN),
]
DENSE_512 = ((512, 512), (512, 512), (512, 512))
DENSE_256 = ((256, 256), (256, 256), (256, 256))

#: kernel -> (source, TPU kernel it replaces, the shape of the kernel
#: table's times: the largest product phase 4 sends K2, the bench's
#: largest order for K4a / K4b, its 256 x B32 for K3, phase 6's for K6)
KERNELS = {
    "conv2d_trunc_f32": (
        "genfer_tpu_torch/csrc/conv2d_trunc_f32.cu",
        "genfer_tpu/ops/pallas_conv2d.py:189",
        (((95, 1), (95, 87), (95, 87)), 1)),
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


def _time(fn) -> float:
    """Milliseconds a call of ``fn``: one warm-up call, one timed probe,
    then as many calls as fit in ~0.1 s (1 to 200), from CUDA events."""
    from genfer_tpu_torch.bench import time_ms

    probe = time_ms(fn, 1, warmup=1)
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


def _check(name, got, want, rtol) -> tuple[float, float]:
    """Fail unless ``got`` is finite, of ``want``'s shape and within
    ``rtol`` / ``ATOL`` of it; return its max abs and rel error."""
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        fail(f"{name}: bad shape {tuple(got.shape)} or non-finite")
    diff = (got.double() - want).abs()
    if not bool((diff <= ATOL + rtol * want.abs()).all()):
        err = (diff / (ATOL + rtol * want.abs())).max().item()
        fail(f"{name}: off by {err:.3g}x the rtol {rtol} / atol {ATOL} bar "
             "against f64")
    return diff.max().item(), (diff / want.abs().clamp_min(ATOL)).max().item()


def _measure(name, kernel, plain, library, want, rtol, label) -> dict:
    """Hold ``kernel()`` and ``plain()`` against ``want``; time all three
    (``library()``'s error is printed, not held: cuDNN may pick an
    algorithm of another accuracy)."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err = _check(f"{name} {label}", got, want, rtol)
    _check(f"{name} plain {label}", ref, want, rtol)
    lib = library().reshape(want.shape).double()
    lib_rel = ((lib - want).abs() / want.abs().clamp_min(ATOL)).max().item()
    row = {"max_abs_err": abs_err, "ms": _time(kernel),
           "plain_ms": _time(plain), "library_ms": _time(library)}
    print(f"phase 3 {name} {label}: max abs err {abs_err:.3e}, max rel err "
          f"{rel_err:.3e}; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
          f"(max rel err {lib_rel:.3e})")
    return row


def phase3_kernels() -> dict:
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.taylor.backend import _conv_impl

    rng = np.random.default_rng(0)
    rows: dict = {name: {} for name in KERNELS}
    for sa, sb, out in SHAPES:
        a, b = rng.random(sa), rng.random(sb)
        a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        a32, b32 = a64.float(), b64.float()
        want = _conv_impl(a64, b64, out)
        library = _conv2d_library(a32[None], b32, out)
        label = f"{sa}x{sb}->{out}"
        for name in ("conv2d_trunc_f32", "conv2d_trunc_f32_tile",
                     "conv2d_trunc_f32_grouped"):
            kernel = getattr(ops, name)
            rows[name][((sa, sb, out), 1)] = _measure(
                name, lambda k=kernel: k(a32, b32, out),
                lambda: ops.conv2d_trunc_f32_reference(a32, b32, out),
                library, want, RTOL, label)
        for batch in BATCHES:
            ab = torch.from_numpy(rng.random((batch, *sa))).cuda()
            ab32 = ab.float()
            want_b = torch.stack([_conv_impl(x, b64, out) for x in ab])
            rows["conv2d_trunc_f32_batched"][((sa, sb, out), batch)] = (
                _measure(
                    "conv2d_trunc_f32_batched",
                    lambda: ops.conv2d_trunc_f32_batched(ab32, b32, out),
                    lambda: ops.conv2d_trunc_f32_batched_reference(
                        ab32, b32, out),
                    _conv2d_library(ab32, b32, out), want_b, RTOL,
                    f"B={batch} {label}"))
            del ab, ab32, want_b
    for la, lb, lc in SHAPES_1D:
        a, b = rng.random(la), rng.random(lb)
        a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        a32, b32 = a64.float(), b64.float()
        want = _conv_impl(a64, b64, (lc,))
        rows["conv1d_trunc_f32"][((la, lb, lc), 1)] = _measure(
            "conv1d_trunc_f32",
            lambda: ops.conv1d_trunc_f32(a32, b32, lc),
            lambda: ops.conv1d_trunc_f32_reference(a32, b32, lc),
            _conv1d_library(a32, b32, lc), want, RTOL_1D,
            f"({la},)x({lb},)->({lc},)")
    return rows


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


def phase5_bench(launches: dict) -> None:
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


def kernel_table(rows: dict, launches: dict) -> list:
    from genfer_tpu_torch.bench import product_bound

    table = []
    for name, (source, replaces, key) in KERNELS.items():
        row = rows[name][key]
        shape, batch = key
        if name == "conv1d_trunc_f32":
            la, lb, lc = shape
            bound, by = product_bound((la,), (lb,), (lc,))
        else:
            bound, by = product_bound(*shape, batch=batch)
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"]
                               for r in rows[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bound, "bound_by": by,
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
    launches: dict = {}
    phase4_end_to_end(launches)
    phase5_bench(launches)
    phase6_ops_api(launches)
    print(json.dumps({"kernels": kernel_table(rows, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
