#!/usr/bin/env python3
"""Smoke run of genfer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before a result):

1. a CUDA card must be present; print nvidia-smi's name and power limit;
2. build the CUDA kernels from ``genfer_tpu_torch/csrc`` with nvcc;
3. the f32 kernel ``conv2d_trunc_f32`` against its plain PyTorch version
   and the f64 product ``_conv_impl`` on the card, at rtol 5e-5 /
   atol 1e-6 against f64 (the bar of the Pallas kernel's tests), with
   both times from CUDA events;
4. end to end: the two-population model (``generate_two_populations``,
   seed 0, size ``SIZE``) through ``python -m genfer_tpu_torch --backend
   pallas`` in-process, against the host f64 ``--backend numpy`` run of
   the same CLI.  Z, the moments and every normalized p(k)/Z >= 1e-6
   must agree at rel 1e-5, and the kernel must have been launched.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Everything is reached through
``genfer_tpu_torch``; nothing here imports jax.

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
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

#: the f32 route's threshold for phase 4, in multiply-adds; set in the
#: environment before the port's backend module is imported
OFFLOAD_FLOPS = "1e5"
SIZE = 500
RTOL, ATOL = 5e-5, 1e-6  # f32 kernel against f64
E2E_RTOL = 1e-5  # end-to-end results against the host f64 run
P_MIN = 1e-6  # normalized masses below this are not compared

# (a shape, b shape, out shape): the ragged shapes of the Pallas tests
# (tests/test_parallel_ops.py), two edge shapes of tests/test_conv_block.py
# (a longer than the output; output wider than the full product), the
# largest products the end-to-end run routes (size 500) and the largest
# it would route at size 2000, and dense truncated products at orders
# 256 and 512
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
    ((512, 512), (512, 512), (512, 512)),
]
# the shape whose times go into the kernel table: the largest product
# the end-to-end run sends to the kernel
MAIN_PATH_SHAPE = ((95, 1), (95, 87), (95, 87))


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
    # the f32 plain version is a cuBLAS product: keep it in IEEE f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase2_build() -> None:
    from genfer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s wall, nvcc "
          f"{_build.build_seconds:.3f} s -> {_build.library_path().name}")


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
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


def phase3_kernel() -> dict:
    from genfer_tpu_torch.ops.conv2d import (
        conv2d_trunc_f32,
        conv2d_trunc_f32_reference,
    )
    from genfer_tpu_torch.taylor.backend import _conv_impl

    rng = np.random.default_rng(0)
    worst_abs = 0.0
    main = None
    for sa, sb, out in SHAPES:
        a = rng.random(sa)
        b = rng.random(sb)
        a64 = torch.from_numpy(a).cuda()
        b64 = torch.from_numpy(b).cuda()
        a32, b32 = a64.float(), b64.float()
        want = _conv_impl(a64, b64, out)
        got = conv2d_trunc_f32(a32, b32, out)
        plain = conv2d_trunc_f32_reference(a32, b32, out)
        torch.cuda.synchronize()
        for name, t in (("kernel", got), ("plain", plain)):
            if tuple(t.shape) != out or not bool(torch.isfinite(t).all()):
                fail(f"{name} {sa}x{sb}->{out}: bad shape or non-finite")
            if not torch.allclose(t.double(), want, rtol=RTOL, atol=ATOL):
                err = ((t.double() - want).abs()
                       / (ATOL + RTOL * want.abs())).max().item()
                fail(f"{name} {sa}x{sb}->{out}: off by {err:.3g}x the "
                     f"rtol {RTOL} / atol {ATOL} bar against f64")
        abs_err = (got.double() - want).abs().max().item()
        rel_err = ((got.double() - want).abs()
                   / want.abs().clamp_min(ATOL)).max().item()
        worst_abs = max(worst_abs, abs_err)
        reps = 20 if max(out) >= 256 else 200
        ms = _time_ms(lambda: conv2d_trunc_f32(a32, b32, out), reps)
        plain_ms = _time_ms(
            lambda: conv2d_trunc_f32_reference(a32, b32, out), reps
        )
        print(f"phase 3 {sa}x{sb}->{out}: max abs err {abs_err:.3e}, "
              f"max rel err {rel_err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if (sa, sb, out) == MAIN_PATH_SHAPE:
            main = (ms, plain_ms)
    return {"max_abs_err": worst_abs, "ms": main[0], "plain_ms": main[1]}


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


def phase4_end_to_end() -> int:
    from genfer_tpu_torch import cli
    from genfer_tpu_torch.ops import conv2d
    from genfer_tpu_torch.taylor.backend import PallasBackend
    from genfer_tpu_torch.tools.generators import generate_two_populations

    if PallasBackend.PALLAS_OFFLOAD_FLOPS != int(float(OFFLOAD_FLOPS)):
        fail(f"PallasBackend routes at {PallasBackend.PALLAS_OFFLOAD_FLOPS} "
             f"multiply-adds, not {OFFLOAD_FLOPS}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"two_populations_{SIZE}.sgcl"
        generate_two_populations(path, SIZE, seed=0)
        flags = [str(path), "--no-timing", "--backend"]
        conv2d.launches = 0
        port_out, port_s = _capture(cli.main, flags + ["pallas"])
        launches = conv2d.launches
        host_out, host_s = _capture(cli.main, flags + ["numpy"])
    if launches < 1:
        fail("the end-to-end run never launched conv2d_trunc_f32")
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
    print(f"phase 4 two_populations({SIZE}) --backend pallas: launches "
          f"{launches}, {compared} results within rel {E2E_RTOL} of host "
          f"f64 (max rel dev {worst:.3e}; tail bounds not compared: they "
          f"are differences of nearly equal sums), port {port_s:.3f} s, "
          f"host {host_s:.3f} s wall")
    if "jax" in sys.modules:
        fail("jax was imported")
    return launches


def main() -> None:
    # routing only: phase 4's f32 route takes 2-axis products of at least
    # OFFLOAD_FLOPS multiply-adds (the backend reads it at import)
    os.environ["GENFER_PALLAS_OFFLOAD_FLOPS"] = OFFLOAD_FLOPS
    phase1_card()
    phase2_build()
    times = phase3_kernel()
    launches = phase4_end_to_end()
    kernel = {
        "name": "conv2d_trunc_f32",
        "route": "cuda",
        "source": "genfer_tpu_torch/csrc/conv2d_trunc_f32.cu",
        "replaces": "genfer_tpu/ops/pallas_conv2d.py:189",
        "launches": launches,
        **times,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
