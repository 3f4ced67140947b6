"""Benchmark of the port's f32 kernels on one CUDA card: the twin of the
``--pallas`` sections of genfer_tpu's ``bench.py``.

    python -m genfer_tpu_torch.bench --pallas [--seed N]

Sections, at the JAX bench's own sizes:

* ``pallas_kernel``: the row-strip kernel's twin ``conv2d_trunc_f32`` at
  orders 256 and 512, with its max relative error against the f64
  product;
* ``pallas_batched``: ``conv2d_trunc_f32_batched`` at 256 x B32 and
  512 x B8; entry 0 must equal the single-pair kernel bit for bit;
* ``pallas_rowstrip``: the row-strip twin against the tile
  (``conv2d_trunc_f32_tile``) and grouped (``conv2d_trunc_f32_grouped``)
  kernels at orders 256, 384 and 512.  On the card the row-strip twin
  splits j0 over blocks at these orders and the tile kernel does not, so
  the two agree to f32 rounding, not bit for bit as on the TPU.

Operands are uniform in [0, 1), drawn from ``--seed`` with a numpy
generator.  Times come from CUDA events over back-to-back calls after a
synchronize.  Every section carries the card's name and power limit from
``nvidia-smi``, and each kernel's bound: the least time the card could
take for the same work (``bound_ms``) and the measured time's share of it
(``bound_share``), in place of the JAX bench's ``issue_util`` / ``mfu``,
which used the TPU's ceiling.  A failed check raises.  The results are
printed as one JSON line and written to ``build/bench-results-torch.json``.

The other sections and the f64 headline of genfer_tpu's bench are not
ported yet; asking for one raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import subprocess
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

#: genfer_tpu bench options this twin does not run yet -> ROADMAP item
UNPORTED = {
    "suite": "Queue 1 item 3 (bench twin; end-to-end suite)",
    "scaling": "Queue 1 item 3 (bench twin; needs K1 and TorchF64Backend, "
               "Queue 1 item 1)",
    "serving": "Queue 1 items 8 and 10 (compile.py, scanc.py)",
    "scan": "Queue 1 items 9 and 10 (models/, scanc.py)",
    "highorder": "Queue 1 item 11 (ops/blocked_conv.py)",
    "ozaki": "Queue 2 K5 (ozaki route)",
    "nested": "Queue 1 item 3 (bench twin)",
    "all": "Queue 1 item 3 (bench twin; every section)",
}
HEADLINE = ("Queue 1 item 3 (bench twin): the f64 headline bench_kernel and "
            "bench_host_kernel need K1 and TorchF64Backend (Queue 1 item 1)")


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def bound_ms(macs: float, nbytes: float) -> tuple[float, str]:
    """The least time one H100 could take for ``macs`` f32 multiply-adds
    that read and write ``nbytes`` (each input read once, each output
    written once), and which of the two bounds it."""
    ops_ms = macs / F32_FMA_PER_S * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (
        bytes_ms, "bytes")


def product_bound(a_shape, b_shape, out_shape,
                  batch: int = 1) -> tuple[float, str]:
    """``bound_ms`` of ``batch`` truncated products of f32 operands (one
    operand of each pair batched, the other shared)."""
    macs = batch * _conv_pair_flops(tuple(a_shape), tuple(b_shape),
                                    tuple(out_shape))
    n = (np.prod(a_shape) * batch + np.prod(b_shape)
         + np.prod(out_shape) * batch)
    return bound_ms(macs, 4.0 * n)


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
    from .ops import conv2d_trunc_f32
    from .taylor.backend import _conv_impl

    shape = (order, order)
    a, b = rng.random(shape), rng.random(shape)
    a64, b64 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    a32, b32 = a64.float(), b64.float()
    rel = _max_rel(conv2d_trunc_f32(a32, b32, shape),
                   _conv_impl(a64, b64, shape))
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
    to f32 rounding here (the twin splits j0 over blocks), and the grouped
    one matches the tile kernel to f32 rounding, as on the TPU."""
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
    return {"ms": dt["strip"], "gflops": flops / dt["strip"] / 1e6,
            "tile_ms": dt["tile"],
            "speedup_vs_tile": dt["tile"] / dt["strip"],
            "grouped_ms": dt["grouped"],
            "grouped_gflops": flops / dt["grouped"] / 1e6,
            "tile_err": tile_err, "grouped_err": grouped_err,
            "bound_ms": bound, "bound_share": bound / dt["strip"],
            "tile_bound_share": bound / dt["tile"],
            "grouped_bound_share": bound / dt["grouped"], "card": where}


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


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m genfer_tpu_torch.bench")
    ap.add_argument("--pallas", action="store_true",
                    help="the f32 kernel sections (the only ones ported)")
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
    if not args.pallas:
        raise NotImplementedError(f"not ported yet: ROADMAP {HEADLINE}; "
                                  "run with --pallas")
    results = run_pallas(args.seed)
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    RESULTS.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
