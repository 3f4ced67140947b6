#!/usr/bin/env python3
"""Where the time of one ``--backend pallas`` or ``--backend jax``
inference goes on a CUDA card.

    python3 profile_port.py [--backend pallas|jax] [--out table.txt]

Builds the port's kernels, writes the end-to-end model of
``chip_smoke.py`` (``generate_two_populations``, seed 0: for ``pallas``
its ``SIZE`` at its ``OFFLOAD_FLOPS``, phase 4's f32 route through K2;
for ``jax`` its ``E2E_SIZE``, phase 8's f64 device path through K1) to a
temporary file and runs it through ``python -m genfer_tpu_torch
--backend ...`` in-process: ``WARM`` times untraced (their wall times
are printed), then once under ``torch.profiler`` with CPU and CUDA
activities. The host f64 ``--backend numpy`` run of the same CLI is
timed twice beside it. Printed: the card's name and power limit, the
untraced walls, the traced wall, the device's busy time and share of it,
each device kernel and copy with its calls and mean microseconds, and
the CUDA runtime calls of the host; for ``jax`` also K1's launches and
device time by body (small, dense, dense_t: ``ops.conv2d_f64._launch``
is wrapped here to record the body of each launch in order, and
``_k1_by_body`` matches the card's events to them). ``--out`` receives
the profiler's full ``key_averages`` table. Nothing here imports jax."""

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

from chip_smoke import E2E_SIZE, OFFLOAD_FLOPS, SIZE

WARM = 5  # untraced runs before the traced one


def _wall(main, argv) -> float:
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv)
    return time.perf_counter() - t0


def _k1_by_body(dev, bodies) -> dict:
    """K1's launches and device microseconds by body, from the card's
    events in stream order: the small body's kernel by its name; the
    dense body's kernel and its f64 slot sum, which ``dense`` and
    ``dense_t`` share, matched in order to ``bodies``, the bodies of the
    traced run's K1 calls in launch order (the transposes of ``dense_t``
    are PyTorch copy kernels, not counted here)."""
    dense = [b for b in bodies if b != "small"]
    us: dict[str, float] = defaultdict(float)
    seen = -1
    for e in sorted(dev, key=lambda e: e.time_range.start):
        if "conv2d_small_f64_kernel" in e.name:
            us["small"] += e.time_range.elapsed_us()
        elif "conv2d_trunc_f64_kernel" in e.name:
            seen += 1
            us[dense[seen]] += e.time_range.elapsed_us()
        elif "sum_units_kernel<double>" in e.name:
            us[dense[seen]] += e.time_range.elapsed_us()
    if seen + 1 != len(dense):
        sys.exit(f"profile_port: {seen + 1} dense kernels on the card for "
                 f"{len(dense)} dense launches")
    return {body: (bodies.count(body), us[body])
            for body in ("small", "dense", "dense_t")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="profile_port")
    ap.add_argument("--backend", choices=["pallas", "jax"],
                    default="pallas", help="the path profiled")
    ap.add_argument("--out", type=Path, default=None,
                    help="file for the profiler's full table")
    args = ap.parse_args(argv)
    # the backend reads the threshold when its module is imported
    os.environ["GENFER_PALLAS_OFFLOAD_FLOPS"] = OFFLOAD_FLOPS

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from genfer_tpu_torch import _build, cli, ops
    from genfer_tpu_torch.ops import conv2d_f64
    from genfer_tpu_torch.tools.generators import generate_two_populations

    if not torch.cuda.is_available():
        sys.exit("profile_port: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    _build.load()

    size, kernel, setting = (
        (SIZE, ops.conv2d_trunc_f32,
         f" at GENFER_PALLAS_OFFLOAD_FLOPS={OFFLOAD_FLOPS}")
        if args.backend == "pallas" else (E2E_SIZE, ops.conv2d_trunc_f64, ""))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"two_populations_{size}.sgcl"
        generate_two_populations(path, size, seed=0)
        flags = [str(path), "--no-timing", "--backend"]
        walls = [_wall(cli.main, flags + [args.backend])
                 for _ in range(WARM)]
        host = [_wall(cli.main, flags + ["numpy"]) for _ in range(2)]
        kernel.launches = 0
        conv2d_f64.reset_launches()
        launch, bodies = conv2d_f64._launch, []

        def named_launch(body, *rest):
            bodies.append(body)
            return launch(body, *rest)

        conv2d_f64._launch = named_launch
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                traced = _wall(cli.main, flags + [args.backend])
                torch.cuda.synchronize()
        finally:
            conv2d_f64._launch = launch
    print(f"two_populations({size}) --backend {args.backend}{setting}: "
          f"untraced wall {', '.join(f'{w:.4f}' for w in walls)} s (first "
          f"run of the process first); host --backend numpy "
          f"{', '.join(f'{w:.4f}' for w in host)} s")

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    print(f"traced wall {traced:.4f} s, {kernel.__name__} launches "
          f"{kernel.launches}; device busy {busy_us / 1e3:.4f} ms = "
          f"{100 * busy_us / 1e6 / traced:.4f}% of the traced wall")
    if args.backend == "jax":
        print("K1 by body: " + ", ".join(
            f"{body} {n} launches, device {us / 1e3:.4f} ms"
            f" ({us / max(n, 1):.3f} us each)"
            for body, (n, us) in _k1_by_body(dev, bodies).items()))
    by_name: dict[str, list[float]] = defaultdict(list)
    for e in dev:
        by_name[e.name].append(e.time_range.elapsed_us())
    for name, us in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        print(f"  device {name}: {len(us)} calls, "
              f"{sum(us) / len(us):.3f} us each")
    host_api: dict[str, list[float]] = defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda"):
            host_api[e.name].append(e.time_range.elapsed_us())
    for name, us in sorted(host_api.items(), key=lambda kv: -sum(kv[1])):
        print(f"  host {name}: {len(us)} calls, {sum(us) / 1e3:.3f} ms")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=-1))
        print(f"full table -> {args.out}")


if __name__ == "__main__":
    main()
