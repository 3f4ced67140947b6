"""Run one cell of the benchmark of genfer_tpu_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic; ``harness/cell.py`` sets up, measures and
checks.  The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and window seconds and the
breakdown.  The numbers compared to decide ``correct`` are the last lines
of standard error and the last key of that object.

The run exits with a code other than 0 and prints no result when no card
is there (or fewer than the cell asks for), and when JAX or the JAX
package (``jax``, ``jaxlib``, ``flax``, ``genfer_tpu``; top-level names
compared whole) is loaded once the window has closed.  Kernel builds and
caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (from
    ``/proc``; where that cannot be read, now)."""
    now = time.perf_counter()
    try:
        stat = Path("/proc/self/stat").read_text()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import guard, spec

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    bench = spec.benchmark()
    wanted = spec.cell(bench, args.workload)["chips"]
    have = guard.card_count(torch)
    if have < wanted:
        log(f"error: the cell needs {wanted} CUDA card(s); torch sees {have}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = cells.Cell(args.workload, bench)
    result = cells.run(cell, args.seed, args.seconds, bool(args.trace),
                       device, torch, started, log)
    bad = guard.forbidden_loaded()
    if bad:
        log(f"error: the run loaded {', '.join(bad)}")
        return 3
    for line in cells.fmt_checks(result["checks"]):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
