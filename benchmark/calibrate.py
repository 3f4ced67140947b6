"""Readings that the limits of a cell's check are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 3]

In one process: the program translated and captured once, then for each
seed the seed's data and pool, a short window at the cell's own load and
batch size (the same answers a run samples), and the cell's compared
numbers for the program and for the control (the plain reference in
float32 put in the program's place).  One JSON line a seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import check

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.Cell(args.workload)
    driver = cell.driver_mod.Driver(cell.config, device)
    worst, least = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        data, pool, rng = cells.prepare(cell, seed)
        client = cell.client_mod.Client(cell.config, data, device)
        for j in range(cell.traffic["warmup"] + 1):
            cells.serve_batch(driver, client, pool[j % len(pool)])
        reservoir = check.Reservoir(cell.traffic["check_batches"], rng)
        lat, _ = cells.window(driver, client, pool, args.seconds, reservoir)
        ok, table = check.judge(cell.reference, cell.config, data,
                                reservoir.items, pool)
        ctl = check.control(cell.reference, cell.config, data,
                            reservoir.items, pool)
        row = {"seed": seed, "batches": len(lat), "correct": ok,
               "program": {k: v for k, (v, _) in table.items()},
               "control": ctl}
        print(json.dumps(row), flush=True)
        for k, (v, _) in table.items():
            worst[k] = max(worst.get(k, 0.0), v)
        for k, v in ctl.items():
            least[k] = min(least.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload,
                      "program_largest": worst, "control_smallest": least,
                      "limits": {k: c["limit"]
                                 for k, c in cell.config["check"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
