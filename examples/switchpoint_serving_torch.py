"""Switchpoint serving: compile the coal-mining cascade once, serve
fresh observation datasets at millisecond latency (serving demo): the
twin of examples/switchpoint_serving.py on genfer_tpu_torch.

The reference's switchpoint benchmark (benchmarks/neurips2023/approx/
switchpoint, generated by src/bin/generate_switchpoint.rs from the
PyMC coal-mining-disasters dataset) is a 111-branch telescoping
if-cascade: its interpreter run costs seconds per dataset.  The
cascade compiler (genfer_tpu_torch/scanc.py) factorizes it into forward
+ backward cumulative scans over per-unit likelihood rows, so a fresh
dataset only needs new likelihood rows — the compiled scans rerun in
milliseconds (`run_with_counts`).

This demo compiles the committed program via the public library API
(`api.compile_serving` = the CLI's --compile-scan; on the CUDA card by
default, as the port's entry points are), then serves a stream of
perturbed datasets and reports steady-state latency.  The cascade path
is host-numpy by design, as in genfer_tpu (grid-row work is far below
any accelerator's dispatch cost; see CascadeCompiled's docstring).

Usage:  python examples/switchpoint_serving_torch.py [--datasets N]
        [--file F]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SGCL = Path("/root/reference/benchmarks/neurips2023/approx/"
            "switchpoint/switchpoint.sgcl")


def main(argv=None, device=None):
    """Compile, then serve; return the committed dataset's (masses, Z) and
    the served datasets' [(masses, Z)].  ``device``: None (the CUDA card,
    which must exist) or ``"cpu"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", type=int, default=200)
    ap.add_argument("--file", type=Path, default=SGCL)
    args = ap.parse_args(argv)

    from genfer_tpu_torch import api
    from genfer_tpu_torch.scanc import CascadeCompiled

    src = args.file.read_text(encoding="utf-8")
    t0 = time.perf_counter()
    obj = api.compile_serving(src, order=128, device=device)
    masses, Z = obj.run()
    t_compile = time.perf_counter() - t0
    assert isinstance(obj, CascadeCompiled), "expected the cascade path"
    n_units = obj.rep.n_iters
    print(f"compiled + self-validated in {t_compile:.2f}s "
          f"({n_units} observation units); committed dataset "
          f"Z = {Z:.6e}, argmax switchpoint = {int(np.argmax(masses))}")

    # serve perturbed datasets: resampled Poisson counts around the
    # committed ones (what a fresh year-by-year disaster record would
    # look like)
    base = np.asarray(
        [st.recognize_observe().data for st in obj.form.units],
        dtype=np.int64,
    )
    rng = np.random.RandomState(0)
    datasets = rng.poisson(np.maximum(base, 0.5),
                           size=(args.datasets, n_units))
    obj.run_with_counts(datasets[0])  # warm
    t0 = time.perf_counter()
    posts = [obj.run_with_counts(d) for d in datasets]
    dt = time.perf_counter() - t0
    per = dt / args.datasets
    modes = np.asarray([int(np.argmax(m)) for m, _ in posts])
    print(f"served {args.datasets} fresh datasets in {dt:.3f}s "
          f"({per * 1e3:.2f} ms each, {1 / per:.0f} datasets/s); "
          f"posterior switchpoint modes span "
          f"[{modes.min()}, {modes.max()}]")
    return (masses, Z), posts


if __name__ == "__main__":
    main()
