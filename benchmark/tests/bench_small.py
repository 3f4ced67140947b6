"""Cells of the benchmark at sizes a CPU test run holds: the same
configuration and traffic files, with a smaller batch and pool, and the
digit model at 20 pixels a class."""

from __future__ import annotations

import time

import torch

from benchmark.harness import cell as cells
from benchmark.harness import spec

DIGIT_PIXELS = 20


def config(name: str) -> dict:
    bench = spec.benchmark()
    cfg = spec.config(bench, name)
    if name == "digit_recognition":
        from genfer_tpu_torch.tools.generators import digit_serving_source

        src, params = digit_serving_source(DIGIT_PIXELS)
        cfg = dict(cfg, program=src, params=params,
                   model=dict(cfg["model"], pixels=DIGIT_PIXELS))
    return cfg


def cell(workload: str, batch: int = 8) -> cells.Cell:
    bench = spec.benchmark()
    c = spec.cell(bench, workload)
    traffic = dict(spec.traffic(c["traffic"]), batch=batch, pool=3,
                   warmup=1, check_batches=4)
    return cells.Cell(workload, bench, config(c["config"]), traffic)


def run(workload: str, seed: int = 2**31 + 7, seconds: float = 0.3,
        trace: bool = False, batch: int = 8) -> dict:
    c = cell(workload, batch)
    return cells.run(c, seed, seconds, trace, torch.device("cpu"), torch,
                     time.perf_counter(), log=lambda msg: None)
