"""genfer's two_populations program with survival and detection as
parameters (``tools.generators.two_populations_serving``), served by
``compile.CompiledProgram`` on the CPU, against the benchmark's plain
reference in value space (``benchmark/reference/two_populations_2000.py``).

Both sides compute in f64; a row's largest gap over its largest mass is
held to ``RTOL``.  The reference in float32 misses that, so the comparison
catches a lower precision.  The reference's grid is checked by doubling
it, and the reference loads nothing of the port.  The file imports no
JAX; ``tests/test_torch_compile.py`` holds the same program to the JAX
package."""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from genfer_tpu_torch import trace
from genfer_tpu_torch.compile import CompiledProgram, TracedF64Backend
from genfer_tpu_torch.taylor.host import Backend
from genfer_tpu_torch.tools.generators import (
    generate_two_populations,
    two_populations_serving,
)

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "benchmark" / "reference" / "two_populations_2000.py"
R = spec.module("reference", "two_populations_2000")
PARAMS = ["s1", "s2", "det"]
#: (size, seed of the generator's counts, limit): seed 0 as published,
#: seed 4 for counts of 2 to 5
CASES = [(50, 0, 40), (50, 4, 40)]
#: a row's largest gap over its largest mass, port against reference
RTOL = 1e-12


def _points(seed, n=8):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0.1, 0.4, (n, 3)), dtype=torch.float64)


def _rel_err(got, want):
    gap = (got - want).abs().amax(dim=1) / want.abs().amax(dim=1)
    return gap.max().item()


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"size{c[0]}"
                f"_seed{c[1]}")
def served(request):
    size, seed, limit = request.param
    source, model = two_populations_serving(size, seed)
    program = CompiledProgram(source, PARAMS, limit, device="cpu")
    params = _points(1000 + seed)
    with trace.recording() as rec:
        got = program.probs_batch(params)
    return model, limit, params, got, program, rec


def test_port_matches_the_reference(served):
    model, limit, params, got, *_ = served
    want = R.masses(params, model, limit)
    assert got.shape == want.shape == (8, limit)
    assert (want[:, 0] > 0).all()
    assert _rel_err(got, want) < RTOL


def test_the_float32_reference_misses_the_tolerance(served):
    model, limit, params, got, *_ = served
    low = R.masses(params, model, limit, dtype=torch.float32)
    assert low.dtype == torch.float32
    assert _rel_err(low.double(), got) > 100 * RTOL


def test_the_fused_sums_give_the_op_by_op_bits(served, monkeypatch):
    """The walk's sums in ``ops.lincomb_f64`` (its plain version here)
    against ``Backend.lincomb``'s op-by-op default on the same backend."""
    _, _, params, got, program, rec = served
    for site in ("add", "mul_linear"):
        assert rec.count("walk.lincombs_fused", site=site, phase="eager") > 0
    monkeypatch.setattr(TracedF64Backend, "lincomb", Backend.lincomb)
    plain = program.probs_batch(params)
    assert torch.equal(got.view(torch.int64), plain.view(torch.int64))


@pytest.mark.parametrize("size,seed", [(50, 4), (200, 0)])
def test_doubling_the_grid_moves_nothing(size, seed):
    _, model = two_populations_serving(size, seed)
    corners = torch.tensor([[0.1, 0.1, 0.1], [0.4, 0.4, 0.1],
                            [0.4, 0.4, 0.4], [0.1, 0.4, 0.25]],
                           dtype=torch.float64)
    n1, n2 = R.grid(model)
    base = R.masses(corners, model, n2)
    wide = R.masses(corners, model, n2, bounds=(2 * n1, 2 * n2))
    assert _rel_err(base, wide) < 1e-15
    lost = (wide.sum(dim=1) - base.sum(dim=1)) / wide.sum(dim=1)
    assert (lost.abs() < 1e-15).all()


def test_blocks_of_rows_give_the_same_bits(monkeypatch):
    _, model = two_populations_serving(50, 4)
    params = _points(7, n=5)
    whole = R.masses(params, model, 30)
    monkeypatch.setattr(R, "BLOCK", 2)
    assert torch.equal(R.masses(params, model, 30), whole)


def test_pmf_pieces():
    dt = torch.float64
    for rate in (0.3, 7.5, 209.34):
        pmf = R.poisson_pmf(rate, 600, dt, "cpu")
        k = torch.arange(600, dtype=dt)
        direct = torch.exp(k * np.log(rate) - rate - torch.lgamma(k + 1))
        assert torch.allclose(pmf, direct, rtol=1e-12, atol=0)
        assert pmf.sum().item() == pytest.approx(1.0, rel=1e-14)
    p = torch.tensor([0.1, 0.37], dtype=dt)
    t = R.binomial_table(p, 30, 12)
    j, i = 17, 5
    for r in range(2):
        want = (float(math.comb(j, i)) * p[r].item() ** i
                * (1 - p[r].item()) ** (j - i))
        assert t[r, j, i].item() == pytest.approx(want, rel=1e-14)
    assert torch.allclose(R.binomial_table(p, 30, 31).sum(dim=2),
                          torch.ones(2, 30, dtype=dt), rtol=1e-14)


def test_the_serving_source_is_the_generated_program():
    """Three parameters in place of the published probabilities, every
    other constant as generated; the benchmark's program is size 2000."""
    for size, seed in ((50, 0), (2000, 0)):
        source, model = two_populations_serving(size, seed)
        published = generate_two_populations(None, size, seed)
        assert source.replace("$s1", "0.23724").replace(
            "$s2", "0.2636").replace("$det", "0.2") == published
        assert source.count("$det") == 8 and source.count("$s1") == 4
        assert len(model["observed"]) == len(model["arrival_rates"]) == 4
    committed = ROOT / "benchmark" / "configs" / "two_populations_2000.sgcl"
    assert committed.read_text() == two_populations_serving(2000)[0]


def test_the_reference_loads_no_walk_and_no_tf32():
    """The reference imports nothing of the port (nor of the benchmark's
    harness, nor JAX) and turns TF32 off."""
    code = (
        "import runpy, sys, torch\n"
        f"runpy.run_path({str(REFERENCE)!r})\n"
        "print(sorted(m for m in sys.modules if m.startswith(("
        "'jax', 'genfer_tpu', 'benchmark'))))\n"
        "print(torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    mods, flags = out.strip().splitlines()
    assert mods == "[]"
    assert flags == "False False"
