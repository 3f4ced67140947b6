"""The guards of a run: the check for JAX and the JAX package by whole
top-level names, the refusal without a card, and (on the card) a short
run of each cell."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import guard

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    assert guard.forbidden_loaded(["genfer_tpu_torch", "genfer_tpu_torch.x",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["genfer_tpu.compile", "jax.numpy",
                                   "jaxlib", "flax.linen", "torch"]) == [
        "flax", "genfer_tpu", "jax", "jaxlib"]


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench_small\n"
        "out = bench_small.run('scam.grid4096', seconds=0.1)\n"
        "from benchmark.harness import guard\n"
        "print(out['correct'], guard.forbidden_loaded())\n"
        % (str(ROOT), str(Path(__file__).parent)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scam.grid4096",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA card" in res.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["scam.grid4096", "digit.b1024"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert "kernels_per_batch" in out["metrics"]
