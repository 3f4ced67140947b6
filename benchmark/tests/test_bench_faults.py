"""A run on the CPU with the timed path broken underneath comes out not
correct: an entry that returns its previous answer (its state
unchanged), one that computes half the batch and repeats it for the
rest, and one that alters one answer where it is produced.  The same run
unbroken is correct.  (One card: there is no exchange between cards to
leave out.)"""

import pytest
import torch

import bench_small
from genfer_tpu_torch.compile import CompiledProgram

WORKLOADS = ["scam.grid4096", "digit.b1024"]


def _stale(real):
    last = {}

    def probs_batch(self, params, normalized=False):
        out = real(self, params, normalized)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    return probs_batch


def _half(real):
    def probs_batch(self, params, normalized=False):
        n = params.shape[0]
        half = real(self, params[: n // 2], normalized)
        return torch.cat([half, half[: n - n // 2]])

    return probs_batch


def _altered(real):
    def probs_batch(self, params, normalized=False):
        out = real(self, params, normalized).clone()
        out[0, self.limit // 2] *= 1 + 1e-6
        return out

    return probs_batch


@pytest.mark.parametrize("trace,metrics", [
    (False, {"inferences_per_s", "batch_p95_ms", "setup_s"}),
    # on the CPU no device metric has anything to read
    (True, {"translate_s", "capture_s", "entry_host_ms"})])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_unbroken_run_is_correct(workload, trace, metrics):
    out = bench_small.run(workload, trace=trace)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == metrics


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_entry_is_not_correct(workload, fault, monkeypatch):
    monkeypatch.setattr(CompiledProgram, "probs_batch",
                        fault(CompiledProgram.probs_batch))
    out = bench_small.run(workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
