"""The port's loop-compiled models (``genfer_tpu_torch.models``) against
genfer_tpu's scan-compiled ``models``: the same seeded numpy inputs through
both, the JAX package on the CPU, the port with ``device="cpu"``, at rtol
1e-12 (their matrix products and sums add in other orders, ~1e-15 apart),
and against the port's host interpreter on the generated SGCL at the bar of
tests/test_population_scan.py (rel 1e-10).  On the card: a graph replay
equals the eager run bit for bit."""

import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

# genfer_tpu's models import jax when built: the card machine, which has
# no jax, collects this file for its ``cuda`` test
import genfer_tpu.models as J
import genfer_tpu_torch.models as T
from genfer_tpu_torch import cli
from genfer_tpu_torch.tools.generators import (
    population_scan_source,
    two_populations_scan_source,
)

RTOL = 1e-12
DELTA, RHO = 0.2636, 0.2


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=0)


def _cli_probs(src, limit, tmp_path):
    """The port's host interpreter (``--backend numpy``) on ``src``."""
    path = tmp_path / "model.sgcl"
    path.write_text(src)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main([str(path), "--no-timing", "--limit", str(limit),
                  "--backend", "numpy"])
    return {
        int(m.group(1)): float(m.group(2))
        for m in re.finditer(
            r"Unnormalized: p\((\d+)\)\s*=\s*([\d.e+-]+)", buf.getvalue())
    }


def _against_host(got, ref, rel=1e-10):
    assert ref
    for k, v in ref.items():
        if v > 1e-290:
            assert abs(got[k] - v) / v <= rel, (k, got[k], v)


@pytest.mark.parametrize("limit,slack", [(40, 64), (64, 96)])
def test_population(limit, slack, tmp_path):
    init_lam = 1.285
    lams = [5.815, 10.52, 7.52, 2.14]
    cs = [3, 1, 4, 0]
    kw = dict(limit=limit, max_steps=6, init_lambda=init_lam, slack=slack)
    got = T.CompiledPopulation(DELTA, RHO, device="cpu", **kw).probs(
        np.asarray(lams), np.asarray(cs))
    assert got.shape == (limit,)
    _close(got, J.CompiledPopulation(DELTA, RHO, **kw).probs(
        np.asarray(lams), np.asarray(cs)))
    _against_host(got, _cli_probs(
        population_scan_source(init_lam, lams, cs, DELTA, RHO), limit,
        tmp_path))


def test_two_populations(tmp_path):
    d1, d2, mig, rho = 0.23724, 0.2636, 0.1, 0.2
    init = (2.313, 0.257)
    args = ([10.467, 18.936], [1.163, 2.104], [1, 5], [1, 0])
    kw = dict(limit=24, max_steps=3, init_lams=init, slack=72)
    got = T.CompiledTwoPopulations(d1, d2, mig, rho, rho, device="cpu",
                                   **kw).probs(*args)
    _close(got, J.CompiledTwoPopulations(d1, d2, mig, rho, rho, **kw).probs(
        *map(np.asarray, args)))
    _against_host(got, _cli_probs(
        two_populations_scan_source(init, *args, d1, d2, mig, rho), 24,
        tmp_path))


def test_population_padding_and_batch(tmp_path):
    """Shorter datasets pad with masked steps; a batch is one run (one
    graph on the card) and each row matches its own single run."""
    kw = dict(limit=32, max_steps=5, init_lambda=2.0, slack=48)
    cp = T.CompiledPopulation(DELTA, RHO, device="cpu", **kw)
    jp = J.CompiledPopulation(DELTA, RHO, **kw)
    lams2, cs2 = [4.0, 6.0], [2, 1]
    got2 = cp.probs(np.asarray(lams2), np.asarray(cs2))
    _close(got2, jp.probs(np.asarray(lams2), np.asarray(cs2)))
    _against_host(got2, _cli_probs(
        population_scan_source(2.0, lams2, cs2, DELTA, RHO), 32, tmp_path))
    rng = np.random.default_rng(0)
    batch_l = rng.uniform(1.0, 8.0, (3, 3))
    batch_c = rng.poisson(2, (3, 3))
    got_b = cp.probs_batch(batch_l, batch_c)
    assert got_b.shape == (3, 32)
    _close(got_b, jp.probs_batch(batch_l, batch_c))
    for row, (ls, csx) in enumerate(zip(batch_l, batch_c)):
        np.testing.assert_allclose(got_b[row], cp.probs(ls, csx),
                                   rtol=RTOL)


@pytest.mark.parametrize("result", ["rate1", "rate2", "state"])
def test_hmm(result):
    counts = np.random.default_rng(1).poisson(2, 20)
    kw = dict(n_rates=24, max_steps=24, result=result, max_count=16)
    got = T.CompiledHMM(device="cpu", **kw).probs(counts)
    assert np.all(np.isfinite(got)) and got.max() > 0
    _close(got, J.CompiledHMM(**kw).probs(counts))


@pytest.mark.parametrize("result", ["rate1", "rate2"])
def test_mixture(result):
    counts = np.random.default_rng(2).poisson(2, 30)
    kw = dict(n_rates=32, max_steps=32, result=result, limit=20,
              max_count=16)
    got = T.CompiledMixture(device="cpu", **kw).probs(counts)
    assert got.shape == (20,)
    _close(got, J.CompiledMixture(**kw).probs(counts))


def test_counts_out_of_range_raise():
    hmm = T.CompiledHMM(n_rates=8, max_steps=4, max_count=5, device="cpu")
    with pytest.raises(ValueError, match="max_count"):
        hmm.probs([1, 6])
    with pytest.raises(ValueError, match="compiled for 4"):
        hmm.probs([1, 1, 1, 1, 1])


def test_models_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.CompiledPopulation(DELTA, RHO, limit=8, max_steps=2)


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cp = T.CompiledPopulation(DELTA, RHO, limit=64, max_steps=6,
                              init_lambda=2.0, slack=64, device="cuda")
    rng = np.random.default_rng(3)
    bl, bc = rng.uniform(1, 8, (8, 6)), rng.poisson(2, (8, 6))
    g0, rows, cs, valid = cp._prepare(bl, bc)
    g0b = np.ascontiguousarray(np.broadcast_to(g0, (8, cp.N)))
    eager = cp._run_batch.eager(g0b, rows, cs, valid)
    replay = cp._run_batch(g0b, rows, cs, valid)
    for e, r in zip(eager, replay):
        assert torch.equal(e, r)
    cpu = T.CompiledPopulation(DELTA, RHO, limit=64, max_steps=6,
                               init_lambda=2.0, slack=64, device="cpu")
    np.testing.assert_allclose(cp.probs_batch(bl, bc),
                               cpu.probs_batch(bl, bc), rtol=1e-12)
