"""Loop-compiled 2-state Poisson HMM and Poisson-mixture families: the
twins of genfer_tpu's ``models/hmm.py`` (reference: generate_hmm.rs /
generate_mixture.rs, benchmarks/neurips2023/approx/{hmm,mixture}).

The generated hmm model unrolls, per observation ``c_t``:

    if State = 0 { observe c_t ~ Poisson(f * Rate1); State ~ Bernoulli(p01); }
    else         { observe c_t ~ Poisson(f * Rate2); State ~ Bernoulli(p11); }

with Geometric priors on the two rates.  The joint posterior state is the
tensor ``g[s, r1, r2]`` (s the hidden state, r_i the latent integer
rates); each round is a *diagonal* likelihood reweighting along the active
rate axis followed by a 2x2 state-transition mix, so the whole observation
sequence is one loop over ``max_steps`` (genfer_tpu's ``lax.scan``),
captured on the card as one CUDA graph (``compile.GraphedEntry``).

The mixture model (coal-mining disasters, 109 observations) is the same
family without the hidden state: each observation reweights the joint rate
grid by ``q pmf(c; f r1) + (1-q) pmf(c; f r2)``.

Numeric policy, kept from genfer_tpu: the Poisson pmf tables are made on
the host in f64 (indexed by the runtime counts on the device), the carry
is rescaled by a power of two each step with the exponent accumulated, and
the final ``marginal * 2^logz`` happens on the host.

Truncation: Geometric rates are truncated at ``n_rates`` (tail mass
0.9^N; the reference truncates the same tail at its Taylor evaluation
degree).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compile import GraphedEntry
from ..taylor.backend import _resolve_device
from .population import _pad_steps, _rescale


def _geometric(p: float, n: int) -> np.ndarray:
    rs = np.arange(n, dtype=np.float64)
    return p * (1.0 - p) ** rs


def _poisson_pmf_table(factor: float, n_rates: int,
                       max_count: int) -> np.ndarray:
    """W[c, r] = e^{-f r} (f r)^c / c!  computed on the host in real
    f64 by the stable ratio recurrence W[c] = W[c-1] * (f r) / c."""
    lam = factor * np.arange(n_rates, dtype=np.float64)
    W = np.zeros((max_count + 1, n_rates))
    W[0] = np.exp(-lam)
    for c in range(1, max_count + 1):
        W[c] = W[c - 1] * lam / c
    return W


def _row(table, c):
    """``table[c]`` for a 0-d count tensor ``c``, read on the device (an
    index by a 0-d tensor reads it on the host, which a CUDA graph's
    capture refuses)."""
    return torch.index_select(table, 0, c.reshape(1))[0]


def _counts(counts, max_count: int, max_steps: int):
    """The counts padded to ``max_steps`` and their valid mask."""
    cs = np.asarray(counts, dtype=np.int64)
    if cs.max(initial=0) > max_count:
        raise ValueError(f"a count above max_count = {max_count}")
    (cs,), valid = _pad_steps(cs.shape[0], max_steps, cs)
    return cs, valid


class CompiledHMM:
    """One-compile loop inference for the 2-state Poisson HMM family.

    Parameters mirror the generated model: ``geo_p`` the Geometric prior
    parameter of both rates, ``factor`` the Poisson rate multiplier,
    ``trans = (p01, p11)`` the probability that the next state is 1
    given the current state, ``init_state`` the deterministic initial
    state.  ``max_count`` bounds the observable counts (table size).
    ``device``: a torch device, or None for the CUDA card.
    """

    def __init__(self, geo_p: float = 0.1, factor: float = 0.1,
                 trans=(0.2, 0.8), init_state: int = 1,
                 n_rates: int = 256, max_steps: int = 32,
                 result: str = "rate2", limit: int | None = None,
                 max_count: int = 64, device=None):
        self.device = _resolve_device(device)
        dev = self.device
        self.n_rates = int(n_rates)
        self.max_steps = int(max_steps)
        self.max_count = int(max_count)
        N = self.n_rates
        geo = _geometric(geo_p, N)
        Wt = torch.from_numpy(
            _poisson_pmf_table(factor, N, self.max_count)).to(dev)
        p01, p11 = float(trans[0]), float(trans[1])
        self.result = result
        self.limit = int(limit) if limit is not None else N
        lim = self.limit
        init_prior = np.outer(geo, geo)

        def step(g, logz, c, valid):
            # scaled forward recursion: each step renormalizes by a power
            # of two near its max and accumulates the exponent
            w = _row(Wt, c)
            g0 = g[0] * w[:, None]      # state 0 observes via Rate1
            g1 = g[1] * w[None, :]      # state 1 observes via Rate2
            new0 = (1.0 - p01) * g0 + (1.0 - p11) * g1
            new1 = p01 * g0 + p11 * g1
            return _rescale(torch.stack([new0, new1]), g, logz, valid)

        def run(g0, cs, valids):
            g, logz = g0, torch.zeros((), dtype=torch.float64, device=dev)
            for t in range(self.max_steps):
                g, logz = step(g, logz, cs[t], valids[t])
            # return-variable marginal (the benchmark returns Rate2)
            if result == "state":
                marg = g.sum(dim=(1, 2))
            elif result == "rate1":
                marg = g.sum(dim=(0, 2))[:lim]
            else:
                marg = g.sum(dim=(0, 1))[:lim]
            return marg, logz

        self._run = GraphedEntry(run, dev, "run")
        self._g0 = np.zeros((2, N, N))
        self._g0[int(init_state)] = init_prior

    def probs(self, counts):
        """Unnormalized posterior masses of the result variable after
        the observation sequence ``counts``, as a host array."""
        cs, valid = _counts(counts, self.max_count, self.max_steps)
        marg, logz = self._run(self._g0, cs, valid)
        return marg.cpu().numpy() * 2.0 ** float(logz)


class CompiledMixture:
    """Loop-compiled 50/50 Poisson mixture over two latent Geometric
    rates (reference: generate_mixture.rs, the coal-mining-disasters
    benchmark).  On the joint rate grid ``g[r1, r2]`` each observation
    is the diagonal reweighting
    ``q * pmf(c; f r1) + (1-q) * pmf(c; f r2)``.
    ``device``: a torch device, or None for the CUDA card."""

    def __init__(self, geo_p: float = 0.1, factor: float = 0.1,
                 q: float = 0.5, n_rates: int = 256,
                 max_steps: int = 128, result: str = "rate1",
                 limit: int | None = None, max_count: int = 64,
                 device=None):
        self.device = _resolve_device(device)
        dev = self.device
        self.n_rates = int(n_rates)
        self.max_steps = int(max_steps)
        self.max_count = int(max_count)
        N = self.n_rates
        geo = _geometric(geo_p, N)
        Wt = torch.from_numpy(
            _poisson_pmf_table(factor, N, self.max_count)).to(dev)
        self.limit = int(limit) if limit is not None else N
        lim = self.limit
        q_ = float(q)

        def step(g, logz, c, valid):
            # scaled forward recursion (see CompiledHMM.step)
            w = _row(Wt, c)
            gn = g * (q_ * w[:, None] + (1.0 - q_) * w[None, :])
            return _rescale(gn, g, logz, valid)

        def run(g0, cs, valids):
            g, logz = g0, torch.zeros((), dtype=torch.float64, device=dev)
            for t in range(self.max_steps):
                g, logz = step(g, logz, cs[t], valids[t])
            axis = 1 if result == "rate1" else 0
            return g.sum(dim=axis)[:lim], logz

        self._run = GraphedEntry(run, dev, "run")
        self._g0 = np.outer(geo, geo)

    def probs(self, counts):
        """Unnormalized posterior masses of the result rate, as a host
        array."""
        cs, valid = _counts(counts, self.max_count, self.max_steps)
        marg, logz = self._run(self._g0, cs, valid)
        return marg.cpu().numpy() * 2.0 ** float(logz)
