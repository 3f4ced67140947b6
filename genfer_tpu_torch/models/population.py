"""Scan-compiled population (Poisson-Binomial survey) models: the twins
of genfer_tpu's ``models/population.py``.

The reference's population benchmarks (generated by
src/bin/generate_population_examples.rs) iterate the block

    arrivals   ~ Poisson(lambda_k);
    population ~ Binomial(population, delta);   # survival thinning
    population += arrivals;
    observe c_k ~ Binomial(population, rho);    # noisy count

over many observation rounds.  In the single-variable state-space view the
PGF coefficient vector ``g[n] = P(population = n, observations so far)``
is the (unnormalized) state distribution, and every block statement is a
*linear* operator on it:

* thinning       g <- B^T g     (Pascal matrix B[n,k] = C(n,k) delta^k
                                 (1-delta)^(n-k), one constant matrix)
* + arrivals     g <- g (*) pois(lambda_k)   (truncated 1-D product with
                                 the Poisson pgf series, a Toeplitz
                                 matrix times a vector)
* observe c_k    g[n] *= C(n,c_k) rho^c_k (1-rho)^(n-c_k)  (diagonal
                                 reweighting, the binomial column built by
                                 a cumulative product, so the count is a
                                 runtime value)

so the whole inference is one loop over (lambda_k, c_k): genfer_tpu's
``lax.scan`` becomes a loop over ``max_steps`` (shorter datasets pad with
masked no-op steps), its ``jit(vmap(run))`` a batched run captured as one
CUDA graph (``compile.GraphedEntry``).  The products are plain matrix
products, which XLA ran outside any Pallas kernel; here they are
``torch.matmul``.

Numeric policy, kept from genfer_tpu: the Poisson pgf rows are made on the
host in f64 and fed to the loop as per-step inputs, the carry is rescaled
by a power of two each step (an exact division) with the exponent
accumulated, and the final ``masses = g * 2^logz`` happens on the host.

Truncation matches the reference's: coefficients above the limit are
dropped as its truncated Taylor engine drops them; ``slack`` carries
extra orders.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compile import GraphedEntry
from ..taylor.backend import _resolve_device, _toeplitz


def _pascal_matrix(n: int, delta: float) -> np.ndarray:
    """B[n_row, k_col] = C(n_row, k_col) delta^k (1-delta)^(n-k); the
    thinning map is g_out = B^T g (columns index the surviving count).

    Built by the Pascal recurrence (nonnegative sums only)."""
    B = np.zeros((n, n))
    B[0, 0] = 1.0
    for i in range(1, n):
        B[i, 0] = B[i - 1, 0] * (1.0 - delta)
        B[i, 1:i + 1] = (
            B[i - 1, 1:i + 1] * (1.0 - delta) + B[i - 1, 0:i] * delta
        )
    return B


def _poisson_rows(lams: np.ndarray, n: int) -> np.ndarray:
    """Host-f64 Poisson pgf coefficient rows e^-lam lam^j / j! for each
    rate in ``lams`` (any leading shape), by the stable ratio recurrence
    coef[j+1] = coef[j] * lam / (j+1)."""
    lams = np.asarray(lams, dtype=np.float64)
    out = np.zeros(lams.shape + (n,))
    out[..., 0] = np.exp(-lams)
    for j in range(1, n):
        out[..., j] = out[..., j - 1] * lams / j
    return out


def _obs_weights(ns, c, rho: float):
    """w[n] = C(n, c) rho^c (1-rho)^(n-c) for n >= c, else 0, as one
    cumulative product along n: the step ratio is rho up to n = c
    (building rho^c) and (n/(n-c)) (1-rho) beyond (C(n,c)/C(n-1,c) =
    n/(n-c))."""
    cf = c.to(torch.float64)
    r = torch.where(ns <= cf, rho,
                    ns / torch.clamp(ns - cf, min=1.0) * (1.0 - rho))
    w = torch.cat([torch.ones_like(ns[:1]), torch.cumprod(r[1:], dim=0)])
    return torch.where(ns >= cf, w, 0.0)


def _rescale(g_new, g, logz, valid):
    """The power-of-two rescale of a step's result and the masked carry:
    padding steps (``valid`` false) leave ``(g, logz)`` as they were."""
    m = g_new.max()
    e = torch.where(m > 0, torch.floor(torch.log2(m)), 0.0)
    g_new = g_new / torch.exp2(e)
    return torch.where(valid, g_new, g), torch.where(valid, logz + e, logz)


def _pad_steps(k: int, max_steps: int, *arrays):
    """Each array padded with zeros to ``max_steps`` along its last axis,
    and the valid mask (true for the first ``k`` steps)."""
    if k > max_steps:
        raise ValueError(f"{k} steps, compiled for {max_steps}")
    out = []
    for a in arrays:
        pad = np.zeros(a.shape[:-1] + (max_steps - k,), dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=-1))
    lead = arrays[0].shape[:-1]
    valid = np.concatenate([np.ones(lead + (k,), dtype=bool),
                            np.zeros(lead + (max_steps - k,), dtype=bool)],
                           axis=-1)
    return out, valid


class CompiledPopulation:
    """One-compile, loop-structured inference for the population family.

    Parameters
    ----------
    delta, rho : float
        Survival probability (Binomial thinning) and detection
        probability (Binomial observation) — structural constants of
        the model family.
    limit : int
        Number of posterior masses to return (p(0..limit-1)).
    max_steps : int
        Loop length the program is compiled for; shorter datasets are
        padded with masked no-op steps.
    init_lambda : float | None
        Poisson rate of the initial population; None starts from an
        empty population.
    slack : int
        Extra truncation orders carried beyond ``limit``.
    device : torch device, or None for the CUDA card (which must exist).
    """

    def __init__(self, delta: float, rho: float, limit: int,
                 max_steps: int, init_lambda: float | None = None,
                 slack: int = 64, device=None):
        self.device = _resolve_device(device)
        self.delta = float(delta)
        self.rho = float(rho)
        self.limit = int(limit)
        self.N = int(limit) + int(slack)
        self.max_steps = int(max_steps)
        self.init_lambda = init_lambda
        N = self.N
        dev = self.device
        BT = torch.from_numpy(_pascal_matrix(N, self.delta).T.copy()).to(dev)
        ns = torch.arange(N, dtype=torch.float64, device=dev)
        rho_ = self.rho

        def step(g, logz, pois_row, c, valid):
            g1 = BT @ g                                         # thinning
            g2 = _toeplitz(g1, N, N) @ pois_row                 # + arrivals
            g3 = g2 * _obs_weights(ns, c, rho_)                 # observe
            return _rescale(g3, g, logz, valid)

        def run(g0, pois_rows, cs, valids):
            g, logz = g0, torch.zeros((), dtype=torch.float64, device=dev)
            for t in range(self.max_steps):
                g, logz = step(g, logz, pois_rows[t], cs[t], valids[t])
            return g[: self.limit], logz

        self._run = GraphedEntry(run, dev)
        self._run_batch = GraphedEntry(torch.func.vmap(run), dev)

    # ------------------------------------------------------------------
    def _prepare(self, lams, cs):
        lams = np.asarray(lams, dtype=np.float64)
        cs = np.asarray(cs, dtype=np.int64)
        (lams, cs), valid = _pad_steps(lams.shape[-1], self.max_steps,
                                       lams, cs)
        rows = _poisson_rows(lams, self.N)
        if self.init_lambda is not None:
            g0 = _poisson_rows(np.asarray(self.init_lambda), self.N)
        else:
            g0 = np.zeros(self.N)
            g0[0] = 1.0
        return g0, rows, cs, valid

    def probs(self, lams, cs):
        """Unnormalized posterior masses p(0..limit-1) after observing
        counts ``cs`` with arrival rates ``lams`` (arrays of equal
        length <= max_steps), as a host array."""
        g0, rows, cs, valid = self._prepare(lams, cs)
        g, logz = self._run(g0, rows, cs, valid)
        return g.cpu().numpy() * 2.0 ** float(logz)

    def probs_batch(self, lams, cs):
        """Batched over leading dataset axis: (B, k) rates/counts."""
        g0, rows, cs, valid = self._prepare(lams, cs)
        B = rows.shape[0]
        g0b = np.ascontiguousarray(np.broadcast_to(g0, (B, self.N)))
        g, logz = self._run_batch(g0b, rows, cs, valid)
        return g.cpu().numpy() * (2.0 ** logz.cpu().numpy())[:, None]


def _binom_vec(trials: int, p: float, n: int) -> np.ndarray:
    """The Binomial(trials, p) pmf on 0..n-1 (host f64)."""
    out = np.zeros(n)
    q = 1.0 - p
    w = q ** trials
    for k in range(min(trials, n - 1) + 1):
        out[k] = w
        if k < trials and q > 0:
            w = w * (trials - k) / (k + 1) * (p / q)
    return out


class CompiledTwoPopulations:
    """Loop-compiled two-species population model (reference:
    generate_two_populations.rs).  Per round, on the joint coefficient
    matrix g[n1, n2]:

        population2 +~ Binomial(population1, mig)   # migration
        population1 ~ Binomial(population1, delta1) # Pascal matmul ax0
        population2 ~ Binomial(population2, delta2) # Pascal matmul ax1
        population1 +~ Poisson(lam1_k)              # Toeplitz product ax0
        population2 +~ Poisson(lam2_k)              # Toeplitz product ax1
        observe c1_k ~ Binomial(population1, rho1)  # diag weights ax0
        observe c2_k ~ Binomial(population2, rho2)  # diag weights ax1

    The migration kernel factorizes over pop1 (Binomial(n, p) is the n-fold
    product of Binomial(1, p)), so it runs as the binary decomposition of
    genfer_tpu: one masked Toeplitz product per bit of the pop1 axis.
    Poisson pgf rows are made on the host and the carry is rescaled by
    powers of two (the module docstring's numeric policy).
    ``probs(...)`` returns the unnormalized marginal of the requested
    species (matching ``return population2`` of the generated SGCL)."""

    def __init__(self, delta1: float, delta2: float, mig: float,
                 rho1: float, rho2: float, limit: int, max_steps: int,
                 init_lams=(0.0, 0.0), slack: int = 48,
                 result_var: int = 2, device=None):
        self.device = _resolve_device(device)
        dev = self.device
        self.limit = int(limit)
        N = self.limit + int(slack)
        self.N = N
        self.max_steps = int(max_steps)
        self.result_var = result_var
        self.init_lams = (float(init_lams[0]), float(init_lams[1]))
        B1T = torch.from_numpy(_pascal_matrix(N, float(delta1)).T.copy()).to(
            dev)
        B2 = torch.from_numpy(_pascal_matrix(N, float(delta2))).to(dev)
        mig_ = float(mig)
        bits = max(1, (N - 1).bit_length())
        mig_rows = torch.from_numpy(np.stack([
            _binom_vec(1 << j, mig_, N) for j in range(bits)
        ])).to(dev)
        bit_masks = torch.from_numpy(np.stack([
            ((np.arange(N) >> j) & 1).astype(np.float64)[:, None]
            for j in range(bits)
        ])).to(dev)
        ns = torch.arange(N, dtype=torch.float64, device=dev)
        rho1_, rho2_ = float(rho1), float(rho2)

        def toeplitz(p):
            return _toeplitz(p, N, N)

        def migrate(g):
            # g'[n, m] = sum_k g[n, m-k] Binom(k; n, mig) via the bit
            # decomposition: rows n with bit j set convolve with the
            # Binomial(2^j, mig) pmf along axis 1
            for j in range(bits):
                gK = g @ toeplitz(mig_rows[j]).T
                g = bit_masks[j] * gK + (1.0 - bit_masks[j]) * g
            return g

        def step(g, logz, row1, row2, c1, c2, valid):
            g1 = migrate(g)                           # migration
            g2 = B1T @ g1                             # thin pop1
            g3 = g2 @ B2                              # thin pop2
            g4 = toeplitz(row1) @ g3                  # arrivals pop1
            g5 = g4 @ toeplitz(row2).T                # arrivals pop2
            g6 = (
                g5
                * _obs_weights(ns, c1, rho1_)[:, None]
                * _obs_weights(ns, c2, rho2_)[None, :]
            )
            return _rescale(g6, g, logz, valid)

        def run(g0, rows1, rows2, c1s, c2s, valids):
            g, logz = g0, torch.zeros((), dtype=torch.float64, device=dev)
            for t in range(self.max_steps):
                g, logz = step(g, logz, rows1[t], rows2[t], c1s[t], c2s[t],
                               valids[t])
            axis = 1 if self.result_var == 1 else 0
            return g.sum(dim=axis)[: self.limit], logz

        self._run = GraphedEntry(run, dev)

    def probs(self, lam1s, lam2s, c1s, c2s):
        lam1s = np.asarray(lam1s, dtype=np.float64)
        lam2s = np.asarray(lam2s, dtype=np.float64)
        c1s = np.asarray(c1s, dtype=np.int64)
        c2s = np.asarray(c2s, dtype=np.int64)
        (lam1s, lam2s, c1s, c2s), valid = _pad_steps(
            lam1s.shape[0], self.max_steps, lam1s, lam2s, c1s, c2s)
        rows1 = _poisson_rows(lam1s, self.N)
        rows2 = _poisson_rows(lam2s, self.N)
        g0 = np.outer(
            _poisson_rows(np.asarray(self.init_lams[0]), self.N),
            _poisson_rows(np.asarray(self.init_lams[1]), self.N),
        )
        g, logz = self._run(g0, rows1, rows2, c1s, c2s, valid)
        return g.cpu().numpy() * 2.0 ** float(logz)
