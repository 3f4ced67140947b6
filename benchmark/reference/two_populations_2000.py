"""Plain reference of genfer's two-species population program
(``generate_two_populations.rs`` at size 2000) with the survival and
detection probabilities as the parameters ``$s1``, ``$s2`` and ``$det``.
It imports nothing of the port, so that a change to the program cannot
move it; the port's CPU tests hold the port to it at small sizes.

It carries the joint distribution of (population1, population2) in value
space on a truncated grid through the four rounds (Poisson pmf vectors
for the arrivals, matrices of binomial pmfs of each row's own parameters
for the thinnings and the migration, likelihood rows for the
observations) and gives the unnormalized masses p(population2 = k,
observations), k < limit.  Plain torch, on the card where there is one,
in the dtype it is given, TF32 off.  The compared number is the worst, over
the sampled rows, of the largest gap of a row against the row's largest
reference mass.  The masses span about 1e-20 to 1e-64 over the traffic's
box [0.1, 0.4]^3, mostly below float32's range: the float32 control
underflows to zeros there and reads 1.0; where they fit, it reads 2e-5
to 7e-5.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: a grid axis ends this many standard deviations past the largest mean
#: the population can have (survival 1)
TAIL_SDS = 12
#: rows carried at once
BLOCK = 32
#: rows of the migration's Toeplitz matrices made at once
MIGRATION_CHUNK = 64


def grid(model) -> tuple[int, int]:
    """Grid sizes (n1, n2): each population's largest possible mean (every
    survival 1) plus ``TAIL_SDS`` standard deviations plus ``TAIL_SDS``;
    the mass left outside is far below 1e-15 of the total over any
    survival and detection (the port's tests double the grid)."""
    m1, m2 = (float(x) for x in model["init_rates"])
    for a1, a2 in model["arrival_rates"]:
        m2 += model["migration"] * m1 + a2
        m1 += a1
    return tuple(int(math.ceil(m + TAIL_SDS * math.sqrt(m) + TAIL_SDS))
                 for m in (m1, m2))


def poisson_pmf(rate: float, n: int, dtype, device) -> torch.Tensor:
    """Poisson(rate) masses of 0..n-1: the mass at the mode m = floor(rate)
    from Stirling's series (no large terms that cancel), the rest by the
    ratios m -> m + 1 (rate / (m + 1)) and m -> m - 1 (m / rate)."""
    m = min(int(math.floor(rate)), n - 1)
    rate_t = torch.tensor(rate, dtype=dtype, device=device)
    if m < 30:
        log_mode = (m * torch.log(rate_t) - rate_t
                    - math.lgamma(m + 1)) if m else -rate_t
    else:
        mt = torch.tensor(float(m), dtype=dtype, device=device)
        d = rate_t - mt
        log_mode = (mt * torch.log1p(d / mt) - d
                    - 0.5 * torch.log(2 * math.pi * mt)
                    - (1 / (12 * mt) - 1 / (360 * mt ** 3)
                       + 1 / (1260 * mt ** 5)))
    mode = torch.exp(log_mode).reshape(1)
    k = torch.arange(n, dtype=dtype, device=device)
    up = torch.cumprod(rate_t / k[m + 1:], 0) * mode
    down = torch.flip(torch.cumprod(torch.flip(k[1:m + 1], [0]) / rate_t, 0),
                      [0]) * mode
    return torch.cat([down, mode, up])


def binomial_table(p: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``t[r, j, i] = C(j, i) p_r^i (1 - p_r)^(j - i)``, j < n, i < k, by
    Pascal's rule (each entry a sum of two nonnegative terms)."""
    rows = p.shape[0]
    q = (1 - p)[:, None]
    out = p.new_zeros((rows, n, k))
    row = p.new_zeros((rows, k))
    row[:, 0] = 1
    for j in range(n):
        out[:, j] = row
        nxt = row * q
        nxt[:, 1:] += row[:, :-1] * p[:, None]
        row = nxt
    return out


def _toeplitz_lower(pmf: torch.Tensor, n: int) -> torch.Tensor:
    """``L[k, j] = pmf[k - j]`` (0 where k < j): adding an independent
    count with masses ``pmf`` to the one indexed by j."""
    idx = torch.arange(n, device=pmf.device)
    diff = idx[:, None] - idx[None, :]
    return torch.where(diff >= 0, pmf[diff.clamp(min=0)],
                       pmf.new_zeros(()))


def _migrate(P: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """population2 += Binomial(population1, m): ``out[r, j, q] = sum_i P[r,
    j, i] M[j, q - i]``, a Toeplitz matrix of ``M``'s row a value j of
    population1."""
    n1, n2 = P.shape[1:]
    idx = torch.arange(n2, device=P.device)
    diff = idx[None, :] - idx[:, None]  # [i, q] -> q - i
    mask = diff >= 0
    out = torch.empty_like(P)
    for lo in range(0, n1, MIGRATION_CHUNK):
        hi = min(lo + MIGRATION_CHUNK, n1)
        T = torch.where(mask, M[lo:hi][:, diff.clamp(min=0)],
                        M.new_zeros(()))  # [j, i, q]
        out[:, lo:hi] = torch.einsum("rji,jiq->rjq", P[:, lo:hi], T)
    return out


def _block(params: torch.Tensor, model, limit: int, n1: int, n2: int,
           pois, mig) -> torch.Tensor:
    s1, s2, det = params[:, 0], params[:, 1], params[:, 2]
    observed = model["observed"]
    c1 = max(c for c, _ in observed) + 1
    c2 = max(c for _, c in observed) + 1
    B1 = binomial_table(s1, n1, n1).transpose(1, 2)  # [r, k, j]
    B2 = binomial_table(s2, n2, n2)  # [r, j, k]
    D1 = binomial_table(det, n1, c1)
    D2 = binomial_table(det, n2, c2)
    P = (pois[0][0][:, None] * pois[0][1][None, :]).expand(
        params.shape[0], n1, n2)
    for (L1, L2), (o1, o2) in zip(pois[1:], observed):
        P = _migrate(P, mig)
        P = B1 @ P
        P = P @ B2
        P = L1 @ P
        P = P @ L2.T
        P = P * D1[:, :, o1, None] * D2[:, None, :, o2]
    return P.sum(dim=1)[:, :limit]


def masses(params, model, limit: int, dtype=torch.float64, device="cpu",
           bounds=None) -> torch.Tensor:
    """(rows, limit) unnormalized masses of population2 a row of
    ``params`` (s1, s2, det), computed in ``dtype`` on ``device`` on the
    grid ``bounds`` (default ``grid(model)``), ``BLOCK`` rows at once."""
    n1, n2 = bounds or grid(model)
    params = torch.as_tensor(params).to(dtype=dtype, device=device)
    rates = [model["init_rates"]] + list(model["arrival_rates"])
    vecs = [(poisson_pmf(float(r1), n1, dtype, device),
             poisson_pmf(float(r2), n2, dtype, device)) for r1, r2 in rates]
    pois = [vecs[0]] + [(_toeplitz_lower(v1, n1), _toeplitz_lower(v2, n2))
                        for v1, v2 in vecs[1:]]
    m = torch.tensor([float(model["migration"])], dtype=dtype, device=device)
    mig = binomial_table(m, n1, n2)[0]
    return torch.cat([_block(params[i:i + BLOCK], model, limit, n1, n2, pois,
                             mig)
                      for i in range(0, params.shape[0], BLOCK)])


_DTYPES = {np.dtype(np.float64): torch.float64,
           np.dtype(np.float32): torch.float32}


def reference(inputs, data, config, dtype):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = masses(inputs["params"], config["model"], config["limit"],
                 dtype=_DTYPES[np.dtype(dtype)], device=device)
    return out.cpu().numpy()


def served(raw):
    return raw


def numbers(got, want) -> dict:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    gap = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    return {"rel_err": float(np.max(np.where(np.isnan(gap), np.inf, gap)))}
