"""Plain reference of genfer's ``example.sgcl`` with the scam probability
as the parameter ``$p``:

    calls ~ Poisson(rate); scams ~ Binomial(calls, $p);
    observe(scams = observed); return calls;

The served answer is the unnormalized masses, for k < limit,

    p(calls = k, scams = s) = Poisson(k; rate) C(k, s) p^s (1 - p)^(k - s),

zero for k < s.  Computed in closed form in ``dtype`` throughout (the
Poisson masses by their recurrence), independent of the program.  The
compared number is the worst, over the sampled rows, of the largest gap
of a row against the row's largest reference mass.
"""

from __future__ import annotations

import math

import numpy as np


def reference(inputs, data, config, dtype):
    model, limit = config["model"], config["limit"]
    rate, s = dtype(model["calls_rate"]), model["scams_observed"]
    pois = np.empty(limit, dtype=dtype)
    pois[0] = np.exp(-rate)
    for k in range(1, limit):
        pois[k] = pois[k - 1] * rate / dtype(k)
    k = np.arange(limit)
    choose = np.array([math.comb(int(j), s) for j in k], dtype=dtype)
    p = inputs["params"][:, :1].astype(dtype)
    tail = np.where(k >= s, (1 - p) ** np.maximum(k - s, 0).astype(dtype),
                    dtype(0))
    return (pois * choose)[None, :] * p ** dtype(s) * tail


def served(raw):
    return raw


def numbers(got, want) -> dict:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    gap = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    return {"rel_err": float(np.max(np.where(np.isnan(gap), np.inf, gap)))}
