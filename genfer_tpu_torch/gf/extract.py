"""Probability-mass and moment extraction from an evaluated GF.

(reference: src/generating_function.rs:937-1086)
"""

from __future__ import annotations

from typing import Sequence


def probs_taylor(pgf, backend, v: int, var_info, max_n: int):
    """p(0..max_n-1): substitute 1 for other discrete vars, 0 for continuous
    vars and the result var; evaluate to order max_n; read coefficients
    (reference: generating_function.rs:937-967)."""
    T = backend.scalar_cls
    assert var_info[v].is_discrete(), (
        "Can only compute probabilities for discrete variables"
    )
    num_vars = var_info.num_vars()
    substs = [
        T.one() if var_info[i].is_discrete() else T.zero() for i in range(num_vars)
    ]
    substs[v] = T.zero()
    expansion = pgf.eval(backend, substs, max_n + 1)
    index = [0] * num_vars
    probs = []
    for i in range(max_n):
        index[v] = i
        probs.append(expansion.coefficient(index))
    return probs


def moments_taylor(pgf, backend, v: int, var_info, limit: int):
    """Total mass + raw moments of orders 1..limit-1
    (reference: generating_function.rs:969-1005)."""
    T = backend.scalar_cls
    num_vars = var_info.num_vars()
    substs = [
        T.one() if var_info[i].is_discrete() else T.zero() for i in range(num_vars)
    ]
    expansion = pgf.eval(backend, substs, limit)
    index = [0] * num_vars
    result = []
    factor = T.one()
    for i in range(limit):
        index[v] = i
        result.append(expansion.coefficient(index) * factor)
        factor = factor * T.from_u32(i + 1)
    if var_info[v].is_discrete():
        return factorial_moments_to_moments(result)
    total = result[0]
    moments = [x / total for x in result[1:]]
    return total, moments


def factorial_moments_to_moments(factorial_moments: Sequence):
    """Stirling-numbers-of-the-2nd-kind transform
    (reference: generating_function.rs:1008-1033)."""
    T = type(factorial_moments[0])
    n = len(factorial_moments)
    stirling = [[T.zero() for _ in range(n)] for _ in range(n)]
    for i in range(n):
        stirling[i][i] = T.one()
        for k in range(1, i):
            stirling[i][k] = stirling[i - 1][k - 1] + T.from_u32(k) * stirling[i - 1][k]
    total = factorial_moments[0]
    moments = [T.zero() for _ in range(n - 1)]
    for i in range(1, n):
        for k in range(i + 1):
            moments[i - 1] = moments[i - 1] + stirling[i][k] * factorial_moments[k]
    moments = [m / total for m in moments]
    return total, moments


def moments_to_central_moments(moments: Sequence):
    """Binomial transform raw -> central moments
    (reference: generating_function.rs:1036-1059)."""
    T = type(moments[0])
    n = len(moments) + 1
    mean = moments[0]
    binom = [[T.zero() for _ in range(n)] for _ in range(n)]
    for i in range(n):
        binom[i][0] = T.one()
        binom[i][i] = T.one()
        for k in range(1, i):
            binom[i][k] = binom[i - 1][k - 1] + binom[i - 1][k]
    neg_mean = -mean
    central = [T.zero() for _ in range(n - 2)]
    for i in range(2, n):
        for k in range(1, i + 1):
            central[i - 2] = central[i - 2] + binom[i][k] * neg_mean.pow_u32(
                i - k
            ) * moments[k - 1]
        central[i - 2] = central[i - 2] + neg_mean.pow_u32(i)
    return mean, central


def central_to_standardized_moments(central_moments: Sequence):
    """(variance, [skewness, kurtosis])
    (reference: generating_function.rs:1064-1086)."""
    variance = central_moments[0]
    sigma = variance.sqrt()
    result = []
    for i, x in enumerate(central_moments[1:]):
        if x.is_zero() and not variance.is_nan() and not variance.is_zero():
            result.append(x)
        else:
            if i % 2 == 0:
                sigma_power = sigma.pow_u32(i + 3)
            else:
                # avoid square roots for rational computations
                sigma_power = variance.pow_u32((i + 3) // 2)
            result.append(x / sigma_power)
    return variance, result
