"""Plain reference of the digitRecognition model (naive Bayes over
``classes`` x ``pixels`` binary pixels, the class prior ``priors``):

    log p(y = c, x) = log prior_c + sum_i log(x_i theta[c, i]
                                               + (1 - x_i)(1 - theta[c, i]))

worked out from the benchmark's own images and theta (never from the
evidence the client folded on the device), in log space so that it
holds in ``dtype`` (the masses lie near 1e-40 to 1e-120, under float32's
range).  The program serves the masses themselves; they are compared
in log space: the compared number is the largest gap, over the sampled
images and every class, between the log of a served mass and the
reference's, which is the mass's relative error.
"""

from __future__ import annotations

import numpy as np


def reference(inputs, data, config, dtype):
    x = inputs["images"].astype(dtype)
    theta = data["theta"].astype(dtype)
    prior = np.log(np.asarray(config["model"]["priors"], dtype=dtype))
    return prior[None, :] + x @ np.log(theta).T + (1 - x) @ np.log1p(-theta).T


def served(raw):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(np.asarray(raw, dtype=np.float64))


def numbers(got, want) -> dict:
    gap = np.abs(np.asarray(got, dtype=np.float64)
                 - np.asarray(want, dtype=np.float64))
    gap = np.where(np.isnan(gap), np.inf, gap)
    return {"log_rel_err": float(gap.max())}
