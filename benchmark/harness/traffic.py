"""The one generator of inputs: a configuration's data and a traffic mix's
pool of batches, drawn from ``--seed``.

Each seed gives the same sizes and the same amount of work; only the
values differ.  Three independent streams come from one seed: the
configuration's data (``data``), the pool of input batches (``pool``)
and the choice of the answers the check compares (``sample``).

Laws a configuration's ``data`` may name:

* ``ink_background``: a (classes, pixels) table of Bernoulli parameters;
  a pixel is inked with probability ``ink_share`` (one mask for every
  class), its parameter uniform in ``ink`` there and in ``background``
  elsewhere.

Laws a traffic mix's ``inputs`` may name:

* ``uniform``: each of the program's parameters uniform in [low, high];
  the batch is ``{"params": (batch, n_params)}``.
* ``class_images``: a class a row from the configuration's ``priors``,
  then binary pixels from that class's row of ``theta``; the batch is
  ``{"images": (batch, pixels) float64 0/1, "classes": (batch,)}``.
"""

from __future__ import annotations

import numpy as np

STREAMS = ("data", "pool", "sample")


def streams(seed: int) -> dict:
    """Independent generators for each stream of ``seed`` (any whole
    number: negative ones and those past 64 bits are folded in)."""
    entropy = int(seed) % (1 << 128)
    children = np.random.SeedSequence(entropy).spawn(len(STREAMS))
    return {name: np.random.default_rng(s)
            for name, s in zip(STREAMS, children)}


def model_data(config: dict, rng) -> dict:
    """The configuration's data (``config["data"]``), drawn from ``rng``."""
    out = {}
    for key, spec in config.get("data", {}).items():
        law = spec["law"]
        if law == "ink_background":
            model = config["model"]
            classes, pixels = model["classes"], model["pixels"]
            ink = rng.random(pixels) < spec["ink_share"]
            out[key] = np.where(
                ink, rng.uniform(*spec["ink"], (classes, pixels)),
                rng.uniform(*spec["background"], (classes, pixels)))
        else:
            raise ValueError(f"unknown data law {law!r}")
    return out


def batch(traffic: dict, config: dict, data: dict, rng) -> dict:
    spec, n = traffic["inputs"], traffic["batch"]
    law = spec["law"]
    if law == "uniform":
        k = len(config["params"])
        return {"params": rng.uniform(spec["low"], spec["high"], (n, k))}
    if law == "class_images":
        priors = np.asarray(config["model"]["priors"], dtype=np.float64)
        classes = rng.choice(len(priors), size=n, p=priors / priors.sum())
        theta = data["theta"]
        images = rng.random((n, theta.shape[1])) < theta[classes]
        return {"images": images.astype(np.float64), "classes": classes}
    raise ValueError(f"unknown input law {law!r}")


def pool(traffic: dict, config: dict, data: dict, rng) -> list[dict]:
    """``traffic["pool"]`` distinct batches; the window cycles through
    them in order."""
    return [batch(traffic, config, data, rng)
            for _ in range(traffic["pool"])]
