"""The comparison that decides ``correct``.

The answers compared are those the timed path produced in the window: a
sample of its batches drawn from the seed (reservoir sampling, so every
batch of the window is as likely to be drawn), read back as the client
received them.  The configuration's plain reference
(``reference/<config>.py``) works each sampled batch out again from the
benchmark's own inputs and data, and reduces the gap to the numbers that
the configuration's ``check`` holds to their limits.  The reference
module gives:

* ``served(raw)``: the program's read-back in the compared form;
* ``reference(inputs, data, config, dtype)``: the same form, computed by
  the reference in ``dtype``;
* ``numbers(got, want)``: ``{name: gap}``, larger is worse.

The control is the reference computed in float32 put in the program's
place; it has to come out not correct (``control``).
"""

from __future__ import annotations

import math

import numpy as np


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, drawn
    with ``rng`` (Algorithm R)."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _worse(a: float, b: float) -> float:
    """The larger gap; a NaN counts as infinitely large."""
    a = math.inf if math.isnan(a) else a
    b = math.inf if math.isnan(b) else b
    return max(a, b)


def readings(ref, config: dict, data: dict, samples, pool, answer) -> dict:
    """The worst of each compared number over ``samples`` ((pool index,
    raw) pairs), where ``answer(pool_index, raw)`` gives what is held to
    the float64 reference."""
    worst: dict = {}
    for idx, raw in samples:
        want = ref.reference(pool[idx], data, config, np.float64)
        got = answer(idx, raw)
        if np.shape(got) != np.shape(want):
            nums = {name: math.inf for name in config["check"]}
        else:
            nums = ref.numbers(got, want)
        for name, v in nums.items():
            worst[name] = _worse(worst.get(name, 0.0), float(v))
    return worst


def judge(ref, config: dict, data: dict, samples, pool) -> tuple[bool, dict]:
    """``correct`` and ``{name: (reading, limit)}`` for the program's
    sampled answers."""
    got = readings(ref, config, data, samples, pool,
                   lambda idx, raw: ref.served(raw))
    return verdict(config, got, bool(samples))


def control(ref, config: dict, data: dict, samples, pool) -> dict:
    """The readings of the float32 reference in the program's place."""
    return readings(ref, config, data, samples, pool,
                    lambda idx, raw: ref.reference(pool[idx], data, config,
                                                   np.float32))


def verdict(config: dict, got: dict, any_sample: bool):
    limits = {name: c["limit"] for name, c in config["check"].items()}
    table = {name: (got.get(name, math.inf), lim)
             for name, lim in limits.items()}
    ok = any_sample and all(v <= lim for v, lim in table.values())
    return ok, table
