"""K1's share of its roofline over the captured walk, in percent: the least
time one H100 needs for the products the configuration lists
(``k1.products``, each repeated ``times`` times; ``harness.peaks``: the
larger of a product's bytes over the memory bandwidth and its
multiply-adds over the FP64 tensor rate), over the time K1's kernels took
a batch of the profiled slice.

The work is counted from the list, never from what ran, as for
``k1_roofline_pct``.  What the program ran is read from its own tracer
(``harness.program_trace``): the ``k1.products`` counts {a, b, out} of
phase ``capture``, the walk the CUDA graph replays.  The metric reads
only where those are the listed products as a multiset, and every kept
batch of the slice shows one K1 kernel a listed product; a program whose
counts have no ``phase`` reads nothing.  The per-batch reading is
``k1_roofline_pct``'s, over the expanded list.
"""

import sys
from collections import Counter
from types import SimpleNamespace

from benchmark.harness import program_trace
from benchmark.metrics import k1_roofline_pct as _k1

arm = program_trace.arm

NAME = "k1_walk_roofline_pct"


def expanded(listed) -> list:
    """The listed products, each ``times`` times (once by default)."""
    return [p for p in listed for _ in range(p.get("times", 1))]


def captured(rec) -> Counter:
    """The products the recording's ``k1.products`` counts of phase
    ``capture`` name, as a multiset of (a, b, out)."""
    out = Counter()
    for (name, items), n in rec.counters.items():
        attrs = dict(items)
        if name == "k1.products" and attrs.get("phase") == "capture":
            out[_k1._key(attrs["a"], attrs["b"], attrs["out"])] += n
    return out


def read(run):
    k1 = run.config.get("k1")
    sl = run.slice
    if k1 is None or sl is None or not sl.complete:
        return None
    rec = run.counters.get(program_trace.KEY)
    if rec is None:
        print(f"{NAME}: the program has no tracer", file=sys.stderr)
        return None
    products = expanded(k1["products"])
    keys = [_k1._key(p["a"], p["b"], p["out"]) for p in products]
    got = captured(rec)
    if got != Counter(keys):
        print(f"{NAME}: the captured walk handed K1 {sum(got.values())} "
              f"products of phase capture, not the {len(products)} listed",
              file=sys.stderr)
        return None
    # the captured walk is the listed products once: k1_roofline_pct's
    # reading of the slice over them
    return _k1.read(SimpleNamespace(
        config=dict(run.config, k1=dict(k1, products=products)), slice=sl,
        batch=run.batch, counters={"k1_products": keys}))
