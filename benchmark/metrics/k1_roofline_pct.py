"""K1's share of its roofline in the profiled slice: the least time one
H100 needs for the products the configuration lists (``k1.products``,
each the larger of its bytes over the memory bandwidth and its
multiply-adds over the FP64 tensor rate: ``harness.peaks``), over the
time K1's kernels took, a batch, in percent.

The work is counted from the list, never from the kernel that ran, so a
later kernel for the same products meets the same yardstick.  ``arm``
records, during the first call, the shapes of the products the program
hands to K1's wrapper; the metric is read only where they are the
listed products (once for each walk of the call), and where every kept
batch of the slice shows one K1 kernel a listed product.
"""

import contextlib
import sys
from collections import Counter

from benchmark.harness import peaks

K1_MODULE = "genfer_tpu_torch.ops.conv2d_f64"
K1_WRAPPER = "conv2d_trunc_f64_batched"


def _key(a, b, out):
    return (tuple(a), tuple(b), tuple(out))


@contextlib.contextmanager
def arm(run):
    """Record the products handed to K1's wrapper while active."""
    if "k1" not in run.config:
        yield
        return
    import importlib

    mod = importlib.import_module(K1_MODULE)
    inner = getattr(mod, K1_WRAPPER)
    seen = run.counters.setdefault("k1_products", [])

    def wrapper(a, b, out_shape, *args, **kwargs):
        seen.append(_key(a.shape[1:], b.shape[1:], out_shape))
        return inner(a, b, out_shape, *args, **kwargs)

    setattr(mod, K1_WRAPPER, wrapper)
    try:
        yield
    finally:
        setattr(mod, K1_WRAPPER, inner)


def products_match(listed, seen) -> bool:
    """``seen`` is the listed products, as a multiset, once or more."""
    want = Counter(_key(p["a"], p["b"], p["out"]) for p in listed)
    n = len(listed)
    if not seen or len(seen) % n:
        return False
    return all(Counter(seen[i:i + n]) == want for i in range(0, len(seen), n))


def _fail(why):
    print(f"k1_roofline_pct: {why}", file=sys.stderr)


def read(run):
    k1 = run.config.get("k1")
    sl = run.slice
    if k1 is None or sl is None or not sl.complete:
        return None
    seen = run.counters.get("k1_products") or []
    if not products_match(k1["products"], seen):
        return _fail(f"the first call handed K1 {len(seen)} products, not "
                     f"the {len(k1['products'])} listed once a walk")
    per_batch = []
    for j in range(len(sl.batches)):
        ops = [(s, e) for name, s, e in sl.kernels(j)
               if any(k in name for k in k1["kernels"])]
        if len(ops) != len(k1["products"]):
            return _fail(f"kept batch {j} shows {len(ops)} K1 kernels, not "
                         f"{len(k1['products'])}")
        per_batch.append(sum(e - s for s, e in ops))
    measured = sum(per_batch) / len(per_batch)
    return 100.0 * peaks.least_seconds(k1["products"], run.batch) / measured
