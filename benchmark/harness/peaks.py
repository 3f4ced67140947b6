"""The yardstick's table of peaks and the operation and byte counts of a
truncated product (copied from the port's ``bench.py`` arithmetic, so
that a change to the program cannot move it).

Peaks of one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the
700 W power limit: HBM3 at 3.35 TB/s, FP64 on the tensor cores at 67
TFLOP/s (two flops a multiply-add).
"""

from __future__ import annotations

import math

BYTES_PER_S = 3.35e12
F64_MMA_PER_S = 67e12 / 2
F64_BYTES = 8


def pair_macs(a_shape, b_shape, out_shape) -> int:
    """Multiply-adds of one truncated product ``c[k] = sum a[i] b[k - i]``,
    ``k < out_shape``: each axis contributes the pairs (i, k - i) inside
    both operands, summed over its outputs."""
    total = 1
    for s_a, s_b, o in zip(a_shape, b_shape, out_shape):
        pairs = 0
        for k in range(o):
            pairs += max(0, min(k + 1, s_a) - max(0, k + 1 - s_b))
        total *= max(pairs, 1)
    return total


def product_work(product: dict, batch: int) -> tuple[int, int]:
    """(multiply-adds, bytes) of one batched product of the list in a
    configuration's ``k1`` block: ``a``, ``b`` and ``out`` shapes, and the
    operands in ``batched`` carry the batch.  Each input is read once and
    the output written once: an operand shared by the batch counts once."""
    a, b, out = product["a"], product["b"], product["out"]
    words = sum(math.prod(product[k]) * (batch if k in product["batched"]
                                         else 1) for k in ("a", "b"))
    words += math.prod(out) * batch
    return batch * pair_macs(a, b, out), F64_BYTES * words


def least_seconds(products: list, batch: int) -> float:
    """The least time one H100 takes for these products, launched one
    after another: for each, the larger of its bytes over the memory
    bandwidth and its multiply-adds over the FP64 tensor rate."""
    total = 0.0
    for p in products:
        macs, nbytes = product_work(p, batch)
        total += max(nbytes / BYTES_PER_S, macs / F64_MMA_PER_S)
    return total
