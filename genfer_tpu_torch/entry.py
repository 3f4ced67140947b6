"""The port's one-step form of the f64 device path: the twin of
genfer_tpu's driver entry point ``__graft_entry__.entry()``.

    from genfer_tpu_torch.entry import entry
    forward, (a, b, y) = entry()          # on the CUDA card
    quot, total = forward(a, b, y)

``forward`` is one truncated-Taylor inference step at order 64: the
truncated 2-D Cauchy product of ``a`` and ``b`` (``_conv_impl``: K1 on the
card), the power-series division of the product by ``y`` along the
leading axis (a lower-triangular Toeplitz solve), and the total mass of
the quotient.  The operands come from a ``torch.Generator`` on the device,
seeded 0 (uniform in [0, 1)), and ``y = [2, 1, 1, ...]``: jax's random
bits cannot be drawn here, so a comparison with genfer_tpu runs the same
operands through both ``forward``s.
"""

from __future__ import annotations

import torch

from .taylor.backend import _conv_impl, _resolve_device, _toeplitz

ORDER = 64


def forward(a, b, y):
    """(quotient, total) of one step on the operands' device."""
    prod = _conv_impl(a, b, (ORDER, ORDER))
    T = _toeplitz(y, ORDER, ORDER)
    quot = torch.linalg.solve_triangular(T, prod, upper=False)
    return quot, quot.sum()


def entry(device=None):
    """``forward`` and its operands on ``device`` (``None``: the CUDA
    card, which must exist)."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.rand((ORDER, ORDER), generator=gen, dtype=torch.float64,
                   device=device)
    b = torch.rand((ORDER, ORDER), generator=gen, dtype=torch.float64,
                   device=device)
    y = torch.ones(ORDER, dtype=torch.float64, device=device)
    y[0] = 2.0
    return forward, (a, b, y)
