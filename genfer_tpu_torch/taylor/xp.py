"""A torch array namespace with numpy's signatures.

``ArrayF64Backend`` and ``ArrayIntervalBackend`` (``taylor/host.py``) hold
the bodies of genfer_tpu's JAX backends over an array namespace
``self.jnp``, and the shared layers call that namespace as numpy
(``tensorpoly.py``'s ``b.jnp.pad(arr, [(lo, hi), ...])``, ``gf/ir.py``'s
``backend.jnp.maximum``).  ``TorchNamespace(device)`` is that namespace
over torch: exactly the names those callers use, each with numpy's
signature, and every tensor it makes lands on ``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


class TorchNamespace:
    """numpy's signatures over torch tensors on one device."""

    float64 = torch.float64
    inf = math.inf
    nan = math.nan

    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    isfinite = staticmethod(torch.isfinite)
    isnan = staticmethod(torch.isnan)
    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)
    where = staticmethod(torch.where)
    broadcast_to = staticmethod(torch.broadcast_to)

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, x, dtype=None):
        """Nested lists, numpy arrays or Python floats."""
        # a copy: numpy's cached factor vectors are read-only
        return torch.as_tensor(np.array(x), dtype=dtype or self.float64,
                               device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.float64,
                           device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype or self.float64,
                          device=self.device)

    @staticmethod
    def take(arr, i, axis):
        """An int index drops the axis, as numpy's does."""
        if isinstance(i, (int, np.integer)):
            return arr.select(axis, int(i))
        idx = torch.as_tensor(i, dtype=torch.long, device=arr.device)
        return arr.index_select(axis, idx)

    @staticmethod
    def stack(arrs, axis=0):
        return torch.stack(list(arrs), dim=axis)

    @staticmethod
    def concatenate(arrs, axis=0):
        return torch.cat(list(arrs), dim=axis)

    @staticmethod
    def pad(arr, pads):
        """numpy's ``[(lo, hi), ...]`` per axis, zeros."""
        return F.pad(arr, [p for lo_hi in reversed(pads) for p in lo_hi])

    @staticmethod
    def sum(a, axis=None, keepdims=False):
        return a.sum() if axis is None else a.sum(dim=axis, keepdim=keepdims)

    @staticmethod
    def nextafter(x, toward):
        return torch.nextafter(x, torch.full_like(x, toward))
