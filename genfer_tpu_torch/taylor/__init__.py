from .backend import (
    HybridBackend,
    PallasBackend,
    TorchF64Backend,
    TorchIntervalBackend,
)
from .host import (
    ArrayF64Backend,
    ArrayIntervalBackend,
    Backend,
    NumpyF64Backend,
    NumpyIntervalBackend,
    ObjectBackend,
)
from .tensorpoly import INF_DEGREE, TaylorPoly

__all__ = [
    "ArrayF64Backend",
    "ArrayIntervalBackend",
    "Backend",
    "HybridBackend",
    "NumpyF64Backend",
    "NumpyIntervalBackend",
    "ObjectBackend",
    "PallasBackend",
    "TaylorPoly",
    "TorchF64Backend",
    "TorchIntervalBackend",
    "INF_DEGREE",
]
