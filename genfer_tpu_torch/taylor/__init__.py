from .backend import HybridBackend, PallasBackend

__all__ = ["HybridBackend", "PallasBackend"]
