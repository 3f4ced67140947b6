from .ir import GenFun
from .extract import (
    probs_taylor,
    moments_taylor,
    factorial_moments_to_moments,
    moments_to_central_moments,
    central_to_standardized_moments,
)

__all__ = [
    "GenFun",
    "probs_taylor",
    "moments_taylor",
    "factorial_moments_to_moments",
    "moments_to_central_moments",
    "central_to_standardized_moments",
]
