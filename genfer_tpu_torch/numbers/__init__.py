from .scalar import (
    F64,
    BigFloat,
    Interval,
    MultiPrec,
    Rational,
    set_precision,
    get_precision,
)
from .format import format_f64

__all__ = [
    "F64",
    "BigFloat",
    "Interval",
    "MultiPrec",
    "Rational",
    "set_precision",
    "get_precision",
    "format_f64",
]
