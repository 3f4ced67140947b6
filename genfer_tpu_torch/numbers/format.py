"""Shortest round-trip float formatting compatible with the reference output.

The reference prints every f64 with the Rust `ryu` crate
(reference: src/number/f64.rs:41-45), whose conventions are:

* shortest representation that round-trips,
* fixed-point notation for ``1e-5 <= |x| < 1e16``,
* scientific notation otherwise, with no zero-padded exponent (``1e-7``),
* ``0.0`` / ``-0.0`` keep one fractional digit; integers print as ``42.0``,
* non-finite values print as ``inf`` / ``-inf`` / ``NaN``.

Python's ``repr`` already produces shortest round-trip digits, but pads
exponents (``1e-07``), switches to scientific at 1e-4 instead of 1e-5 and
prints ``nan``/``inf`` in lowercase.  This module converts.
"""

from __future__ import annotations

import math


def _split_repr(x: float) -> tuple[str, str, int]:
    """Return (sign, digits, e10) where x = sign 0.digits * 10^(e10+1),
    i.e. e10 is the decimal exponent of the leading digit."""
    s = repr(float(x))
    sign = ""
    if s.startswith("-"):
        sign, s = "-", s[1:]
    if "e" in s:
        mant, _, exp = s.partition("e")
        e = int(exp)
    else:
        mant, e = s, 0
    if "." in mant:
        int_part, _, frac_part = mant.partition(".")
    else:
        int_part, frac_part = mant, ""
    digits = (int_part + frac_part).lstrip("0")
    if not digits:
        return sign, "0", 0
    # exponent of leading digit
    leading_zeros = len(int_part) - len(int_part.lstrip("0"))
    if int_part.lstrip("0"):
        e10 = e + len(int_part) - 1
    else:
        # 0.000ddd form
        frac_zeros = len(frac_part) - len(frac_part.lstrip("0"))
        e10 = e - frac_zeros - 1
    del leading_zeros
    digits = digits.rstrip("0") or "0"
    return sign, digits, e10


def format_f64(x: float) -> str:
    """Format a float like the Rust ryu crate's ``Buffer::format``."""
    x = float(x)
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    sign, digits, e10 = _split_repr(x)
    ndigits = len(digits)
    if -5 <= e10 < 16:
        # fixed-point
        if e10 >= ndigits - 1:
            # integer with trailing zeros
            body = digits + "0" * (e10 - ndigits + 1) + ".0"
        elif e10 >= 0:
            body = digits[: e10 + 1] + "." + digits[e10 + 1 :]
        else:
            body = "0." + "0" * (-e10 - 1) + digits
        return sign + body
    # scientific
    if ndigits == 1:
        mant = digits
    else:
        mant = digits[0] + "." + digits[1:]
    return f"{sign}{mant}e{e10}"
