"""What a CLI run printed, read back, and the reference's is_close between
two runs' values: one reader and one comparison for the bench and
``chip_smoke.py``."""

from __future__ import annotations

import math
import re
from fractions import Fraction

#: the reference's is_close (number.rs:59-77): rel 1e-9 or abs 1e-8
IS_CLOSE = (1e-9, 1e-8)

_POINT = re.compile(r"^(?:Normalized:\s+)?(.+?)\s+=\s+(\S+)$")
_MASS = re.compile(r"Unnormalized: p\((\d+)\)\s*=\s*([\d.e+/-]+)")


def _number(text: str) -> float:
    """A printed value: a float, or a fraction as ``--rational`` prints."""
    return float(Fraction(text)) if "/" in text else float(text)


def read_results(text: str) -> dict[str, float]:
    """The point results a run printed: ``Z``, ``E``, ``σ`` and the other
    moments by their symbol, each ``p(k)`` of a normalized program, and
    each ``p(k) / Z`` of an unnormalized one (its unnormalized lines and
    the "p(n) <= ..." tail bounds are left out); a fraction as its float,
    and "(not a rational)" left out."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("Unnormalized:") or "<=" in line:
            continue
        m = _POINT.match(line.strip())
        if m is not None:
            out[m.group(1).split(":")[-1].strip()] = _number(m.group(2))
    return out


def read_intervals(text: str) -> dict[str, tuple[float, float]]:
    """The intervals a run printed (``X ∈ [lo, hi]``), by symbol, as
    ``read_results`` reads points ("(not a rational)" left out)."""
    out = {}
    for line in text.splitlines():
        if "∈ [" in line and "<=" not in line and "(not" not in line:
            key, rest = line.split("∈ [")
            lo, hi = rest.rstrip("]").split(", ")
            out[key.split(":")[-1].strip()] = (_number(lo), _number(hi))
    return out


def read_endpoints(text: str) -> dict[str, float]:
    """``read_intervals`` as points: ``X lo`` and ``X hi``."""
    return {f"{key} {end}": v for key, iv in read_intervals(text).items()
            for end, v in zip(("lo", "hi"), iv)}


def read_masses(text: str) -> dict[str, float]:
    """The unnormalized masses a run printed, by ``p(k)``."""
    return {f"p({m.group(1)})": _number(m.group(2))
            for m in _MASS.finditer(text)}


def disagreements(got: dict, want: dict, scale: float | None = None
                  ) -> list[str]:
    """Where ``got`` differs from ``want``: other keys, or a value outside
    is_close of ``want``'s (equal non-finite values agree).  ``Z`` is held
    at rel 1e-9 of itself, and with ``scale`` every value at rel 1e-9 of
    ``scale`` (the masses' own Z), with no absolute floor: a posterior's Z
    and unnormalized masses often lie far below is_close's 1e-8."""
    rel, abs_ = IS_CLOSE
    if set(got) != set(want):
        return [f"printed results differ: {sorted(set(got) ^ set(want))}"]
    out = []
    for key, w in want.items():
        g = got[key]
        if g == w or (math.isnan(g) and math.isnan(w)):
            continue
        if scale is not None:
            tol = rel * abs(scale)
        elif key == "Z":
            tol = rel * abs(w)
        else:
            tol = max(abs_, rel * abs(w))
        if not abs(g - w) <= tol:
            out.append(f"{key} = {g} against {w}")
    return out
