"""The golden-corpus comparison of the reference's test suite, for the
bench's ``--suite`` (``bench.bench_suite``): the port's copies of
``tests/test_golden.py``'s ``compare_outputs`` (stdout against an
``.expect`` file at the reference's is_close: rel 1e-9, abs 1e-8,
reference number/number.rs:69-77; bit-identical text is not required for
numeric tokens, everything else must match exactly), ``_first_line_flags``
(the per-file flags of the first comment line, integration.rs:18-33) and
``run_cli`` (the port's CLI in process).
"""

from __future__ import annotations

import io
import math
import re
from contextlib import redirect_stdout
from fractions import Fraction
from pathlib import Path

_NUM_RE = re.compile(
    r"-?\d+\.\d+e-?\d+|-?\d+e-?\d+|-?\d+\.\d+|-?\d+/\d+|-?\d+|-?inf|NaN|∞|-∞"
)


def _parse_num(tok: str):
    if tok == "NaN":
        return math.nan
    if tok in ("inf", "∞"):
        return math.inf
    if tok in ("-inf", "-∞"):
        return -math.inf
    if "/" in tok:
        return Fraction(tok)
    if "." in tok or "e" in tok:
        return float(tok)
    return Fraction(int(tok))


def _tokenize(line: str):
    """Return (template, numbers): numeric tokens replaced by '#'."""
    nums = [_parse_num(m.group()) for m in _NUM_RE.finditer(line)]
    template = _NUM_RE.sub("#", line)
    return template, nums


def _is_close(a, b, rel=1e-9, abs_tol=1e-8) -> bool:
    if isinstance(a, Fraction) and isinstance(b, Fraction):
        return a == b
    af, bf = float(a), float(b)
    if math.isnan(af) or math.isnan(bf):
        return math.isnan(af) and math.isnan(bf)
    if math.isinf(af) or math.isinf(bf):
        return af == bf
    diff = abs(af - bf)
    return diff <= abs_tol or diff <= rel * abs(bf)


_POINT_OR_IV = re.compile(r"(= #|∈ \[#, #\])")


def _normalize_interval_forms(template: str) -> str:
    """A point `= x` and a degenerate interval `∈ [x, x]` are numerically
    interchangeable; normalize both to the same template token."""
    return _POINT_OR_IV.sub("@", template)


def compare_outputs(ours: str, expected: str, path):
    our_lines = ours.rstrip("\n").split("\n")
    exp_lines = expected.rstrip("\n").split("\n")
    assert len(our_lines) == len(exp_lines), (
        f"{path}: line count mismatch: {len(our_lines)} vs {len(exp_lines)}\n"
        f"--- ours ---\n{ours}\n--- expected ---\n{expected}"
    )
    for ln, (a, b) in enumerate(zip(our_lines, exp_lines), 1):
        ta, na = _tokenize(a)
        tb, nb = _tokenize(b)
        norm_a, norm_b = _normalize_interval_forms(ta), _normalize_interval_forms(tb)
        if norm_a == norm_b and ta != tb:
            # point vs degenerate interval: expand points to (x, x) pairs
            na = _expand_to_pairs(ta, na)
            nb = _expand_to_pairs(tb, nb)
        else:
            assert ta == tb, (
                f"{path}:{ln}: text mismatch\n ours:     {a}\n expected: {b}"
            )
        assert len(na) == len(nb), (
            f"{path}:{ln}: number count mismatch\n ours:     {a}\n expected: {b}"
        )
        for x, y in zip(na, nb):
            assert _is_close(x, y), (
                f"{path}:{ln}: value mismatch {x} vs {y}\n"
                f" ours:     {a}\n expected: {b}"
            )


def _expand_to_pairs(template: str, nums):
    """Duplicate the numbers of `= #` point tokens so they align with
    `∈ [#, #]` interval tokens."""
    out = []
    i = 0
    pos = 0
    for m in re.finditer(r"= #|∈ \[#, #\]|#", template):
        tok = m.group()
        if tok == "= #":
            out.extend([nums[i], nums[i]])
            i += 1
        elif tok == "#":
            out.append(nums[i])
            i += 1
        else:
            out.extend([nums[i], nums[i + 1]])
            i += 2
        pos = m.end()
    del pos
    return out


def _first_line_flags(path: Path):
    first = path.read_text(encoding="utf-8").splitlines()
    first = first[0] if first else ""
    if "skip integration test" in first:
        return None
    if "flags: " in first:
        return first.split("flags: ", 1)[1].split()
    return []


def run_cli(sgcl: Path, flags):
    from .cli import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main([str(sgcl), "--no-timing"] + flags)
    return buf.getvalue()
