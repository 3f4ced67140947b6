"""Program statistics tool (reference: src/bin/stats.rs).

Prints the number of variables and statements, the inferred support, its
size, and whether the program contains observations.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..lang.parser import parse_file
from ..semantics.support_transform import SupportTransformer
from ..semantics.supportset import SupportSet


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genfer-stats")
    ap.add_argument("file_name", type=Path)
    args = ap.parse_args(argv)
    program = parse_file(args.file_name)
    support = SupportTransformer().semantics(program)
    print(
        f"{support.num_vars()} variables, {program.size()} statements "
        "(including nesting)"
    )
    print(f"Support: {support}")
    size = _support_size(support)
    print(f"Support size: {size if size is not None else 'infinite'}")
    print(f"Contains observations: {'true' if program.uses_observe() else 'false'}")


def _support_size(support):
    if support.is_empty():
        return 0
    acc = 1
    for s in support.supports:
        if s.kind == SupportSet.RANGE and s.end is not None:
            acc *= s.end - s.start + 1
        else:
            return None
    return acc


if __name__ == "__main__":
    main()
