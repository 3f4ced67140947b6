"""CPU tests of the benchmark's harness: run them from the root of the
checkout with ``python -m pytest benchmark/tests -q`` (the card's test is
marked ``cuda`` and skips without a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
