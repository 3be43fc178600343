"""CPU tests of the benchmark's harness: ``python -m pytest
streambench/tests`` from the root of the repo (the driver's ``pytest
tests/`` does not collect them). None needs a card: what only the card can
show, the cells' runs show."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
