"""The benchmark's CPU tests: the repository root and ``src/`` on the
path, so that ``portbench`` and the port import as ``run.py`` imports
them."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
