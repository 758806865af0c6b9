"""The benchmark's tests: its own directory and the repository root on
the import path (the harness's modules import each other by name)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
