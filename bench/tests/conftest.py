"""The benchmark's tests find ``bench`` and the program under test from the
checkout's root; they import nothing of JAX."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
