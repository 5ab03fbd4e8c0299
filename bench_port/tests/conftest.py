"""The harness's CPU tests: ``python -m pytest -q bench_port/tests`` from
the checkout's root (``-m gpu`` for the one that needs the card)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
