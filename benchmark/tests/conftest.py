"""Puts the benchmark's folder and the repository root on ``sys.path``, as
``benchmark/run.py`` does; imports nothing heavy."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)
