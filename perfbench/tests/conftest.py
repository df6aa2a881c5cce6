"""Tests of the benchmark harness: on the CPU at tiny sizes (the program's
kernels run their plain versions there), and one ``cuda`` test on the card.

Run from the repository's root:

    python -m pytest -q perfbench/tests
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)
