"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository: the program under test
is ``src/repro_torch`` there.  See ``perfbench/harness.py``.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for ``perfbench``) and its ``src`` (for the program),
# in place of this script's folder, whose module names are the harness's own
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("perfbench: the program under test (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        sys.exit(2)
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
