"""The least work of the main path's kernels in one job, from the job's own
sizes, whatever implements them.

Bytes count uint32 values at 4 bytes (the paper's record layout), each input
read once and each output written once.  The formulas follow the kernel
table of the port's PERF.md (phase 4 of ``chip_smoke.py``):

* ``suffix_pack``: every position's token in (4 B) and its record out:
  the sigma-truncated suffix packed into lanes plus a weight (4 B a lane).
  About 6 scalar operations a term of a suffix.
* ``lcp_boundary``: every row that must be reduced (the distinct suffixes
  the combiner leaves, the job's ``shuffle_records``) read as sigma terms
  (4 B each); its LCP (4 B) and sigma boundary flags (1 B each) out.  About
  3 scalar operations a term.
"""
from __future__ import annotations

import math

from perfbench.devtrace import bound_s

__all__ = ["term_bits", "lanes", "suffix_pack_s", "lcp_boundary_s"]


def term_bits(vocab_size: int) -> int:
    """Bits of one term id (ids 1..vocab_size, 0 is PAD)."""
    return max(1, math.ceil(math.log2(vocab_size + 1)))


def lanes(sigma: int, vocab_size: int) -> int:
    """32-bit lanes of a packed sigma-term suffix, whole terms a lane."""
    per = max(1, 32 // term_bits(vocab_size))
    return -(-sigma // per)


def suffix_pack_s(positions: int, sigma: int, vocab_size: int) -> float:
    """Least seconds of one job's map emit over ``positions`` positions."""
    return bound_s(positions * (4 + 4 * (lanes(sigma, vocab_size) + 1)),
                   6 * sigma * positions)


def lcp_boundary_s(rows: int, sigma: int) -> float:
    """Least seconds of one job's reducer boundaries over ``rows`` rows."""
    return bound_s(rows * (4 * sigma + 4 + sigma), 3 * sigma * rows)
