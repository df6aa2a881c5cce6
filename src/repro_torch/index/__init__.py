"""Device-resident n-gram index and batched queries (flat layout).

``build`` freezes a finished job's ``NGramStats`` into a sorted packed-lane
``NGramIndex``; ``query`` answers batched point-count and top-k-continuation
queries against it.  Compression, merge, generations and sharded serving wait
for later slices.
"""
from . import build, query
from .build import (IndexSegment, NGramIndex, build_index, index_from_arrays,
                    index_from_segment, segment_from_stats)
from .query import continuations, lookup

__all__ = ["build", "query", "IndexSegment", "NGramIndex", "build_index",
           "index_from_arrays", "index_from_segment", "segment_from_stats",
           "lookup", "continuations"]
