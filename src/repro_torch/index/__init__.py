"""Device-resident n-gram index, its compressed and generational layouts, and
batched queries.

``build`` freezes a finished job's ``NGramStats`` into a sorted packed-lane
``NGramIndex``; ``compress`` re-encodes it as a front-coded + Elias-Fano
``CompressedNGramIndex``; ``merge`` merges segments, folds a wave run's segments
(the accumulators) and keeps a ``GenerationalIndex`` (LSM) under streaming
ingest; ``query`` answers batched point-count and top-k-continuation queries
against any of them; ``serve`` shards a frozen index across the ranks of
a mesh with the job shuffle's own hash partitioner (``build_sharded_index``,
``serve_queries``), a generational index segment by segment
(``shard_generational``), and describes the layout to the frontend
(``describe_topology``).
"""
from . import build, compress, merge, query, serve
from .build import (IndexSegment, NGramIndex, build_index, index_from_arrays,
                    index_from_segment, segment_from_stats,
                    segment_from_wave_stats)
from .compress import (CompressedNGramIndex, build_compressed_index,
                       compress_index, compressed_index_from_arrays,
                       decode_segment)
from .merge import (DeferredSegmentAccumulator, GenerationalIndex,
                    PairwiseSegmentAccumulator, TieredSegmentAccumulator,
                    generational_from_stats, merge_indexes, merge_segments,
                    segment_to_stats, stats_union)
from .query import continuations, lookup
from .serve import (ShardedGenerationalIndex, ShardedNGramIndex,
                    build_sharded_index, empty_prefix_continuations, make_server,
                    shard_generational)
from .serve import serve as serve_queries

__all__ = ["build", "compress", "merge", "query", "serve", "IndexSegment", "NGramIndex",
           "build_index", "index_from_arrays", "index_from_segment",
           "segment_from_stats", "segment_from_wave_stats",
           "CompressedNGramIndex", "build_compressed_index", "compress_index",
           "compressed_index_from_arrays", "decode_segment",
           "GenerationalIndex", "DeferredSegmentAccumulator",
           "TieredSegmentAccumulator", "PairwiseSegmentAccumulator",
           "generational_from_stats", "merge_indexes", "merge_segments",
           "segment_to_stats", "stats_union", "lookup", "continuations",
           "ShardedGenerationalIndex", "ShardedNGramIndex", "build_sharded_index",
           "empty_prefix_continuations", "make_server", "shard_generational",
           "serve_queries"]
