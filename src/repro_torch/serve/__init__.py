"""The query service of the port (the ``cache`` and ``service`` parts of
``repro.serve``): a generational index + a host LRU cache behind a batch
ingest / lookup / top-k API.  The batcher, admission, frontend and HTTP
layers wait for a later slice."""
from .cache import LRUQueryCache
from .service import StreamingNGramService, make_query_stream

__all__ = ["LRUQueryCache", "StreamingNGramService", "make_query_stream"]
