"""Generation-keyed host-side LRU of hot query results (port of
``repro.serve.cache``; it touches no device)."""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.obs import metrics as obs_metrics

__all__ = ["LRUQueryCache"]


class LRUQueryCache:
    """Host-side LRU of hot query results, keyed by (kind, gram bytes).

    Entries are tagged with the index ``generation`` they were computed
    against; a lookup under a newer generation drops the whole cache (segment
    swaps change answers wholesale).  Accesses tagged with an *older*
    generation -- a batch collected after an ingest bumped the index -- are
    discarded, never installed: they must not roll the cache back to stale
    counts.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.generation = -1
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._d: OrderedDict = OrderedDict()

    def _sync(self, generation: int) -> bool:
        """Advance to ``generation`` if newer; False iff the caller is stale."""
        if generation > self.generation:
            self._d.clear()
            self.generation = generation
        return generation == self.generation

    def get(self, key, generation: int):
        if not self._sync(generation):
            self.misses += 1               # stale reader: always a miss
            return None
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key, generation: int, value) -> None:
        if not self._sync(generation):
            return                         # stale result: drop, don't install
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._d),
                "generation": self.generation, "hit_rate": self.hit_rate}

    def publish_metrics(self, reg=None) -> None:
        """Mirror lifetime cache stats into the active metrics registry."""
        if reg is None:
            reg = obs_metrics.get_registry()
        if not reg:
            return
        for k in ("hits", "misses", "evictions"):
            c = reg.counter("cache." + k)
            c.add(getattr(self, k) - c.value)     # lifetime mirror, not +=
        reg.gauge("cache.entries").set(len(self._d))
        reg.gauge("cache.hit_rate").set(self.hit_rate)
