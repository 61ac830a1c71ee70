"""Bounded caches.

* ``RandomEvictionCache`` — fixed-size map evicting a random entry when
  full.  Reference: src/util/RandomEvictionCache.h.  Used by the
  signature-verify cache (src/crypto/SecretKey.cpp) and bucket-entry
  caches.  Random eviction (not LRU) keeps adversaries from
  deterministically flushing hot entries.
* ``LRUCache`` — classic least-recently-used map.  Backs the
  BucketListDB entry cache in ``LedgerTxnRoot`` (reference: the
  InMemorySorobanState-adjacent entry cache of LedgerTxnRoot /
  BucketListDB's RandomEvictionCache — LRU here because replay's access
  pattern is hot-account dominated, not adversarial).
"""

from __future__ import annotations

import random
from collections import OrderedDict
from typing import Dict, Generic, Hashable, List, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    """Least-recently-used bounded map.  ``get`` distinguishes a cached
    None from a miss via the `default` sentinel, so callers can cache
    negative lookups ("this key is definitively absent") — the
    BucketListDB root does, to spare repeated 22-bucket probe chains."""

    __slots__ = ("_max", "_map", "hits", "misses")

    def __init__(self, max_size: int) -> None:
        if max_size <= 0:
            raise ValueError("max_size must be positive")
        self._max = max_size
        self._map: "OrderedDict[K, V]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: K) -> bool:
        return key in self._map

    @property
    def max_size(self) -> int:
        return self._max

    def get(self, key: K, default=None):
        try:
            v = self._map[key]
        except KeyError:
            self.misses += 1
            return default
        self._map.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key: K, value: V) -> None:
        m = self._map
        if key in m:
            m[key] = value
            m.move_to_end(key)
            return
        if len(m) >= self._max:
            m.popitem(last=False)
        m[key] = value

    def pop(self, key: K) -> None:
        self._map.pop(key, None)

    def clear(self) -> None:
        self._map.clear()

    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class RandomEvictionCache(Generic[K, V]):
    def __init__(self, max_size: int, rng: Optional[random.Random] = None) -> None:
        if max_size <= 0:
            raise ValueError("max_size must be positive")
        self._max = max_size
        self._map: Dict[K, V] = {}
        self._keys: List[K] = []
        self._pos: Dict[K, int] = {}
        self._rng = rng or random.Random(0)
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: K) -> bool:
        return key in self._map

    def put(self, key: K, value: V) -> None:
        if key in self._map:
            self._map[key] = value
            return
        if len(self._map) >= self._max:
            i = self._rng.randrange(len(self._keys))
            evicted = self._keys[i]
            last = self._keys[-1]
            self._keys[i] = last
            self._pos[last] = i
            self._keys.pop()
            del self._pos[evicted]
            del self._map[evicted]
        self._pos[key] = len(self._keys)
        self._keys.append(key)
        self._map[key] = value

    def get(self, key: K) -> Optional[V]:
        v = self._map.get(key)
        if v is None and key not in self._map:
            self.misses += 1
            return None
        self.hits += 1
        return v

    def maybe_get(self, key: K) -> Optional[V]:
        return self._map.get(key)

    def clear(self) -> None:
        self._map.clear()
        self._keys.clear()
        self._pos.clear()
